"""Mixture-of-Experts layer, expert parallelism over the ``expert`` axis
(port of ``easyparallellibrary_tpu/models/moe.py``).

The router picks top-1 (Switch) or top-2 experts for every token with a
capacity bound; dispatch and combine are products with the ``[T, E, C]``
one-hot masks of :func:`_top_k_dispatch`, as in the JAX module; tokens
past an expert's capacity are dropped; and the Switch load-balancing
loss comes from the router's pre-drop choices.  The JAX module sows that
loss into a flax collection; here :meth:`MoEMLP.forward` returns it
beside the output, and the GPT sums it (``models/gpt.py``).

The router runs in fp32 and must see the same numbers as the JAX one
(routing is discrete): its product runs at full fp32 precision, never as
TF32 (:func:`_fp32_matmul`), ``torch.argmax`` takes the first maximum as
``jnp.argmax`` does, and the queue positions are JAX's ``cumsum(onehot)
* onehot - onehot + fill``.

Expert weights ``wi [E, D, F]`` / ``wo [E, F, D]`` are cut over the
``expert`` axis (``E / ep`` experts a rank) and, under
``tensor_parallel``, their ``F`` dim over ``model``.  Two
implementations, as there:

* ``impl="einsum"``: tokens replicated over the expert group, each rank
  running its own experts on every token.  Megatron's pair around the
  expert-partial region (GSPMD's lowering of the JAX einsums): its
  inputs (the tokens and the router probabilities) are the identity
  forward with an all-reduce backward (``bridging.copy_to_split``), its
  output an all-reduce forward with the identity backward.  The same pair
  over ``model`` wraps the experts' ``F`` split.
* ``impl="a2a"``: tokens split over the expert group (``models.gpt``
  cuts the batch rows over ``("data", "expert")``), routed locally with a
  per-source capacity ``ceil(t_loc / E * cf)``, exchanged by two
  all-to-alls of ``[ep, E/ep, C, D]`` (``collectives.all_to_all``, whose
  backward is the inverse exchange) around the local experts.

Where the tokens of the global batch are split over ranks (``split_axes``:
data, seq, and expert under ``a2a``), the loss's fractions are averaged
over those axes before their product (:func:`_global_mean`), so the
loss is the global one.  The einsum path routes the whole batch as one
group, as the JAX one does under GSPMD: the queue positions count the
tokens of the ranks before over data and seq (:func:`_queue_starts`),
the capacity is the global batch's, and each rank runs the experts on
every capacity slot (its own tokens fill some; the others are zero and
stay zero).  The a2a path routes each rank's tokens as one group, with
its per-source capacity.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.ops import bridging


def _fp32_matmul(a, b):
  """``a @ b`` in fp32 at full precision (TF32 off for this product)."""
  was = torch.get_float32_matmul_precision()
  torch.set_float32_matmul_precision("highest")
  try:
    return torch.matmul(a.float(), b.float())
  finally:
    torch.set_float32_matmul_precision(was)


def _queue_starts(onehots, rows: int, axes: Sequence[str]):
  """``(before [K, T, E], totals [K, E])`` of the choices ``onehots [K,
  T, E]`` of this rank's ``T`` tokens, ``rows`` rows of ``T / rows``:
  for each token and expert, the choices of the expert made by the
  tokens before it in the global batch, and each expert's choices over
  the whole batch.  ``axes`` split the global batch: ``data`` its rows,
  ``seq`` each row's tokens, so the global order runs over (data rank,
  row, seq rank, token); this rank's per-row counts are all-gathered
  over them (a few integers a row)."""
  K, T, E = onehots.shape
  per_row = onehots.reshape(K, rows, T // rows, E)
  counts = per_row.sum(2, keepdim=True)                    # [K, rows, 1, E]
  d = q = 0
  if constants.SEQ_AXIS in axes:
    counts = collectives.all_gather(counts, constants.SEQ_AXIS, axis=2)
    q = collectives.axis_index(constants.SEQ_AXIS)
  counts = counts.unsqueeze(1)                             # [K, 1, rows, n, E]
  if constants.DATA_AXIS in axes:
    counts = collectives.all_gather(counts, constants.DATA_AXIS, axis=1)
    d = collectives.axis_index(constants.DATA_AXIS)
  blocks = counts.reshape(K, -1, E)
  ahead = (torch.cumsum(blocks, 1) - blocks).reshape(counts.shape)
  start = ahead[:, d, :, q]                                # [K, rows, E]
  before = torch.cumsum(per_row, 2) - per_row + start[:, :, None]
  return before.reshape(K, T, E), blocks.sum(1)


def _top_k_dispatch(probs, top_k: int, E: int, capacity: int, dtype,
                    rows: int = 1, axes: Sequence[str] = ()
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Top-k routing: ``(dispatch [T, E, C], combine [T, E, C], assign
  [T, E])``.  ``assign`` is the pre-capacity choice mask (for the
  auxiliary loss).  The masks are written by index (a token's one
  ``(expert, slot)`` a choice) into ``dtype``, the values of JAX's
  one-hot products.  ``probs`` are this rank's ``rows`` rows of a batch
  split over ``axes`` (``data``, ``seq``), routed as one group with it:
  the queue positions count the tokens of the ranks before
  (:func:`_queue_starts`) and ``capacity`` is the group's."""
  T = probs.shape[0]
  dev = probs.device
  dispatch = torch.zeros((T, E, capacity), dtype=dtype, device=dev)
  combine = torch.zeros((T, E, capacity), dtype=dtype, device=dev)
  idxs, gates, onehots = [], [], []
  remaining = probs
  for _ in range(top_k):
    gates.append(remaining.amax(dim=-1))
    idxs.append(torch.argmax(remaining, dim=-1))   # the first maximum
    onehots.append(F.one_hot(idxs[-1], E).to(torch.int32))   # [T, E]
    remaining = remaining * (1 - onehots[-1].to(remaining.dtype))
  onehots = torch.stack(onehots)
  # Each choice's position in its expert's queue (0-based): JAX's
  # cumsum(onehot) * onehot - onehot over the group, after the tokens
  # placed by earlier choices (``fill``).
  before, totals = _queue_starts(onehots, rows, axes)
  rows_t = torch.arange(T, device=dev)
  fill = torch.zeros((E,), dtype=torch.int32, device=dev)
  for k in range(top_k):
    onehot, idx = onehots[k], idxs[k]
    pos = before[k] * onehot + fill[None, :]
    keep = (pos < capacity).to(torch.int32) * onehot
    kept = keep.sum(-1).bool()
    slot = (pos * keep).sum(-1)
    dispatch = dispatch.index_put(
        (rows_t[kept], idx[kept], slot[kept]),
        torch.ones((), dtype=dtype, device=dev), accumulate=True)
    combine = combine.index_put(
        (rows_t[kept], idx[kept], slot[kept]), gates[k][kept].to(dtype),
        accumulate=True)
    # The group's kept choices: its positions run from fill up.
    fill = fill + torch.clamp(capacity - fill, min=0).minimum(
        totals[k]).to(torch.int32)
  return dispatch, combine, onehots.sum(0, dtype=torch.int32)


def _dropped(assign, dispatch):
  """The router's choices minus those placed in a capacity slot."""
  return (assign.sum() - dispatch.detach().sum(dtype=torch.float32)).long()


def _global_mean(x, axes: Sequence[str]):
  """The mean of ``x`` over the ranks of ``axes`` (JAX's ``pmean``), whose
  backward passes the cotangent through unchanged: the ranks'
  gradients are averaged afterwards (``parallel.api.reduce_gradients``),
  and a replicated loss term's gradient must average, not sum, to the
  global one."""
  whole = x.detach()
  for axis in axes:
    whole = collectives.all_reduce(whole, axis, op=collectives.MEAN)
  return x + (whole - x.detach())


def _gelu(x):
  return F.gelu(x, approximate="tanh")     # flax nn.gelu


class MoEMLP(nn.Module):
  """Drop-in replacement for the dense MLP: ``forward(x) -> (out, aux)``
  with ``out`` ``x``'s shape and ``aux`` the fp32 load-balancing loss.
  ``split_axes``: the mesh axes over which this rank's tokens are a
  distinct part of the global batch."""

  def __init__(self, cfg, top_k: int = 1, impl: str = "einsum",
               device=None):
    super().__init__()
    if impl not in ("einsum", "a2a"):
      raise ValueError(f"MoEMLP.impl must be einsum|a2a: {impl!r}")
    self.cfg, self.top_k, self.impl = cfg, top_k, impl
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    self.ep = collectives.axis_size(constants.EXPERT_AXIS)
    self.tp = (collectives.axis_size(constants.MODEL_AXIS)
               if cfg.tensor_parallel else 1)
    if E % self.ep:
      raise ValueError(f"num_experts {E} must divide the expert axis "
                       f"{self.ep}")
    if Fd % self.tp:
      raise ValueError(f"d_ff {Fd} must divide the model axis {self.tp}")
    el, fl = E // self.ep, Fd // self.tp
    self.router_kernel = nn.Parameter(torch.empty(
        D, E, dtype=torch.float32, device=device))
    self.wi = nn.Parameter(torch.empty(el, D, fl, dtype=cfg.param_dtype,
                                       device=device))
    self.wo = nn.Parameter(torch.empty(el, fl, D, dtype=cfg.param_dtype,
                                       device=device))
    self.split_axes: Tuple[str, ...] = ()
    # Tokens (choices) this rank's last forward dropped at capacity, a
    # device scalar (read it after a step; reading it syncs).
    self.last_dropped = None

  def param_specs(self) -> dict:
    """Each parameter's spec, as the JAX module's partitioning names."""
    m = constants.MODEL_AXIS if self.cfg.tensor_parallel else None
    return {"wi": (constants.EXPERT_AXIS, None, m),
            "wo": (constants.EXPERT_AXIS, m, None)}

  def _experts(self, x, dtype):
    """The local experts on ``[E_loc, G, D]`` inputs, with the model
    axis pair around their ``F`` split."""
    if self.tp > 1:
      x = bridging.copy_to_split(x, constants.MODEL_AXIS)
    h = _gelu(torch.einsum("egd,edf->egf", x, self.wi.to(dtype)))
    y = torch.einsum("egf,efd->egd", h, self.wo.to(dtype))
    if self.tp > 1:
      y = collectives.all_reduce(y, constants.MODEL_AXIS)
    return y

  def _aux(self, probs, assign, axes):
    E = self.cfg.num_experts
    frac_tokens = _global_mean(assign.float().mean(0), axes).detach()
    frac_probs = _global_mean(probs.mean(0), axes)
    return E * torch.sum(frac_tokens * frac_probs)

  def forward(self, x, dtype=None):
    dtype = dtype or x.dtype
    if self.impl == "a2a":
      return self._a2a_path(x, dtype)
    return self._einsum_path(x, dtype)

  def _einsum_path(self, x, dtype):
    cfg = self.cfg
    B, S, D = x.shape
    E, T = cfg.num_experts, B * S
    group = tuple(a for a in self.split_axes
                  if a in (constants.DATA_AXIS, constants.SEQ_AXIS)
                  and collectives.axis_size(a) > 1)
    t_group = T * math.prod(collectives.axis_size(a) for a in group)
    capacity = max(self.top_k,
                   int(math.ceil(t_group / E * cfg.capacity_factor)))
    tokens = x.reshape(T, D)
    probs = torch.softmax(_fp32_matmul(tokens, self.router_kernel), dim=-1)
    routed = probs
    if self.ep > 1:
      # Every rank routes every token; its experts see only their slice
      # of the masks, so the gradients into the tokens and the router
      # are partial and sum over the expert group.
      tokens = bridging.copy_to_split(tokens, constants.EXPERT_AXIS)
      routed = bridging.copy_to_split(probs, constants.EXPERT_AXIS)
    dispatch, combine, assign = _top_k_dispatch(
        routed, self.top_k, E, capacity, x.dtype, rows=B, axes=group)
    self.last_dropped = _dropped(assign, dispatch)
    el = E // self.ep
    e0 = collectives.axis_index(constants.EXPERT_AXIS) * el
    if self.ep > 1:
      dispatch, combine = dispatch[:, e0:e0 + el], combine[:, e0:e0 + el]
    expert_in = torch.einsum("td,tec->ecd", tokens, dispatch)
    expert_out = self._experts(expert_in, dtype)
    out = torch.einsum("ecd,tec->td", expert_out, combine)
    if self.ep > 1:
      out = collectives.all_reduce(out, constants.EXPERT_AXIS)
    aux = self._aux(probs, assign, self.split_axes)
    return out.reshape(B, S, D), aux

  def _a2a_path(self, x, dtype):
    cfg = self.cfg
    B, S, D = x.shape
    E, t_loc, ep = cfg.num_experts, B * S, self.ep
    el = E // ep
    # Per-source capacity: the receive buffer of an expert is ep * C,
    # about the einsum path's global bound.
    C = max(self.top_k, int(math.ceil(t_loc / E * cfg.capacity_factor)))
    tokens = x.reshape(t_loc, D)
    probs = torch.softmax(_fp32_matmul(tokens, self.router_kernel), dim=-1)
    dispatch, combine, assign = _top_k_dispatch(
        probs, self.top_k, E, C, x.dtype)
    self.last_dropped = _dropped(assign, dispatch)
    buf = torch.einsum("td,tec->ecd", tokens, dispatch).reshape(
        ep, el, C, D)
    recv = collectives.all_to_all(buf, constants.EXPERT_AXIS, 0, 0)
    y = self._experts(recv.transpose(0, 1).reshape(el, ep * C, D), dtype)
    y = y.reshape(el, ep, C, D).transpose(0, 1)
    back = collectives.all_to_all(y.contiguous(), constants.EXPERT_AXIS, 0,
                                  0)
    out = torch.einsum("ecd,tec->td", back.reshape(E, C, D), combine)
    axes = tuple(self.split_axes)
    if constants.EXPERT_AXIS not in axes:
      axes = axes + (constants.EXPERT_AXIS,)
    aux = self._aux(probs, assign, axes)
    return out.reshape(B, S, D), aux
