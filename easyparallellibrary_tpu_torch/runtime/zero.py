"""ZeRO-1: optimizer state sharded over the data axis (port of
``easyparallellibrary_tpu/runtime/zero.py``).

In the JAX package ZeRO is a sharding decision (v0) and an explicit
``shard_map`` step (v1).  The port is explicit SPMD, so both levels are
the same dataflow written out: each parameter's owner dim is the first
one the data axis divides (:func:`zero_owner_dim`); this rank's
optimizer holds only its slice of every such parameter (AdamW's moments
at 1 / dp of their size), and :func:`apply_sharded` runs
``reduce_scatter(grads) / dp -> the owner's update -> all_gather(params)``
over the data group.  A parameter no dim of which divides stays whole
on every rank and takes the mean gradient, as in JAX.  A dim the
parameter's spec already shards (the stage dim of a pipelined model's
stacked leaves, the tensor-parallel and expert dims) is never the owner
dim (:func:`zero1_grad_layout`), so ZeRO composes with the pipeline
engines and the other axes: any train step of
``runtime.trainer.build_train_step`` over a ZeRO state, and
:func:`make_zero1_train_step`, reduce the gradients to their owners
through :func:`apply_sharded`.

The optimizer must be elementwise: :func:`apply_sharded` probes it once
a layout (:func:`_assert_elementwise_tx`: a global-norm clip couples
positions, so its 1 / dp slices would diverge from the whole) and
raises, as the JAX guard does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.utils.logging import get_logger


def zero_owner_dim(shape, taken, data_size: int) -> Optional[int]:
  """The first dim not already sharded (``taken[dim]`` falsy) that
  ``data_size`` divides, or None (the leaf stays replicated)."""
  if not shape or data_size <= 1:
    return None
  for dim, size in enumerate(shape):
    if not taken[dim] and size % data_size == 0 and size >= data_size:
      return dim
  return None


def zero1_grad_layout(params: Dict[str, torch.Tensor],
                      specs: Dict[str, tuple], dp: int
                      ) -> Dict[str, Optional[int]]:
  """ZeRO owner dims (JAX ``pipeline_smap.zero1_grad_layout``): each
  leaf's dim its gradient is reduce-scattered over ``data`` to (None: it
  stays whole and takes the mean), by :func:`zero_owner_dim` on this
  rank's shape with the dims its spec already shards taken (the stage
  dim of a stacked leaf, the tensor-parallel and expert dims), the rule
  that lays out the v0 / v1 optimizer state, so the scattered gradients
  land on it."""
  dims = {}
  for name, p in params.items():
    spec = list(specs.get(name, ()) or ())
    spec += [None] * (p.dim() - len(spec))
    dims[name] = zero_owner_dim(tuple(p.shape),
                                [e is not None for e in spec], dp)
  return dims


def _zero1_overlap_chunks(grads: Dict[str, torch.Tensor],
                          dims: Dict[str, Optional[int]], dp: int) -> int:
  """The ring chunk count ``communication.overlap`` picks for the
  reduce-to-owner, one decision for the whole gradient set (1: fused)."""
  from easyparallellibrary_tpu_torch.communicators import overlap
  total, dtype = 0, None
  for name, g in grads.items():
    if dims.get(name) is not None:
      total += g.numel()
      dtype = dtype or g.dtype
  if not total:
    return 1
  return overlap.resolve_num_chunks(
      "reduce_scatter", dp, m=dp, k=max(total // dp, 1), n_out=0,
      dtype=dtype)


@dataclasses.dataclass
class ZeroLayout:
  """Which dim each parameter's optimizer slice is cut on (None: whole)
  and this rank's owner leaves, which the optimizer steps.
  ``tx_checked``: the optimizer passed :func:`_assert_elementwise_tx`."""
  dims: Dict[str, Optional[int]]
  owners: Dict[str, torch.Tensor]
  dp: int
  tx_checked: bool = False


def shard_opt_state(state, shardings, mesh, level: str):
  """Rebuild ``state``'s optimizer over this rank's owner slices (ZeRO
  v0 / v1 over the data axis).  Returns ``(state, shardings)``, the
  optimizer entries' specs with ``data`` on the owner dim.  At a data
  axis of 1 the state is left as it is, with a warning (JAX's)."""
  if level not in (constants.ZERO_V0, constants.ZERO_V1):
    raise ValueError(f"Unsupported zero.level {level!r}")
  dp = mesh.axis_size(constants.DATA_AXIS)
  if dp <= 1:
    get_logger().warning("zero.level=%s requested but data axis is size 1; "
                         "optimizer state stays unsharded", level)
    return state, shardings
  idx = mesh.axis_index(constants.DATA_AXIS)
  dims = zero1_grad_layout(state.params, shardings, dp)
  owners = {}
  for name, p in state.params.items():
    d = dims[name]
    if d is None:
      owners[name] = p
    else:
      block = p.shape[d] // dp
      owners[name] = (p.detach().narrow(d, idx * block, block).clone()
                      .requires_grad_(True))
  state.opt_state = state.tx.init(owners)
  state.zero = ZeroLayout(dims, owners, dp)
  shardings = dict(shardings)
  for name, d in dims.items():
    spec = list(shardings.get(name, ()) or ())
    spec += [None] * (state.params[name].dim() - len(spec))
    if d is not None:
      spec[d] = constants.DATA_AXIS
    shardings[f"opt_state/{name}"] = tuple(spec)
  return state, shardings


def apply_sharded(state, reduce_method: str = "mean") -> None:
  """The ZeRO update of a state whose parameters hold this rank's
  gradients: the reduction to the owners (``parallel.api._reduce_grads``:
  the split axes' mean first, then the reduce-scatter over data), the
  optimizer's step on the owner slices, and the new slices all-gathered
  over data into the parameters, in place.  The first update of a
  layout probes the optimizer (:func:`_assert_elementwise_tx`)."""
  from easyparallellibrary_tpu_torch.parallel.api import (
      _reduce_grads, grad_mean_axes, param_specs)
  zero = state.zero
  if not zero.tx_checked:
    _assert_elementwise_tx(state.tx, state.params)
    zero.tx_checked = True
  model = state.apply_fn
  with torch.no_grad():
    _reduce_grads(state.params, mean_axes=grad_mean_axes(model),
                  specs=param_specs(model), owners=zero.owners,
                  dims=zero.dims, reduce_method=reduce_method)
    state.opt_state.step()
    for name, p in state.params.items():
      d = zero.dims[name]
      if d is not None:
        p.copy_(collectives.all_gather(zero.owners[name],
                                       constants.DATA_AXIS, axis=d))
  state.step = state.step + 1


def moment_bytes(opt: torch.optim.Optimizer) -> int:
  """Bytes of every tensor the optimizer keeps per parameter (AdamW's
  moments; the step counts are scalars)."""
  total = 0
  for st in opt.state.values():
    for v in st.values():
      if isinstance(v, torch.Tensor) and v.dim() > 0:
        total += v.numel() * v.element_size()
  return total


def _assert_elementwise_tx(tx, params: Dict[str, torch.Tensor]) -> None:
  """Reject optimizers whose update at one position depends on other
  positions (other leaves, or other slices of one leaf): the JAX
  behavioural probe.  On [128, 128] leaves with the parameters' names,
  perturb one element of the first and last leaves and require every
  other position's update and state to be unchanged."""
  shape = (128, 128)
  names = list(params)
  pert = {names[0], names[-1]}

  def run(perturb: bool):
    probe = {n: torch.ones(shape, requires_grad=True) for n in names}
    opt = tx.init(probe)
    for n, p in probe.items():
      g = torch.full(shape, 0.5)
      if perturb and n in pert:
        g[0, 0] = 1e3
      p.grad = g
    opt.step()
    moments = [[v.clone() for v in opt.state[p].values()
                if isinstance(v, torch.Tensor) and v.dim() > 0]
               for p in probe.values()]
    return {n: p.detach().clone() for n, p in probe.items()}, moments

  try:
    base, base_m = run(False)
    got, got_m = run(True)
  except Exception as e:  # noqa: BLE001 — a probe failure is not a verdict
    get_logger().warning(
        "ZeRO-1 could not verify the optimizer is elementwise (probe "
        "failed: %s); proceeding", e)
    return
  off = torch.ones(shape, dtype=torch.bool)
  off[0, 0] = False

  def differs(a, b, masked):
    if masked:
      a, b = a[off], b[off]
    return not torch.allclose(a, b, rtol=1e-5, atol=1e-7)

  coupled = any(differs(base[n], got[n], n in pert) for n in names)
  coupled = coupled or any(
      differs(a, b, True) for ms, mg in zip(base_m, got_m)
      for a, b in zip(ms, mg))
  if coupled:
    raise ValueError(
        "explicit ZeRO-1 requires an elementwise optimizer: this "
        "optimizer couples positions (e.g. a clip by global norm across "
        "leaves), so applying it to per-owner 1/dp shards would compute "
        "the coupling over local slices only.  Drop the coupled "
        "transform, or train without ZeRO.")


def make_zero1_train_step(loss_fn: Callable, mesh) -> Callable:
  """ZeRO-1 step ``(state, batch, rng) -> (state, metrics)`` on a pure
  data-parallel mesh: the local gradients of this rank's rows of the
  global ``batch``, then :func:`apply_sharded` (each divisible gradient
  reduce-scattered to its owner and divided by dp, the others averaged;
  the optimizer's step on the owner slices; the new slices all-gathered
  into the whole parameters).  Build the state with
  ``create_sharded_train_state(..., zero_level="v1")``."""
  for name, size in mesh.shape.items():
    if name != constants.DATA_AXIS and size > 1:
      raise ValueError(
          f"explicit ZeRO-1 supports pure data parallelism; mesh axis "
          f"{name!r} has size {size}")

  def step(state, batch, rng):
    from easyparallellibrary_tpu_torch.parallel.api import local_batch
    from easyparallellibrary_tpu_torch.parallel.metrics import (
        merge_shard_metrics)
    if getattr(state, "zero", None) is None:
      raise ValueError("make_zero1_train_step needs a ZeRO state: build it "
                       "with create_sharded_train_state(..., "
                       "zero_level='v1') on a data axis above 1")
    for p in state.params.values():
      p.grad = None
    loss, aux = loss_fn(state.params, local_batch(batch, mesh), rng)
    loss.backward()
    apply_sharded(state)
    metrics = {"loss": collectives.all_reduce(
        loss.detach(), constants.DATA_AXIS, op=collectives.MEAN)}
    if aux:
      metrics.update(merge_shard_metrics(
          {k: torch.as_tensor(v).detach() for k, v in aux.items()}))
    return state, metrics

  return step
