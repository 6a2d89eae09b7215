"""Ring attention: context parallelism over the ``seq`` axis (port of
``easyparallellibrary_tpu/sequence/ring_attention.py``).

The JAX module holds global arrays and drops into ``shard_map`` over the
seq axis.  The port is explicit SPMD: every rank holds its own slice of
the tokens, ``[B, S/n, H, D]`` (rank ``i`` the ``i``-th contiguous slice,
as ``models.gpt`` cuts them), and the rotations are ``ppermute``\\ s over
the seq group (``communicators.overlap.ring_step``: rank ``i`` sends to
``i + 1``), so at ring step ``r`` rank ``i`` holds K/V block
``(i - r) mod n``.  Three implementations, chosen as there:

* **flash ring** (``sequence.ring_impl="flash"``, the default): the
  flash kernels (``kernels/flash_attention.py``) on every visiting block,
  merged by log-sum-exp, with a backward that rotates K and V again
  instead of saving them and runs the dK/dV and dQ kernels once per
  visiting block against the *global* lse and delta (dK and dV
  accumulate in fp32 and travel with their block back to its owner), so
  the live memory of a rank stays O(S/n).  The forward is the custom op
  ``epl_torch::ring_flash_fwd`` (``RING_FWD_OP``), so the GPT's
  ``remat_policy="dots_flash"`` saves its ``(out, lse)`` as it saves the
  flash op's and a recompute never re-runs the ring.  Two layouts:
  contiguous, and zigzag (half-chunks ``i`` and ``2n - 1 - i`` on rank
  ``i``, entered and left by the JAX module's ``ppermute`` index maps,
  :func:`_zig_entry` / :func:`_zig_exit`), taken only when causal,
  ``n > 1``, the slice even and its half blockable.
  ``ring_impl="dense"`` runs the same rings with plain block products
  (:func:`_dense_block_fwd` / :func:`_dense_block_bwd`).
* **einsum ring** (``ring_impl="einsum"``, ``sequence.block_size`` finer
  blocking, an explicit ``num_blocks``, an unblockable slice, or one
  rank): the online-softmax recurrence over blocks (:func:`_ring_step`,
  each step checkpointed), the global roll of the block dim written as
  a shift of the local blocks plus a ``ppermute`` of the last one.

Causality is block-wise: a query block attends its own block under the
triangular mask, earlier blocks whole, later ones not at all.  The JAX
flash ring runs the fully masked steps as zeros (uniform SPMD work);
the port skips their launches, which leaves the merged result bit for
bit the same.  Launches of the flash forward on rank ``i`` a layer
(each backward kernel the same): contiguous causal ``i + 1``, not
causal ``n``, zigzag ``2n + 1`` half-blocks (:func:`launches_per_layer`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import register_flop_formula

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.communicators.overlap import ring_step
from easyparallellibrary_tpu_torch.kernels import _cost
from easyparallellibrary_tpu_torch.kernels import flash_attention as fa

NEG_INF = -1e30


def _config():
  from easyparallellibrary_tpu_torch.env import Env
  return Env.get().config.sequence


def _seq() -> Tuple[int, int]:
  """``(n, i)``: the seq axis size and this rank's index on it."""
  return (collectives.axis_size(constants.SEQ_AXIS),
          collectives.axis_index(constants.SEQ_AXIS))


def _rot(x, n: int):
  return ring_step(x, constants.SEQ_AXIS, n)


# ------------------------------------------------------- block compute --


def _dense_scores(q, k, causal: bool):
  """Scaled (and causally masked) fp32 scores of ``[B, H, s, D]`` blocks:
  products of the stored values accumulated in fp32."""
  scale = q.shape[-1] ** -0.5
  s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
  if causal:
    mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                      device=s.device).tril()
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=s.device))
  return s, scale


def _dense_block_fwd(q, k, v, causal: bool):
  """Plain block attention with the flash forward's contract: ``(out in
  q's dtype, lse [B, H, s] fp32)``."""
  s, _ = _dense_scores(q, k, causal)
  m = s.amax(-1)
  p = torch.exp(s - m[..., None])
  l = torch.clamp_min(p.sum(-1), 1e-30)
  o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                   v.float()) / l[..., None]
  return o.to(q.dtype), m + torch.log(l)


def _dense_block_bwd(q, k, v, dout, lse, delta, causal: bool):
  """Plain twin of the flash backward kernels against a caller's (global)
  ``lse`` and ``delta``: ``(dq, dk, dv)`` in the inputs' dtype."""
  s, scale = _dense_scores(q, k, causal)
  p = torch.exp(s - lse[..., None])
  dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(),
                    dout.float())
  dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
  ds = (p * (dp - delta[..., None])).to(q.dtype).float()
  dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
  dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
  return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _block_fwd(q, k, v, causal: bool, dense: bool):
  if dense:
    return _dense_block_fwd(q, k, v, causal)
  return fa.flash_fwd(q, k, v, causal)


def _block_bwd(q, k, v, dout, lse, delta, causal: bool, dense: bool):
  if dense:
    return _dense_block_bwd(q, k, v, dout, lse, delta, causal)
  dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, causal)
  dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, causal)
  return dq, dk, dv


def _merge(o1, l1, o2, l2):
  """LSE-merge two (output, logsumexp) contributions (fp32)."""
  l = torch.logaddexp(l1, l2)
  return (o1 * torch.exp(l1 - l)[..., None]
          + o2 * torch.exp(l2 - l)[..., None]), l


def _halves(x):
  h = x.shape[2] // 2
  return x[:, :, :h], x[:, :, h:]


# --------------------------------------------------- contiguous layout --


def _ring_fwd_pass(n: int, idx: int, causal: bool, dense: bool, q, k0, v0):
  """Rank ``idx``'s ring forward in kernel layout ``[B, H, s, D]``:
  the merged ``(O fp32, L fp32 [B, H, s])``.  At step ``r > 0`` a causal
  rank with ``idx < r`` holds a block wholly in its future: no launch."""
  O = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
  L = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
  k_cur, v_cur = k0, v0
  for r in range(n):
    if not (causal and r > 0 and idx < r):
      o_r, lse_r = _block_fwd(q, k_cur, v_cur, causal and r == 0, dense)
      O, L = _merge(O, L, o_r.float(), lse_r)
    if r != n - 1:
      k_cur, v_cur = _rot(k_cur, n), _rot(v_cur, n)
  return O, L


def _ring_local_bwd(n: int, idx: int, causal: bool, dense: bool, q, k0, v0,
                    out, L, dO):
  delta = (dO.float() * out.float()).sum(-1)
  dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
  k_cur, v_cur = k0, v0
  dk_cur = torch.zeros(k0.shape, dtype=torch.float32, device=q.device)
  dv_cur = torch.zeros_like(dk_cur)
  for r in range(n):
    if not (causal and r > 0 and idx < r):
      dq_r, dk_r, dv_r = _block_bwd(q, k_cur, v_cur, dO, L, delta,
                                    causal and r == 0, dense)
      dq += dq_r.float()
      dk_cur += dk_r.float()
      dv_cur += dv_r.float()
    # dK/dV ride with their block every step (n rotations), so each
    # arrives back at its block's owner.
    if r != n - 1:
      k_cur, v_cur = _rot(k_cur, n), _rot(v_cur, n)
    dk_cur, dv_cur = _rot(dk_cur, n), _rot(dv_cur, n)
  return dq.to(q.dtype), dk_cur.to(k0.dtype), dv_cur.to(v0.dtype)


# ------------------------------------------------------- zigzag layout --


def _zig_entry(x, n: int):
  """Contiguous shard (chunks 2i, 2i+1) -> zigzag (chunks i, 2n-1-i)."""
  idx = collectives.axis_index(constants.SEQ_AXIS)
  a, b = _halves(x)
  evens = collectives.ppermute(
      a, constants.SEQ_AXIS,
      [(i, 2 * i if 2 * i < n else 2 * n - 1 - 2 * i) for i in range(n)])
  odds = collectives.ppermute(
      b, constants.SEQ_AXIS,
      [(i, 2 * i + 1 if 2 * i + 1 < n else 2 * n - 2 - 2 * i)
       for i in range(n)])
  if idx % 2 == 0:
    return torch.cat([evens, odds], dim=2)
  return torch.cat([odds, evens], dim=2)


def _zig_exit(x, n: int):
  """Inverse of :func:`_zig_entry`."""
  idx = collectives.axis_index(constants.SEQ_AXIS)
  a, b = _halves(x)
  even_chunk, odd_chunk = (a, b) if idx % 2 == 0 else (b, a)
  evens = collectives.ppermute(
      even_chunk, constants.SEQ_AXIS,
      [(i, (i if i % 2 == 0 else 2 * n - 1 - i) // 2) for i in range(n)])
  odds = collectives.ppermute(
      odd_chunk, constants.SEQ_AXIS,
      [(i, ((2 * n - 1 - i) if i % 2 == 0 else i) // 2) for i in range(n)])
  return torch.cat([evens, odds], dim=2)


def _zz_fwd_pass(n: int, idx: int, dense: bool, q, k0, v0):
  """Zigzag causal ring forward (``s`` = two half-chunks): one always-live
  half-pair (late q, early k) and one selected half-pair a step."""
  qa, qb = _halves(q)

  def fwd_half(qh, kh, vh, causal):
    o, lse = _block_fwd(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                        causal, dense)
    return o.float(), lse

  O = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
  L = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
  k_cur, v_cur = k0, v0
  for r in range(n):
    ka, kb = _halves(k_cur)
    va, vb = _halves(v_cur)
    if r == 0:
      o_a, l_a = fwd_half(qa, ka, va, True)          # diag (early, early)
      o1, l1 = fwd_half(qb, ka, va, False)           # late q vs early k
      o2, l2 = fwd_half(qb, kb, vb, True)            # diag (late, late)
      o_b, l_b = _merge(o1, l1, o2, l2)
    else:
      # Visiting block (idx - r) mod n: unwrapped (idx >= r) makes (qa,
      # ka) live, wrapped makes (qb, kb) live.
      o_aw, l_aw = fwd_half(qb, ka, va, False)       # always live
      none_o = torch.zeros_like(o_aw)
      none_l = torch.full_like(l_aw, NEG_INF)
      if idx >= r:
        o_a, l_a = fwd_half(qa, ka, va, False)
        o_b, l_b = _merge(o_aw, l_aw, none_o, none_l)
      else:
        o_sl, l_sl = fwd_half(qb, kb, vb, False)
        o_a, l_a = none_o, none_l
        o_b, l_b = _merge(o_aw, l_aw, o_sl, l_sl)
    O, L = _merge(O, L, torch.cat([o_a, o_b], dim=2),
                  torch.cat([l_a, l_b], dim=2))
    if r != n - 1:
      k_cur, v_cur = _rot(k_cur, n), _rot(v_cur, n)
  return O, L


def _ring_local_zz_bwd(n: int, idx: int, dense: bool, q, k0, v0, out, L,
                       dO):
  """Recommunicating zigzag backward: the forward's half-pairs, each
  against the global per-half lse and delta."""
  delta = (dO.float() * out.float()).sum(-1)
  half = q.shape[2] // 2
  qa, qb = _halves(q)
  dOa, dOb = _halves(dO)
  La, Lb = L[:, :, :half].contiguous(), L[:, :, half:].contiguous()
  da, db = delta[:, :, :half].contiguous(), delta[:, :, half:].contiguous()
  qa, qb, dOa, dOb = (t.contiguous() for t in (qa, qb, dOa, dOb))
  dqa = torch.zeros(qa.shape, dtype=torch.float32, device=q.device)
  dqb = torch.zeros_like(dqa)
  k_cur, v_cur = k0, v0
  dk_cur = torch.zeros(k0.shape, dtype=torch.float32, device=q.device)
  dv_cur = torch.zeros_like(dk_cur)
  for r in range(n):
    ka, kb = (t.contiguous() for t in _halves(k_cur))
    va, vb = (t.contiguous() for t in _halves(v_cur))
    dka = torch.zeros(ka.shape, dtype=torch.float32, device=q.device)
    dkb, dva, dvb = (torch.zeros_like(dka) for _ in range(3))
    pairs = []   # (q-half is a, k-half is a, causal)
    if r == 0:
      pairs = [(True, True, True), (False, True, False),
               (False, False, True)]
    else:
      pairs = [(False, True, False),
               (True, True, False) if idx >= r else (False, False, False)]
    for qa_side, ka_side, causal in pairs:
      gq, gk, gv = _block_bwd(
          qa if qa_side else qb, ka if ka_side else kb,
          va if ka_side else vb, dOa if qa_side else dOb,
          La if qa_side else Lb, da if qa_side else db, causal, dense)
      if qa_side:
        dqa += gq.float()
      else:
        dqb += gq.float()
      if ka_side:
        dka += gk.float()
        dva += gv.float()
      else:
        dkb += gk.float()
        dvb += gv.float()
    dk_cur = dk_cur + torch.cat([dka, dkb], dim=2)
    dv_cur = dv_cur + torch.cat([dva, dvb], dim=2)
    if r != n - 1:
      k_cur, v_cur = _rot(k_cur, n), _rot(v_cur, n)
    dk_cur, dv_cur = _rot(dk_cur, n), _rot(dv_cur, n)
  dq = torch.cat([dqa, dqb], dim=2)
  return dq.to(q.dtype), dk_cur.to(k0.dtype), dv_cur.to(v0.dtype)


# ------------------------------------------------------------ autograd --


@torch.library.custom_op("epl_torch::ring_flash_fwd", mutates_args=())
def _ring_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, zigzag: bool, dense: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  n, idx = _seq()
  if zigzag:
    O, L = _zz_fwd_pass(n, idx, dense, q, k, v)
  else:
    O, L = _ring_fwd_pass(n, idx, causal, dense, q, k, v)
  return O.to(q.dtype), L


@_ring_fwd_op.register_fake
def _(q, k, v, causal, zigzag, dense):
  return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@register_flop_formula(torch.ops.epl_torch.ring_flash_fwd)
def _ring_fwd_flops(q_shape, k_shape, v_shape, causal, zigzag, dense,
                    *args, **kwargs) -> int:
  """The blocks this rank's ring multiplies (``launches_per_layer``),
  each counted as a flash forward: whole slices, or half slices under
  the zigzag layout."""
  del v_shape, dense
  n, idx = _seq()
  B, H, s, D = q_shape
  side = s // 2 if zigzag else s
  return (launches_per_layer(n, idx, causal, zigzag)
          * _cost.attention_flops((B, H, side, D), (B, H, side, D)))


def _ring_setup_context(ctx, inputs, output):
  q, k, v, causal, zigzag, dense = inputs
  ctx.flags = (causal, zigzag, dense)
  ctx.save_for_backward(q, k, v, output[0], output[1])


def _ring_backward(ctx, dout, dlse):
  del dlse  # the ring's lse is a residual, never a model output
  q, k, v, out, L = ctx.saved_tensors
  causal, zigzag, dense = ctx.flags
  n, idx = _seq()
  dout = dout.to(q.dtype).contiguous()
  if zigzag:
    dq, dk, dv = _ring_local_zz_bwd(n, idx, dense, q, k, v, out, L, dout)
  else:
    dq, dk, dv = _ring_local_bwd(n, idx, causal, dense, q, k, v, out, L,
                                 dout)
  return dq, dk, dv, None, None, None


_ring_fwd_op.register_autograd(_ring_backward,
                               setup_context=_ring_setup_context)

# The op as the selective-checkpoint policies see it (models/gpt.py).
RING_FWD_OP = torch.ops.epl_torch.ring_flash_fwd.default


def _zigzag_applies(causal: bool, n: int, s_loc: int, D: int, dtype,
                    dense: bool) -> bool:
  """The layout rule: zigzag only when causal, ``n > 1``, the slice even
  and its half blockable (dense blocks have no tiling bound)."""
  return (_config().ring_layout == "zigzag" and causal and n > 1
          and s_loc % 2 == 0
          and (dense or fa.flash_blockable(
              s_loc // 2, d=D, itemsize=torch.tensor([], dtype=dtype)
              .element_size())))


def launches_per_layer(n: int, idx: int, causal: bool, zigzag: bool) -> int:
  """Flash forward launches of rank ``idx`` in one ring attention call
  (each backward kernel launches as often)."""
  if zigzag:
    return 2 * n + 1
  return idx + 1 if causal else n


def _ring_flash(q, k, v, causal: bool):
  """The flash (or dense-block) ring over this rank's ``[B, s, H, D]``
  slices."""
  n, _ = _seq()
  s_loc, D = q.shape[1], q.shape[3]
  dense = _config().ring_impl == "dense"
  zigzag = _zigzag_applies(causal, n, s_loc, D, q.dtype, dense)
  qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
  if zigzag:
    qt, kt, vt = (_zig_entry(x, n).contiguous() for x in (qt, kt, vt))
  out, _ = _ring_fwd_op(qt, kt, vt, causal, zigzag, dense)
  if zigzag:
    out = _zig_exit(out, n)
  return out.transpose(1, 2)


def _ring_manual(q, k, v, causal: bool):
  """The ring for callers inside the ``smap`` pipeline engine's stage
  programs, with the JAX module's guards: the einsum ring cannot run
  there, and an unblockable flash slice raises instead of falling
  back."""
  n, _ = _seq()
  cfg = _config()
  s_loc, D = q.shape[1], q.shape[3]
  if cfg.ring_impl not in ("flash", "dense"):
    raise ValueError(
        f"sequence.ring_impl={cfg.ring_impl!r} cannot run inside a "
        "seq-manual region (the einsum ring is a global-array GSPMD "
        "program); use ring_impl='flash' or 'dense' with the smap "
        "pipeline engine")
  dense = cfg.ring_impl == "dense"
  if not dense and not _zigzag_applies(causal, n, s_loc, D, q.dtype, dense) \
      and not fa.flash_blockable(s_loc, d=D, itemsize=q.element_size()):
    raise ValueError(
        f"per-device sequence block {s_loc} (d={D}) has no flash "
        "tiling; set sequence.ring_impl='dense' for the XLA block path "
        "inside the smap engine")
  return _ring_flash(q, k, v, causal)


# ---------------------------------------------------------- einsum ring --


def _ring_step(qb, kb, vb, o, m, l, r: int, N: int, first: int,
               causal: bool):
  """One ring step over local blocks ``[B, nb, s, H, D]`` (global block
  ``first + j`` at local ``j``; the K/V at local ``j`` is global block
  ``(first + j - r) mod N``): blockwise attention plus the online-softmax
  update of ``(o, m, l)``."""
  scale = 1.0 / torch.sqrt(torch.tensor(float(qb.shape[-1])))
  scores = torch.einsum("bnqhd,bnkhd->bnhqk", qb, kb).float() * scale
  if causal:
    nb, s = qb.shape[1], qb.shape[2]
    block_idx = first + torch.arange(nb, device=qb.device)
    k_block = (block_idx - r) % N
    fully = (k_block > block_idx)[None, :, None, None, None]
    diagonal = (k_block == block_idx)[None, :, None, None, None]
    tri = torch.ones((s, s), dtype=torch.bool,
                     device=qb.device).tril()[None, None, None]
    mask = torch.where(diagonal, tri, torch.ones_like(tri)) & ~fully
    scores = torch.where(mask, scores, torch.tensor(NEG_INF,
                                                    device=qb.device))
  step_max = scores.amax(-1)                                  # [b,n,h,q]
  new_m = torch.maximum(m, step_max.permute(0, 1, 3, 2))      # [b,n,q,h]
  correction = torch.exp(m - new_m)
  probs = torch.exp(scores - new_m.permute(0, 1, 3, 2)[..., None])
  new_l = l * correction + probs.sum(-1).permute(0, 1, 3, 2)
  step_o = torch.einsum("bnhqk,bnkhd->bnqhd", probs.to(qb.dtype), vb)
  new_o = o * correction[..., None].to(o.dtype) + step_o.to(o.dtype)
  return new_o, new_m, new_l


def _roll_blocks(x, n: int):
  """The global roll by one of the block dim (``jnp.roll(x, 1, axis=1)``
  of the whole array) on this rank's local blocks: a shift, and the
  last local block to the next rank's first."""
  last = x[:, -1:]
  if n > 1:
    last = _rot(last, n)
  return torch.cat([last, x[:, :-1]], dim=1)


def _einsum_ring(q, k, v, causal: bool, N: int):
  n, idx = _seq()
  B, s_loc, H, D = q.shape
  if N % n:
    raise ValueError(f"{N} ring blocks must divide into the {n} seq ranks")
  nb = N // n
  if s_loc % nb:
    raise ValueError(f"sequence length {s_loc * n} not divisible by "
                     f"{N} ring blocks")
  s = s_loc // nb

  def block(x):
    return x.reshape(B, nb, s, H, D)

  qb, kb, vb = block(q), block(k), block(v)
  o = torch.zeros((B, nb, s, H, D), dtype=torch.float32, device=q.device)
  m = torch.full((B, nb, s, H), NEG_INF, dtype=torch.float32,
                 device=q.device)
  l = torch.zeros_like(m)
  for r in range(N):
    o, m, l = checkpoint(_ring_step, qb, kb, vb, o, m, l, r, N, idx * nb,
                         causal, use_reentrant=False)
    if r != N - 1:
      kb, vb = _roll_blocks(kb, n), _roll_blocks(vb, n)
  out = (o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
  return out.reshape(B, s_loc, H, D)


def ring_attention(q, k, v, causal: bool = True,
                   num_blocks: Optional[int] = None, manual: bool = False):
  """Ring attention over this rank's token slice ``[B, S/n, H, D]``;
  returns the same shape.  With a seq axis above 1 (and no
  ``num_blocks``), ``sequence.ring_impl`` "flash" or "dense" and no
  ``sequence.block_size``, the flash (or dense-block) ring; else, and for
  a slice the kernels cannot tile, the einsum ring over ``num_blocks``
  global blocks (default one a rank, finer under ``block_size``).
  ``manual``: the caller is a stage program of the ``smap`` engine
  (:func:`_ring_manual`)."""
  if manual:
    return _ring_manual(q, k, v, causal)
  n, _ = _seq()
  cfg = _config()
  s_loc, D = q.shape[1], q.shape[3]
  S = s_loc * n
  if (n > 1 and num_blocks is None and cfg.ring_impl in ("flash", "dense")
      and not cfg.block_size):
    if cfg.ring_impl == "dense" or fa.flash_blockable(
        s_loc, d=D, itemsize=q.element_size()):
      return _ring_flash(q, k, v, causal)
    # A slice the kernels cannot tile falls to the einsum ring, which has
    # no blocking bound.
  if num_blocks is None:
    N = n
    if cfg.block_size and S > cfg.block_size:
      finer = S // cfg.block_size
      if S % finer == 0 and finer % n == 0:
        N = max(N, finer)
  else:
    N = num_blocks
  if S % N:
    raise ValueError(f"sequence length {S} not divisible by {N} ring "
                     "blocks")
  return _einsum_ring(q, k, v, causal, N)

