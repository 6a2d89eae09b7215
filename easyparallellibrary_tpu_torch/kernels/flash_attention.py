"""Flash attention: three Hopper CUDA kernels and their plain versions.

Port of ``easyparallellibrary_tpu/kernels/flash_attention.py``.  The
forward saves ``(out, lse)``; the backward recomputes the probabilities
from ``(q, k, lse)``, one kernel producing dK/dV (a CTA per KV tile) and
another dQ (a CTA per Q tile).  The kernels live in
``csrc/flash_attention.cu`` and replace the six Pallas bodies; the
resident/streaming split of the TPU version answered its VMEM budget and
has no counterpart here.  In bf16 at head dims 64 and 128 the three
kernels run their wgmma builds, which read their tiles through TMA
tensor maps that the library encodes on every call from the pointers
and sizes given (3 maps for the forward, 4 each for dK/dV and dQ); in
fp16 at those head dims all three run the same builds instantiated for
fp16.  fp32, and both 16-bit types at other head dims, run the
CUDA-core build, which accumulates in fp32.
``flash_route`` says which build a call takes.

Each of the three functions comes in three forms, kernel layout
``[B, H, S, D]`` (``lse`` and ``delta`` ``[B, H, S]`` fp32):

* ``flash_fwd_reference`` / ``flash_bwd_dkv_reference`` /
  ``flash_bwd_dq_reference`` — plain PyTorch over the full score matrix,
  rounding where the Pallas kernels round (``p`` to V's dtype before the
  PV product, ``p`` to dO's and ``dS`` to Q's / K's dtype before the
  gradient products).  The CPU path, and the kernels' oracle on the card.
  Each counts its runs in ``.calls``.
* ``flash_fwd_cuda`` / ``flash_bwd_dkv_cuda`` / ``flash_bwd_dq_cuda`` —
  wrappers of the kernels: they check device, dtype, shape, contiguity
  and alignment, launch on the current stream, raise on a refused launch
  and count launches in ``.launches``.
* ``flash_fwd`` / ``flash_bwd_dkv`` / ``flash_bwd_dq`` — dispatchers: a
  CPU tensor goes to the plain version, a CUDA tensor to the kernel.  A
  CUDA tensor never reaches a plain version through them.

The dispatchers count by formula under a cost count (``_cost``): the
forward op's FLOPs are registered with the flop counter, and the two
backward dispatchers book theirs through ``_cost.kernel_call``, so a
step counts the same whichever of kernel and plain version ran.

The autograd boundary is the custom op ``epl_torch::flash_attention_fwd``
(``FLASH_FWD_OP``), whose backward runs ``_bwd_kernels``.  Being a
dispatcher op, it is visible to ``torch.utils.checkpoint``'s selective
policies: the GPT's ``remat_policy="dots_flash"`` saves its ``(out,
lse)`` so the recompute of a block never re-runs the forward kernel, the
role ``checkpoint_name("flash_out" / "flash_lse")`` plays in the JAX
package.

Public entry points keep the JAX package's contract: ``flash_attention``
and ``flash_attention_lse`` on ``[B, S, H, D]``, with the block
arguments validated as there (an explicit block must divide the
sequence).  The kernels' own tile is theirs to choose, so ``block_q`` /
``block_k`` keep only their validation meaning.  The TPU block autotune
table (``set_block_want``) waits with ``benchmarks/flash_autotune.py`` for
the port's benchmark (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from easyparallellibrary_tpu_torch.kernels import _cost

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 256
_MAX_BATCH_HEADS = 65535  # the kernels' grid y dimension

# The JAX package's resident/streaming crossover: it no longer selects a
# kernel, but the default block width the public functions validate
# against still follows it (``_heuristic_want``).
_RESIDENT_MAX_BYTES = 1024 * 1024


def _scale(D: int) -> float:
  """1/sqrt(D), applied to fp32 scores (``1.0 / np.sqrt(D)`` there)."""
  return 1.0 / math.sqrt(D)


def _causal_mask(S: int, Skv: int, device) -> torch.Tensor:
  """``q_pos >= k_pos`` over absolute positions, ``[S, Skv]``."""
  return torch.ones((S, Skv), dtype=torch.bool, device=device).tril()


def _scores(q, k, causal: bool) -> torch.Tensor:
  """fp32 scores ``(q . k) * scale``, ``NEG_INF`` where masked."""
  s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * _scale(
      q.shape[-1])
  if causal:
    s = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
  return s


def _probs_and_ds(q, k, v, dout, lse, delta, causal: bool):
  p = torch.exp(_scores(q, k, causal) - lse[..., None])
  dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
  return p, p * (dp - delta[..., None])


# ------------------------------------------------------- plain versions --


def flash_fwd_reference(q, k, v, causal: bool):
  """Full-matrix masked softmax: ``(out [B, H, S, D] in q's dtype,
  lse [B, H, S] fp32)``."""
  flash_fwd_reference.calls += 1
  s = _scores(q, k, causal)
  m = s.amax(-1, keepdim=True)
  p = torch.exp(s - m)
  l_safe = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
  out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                     v.float()) / l_safe
  return out.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal: bool):
  """``(dk, dv)`` from caller-supplied ``lse`` and ``delta``."""
  flash_bwd_dkv_reference.calls += 1
  p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
  dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(),
                    dout.float())
  dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                    q.float()) * _scale(q.shape[-1])
  return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal: bool):
  """``dq`` from caller-supplied ``lse`` and ``delta``."""
  flash_bwd_dq_reference.calls += 1
  _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
  dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                    k.float()) * _scale(q.shape[-1])
  return dq.to(q.dtype)


flash_fwd_reference.calls = 0
flash_bwd_dkv_reference.calls = 0
flash_bwd_dq_reference.calls = 0


# ------------------------------------------------------------- wrappers --


def _library():
  from easyparallellibrary_tpu_torch.kernels import _build
  lib = _build.load("flash_attention")
  if lib.epl_flash_fwd.argtypes is None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.epl_flash_fwd.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float, p]
    lib.epl_flash_bwd_dkv.argtypes = ([p] * 8 + [i] * 6
                                      + [ctypes.c_float, p])
    lib.epl_flash_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [ctypes.c_float, p]
    for fn in (lib.epl_flash_fwd, lib.epl_flash_bwd_dkv,
               lib.epl_flash_bwd_dq):
      fn.restype = ctypes.c_int
    lib.epl_cuda_error_string.argtypes = [i]
    lib.epl_cuda_error_string.restype = ctypes.c_char_p
    lib.epl_flash_route.argtypes = [i, i, i]
    lib.epl_flash_route.restype = i
  return lib


_ROUTE_KERNELS = {"fwd": 0, "dkv": 1, "dq": 2}


def flash_route(kernel: str, dtype: torch.dtype, D: int) -> str:
  """The build the dispatcher gives ``kernel`` (``"fwd"``, ``"dkv"`` or
  ``"dq"``) in ``dtype`` at head dim ``D``: ``"wgmma"`` (the tensor-core
  build) or ``"cuda_cores"``.  The library answers from the gates its
  dispatchers read (``epl_flash_route``), so it is built at the first
  call: on a machine with ``nvcc``."""
  if kernel not in _ROUTE_KERNELS:
    raise ValueError(f"flash_route: kernel {kernel!r} is not one of "
                     f"{sorted(_ROUTE_KERNELS)}")
  if dtype not in _DTYPE_CODES:
    raise ValueError(f"flash_route: dtype {dtype} is not one of "
                     f"{list(_DTYPE_CODES)}")
  code = _library().epl_flash_route(_ROUTE_KERNELS[kernel],
                                    _DTYPE_CODES[dtype], int(D))
  if code not in (0, 1):
    raise RuntimeError(f"epl_flash_route({kernel}, {dtype}, {D}) = {code}")
  return "wgmma" if code == 1 else "cuda_cores"


def _check(name, q, k, v, dout=None, lse=None, delta=None):
  """The kernels' contract; raises ValueError on anything else."""
  floats = [x for x in (q, k, v, dout) if x is not None]
  rows = [x for x in (lse, delta) if x is not None]
  if any(not x.is_cuda for x in floats + rows):
    raise ValueError(f"{name} needs CUDA tensors; got "
                     f"{[str(x.device) for x in floats + rows]}")
  if any(x.device != q.device for x in floats + rows):
    raise ValueError(f"{name}: all tensors must be on one device")
  if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in floats):
    raise ValueError(f"{name} takes float32, bfloat16 or float16 q/k/v/dout "
                     f"of one dtype; got {[x.dtype for x in floats]}")
  if any(x.dtype != torch.float32 for x in rows):
    raise ValueError(f"{name}: lse and delta must be float32")
  if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
    raise ValueError(f"{name}: q [B,H,S,D], k and v [B,H,Skv,D]; got "
                     f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
  B, H, S, D = q.shape
  if k.shape[:2] != (B, H) or k.shape[3] != D:
    raise ValueError(f"{name}: k {tuple(k.shape)} does not match q "
                     f"{tuple(q.shape)}")
  if dout is not None and dout.shape != q.shape:
    raise ValueError(f"{name}: dout {tuple(dout.shape)} != q "
                     f"{tuple(q.shape)}")
  if any(x.shape != (B, H, S) for x in rows):
    raise ValueError(f"{name}: lse/delta must be [B, H, S] = {(B, H, S)}; "
                     f"got {[tuple(x.shape) for x in rows]}")
  if D % 8 or not 0 < D <= _MAX_HEAD_DIM:
    raise ValueError(f"{name}: head dim {D} must be a multiple of 8 in "
                     f"[8, {_MAX_HEAD_DIM}]")
  if not 0 < B * H <= _MAX_BATCH_HEADS or S == 0 or k.shape[2] == 0:
    raise ValueError(f"{name}: B*H = {B * H} must be in [1, "
                     f"{_MAX_BATCH_HEADS}] and the sequences non-empty")
  if any(not x.is_contiguous() for x in floats + rows):
    raise ValueError(f"{name} needs contiguous tensors")
  if any(x.data_ptr() % 16 for x in floats):
    raise ValueError(f"{name} needs 16-byte aligned q/k/v/dout (the "
                     "kernels load 16 bytes per thread, and a TMA tensor "
                     "map needs a 16-byte aligned base)")


def _launch(fn_name, lib, args, dtype, scale, device):
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn_name)(*args, _DTYPE_CODES[dtype], scale, stream)
  if err != 0:
    raise RuntimeError(f"{fn_name} launch failed: cudaError {err} "
                       f"({lib.epl_cuda_error_string(err).decode()})")


def flash_fwd_cuda(q, k, v, causal: bool):
  """Forward kernel on the current stream: ``(out, lse)``."""
  _check("flash_fwd_cuda", q, k, v)
  lib = _library()
  B, H, S, D = q.shape
  out = torch.empty_like(q)
  lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
  _launch("epl_flash_fwd", lib,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr(), B * H, S, k.shape[2], D, int(causal)),
          q.dtype, _scale(D), q.device)
  flash_fwd_cuda.launches += 1
  return out, lse


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal: bool):
  """dK/dV kernel on the current stream: ``(dk, dv)``."""
  _check("flash_bwd_dkv_cuda", q, k, v, dout, lse, delta)
  lib = _library()
  B, H, S, D = q.shape
  dk = torch.empty_like(k)
  dv = torch.empty_like(v)
  _launch("epl_flash_bwd_dkv", lib,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           B * H, S, k.shape[2], D, int(causal)),
          q.dtype, _scale(D), q.device)
  flash_bwd_dkv_cuda.launches += 1
  return dk, dv


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool):
  """dQ kernel on the current stream."""
  _check("flash_bwd_dq_cuda", q, k, v, dout, lse, delta)
  lib = _library()
  B, H, S, D = q.shape
  dq = torch.empty_like(q)
  _launch("epl_flash_bwd_dq", lib,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, S,
           k.shape[2], D, int(causal)),
          q.dtype, _scale(D), q.device)
  flash_bwd_dq_cuda.launches += 1
  return dq


flash_fwd_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0


# ---------------------------------------------------------- dispatchers --


def _route(q, cuda_fn, plain_fn, *args):
  if q.is_cuda:
    return cuda_fn(*args)
  if q.device.type == "cpu":
    return plain_fn(*args)
  raise ValueError(f"flash attention: no implementation for device "
                   f"{q.device}")


def flash_fwd(q, k, v, causal: bool):
  return _route(q, flash_fwd_cuda, flash_fwd_reference, q, k, v, causal)


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool):
  return _cost.kernel_call(
      "flash_bwd_dkv", _cost.attention_flops(q.shape, k.shape), _route, q,
      flash_bwd_dkv_cuda, flash_bwd_dkv_reference, q, k, v, dout, lse, delta,
      causal)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool):
  return _cost.kernel_call(
      "flash_bwd_dq", _cost.attention_flops(q.shape, k.shape), _route, q,
      flash_bwd_dq_cuda, flash_bwd_dq_reference, q, k, v, dout, lse, delta,
      causal)


def reset_counts():
  """Set every launch and call count of this module to 0."""
  for fn in (flash_fwd_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda):
    fn.launches = 0
  for fn in (flash_fwd_reference, flash_bwd_dkv_reference,
             flash_bwd_dq_reference):
    fn.calls = 0


# ------------------------------------------------------------- autograd --


@torch.library.custom_op("epl_torch::flash_attention_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
  return flash_fwd(q, k, v, causal)


@_flash_fwd_op.register_fake
def _(q, k, v, causal):
  return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@register_flop_formula(torch.ops.epl_torch.flash_attention_fwd)
def _flash_fwd_flops(q_shape, k_shape, *args, **kwargs) -> int:
  return _cost.attention_flops(q_shape, k_shape)


def _flash_setup_context(ctx, inputs, output):
  q, k, v, causal = inputs
  out, lse = output
  ctx.causal = causal
  ctx.save_for_backward(q, k, v, out, lse)


def _flash_backward(ctx, dout, dlse):
  # delta = rowsum(dO * O), plain PyTorch as it was plain XLA.  An lse
  # cotangent folds in here: ds = p*(dp - delta + dlse).
  q, k, v, out, lse = ctx.saved_tensors
  dout = dout.contiguous()
  delta = (dout.float() * out.float()).sum(-1)
  if dlse is not None:
    delta = delta - dlse.float()
  dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal)
  dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal)
  return dq, dk, dv, None


_flash_fwd_op.register_autograd(_flash_backward,
                                setup_context=_flash_setup_context)

# The op as the selective-checkpoint policies see it (models/gpt.py).
FLASH_FWD_OP = torch.ops.epl_torch.flash_attention_fwd.default


# ------------------------------------------------------------ block glue --


def _check_blocks(S, Skv, block_q, block_k, *, d, itemsize):
  """Resolve the block widths as the JAX package does (an explicit block
  capped at its sequence, else the default search) and refuse those
  that do not divide it: on the TPU such a block would drop the tail."""
  bq = (min(block_q, S) if block_q else
        _default_block(S, d=d, itemsize=itemsize))
  bk = (min(block_k, Skv) if block_k else
        _default_block(Skv, d=d, itemsize=itemsize))
  if not bq or not bk or S % bq or Skv % bk:
    raise ValueError(
        f"block sizes ({bq}, {bk}) must divide the sequence lengths "
        f"(q={S}, kv={Skv})")


def _bwd_kernels(q, k, v, dout, lse, delta, causal, block_q, block_k):
  """dQ, dK, dV from caller-supplied ``lse`` and ``delta`` (``[B, H,
  S]`` fp32; the JAX version takes them sublane-tiled ``[B, H, 8, S]``).
  Shared by the flash backward (per-call lse, ``delta = rowsum(dO*O) -
  dlse``) and ring attention's global-LSE backward."""
  _check_blocks(q.shape[2], k.shape[2], block_q, block_k, d=q.shape[3],
                itemsize=q.element_size())
  dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal)
  dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal)
  return dq, dk, dv


def _heuristic_want(S: int, d: int, itemsize: int) -> int:
  """The untuned block-width default: 512 in the JAX package's resident
  regime, 1024 past it."""
  return 512 if S * d * itemsize <= _RESIDENT_MAX_BYTES else 1024


def _default_block(S: int, want: int = 0, *, d: int,
                   itemsize: int = 2) -> int:
  """Largest block <= ``want`` that divides S (halving from ``want``,
  floor 8); S itself when shorter than ``want``; 0 when no such block
  divides S (e.g. S = 515) — callers raise or take a non-kernel path."""
  if not want:
    want = _heuristic_want(S, d, itemsize)
  if S <= want:
    return S
  b = want
  while b > 8 and S % b:
    b //= 2
  return b if S % b == 0 else 0


def flash_blockable(S: int, *, d: int, itemsize: int = 2) -> bool:
  """Whether the default block search tiles sequence length S."""
  return _default_block(S, d=d, itemsize=itemsize) > 0


def _heads_first(x):
  return x.transpose(1, 2).contiguous()


def flash_attention_lse(q, k, v, causal: bool = True,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None):
  """Flash attention over ``[B, S, H, D]`` that also returns the
  per-position log-sum-exp, fp32 ``[B, S, H]`` (what merges attention
  over KV chunks).  The backward takes a cotangent for lse."""
  _check_blocks(q.shape[1], k.shape[1], block_q, block_k, d=q.shape[3],
                itemsize=q.element_size())
  out, lse = _flash_fwd_op(_heads_first(q), _heads_first(k),
                           _heads_first(v), causal)
  return out.transpose(1, 2), lse.transpose(1, 2)


def flash_attention(q, k, v, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
  """Flash attention over ``[B, S, H, D]`` inputs (the models' layout);
  the scale 1/sqrt(D) is applied inside.  An explicitly passed block
  size must divide the sequence length."""
  return flash_attention_lse(q, k, v, causal, block_q, block_k)[0]
