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

Each wgmma kernel has tile builds: its inner tile (the forward's and
dQ's KV tile, 64 or 128 keys; dK/dV's Q tile, 32 or 64 rows) and the
depth of its TMA ring (2 or 3 stages) are template parameters
(``WGMMA_BUILDS``; the library lists its own in ``flash_builds``, and
``flash_build_info`` its registers and spills).  A
call takes the build that ``flash_tile`` resolves from its ``(S, D,
itemsize)`` through the block table: the port of the JAX package's
autotune table (``set_block_want``, ``flash_block_table.json`` beside
this module, written on the card by ``kernels/flash_autotune.py``).  A
table entry applies only on the card whose name it records; a shape
without one takes ``DEFAULT_BUILD``.  The CUDA-core kernels have one
tile (``CUDA_CORE_BUILD``).

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
  and alignment, launch on the current stream the build given or the one
  ``flash_tile`` resolves, raise on a refused launch or a build there is
  not, and count launches in ``.launches`` and, by ``(tile, stages)``,
  in ``.by_tile``.
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
sequence).  The kernels' own tile comes from the block table, so
``block_q`` / ``block_k`` keep only their validation meaning; the table's
``want`` for a shape is both the default block those arguments are
validated against (``_default_block``, as in the JAX package) and the
width the kernels' tiles are resolved from (``flash_tile``).
"""

from __future__ import annotations

import ctypes
import json
import math
import os
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from easyparallellibrary_tpu_torch.kernels import _cost
from easyparallellibrary_tpu_torch.observability.trace import step_span

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 256
_MAX_BATCH_HEADS = 65535  # the kernels' grid y dimension

# The JAX package's resident/streaming crossover: it no longer selects a
# kernel, but the default block width the public functions validate
# against still follows it (``_heuristic_want``).
_RESIDENT_MAX_BYTES = 1024 * 1024

# The wgmma kernels' builds, ``(tile, stages)`` by kernel and head dim, as
# ``each_build`` in csrc/flash_attention.cu lists them (``flash_builds``
# reads the library's own list on the card): each inner tile at ring
# depths 2 and 3 where the layout fits in the 227 KB of shared memory a
# CTA may take and ptxas does not spill.  dQ at D = 128 with 128-key
# tiles fits two stages only (Q, dO and three stages of K and V would be
# 256 KB); dK/dV at D = 128 spills at every build under the 168 registers
# a 288-thread CTA may take, and keeps the one it has always had.
WGMMA_BUILDS = {
    ("fwd", 64): ((64, 2), (64, 3), (128, 2), (128, 3)),
    ("fwd", 128): ((64, 2), (64, 3), (128, 2), (128, 3)),
    ("dkv", 64): ((32, 2), (32, 3), (64, 2), (64, 3)),
    ("dkv", 128): ((64, 2),),
    ("dq", 64): ((64, 2), (64, 3), (128, 2), (128, 3)),
    ("dq", 128): ((64, 2), (64, 3), (128, 2)),
}
DEFAULT_BUILD = (64, 2)    # a shape the block table does not name
CUDA_CORE_BUILD = (64, 1)  # the CUDA-core kernels: one tile, no TMA ring


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
    ints = ctypes.POINTER(ctypes.c_int)
    lib.epl_flash_fwd.argtypes = [p] * 5 + [i] * 8 + [ctypes.c_float, p]
    lib.epl_flash_bwd_dkv.argtypes = ([p] * 8 + [i] * 8
                                      + [ctypes.c_float, p])
    lib.epl_flash_bwd_dq.argtypes = [p] * 7 + [i] * 8 + [ctypes.c_float, p]
    for fn in (lib.epl_flash_fwd, lib.epl_flash_bwd_dkv,
               lib.epl_flash_bwd_dq):
      fn.restype = ctypes.c_int
    lib.epl_cuda_error_string.argtypes = [i]
    lib.epl_cuda_error_string.restype = ctypes.c_char_p
    lib.epl_flash_route.argtypes = [i, i, i]
    lib.epl_flash_route.restype = i
    lib.epl_flash_builds.argtypes = [i, i, i, ints, i]
    lib.epl_flash_builds.restype = i
    lib.epl_flash_build_info.argtypes = [i] * 5 + [ints]
    lib.epl_flash_build_info.restype = i
  return lib


_ROUTE_KERNELS = {"fwd": 0, "dkv": 1, "dq": 2}


def _kernel_and_dtype(fn, kernel, dtype):
  if kernel not in _ROUTE_KERNELS:
    raise ValueError(f"{fn}: kernel {kernel!r} is not one of "
                     f"{sorted(_ROUTE_KERNELS)}")
  if dtype not in _DTYPE_CODES:
    raise ValueError(f"{fn}: dtype {dtype} is not one of "
                     f"{list(_DTYPE_CODES)}")
  return _ROUTE_KERNELS[kernel], _DTYPE_CODES[dtype]


def wgmma_takes(dtype: torch.dtype, D: int) -> bool:
  """Whether the wgmma builds take a call in ``dtype`` at head dim ``D``
  (the library's ``wgmma_takes`` and ``wg::with_head_dim``, which
  ``flash_route`` reports on the card)."""
  return dtype in (torch.bfloat16, torch.float16) and D in (64, 128)


def kernel_builds(kernel: str, dtype: torch.dtype, D: int):
  """The ``(tile, stages)`` builds ``kernel`` has in ``dtype`` at head dim
  ``D``: ``WGMMA_BUILDS`` where the wgmma builds take the call, else the
  CUDA-core build alone."""
  _kernel_and_dtype("kernel_builds", kernel, dtype)
  if wgmma_takes(dtype, D):
    return WGMMA_BUILDS[kernel, D]
  return (CUDA_CORE_BUILD,)


def flash_builds(kernel: str, dtype: torch.dtype, D: int):
  """The builds the library has for ``kernel`` in ``dtype`` at head dim
  ``D``, as ``(tile, stages)`` pairs (``epl_flash_builds``; card only:
  it builds the library)."""
  code = _kernel_and_dtype("flash_builds", kernel, dtype)
  out = (ctypes.c_int * 32)()
  n = _library().epl_flash_builds(*code, int(D), out, 16)
  if not 0 < n <= 16:
    raise RuntimeError(f"epl_flash_builds({kernel}, {dtype}, {D}) = {n}")
  return tuple((out[2 * j], out[2 * j + 1]) for j in range(n))


def flash_build_info(kernel: str, dtype: torch.dtype, D: int, tile: int,
                     stages: int) -> Dict[str, int]:
  """Registers a thread, local-memory (spill) bytes a thread and dynamic
  shared memory of a wgmma build, as the loaded binary reports them
  (``epl_flash_build_info``; card only)."""
  code = _kernel_and_dtype("flash_build_info", kernel, dtype)
  info = (ctypes.c_int * 3)()
  lib = _library()
  err = lib.epl_flash_build_info(*code, int(D), int(tile), int(stages),
                                 info)
  if err != 0:
    raise RuntimeError(
        f"epl_flash_build_info({kernel}, {dtype}, {D}, {tile}, {stages}): "
        f"cudaError {err} ({lib.epl_cuda_error_string(err).decode()})")
  return {"registers": info[0], "local_bytes": info[1],
          "smem_bytes": info[2]}


def flash_route(kernel: str, dtype: torch.dtype, D: int,
                S: Optional[int] = None):
  """The build the dispatcher gives ``kernel`` (``"fwd"``, ``"dkv"`` or
  ``"dq"``) in ``dtype`` at head dim ``D``: ``"wgmma"`` (the tensor-core
  build) or ``"cuda_cores"``; given the sequence length ``S`` too,
  ``(route, tile, stages)``, the tile that ``flash_tile`` resolves, held
  against the library's own builds.  The library answers from the gates
  its dispatchers read (``epl_flash_route``, ``epl_flash_builds``), so it
  is built at the first call: on a machine with ``nvcc``."""
  code = _kernel_and_dtype("flash_route", kernel, dtype)
  route = _library().epl_flash_route(*code, int(D))
  if route not in (0, 1):
    raise RuntimeError(f"epl_flash_route({kernel}, {dtype}, {D}) = {route}")
  name = "wgmma" if route == 1 else "cuda_cores"
  if S is None:
    return name
  build = flash_tile(kernel, S, D, dtype)
  if build not in flash_builds(kernel, dtype, D):
    raise RuntimeError(f"flash_tile({kernel}, {S}, {D}, {dtype}) = {build} "
                       f"is not a build of the library")
  return (name,) + build


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


def _build_of(kernel, q, build):
  """The ``(tile, stages)`` a launch takes: ``build`` when given, else
  the block table's (``flash_tile``)."""
  if build is None:
    return flash_tile(kernel, q.shape[2], q.shape[3], q.dtype)
  return tuple(int(x) for x in build)


def _counted(wrapper, build):
  wrapper.launches += 1
  wrapper.by_tile[build] = wrapper.by_tile.get(build, 0) + 1


def flash_fwd_cuda(q, k, v, causal: bool, build=None):
  """Forward kernel on the current stream: ``(out, lse)``.  ``build``:
  the ``(tile, stages)`` to launch (default: the block table's)."""
  _check("flash_fwd_cuda", q, k, v)
  lib = _library()
  B, H, S, D = q.shape
  tile, stages = build = _build_of("fwd", q, build)
  out = torch.empty_like(q)
  lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
  _launch("epl_flash_fwd", lib,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr(), B * H, S, k.shape[2], D, int(causal), tile,
           stages), q.dtype, _scale(D), q.device)
  _counted(flash_fwd_cuda, build)
  return out, lse


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal: bool, build=None):
  """dK/dV kernel on the current stream: ``(dk, dv)``.  ``build``: as
  the forward's."""
  _check("flash_bwd_dkv_cuda", q, k, v, dout, lse, delta)
  lib = _library()
  B, H, S, D = q.shape
  tile, stages = build = _build_of("dkv", q, build)
  dk = torch.empty_like(k)
  dv = torch.empty_like(v)
  _launch("epl_flash_bwd_dkv", lib,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           B * H, S, k.shape[2], D, int(causal), tile, stages),
          q.dtype, _scale(D), q.device)
  _counted(flash_bwd_dkv_cuda, build)
  return dk, dv


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool, build=None):
  """dQ kernel on the current stream.  ``build``: as the forward's."""
  _check("flash_bwd_dq_cuda", q, k, v, dout, lse, delta)
  lib = _library()
  B, H, S, D = q.shape
  tile, stages = build = _build_of("dq", q, build)
  dq = torch.empty_like(q)
  _launch("epl_flash_bwd_dq", lib,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, S,
           k.shape[2], D, int(causal), tile, stages),
          q.dtype, _scale(D), q.device)
  _counted(flash_bwd_dq_cuda, build)
  return dq


for _wrapper in (flash_fwd_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda):
  _wrapper.launches = 0
  _wrapper.by_tile = {}


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
    fn.by_tile = {}
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
  with step_span("train/flash_delta"):
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


# The block table: {(S, d, itemsize): want}, read lazily from
# flash_block_table.json beside this module (written on the card by
# kernels/flash_autotune.py; the JAX package's format, {"device": <card
# name>, "entries": {"S:d:itemsize": want}}, where an entry may also be
# {"want": want, "stages": depth}).  Entries apply to their exact shape
# ONLY when the file's device is this process's card
# (torch.cuda.get_device_name()): widths tuned on one card must not
# reach another, nor a CPU run.  Lazy because it asks CUDA for the
# card's name, which must not happen at import.  A stage depth an entry
# carries is in _BLOCK_STAGES.
_BLOCK_TABLE: Optional[dict] = None
_BLOCK_STAGES: dict = {}
_BLOCK_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "flash_block_table.json")


def _device_kind() -> Optional[str]:
  """The card's name as the table records it; None without a card."""
  return torch.cuda.get_device_name() if torch.cuda.is_available() else None


def _read_block_table(path: str, device: Optional[str]):
  """``(wants, stages)`` of the table at ``path`` for ``device``: empty
  when the file is missing, malformed or another device's (the table is
  an optimisation, never a correctness dependency)."""
  try:
    with open(path) as f:
      raw = json.load(f)
  except (OSError, ValueError):
    return {}, {}
  entries = raw.get("entries") if isinstance(raw, dict) else None
  if device is None or not isinstance(entries, dict) or raw.get(
      "device") != device:
    return {}, {}
  wants, stages = {}, {}
  try:
    for key, value in entries.items():
      shape = tuple(int(x) for x in key.split(":"))
      if len(shape) != 3:
        raise ValueError(key)
      if isinstance(value, dict):
        wants[shape] = int(value["want"])
        if value.get("stages") is not None:
          stages[shape] = int(value["stages"])
      else:
        wants[shape] = int(value)
  except (AttributeError, KeyError, TypeError, ValueError):
    return {}, {}
  return wants, stages


def _ensure_block_table() -> dict:
  global _BLOCK_TABLE
  if _BLOCK_TABLE is None:
    wants, stages = _read_block_table(_BLOCK_TABLE_PATH, _device_kind())
    _BLOCK_STAGES.clear()
    _BLOCK_STAGES.update(stages)
    _BLOCK_TABLE = wants
  return _BLOCK_TABLE


def set_block_want(S: int, d: int, itemsize: int, want: int,
                   stages: Optional[int] = None) -> None:
  """Programmatic block-table entry, and the TMA ring depth the kernels
  take at this shape (default: the default build's).  ``want = 0``
  leaves the shape to the defaults."""
  key = (S, d, itemsize)
  _ensure_block_table()[key] = int(want)
  if stages is None:
    _BLOCK_STAGES.pop(key, None)
  else:
    _BLOCK_STAGES[key] = int(stages)


def tile_for_want(kernel: str, D: int, dtype: torch.dtype, want: int,
                  stages: Optional[int] = None) -> Tuple[int, int]:
  """The ``(tile, stages)`` build of ``kernel`` at head dim ``D`` in
  ``dtype`` that a block width ``want`` names: the kernel's largest inner
  tile <= ``want`` (its smallest when none is), at ring depth ``stages``
  (default: the default build's) where that tile has it, else the
  deepest below it.  The CUDA-core kernels have ``CUDA_CORE_BUILD``
  alone."""
  builds = kernel_builds(kernel, dtype, D)
  if builds == (CUDA_CORE_BUILD,):
    return CUDA_CORE_BUILD
  tiles = sorted({t for t, _ in builds})
  tile = max((t for t in tiles if t <= want), default=tiles[0])
  depths = sorted(s for t, s in builds if t == tile)
  wanted = DEFAULT_BUILD[1] if stages is None else stages
  return tile, max((s for s in depths if s <= wanted), default=depths[0])


def flash_tile(kernel: str, S: int, D: int,
               dtype: torch.dtype) -> Tuple[int, int]:
  """The ``(tile, stages)`` build ``kernel`` takes at sequence length
  ``S`` and head dim ``D`` in ``dtype``: ``tile_for_want`` of the block
  table's entry for ``(S, D, itemsize)`` and its ring depth; without an
  entry ``DEFAULT_BUILD`` (``CUDA_CORE_BUILD`` on the CUDA-core
  kernels)."""
  key = (S, D, dtype.itemsize)
  want = _ensure_block_table().get(key) or DEFAULT_BUILD[0]
  return tile_for_want(kernel, D, dtype, want, _BLOCK_STAGES.get(key))


def _heuristic_want(S: int, d: int, itemsize: int) -> int:
  """The untuned block-width default: 512 in the JAX package's resident
  regime, 1024 past it."""
  return 512 if S * d * itemsize <= _RESIDENT_MAX_BYTES else 1024


def _default_block(S: int, want: int = 0, *, d: int,
                   itemsize: int = 2) -> int:
  """Largest block <= ``want`` that divides S (halving from ``want``,
  floor 8); S itself when shorter than ``want``; 0 when no such block
  divides S (e.g. S = 515) — callers raise or take a non-kernel path.
  Default ``want``: the block table's entry for ``(S, d, itemsize)``
  when there is one, else ``_heuristic_want``."""
  if not want:
    want = _ensure_block_table().get((S, d, itemsize))
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
