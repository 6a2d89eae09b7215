"""Paged-attention decode: the Hopper CUDA kernel and its plain version.

Port of ``easyparallellibrary_tpu/kernels/paged_attention.py``.  Each
token of one flat serving batch attends its own causal prefix through
its slot's block table (shapes below).  Three functions:

* :func:`paged_attention_reference` — plain PyTorch, numerically the
  mirror of the JAX reference (``-1e9`` mask, fp32 softmax, probabilities
  cast back to the input dtype before the V product).  The CPU path, and
  the oracle the kernel is held against on the card.
* :func:`paged_attention_cuda` — the wrapper of the hand-written CUDA
  kernel ``csrc/paged_attention.cu`` (it replaces the Pallas
  ``_paged_kernel``).  CUDA tensors only; a build or launch failure
  raises.
* :func:`paged_attention` — the dispatcher: a CPU tensor goes to the
  plain version, a CUDA tensor to the kernel.  A CUDA tensor never
  reaches the plain version through it; on the card the plain version is
  reached only by name.

Each of the two implementations keeps a plain integer count of its runs
(``paged_attention_cuda.launches``, ``paged_attention_reference.calls``)
so a run can show which one its main path went through.

Shapes (one flat token batch, serving/engine.py):

* ``q``                 ``[T, H, hd]``  this step's query rows
* ``k_pages/v_pages``   ``[NB, bs, H, hd]`` the paged cache pool
* ``tables_tok``        ``[T, MB]`` int32, each token's slot block table
* ``positions``         ``[T]`` int32, each token's absolute position

Token ``t`` attends virtual rows ``j <= positions[t]``, row ``j``
resolved through ``tables_tok[t, j // bs]`` to pool row
``table_entry * bs + j % bs``.
"""

from __future__ import annotations

import ctypes
import math

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256


def paged_attention_reference(q, k_pages, v_pages, tables_tok, positions):
  """Dense-gather plain version: gather every table row, mask rows past
  each token's position with ``-1e9``, softmax in fp32."""
  paged_attention_reference.calls += 1
  T, H, hd = q.shape
  bs = k_pages.shape[1]
  MB = tables_tok.shape[1]
  L = MB * bs
  dtype = q.dtype
  # sqrt(hd) in fp32, rounded to the dtype, as jnp.sqrt(hd).astype(dtype).
  scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=q.device)).to(dtype)
  tables = tables_tok.long()
  kk = k_pages[tables].reshape(T, L, H, hd)
  vv = v_pages[tables].reshape(T, L, H, hd)
  logits = torch.einsum("thd,tlhd->thl", q, kk) * scale
  valid = (torch.arange(L, device=q.device)[None, None, :]
           <= positions.long()[:, None, None])
  logits = torch.where(valid, logits,
                       torch.tensor(-1e9, dtype=logits.dtype,
                                    device=q.device))
  probs = torch.softmax(logits.float(), dim=-1)
  return torch.einsum("thl,tlhd->thd", probs.to(dtype), vv)


paged_attention_reference.calls = 0


def _library():
  from easyparallellibrary_tpu_torch.kernels import _build
  lib = _build.load("paged_attention")
  fn = lib.epl_paged_attention
  if fn.argtypes is None:
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.epl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.epl_cuda_error_string.restype = ctypes.c_char_p
  return lib


def _check_args(q, k_pages, v_pages, tables_tok, positions):
  tensors = (q, k_pages, v_pages, tables_tok, positions)
  if any(not x.is_cuda for x in tensors):
    raise ValueError("paged_attention_cuda needs CUDA tensors; got "
                     f"{[str(x.device) for x in tensors]}")
  if any(x.device != q.device for x in tensors):
    raise ValueError("paged_attention_cuda: all tensors must be on one "
                     "device")
  if q.dtype not in _DTYPE_CODES:
    raise ValueError(f"paged_attention_cuda supports float32 and bfloat16; "
                     f"got {q.dtype}")
  if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
    raise ValueError("paged_attention_cuda: q and the pools must share "
                     f"one dtype; got {q.dtype}, {k_pages.dtype}, "
                     f"{v_pages.dtype}")
  if tables_tok.dtype != torch.int32 or positions.dtype != torch.int32:
    raise ValueError("paged_attention_cuda: tables_tok and positions must "
                     "be int32")
  if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
    raise ValueError(f"paged_attention_cuda: bad ranks/shapes q "
                     f"{tuple(q.shape)}, pools {tuple(k_pages.shape)} / "
                     f"{tuple(v_pages.shape)}")
  T, H, hd = q.shape
  if k_pages.shape[2:] != (H, hd):
    raise ValueError(f"paged_attention_cuda: pool heads/dims "
                     f"{tuple(k_pages.shape[2:])} != q's {(H, hd)}")
  if tables_tok.dim() != 2 or tables_tok.shape[0] != T \
      or positions.shape != (T,):
    raise ValueError(f"paged_attention_cuda: tables_tok "
                     f"{tuple(tables_tok.shape)} / positions "
                     f"{tuple(positions.shape)} do not match T={T}")
  if hd % 8 or not 0 < hd <= _MAX_HEAD_DIM:
    raise ValueError(f"paged_attention_cuda: head dim {hd} must be a "
                     f"multiple of 8 in [8, {_MAX_HEAD_DIM}]")
  for x in tensors:
    if not x.is_contiguous():
      raise ValueError("paged_attention_cuda needs contiguous tensors")
  for x in (q, k_pages, v_pages):
    if x.data_ptr() % 16:
      raise ValueError("paged_attention_cuda needs 16-byte aligned q and "
                       "pools (the kernel loads 16 bytes per lane)")


def paged_attention_cuda(q, k_pages, v_pages, tables_tok, positions):
  """Launch the CUDA kernel on the current stream; returns ``[T, H, hd]``
  in ``q``'s dtype.  Raises on arguments the kernel does not take and on
  a refused launch."""
  _check_args(q, k_pages, v_pages, tables_tok, positions)
  lib = _library()
  T, H, hd = q.shape
  NB, bs = k_pages.shape[:2]
  MB = tables_tok.shape[1]
  out = torch.empty_like(q)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.epl_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables_tok.data_ptr(), positions.data_ptr(), out.data_ptr(),
        T, H, hd, NB, bs, MB, _DTYPE_CODES[q.dtype],
        1.0 / math.sqrt(hd), stream)
  if err != 0:
    raise RuntimeError(
        f"paged_attention kernel launch failed: cudaError {err} "
        f"({lib.epl_cuda_error_string(err).decode()})")
  paged_attention_cuda.launches += 1
  return out


paged_attention_cuda.launches = 0


def paged_attention(q, k_pages, v_pages, tables_tok, positions):
  """Paged gather-attend over a flat token batch (module docstring):
  the kernel for CUDA tensors, the plain version for CPU tensors."""
  if q.is_cuda:
    return paged_attention_cuda(q, k_pages, v_pages, tables_tok, positions)
  if q.device.type == "cpu":
    return paged_attention_reference(q, k_pages, v_pages, tables_tok,
                                     positions)
  raise ValueError(f"paged_attention: no implementation for device "
                   f"{q.device}")
