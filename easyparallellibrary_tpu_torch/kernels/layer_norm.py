"""LayerNorm (K3): a CUDA kernel forward and one backward, and their plain
versions.

flax's ``nn.LayerNorm`` as the port's ``ops/layers.py`` computes it:
fp32 statistics, the fast variance ``E[x^2] - E[x]^2`` clipped at 0,
``rsqrt(var + eps) * weight`` and ``+ bias`` in fp32, the result cast to
the output dtype.  Run eagerly, that formula is 14 launches forward and
29 in its autograd backward, each over full-size fp32 tensors; the
kernels in ``csrc/layer_norm.cu`` run it as one launch forward and two
backward (the rows, then the column sums of dgamma and dbeta).  No TPU
kernel is replaced: the JAX package leaves the formula to XLA's fusion.

Each direction comes in three forms:

* ``layer_norm_reference`` / ``layer_norm_bwd_reference`` — plain
  PyTorch over any ``[..., d]``.  The forward is the formula; the
  backward is autograd of it, so the CPU path's gradients are the
  formula's bit for bit.  The CPU path, and the kernels' oracle on the
  card.  Each counts its runs in ``.calls``.
* ``layer_norm_fwd_cuda`` / ``layer_norm_bwd_cuda`` — wrappers of the
  kernels over rows ``[R, d]``: they check device, dtype, shape,
  contiguity and alignment, launch on the current stream, raise on a
  refused launch, and count launches in ``.launches`` (one a call; the
  backward's column-sum launch is part of its call).  The inputs and
  outputs may be fp32, bf16 or fp16, each on its own; weight and bias
  are fp32, the gradients of both fp32.
* ``layer_norm_fwd`` / ``layer_norm_bwd`` — dispatchers: a CPU tensor
  goes to the plain version, a CUDA tensor to the kernel.  A CUDA tensor
  never reaches a plain version through them.  The backward counts as
  one kernel under a cost count (``_cost.kernel_call``), on either
  device.

The autograd boundary is the custom op ``epl_torch::layer_norm``
(``LAYER_NORM_OP``), whose backward runs ``layer_norm_bwd`` from the
saved input, weight and bias: nothing else is kept for the backward.  To
the selective-checkpoint policies (``models/gpt.py`` ``_remat_context``)
it is one op, not a product, so a block's recompute runs each LayerNorm
as one launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from easyparallellibrary_tpu_torch.kernels import _cost

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_WIDTH = 8192  # csrc/layer_norm.cu: kMaxWidth


# ------------------------------------------------------- plain versions --


def _formula(x, weight, bias, eps: float, dtype: torch.dtype):
  stat_dtype = torch.promote_types(x.dtype, torch.float32)
  xf = x.to(stat_dtype)
  mean = xf.mean(-1, keepdim=True)
  mean2 = (xf * xf).mean(-1, keepdim=True)
  var = torch.clamp(mean2 - mean * mean, min=0.0)
  mul = torch.rsqrt(var + eps) * weight
  y = (xf - mean) * mul + bias
  return y.to(dtype)


def layer_norm_reference(x, weight, bias, eps: float, dtype: torch.dtype):
  """flax's LayerNorm over the last dim of ``x``, in ``dtype``."""
  layer_norm_reference.calls += 1
  return _formula(x, weight, bias, eps, dtype)


def layer_norm_bwd_reference(x, weight, bias, dy, eps: float):
  """``(dx, dweight, dbias)`` for the cotangent ``dy`` of the output
  (whose dtype it has): autograd of the formula."""
  layer_norm_bwd_reference.calls += 1
  with torch.enable_grad():
    leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
    y = _formula(*leaves, eps, dy.dtype)
    return torch.autograd.grad(y, leaves, dy)


layer_norm_reference.calls = 0
layer_norm_bwd_reference.calls = 0


# ------------------------------------------------------------- wrappers --


def _library():
  from easyparallellibrary_tpu_torch.kernels import _build
  lib = _build.load("layer_norm")
  if lib.epl_layer_norm_fwd.argtypes is None:
    i, i64, p = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.epl_layer_norm_fwd.argtypes = ([p] * 4 + [i64, i, i, i]
                                       + [ctypes.c_float, p])
    lib.epl_layer_norm_bwd_blocks.argtypes = [i64, i, i, i]
    lib.epl_layer_norm_bwd.argtypes = ([p] * 7 + [i, i64, i, i, i]
                                       + [ctypes.c_float, p])
    for fn in (lib.epl_layer_norm_fwd, lib.epl_layer_norm_bwd_blocks,
               lib.epl_layer_norm_bwd):
      fn.restype = i
    lib.epl_cuda_error_string.argtypes = [i]
    lib.epl_cuda_error_string.restype = ctypes.c_char_p
  return lib


def _check(name, x, weight, bias=None, dy=None):
  """The kernels' contract; raises ValueError on anything else."""
  tensors = [t for t in (x, weight, bias, dy) if t is not None]
  if any(not t.is_cuda for t in tensors):
    raise ValueError(f"{name} needs CUDA tensors; got "
                     f"{[str(t.device) for t in tensors]}")
  if any(t.device != x.device for t in tensors):
    raise ValueError(f"{name}: all tensors must be on one device")
  rows = [x] + ([dy] if dy is not None else [])
  if any(t.dtype not in _DTYPE_CODES for t in rows):
    raise ValueError(f"{name} takes float32, bfloat16 or float16 rows; "
                     f"got {[t.dtype for t in rows]}")
  params = [t for t in (weight, bias) if t is not None]
  if any(t.dtype != torch.float32 for t in params):
    raise ValueError(f"{name}: weight and bias must be float32; got "
                     f"{[t.dtype for t in params]}")
  if x.dim() != 2:
    raise ValueError(f"{name}: x must be rows [R, d]; got "
                     f"{tuple(x.shape)}")
  d = x.shape[1]
  if not 0 < d <= MAX_WIDTH:
    raise ValueError(f"{name}: width {d} must be in [1, {MAX_WIDTH}]")
  if any(t.shape != (d,) for t in params):
    raise ValueError(f"{name}: weight and bias must be [{d}]; got "
                     f"{[tuple(t.shape) for t in params]}")
  if dy is not None and dy.shape != x.shape:
    raise ValueError(f"{name}: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
  if any(not t.is_contiguous() for t in tensors):
    raise ValueError(f"{name} needs contiguous tensors")
  if any(t.data_ptr() % t.element_size() for t in tensors):
    raise ValueError(f"{name} needs element-aligned tensors")


def _raise_on(fn_name, lib, err):
  if err != 0:
    raise RuntimeError(f"{fn_name} launch failed: cudaError {err} "
                       f"({lib.epl_cuda_error_string(err).decode()})")


def _stream(device):
  return torch.cuda.current_stream(device).cuda_stream


def layer_norm_fwd_cuda(x, weight, bias, eps: float, dtype: torch.dtype):
  """Forward kernel on the current stream: ``y [R, d]`` in ``dtype``."""
  _check("layer_norm_fwd_cuda", x, weight, bias)
  if dtype not in _DTYPE_CODES:
    raise ValueError(f"layer_norm_fwd_cuda: output dtype {dtype} is not "
                     f"one of {list(_DTYPE_CODES)}")
  y = torch.empty(x.shape, dtype=dtype, device=x.device)
  if x.shape[0] == 0:
    return y
  lib = _library()
  with torch.cuda.device(x.device):
    err = lib.epl_layer_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        x.shape[0], x.shape[1], _DTYPE_CODES[x.dtype], _DTYPE_CODES[dtype],
        eps, _stream(x.device))
  _raise_on("epl_layer_norm_fwd", lib, err)
  layer_norm_fwd_cuda.launches += 1
  return y


def layer_norm_bwd_cuda(x, weight, dy, eps: float):
  """Backward kernels on the current stream: ``(dx, dweight, dbias)``,
  dx in x's dtype, the other two fp32."""
  _check("layer_norm_bwd_cuda", x, weight, dy=dy)
  R, d = x.shape
  dx = torch.empty_like(x)
  if R == 0:
    zeros = torch.zeros(d, dtype=torch.float32, device=x.device)
    return dx, zeros, zeros.clone()
  dweight = torch.empty(d, dtype=torch.float32, device=x.device)
  dbias = torch.empty(d, dtype=torch.float32, device=x.device)
  lib = _library()
  codes = _DTYPE_CODES[x.dtype], _DTYPE_CODES[dy.dtype]
  with torch.cuda.device(x.device):
    grid = lib.epl_layer_norm_bwd_blocks(R, d, *codes)
    _raise_on("epl_layer_norm_bwd_blocks", lib, -min(grid, 0))
    part = torch.empty((2, grid, d), dtype=torch.float32, device=x.device)
    err = lib.epl_layer_norm_bwd(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), dx.data_ptr(),
        dweight.data_ptr(), dbias.data_ptr(), part.data_ptr(), grid, R, d,
        *codes, eps, _stream(x.device))
  _raise_on("epl_layer_norm_bwd", lib, err)
  layer_norm_bwd_cuda.launches += 1
  return dx, dweight, dbias


layer_norm_fwd_cuda.launches = 0
layer_norm_bwd_cuda.launches = 0


# ---------------------------------------------------------- dispatchers --


def _rows(t):
  return t.reshape(-1, t.shape[-1]).contiguous()


def _no_device(x):
  return ValueError(f"layer norm: no implementation for device {x.device}")


def layer_norm_fwd(x, weight, bias, eps: float, dtype: torch.dtype):
  if x.is_cuda:
    return layer_norm_fwd_cuda(_rows(x), weight, bias, eps,
                               dtype).view(x.shape)
  if x.device.type == "cpu":
    return layer_norm_reference(x, weight, bias, eps, dtype)
  raise _no_device(x)


def _bwd(x, weight, bias, dy, eps):
  if x.is_cuda:
    dx, dweight, dbias = layer_norm_bwd_cuda(_rows(x), weight, _rows(dy),
                                             eps)
    return dx.view(x.shape), dweight, dbias
  if x.device.type == "cpu":
    return layer_norm_bwd_reference(x, weight, bias, dy, eps)
  raise _no_device(x)


def layer_norm_bwd(x, weight, bias, dy, eps: float):
  return _cost.kernel_call("layer_norm_bwd", 0, _bwd, x, weight, bias, dy,
                           eps)


def reset_counts():
  """Set every launch and call count of this module to 0."""
  layer_norm_fwd_cuda.launches = 0
  layer_norm_bwd_cuda.launches = 0
  layer_norm_reference.calls = 0
  layer_norm_bwd_reference.calls = 0


# ------------------------------------------------------------- autograd --


@torch.library.custom_op("epl_torch::layer_norm", mutates_args=())
def _layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, dtype: torch.dtype) -> torch.Tensor:
  return layer_norm_fwd(x, weight, bias, eps, dtype)


@_layer_norm_op.register_fake
def _(x, weight, bias, eps, dtype):
  return x.new_empty(x.shape, dtype=dtype)


def _setup_context(ctx, inputs, output):
  x, weight, bias, eps, _ = inputs
  ctx.eps = eps
  ctx.save_for_backward(x, weight, bias)


def _backward(ctx, dy):
  x, weight, bias = ctx.saved_tensors
  dx, dweight, dbias = layer_norm_bwd(x, weight, bias, dy, ctx.eps)
  return dx, dweight, dbias, None, None


_layer_norm_op.register_autograd(_backward, setup_context=_setup_context)

# The op as the selective-checkpoint policies see it.
LAYER_NORM_OP = torch.ops.epl_torch.layer_norm.default


def layer_norm(x, weight, bias, eps: float = 1e-6,
               dtype: Optional[torch.dtype] = None):
  """flax's LayerNorm over the last dim of ``x`` with fp32 ``weight`` and
  ``bias``, the result in ``dtype`` (default: x's)."""
  return _layer_norm_op(x, weight, bias, eps, dtype or x.dtype)
