"""ResNet — the image family of BASELINE rows 1 and 3 (port of
``easyparallellibrary_tpu/models/resnet.py``).

As the flax module, the model takes NHWC images; it permutes them to
NCHW once at the stem, and every convolution is ``F.conv2d`` (XLA
computes the JAX model's convolutions outside any Pallas kernel).
Parameter names follow the flax tree, so ``stage0_block0/Conv_1/kernel``
is ``stage0_block0.Conv_1.weight``, with flax's auto-names for the
unnamed convolutions and norms (``Conv_0``..``Conv_2``,
``GroupNorm_i`` / ``BatchNorm_i``).  A kernel is ``[out, in, kh, kw]``
here and HWIO ``[kh, kw, in, out]`` there (``weights.from_jax_params``
transposes it).

The numerics are flax's:

* ``SAME`` padding is XLA's: ``total = max((ceil(n / s) - 1) s + k - n,
  0)``, ``total // 2`` before and the rest after, so a stride-2 window
  over an even size pads one more after than before (the 7x7/2 stem at
  224 pads (2, 3), a 3x3/2 conv (0, 1)); ``max_pool`` pads with -inf;
* ``GroupNorm``: epsilon 1e-6; ``BatchNorm``: momentum 0.9, epsilon
  1e-5; both take their statistics in fp32 with the fast variance
  ``E[x^2] - E[x]^2`` clipped at 0, and batch norm's running variance
  moves by the biased batch variance;
* batch norm in training mode (``forward(x, train=True)``) takes the
  statistics of the global batch: over a ``data`` axis above 1 the sums
  are all-reduced with ``collectives.psum`` (JAX's transpose, so every
  rank's gradient sees every rank's loss through the statistics), as
  GSPMD reduces them in the JAX program;
* the head is ``ops.Dense`` in fp32.  A model built inside ``with
  epl.split(n):`` on a mesh whose ``model`` axis is above 1 makes it
  column-parallel (the JAX layer consults the same scope), and
  ``forward(..., gather_logits=False)`` gives this rank's block of the
  class logits for the distributed cross entropy.

Running statistics are buffers (``BatchNorm_0.mean`` / ``.var``), passed
to ``torch.func.functional_call`` with the parameters; ``forward(x,
train=True, mutable=True)`` returns ``(logits, new_model_state)``, the
JAX ``apply(..., mutable=["batch_stats"])``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.ops import bridging
from easyparallellibrary_tpu_torch.ops.layers import Dense
from easyparallellibrary_tpu_torch.runtime.amp import resolve_model_dtypes


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
  """Every field of the JAX ``ResNetConfig``."""
  stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
  num_filters: int = 64
  num_classes: int = 1000
  dtype: Any = torch.bfloat16
  param_dtype: Any = torch.float32
  norm_groups: int = 32
  norm: str = "group"                           # group | batch


def resnet18_config(**kw):
  return ResNetConfig(stage_sizes=(2, 2, 2, 2), **kw)


def resnet50_config(**kw):
  return ResNetConfig(stage_sizes=(3, 4, 6, 3), **kw)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """XLA's ``SAME`` padding of one spatial dim: ``(before, after)``."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def _pad_same(x, kernel: int, stride: int, value: float = 0.0):
  h = same_pads(x.shape[2], kernel, stride)
  w = same_pads(x.shape[3], kernel, stride)
  if not any(h + w):
    return x
  return F.pad(x, (w[0], w[1], h[0], h[1]), value=value)


def _norm_stats(xf, dims):
  """fp32 mean and fast variance over ``dims`` (flax ``_compute_stats``)."""
  mean = xf.mean(dims)
  mean2 = (xf * xf).mean(dims)
  return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def _normalize(x32, mean, var, weight, bias, epsilon: float, dtype):
  """flax ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) +
  bias`` in fp32, cast to ``dtype``; ``mean`` / ``var`` broadcast."""
  return ((x32 - mean) * (torch.rsqrt(var + epsilon) * weight)
          + bias).to(dtype)


class Conv(nn.Module):
  """flax ``nn.Conv`` without bias, ``SAME`` padding, NCHW: ``weight``
  ``[out, in, kh, kw]``, the product in the compute dtype."""

  def __init__(self, in_features: int, features: int, kernel: int,
               stride: int = 1, param_dtype=torch.float32, device=None):
    super().__init__()
    self.kernel, self.stride = kernel, stride
    self.weight = nn.Parameter(torch.empty(
        features, in_features, kernel, kernel, dtype=param_dtype,
        device=device))

  def forward(self, x, dtype):
    x = _pad_same(x.to(dtype), self.kernel, self.stride)
    return F.conv2d(x, self.weight.to(dtype), stride=self.stride)


class GroupNorm(nn.Module):
  """flax ``nn.GroupNorm`` over NCHW: statistics of each group of
  ``C / num_groups`` channels over the group and the spatial dims."""

  def __init__(self, features: int, num_groups: int, dtype=None,
               param_dtype=torch.float32, epsilon: float = 1e-6,
               device=None):
    super().__init__()
    if num_groups <= 0 or features % num_groups:
      raise ValueError(f"Number of groups ({num_groups}) does not divide "
                       f"the number of channels ({features}).")
    self.num_groups, self.epsilon, self.dtype = num_groups, epsilon, dtype
    self.weight = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                           device=device))
    self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                         device=device))

  def forward(self, x, train: bool = False, collect=None):
    del train, collect
    B, C, H, W = x.shape
    G = self.num_groups
    xf = x.float().reshape(B, G, C // G, H, W)
    mean, var = _norm_stats(xf, (2, 3, 4))
    y = _normalize(xf, mean[:, :, None, None, None],
                   var[:, :, None, None, None],
                   self.weight.reshape(1, G, C // G, 1, 1),
                   self.bias.reshape(1, G, C // G, 1, 1), self.epsilon,
                   self.dtype or x.dtype)
    return y.reshape(B, C, H, W)


class BatchNorm(nn.Module):
  """flax ``nn.BatchNorm`` over NCHW (momentum 0.9, epsilon 1e-5): in
  training mode the batch's statistics, summed over the ``data`` axis
  (``collectives.psum``) so they are the global batch's, and the running
  statistics' update written into ``collect`` under this layer's name
  (``qualname``); otherwise the running statistics."""

  def __init__(self, features: int, dtype=None, param_dtype=torch.float32,
               momentum: float = 0.9, epsilon: float = 1e-5, device=None):
    super().__init__()
    self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
    self.qualname = ""
    self.weight = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                           device=device))
    self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                         device=device))
    self.register_buffer("mean", torch.zeros(features, dtype=torch.float32,
                                             device=device))
    self.register_buffer("var", torch.ones(features, dtype=torch.float32,
                                           device=device))

  def forward(self, x, train: bool = False, collect=None):
    xf = x.float()
    if train:
      dp = collectives.axis_size(constants.DATA_AXIS)
      if dp > 1:
        # Equal rows a rank: the global means are the local ones summed
        # over the axis over dp.
        moments = torch.stack([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
        moments = collectives.psum(moments, constants.DATA_AXIS) / dp
        mean, var = moments[0], torch.clamp(
            moments[1] - moments[0] * moments[0], min=0.0)
      else:
        mean, var = _norm_stats(xf, (0, 2, 3))
      if collect is not None:
        m = self.momentum
        collect[f"{self.qualname}mean"] = (
            m * self.mean + (1 - m) * mean).detach()
        collect[f"{self.qualname}var"] = (
            m * self.var + (1 - m) * var).detach()
    else:
      mean, var = self.mean, self.var
    shape = (1, -1, 1, 1)
    return _normalize(xf, mean.reshape(shape), var.reshape(shape),
                      self.weight.reshape(shape), self.bias.reshape(shape),
                      self.epsilon, self.dtype or x.dtype)


def _norm_factory(cfg: ResNetConfig, filters: int):
  """The norm layer of ``cfg`` for ``filters`` channels, as a
  constructor taking ``device``."""
  if cfg.norm == "batch":
    return lambda device=None: BatchNorm(
        filters, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
        device=device)
  if cfg.norm == "group":
    return lambda device=None: GroupNorm(
        filters, min(cfg.norm_groups, filters), dtype=cfg.dtype,
        param_dtype=cfg.param_dtype, device=device)
  raise ValueError(f"norm must be 'group' or 'batch'; got {cfg.norm!r}")


def _norm_name(cfg: ResNetConfig, i: int) -> str:
  return f"{'BatchNorm' if cfg.norm == 'batch' else 'GroupNorm'}_{i}"


class BottleneckBlock(nn.Module):
  """1x1, 3x3 (strided), 1x1 x4 with a norm after each, and a projected
  shortcut (``proj``, ``proj_norm``) where the shapes differ."""

  def __init__(self, cfg: ResNetConfig, in_filters: int, filters: int,
               strides: int = 1, device=None):
    super().__init__()
    self.cfg = cfg
    norm = _norm_factory(cfg, filters)
    pd = cfg.param_dtype
    self.Conv_0 = Conv(in_filters, filters, 1, param_dtype=pd, device=device)
    self.Conv_1 = Conv(filters, filters, 3, strides, param_dtype=pd,
                       device=device)
    self.Conv_2 = Conv(filters, filters * 4, 1, param_dtype=pd,
                       device=device)
    for i in range(2):
      self.add_module(_norm_name(cfg, i), norm(device))
    self.add_module(_norm_name(cfg, 2), _norm_factory(cfg, filters * 4)(
        device))
    self.has_proj = in_filters != filters * 4 or strides != 1
    if self.has_proj:
      self.proj = Conv(in_filters, filters * 4, 1, strides, param_dtype=pd,
                       device=device)
      self.proj_norm = _norm_factory(cfg, filters * 4)(device)

  def forward(self, x, dtype, train: bool = False, collect=None):
    norms = [getattr(self, _norm_name(self.cfg, i)) for i in range(3)]
    y = F.relu(norms[0](self.Conv_0(x, dtype), train, collect))
    y = F.relu(norms[1](self.Conv_1(y, dtype), train, collect))
    y = norms[2](self.Conv_2(y, dtype), train, collect)
    residual = x
    if self.has_proj:
      residual = self.proj_norm(self.proj(x, dtype), train, collect)
    return F.relu(residual + y)


def _active_split() -> bool:
  from easyparallellibrary_tpu_torch.env import Env
  ctx = Env.get().strategy_context
  return bool(ctx and ctx.stack and ctx.stack[-1].kind == "split")


class ResNet(nn.Module):
  """``forward(x [B, H, W, 3], train=False) -> logits [B, num_classes]``
  (fp32).  ``mutable=True`` (batch norm in training mode) returns
  ``(logits, new_model_state)``; ``gather_logits=False`` with a
  column-parallel head returns this rank's block of the logits."""

  def __init__(self, cfg: ResNetConfig, device="meta"):
    super().__init__()
    self.cfg = cfg
    self.split_axes = ()
    pd = cfg.param_dtype
    self.conv_init = Conv(3, cfg.num_filters, 7, 2, param_dtype=pd,
                          device=device)
    self.add_module(_norm_name(cfg, 0), _norm_factory(cfg, cfg.num_filters)(
        device))
    width = cfg.num_filters
    for i, n_blocks in enumerate(cfg.stage_sizes):
      for j in range(n_blocks):
        strides = 2 if i > 0 and j == 0 else 1
        filters = cfg.num_filters * 2 ** i
        self.add_module(f"stage{i}_block{j}", BottleneckBlock(
            cfg, width, filters, strides, device=device))
        width = filters * 4
    split = _active_split() and \
        collectives.axis_size(constants.MODEL_AXIS) > 1
    self.head = Dense(width, cfg.num_classes, parallel="column" if split
                      else "none", dtype=torch.float32, param_dtype=pd,
                      device=device)
    self.tp = self.head.tp
    for name, mod in self.named_modules():
      if isinstance(mod, BatchNorm):
        mod.qualname = f"{name}."

  def forward(self, x, train: bool = False, mutable: bool = False,
              gather_logits: bool = True):
    cfg = resolve_model_dtypes(self.cfg)
    dtype = cfg.dtype
    collect: Optional[Dict[str, torch.Tensor]] = {} if mutable else None
    x = x.to(dtype).permute(0, 3, 1, 2)              # NHWC -> NCHW
    x = self.conv_init(x, dtype)
    x = F.relu(getattr(self, _norm_name(cfg, 0))(x, train, collect))
    x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, stride=2)
    for i, n_blocks in enumerate(cfg.stage_sizes):
      for j in range(n_blocks):
        x = getattr(self, f"stage{i}_block{j}")(x, dtype, train, collect)
    x = x.mean((2, 3))
    logits = self.head(x, torch.float32)
    if self.tp > 1 and gather_logits:
      logits = bridging.split_to_replica(logits, dim=-1,
                                         logical=cfg.num_classes)
    if mutable:
      return logits, collect
    return logits


def resnet_flops_per_image(cfg: ResNetConfig, image: int = 224) -> float:
  """Training FLOPs an image, ``benchmarks/single_chip_models.py``'s
  count: ~4.09 GFLOP of backbone forward at 224 x 224 (scaled by the
  pixels), the head's ``2 * features * classes``, and the training step
  3x the forward."""
  features = cfg.num_filters * 2 ** (len(cfg.stage_sizes) - 1) * 4
  fwd = 4.09e9 * (image / 224.0) ** 2 + 2.0 * features * cfg.num_classes
  return 3.0 * fwd
