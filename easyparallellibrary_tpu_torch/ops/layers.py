"""Layers of the serving slice (port of ``easyparallellibrary_tpu/ops/layers.py``).

``Dense`` in mode ``"none"``, ``Embedding`` with its tied-head
``attend``, and ``LayerNorm`` with flax's numerics.  The tensor-parallel,
overlap and pipeline-stage modes of the JAX layers raise
(ROADMAP.md Queue 1).

Parameters are stored in ``param_dtype`` (fp32) like the flax modules.
The JAX layers cast a weight to the compute dtype on every call; the
serving engine casts the weights once at load instead
(:func:`easyparallellibrary_tpu_torch.weights.cast_for_compute`), which
gives the same numbers because a cast of a cast to the same dtype is the
identity (the per-call ``.to(dtype)`` below is then a no-op).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from easyparallellibrary_tpu_torch._not_ported import (
    PARALLEL_STRATEGIES, TENSOR_PARALLEL, not_ported)


class Dense(nn.Module):
  """``y = x @ kernel + bias`` in the compute dtype.

  ``weight`` is ``[out, in]`` (torch's ``Linear`` layout; the flax
  kernel is its transpose).  As in the JAX layer, the product is
  rounded to ``dtype`` before the bias is added in ``dtype``
  (``ops/layers.py:280,298`` of the JAX package).
  """

  def __init__(self, in_features: int, features: int, use_bias: bool = True,
               parallel: str = "none", dtype: Optional[torch.dtype] = None,
               param_dtype: torch.dtype = torch.float32, device=None):
    super().__init__()
    if parallel == "row" or parallel == "column":
      raise not_ported(f"Dense(parallel={parallel!r})", TENSOR_PARALLEL)
    if parallel != "none":
      raise not_ported(f"Dense(parallel={parallel!r})", PARALLEL_STRATEGIES)
    self.dtype = dtype
    self.weight = nn.Parameter(torch.empty(features, in_features,
                                           dtype=param_dtype, device=device))
    self.bias = (nn.Parameter(torch.empty(features, dtype=param_dtype,
                                          device=device))
                 if use_bias else None)

  def forward(self, x, dtype: Optional[torch.dtype] = None):
    """``dtype`` overrides the constructor's compute dtype for this call
    (amp O1: the GPT resolves its compute dtype at every forward)."""
    dtype = dtype or self.dtype or x.dtype
    y = F.linear(x.to(dtype), self.weight.to(dtype))
    if self.bias is not None:
      y = y + self.bias.to(dtype)
    return y


class LayerNorm(nn.Module):
  """flax ``nn.LayerNorm``: epsilon 1e-6, fp32 statistics with the fast
  variance ``E[x^2] - E[x]^2`` clipped at 0, scale and bias applied in
  fp32, the result cast to ``dtype``."""

  def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
               param_dtype: torch.dtype = torch.float32,
               epsilon: float = 1e-6, device=None):
    super().__init__()
    self.dtype = dtype
    self.epsilon = epsilon
    self.weight = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                           device=device))
    self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                         device=device))

  def forward(self, x, dtype: Optional[torch.dtype] = None):
    stat_dtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(stat_dtype)
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + self.epsilon) * self.weight
    y = (xf - mean) * mul + self.bias
    return y.to(dtype or self.dtype or x.dtype)


class Embedding(nn.Module):
  """Token embedding ``[num_embeddings, features]`` with the tied head
  :meth:`attend`.  The vocab-sharded modes raise."""

  def __init__(self, num_embeddings: int, features: int,
               parallel: str = "none",
               param_dtype: torch.dtype = torch.float32, device=None):
    super().__init__()
    if parallel == "vocab":
      raise not_ported("Embedding(parallel='vocab')", TENSOR_PARALLEL)
    if parallel != "none":
      raise not_ported(f"Embedding(parallel={parallel!r})",
                       PARALLEL_STRATEGIES)
    self.num_embeddings = num_embeddings
    self.weight = nn.Parameter(torch.empty(num_embeddings, features,
                                           dtype=param_dtype, device=device))

  def forward(self, ids):
    return F.embedding(ids, self.weight)

  def attend(self, x):
    """Tied-softmax logits ``x @ table.T`` in ``x``'s dtype, so a bf16
    model's logits come out in bf16."""
    return torch.matmul(x, self.weight.to(x.dtype).t())
