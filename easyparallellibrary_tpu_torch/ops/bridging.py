"""Bridging between replicated and split layouts (port of
``easyparallellibrary_tpu/ops/bridging.py``).

Under GSPMD a bridge is a resharding constraint: the identity on the
logical value, which XLA materialises as a gather or a slice.  In the
port each rank holds its block of the split dim, so the bridges move
data, and their gradients are those of the identity on the logical
value:

* :func:`replica_to_split` keeps this rank's block of a replicated
  value (zero-padded to an even tiling); backward gathers the blocks;
* :func:`split_to_replica` gathers the blocks (and slices the padding
  off); backward keeps this rank's block;
* :func:`copy_to_split` is the identity, whose backward sums the
  partial gradients of a replicated value over the axis: it marks where
  a replicated activation enters a tensor-parallel region (the column
  layers, the vocab head), as Megatron's ``f``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives


def _pad_to(x, dim: int, size: int):
  extra = size - x.shape[dim]
  if extra <= 0:
    return x
  pad = [0, 0] * (x.dim() - 1 - dim) + [0, extra]
  return F.pad(x, pad)


class _ToSplit(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, axis_name, dim, mesh):
    n = collectives.axis_size(axis_name, mesh)
    idx = collectives.axis_index(axis_name, mesh)
    full = x.shape[dim]
    block = -(-full // n)
    ctx.args = (axis_name, dim, mesh, full)
    return _pad_to(x, dim, block * n).narrow(dim, idx * block,
                                             block).contiguous()

  @staticmethod
  def backward(ctx, g):
    axis_name, dim, mesh, full = ctx.args
    with torch.no_grad():
      whole = collectives.all_gather(g, axis_name, axis=dim, mesh=mesh)
    return whole.narrow(dim, 0, full), None, None, None


class _ToReplica(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, axis_name, dim, mesh, logical):
    with torch.no_grad():
      whole = collectives.all_gather(x, axis_name, axis=dim, mesh=mesh)
    ctx.args = (axis_name, dim, mesh, x.shape[dim])
    return whole.narrow(dim, 0, logical).contiguous()

  @staticmethod
  def backward(ctx, g):
    axis_name, dim, mesh, block = ctx.args
    n = collectives.axis_size(axis_name, mesh)
    idx = collectives.axis_index(axis_name, mesh)
    g = _pad_to(g, dim, block * n)
    return g.narrow(dim, idx * block, block), None, None, None, None


class _CopyToSplit(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, axis_name, mesh):
    ctx.args = (axis_name, mesh)
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    axis_name, mesh = ctx.args
    with torch.no_grad():
      return (collectives.all_reduce(g, axis_name, mesh=mesh), None, None)


def replica_to_split(x, dim: int = -1, axis_name: str = constants.MODEL_AXIS,
                     mesh=None):
  """Enter a tensor-parallel region: this rank's block of ``dim``."""
  if collectives.axis_size(axis_name, mesh) <= 1:
    return x
  return _ToSplit.apply(x, axis_name, dim % x.dim(), mesh)


def split_to_replica(x, dim: int = -1, logical: Optional[int] = None,
                     axis_name: str = constants.MODEL_AXIS, mesh=None):
  """Leave a tensor-parallel region: gather ``dim`` off the axis and cut
  it to ``logical`` (the unpadded width; default all of it)."""
  n = collectives.axis_size(axis_name, mesh)
  dim = dim % x.dim()
  if n <= 1:
    return x if logical is None else x.narrow(dim, 0, logical)
  if logical is None:
    logical = x.shape[dim] * n
  return _ToReplica.apply(x, axis_name, dim, mesh, logical)


def copy_to_split(x, axis_name: str = constants.MODEL_AXIS, mesh=None):
  """The identity on a replicated value entering a split region; its
  backward all-reduces the ranks' partial gradients."""
  if collectives.axis_size(axis_name, mesh) <= 1:
    return x
  return _CopyToSplit.apply(x, axis_name, mesh)
