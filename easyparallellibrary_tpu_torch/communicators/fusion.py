"""Gradient fusion buckets for explicit collectives (port of
``easyparallellibrary_tpu/communicators/fusion.py``).

Gradients are grouped by dtype, kept in declaration order within a
group (the readiness proxy), cut into buckets of about
``fusion_threshold_mb``, capped at ``max_splits`` buckets by merging the
smallest adjacent same-dtype pair, flattened into one buffer per bucket,
reduced with one collective each and cut back.  The plan is shape
arithmetic alone, leaf for leaf the JAX plan: a dict's leaves are taken
in sorted-key order, as ``jax.tree_util`` flattens one.

The wire may be compressed to bf16 / fp16 with a scale, and
``num_communicators`` bounds the buckets in flight.  The port's
collectives are issued in order on one stream, so at most one bucket is
ever in flight and the bound holds for any value of it; it is kept for
the JAX signature.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch

from easyparallellibrary_tpu_torch.communicators import collectives, overlap

Tree = Union[Dict[str, torch.Tensor], Sequence[torch.Tensor]]


def _leaves(tree: Tree):
  if isinstance(tree, dict):
    keys = sorted(tree)
    return keys, [tree[k] for k in keys]
  return None, list(tree)


def _rebuild(keys, leaves, like: Tree):
  if keys is not None:
    return dict(zip(keys, leaves))
  return type(like)(leaves) if isinstance(like, tuple) else list(leaves)


@dataclasses.dataclass(frozen=True)
class _LeafInfo:
  index: int
  shape: Tuple[int, ...]
  dtype: Any
  size: int


@dataclasses.dataclass(frozen=True)
class FusionPlan:
  """Static bucketing of a fixed set of leaves: each bucket a tuple of
  leaf indices (one dtype)."""
  keys: Any
  leaf_infos: Tuple[_LeafInfo, ...]
  buckets: Tuple[Tuple[int, ...], ...]

  @property
  def num_buckets(self) -> int:
    return len(self.buckets)

  def flatten(self, tree: Tree) -> List[torch.Tensor]:
    _, leaves = _leaves(tree)
    return [torch.cat([leaves[i].reshape(-1) for i in bucket])
            for bucket in self.buckets]

  def unflatten(self, buffers: Sequence[torch.Tensor], like: Tree):
    leaves: List[Any] = [None] * len(self.leaf_infos)
    for bucket, buf in zip(self.buckets, buffers):
      offset = 0
      for i in bucket:
        info = self.leaf_infos[i]
        leaves[i] = buf[offset:offset + info.size].reshape(info.shape)
        offset += info.size
    return _rebuild(self.keys, leaves, like)


def _itemsize(dtype) -> int:
  return torch.empty((), dtype=dtype).element_size()


def build_fusion_plan(tree: Tree, fusion_threshold_mb: int = 32,
                      max_splits: int = 60) -> FusionPlan:
  """Bucket leaves by dtype then size (the JAX plan)."""
  keys, leaves = _leaves(tree)
  infos = tuple(_LeafInfo(i, tuple(l.shape), l.dtype, int(l.numel()))
                for i, l in enumerate(leaves))
  threshold = fusion_threshold_mb * 1024 * 1024
  by_dtype: Dict[str, List[_LeafInfo]] = {}
  for info in infos:
    # Grouped by the numpy name of the dtype, in sorted order, as JAX.
    name = str(info.dtype).replace("torch.", "")
    by_dtype.setdefault(name, []).append(info)
  buckets: List[Tuple[int, ...]] = []
  for name in sorted(by_dtype):
    group = by_dtype[name]
    itemsize = _itemsize(group[0].dtype)
    current: List[int] = []
    current_bytes = 0
    for info in group:
      nbytes = info.size * itemsize
      if current and current_bytes + nbytes > threshold:
        buckets.append(tuple(current))
        current, current_bytes = [], 0
      current.append(info.index)
      current_bytes += nbytes
    if current:
      buckets.append(tuple(current))

  def bucket_bytes(bucket):
    return sum(infos[i].size * _itemsize(infos[i].dtype) for i in bucket)

  while len(buckets) > max_splits:
    best = None
    for j in range(len(buckets) - 1):
      a, b = buckets[j], buckets[j + 1]
      if infos[a[0]].dtype != infos[b[0]].dtype:
        continue
      cost = bucket_bytes(a) + bucket_bytes(b)
      if best is None or cost < best[1]:
        best = (j, cost)
    if best is None:
      break
    j = best[0]
    buckets = buckets[:j] + [buckets[j] + buckets[j + 1]] + buckets[j + 2:]
  return FusionPlan(keys=keys, leaf_infos=infos, buckets=tuple(buckets))


_WIRE = {"bf16": torch.bfloat16, "fp16": torch.float16}


def batch_all_reduce(tree: Tree, axis_name: str, op: str = collectives.SUM,
                     plan: FusionPlan = None, fusion_threshold_mb: int = 32,
                     max_splits: int = 60, compress_dtype: str = "",
                     compress_scale: float = 1.0,
                     num_communicators: int = 0):
  """Fused all-reduce of a gradient tree over ``axis_name``: one
  collective per bucket, on a bf16 / fp16 wire scaled by
  ``compress_scale`` when ``compress_dtype`` is set."""
  del num_communicators
  if compress_dtype and compress_dtype not in _WIRE:
    raise ValueError(f"compress_dtype must be '', 'bf16' or 'fp16'; "
                     f"got {compress_dtype!r}")
  if plan is None:
    plan = build_fusion_plan(tree, fusion_threshold_mb, max_splits)
  reduced = []
  for buf in plan.flatten(tree):
    wire = buf
    if compress_dtype:
      wire = (wire * compress_scale).to(_WIRE[compress_dtype])
    wire = collectives.all_reduce(wire, axis_name, op=op)
    if compress_dtype:
      wire = wire.to(buf.dtype) / compress_scale
    reduced.append(wire)
  return plan.unflatten(reduced, tree)


def batch_reduce_scatter(tree: Tree, axis_name: str, dims, num_shards: int,
                         num_chunks: int = 0, fusion_threshold_mb: int = 32,
                         max_splits: int = 60):
  """Bucketed reduce-to-owner, the ZeRO-1 twin of
  :func:`batch_all_reduce`: ``dims`` (matching ``tree``) names each
  leaf's scatter dim, or -1 / None to pass it through.  Each scattered
  leaf is viewed as ``[num_shards, block]``, bucketed like
  :func:`build_fusion_plan`, and each bucket reduce-scattered by one
  collective (the ring of ``overlap.reduce_scatter`` for
  ``num_chunks >= 2``).  Returns owner shards, not divided for a
  mean."""
  keys, leaves = _leaves(tree)
  _, dim_leaves = _leaves(dims)
  if len(leaves) != len(dim_leaves):
    raise ValueError("dims tree must match the gradient tree")
  scat = [i for i, d in enumerate(dim_leaves) if d is not None and d >= 0]
  out = list(leaves)
  if scat:
    sub = []
    for i in scat:
      d = dim_leaves[i]
      if leaves[i].shape[d] % num_shards:
        raise ValueError(
            f"leaf {i} dim {d} ({leaves[i].shape[d]}) does not divide "
            f"num_shards={num_shards}")
      sub.append(leaves[i].movedim(d, 0).reshape(num_shards, -1))
    plan = build_fusion_plan(sub, fusion_threshold_mb, max_splits)
    red_sub = [None] * len(sub)
    for bucket in plan.buckets:
      buf = torch.cat([sub[j] for j in bucket], dim=1)
      red = overlap.reduce_scatter(buf, axis_name, axis=0,
                                   num_chunks=num_chunks)
      offset = 0
      for j in bucket:
        width = sub[j].shape[1]
        red_sub[j] = red[:, offset:offset + width]
        offset += width
    for pos, i in enumerate(scat):
      d = dim_leaves[i]
      shape = leaves[i].shape
      moved = (shape[d] // num_shards,) + tuple(
          s for dim, s in enumerate(shape) if dim != d)
      out[i] = red_sub[pos].reshape(moved).movedim(0, d)
  return _rebuild(keys, out, tree)
