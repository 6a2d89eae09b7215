"""KV cache layouts of the serving engine (port of
``easyparallellibrary_tpu/serving/kv_cache.py``): contiguous slots and
the paged block pool.

Contiguous slots (the default engine): one cache of ``num_slots``
request slots, ``[num_slots, cache_length, H, hd]`` per layer, allocated
once and reused for the life of the engine, with an int32 cursor per
slot (:func:`allocate_kv_cache`).  The engine's fixed-width step writes
a ``chunk``-wide window at every slot's cursor, so each slot is one
chunk longer than any request can grow (:func:`cache_length`) and the
window never runs off the end.

Paged: K/V lives in a pool of fixed-size blocks
(:func:`allocate_paged_kv_cache`); each request slot owns a
grown-on-demand block list behind a block table, and a host-side
:class:`BlockAllocator` (free list + refcounts) hands blocks out.  Block
``NULL_BLOCK`` is reserved: unallocated table entries resolve to it and
padding tokens write their K/V there, so its rows are finite garbage
that the attention mask never exposes.

Both layouts are allocated in the model config's own ``dtype``, as the
JAX package allocates them (under amp O1 the compute dtype may be
narrower; the attention reads the cache in the promoted type).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import torch

from easyparallellibrary_tpu_torch.utils.device import resolve_device

NULL_BLOCK = 0


def blocks_per_slot(cfg, block_size: int) -> int:
  """Block-table width: virtual context rows per slot == ``max_seq_len``
  exactly, so ``block_size`` must divide ``max_seq_len`` (the paged
  attend's reduction length then equals ``generate(use_cache=True)``'s
  cache length)."""
  if block_size < 1:
    raise ValueError(f"block_size must be >= 1: {block_size}")
  if cfg.max_seq_len % block_size:
    raise ValueError(
        f"serving.paged.block_size {block_size} must divide max_seq_len "
        f"{cfg.max_seq_len}: the paged attend's reduction length "
        f"(blocks_per_slot * block_size) must equal the oracle's cache "
        f"length for the greedy bit-exactness contract to hold")
  return cfg.max_seq_len // block_size


def default_num_blocks(cfg, num_slots: int, block_size: int) -> int:
  """Auto pool size: every slot can reach ``max_seq_len``, plus the null
  block."""
  return num_slots * blocks_per_slot(cfg, block_size) + 1


def _heads(cfg) -> int:
  """The heads a rank's cache holds: ``H / tp`` for a tensor-parallel
  model on the ambient mesh (``models.gpt.local_heads``), else ``H``."""
  from easyparallellibrary_tpu_torch.models.gpt import local_heads
  return local_heads(cfg)


def kv_cache_shardings(cfg, mesh):
  """The cache layout on ``mesh`` (JAX ``kv_cache_shardings``): the spec
  of every K/V leaf, heads (dim 2) split over ``model`` for a
  tensor-parallel model on a model axis above 1, else replicated, and
  the cursors' (replicated).  ``(None, None)`` without a mesh.  Each
  rank allocates its own shard (``H / tp`` heads); heads that do not
  divide the axis raise, where JAX replicates the cache."""
  from easyparallellibrary_tpu_torch import constants
  if mesh is None:
    return None, None
  tp = mesh.axis_size(constants.MODEL_AXIS)
  sharded = bool(cfg.tensor_parallel) and tp > 1
  if sharded and cfg.num_heads % tp:
    raise ValueError(
        f"num_heads {cfg.num_heads} does not divide the model axis ({tp}): "
        "the port shards whole heads per rank (the JAX package replicates "
        "such a cache)")
  leaf = (None, None, constants.MODEL_AXIS, None) if sharded else ()
  kv = {f"block_{i}": {"attn": {"cached_key": leaf, "cached_value": leaf}}
        for i in range(cfg.num_layers)}
  return kv, ()


def allocate_paged_kv_cache(cfg, num_blocks: int, block_size: int,
                            device=None) -> Dict[str, Dict]:
  """Zeroed K/V pools on ``device`` (default ``"cuda"``):
  ``{"block_i": {"attn": {"cached_key"/"cached_value":
  [num_blocks, block_size, H, hd]}}}`` in ``cfg.dtype``."""
  dev = resolve_device(device)
  mb = blocks_per_slot(cfg, block_size)
  if num_blocks < mb + 1:
    raise ValueError(
        f"num_blocks {num_blocks} cannot hold even one full-length "
        f"request: need >= blocks_per_slot + 1 = {mb + 1} (one null "
        f"block plus max_seq_len/block_size per request)")
  if cfg.d_model % cfg.num_heads:
    raise ValueError(f"d_model {cfg.d_model} must divide into "
                     f"{cfg.num_heads} heads")
  shape = (num_blocks, block_size, _heads(cfg),
           cfg.d_model // cfg.num_heads)

  def leaf():
    return torch.zeros(shape, dtype=cfg.dtype, device=dev)

  return {f"block_{i}": {"attn": {"cached_key": leaf(),
                                  "cached_value": leaf()}}
          for i in range(cfg.num_layers)}


def cache_length(cfg, chunk: int) -> int:
  """Per-slot cache length: ``max_seq_len`` plus one chunk of slack, so
  the step's fixed-width write window never runs off the end."""
  return cfg.max_seq_len + int(chunk)


def allocate_kv_cache(cfg, num_slots: int, chunk: int, device=None
                      ) -> Tuple[Dict[str, Dict], torch.Tensor]:
  """The slot cache on ``device`` (default ``"cuda"``): ``(kv,
  cursors)``, ``kv`` shaped like the GPT's slot-mode cache dict
  (``{"block_i": {"attn": {"cached_key"/"cached_value": [num_slots,
  cache_length, H, hd]}}}``, zeros in ``cfg.dtype``) and ``cursors`` the
  int32 ``[num_slots]`` write offsets (zeros)."""
  if num_slots < 1:
    raise ValueError(f"num_slots must be >= 1: {num_slots}")
  if chunk < 1:
    raise ValueError(f"prefill chunk must be >= 1: {chunk}")
  if cfg.d_model % cfg.num_heads:
    raise ValueError(f"d_model {cfg.d_model} must divide into "
                     f"{cfg.num_heads} heads")
  dev = resolve_device(device)
  shape = (num_slots, cache_length(cfg, chunk), _heads(cfg),
           cfg.d_model // cfg.num_heads)

  def leaf():
    return torch.zeros(shape, dtype=cfg.dtype, device=dev)

  kv = {f"block_{i}": {"attn": {"cached_key": leaf(),
                                "cached_value": leaf()}}
        for i in range(cfg.num_layers)}
  return kv, torch.zeros((num_slots,), dtype=torch.int32, device=dev)


def cache_bytes(cfg, num_slots: int, chunk: int) -> int:
  """Slot-cache footprint in bytes (K and V, all layers) on one rank."""
  H, hd = _heads(cfg), cfg.d_model // cfg.num_heads
  itemsize = torch.empty((), dtype=cfg.dtype).element_size()
  per_leaf = num_slots * cache_length(cfg, chunk) * H * hd
  return 2 * cfg.num_layers * per_leaf * itemsize


def paged_cache_bytes(cfg, num_blocks: int, block_size: int) -> int:
  """Paged-pool footprint in bytes (K and V, all layers) on one rank."""
  H, hd = _heads(cfg), cfg.d_model // cfg.num_heads
  itemsize = torch.empty((), dtype=cfg.dtype).element_size()
  return 2 * cfg.num_layers * num_blocks * block_size * H * hd * itemsize


class BlockAllocator:
  """Host-side free list + refcounts over the paged K/V pool.

  Lowest-free-first (a heap) keeps block assignment deterministic for a
  given request order.  A block starts at refcount 1 and returns to the
  free list when its last holder lets go.  ``NULL_BLOCK`` is never
  handed out.
  """

  def __init__(self, num_blocks: int, block_size: int):
    if num_blocks < 2:
      raise ValueError(f"num_blocks must be >= 2 (one null block plus at "
                       f"least one allocatable): {num_blocks}")
    if block_size < 1:
      raise ValueError(f"block_size must be >= 1: {block_size}")
    self.num_blocks = num_blocks
    self.block_size = block_size
    self._free: List[int] = list(range(1, num_blocks))
    heapq.heapify(self._free)
    self._ref: Dict[int, int] = {}

  @property
  def num_free(self) -> int:
    return len(self._free)

  @property
  def num_used(self) -> int:
    return len(self._ref)

  def alloc(self) -> Optional[int]:
    """Claim the lowest free block at refcount 1, or None when empty."""
    if not self._free:
      return None
    blk = heapq.heappop(self._free)
    self._ref[blk] = 1
    return blk

  def incref(self, block: int) -> None:
    if block not in self._ref:
      raise ValueError(f"block {block} is not allocated")
    self._ref[block] += 1

  def decref(self, block: int) -> None:
    """Drop a reference; the block returns to the free list at zero."""
    if block not in self._ref:
      raise ValueError(f"block {block} is not allocated (double free?)")
    self._ref[block] -= 1
    if self._ref[block] == 0:
      del self._ref[block]
      heapq.heappush(self._free, block)

  def refcount(self, block: int) -> int:
    return self._ref.get(block, 0)

  def fragmentation(self, used_tokens: int) -> float:
    """The fraction of allocated token capacity no resident token
    occupies; 0.0 when nothing is allocated."""
    cap = self.num_used * self.block_size
    if cap <= 0:
      return 0.0
    return max(0.0, 1.0 - used_tokens / cap)

  def __repr__(self):
    return (f"BlockAllocator(num_blocks={self.num_blocks}, "
            f"block_size={self.block_size}, free={self.num_free}, "
            f"used={self.num_used})")


class SlotAllocator:
  """Host-side free list over the request slots (lowest free first)."""

  def __init__(self, num_slots: int):
    if num_slots < 1:
      raise ValueError(f"num_slots must be >= 1: {num_slots}")
    self.num_slots = num_slots
    self._free: List[int] = list(range(num_slots))
    self._used = set()

  @property
  def num_free(self) -> int:
    return len(self._free)

  def alloc(self) -> Optional[int]:
    """Claim the lowest free slot, or None when full."""
    if not self._free:
      return None
    slot = min(self._free)
    self._free.remove(slot)
    self._used.add(slot)
    return slot

  def free(self, slot: int):
    if slot not in self._used:
      raise ValueError(f"slot {slot} is not allocated (double free?)")
    self._used.remove(slot)
    self._free.append(slot)

  def __repr__(self):
    return (f"SlotAllocator(num_slots={self.num_slots}, "
            f"free={sorted(self._free)})")
