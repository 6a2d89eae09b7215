"""Copy-on-write prefix caching over the paged KV pool (port of
``easyparallellibrary_tpu/serving/prefix_cache.py``).

K/V at position ``p`` depends only on the weights and tokens ``0..p``,
so a pool block whose covering token prefix matches is the same between
requests and can be shared by reference instead of recomputed.
:class:`PrefixCache` is a content-addressed radix tree over full prompt
blocks: each node holds one pool block and the exact tokens that filled
it, and a node's path from the root spells the block-aligned prefix
whose K/V the block carries.  On admission the scheduler walks the tree
with the request's prefix (:meth:`PrefixCache.match`), maps every
matched block into the slot's table (one more reference, no device
copy), and starts chunked prefill past them.

Shared blocks are never written: matching stops strictly before the last
prefix token, so the divergent or partial block is always freshly
allocated and rebuilt by prefill (copy-on-write by recompute), and every
later write lands past the shared blocks.  ``NULL_BLOCK`` is never
registered.

The tree holds its own reference on every registered block, so a
retired request's blocks stay resident (multi-turn sessions replay warm)
under two bounds: ``session_ttl_s`` expires entries not touched within
the TTL, ``max_cached_blocks`` caps the footprint (LRU beyond it).  The
scheduler reclaims unmapped cached blocks (:meth:`evict_for_space`)
before it preempts any live slot.

LRU invariant: every lookup or registration touches its whole path,
deepest node first, so an ancestor is always at least as recent as its
descendants and the LRU front is always a leaf.

The keys are crc32 chains over the int32 token bytes, the same bytes as
the JAX package's, so :func:`block_prefix_keys` gives the same integers
there and here.
"""

from __future__ import annotations

import time
import zlib
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from easyparallellibrary_tpu_torch.serving.kv_cache import (
    BlockAllocator, NULL_BLOCK)

# Affinity probes look at most this many block-aligned prefix depths.
AFFINITY_MAX_BLOCKS = 8

# Distinct crc32 chain seeds, so a block-aligned key never collides with
# a short-prompt key of the same bytes.
_BLOCK_SALT = zlib.crc32(b"epl/prefix/block")
_SHORT_SALT = zlib.crc32(b"epl/prefix/short")


def _version_salt(base: int, version: int) -> int:
  """Fold a checkpoint version into a chain seed; version 0 keeps the
  bare salt."""
  if version == 0:
    return base
  return zlib.crc32(np.asarray([version], np.int64).tobytes(), base)


def block_prefix_keys(prompt, block_size: int,
                      max_blocks: int = AFFINITY_MAX_BLOCKS,
                      version: int = 0) -> List[int]:
  """Content keys for every block-aligned prefix depth of ``prompt``,
  shallowest first: ``keys[d-1]`` covers tokens ``[0, d * block_size)``
  and chains the previous depth's crc32.  Only full blocks strictly
  before the last token get a key (:meth:`PrefixCache.match`'s cap); a
  prompt too short for one falls back to one whole-prompt key under a
  distinct salt.  ``version`` scopes the keys to a checkpoint
  version."""
  prompt = np.ascontiguousarray(np.asarray(prompt, np.int32).reshape(-1))
  full = max(0, int(prompt.size) - 1) // block_size if block_size > 0 else 0
  keys: List[int] = []
  crc = _version_salt(_BLOCK_SALT, version)
  for d in range(min(full, max_blocks)):
    crc = zlib.crc32(prompt[d * block_size:(d + 1) * block_size].tobytes(),
                     crc)
    keys.append(crc)
  if not keys:
    keys.append(zlib.crc32(prompt.tobytes(),
                           _version_salt(_SHORT_SALT, version)))
  return keys


class _Node:
  """One cached block: its chained digest (the key in its parent), the
  tokens that filled it (checked on every digest hit), the pool block
  and its place in the tree."""

  __slots__ = ("key", "tokens", "block", "parent", "children",
               "last_touch")

  def __init__(self, key: int, tokens: Optional[np.ndarray], block: int,
               parent: "_Node", now: float):
    self.key = key
    self.tokens = tokens
    self.block = block
    self.parent = parent
    self.children: Dict[int, "_Node"] = {}
    self.last_touch = now


class PrefixCache:
  """Content-addressed radix tree over prompt blocks (module docstring).

  Children are keyed by the chained crc32 of :func:`block_prefix_keys`;
  a digest hit is checked against the node's stored tokens, and a
  mismatch reads as a miss (match) or stops descent (register: the
  first writer keeps the digest).  The tree owns one allocator
  reference per registered block; mapping a match into a slot adds the
  slot's own, so a block is never freed while a table points at it.
  ``hits`` / ``misses`` / ``blocks_reused`` / ``evictions`` are
  cumulative.
  """

  def __init__(self, allocator: BlockAllocator, block_size: int,
               session_ttl_s: float = 0.0, max_cached_blocks: int = 0,
               clock: Callable[[], float] = time.monotonic,
               version: int = 0):
    if block_size < 1:
      raise ValueError(f"block_size must be >= 1: {block_size}")
    if session_ttl_s < 0:
      raise ValueError(f"session_ttl_s must be >= 0: {session_ttl_s}")
    if max_cached_blocks < 0:
      raise ValueError(
          f"max_cached_blocks must be >= 0: {max_cached_blocks}")
    self.allocator = allocator
    self.block_size = block_size
    self.session_ttl_s = session_ttl_s
    self.max_cached_blocks = max_cached_blocks
    self.clock = clock
    self.version = int(version)
    self._chain_seed = _version_salt(_BLOCK_SALT, self.version)
    self._root = _Node(0, None, NULL_BLOCK, None, 0.0)  # sentinel
    # Touch-ordered registry: front = least recent (always a leaf).
    self._lru: "OrderedDict[_Node, None]" = OrderedDict()
    self.hits = 0
    self.misses = 0
    self.blocks_reused = 0
    self.evictions = 0

  @property
  def num_cached_blocks(self) -> int:
    return len(self._lru)

  def _touch_path(self, path: List[_Node], now: float) -> None:
    for node in reversed(path):   # deepest first: ancestors end newer
      node.last_touch = now
      self._lru.move_to_end(node)

  def _remove_subtree(self, node: _Node) -> int:
    """Drop ``node`` and its descendants, releasing the tree's
    references; returns how many nodes went."""
    stack, order = [node], []
    while stack:
      n = stack.pop()
      order.append(n)
      stack.extend(n.children.values())
    for n in reversed(order):  # children first, so parents unlink empty
      del n.parent.children[n.key]
      del self._lru[n]
      self.allocator.decref(n.block)
    self.evictions += len(order)
    return len(order)

  def match(self, prefix: np.ndarray) -> List[int]:
    """Walk the tree with ``prefix``; return the matched blocks (root
    first), each carrying one fresh reference for the caller's table.
    Matching stops strictly before the last token.  Counts one hit (any
    block matched) or one miss."""
    prefix = np.ascontiguousarray(np.asarray(prefix, np.int32)
                                  .reshape(-1))
    bs = self.block_size
    limit = max(0, int(prefix.size) - 1) // bs
    node, path, crc = self._root, [], self._chain_seed
    for d in range(limit):
      chunk = prefix[d * bs:(d + 1) * bs]
      crc = zlib.crc32(chunk, crc)
      child = node.children.get(crc)
      if child is None or not np.array_equal(child.tokens, chunk):
        break
      path.append(child)
      node = child
    if not path:
      self.misses += 1
      return []
    self.hits += 1
    self.blocks_reused += len(path)
    self._touch_path(path, self.clock())
    for n in path:
      self.allocator.incref(n.block)
    return [n.block for n in path]

  def register(self, tokens: np.ndarray, num_blocks: int,
               blocks: List[int]) -> int:
    """Insert the first ``num_blocks`` full blocks of ``tokens``, backed
    by ``blocks[:num_blocks]``, taking a reference on each newly
    inserted block.  The caller guarantees those blocks hold committed
    K/V for exactly those tokens.  On a collision the existing node
    wins.  Returns the number of new nodes."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32)
                                  .reshape(-1))
    bs = self.block_size
    num_blocks = min(num_blocks, int(tokens.size) // bs, len(blocks))
    node, path, added = self._root, [], 0
    now = self.clock()
    crc = self._chain_seed
    for d in range(num_blocks):
      chunk = tokens[d * bs:(d + 1) * bs]
      crc = zlib.crc32(chunk, crc)
      child = node.children.get(crc)
      if child is not None and not np.array_equal(child.tokens, chunk):
        break  # crc collision: nothing below this depth is addressable
      if child is None:
        blk = blocks[d]
        if blk == NULL_BLOCK:
          break  # the trash row is never shareable
        self.allocator.incref(blk)
        child = _Node(crc, chunk.copy(), blk, node, now)
        node.children[crc] = child
        self._lru[child] = None
        added += 1
      path.append(child)
      node = child
    if path:
      self._touch_path(path, now)
    if self.max_cached_blocks > 0:
      self._enforce_budget()
    return added

  def _enforce_budget(self) -> None:
    # Shed least-recent leaves whatever their refcount: a still-mapped
    # block only loses its tree entry, the slot's reference keeps it.
    while len(self._lru) > self.max_cached_blocks:
      self._remove_subtree(next(iter(self._lru)))

  def evict_for_space(self, need: int) -> int:
    """Free up to ``need`` pool blocks by dropping least-recent entries
    whose tree reference is the last one; mapped entries are skipped.
    One front-to-back sweep suffices (a parent freed of its last child
    is newer, so the sweep reaches it later).  Returns blocks freed."""
    freed = 0
    for node in list(self._lru):
      if freed >= need:
        break
      if node.children or self.allocator.refcount(node.block) != 1:
        continue
      self._remove_subtree(node)
      freed += 1
    return freed

  def expire(self, now: Optional[float] = None) -> int:
    """Drop every entry idle past ``session_ttl_s`` (0 = never), popping
    from the LRU front.  Returns how many nodes went."""
    if self.session_ttl_s <= 0 or not self._lru:
      return 0
    now = self.clock() if now is None else now
    deadline = now - self.session_ttl_s
    dropped = 0
    while self._lru:
      front = next(iter(self._lru))
      if front.last_touch > deadline:
        break
      dropped += self._remove_subtree(front)
    return dropped

  def invalidate_blocks(self, blocks: Iterable[int]) -> int:
    """Remove every entry backed by one of ``blocks``, with its subtree;
    K/V that was overwritten must never satisfy a match."""
    bad = set(int(b) for b in blocks)
    if not bad:
      return 0
    removed = 0
    for node in [n for n in self._lru if n.block in bad]:
      if node in self._lru:  # not already gone with an ancestor
        removed += self._remove_subtree(node)
    return removed

  def clear(self) -> int:
    """Drop everything, releasing every tree reference."""
    removed = 0
    for child in list(self._root.children.values()):
      removed += self._remove_subtree(child)
    return removed

  def __repr__(self):
    return (f"PrefixCache(blocks={self.num_cached_blocks}, "
            f"hits={self.hits}, misses={self.misses}, "
            f"reused={self.blocks_reused}, evictions={self.evictions})")
