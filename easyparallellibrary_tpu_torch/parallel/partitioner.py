"""Stage partitioning (port of
``easyparallellibrary_tpu/parallel/partitioner.py``): weighted
contiguous bucketing (``partition_balance``, shared with the grouped
optimizer apply and the auto gradient-checkpoint segmentation), stage
partitioning of an ordered block list, and repeated-block detection,
for the stage planner (``parallel/planner.py``).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


def partition_balance(weights: Sequence[float], num_parts: int
                      ) -> List[Tuple[int, int]]:
  """Split ``weights`` into ``num_parts`` contiguous ranges minimizing
  the max range sum.  Returns ``[(start, end), ...)`` half-open ranges:
  binary search on the capacity with a greedy fill, then the heaviest
  splittable range split until there are exactly ``num_parts``."""
  n = len(weights)
  if num_parts <= 0:
    raise ValueError("num_parts must be positive")
  if num_parts > n:
    raise ValueError(f"cannot split {n} items into {num_parts} parts")

  def parts_needed(cap: float) -> int:
    count, acc = 1, 0.0
    for w in weights:
      if w > cap:
        return num_parts + 1  # infeasible capacity
      if acc + w > cap:
        count += 1
        acc = w
      else:
        acc += w
    return count

  lo, hi = max(weights), sum(weights)
  for _ in range(64):
    mid = (lo + hi) / 2
    if parts_needed(mid) <= num_parts:
      hi = mid
    else:
      lo = mid
  cap = hi
  ranges: List[Tuple[int, int]] = []
  start, acc = 0, 0.0
  for i, w in enumerate(weights):
    if acc + w > cap and i > start:
      ranges.append((start, i))
      start, acc = i, w
    else:
      acc += w
  ranges.append((start, n))
  while len(ranges) < num_parts:
    idx = max((j for j in range(len(ranges))
               if ranges[j][1] - ranges[j][0] > 1),
              key=lambda j: sum(weights[ranges[j][0]:ranges[j][1]]),
              default=None)
    if idx is None:
      break
    s, e = ranges[idx]
    best_k, best_cost = s + 1, float("inf")
    for k in range(s + 1, e):
      cost = max(sum(weights[s:k]), sum(weights[k:e]))
      if cost < best_cost:
        best_k, best_cost = k, cost
    ranges[idx:idx + 1] = [(s, best_k), (best_k, e)]
  return ranges


def find_repeated_blocks(names: Sequence[str]
                         ) -> "OrderedDict[str, List[str]]":
  """Group names by their repeated-layer pattern: names whose digits,
  each run replaced by ``#``, match belong to one family (``block_0``,
  ``block_1`` ...), in first-seen order."""
  groups: "OrderedDict[str, List[str]]" = OrderedDict()
  for name in names:
    groups.setdefault(re.sub(r"\d+", "#", name), []).append(name)
  return groups


def partition_stages(block_names: Sequence[str], num_stages: int,
                     weights: Optional[Dict[str, float]] = None
                     ) -> List[List[str]]:
  """An ordered block list in ``num_stages`` contiguous groups balanced
  by ``weights`` (parameter counts or FLOPs; 1 for a block without
  one)."""
  ws = [float(weights.get(b, 1.0)) if weights else 1.0 for b in block_names]
  return [list(block_names[s:e])
          for s, e in partition_balance(ws, num_stages)]
