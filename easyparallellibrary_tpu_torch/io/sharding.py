"""IO slicing — sharding input files and samples across data-parallel
workers (port of ``easyparallellibrary_tpu/io/sharding.py``).

Analog of the reference's io_slicing pass
(epl/parallel/graph_editor.py:116-215) and its proportional file
assignment (`fetch_slice_objects_proportion_to_local_num_replicas`,
:787-854): with F files and N replicas, each replica gets a contiguous
slice of ⌊F/N⌋ (+1 for the first F mod N replicas when unbalanced
slicing is allowed; with `drop_last`, the remainder files are dropped so
every replica sees the same count).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from easyparallellibrary_tpu_torch.env import Env


def shard_files(files: Sequence[str], num_shards: int, shard_index: int,
                unbalanced: bool | None = None,
                drop_last: bool | None = None) -> List[str]:
  if num_shards < 1:
    raise ValueError("num_shards must be >= 1")
  if not 0 <= shard_index < num_shards:
    raise ValueError(f"shard_index {shard_index} out of [0, {num_shards})")
  cfg = Env.get().config
  if unbalanced is None:
    unbalanced = cfg.io.unbalanced_io_slicing
  if drop_last is None:
    drop_last = cfg.io.drop_last_files

  files = list(files)
  n = len(files)
  base, rem = divmod(n, num_shards)
  if rem and not unbalanced:
    if drop_last:
      files = files[:n - rem]
      base, rem = len(files) // num_shards, 0
    elif base == 0:
      raise ValueError(
          f"{n} files cannot be evenly sliced across {num_shards} shards; "
          "enable io.unbalanced_io_slicing or io.drop_last_files")
    else:
      # Even slicing requested but remainder exists: fall back to
      # unbalanced (first shards take one extra), matching the
      # reference's proportional dispatch.
      pass
  start = shard_index * base + min(shard_index, rem)
  count = base + (1 if shard_index < rem else 0)
  return files[start:start + count]


def shard_batch_dim(total: int, num_shards: int, shard_index: int
                    ) -> Tuple[int, int]:
  """(offset, size) slice of a sample dimension for this shard."""
  if total % num_shards != 0:
    raise ValueError(f"{total} samples not divisible by {num_shards}")
  size = total // num_shards
  return shard_index * size, size
