"""Path, size and micro-batch helpers over the port's trees (port of
``easyparallellibrary_tpu/utils/pytree.py``).

The port's trees are nested dicts (or lists / tuples) of tensors, most
often the flat ``name -> tensor`` state dicts of ``weights``; a leaf's
path is its keys joined with ``/``, as the JAX package renders a key
path.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch


def path_str(path: Sequence[Any]) -> str:
  """Render a sequence of keys or indices as ``'a/b/c'``."""
  return "/".join(str(p) for p in path)


def _walk(tree, prefix: Tuple[Any, ...]):
  if isinstance(tree, dict):
    for key, value in tree.items():
      yield from _walk(value, prefix + (key,))
  elif isinstance(tree, (list, tuple)):
    for i, value in enumerate(tree):
      yield from _walk(value, prefix + (i,))
  elif tree is not None:
    yield prefix, tree


def tree_paths_and_leaves(tree) -> List[Tuple[str, Any]]:
  """``[(path, leaf), ...]`` in insertion order (dict keys as given, the
  JAX package sorts them: callers that compare paths compare sets)."""
  return [(path_str(path), leaf) for path, leaf in _walk(tree, ())]


def leaf_bytes(leaf) -> int:
  """Bytes of one leaf: a tensor, a numpy array, or anything with
  ``shape`` and ``dtype`` (a scalar counts 4 bytes of fp32)."""
  shape = tuple(getattr(leaf, "shape", ()))
  dtype = getattr(leaf, "dtype", np.float32)
  if isinstance(dtype, torch.dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
  else:
    itemsize = np.dtype(dtype).itemsize
  return int(np.prod(shape or (1,))) * itemsize


def tree_bytes(tree) -> int:
  return sum(leaf_bytes(leaf) for _, leaf in tree_paths_and_leaves(tree))


def tree_param_count(tree) -> int:
  """Elements over every leaf of ``tree`` (a scalar counts one)."""
  return sum(int(np.prod(tuple(getattr(leaf, "shape", ())) or (1,)))
             for _, leaf in tree_paths_and_leaves(tree))


def split_micro_batches(batch, num_micro_batch: int):
  """``[B, ...] -> [M, B/M, ...]`` on every leaf of ``batch`` (a dict,
  list or tuple tree of tensors or arrays): the micro-batch slicing of
  gradient accumulation.  Returns the same tree; indexing a leaf's first
  axis gives one micro-batch (a view, no copy)."""

  def reshape(x):
    b = x.shape[0]
    if b % num_micro_batch != 0:
      raise ValueError(
          f"batch {b} not divisible by num_micro_batch {num_micro_batch}")
    return x.reshape((num_micro_batch, b // num_micro_batch)
                     + tuple(x.shape[1:]))

  def walk(tree):
    if isinstance(tree, dict):
      return {k: walk(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
      return type(tree)(walk(v) for v in tree)
    return None if tree is None else reshape(tree)

  return walk(batch)
