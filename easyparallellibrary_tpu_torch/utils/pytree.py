"""Path helpers over the port's parameter trees (the part of
``easyparallellibrary_tpu/utils/pytree.py`` that
``runtime.amp.nonfinite_report`` needs).

The port's trees are nested dicts (or lists / tuples) of tensors, most
often the flat ``name -> tensor`` state dicts of ``weights``; a leaf's
path is its keys joined with ``/``, as the JAX package renders a key
path.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple


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
