"""The manual-sharding surface (port of
``easyparallellibrary_tpu/utils/compat.py``).

The JAX module papers over two spellings of ``shard_map`` and of the
axis queries inside a manual region.  The port has no ``shard_map``: it
is explicit SPMD, so every rank is always "inside" a manual region over
every axis of its mesh, and the body of a JAX ``shard_map`` is what each
rank's code runs directly.  What remains are the axis queries, answered
from the ambient mesh (``cluster.Mesh``).
"""

from __future__ import annotations

from easyparallellibrary_tpu_torch.communicators import collectives


def axis_size(axis_name: str) -> int:
  """Size of a named mesh axis (1 without a mesh)."""
  return collectives.axis_size(axis_name)


def axis_index(axis_name: str) -> int:
  """This rank's index along a named mesh axis (0 without a mesh)."""
  return collectives.axis_index(axis_name)


def ambient_manual_axes() -> frozenset:
  """The mesh axes this rank's code is manual over: every axis of the
  ambient mesh above 1 (explicit SPMD), empty without a mesh."""
  m = collectives._mesh()
  if m is None:
    return frozenset()
  return frozenset(a for a, s in m.shape.items() if s > 1)
