"""Sharding specs as bookkeeping (port of
``easyparallellibrary_tpu/utils/sharding.py``).

In the JAX package a ``PartitionSpec`` tells GSPMD where a value lives,
and ``constrain`` moves data to match.  In the port each rank holds its
shard explicitly, so a spec only records which dims of a parameter or
activation are split over which mesh axis; :func:`constrain` checks a
local tensor against the spec (its shape is the global shape divided by
the axis sizes) and moves no data.  There is no counterpart of
``shard_map``: the rank's own code is the manual region.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from easyparallellibrary_tpu_torch.communicators import collectives

# A dim that the spec leaves to whatever layout the value already has
# (``P.UNCONSTRAINED``): never checked.
UNCONSTRAINED = "unconstrained"


def manual_axes() -> frozenset:
  from easyparallellibrary_tpu_torch.utils.compat import ambient_manual_axes
  return ambient_manual_axes()


def local_shape(global_shape: Sequence[int], spec: Tuple, mesh=None
                ) -> Tuple[int, ...]:
  """The per-rank shape of a value of ``global_shape`` under ``spec``
  (each entry None, an axis name, a tuple of names or UNCONSTRAINED)."""
  out = list(global_shape)
  for dim, entry in enumerate(spec):
    if entry is None or entry == UNCONSTRAINED:
      continue
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    n = 1
    for name in names:
      n *= collectives.axis_size(name, mesh)
    if out[dim] % n:
      raise ValueError(f"dim {dim} of {tuple(global_shape)} does not "
                       f"divide {names} ({n})")
    out[dim] //= n
  return tuple(out)


def constrain(x, spec: Tuple, global_shape: Optional[Sequence[int]] = None,
              mesh=None):
  """Check the local ``x`` against ``spec`` and return it unchanged.
  Without ``global_shape`` only the spec's rank is checked (as the JAX
  helper raises on a spec longer than the value); with it, ``x`` must
  have the local shape the spec gives."""
  if len(spec) > x.dim():
    raise ValueError(
        f"sharding spec {spec} has more entries than value rank {x.dim()}")
  if global_shape is not None:
    want = local_shape(global_shape, spec, mesh)
    if tuple(x.shape) != want:
      raise ValueError(f"local shape {tuple(x.shape)} does not match "
                       f"spec {spec} of global {tuple(global_shape)}: "
                       f"want {want}")
  return x
