"""Shared helpers for the sequence-parallel paths (port of
``easyparallellibrary_tpu/sequence/_util.py``)."""

from __future__ import annotations


def axis_if_divisible(dim_size: int, mesh, axis_name: str):
  """``axis_name`` when the dimension divides that mesh axis, else
  None."""
  return axis_name if dim_size % mesh.axis_size(axis_name) == 0 else None
