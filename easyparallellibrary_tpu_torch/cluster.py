"""Cluster: the device pool and the mesh record (port of
``easyparallellibrary_tpu/cluster.py``).

The JAX cluster builds a ``jax.sharding.Mesh`` over the logical axes
``(stage, data, seq, expert, model)``.  The port runs one process on one
device, so its mesh is a plain record of the same axis names, their
sizes and the device: every axis has size 1.  An axis above 1 (data
parallelism over several devices, tensor parallelism from a ``split``
scope, pipeline stages, sequence or expert parallelism) raises through
``not_ported``; the ``torch.distributed`` mesh that carries them is
ROADMAP.md Queue 1 work, and with it the JAX package's layout policies
(``auto``, ``all``, and the ``cluster.mesh_shape`` spec, which the port
accepts only when every axis it names is 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch._not_ported import (
    PARALLEL_STRATEGIES, TENSOR_PARALLEL, not_ported)
from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
  """The mesh of one program: axis sizes by name (outermost first, as
  ``jax.sharding.Mesh.shape``) and the devices, row-major."""
  shape: Dict[str, int]
  devices: tuple

  @property
  def axis_names(self) -> tuple:
    return tuple(self.shape)

  @property
  def device(self) -> torch.device:
    """The device of a one-device mesh: where state and batches live."""
    return self.devices[0]


def _check_one_device(sizes: Dict[str, int]):
  for axis, size in sizes.items():
    if size > 1:
      item = (TENSOR_PARALLEL
              if axis in (constants.MODEL_AXIS, constants.DATA_AXIS)
              else PARALLEL_STRATEGIES)
      raise not_ported(f"a mesh with {axis}={size} (the port runs one "
                       "process on one device)", item)


def _parse_mesh_shape(spec: str) -> Dict[str, int]:
  """``"data:1,model:1"`` -> ``{"data": 1, "model": 1}``."""
  sizes = {}
  for part in spec.split(","):
    if not part.strip():
      continue
    axis, _, num = part.partition(":")
    axis = axis.strip()
    if axis not in constants.MESH_AXES:
      raise ValueError(f"Unknown mesh axis '{axis}' in mesh_shape spec "
                       f"{spec!r}; valid: {constants.MESH_AXES}")
    sizes[axis] = int(num)
  return sizes


class Cluster:
  """Device pool + mesh factory.

  ``devices`` defaults to the one device the caller names (``device``;
  the current CUDA device unless ``device="cpu"``), and a machine
  without a GPU raises unless the caller asks for the CPU."""

  def __init__(self, devices: Optional[List[torch.device]] = None,
               device=None):
    if devices is None:
      dev = resolve_device(device)
      if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
      devices = [dev]
    self.devices = [torch.device(d) for d in devices]
    self._mesh: Optional[Mesh] = None

  @property
  def num_devices(self) -> int:
    return len(self.devices)

  def build_mesh(self, **requested: int) -> Mesh:
    """Build the 5-axis mesh record, every axis of size 1.  Raises
    ``NotImplementedError`` for an axis above 1: requested, set by
    ``cluster.mesh_shape``, or a data axis over several devices."""
    _check_one_device(requested)
    _check_one_device(_parse_mesh_shape(Env.get().config.cluster.mesh_shape))
    _check_one_device({constants.DATA_AXIS: self.num_devices})
    self._mesh = Mesh(shape={a: 1 for a in constants.MESH_AXES},
                      devices=tuple(self.devices))
    return self._mesh

  @property
  def mesh(self) -> Mesh:
    if self._mesh is None:
      self.build_mesh()
    return self._mesh

  @property
  def built_mesh(self) -> Optional[Mesh]:
    """The mesh if :meth:`build_mesh` has run, else None."""
    return self._mesh

  def axis_size(self, axis: str) -> int:
    return self.mesh.shape[axis]

  def __repr__(self):
    shape = None if self._mesh is None else dict(self._mesh.shape)
    return f"Cluster(num_devices={self.num_devices}, mesh={shape})"
