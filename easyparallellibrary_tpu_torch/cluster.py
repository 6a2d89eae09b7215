"""Cluster: the process pool, the layouts and the mesh (port of
``easyparallellibrary_tpu/cluster.py``).

The JAX cluster builds one ``jax.sharding.Mesh`` over the logical axes
``(stage, data, seq, expert, model)`` and lets GSPMD place one program
on it.  The port is explicit SPMD on ``torch.distributed``: one process
per rank, each with one device, and the mesh is a record of the axis
sizes, this rank's coordinates and one process group per axis above 1
(the ranks that differ only in that axis).  Ranks are laid out
row-major over the axes, ``model`` innermost, as the JAX mesh orders
its devices.

Layouts mirror the JAX ones: ``auto`` infers the data axis from the
world size, ``all`` puts every rank on the data axis, and the
``cluster.mesh_shape`` spec (``SpecificLayout``) gives exact sizes.
The ``stage`` axis carries the pipeline (``parallel/pipeline.py``): its
group holds the ranks of one pipeline, each a stage, and each stage is a
``VirtualDevice`` of the ranks that share its stage index.  The ``seq``
axis carries sequence parallelism (``sequence/``: each rank a slice of
the tokens) and the ``expert`` axis the MoE experts (``models/moe.py``:
each rank ``E / ep`` of them; under ``moe_impl="a2a"`` the batch rows
split over ``("data", "expert")``).

A world of one (no process group) is the one-device mesh of earlier
slices: every axis has size 1 and no group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.utils.device import (
    process_count, process_index, resolve_device)


class VirtualDevice:
  """The ranks backing one pipeline stage: introspection metadata, as in
  the JAX package (placement is one device per process)."""

  def __init__(self, stage_index: int, devices: Sequence[torch.device]):
    self.stage_index = stage_index
    self.devices = list(devices)

  @property
  def num_devices(self) -> int:
    return len(self.devices)

  def __repr__(self):
    return (f"VirtualDevice(stage={self.stage_index}, "
            f"devices={[str(d) for d in self.devices]})")


@dataclasses.dataclass(frozen=True)
class Mesh:
  """The mesh of one program: axis sizes by name (outermost first, as
  ``jax.sharding.Mesh.shape``), every rank's device, row-major, this
  process's rank, and the process group of each axis above 1."""
  shape: Dict[str, int]
  devices: tuple
  rank: int = 0
  groups: Dict[str, object] = dataclasses.field(default_factory=dict)

  @property
  def axis_names(self) -> tuple:
    return tuple(self.shape)

  @property
  def size(self) -> int:
    return math.prod(self.shape.values())

  @property
  def device(self) -> torch.device:
    """This rank's device: where its state and batches live."""
    return self.devices[self.rank]

  @property
  def coords(self) -> Dict[str, int]:
    """This rank's index along every axis."""
    out, rest = {}, self.rank
    for axis in reversed(self.axis_names):
      out[axis] = rest % self.shape[axis]
      rest //= self.shape[axis]
    return dict((a, out[a]) for a in self.axis_names)

  def axis_size(self, axis: str) -> int:
    return self.shape.get(axis, 1)

  def axis_index(self, axis: str) -> int:
    return self.coords.get(axis, 0)

  def group(self, axis: str):
    """The process group of ``axis``, or None for an axis of size 1
    (every collective over it is the identity)."""
    if self.axis_size(axis) <= 1:
      return None
    return self.groups[axis]

  def group_ranks(self, axis: str) -> List[int]:
    """The global ranks of this rank's group along ``axis``, in axis
    order."""
    return _axis_ranks(self.shape, self.coords, axis)


def _axis_ranks(shape: Dict[str, int], coords: Dict[str, int],
                axis: str) -> List[int]:
  names = list(shape)
  out = []
  for i in range(shape[axis]):
    c = dict(coords)
    c[axis] = i
    r = 0
    for a in names:
      r = r * shape[a] + c[a]
    out.append(r)
  return out


def _all_coords(shape: Dict[str, int]):
  for flat in range(math.prod(shape.values())):
    c, rest = {}, flat
    for a in reversed(list(shape)):
      c[a] = rest % shape[a]
      rest //= shape[a]
    yield c


def _build_groups(shape: Dict[str, int], rank: int) -> Dict[str, object]:
  """One process group per axis above 1.  Every rank creates every
  group in the same order (``new_group`` is collective over the world),
  and keeps the ones it belongs to."""
  import torch.distributed as dist
  mine = {}
  for axis, size in shape.items():
    if size <= 1:
      continue
    seen = set()
    for c in _all_coords(shape):
      ranks = tuple(_axis_ranks(shape, c, axis))
      if ranks in seen:
        continue
      seen.add(ranks)
      group = dist.new_group(list(ranks))
      if rank in ranks:
        mine[axis] = group
  return mine


class Layout:
  """Base layout: the per-axis mesh sizes."""

  name = "base"

  def axis_sizes(self, cluster: "Cluster",
                 requested: Dict[str, int]) -> Dict[str, int]:
    raise NotImplementedError


class AllLayout(Layout):
  """Every rank on the data axis: pure data parallelism."""

  name = "all"

  def axis_sizes(self, cluster, requested):
    sizes = {axis: 1 for axis in constants.MESH_AXES}
    sizes[constants.DATA_AXIS] = cluster.num_devices
    return sizes


class AutoLayout(Layout):
  """Data axis = world size / (stage * seq * expert * model)."""

  name = "auto"

  def axis_sizes(self, cluster, requested):
    sizes = {axis: int(requested.get(axis, 1))
             for axis in constants.MESH_AXES}
    fixed = math.prod(
        sizes[a] for a in constants.MESH_AXES if a != constants.DATA_AXIS)
    total = cluster.num_devices
    if total % fixed != 0:
      raise ValueError(
          f"Cannot lay out mesh: {total} devices not divisible by "
          f"stage*seq*expert*model = {fixed} (requested {requested})")
    explicit = requested.get(constants.DATA_AXIS, 0)
    sizes[constants.DATA_AXIS] = explicit if explicit else total // fixed
    if math.prod(sizes.values()) != total:
      raise ValueError(f"Mesh sizes {sizes} do not cover {total} devices")
    return sizes


class SpecificLayout(Layout):
  """Exact sizes from the ``cluster.mesh_shape`` spec, e.g.
  ``"data:2,model:2"``."""

  name = "specific"

  def __init__(self, spec: str):
    self.sizes = {axis: 1 for axis in constants.MESH_AXES}
    for part in spec.split(","):
      if not part.strip():
        continue
      axis, _, num = part.partition(":")
      axis = axis.strip()
      if axis not in self.sizes:
        raise ValueError(f"Unknown mesh axis '{axis}' in mesh_shape spec "
                         f"{spec!r}; valid: {constants.MESH_AXES}")
      self.sizes[axis] = int(num)

  def axis_sizes(self, cluster, requested):
    if math.prod(self.sizes.values()) != cluster.num_devices:
      raise ValueError(
          f"mesh_shape {self.sizes} does not match device count "
          f"{cluster.num_devices}")
    for axis, size in requested.items():
      if size > 1 and self.sizes.get(axis, 1) != size:
        raise ValueError(
            f"cluster.mesh_shape sets {axis}={self.sizes.get(axis, 1)} but "
            f"the recorded strategy scopes require {axis}={size}; make the "
            f"explicit shape consistent with the annotations")
    return dict(self.sizes)


_LAYOUTS = {"all": AllLayout, "auto": AutoLayout}


class Cluster:
  """Process pool + mesh factory.

  One device per process: this process's device (``device``; the
  current CUDA device unless ``device="cpu"``, and a machine without a
  GPU raises unless the caller asks for the CPU), and the world size of
  the default process group (1 without one).  ``devices`` lists every
  rank's device explicitly."""

  def __init__(self, devices: Optional[List[torch.device]] = None,
               device=None, layout="auto"):
    self.process_index = process_index()
    self.process_count = process_count()
    if devices is None:
      dev = resolve_device(device)
      if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
      if dev.type == "cuda" and self.process_count > 1:
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", r % count)
                   for r in range(self.process_count)]
      else:
        devices = [dev] * self.process_count
    self.devices = [torch.device(d) for d in devices]
    # The cluster.mesh_shape spec is parsed when the mesh is built.
    self._spec = Env.get().config.cluster.mesh_shape
    self.layout: Layout = (layout if isinstance(layout, Layout)
                           else _LAYOUTS[layout]())
    self._mesh: Optional[Mesh] = None
    self.virtual_devices: List[VirtualDevice] = []

  @property
  def num_devices(self) -> int:
    return len(self.devices)

  def build_mesh(self, **requested: int) -> Mesh:
    """Build the 5-axis mesh and its process groups, one a mesh axis
    above 1 (collective: every rank calls it with the same request)."""
    if self._spec:
      self.layout = SpecificLayout(self._spec)
    if len(self.devices) != self.process_count:
      # The JAX package drives several devices from one process; the
      # port's SPMD design does not.
      raise NotImplementedError(
          f"{len(self.devices)} devices for {self.process_count} "
          "process(es): the port runs one device per process; start one "
          "process per device (utils.launcher.launch_local)")
    sizes = self.layout.axis_sizes(self, requested)
    groups = (_build_groups(sizes, self.process_index)
              if self.process_count > 1 else {})
    self._mesh = Mesh(shape=sizes, devices=tuple(self.devices),
                      rank=self.process_index, groups=groups)
    stage_of = [c[constants.STAGE_AXIS] for c in _all_coords(sizes)]
    self.virtual_devices = [
        VirtualDevice(i, [d for d, s in zip(self.devices, stage_of) if s == i])
        for i in range(sizes[constants.STAGE_AXIS])]
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
    return (f"Cluster(num_devices={self.num_devices}, "
            f"processes={self.process_count}, layout={self.layout.name!r}, "
            f"mesh={shape})")
