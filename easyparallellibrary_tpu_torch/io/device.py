"""Host-to-device input feeding (port of
``easyparallellibrary_tpu/io/device.py``).

* :func:`global_batch` assembles the processes' host batches into the
  global batch, on the mesh's device of every process: their
  concatenation in process order (an all-gather over the default group
  when there is more than one process), which
  ``parallel.parallelize`` then cuts to each rank's rows.
* :class:`DevicePrefetcher` keeps ``depth`` batches in flight so host IO
  (``io.RecordReader``) and the copies overlap the training step.  A
  ``non_blocking`` copy from pageable memory is synchronous, so each
  leaf is first staged in pinned host memory, then copied on a side
  stream; the consumer's stream waits on the copy's event (no host
  wait), and ``record_stream`` keeps the caching allocator from handing
  the buffer to another tensor while the consumer's work is in flight.
  Order and depth are the JAX prefetcher's.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator, Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch.utils.device import (
    process_count, resolve_device)


def _map(tree, fn):
  if isinstance(tree, dict):
    return {k: _map(v, fn) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(v, fn) for v in tree)
  return fn(tree)


def _leaves(tree):
  if isinstance(tree, dict):
    for v in tree.values():
      yield from _leaves(v)
  elif isinstance(tree, (list, tuple)):
    for v in tree:
      yield from _leaves(v)
  else:
    yield tree


def _as_host_tensor(x) -> torch.Tensor:
  if isinstance(x, torch.Tensor):
    return x
  return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _gather_processes(t: torch.Tensor) -> torch.Tensor:
  import torch.distributed as dist

  from easyparallellibrary_tpu_torch.communicators.collectives import (
      _raw_all_gather)
  return _raw_all_gather(t, dist.group.WORLD, 0)


def global_batch(local_batch, mesh=None, spec=None, device=None):
  """The global batch from each process's ``local_batch`` (a tree of
  arrays or tensors; this process's rows), on the mesh's device
  (``mesh.device``; without a mesh, ``device``, default the GPU): the
  processes' rows concatenated in process order along dim 0.  ``spec``
  is the JAX default, the leading dim over ``data``."""
  del spec
  dev = mesh.device if mesh is not None else resolve_device(device)
  many = process_count() > 1
  return _map(local_batch, lambda x: (
      _gather_processes(_as_host_tensor(x).to(dev)) if many
      else _as_host_tensor(x).to(dev)))


class DevicePrefetcher:
  """Wrap a host batch iterator; keeps ``depth`` batches (default
  ``io.prefetch``) copied or in flight to the device ahead of the
  consumer.  On the CPU (``device="cpu"`` or a CPU mesh) the batches are
  only converted to tensors."""

  def __init__(self, iterator: Iterator[Any], mesh=None, spec=None,
               depth: Optional[int] = None, device=None):
    from easyparallellibrary_tpu_torch.env import Env
    del spec
    self._it = iter(iterator)
    self._mesh = mesh
    self.device = mesh.device if mesh is not None else \
        resolve_device(device)
    if depth is None:
      depth = Env.get().config.io.prefetch
    self._depth = max(1, depth)
    self._queue: collections.deque = collections.deque()
    self._cuda = self.device.type == "cuda"
    self._stream = torch.cuda.Stream(self.device) if self._cuda else None
    self.copies = 0

  def _stage(self, host):
    """Start one batch's copy: pinned staging, then a copy on the side
    stream.  The pinned buffers stay referenced until the batch is
    consumed (the host allocator also holds a block until its copy's
    event completes)."""
    if process_count() > 1:
      # Several processes: every batch is assembled by a collective, in
      # step with the other processes' prefetchers.
      return global_batch(host, self._mesh, device=self.device), None, None
    if not self._cuda:
      return _map(host, _as_host_tensor), None, None
    pinned = _map(host, lambda x: _as_host_tensor(x).pin_memory())
    with torch.cuda.stream(self._stream):
      out = _map(pinned, lambda t: t.to(self.device, non_blocking=True))
      event = torch.cuda.Event()
      event.record(self._stream)
    self.copies += 1
    return out, event, pinned

  def _fill(self):
    while len(self._queue) < self._depth:
      try:
        host = next(self._it)
      except StopIteration:
        return
      self._queue.append(self._stage(host))

  def __iter__(self):
    return self

  def __next__(self):
    self._fill()
    if not self._queue:
      raise StopIteration
    out, event, _pinned = self._queue.popleft()
    if event is not None:
      consumer = torch.cuda.current_stream(self.device)
      consumer.wait_event(event)
      for t in _leaves(out):
        t.record_stream(consumer)
    self._fill()
    return out
