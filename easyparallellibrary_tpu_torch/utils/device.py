"""The port's device rule for entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
  """Entry points run on the GPU unless the caller asks for the CPU:
  ``None`` means ``"cuda"``, and a CUDA device on a machine without one
  raises instead of dropping to the CPU."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "no CUDA device is available; pass device='cpu' to run the port "
        "on the CPU")
  return dev


def process_index() -> int:
  """This process's index among a run's processes: the
  ``torch.distributed`` rank when a process group is initialised, else
  0.  Leader-only writers (trace export, the metric sinks) write on 0."""
  import torch.distributed as dist
  if dist.is_available() and dist.is_initialized():
    return dist.get_rank()
  return 0


def process_count() -> int:
  """The run's process count: the ``torch.distributed`` world size when a
  process group is initialised, else 1."""
  import torch.distributed as dist
  if dist.is_available() and dist.is_initialized():
    return dist.get_world_size()
  return 1
