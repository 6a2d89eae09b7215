"""Memory profiling (port of ``easyparallellibrary_tpu/profiler/memory.py``).

The JAX package reads the runtime's live and peak HBM per device
(``Device.memory_stats()``) and the compiler's static memory plan of a
step (``Compiled.memory_analysis()``).  PyTorch has no compiled plan to
ask, so :func:`compiled_memory` measures one run of the function on
copies of its arguments, under JAX's keys:

* ``argument_size_in_bytes`` / ``output_size_in_bytes`` — the tensors'
  ``nbytes`` (an output that is one of the arguments, updated in place,
  counts in both, as an aliased buffer does in XLA's plan);
* ``temp_size_in_bytes`` — what the run adds at its peak over the memory
  in use when it starts: on the card the allocator's peak
  (``torch.cuda.max_memory_allocated`` after
  ``torch.cuda.reset_peak_memory_stats()``) less the allocated bytes at
  the start, on the CPU the peak of the running sum of
  ``torch.profiler``'s memory events over the run (the cycle collector
  is held off during the run on both);
* ``generated_code_size_in_bytes`` — the size of the kernel libraries
  this process has loaded (``kernels/_build.py``), the code the step
  brings to the card; 0 when none is loaded (on the CPU);
* ``total_bytes`` — temp plus arguments, as in JAX.

:class:`MemoryProfiler` records the card's HBM every ``every_n_steps``
and writes CSV, and a PNG where matplotlib is installed (a logged no-op
otherwise, as in JAX).
"""

from __future__ import annotations

import csv
import gc
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from easyparallellibrary_tpu_torch.utils.logging import get_logger


def device_memory_stats(device=None) -> Dict[str, float]:
  """The card's ``bytes_in_use`` (``torch.cuda.memory_allocated``),
  ``peak_bytes_in_use`` (``max_memory_allocated``) and ``bytes_limit``
  (the card's memory, ``mem_get_info``), JAX's keys."""
  device = torch.device("cuda", torch.cuda.current_device()) \
      if device is None else torch.device(device)
  return {
      "bytes_in_use": float(torch.cuda.memory_allocated(device)),
      "peak_bytes_in_use": float(torch.cuda.max_memory_allocated(device)),
      "bytes_limit": float(torch.cuda.mem_get_info(device)[1]),
  }


def _nbytes(tree) -> float:
  from easyparallellibrary_tpu_torch.profiler.flops import tensors_of
  return float(sum(t.numel() * t.element_size() for t in tensors_of(tree)))


_MARK = "epl_compiled_memory_run"


def _cpu_run(fn, args, kwargs):
  """``(copied args, output, peak bytes added)`` of one CPU run on fresh
  copies, from the profiler's memory events inside the run's mark.  The
  copies are made inside the profiled window, so every block the run
  frees was allocated where the profiler saw it (a block allocated
  before a window is freed without a size)."""
  from easyparallellibrary_tpu_torch.profiler.flops import copy_args
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU],
      profile_memory=True) as prof:
    args, kwargs = copy_args(args, kwargs)
    with torch.profiler.record_function(_MARK):
      out = fn(*args, **kwargs)
  events = prof.profiler.kineto_results.events()
  mark = next(e for e in events if e.name() == _MARK)
  live = peak = 0
  for e in events:
    if e.name() == "[memory]" and mark.start_ns() <= e.start_ns() \
        <= mark.end_ns():
      live += e.nbytes()
      peak = max(peak, live)
  return (args, kwargs), out, float(peak)


def compiled_memory(fn: Callable, *args, **kwargs) -> Dict[str, float]:
  """The memory of one run of ``fn(*args, **kwargs)`` on copies of the
  arguments, under XLA's keys (module docstring)."""
  from easyparallellibrary_tpu_torch.kernels import _build
  from easyparallellibrary_tpu_torch.profiler.flops import (
      copy_args, tensors_of)
  arg_bytes = _nbytes((args, kwargs))
  devices = {t.device for t in tensors_of((args, kwargs))}
  cuda = next((d for d in devices if d.type == "cuda"), None)
  # The cycle collector off for the run: what it would free mid-run, and
  # when, varies from run to run; reference counting does not.
  gc.collect()
  gc.disable()
  try:
    if cuda is not None:
      args, kwargs = copy_args(args, kwargs)
      torch.cuda.synchronize(cuda)
      start = torch.cuda.memory_allocated(cuda)
      torch.cuda.reset_peak_memory_stats(cuda)
      out = fn(*args, **kwargs)
      torch.cuda.synchronize(cuda)
      temp = float(torch.cuda.max_memory_allocated(cuda) - start)
    else:
      _copies, out, temp = _cpu_run(fn, args, kwargs)
  finally:
    gc.enable()
  return {
      "temp_size_in_bytes": temp,
      "argument_size_in_bytes": arg_bytes,
      "output_size_in_bytes": _nbytes(out),
      "generated_code_size_in_bytes": float(_build.loaded_bytes()),
      "total_bytes": temp + arg_bytes,
  }


class MemoryProfiler:
  """Per-step HBM recorder with CSV export (the reference's
  MemoryProfilerHook emits CSV and PNG)."""

  def __init__(self, every_n_steps: int = 10,
               csv_path: Optional[str] = None):
    self.every_n_steps = every_n_steps
    self.csv_path = csv_path
    self.records: List[Dict[str, float]] = []
    self._step = 0

  def step(self) -> Optional[Dict[str, float]]:
    self._step += 1
    if self._step % self.every_n_steps != 0:
      return None
    rec = {"step": self._step, "time": time.time()}
    for i in range(torch.cuda.device_count()):
      stats = device_memory_stats(i)
      rec[f"dev{i}_bytes_in_use"] = stats["bytes_in_use"]
      rec[f"dev{i}_peak_bytes"] = stats["peak_bytes_in_use"]
    self.records.append(rec)
    return rec

  def peak_bytes(self) -> float:
    peaks = [v for r in self.records for k, v in r.items()
             if k.endswith("_peak_bytes")]
    return max(peaks) if peaks else 0.0

  def dump_csv(self, path: Optional[str] = None):
    path = path or self.csv_path
    if not path or not self.records:
      return
    keys = sorted({k for r in self.records for k in r})
    with open(path, "w", newline="") as f:
      writer = csv.DictWriter(f, fieldnames=keys)
      writer.writeheader()
      writer.writerows(self.records)
    get_logger().info("memory profile written to %s", path)

  def dump_png(self, path: str,
               phase_spans: Optional[List[tuple]] = None):
    """Plot the per-device HBM timeline, ``phase_spans`` ([(start_step,
    end_step, label), ...]) shaded behind the curves.  No-op (with a log
    line) when matplotlib is unavailable or nothing was recorded."""
    if not self.records:
      get_logger().info("memory profile: nothing recorded, skipping %s",
                        path)
      return
    try:
      import matplotlib
      matplotlib.use("Agg")
      import matplotlib.pyplot as plt
    except ImportError:
      get_logger().info("matplotlib unavailable; wrote no PNG (use "
                        "dump_csv)")
      return
    steps = [r["step"] for r in self.records]
    fig, ax = plt.subplots(figsize=(8, 4))
    dev_keys = sorted({k.split("_")[0] for r in self.records
                       for k in r if k.startswith("dev")})
    for dk in dev_keys:
      in_use = [r.get(f"{dk}_bytes_in_use", 0) / 2**30
                for r in self.records]
      peak = [r.get(f"{dk}_peak_bytes", 0) / 2**30 for r in self.records]
      ax.plot(steps, in_use, label=f"{dk} in use")
      ax.plot(steps, peak, linestyle="--", label=f"{dk} peak")
    for start, end, label in phase_spans or ():
      ax.axvspan(start, end, alpha=0.12, label=label)
    ax.set_xlabel("step")
    ax.set_ylabel("HBM (GiB)")
    ax.legend(loc="upper left", fontsize=7)
    ax.set_title("device memory timeline")
    fig.tight_layout()
    fig.savefig(os.fspath(path), dpi=110)
    plt.close(fig)
    get_logger().info("memory timeline PNG written to %s", path)
