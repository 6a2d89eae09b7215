"""Step profiler — wall clock, throughput, MFU and device-trace capture
(port of ``easyparallellibrary_tpu/profiler/profiler.py``).

:class:`StepProfiler` is ``fit``'s timing hook; its ``trace`` brackets a
``torch.profiler`` capture (``observability.trace.Tracer.device_trace``,
the counterpart of the JAX package's XLA trace).  :func:`profile_step`,
the static cost model, needs the compiled-cost and memory analyses,
which are not ported.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from easyparallellibrary_tpu_torch._not_ported import (
    OTHER_MODELS, not_ported)
from easyparallellibrary_tpu_torch.profiler.flops import estimate_mfu


def profile_step(fn: Callable, *args, tokens_per_step: Optional[int] = None,
                 num_stages: int = 1, num_micro_batch: int = 1,
                 **kwargs) -> Dict[str, float]:
  raise not_ported("profile_step (compiled_cost and compiled_memory)",
                   OTHER_MODELS)


class StepProfiler:
  """Training-loop timing hook: ``tick()`` once per step; after
  ``warmup`` ticks, the intervals between ticks are the step times."""

  def __init__(self, flops_per_step: float = 0.0,
               tokens_per_step: int = 0, warmup: int = 2):
    self.flops_per_step = flops_per_step
    self.tokens_per_step = tokens_per_step
    self.warmup = warmup
    self.times = []
    # Resilience counters, fed by fit() from the sentinel's totals and
    # the transient-IO retry count.
    self.bad_steps = 0
    self.io_retries = 0
    self._last = None
    self._count = 0

  def note_bad_step(self, n: int = 1):
    self.bad_steps += n

  def note_retry(self, n: int = 1):
    self.io_retries += n

  def tick(self):
    now = time.perf_counter()
    self._count += 1
    if self._count > self.warmup and self._last is not None:
      self.times.append(now - self._last)
    self._last = now

  def summary(self) -> Dict[str, float]:
    if not self.times:
      return {}
    dt = sum(self.times) / len(self.times)
    out = {"step_time_s": dt, "steps_per_sec": 1.0 / dt}
    if self.tokens_per_step:
      out["tokens_per_sec"] = self.tokens_per_step / dt
    if self.flops_per_step and torch.cuda.is_available():
      # MFU is against the card's peak: no card, no MFU.
      out["mfu"] = estimate_mfu(self.flops_per_step, dt)
    if self.bad_steps:
      out["bad_steps"] = float(self.bad_steps)
    if self.io_retries:
      out["io_retries"] = float(self.io_retries)
    return out

  def publish(self, registry, step: int):
    """Publish :meth:`summary` through a MetricRegistry: timing under
    ``train/*``, the health counters under ``resilience/*``."""
    out = self.summary()
    if not out:
      return
    from easyparallellibrary_tpu_torch.observability.registry import (
        split_namespaces)
    registry.publish_many(step, split_namespaces(out))

  def trace(self, log_dir: str):
    """A ``torch.profiler`` capture into ``log_dir`` bracketed by a host
    span of the ambient tracer (``Tracer.device_trace``); use as a
    context manager around the steps to capture."""
    from easyparallellibrary_tpu_torch.observability import (
        trace as trace_lib)
    return trace_lib.get_tracer().device_trace(log_dir)
