"""The step watchdog (port of ``StepWatchdog`` from
``easyparallellibrary_tpu/runtime/resilience.py``).

The serving engine arms it around each device step when
``serving.resilience.step_timeout_s`` > 0, so a wedged step surfaces in
the log with a step number instead of as silence.  The training
sentinel and rollback of the JAX module are not ported (ROADMAP.md
Queue 1, "Runtime around the step").
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from easyparallellibrary_tpu_torch.utils.logging import get_logger


class StepWatchdog:
  """Deadline monitor for loop iterations.

  ``arm(step)`` before the iteration, ``disarm()`` after; if the
  deadline passes first, diagnostics are logged (and
  ``on_timeout(step)`` called).  The step is not interrupted: the role
  is observability only.

  One long-lived daemon thread (``epl-step-watchdog``) waits on a
  condition variable; ``arm``/``disarm`` only move the deadline under
  the lock, so a step costs a lock acquire and a notify.  ``close()``
  ends the thread.
  """

  def __init__(self, timeout_s: float,
               on_timeout: Optional[Callable[[int], None]] = None,
               knob: str = "resilience.step_timeout_s"):
    self.timeout_s = timeout_s
    self.on_timeout = on_timeout
    # The config knob that set this deadline, named in the timeout log.
    self.knob = knob
    self.timeouts_fired = 0
    self._cond = threading.Condition()
    self._deadline: Optional[float] = None
    self._step = -1
    self._closed = False
    self._thread: Optional[threading.Thread] = None

  def _ensure_thread(self):
    if self._thread is None or not self._thread.is_alive():
      self._thread = threading.Thread(target=self._run,
                                      name="epl-step-watchdog",
                                      daemon=True)
      self._thread.start()

  def arm(self, step: int):
    with self._cond:
      self._deadline = time.monotonic() + self.timeout_s
      self._step = step
      self._ensure_thread()
      self._cond.notify()

  def disarm(self):
    with self._cond:
      self._deadline = None
      self._cond.notify()

  def _run(self):
    while True:
      with self._cond:
        if self._closed:
          return
        if self._deadline is None:
          self._cond.wait()
          continue
        remaining = self._deadline - time.monotonic()
        if remaining > 0:
          self._cond.wait(remaining)
          continue
        step, self._deadline = self._step, None  # fire once per arm
      self._fire(step)

  def _fire(self, step: int):
    # Written here, read by the host loop: the counter shares the
    # condition's lock.
    with self._cond:
      self.timeouts_fired += 1
    # An instant from the monitor thread (its own trace track): the
    # wedged window shows in the timeline next to the span that never
    # closed.
    from easyparallellibrary_tpu_torch.observability import (
        trace as trace_lib)
    trace_lib.get_tracer().instant(
        "resilience/watchdog_timeout", cat="resilience",
        track="resilience/watchdog",
        args={"step": step, "timeout_s": self.timeout_s})
    devices = torch.cuda.device_count() if torch.cuda.is_available() else 0
    get_logger().warning(
        "watchdog: step %d exceeded the %.1fs deadline (%s); %d CUDA "
        "device(s) visible. Likely causes: a stalled input pipeline, a "
        "wedged device call or collective. Dumping thread stacks to "
        "stderr.", step, self.timeout_s, self.knob, devices)
    try:
      import faulthandler
      faulthandler.dump_traceback(all_threads=True)
    except Exception:  # pragma: no cover
      pass
    if self.on_timeout is not None:
      self.on_timeout(step)

  def close(self):
    with self._cond:
      self._closed = True
      self._deadline = None
      self._cond.notify()
    if self._thread is not None:
      self._thread.join(timeout=1.0)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
