"""Serving fault injectors (port of the serving part of
``easyparallellibrary_tpu/testing/chaos.py``): the adversaries the
engine's resilience (serving/resilience.py) is tested against.

* :class:`NaNLogitsInjector` wraps the engine's step callable and hands
  chosen device calls fully-NaN parameters, so the model really computes
  non-finite logits and the engine's finiteness verdict judges real
  device output;
* :class:`HangingStepInjector` sleeps before chosen calls, tripping the
  step watchdog;
* :class:`FlakyDrafter` raises or proposes garbage on chosen calls.

The replica and process injectors wait with the router (ROADMAP.md
Queue 1, "Router, fleet and request migration").
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np


class _StepFnWrapper:
  """Base of the step interceptors: installs itself over
  ``engine._step_fn`` (``fn(params, plan[, num_draft])``) and counts the
  device calls."""

  def __init__(self, engine):
    self.engine = engine
    self.inner = engine._step_fn
    self.calls = 0
    engine._step_fn = self

  def uninstall(self):
    self.engine._step_fn = self.inner


class NaNLogitsInjector(_StepFnWrapper):
  """Poison chosen step calls so the model genuinely computes non-finite
  logits.

  For call indices in ``bad_calls`` (0-based, every step dispatch
  counts), the params argument is swapped for a copy with every floating
  tensor times NaN (same names, shapes, dtypes and device).  A retry of
  the poisoned work is a later call and sees clean params: a transient
  fault.  Adjacent indices (``(3, 4)``) model a persistent one that must
  escalate from retry to requeue.  ``poisoned`` lists the calls that
  were poisoned."""

  def __init__(self, engine, bad_calls: Sequence[int]):
    super().__init__(engine)
    self.bad_calls = set(bad_calls)
    self.poisoned: list = []
    self._nan_params = None

  def _poison(self, params):
    if self._nan_params is None:
      self._nan_params = {
          name: p * float("nan") if p.is_floating_point() else p
          for name, p in params.items()}
    return self._nan_params

  def __call__(self, params, *args):
    call, self.calls = self.calls, self.calls + 1
    if call in self.bad_calls:
      self.poisoned.append(call)
      params = self._poison(params)
    return self.inner(params, *args)


class HangingStepInjector(_StepFnWrapper):
  """Stall chosen step calls by ``hang_s`` of host sleep, which the
  serving watchdog (``serving.resilience.step_timeout_s``) exists to
  surface.  The step then completes normally: outputs stay exact."""

  def __init__(self, engine, hang_calls: Sequence[int],
               hang_s: float = 0.05):
    super().__init__(engine)
    self.hang_calls = set(hang_calls)
    self.hang_s = hang_s
    self.hangs = 0

  def __call__(self, params, *args):
    call, self.calls = self.calls, self.calls + 1
    if call in self.hang_calls:
      self.hangs += 1
      time.sleep(self.hang_s)
    return self.inner(params, *args)


class FlakyDrafter:
  """Drafter wrapper that raises (``mode="raise"``) or proposes uniformly
  random tokens (``mode="garbage"``) on chosen ``propose`` calls.  The
  engine must degrade a raising drafter to zero drafts for the step, and
  verification must reject garbage; either way the committed output
  stays exact."""

  def __init__(self, inner, bad_calls: Sequence[int],
               mode: str = "raise", seed: int = 0):
    if mode not in ("raise", "garbage"):
      raise ValueError(f"unknown FlakyDrafter mode {mode!r}")
    self.inner = inner
    self.bad_calls = set(bad_calls)
    self.mode = mode
    self.calls = 0
    self.faults = 0
    self._rng = np.random.RandomState(seed)
    self._vocab: Optional[int] = None

  @property
  def k(self) -> int:
    return self.inner.k

  def bind(self, engine) -> None:
    self._vocab = engine.model.cfg.vocab_size
    self.inner.bind(engine)

  def propose(self, plan, histories):
    call, self.calls = self.calls, self.calls + 1
    if call in self.bad_calls:
      self.faults += 1
      if self.mode == "raise":
        raise RuntimeError("chaos: drafter failure")
      N = plan.draft_cap.shape[0]
      drafts = self._rng.randint(
          0, self._vocab or 2, (N, self.k)).astype(np.int32)
      return drafts, np.asarray(plan.draft_cap, np.int32)
    return self.inner.propose(plan, histories)

  def observe_commit(self, new_cursors) -> None:
    self.inner.observe_commit(new_cursors)

  def observe_skip(self, plan) -> None:
    self.inner.observe_skip(plan)


__all__ = ["FlakyDrafter", "HangingStepInjector", "NaNLogitsInjector"]
