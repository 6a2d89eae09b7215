"""Anomaly sentinel, rollback and step watchdog — the resilience layer
(port of ``easyparallellibrary_tpu/runtime/resilience.py``).

* **skip** — a finite check on the loss and the gradients makes a bad
  step a true no-op with no host sync.  The JAX package runs the update
  and selects the old state wholesale with ``jnp.where``; the port's
  optimizer updates in place, so :func:`runtime.trainer.build_train_step`
  hands the verdict to torch's fused AdamW as its ``found_inf`` input —
  the kernel leaves parameters, both moments and the decoupled weight
  decay untouched and takes its step increment back, all on the device
  — and :func:`guard_step` (any step function, checked after the update)
  restores a snapshot through ``torch.where``.
* **rollback** — consecutive bad steps are counted on the device in
  :class:`SentinelState`; ``fit`` reads the counter once per
  ``max_bad_steps`` window and, past the threshold, restores the newest
  valid checkpoint (optionally backing off the learning rate).
* **watchdog** — :class:`StepWatchdog` logs diagnostics when one loop
  iteration exceeds a wall-clock deadline (the serving engine arms it
  too, under ``serving.resilience.step_timeout_s``).

Knobs: the ``resilience.*`` config group.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Consecutive rollbacks without a clean window in between: after this
# many the fault is clearly not transient and fit() fails loudly rather
# than replaying the same window forever.
MAX_CONSECUTIVE_ROLLBACKS = 3


def sentinel_enabled(config=None) -> bool:
  """Whether the anomaly guard is active (``resilience.sentinel``,
  implied by ``resilience.max_bad_steps > 0``)."""
  if config is None:
    from easyparallellibrary_tpu_torch.env import Env
    config = Env.get().config
  return bool(config.resilience.sentinel
              or config.resilience.max_bad_steps > 0)


@dataclasses.dataclass(frozen=True)
class SentinelState:
  """Anomaly counters carried in the train state, 0-d int32 tensors on
  the device.  ``bad_consecutive`` resets to zero on every finite step;
  ``bad_total`` only grows."""
  bad_consecutive: torch.Tensor
  bad_total: torch.Tensor

  @classmethod
  def create(cls, device=None) -> "SentinelState":
    return cls(bad_consecutive=torch.zeros((), dtype=torch.int32,
                                           device=device),
               bad_total=torch.zeros((), dtype=torch.int32, device=device))

  def replace(self, **fields) -> "SentinelState":
    return dataclasses.replace(self, **fields)

  def update(self, finite) -> "SentinelState":
    finite = torch.as_tensor(finite, device=self.bad_total.device)
    bad = (~finite).to(torch.int32)
    return self.replace(
        bad_consecutive=torch.where(finite,
                                    torch.zeros_like(self.bad_consecutive),
                                    self.bad_consecutive + 1),
        bad_total=self.bad_total + bad)


def _state_device(state):
  for p in state.params.values():
    return p.device
  return None


def attach_sentinel(state):
  """Give a TrainState its sentinel counters on its parameters' device
  (idempotent)."""
  if getattr(state, "sentinel", None) is not None:
    return state
  return state.replace(sentinel=SentinelState.create(_state_device(state)))


def finite_check(loss, grads=None) -> torch.Tensor:
  """0-d bool tensor: ``loss`` (and every floating leaf of ``grads``,
  when given) is finite.  Stays on the device."""
  from easyparallellibrary_tpu_torch.runtime import amp as amp_lib
  ok = torch.isfinite(torch.as_tensor(loss).float()).all()
  if grads is not None:
    ok = ok & amp_lib.all_finite(grads).to(ok.device)
  return ok


def grads_nonfinite(grads, inv_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
  """0-d float32 tensor, 1.0 when any of ``grads`` (a list of tensors on
  one device) holds an inf or NaN, multiplying every gradient by
  ``inv_scale`` in the same pass (default 1: unchanged) — the
  multi-tensor kernel of torch's GradScaler, not a launch per leaf."""
  grads = [g for g in grads if g is not None]
  device = grads[0].device if grads else None
  found = torch.zeros((), dtype=torch.float32, device=device)
  if grads:
    if inv_scale is None:
      inv_scale = torch.ones((), dtype=torch.float32, device=device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, inv_scale.to(torch.float32))
  return found


def select_state(finite, updated, previous):
  """``updated`` where ``finite`` else ``previous``, leafwise over two
  trees of tensors (dicts / lists / tuples) through ``torch.where`` —
  no host branch.  The port's steps update in place, so callers keep a
  snapshot as ``previous`` (:func:`guard_step`)."""
  if isinstance(updated, dict):
    return {k: select_state(finite, updated[k], previous[k])
            for k in updated}
  if isinstance(updated, (list, tuple)):
    return type(updated)(select_state(finite, a, b)
                         for a, b in zip(updated, previous))
  if isinstance(updated, torch.Tensor) or isinstance(previous, torch.Tensor):
    return torch.where(finite, torch.as_tensor(updated),
                       torch.as_tensor(previous))
  return updated


def sentinel_metrics(sentinel: SentinelState, finite) -> Dict[str, Any]:
  """The guard's metrics, device tensors (no host sync; the metrics
  writer floats them at its flush boundary)."""
  return {"bad_steps": sentinel.bad_consecutive,
          "bad_steps_total": sentinel.bad_total,
          "update_skipped": (~finite).to(torch.float32)}


def _optimizer_tensors(opt: torch.optim.Optimizer, params) -> list:
  """Every tensor of the optimizer's per-parameter state."""
  out = []
  for p in params:
    for value in opt.state.get(p, {}).values():
      if isinstance(value, torch.Tensor):
        if value.device != p.device:
          raise ValueError(
              "guard_step needs the optimizer's step counters on the "
              "parameters' device (a CPU counter would cost a host sync "
              "per step): build the optimizer with fused=True "
              "(TrainState.create(..., fused=True))")
        out.append(value)
  return out


def guard_step(step_fn: Callable) -> Callable:
  """Wrap any ``(state, batch, rng) -> (state, metrics)`` step with the
  anomaly sentinel.

  The wrapper snapshots the parameters, the optimizer state and the
  step count, runs ``step_fn`` (which updates them in place), finite-
  checks the returned loss AND the updated parameters (a NaN gradient
  poisons the parameters it touched), and on a bad step writes the
  snapshot back with ``torch.where`` — all on the device, no host sync.
  The snapshot costs one copy of the parameters and moments a step;
  :func:`runtime.trainer.build_train_step` checks the raw gradients
  before the apply and needs none.  The state must carry sentinel
  counters (:func:`attach_sentinel`).
  """

  def guarded(state, batch, rng):
    if getattr(state, "sentinel", None) is None:
      raise ValueError(
          "guard_step requires sentinel counters in the train state; "
          "wrap it with resilience.attach_sentinel(state) first")
    params = list(state.params.values())
    opt_tensors = _optimizer_tensors(state.opt_state, params)
    snap = [t.detach().clone() for t in params + opt_tensors]
    had_state = {p for p in params if p in state.opt_state.state}
    old_step = state.step.clone() if isinstance(state.step, torch.Tensor) \
        else state.step
    new_state, metrics = step_fn(state, batch, rng)
    finite = finite_check(metrics.get("loss", torch.zeros(())),
                          new_state.params)
    with torch.no_grad():
      live = params + opt_tensors
      for t, kept in zip(live, select_state(finite, live, snap)):
        t.copy_(kept)
      for p in params:
        if p not in had_state and p in new_state.opt_state.state:
          # The step created this parameter's state (the optimizer's
          # first step): a bad first step leaves it at zero.
          for value in new_state.opt_state.state[p].values():
            if isinstance(value, torch.Tensor):
              value.copy_(torch.where(finite, value,
                                      torch.zeros_like(value)))
    # A bad step adds 0 to the old count: no host copy of either count.
    step = (new_state.step - old_step) * finite.to(torch.int32) + old_step
    sentinel = state.sentinel.update(finite)
    out = new_state.replace(step=step, sentinel=sentinel)
    return out, {**metrics, **sentinel_metrics(sentinel, finite)}

  return guarded


# ------------------------------------------------------------- rollback --


def backoff_learning_rate(opt_state, factor: float) -> Tuple[Any, bool]:
  """Scale the optimizer's learning rate by ``factor`` in every parameter
  group (``param_groups[*]["lr"]``; the counterpart of an optax state
  built with ``inject_hyperparams``).  Returns ``(opt_state, applied)``;
  an object without ``param_groups`` is returned unchanged with
  ``applied=False``."""
  groups = getattr(opt_state, "param_groups", None)
  if not groups or any("lr" not in g for g in groups):
    return opt_state, False
  for g in groups:
    lr = g["lr"]
    if isinstance(lr, torch.Tensor):
      lr.mul_(factor)
    else:
      g["lr"] = lr * factor
  return opt_state, True


# ------------------------------------------------------------- watchdog --


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
