"""Engine-level SLO actuator (port of
``easyparallellibrary_tpu/serving/autotune.py``): breaches move the
knobs the stack already has, between steps, never a shape.

The :class:`~easyparallellibrary_tpu_torch.observability.slo.SLOMonitor`
senses (TTFT / ITL / burn-rate rules, ``add_listener``); this module acts
at ENGINE scope (fleet scope is serving/autoscale.py).  An
:class:`EngineAutotuner` subscribes to the monitor and walks a small
ladder of DATA-valued knobs:

========  ============  ==============================================
level     name          knobs applied (all host-side plan data)
========  ============  ==============================================
0         normal        baseline: every clamp released
1         spec_trim     speculation-k clamped to half the drafter's k,
                        floored at 1 (greedy exactness holds)
2         budget_tight  speculation off, per-step prefill budget
                        clamped to ``budget_chunks * prefill_chunk``,
                        admission-ladder floor pinned at spec_off
3         slot_cap      plus effective concurrency clamped to half the
                        batch cap (bounded below by ``min_slots``)
========  ============  ==============================================

Every knob is data the scheduler reads while planning the NEXT step
(``tune_spec_k`` / ``tune_budget`` / ``tune_slot_cap``, scheduler.py;
``floor_level``, resilience.py): the tensors a step is fed keep their
shapes, so an actuation never builds or loads a kernel library (the
compile sentinel stays silent).  On the paged engine the attention
kernel sees the clamps only as plan data: shorter draft runs, fewer
prefill tokens, fewer live slots.

Escalation is immediate on a breach event (one level per breached
step) and continues one level per ``hold_steps`` while a matching stream
STAYS breached (polled through :class:`SLOMonitor.breached_streams`).
Recovery is hysteretic: one level per clean ``hold_steps`` window.  A
STALE breach (a stream wedged "breached" whose records stopped flowing)
stops counting as pressure after ``10 * hold_steps`` event-free steps.

Every actuation is emitted three ways: a ``serving/actuation`` trace
instant (and the ``serving/autotune_level`` counter track), an
``slo_events.jsonl`` line through :meth:`SLOMonitor.note_actuation`, and
the ``autotune_level`` / ``autotune_actuations`` keys of the engine's
per-step registry record.

Pure host policy, unit-testable with a duck-typed engine.  Knobs:
``serving.autotune.*``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Tune-ladder levels, in escalation order (index = level number carried
# by metrics and actuation payloads).
TUNE_LEVELS = ("normal", "spec_trim", "budget_tight", "slot_cap")


class EngineAutotuner:
  """Breach-driven knob ladder for ONE engine (module docstring).

  ``engine`` duck-types :class:`ContinuousBatchingEngine`: the tuner
  reads ``scheduler`` (tune_* fields), ``chunk``, ``_admission``
  (ladder floor), ``_twin_label`` / ``_track_prefix`` (breach
  attribution) and ``registry``/``stats`` presence is irrelevant.
  ``monitor`` may be None (config enabled the tuner but SLO monitoring
  is off) — the tuner then never hears a breach and stays at level 0.

  Threading: breach callbacks may arrive from the watchdog's monitor
  thread (``note_event``), so :meth:`_on_breach` only RECORDS the
  breach under a lock; knobs move exclusively in :meth:`on_step`, which
  the engine calls at the top of each host iteration — strictly between
  fused-step dispatches.
  """

  def __init__(self, engine, monitor, config=None):
    conf = (config if config is not None
            else Env.get().config).serving.autotune
    self.engine = engine
    self.monitor = monitor
    self.hold_steps = conf.hold_steps
    self.max_level = min(conf.max_level, len(TUNE_LEVELS) - 1)
    self.min_slots = conf.min_slots
    self.budget_chunks = conf.budget_chunks
    self.level = 0
    self.actuations = 0
    self.breaches_heard = 0
    sched = engine.scheduler
    self._base_spec_k = sched.spec_k
    self._base_cap = min(sched.num_slots, sched.max_batch)
    # Engine step index of the last actuation OR matching breach — the
    # hold window (recovery AND sustained-pressure escalation) restarts
    # from whichever is later.
    self._hold_from: Optional[int] = None
    # Step of the last sign of LIFE from a matching breach: a breach
    # event, or a breached stream whose record count grew (the monitor
    # only fires events on transitions; slo.BreachPressure owns that
    # invariant).  A breached stream silent past stale_steps is stale,
    # not pressure (docstring).
    self._last_heard_step: Optional[int] = None
    from easyparallellibrary_tpu_torch.observability.slo import BreachPressure
    self._probe = BreachPressure(
        monitor, lambda _rule, key: self._matches({"metric": key}))
    self.stale_steps = 10 * self.hold_steps
    self._lock = threading.Lock()
    self._pending_rule: Optional[str] = None
    if monitor is not None:
      # Weak: the ambient monitor outlives engines; a discarded engine
      # (and its tuner) must stay collectible.
      monitor.add_listener(self._on_breach, weak=True)
    else:
      get_logger().warning(
          "serving.autotune.enabled without observability.slo.enabled: "
          "the autotuner has no breach source and will never actuate")
    get_logger().info(
        "engine autotuner: max level %s, hold %d steps, budget clamp "
        "%d chunk(s), slot floor %d", TUNE_LEVELS[self.max_level],
        self.hold_steps, self.budget_chunks, self.min_slots)

  # ------------------------------------------------------------ matching

  def _matches(self, payload: Dict[str, Any]) -> bool:
    """Does a breach concern THIS engine?  Engine-attributed events
    (watchdog, recompile) carry the twin label; record-rule breaches
    carry the metric key, matched by this engine's namespace prefix.
    Fleet-scope metrics (``serving/fleet/*``) are the autoscaler's to
    act on — one fleet breach must not tighten every healthy replica
    at once (same reasoning as the device-capture listener, engine.py)."""
    twin = payload.get("twin")
    if twin is not None:
      return twin == self.engine._twin_label
    metric = str(payload.get("metric", ""))
    if not metric:
      return False
    prefix = getattr(self.engine, "_track_prefix", "serving")
    # Exclusions FIRST — a bare engine's prefix is "serving", which
    # would otherwise swallow both scopes below:
    if metric.startswith("serving/fleet/"):
      return False                 # fleet scope is the autoscaler's
    if metric.startswith("serving/replica"):
      # A replica-scoped stream concerns exactly the replica it names.
      return prefix != "serving" and metric.startswith(prefix + "/")
    # Own namespace, or the plain serving/* keys a registry-less
    # engine publishes whatever its track prefix.
    return (metric.startswith(prefix + "/")
            or metric.startswith("serving/"))

  def _on_breach(self, rule: str, payload: Dict[str, Any]) -> None:
    if not self._matches(payload):
      return
    with self._lock:
      self.breaches_heard += 1
      self._pending_rule = rule

  # ------------------------------------------------------------- ladder

  def _level_knobs(self, level: int) -> Dict[str, int]:
    """The scheduler/admission clamp values one ladder level means.
    Bounds: spec clamp in [0, k], budget clamp >= one chunk, slot cap
    in [min_slots, base cap]; level 0 releases everything."""
    chunk = self.engine.chunk
    if level <= 0:
      return {"tune_spec_k": -1, "tune_budget": 0, "tune_slot_cap": 0,
              "floor_level": 0}
    if level == 1:
      # Trim, never shut off: floored at 1 so a k=1 drafter keeps its
      # draft at the gentlest level (full spec-off is level 2's job);
      # k=0 (no drafter) keeps the clamp a no-op.
      trimmed = max(1, self._base_spec_k // 2) if self._base_spec_k \
          else 0
      return {"tune_spec_k": trimmed, "tune_budget": 0,
              "tune_slot_cap": 0, "floor_level": 0}
    knobs = {"tune_spec_k": 0,
             "tune_budget": self.budget_chunks * chunk,
             "tune_slot_cap": 0, "floor_level": 1}
    if level >= 3:
      knobs["tune_slot_cap"] = max(self.min_slots, self._base_cap // 2)
    return knobs

  def _pressure(self, step: int) -> bool:
    """Is any matching breach stream STILL breached?  (Module
    docstring: sustained overload never re-fires the transition
    event.)  While the breach is alive (records flowing —
    slo.BreachPressure) ``_last_heard_step`` refreshes, so staleness
    only accrues once a wedged stream's records stop."""
    pressured, fresh = self._probe.poll()
    if fresh:
      self._last_heard_step = step
    return pressured

  def on_step(self, step: int) -> None:
    """One host iteration boundary: escalate on a recorded breach
    event, keep climbing one level per hold window under sustained
    pressure, and release one level per clean hold window.  A few int
    compares on the healthy path."""
    with self._lock:
      rule, self._pending_rule = self._pending_rule, None
    if rule is not None:
      self._last_heard_step = step
      self._hold_from = step
      if self.level < self.max_level:
        self._actuate(self.level + 1, rule, step)
      return
    if self.level == 0 or self._hold_from is None:
      return
    pressured = self._pressure(step)   # may refresh _last_heard_step
    if step - self._hold_from < self.hold_steps:
      return
    stale = (self._last_heard_step is None
             or step - self._last_heard_step >= self.stale_steps)
    if pressured and not stale:
      # The breach never recovered: keep tightening, one level per
      # hold window (or hold at max until it clears).
      self._hold_from = step
      if self.level < self.max_level:
        self._actuate(self.level + 1, "sustained", step)
      return
    self._actuate(self.level - 1, "recovered", step)

  def _actuate(self, new_level: int, rule: str, step: int) -> None:
    old_level, self.level = self.level, new_level
    self._hold_from = step          # recovery hold restarts per move
    sched = self.engine.scheduler
    knobs = self._level_knobs(new_level)
    changes: Dict[str, Any] = {}
    for name in ("tune_spec_k", "tune_budget", "tune_slot_cap"):
      old = getattr(sched, name)
      if old != knobs[name]:
        changes[name] = [old, knobs[name]]
        setattr(sched, name, knobs[name])
    admission = getattr(self.engine, "_admission", None)
    if admission is not None and \
        admission.floor_level != knobs["floor_level"]:
      changes["floor_level"] = [admission.floor_level,
                                knobs["floor_level"]]
      admission.floor_level = knobs["floor_level"]
    self.actuations += 1
    payload = {"actuator": "autotune",
               "twin": self.engine._twin_label,
               "from_level": TUNE_LEVELS[old_level],
               "to_level": TUNE_LEVELS[new_level],
               "rule": rule, "knobs": changes}
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          "serving/actuation", cat="serving", track="serving",
          args={"actuator": "autotune", "rule": rule,
                "from_level": TUNE_LEVELS[old_level],
                "to_level": TUNE_LEVELS[new_level]})
      tracer.counter("serving/autotune_level", new_level)
    if self.monitor is not None:
      self.monitor.note_actuation("autotune", payload, step=step)
    get_logger().warning(
        "autotune: %s -> %s (rule %s, step %d, knobs %s)",
        TUNE_LEVELS[old_level], TUNE_LEVELS[new_level], rule, step,
        changes)
