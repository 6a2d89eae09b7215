"""Serving-side resilience policy: admission control, overload shedding,
degradation, bad-step recovery and replica health (port of
``easyparallellibrary_tpu/serving/resilience.py``, a copy: the module is
pure host policy and the port imports nothing of the JAX package).

* **Admission control & shedding** — :class:`AdmissionController`, a
  bounded admission queue plus a degradation ladder driven by live load
  signals (queue depth, slot occupancy, measured ITL vs its SLO).
  Pressure is answered in cost order: speculation off first, then
  prefill-budget tightening, then shedding new arrivals at submit
  (reason ``"shed"``) — never by corrupting or abandoning admitted work.
* **Bad-step policy** — :class:`BadStepPolicy` tracks per-slot
  consecutive bad device steps (the finiteness verdict the guarded step
  returns; serving/engine.py) and decides retry vs quarantine: a bad
  slot never advanced, so the next plan re-feeds identical work (the
  retry is exact); past ``max_step_retries`` the request is requeued
  with its committed prefix, and past ``max_requeues`` it is failed.
* **Replica health** — :class:`ReplicaHealth`, the state machine and
  circuit breaker a multi-replica router reads (serving/router.py).

No device work, no torch: unit-testable with a fake clock.  Knobs: the
``serving.resilience.*`` config group.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Degradation ladder levels, in escalation order.  The index is the
# level number the engine/metrics carry.
DEGRADE_LEVELS = ("normal", "spec_off", "budget_tight", "shed")

# Replica health states (serving/router.py; docs/serving.md
# "Multi-replica serving").  Only "healthy" receives new dispatch;
# "suspect" keeps its in-flight work but is skipped by routing;
# "down" triggers failover of its queued + in-flight requests;
# "draining" is the admin-initiated rolling-restart state (finish or
# migrate within drain_timeout_s, then rejoin warm).
HEALTH_STATES = ("healthy", "suspect", "down", "draining")


class AdmissionController:
  """Bounded admission queue + graceful-degradation ladder.

  ``queue_limit`` bounds how many requests may wait for a slot; a
  submit that finds the queue full is shed immediately (early
  rejection: the client learns NOW instead of after a hopeless wait).
  Below the hard limit, the ladder degrades service quality in cost
  order as pressure builds:

  ========  ============  ==============================================
  level     name          effect (applied by the engine)
  ========  ============  ==============================================
  0         normal        full service
  1         spec_off      speculation disabled (draft compute freed for
                          committed tokens; exactness unaffected)
  2         budget_tight  per-step prefill budget clamped to one chunk
                          (admission slows, decode cadence protected)
  3         shed          new submits rejected (reason ``"shed"``)
  ========  ============  ==============================================

  Level entry thresholds are queue-depth fractions of ``queue_limit``
  (``degrade_queue_frac`` enters level 1, halfway between it and full
  enters level 2, full enters level 3); an ITL measurement above
  ``itl_slo_s`` forces at least level 1 regardless of queue depth.
  Level 2 additionally requires full slot occupancy — tightening the
  prefill budget while slots sit empty would slow the very admissions
  that drain the queue.  De-escalation is hysteretic: a level is left
  only once the queue has drained below HALF its entry threshold, one
  level per observation, so the ladder cannot flap on a noisy boundary
  — except that ``budget_tight`` is also released the moment occupancy
  drops below full (its entry condition), for the same reason it
  requires full occupancy to enter.  An over-SLO ITL holds the ladder
  at ``spec_off`` or above (it floors the target level at 1) but never
  pins the higher levels.

  ``on_transition(old_level, new_level, signals)`` fires on every
  ladder move (the engine hooks the stats counters in).
  """

  def __init__(self, queue_limit: int = 0, itl_slo_s: float = 0.0,
               degrade_queue_frac: float = 0.5,
               on_transition: Optional[Callable] = None):
    if queue_limit < 0:
      raise ValueError(f"queue_limit must be >= 0 (0 = unbounded): "
                       f"{queue_limit}")
    if not 0.0 < degrade_queue_frac <= 1.0:
      raise ValueError(f"degrade_queue_frac must be in (0, 1]: "
                       f"{degrade_queue_frac}")
    if itl_slo_s < 0:
      raise ValueError(f"itl_slo_s must be >= 0 (0 = off): {itl_slo_s}")
    self.queue_limit = queue_limit
    self.itl_slo_s = itl_slo_s
    self.degrade_queue_frac = degrade_queue_frac
    self.on_transition = on_transition
    self.level = 0
    # External de-escalation floor (the autotuner's ladder-floor knob,
    # serving/autotune.py): while set, the ladder never drops below it
    # — an SLO actuator can pin "at least spec_off" through a breach
    # window without re-deriving the queue signals.  0 = no floor.
    self.floor_level = 0
    self.transitions = 0
    self.shed_total = 0

  # --------------------------------------------------------------- levels

  def _enter_frac(self, level: int) -> float:
    """Queue-depth fraction at which `level` is entered."""
    if level >= 3:
      return 1.0
    if level == 2:
      return (1.0 + self.degrade_queue_frac) / 2.0
    return self.degrade_queue_frac

  def _target_level(self, queue_frac: float, occupancy: float,
                    itl_over: bool) -> int:
    level = 0
    if self.queue_limit > 0:
      if queue_frac >= self._enter_frac(3):
        level = 3
      elif queue_frac >= self._enter_frac(2) and occupancy >= 1.0:
        level = 2
      elif queue_frac >= self._enter_frac(1):
        level = 1
    if itl_over:
      level = max(level, 1)
    return max(level, min(self.floor_level, 3))

  def observe(self, queue_depth: int, occupancy: float,
              itl_s: float = 0.0) -> int:
    """Feed one engine iteration's load signals; returns the (possibly
    new) degradation level.  Escalation is immediate; de-escalation one
    level per call, and only once pressure is well clear (docstring)."""
    queue_frac = (queue_depth / self.queue_limit
                  if self.queue_limit > 0 else 0.0)
    itl_over = bool(self.itl_slo_s > 0 and itl_s > self.itl_slo_s)
    target = self._target_level(queue_frac, occupancy, itl_over)
    new = self.level
    if target > self.level:
      new = target
    elif target < self.level:
      clear = queue_frac < 0.5 * self._enter_frac(self.level)
      if self.level == 2 and occupancy < 1.0:
        # budget_tight's entry condition includes full occupancy; once
        # slots sit free the clamp only slows the admissions that drain
        # the queue, so its release does not wait for queue hysteresis.
        clear = True
      # No extra ITL gate here: an over-SLO ITL floors `target` at 1
      # (so the ladder never drops below spec_off while it holds), but
      # it must not pin levels 2-3 — a stale EWMA on a drained engine
      # (ITL only refreshes on decode steps, which a fully-shedding
      # engine never runs) would otherwise hold the shed level forever.
      if clear:
        new = self.level - 1
    if new != self.level:
      old, self.level = self.level, new
      self.transitions += 1
      get_logger().info(
          "serving degradation: %s -> %s (queue %d/%s, occupancy %.2f, "
          "itl %.4fs vs slo %.4fs)", DEGRADE_LEVELS[old],
          DEGRADE_LEVELS[new], queue_depth, self.queue_limit or "inf",
          occupancy, itl_s, self.itl_slo_s)
      if self.on_transition is not None:
        self.on_transition(old, new, {
            "queue_depth": int(queue_depth),
            "occupancy": float(occupancy), "itl_s": float(itl_s)})
    return self.level

  # ------------------------------------------------------------ admission

  def should_shed(self, queue_depth: int) -> bool:
    """Submit-time verdict: shed when the bounded queue is full or the
    ladder has reached its shed level.  Pure predicate — safe to poll
    for introspection; the caller that actually sheds a request
    records it via :meth:`note_shed`."""
    if self.queue_limit > 0 and queue_depth >= self.queue_limit:
      return True
    return self.level >= 3

  def note_shed(self):
    """Count one actually-shed request (the engine's shed path calls
    this after acting on a True :meth:`should_shed` verdict)."""
    self.shed_total += 1

  @property
  def speculation_enabled(self) -> bool:
    return self.level < 1

  @property
  def budget_tightened(self) -> bool:
    return self.level >= 2


class BadStepPolicy:
  """Retry-then-quarantine policy over per-slot bad-step streaks.

  The guarded fused step (engine.py) returns a per-slot finiteness
  verdict; a bad slot's cursor and host state never advanced, so simply
  replanning retries it exactly.  This class only decides WHEN to stop
  retrying: a slot whose streak exceeds ``max_step_retries`` is
  quarantined (requeue with committed prefix — a fresh slot's replay
  rewrites any poisoned K/V), and a request requeued more than
  ``max_requeues`` times is failed.
  """

  RETRY, REQUEUE, FAIL = "retry", "requeue", "fail"

  def __init__(self, max_step_retries: int = 1, max_requeues: int = 1):
    if max_step_retries < 0 or max_requeues < 0:
      raise ValueError("max_step_retries and max_requeues must be >= 0")
    self.max_step_retries = max_step_retries
    self.max_requeues = max_requeues
    self.bad_steps = 0        # engine steps with >= 1 bad slot
    self.step_retries = 0     # slot-steps replayed in place
    self.requeues = 0
    self.failures = 0

  def judge(self, slot_states: Dict[int, "object"],
            bad_slots: List[int],
            exercised: Optional[set] = None) -> Dict[int, str]:
    """Update streaks for one engine step and return the action per bad
    slot (``retry`` | ``requeue`` | ``fail``).  ``slot_states`` is the
    scheduler's ``active`` map (entries carry ``bad_streak`` and
    ``requeues``); good slots' streaks reset here — but only slots the
    step actually EXERCISED (``exercised``, the plan's num_valid>0 set;
    None = all): a budget-starved slot proved nothing this step, and
    resetting its streak would re-grant a poisoned slot its full retry
    allowance on every starvation interleave, postponing quarantine
    indefinitely."""
    if bad_slots:
      self.bad_steps += 1
    actions: Dict[int, str] = {}
    bad = set(bad_slots)
    for slot, state in slot_states.items():
      if slot not in bad:
        if exercised is None or slot in exercised:
          state.bad_streak = 0
        continue
      state.bad_streak += 1
      if state.bad_streak <= self.max_step_retries:
        self.step_retries += 1
        actions[slot] = self.RETRY
      elif state.requeues < self.max_requeues:
        self.requeues += 1
        actions[slot] = self.REQUEUE
      else:
        self.failures += 1
        actions[slot] = self.FAIL
    return actions

  def counters(self) -> Dict[str, int]:
    return {"bad_steps": self.bad_steps,
            "step_retries": self.step_retries,
            "requeues": self.requeues,
            "failed_requests": self.failures}


class ReplicaHealth:
  """Health state machine + circuit breaker for ONE serving replica.

  The router feeds two signal kinds and reads one state back:

  * :meth:`beat` — the replica's step loop calls it after every
    COMPLETED engine step, carrying the live signals the step already
    has on the host (the StepWatchdog's timeout count, the BadStepPolicy
    streak counters, the measured ITL EWMA).  A beat is the heartbeat;
    its arguments decide whether it is a *clean* one.
  * :meth:`observe` — the router polls it each scheduling round.
    Heartbeat age drives the passive half of the machine: a replica
    silent past ``suspect_after`` seconds is ``suspect`` (no new
    dispatch; its in-flight work keeps running), past ``down_after`` it
    is ``down`` (failover).  A beat carrying a watchdog timeout or an
    over-SLO ITL also marks the replica suspect — it answered, but too
    slowly to trust with new latency-sensitive work.
  * :meth:`mark_down` — the active half: the router calls it when a
    replica's step RAISES (the thread/process died mid-decode).

  Recovery goes through the **circuit breaker**: every trip to ``down``
  counts, and :meth:`can_probe` only opens after a cooldown that
  doubles per trip (capped), so a flapping replica — one that dies,
  rejoins clean, and dies again — is held out exponentially longer each
  round instead of bouncing traffic.  :meth:`rejoin` closes the breaker
  half-open: the replica is routable again, but its next ``mark_down``
  doubles the hold-out rather than restarting the ladder.

  ``drain()`` / ``rejoin()`` implement the rolling-restart path: a
  draining replica is unroutable but healthy; rejoin resumes admission
  warm (the engine and its compiled step were never torn down).

  Pure host policy — injectable ``clock``, no device work,
  unit-testable with a fake clock like the ladder above.
  ``on_transition(old, new, reason)`` fires on every state change (the
  router hooks tracer instants in).
  """

  def __init__(self, suspect_after: float = 3.0, down_after: float = 10.0,
               heartbeat_s: float = 1.0, itl_slo_s: float = 0.0,
               clock: Callable[[], float] = time.monotonic,
               on_transition: Optional[Callable] = None):
    if not 0 < suspect_after <= down_after:
      raise ValueError(
          f"need 0 < suspect_after <= down_after; got "
          f"suspect_after={suspect_after}, down_after={down_after}")
    if heartbeat_s <= 0:
      raise ValueError(f"heartbeat_s must be > 0: {heartbeat_s}")
    self.suspect_after = suspect_after
    self.down_after = down_after
    self.heartbeat_s = heartbeat_s
    self.itl_slo_s = itl_slo_s
    self.clock = clock
    self.on_transition = on_transition
    self.state = "healthy"
    self.last_beat = clock()
    self.last_clean_beat = self.last_beat
    self.trips = 0              # healthy->down round trips (breaker)
    self.transitions = 0
    self.down_reason = ""
    self._down_since = 0.0
    # Cumulative-counter watermarks: beats carry the stats objects'
    # running totals, and only an INCREASE is a fresh incident — an old
    # timeout must not keep every later beat dirty forever.
    self._last_bad_steps = 0
    self._last_watchdog = 0

  # --------------------------------------------------------------- signals

  def _set_state(self, new: str, reason: str = ""):
    if new == self.state:
      return
    old, self.state = self.state, new
    self.transitions += 1
    if new == "down":
      self.trips += 1
      self._down_since = self.clock()
      self.down_reason = reason
    get_logger().warning(
        "replica health: %s -> %s%s", old, new,
        f" ({reason})" if reason else "")
    if self.on_transition is not None:
      self.on_transition(old, new, reason)

  def beat(self, watchdog_timeouts: int = 0, bad_steps: int = 0,
           itl_s: float = 0.0) -> None:
    """One completed engine step.  ``watchdog_timeouts`` / ``bad_steps``
    are CUMULATIVE counters (the stats objects already hold them);
    deltas are computed here.  A down/draining replica's beats are
    recorded (staleness clears) but never auto-promote — recovery from
    ``down`` goes through :meth:`rejoin`, and ``draining`` is admin
    state."""
    now = self.clock()
    self.last_beat = now
    hung = watchdog_timeouts > self._last_watchdog
    bad = bad_steps > self._last_bad_steps
    self._last_watchdog = max(self._last_watchdog, watchdog_timeouts)
    self._last_bad_steps = max(self._last_bad_steps, bad_steps)
    slow = self.itl_slo_s > 0 and itl_s > self.itl_slo_s
    if hung or bad or slow:
      if self.state == "healthy":
        self._set_state(
            "suspect",
            "watchdog timeout" if hung else
            ("bad device step" if bad else "ITL over SLO"))
      return
    self.last_clean_beat = now
    if self.state == "suspect":
      self._set_state("healthy", "clean beat")

  def beat_from_wire(self, beat: Dict[str, "object"]) -> None:
    """Ingest a transport heartbeat (serving/transport.py): process
    replicas piggyback their watchdog/bad-step WATERMARKS, the ITL EWMA
    and load signals on every RPC reply, and the router feeds the
    health half here.  Same cumulative-counter semantics as
    :meth:`beat` — the dict is just the wire spelling of the in-process
    signals, so the state machine cannot tell (and must not care)
    which side of a process boundary the replica lives on."""
    self.beat(
        watchdog_timeouts=int(beat.get("watchdog_timeouts", 0) or 0),
        bad_steps=int(beat.get("bad_steps", 0) or 0),
        itl_s=float(beat.get("itl_ewma_s", 0.0) or 0.0))

  def touch(self, now: Optional[float] = None) -> None:
    """Reset the heartbeat clock WITHOUT a step.  The router calls this
    for an IDLE replica at dispatch time: an idle replica's loop is not
    running, so absence of beats is not evidence of death — only a
    replica that owes work can go stale.  (Without this, a healthy
    fleet quiet for ``suspect_after`` seconds would shed its first
    request after every lull.)  No state transitions: a suspect set by
    a dirty beat still needs a CLEAN beat to clear."""
    if self.state in ("down", "draining"):
      return
    self.last_beat = self.clock() if now is None else now

  def observe(self, now: Optional[float] = None) -> str:
    """Heartbeat-staleness check; returns the (possibly new) state.
    Draining and down are sticky — staleness never demotes an admin
    state, and only :meth:`rejoin` recovers a down replica."""
    now = self.clock() if now is None else now
    if self.state in ("down", "draining"):
      return self.state
    age = now - self.last_beat
    if age >= self.down_after:
      self._set_state("down", f"no heartbeat for {age:.2f}s")
    elif age >= self.suspect_after and self.state == "healthy":
      self._set_state("suspect", f"heartbeat stale ({age:.2f}s)")
    return self.state

  def mark_down(self, reason: str = "step raised") -> None:
    """Active failure report (the replica's step raised / its host died).
    Trips the breaker immediately."""
    self._set_state("down", reason)

  # ------------------------------------------------------------- lifecycle

  def drain(self) -> None:
    """Admin drain: unroutable, but not a failure — no breaker trip."""
    if self.state != "down":
      self._set_state("draining", "drain requested")

  def cooldown_s(self) -> float:
    """Current breaker hold-out: ``down_after`` doubled per trip, capped
    at 2^6 — a flapping replica waits exponentially longer each round."""
    return self.down_after * (2 ** min(max(self.trips - 1, 0), 6))

  def can_probe(self, now: Optional[float] = None) -> bool:
    """True once a down replica's breaker cooldown has elapsed — the
    router may then :meth:`rejoin` it as a half-open probe."""
    if self.state != "down":
      return False
    now = self.clock() if now is None else now
    return now - self._down_since >= self.cooldown_s()

  def rejoin(self, force: bool = False) -> bool:
    """Return the replica to service (rolling-restart rejoin, or a
    breaker probe).  A down replica rejoins only once :meth:`can_probe`
    allows it (``force=True`` overrides — the operator knows best);
    returns False when the breaker refuses.  The trip count is KEPT —
    a relapse doubles the next hold-out (that is the breaker's whole
    point); it decays only via :meth:`note_stable`."""
    if self.state == "down" and not (force or self.can_probe()):
      return False
    self.last_beat = self.clock()   # fresh grace period, not instant-stale
    self._set_state("healthy", "rejoin")
    return True

  def probe_failed(self, reason: str = "") -> None:
    """A half-open probe could not even START the replica (e.g. a
    process transport's respawn failed).  Re-arm the breaker as if the
    replica had relapsed — trip count up, cooldown window restarted —
    so a host that cannot spawn is backed off exponentially instead of
    spawn-stormed every sweep."""
    if self.state != "down":
      return
    self.trips += 1
    self._down_since = self.clock()
    if reason:
      self.down_reason = reason
    get_logger().warning(
        "replica probe failed%s: breaker re-armed (trip %d, hold-out "
        "%.1fs)", f" ({reason})" if reason else "", self.trips,
        self.cooldown_s())

  def note_stable(self) -> None:
    """Forgive one breaker trip (the router calls this after a rejoined
    replica survives a full cooldown window without incident, so an
    ancient flap does not tax a now-healthy replica forever)."""
    self.trips = max(0, self.trips - 1)

  @property
  def routable(self) -> bool:
    return self.state == "healthy"

  def signals_stale(self, now: Optional[float] = None) -> bool:
    """Load signals older than two heartbeats cannot be trusted for
    least-loaded ranking — dispatch degrades to round-robin."""
    now = self.clock() if now is None else now
    return now - self.last_beat > 2.0 * self.heartbeat_s
