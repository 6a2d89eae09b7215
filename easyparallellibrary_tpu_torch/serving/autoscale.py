"""Fleet-level SLO actuator: burn-rate breaches resize the live
replica set through the router's existing levers (port of
``easyparallellibrary_tpu/serving/autoscale.py``).

The serving stack already owns every mechanism this policy needs:
graceful :meth:`Router.drain` / warm :meth:`Router.rejoin`, the build
path behind :meth:`Router.add_replica` (a child's spawn on the process
transport, an engine on the card in process), and the
:class:`~easyparallellibrary_tpu_torch.observability.slo.SLOMonitor`'s
burn-rate rules that already prove a breach is sustained (fast AND slow
window).  This module is only the policy that connects them:

* **grow** — on a sustained SLO burn (any :class:`BurnRateRule` breach,
  plus any rule named in ``serving.autoscale.rules``), add one replica:
  a replica the autoscaler ITSELF previously drained rejoins WARM
  (engine and cache intact — the cheapest capacity in the
  fleet; an OPERATOR-drained replica is maintenance in progress and is
  never silently reverted), else a new replica is built cold
  OFF-THREAD: :meth:`Router.build_replica` (the subprocess spawn and
  the child's engine build on the process transport) runs on a background
  spawner thread while the sweep keeps serving, and the finished
  replica is adopted (:meth:`Router.adopt_replica` — appended,
  health-tracked, parked backlog flushed) at the next sweep boundary.
  The replica is UNROUTABLE until adopted (it simply is not in the
  fleet yet), at most one spawn is in flight (further grow impulses
  hold), and a failed spawn counts a ``spawn_failures`` — never a flap
  (a flap trip requires a grow that LANDED).  Fleets without a build
  recipe (injected test replicas) fall back to the synchronous
  :meth:`Router.add_replica` lever;
* **shrink** — once the error budget has recovered (no relevant breach
  for ``scale_down_cooldown_s``), gracefully :meth:`drain` the
  youngest-added live replica back out, never below ``min_replicas``;
* **flap breaker** — a scale-up that lands inside ``flap_window_s`` of
  a scale-down is a flap: each trip DOUBLES the scale-up hold-out
  (capped at 2^6, decaying one trip per clean window) — the same
  doubling-hold-out shape as the replica circuit breaker, so an
  oscillating load curve converges to a steady set instead of paying a
  cold spawn per wave.

Actuations move only the replica SET — never a live engine's geometry —
so every stream stays bit-exact and no kernel library is built or loaded
by an actuation (a cold child loads its own once, like any restart).
Each action emits a ``serving/actuation`` trace instant, an
``slo_events.jsonl`` line (:meth:`SLOMonitor.note_actuation`), and the
``scale_ups`` / ``scale_downs`` / ``autoscale_holds`` / ``flap_trips``
counters on the ``serving/fleet/*`` rollup (published immediately, not
on the heartbeat cadence — an actuation opens its evidence window at
the action).

Pure host policy — injectable clock (the router's); unit tests drive it
with fake replicas and a fake clock.  Knobs: ``serving.autoscale.*``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Flap hold-out doubling cap: 2^6 (mirrors ReplicaHealth.cooldown_s).
_MAX_FLAP_DOUBLINGS = 6


class FleetAutoscaler:
  """SLO-burn-driven replica-set policy for one Router (module
  docstring).  Built by the router when ``serving.autoscale.enabled``;
  the router calls :meth:`on_step` at the top of every fleet sweep —
  replica-list mutation is only safe between sweeps.

  Threading mirrors the autotuner: breach callbacks may arrive from a
  watchdog thread, so the listener only RECORDS under a lock and every
  action happens in :meth:`on_step` on the router's thread.
  """

  def __init__(self, router, config=None):
    conf = (config if config is not None
            else Env.get().config).serving.autoscale
    self.router = router
    self.clock = router.clock
    self.min_replicas = conf.min_replicas
    self.max_replicas = conf.max_replicas
    self.scale_up_cooldown_s = conf.scale_up_cooldown_s
    self.scale_down_cooldown_s = conf.scale_down_cooldown_s
    self.flap_window_s = conf.flap_window_s
    self._rules = set(conf.rules)
    # Deterministic spawn lever (replay/simulation): grow replicas
    # synchronously inside on_step instead of on the spawner thread.
    self.sync_spawn = conf.sync_spawn
    # Predictive scale-up (config comment): differentiate the router's
    # cumulative submit counter over a sliding window and grow when the
    # arrival-rate SLOPE says the burn is coming — before the burn-rate
    # rule can have breached.  slope <= 0 disables the rule.
    self.predictive_window_s = conf.predictive_window_s
    self.predictive_slope = conf.predictive_slope
    self._demand_samples: Deque[Tuple[float, int]] = deque()
    self.predictive_fires = 0
    # First landed grow of this policy's lifetime: the time-to-react
    # evidence that compares predictive with reactive scaling.
    self.first_scale_up_t: Optional[float] = None
    self.scale_ups = 0
    self.scale_downs = 0
    self.holds = 0              # actions suppressed by cooldown/hold-out
    self.flap_trips = 0
    self.spawn_failures = 0
    # Replica indices this policy currently OWNS (spawned or rejoined
    # into service); shrink only ever drains from this set, and a
    # drain moves the entry to _parked (eligible for warm rejoin) —
    # the operator's base fleet is never the autoscaler's to take
    # below its provisioned size, and an OPERATOR-drained replica is
    # never its rejoin target.
    self._added: List[int] = []
    self._parked: List[int] = []
    self._last_up_t: Optional[float] = None
    self._last_down_t: Optional[float] = None
    self._flap_decay_t: Optional[float] = None
    self._lock = threading.Lock()
    self._pending_rule: Optional[str] = None
    self._last_breach_t: Optional[float] = None
    # Off-thread cold spawn (module docstring): at most one in flight;
    # a single LONG-LIVED daemon spawner thread serves build requests
    # and posts outcomes here for the router thread to adopt (or book
    # the failure) at the next on_step.  The thread must outlive every
    # child it spawns: Linux delivers PR_SET_PDEATHSIG when the thread
    # that forked the child EXITS, so a short-lived per-spawn thread
    # would SIGKILL its own replica the moment it finished — and a
    # daemon thread dying only at process exit turns that same signal
    # into exactly the orphan reaping the transport wants.
    self._spawn_thread: Optional[threading.Thread] = None
    self._spawn_queue = None
    self._spawn_busy = False
    self._spawn_outcome: Optional[tuple] = None
    # External hold (serving/rollout.py): while a blue/green rollout is
    # in flight the replica set belongs to the rollout controller —
    # autoscale grow/shrink during a canary would change the capacity
    # the canary's SLO evidence is judging.  In-flight spawn outcomes
    # still LAND while held (a child process must be adopted or
    # reaped), but no new action starts.
    self._hold_reason: Optional[str] = None
    monitor = router._slo
    from easyparallellibrary_tpu_torch.observability.slo import BreachPressure
    self._probe = BreachPressure(
        monitor, lambda rule, _key: rule in self._relevant_rules())
    if monitor is not None:
      monitor.add_listener(self._on_breach, weak=True)
    else:
      get_logger().warning(
          "serving.autoscale.enabled without observability.slo.enabled: "
          "the autoscaler has no burn signal and will never actuate")
    if len(router.replicas) >= self.max_replicas:
      get_logger().warning(
          "serving.autoscale.max_replicas (%d) <= current fleet size "
          "(%d): every scale-up will be held — raise max_replicas if "
          "the fleet should grow under burn", self.max_replicas,
          len(router.replicas))
    get_logger().info(
        "fleet autoscaler: %d..%d replicas, up/down cooldown "
        "%.1fs/%.1fs, flap window %.1fs, extra rules %s",
        self.min_replicas, self.max_replicas, self.scale_up_cooldown_s,
        self.scale_down_cooldown_s, self.flap_window_s,
        sorted(self._rules) or "(burn rules only)")

  # ----------------------------------------------------------- listening

  def _on_breach(self, rule: str, payload: Dict[str, Any]) -> None:
    """Record a relevant breach.  Burn-rate breaches (payload carries
    the window burns) always qualify — the rule itself proved the burn
    is sustained across fast AND slow windows; threshold rules only
    when named in ``serving.autoscale.rules``."""
    if "fast_burn" not in payload and rule not in self._rules:
      return
    with self._lock:
      self._pending_rule = rule
      self._last_breach_t = self.clock()

  # ------------------------------------------------------------- policy

  def _live(self) -> List[int]:
    """Replica indices serving or able to serve (healthy + suspect);
    draining and down replicas are capacity already removed."""
    return [i for i, h in enumerate(self.router.health)
            if h.state in ("healthy", "suspect")]

  def _relevant_rules(self) -> set:
    monitor = self.router._slo
    if monitor is None:
      return set(self._rules)
    from easyparallellibrary_tpu_torch.observability.slo import BurnRateRule
    return ({r.name for r in monitor.rules
             if isinstance(r, BurnRateRule)} | self._rules)

  def _pressure(self) -> bool:
    """Is any relevant breach stream STILL breached?  A breach event
    fires only on the transition; an overload one replica-add did not
    absorb looks like a burn stream that never recovers, so sustained
    pressure is polled (slo.BreachPressure owns the liveness
    invariant).  While the breach is alive ``_last_breach_t``
    refreshes, so the quiet-window gates below never read a live burn
    as recovered; a wedged stream whose records stopped flowing lets
    the timestamp age out."""
    pressured, fresh = self._probe.poll()
    if fresh:
      with self._lock:
        self._last_breach_t = self.clock()
    return pressured

  def _demand_slope(self, now: float) -> Optional[float]:
    """Sample the router's cumulative demand counter and estimate the
    arrival-rate slope (requests/s per second) over the sliding window:
    the late-half rate minus the early-half rate, over half the span.
    Returns None while the rule is off, the window has not filled yet
    (startup must never read as a ramp), or the halves are degenerate.
    Two-half differencing instead of least squares on purpose: it is
    O(1) per sweep, exactly reproducible, and a steady Poisson stream's
    halves agree in expectation — slope ~ 0, so fault-free traffic
    cannot fire the rule."""
    if self.predictive_slope <= 0:
      return None
    count = getattr(self.router, "submitted_total", None)
    if count is None:
      return None
    samples = self._demand_samples
    samples.append((now, int(count)))
    cutoff = now - self.predictive_window_s
    # Keep s[0] as the newest sample at-or-before the cutoff so the
    # retained span always covers the full window.
    while len(samples) >= 2 and samples[1][0] <= cutoff:
      samples.popleft()
    t0, c0 = samples[0]
    span = now - t0
    if span < self.predictive_window_s * 0.95:
      return None
    mid = now - span / 2.0
    tp, cp = min(samples, key=lambda tc: abs(tc[0] - mid))
    if not t0 < tp < now:
      return None
    early = (cp - c0) / (tp - t0)
    late = (count - cp) / (now - tp)
    return (late - early) / (span / 2.0)

  @property
  def spawn_in_flight(self) -> bool:
    """True while an off-thread cold spawn is running or its outcome
    has not yet been landed by :meth:`on_step` — drivers that want the
    scale-up to complete keep sweeping (idle sweeps are heartbeats)
    while this holds."""
    with self._lock:
      return self._spawn_busy or self._spawn_outcome is not None

  def hold(self, reason: str) -> None:
    """Suspend autoscaling actions (init comment on ``_hold_reason``):
    breaches keep being recorded and in-flight spawns still land, but
    no grow/shrink starts until :meth:`release`.  Idempotent."""
    if self._hold_reason is None:
      get_logger().info("autoscale: held (%s)", reason)
    self._hold_reason = reason

  def release(self) -> None:
    """Lift a :meth:`hold`.  Idempotent."""
    if self._hold_reason is not None:
      get_logger().info("autoscale: released (was held: %s)",
                        self._hold_reason)
    self._hold_reason = None

  @property
  def held(self) -> bool:
    return self._hold_reason is not None

  def scale_up_holdout_s(self) -> float:
    """Current scale-up hold-out: the base cooldown doubled per flap
    trip (capped) — the replica breaker's shape applied to capacity."""
    return self.scale_up_cooldown_s * (
        2 ** min(self.flap_trips, _MAX_FLAP_DOUBLINGS))

  def on_step(self, now: Optional[float] = None) -> None:
    """One fleet-sweep boundary: land any finished off-thread spawn,
    then act on a recorded breach (grow) or on a recovered budget
    (shrink), honoring bounds/cooldowns/hold-outs."""
    now = self.clock() if now is None else now
    # Demand sampling runs every sweep — held or not — so the slope
    # estimate never has a hole exactly where the interesting window is.
    slope = self._demand_slope(now)
    with self._lock:
      outcome, self._spawn_outcome = self._spawn_outcome, None
    if outcome is not None:
      self._finish_spawn(outcome, now)
    if self._parked:
      # A parked claim is valid only while the drain THIS policy
      # started is still in effect: the moment a parked replica leaves
      # "draining" through any other path (an operator rejoined it,
      # or it died), the claim is void — otherwise a LATER operator
      # maintenance drain of the same index would read as ours and a
      # breach could silently revert it.
      self._parked = [i for i in self._parked
                      if self.router.health[i].state == "draining"]
    if self._hold_reason is not None:
      # Held (rollout in flight): the breach event is consumed as a
      # hold — a burn that OUTLIVES the hold re-fires through the
      # sustained-pressure poll once released, so no real overload is
      # lost, only the stale event.
      with self._lock:
        pending, self._pending_rule = self._pending_rule, None
      if pending is not None:
        self.holds += 1
      return
    with self._lock:
      rule, self._pending_rule = self._pending_rule, None
    if rule is not None:
      self._maybe_scale_up(rule, now)
      return
    if (slope is not None and slope >= self.predictive_slope
        and len(self._live()) < self.max_replicas
        and (self._last_up_t is None
             or now - self._last_up_t >= self.scale_up_holdout_s())):
      # Arrival-rate slope says the burn is COMING: grow now, while the
      # spawn still lands before the queue does.  Pre-gated (like the
      # sustained path) so a high slope inside the hold-out window does
      # not spin the holds counter every sweep.
      self.predictive_fires += 1
      self._maybe_scale_up("predictive", now)
      return
    # _pressure() refreshes _last_breach_t while the breached streams'
    # records keep flowing — a live sustained burn keeps the quiet
    # window open; a wedged-silent stream lets it close (stale escape).
    pressured = self._pressure()
    with self._lock:
      last_breach_t = self._last_breach_t
    if (pressured and last_breach_t is not None
        and now - last_breach_t < self.scale_down_cooldown_s):
      # Sustained burn one add did not absorb: keep growing, one
      # replica per hold-out window (the checks here pre-gate so the
      # holds counter only counts suppressed breach EVENTS).
      if (len(self._live()) < self.max_replicas
          and (self._last_up_t is None
               or now - self._last_up_t >= self.scale_up_holdout_s())):
        self._maybe_scale_up("sustained", now)
      return
    # Flap-trip decay: a full clean window without any scaling action
    # forgives one trip (ReplicaHealth.note_stable's analogue).
    if self.flap_trips:
      quiet = max(self._last_up_t or 0.0, self._last_down_t or 0.0,
                  self._flap_decay_t or 0.0)
      if now - quiet >= self.flap_window_s:
        self.flap_trips -= 1
        self._flap_decay_t = now   # one forgiveness per clean window
    if not self._added or last_breach_t is None:
      # Nothing autoscaler-owned in service: the operator's base set
      # is never drained — min_replicas is a floor, not a target.
      return
    quiet_since = max(
        last_breach_t, self._last_up_t or 0.0, self._last_down_t or 0.0)
    if now - quiet_since >= self.scale_down_cooldown_s:
      self._maybe_scale_down(now)

  def _maybe_scale_up(self, rule: str, now: float) -> None:
    with self._lock:
      spawning = self._spawn_busy or self._spawn_outcome is not None
    if spawning:
      # One capacity action in flight: further grow impulses hold until
      # the spawner thread's outcome lands at a sweep boundary.
      self.holds += 1
      return
    live = self._live()
    if len(live) >= self.max_replicas:
      self.holds += 1
      return
    if (self._last_up_t is not None
        and now - self._last_up_t < self.scale_up_holdout_s()):
      self.holds += 1
      return
    router = self.router
    # Cheapest capacity first: a replica THIS policy drained rejoins
    # WARM.  Operator-drained replicas are maintenance in progress —
    # reverting one on a breach would silently undo a rolling restart.
    parked = [i for i in self._parked
              if router.health[i].state == "draining"]
    if parked:
      index = parked[-1]
      if not router.rejoin(index):
        self.holds += 1
        return
      self._parked.remove(index)
      self._land_grow(index, "rejoin", rule, now)
      return
    if (not self.sync_spawn
        and getattr(router, "spawn_recipe_available", False)):
      # Cold spawn OFF the sweep thread: the build (a child's spawn, or
      # an engine's weight copy onto the card) can take
      # seconds, and a synchronous add would stall every live replica
      # for exactly the window the fleet is overloaded.  The new
      # replica is unroutable until adoption lands it at a later
      # sweep.
      self._start_spawn(rule)
      return
    # No build recipe (injected test fleets), or sync_spawn pinned for
    # replay determinism: the synchronous operator lever is the grow
    # path.
    try:
      index = router.add_replica()
    except Exception as e:  # noqa: BLE001 — a failed spawn must not
      self.spawn_failures += 1          # take the control plane down
      get_logger().error(
          "autoscale: replica spawn failed (%s: %s); holding",
          type(e).__name__, e)
      # Stamp AFTER the failed attempt (same rule as the success
      # path): a spawn that blocked until spawn_timeout_s must buy a
      # full cooldown of actual serving before the retry, not an
      # immediate back-to-back doomed attempt.
      self._last_up_t = self.clock()
      return
    self._land_grow(index, "spawn", rule, now)

  def _start_spawn(self, rule: str) -> None:
    """Queue the cold spawn onto the persistent daemon spawner thread
    (init comment on ``_spawn_thread``: the forking thread must outlive
    the child, or PDEATHSIG kills the fresh replica the moment the
    thread exits).  The thread only calls :meth:`Router.build_replica`
    (recipe reads + the subprocess spawn — no router-list mutation) and
    posts the outcome for :meth:`on_step` to land on the router's
    thread."""
    import queue
    with self._lock:
      if self._spawn_thread is None or not self._spawn_thread.is_alive():
        self._spawn_queue = queue.Queue()
        self._spawn_thread = threading.Thread(
            target=self._spawner_loop, name="epl-autoscale-spawner",
            daemon=True)
        self._spawn_thread.start()
      self._spawn_busy = True
    self._spawn_queue.put(rule)
    get_logger().info(
        "autoscale: cold replica spawn started off-thread (rule %s); "
        "fleet keeps sweeping, replica unroutable until ready", rule)

  def _spawner_loop(self) -> None:
    while True:
      rule = self._spawn_queue.get()
      if rule is None:
        return                        # close(): the thread lets go
      try:
        rep, err = self.router.build_replica(), None
      except Exception as e:  # noqa: BLE001 — posted, booked on_step
        rep, err = None, e
      with self._lock:
        self._spawn_outcome = (rep, err, rule)
        self._spawn_busy = False

  def close(self) -> None:
    """Stop the spawner thread (it holds this policy, and so the router
    and its engines, for as long as it runs).  Router.close() calls it;
    a spawn in flight finishes first.  Idempotent."""
    with self._lock:
      thread, queue_ = self._spawn_thread, self._spawn_queue
      self._spawn_thread = None
    if thread is not None and thread.is_alive():
      queue_.put(None)

  def _finish_spawn(self, outcome, now: float) -> None:
    rep, err, rule = outcome
    if err is not None:
      # A failed spawn is booked exactly like the synchronous path:
      # counted, cooled down — and NEVER a flap (no grow landed).
      self.spawn_failures += 1
      get_logger().error(
          "autoscale: off-thread replica spawn failed (%s: %s); holding",
          type(err).__name__, err)
      self._last_up_t = self.clock()
      return
    index = self.router.adopt_replica(rep)
    self._land_grow(index, "spawn", rule, now)

  def _land_grow(self, index: int, action: str, rule: str,
                 now: float) -> None:
    """Book one grow that LANDED (warm rejoin, sync spawn, or adopted
    off-thread spawn): ownership, flap accounting, cooldown stamp,
    emission."""
    if index not in self._added:
      # Autoscaler-owned capacity (spawned OR rejoined into service):
      # exactly the set shrink may later drain back out.
      self._added.append(index)
    if (self._last_down_t is not None
        and now - self._last_down_t < self.flap_window_s):
      # Growing right after shrinking — and only when the grow actually
      # LANDED: the load is oscillating around the capacity step, so
      # the next hold-out doubles (a failed spawn is not a flap).
      self.flap_trips = min(self.flap_trips + 1, _MAX_FLAP_DOUBLINGS)
    if self.first_scale_up_t is None:
      self.first_scale_up_t = now
    self.scale_ups += 1
    # Stamp AFTER the action: a cold spawn takes seconds, and a
    # cooldown counted from before it would let the very next sweep
    # read the whole spawn as "quiet" and drain the replica right back.
    self._last_up_t = self.clock()
    self._emit("scale_up", action, index, rule)

  def _maybe_scale_down(self, now: float) -> None:
    live = self._live()
    if len(live) <= self.min_replicas:
      return
    # Youngest-added live replica, LIFO — and ONLY autoscaler-owned
    # capacity: if everything it added is already gone (e.g. the
    # spawned replica died), the operator's base set is not a fallback.
    added_live = [i for i in self._added if i in live]
    if not added_live:
      return
    index = added_live[-1]
    self._added.remove(index)
    self._parked.append(index)   # eligible for a future warm rejoin
    self.router.drain(index)
    self.scale_downs += 1
    self._last_down_t = self.clock()
    self._emit("scale_down", "drain", index, "recovered")

  # ------------------------------------------------------------ emission

  def counters(self) -> Dict[str, float]:
    """Fleet-rollup counters (merged into Router.router_counters, so
    they ride the ``serving/fleet/*`` schema with zero new plumbing)."""
    return {"scale_ups": float(self.scale_ups),
            "scale_downs": float(self.scale_downs),
            "autoscale_holds": float(self.holds),
            "flap_trips": float(self.flap_trips),
            "predictive_fires": float(self.predictive_fires)}

  def _emit(self, action: str, mechanism: str, index: int,
            rule: str) -> None:
    router = self.router
    live = len(self._live())
    payload = {"actuator": "autoscale", "action": action,
               "mechanism": mechanism, "replica": int(index),
               "rule": rule, "live_replicas": live,
               "knobs": {"live_replicas":
                         [live - 1 if action == "scale_up" else live + 1,
                          live]}}
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          "serving/actuation", cat="serving", track="serving",
          args={"actuator": "autoscale", "action": action,
                "mechanism": mechanism, "replica": int(index),
                "rule": rule, "live_replicas": live})
      tracer.counter("serving/live_replicas", live)
    if router._slo is not None:
      router._slo.note_actuation("autoscale", payload, step=router.steps)
    # Immediate rollup: the actuation's counter evidence lands at the
    # action, not up to a heartbeat later (Router._note_incident's rule).
    router._note_incident()
    get_logger().warning(
        "autoscale: %s replica %d via %s (rule %s) -> %d live "
        "(trips %d, next hold-out %.1fs)", action, index, mechanism,
        rule, live, self.flap_trips, self.scale_up_holdout_s())
