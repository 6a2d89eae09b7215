"""A simulated serving fleet: the REAL Router and its policy stack
over :class:`sim.replica.SimReplica` members on a virtual clock.

This is the discrete-event harness: it owns the
:class:`~easyparallellibrary_tpu_torch.sim.engine.SimClock`, feeds a
:class:`~easyparallellibrary_tpu_torch.sim.arrivals.Workload` through
``router.submit``, sweeps the fleet with ``router.step()`` and
advances virtual time by the slowest live replica's modeled step cost
(replicas run concurrently in a real fleet, so one synchronous sweep
spans one device-step worth of simulated wall time).  Every control
object above the device step is the production one: dispatch, health,
failover, admission, autotune, autoscale, rollout all run unmodified —
the simulator's claim is exactly "same policies, modeled physics".

The episode loop itself lives in :func:`drive_episode` and is SHARED
with the golden recorder (the JAX package's benchmarks/sim_golden.py)
and with ``chip_smoke.py``, which drive a REAL fleet through the
identical loop on the same virtual clock — replay fidelity then rests
on the policy objects and the record schema alone, never on two
hand-mirrored loops drifting apart.

Two dt regimes:

* ``fixed_dt`` — every busy sweep advances the same amount; used by
  golden record/replay, where both timelines must be step-for-step
  comparable.
* ``dt_fn`` (cost-driven, the SimFleet default) — dt = max over live
  replicas' last modeled step cost, floored at the step overhead;
  used by the policy-search sweeps.

The idle fast-forward is what buys the simulator its throughput: when
no replica owes work and no fault is due, the clock JUMPS to the next
stimulus instead of sweeping 100 idle replicas every overhead-quantum.
Jump landings still pass through ``router.step()`` so cooldown-gated
actuators (autoscaler, rollout, health probes) observe the elapsed
virtual time — the same observable sequence a patient wall-clock loop
would produce, minus the idle sweeps between.

``vclock.install`` is held for the duration of the loop (try/finally)
so config-built observability objects (SLO monitor timestamps,
diagnostic captures) read simulated seconds.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.observability import slo as slo_lib
from easyparallellibrary_tpu_torch.observability.registry import MetricRegistry
from easyparallellibrary_tpu_torch.serving.router import Router
from easyparallellibrary_tpu_torch.serving.scheduler import Request
from easyparallellibrary_tpu_torch.sim.arrivals import Workload
from easyparallellibrary_tpu_torch.sim.engine import SimClock
from easyparallellibrary_tpu_torch.sim.faults import FaultInjector
from easyparallellibrary_tpu_torch.sim.replica import CostModel, SimReplica
from easyparallellibrary_tpu_torch.utils import vclock


def _jsonify(obj):
  """Best-effort JSON coercion for numpy scalars in event payloads."""
  try:
    return float(obj)
  except (TypeError, ValueError):
    return str(obj)


def actuation_sequence(monitor=None) -> List[Dict[str, Any]]:
  """The episode's actuation sequence — every ``event == "actuation"``
  entry from the SLO monitor's event log, in order, with the wall
  timestamp stripped (real episodes carry process time, simulated ones
  virtual seconds; the SEQUENCE — actuator, knob transitions, order —
  is the replay-fidelity contract).  JSON round-tripped so recorded
  (file) and live (in-memory) sequences compare with ``==``."""
  monitor = monitor if monitor is not None else slo_lib.get_monitor()
  if monitor is None:
    return []
  seq = [{k: v for k, v in ev.items() if k != "time"}
         for ev in monitor.events if ev.get("event") == "actuation"]
  return json.loads(json.dumps(seq, default=_jsonify))


def warm_fleet(router: Router, clock, prompt, warm_max_new: int) -> None:
  """Pre-episode warm drain, identical on both sides of the replay
  contract: one short request DIRECT to every replica (bypassing
  router dispatch — placement must not depend on warm-up), then drive
  until drained.  On the real fleet this loads every kernel library
  outside the timed episode; on the simulated fleet it exists so the
  per-replica record streams (which the recorded episode's burn
  windows counted from step 1) line up."""
  vclock.install(clock)
  try:
    for i, rep in enumerate(router.replicas):
      rep.submit(Request(uid=f"warm{i}", prompt=prompt,
                         max_new_tokens=int(warm_max_new)))
    # Drain via the sweep EXPLICITLY, never router.run(): with
    # `serving.router.reactor` on, run() delegates to the readiness
    # driver (serving/reactor.py), whose cycles advance router.steps
    # on a different cadence — and every recorded step index in a
    # golden episode (tests/golden/sim_chaos_heal.json) is pinned to
    # the sweep's.  The simulator is sweep-compat by contract
    # (drive_episode below steps the same way).
    while router.has_work:
      router.step()
    if router.registry is not None or router._slo is not None:
      router._publish_rollup()
  finally:
    vclock.reset()


def drive_episode(router: Router, clock: SimClock, workload: Workload,
                  *, fixed_dt: Optional[float] = None,
                  dt_fn: Optional[Callable[[], float]] = None,
                  idle_dt: float = 5e-3, settle_steps: int = 400,
                  faults: Optional[FaultInjector] = None,
                  max_sim_s: float = 0.0) -> Dict[str, Any]:
  """THE episode loop (module docstring) — shared verbatim by the
  simulator and the golden recorder: fire due faults, submit due
  arrivals, one router sweep, advance the clock (``fixed_dt`` or
  ``dt_fn()``), fast-forward over dead air, then ``settle_steps`` idle
  sweeps at ``idle_dt`` so de-escalation / scale-down land inside the
  episode (actuators act between steps).  Returns loop accounting +
  ``submit_at``."""
  if (fixed_dt is None) == (dt_fn is None):
    raise ValueError("exactly one of fixed_dt / dt_fn must be given")
  n = len(workload)
  nxt = 0
  submit_at: Dict[Any, float] = {}
  peak = len(router.replicas)
  busy_sweeps = idle_jumps = 0
  vclock.install(clock)
  try:
    while nxt < n or router.has_work or (faults is not None
                                         and faults.pending):
      now = clock()
      if faults is not None:
        faults.fire_due(now, router.replicas)
      while nxt < n and workload.times[nxt] <= now:
        uid = nxt
        submit_at[uid] = now
        router.submit(Request(uid=uid, prompt=workload.prompts[uid],
                              max_new_tokens=int(workload.max_new[uid])))
        nxt += 1
      router.step()
      busy_sweeps += 1
      clock.advance(fixed_dt if fixed_dt is not None else dt_fn())
      peak = max(peak, len(router.replicas))
      if not router.has_work:
        # Idle fast-forward: jump to the next stimulus (arrival or
        # fault), not through it.
        horizon = []
        if nxt < n:
          horizon.append(float(workload.times[nxt]))
        if faults is not None and faults.next_time() is not None:
          horizon.append(float(faults.next_time()))
        if horizon:
          clock.advance_to(min(horizon))
          idle_jumps += 1
        else:
          break
      if max_sim_s > 0 and clock() > max_sim_s:
        break
    for _ in range(settle_steps):
      router.step()
      clock.advance(idle_dt)
    peak = max(peak, len(router.replicas))
  finally:
    vclock.reset()
  return {"submit_at": submit_at, "busy_sweeps": busy_sweeps,
          "idle_jumps": idle_jumps, "replicas_peak": peak,
          "submitted": nxt}


class SimFleet:
  """Build and drive one simulated fleet episode (module docstring)."""

  def __init__(self, *, num_replicas: int, config=None, registry=None,
               cost: Optional[CostModel] = None,
               num_slots: Optional[int] = None,
               prefill_chunk: Optional[int] = None,
               max_seq_len: int = 512):
    root = config if config is not None else Env.get().config
    self.config = root
    self.clock = SimClock()
    self.cost = cost if cost is not None else CostModel.from_config(root)
    self.registry = registry if registry is not None else MetricRegistry()
    self._num_slots = num_slots
    self._chunk = prefill_chunk
    self._max_seq_len = max_seq_len
    self._first_at: Dict[Any, float] = {}
    self.spawn_delay_s = root.sim.spawn_delay_s
    self.spawns = 0
    replicas = [self._make_replica(i) for i in range(num_replicas)]
    self.router = Router(
        config=root, registry=self.registry, clock=self.clock,
        replicas=replicas, replica_factory=self._spawn_replica)

  # ------------------------------------------------------------ members

  def _make_replica(self, index: int) -> SimReplica:
    rep = SimReplica(index, config=self.config, registry=self.registry,
                     clock=self.clock, cost=self.cost,
                     num_slots=self._num_slots,
                     prefill_chunk=self._chunk,
                     max_seq_len=self._max_seq_len)
    clk = self.clock
    first = self._first_at
    rep.scheduler.on_first_token.append(
        lambda uid, _f=first, _c=clk: _f.setdefault(uid, _c()))
    return rep

  def _spawn_replica(self, index: int) -> SimReplica:
    """The autoscaler/rollout spawn path.  Provisioning latency is
    charged to the virtual clock (``sim.spawn_delay_s``) — with
    ``autoscale.sync_spawn`` the fleet genuinely waits, which is what
    a blocking in-process spawn costs in the real router too."""
    if self.spawn_delay_s > 0:
      self.clock.advance(self.spawn_delay_s)
    self.spawns += 1
    return self._make_replica(index)

  @property
  def replicas(self) -> List[SimReplica]:
    return self.router.replicas

  def submit(self, request: Request) -> bool:
    return self.router.submit(request)

  def _sweep_dt(self) -> float:
    """Cost-driven virtual time for one fleet sweep: the slowest live
    replica's modeled step (they run concurrently), floored at the
    dispatch overhead so a sweep never costs zero time."""
    router = self.router
    dt = max((rep.last_step_cost
              for i, rep in enumerate(router.replicas)
              if router.health[i].state != "down"), default=0.0)
    return max(dt, self.cost.step_overhead_s)

  # ------------------------------------------------------------ episode

  def run(self, workload: Workload, *,
          fixed_dt: Optional[float] = None,
          idle_dt: float = 5e-3,
          settle_steps: int = 400,
          faults: Optional[FaultInjector] = None,
          max_sim_s: float = 0.0) -> Dict[str, Any]:
    """Drive one full episode; returns the episode summary dict."""
    router = self.router
    n = len(workload)
    wall_t0 = time.perf_counter()
    loop = drive_episode(
        router, self.clock, workload,
        fixed_dt=fixed_dt,
        dt_fn=None if fixed_dt is not None else self._sweep_dt,
        idle_dt=idle_dt, settle_steps=settle_steps, faults=faults,
        max_sim_s=max_sim_s)
    wall_s = time.perf_counter() - wall_t0
    submit_at = loop["submit_at"]
    first_at = self._first_at
    shed = [u for u in range(n)
            if u in router.finished
            and router.finished[u].finish_reason == "shed"]
    served = [u for u in range(n) if u not in set(shed)]
    ttfts = sorted(first_at[u] - submit_at[u]
                   for u in served if u in first_at and u in submit_at)
    monitor = slo_lib.get_monitor()

    def pct(p: float) -> float:
      if not ttfts:
        return 0.0
      k = min(len(ttfts) - 1, int(round(p / 100.0 * (len(ttfts) - 1))))
      return float(ttfts[k])

    live = [h for h in router.health if h.state in ("healthy", "suspect")]
    summary: Dict[str, Any] = {
        "requests": n,
        "served": len(served),
        "shed": len(shed),
        "shed_rate": len(shed) / n if n else 0.0,
        "ttft_p50_s": pct(50), "ttft_p99_s": pct(99),
        "sim_duration_s": float(self.clock()),
        "wall_s": float(wall_s),
        "busy_sweeps": loop["busy_sweeps"],
        "idle_jumps": loop["idle_jumps"],
        "replicas_peak": loop["replicas_peak"],
        "replicas_final_live": len(live),
        "spawns": self.spawns,
        "faults_fired": len(faults.fired) if faults is not None else 0,
        "cost_source": self.cost.source,
    }
    if monitor is not None:
      summary["slo_breaches"] = monitor.breaches
      summary["slo_recoveries"] = monitor.recoveries
      summary["slo_actuations"] = monitor.actuations
    auto = router._autoscaler
    if auto is not None:
      summary["scale_ups"] = auto.scale_ups
      summary["scale_downs"] = auto.scale_downs
    return summary
