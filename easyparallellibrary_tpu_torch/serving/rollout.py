"""Zero-downtime blue/green checkpoint rollout with an SLO-watched
canary and automatic rollback (port of
``easyparallellibrary_tpu/serving/rollout.py``).

A fleet serving checkpoint N ("blue") moves to checkpoint N+1
("green") without dropping a request and without trusting the new
weights until they have carried real traffic:

1. **Validate** — ``begin(checkpoint_dir)`` walks the checksum chain
   (:func:`~runtime.saver.checkpoint_fingerprint`: every shard's
   sha256 plus the index's params fingerprint) and, when the serving
   params live in this process, checks the stored leaf geometry
   against them (:func:`~runtime.saver.peek_leaf_shapes`, in the JAX
   layout the saver writes) — a wrong checkpoint fails in milliseconds,
   before any replica is spawned.
2. **Spawn green** — one new replica per live blue is built from the
   router's construction recipe pointed at the new checkpoint, OFF the
   sweep thread (the autoscaler's spawner pattern: a long-lived daemon
   thread builds, :meth:`Router.adopt_replica` lands each at a sweep
   boundary).  Capacity only ever GROWS here — the live set never dips
   below ``serving.rollout.min_replicas`` because blue keeps serving
   untouched until cutover.
3. **Canary** — admission weight shifts green-ward in stages:
   ``canary_frac`` of NEW requests first (the router's deterministic
   deficit split, :meth:`Router.set_version_weights`), watched for
   ``canary_hold_s`` through the existing
   :class:`~observability.slo.SLOMonitor` via per-version breach
   streams — the router publishes ``serving/fleet/v<N>/*`` sub-rollups
   while a rollout is active, and bare-name SLO rules suffix-match
   them with no new rule plumbing.  A canary-scoped breach (or a green
   replica death, or a green spawn failure) triggers **automatic
   rollback**: green is drained, blue admission weights are restored,
   and the fleet is bit-exactly the never-rolled fleet.  A clean hold
   cuts admission fully over to green.
4. **Drain blue** — after cutover, blue replicas drain gracefully:
   in-flight blue requests COMPLETE IN PLACE on the weights that
   started them (migration policy: prefix replay across checkpoint
   versions is not bit-exact, so every request is pinned to the
   version it was admitted under and restore/evacuate refuse
   cross-version replay — a mid-rollout SIGKILL of a blue replica
   fails over to a surviving blue, never green).  Once blue is empty
   the recipe is rewritten (later autoscale spawns and breaker
   respawns build green), ``Router._fleet_version`` advances, and the
   rollout retires.

Every transition is emitted three ways: a ``serving/rollout`` trace
instant, an :meth:`SLOMonitor.note_actuation` line in
``slo_events.jsonl``, and the ``serving/fleet/rollout_*`` counters on
the fleet rollup (published immediately, not on the heartbeat
cadence).

While a rollout is in flight the autoscaler is HELD
(:meth:`FleetAutoscaler.hold`): grow/shrink mid-canary would change
the capacity the canary's SLO evidence is judging.

Pure host policy — injectable clock (the router's), driven from
:meth:`Router.step` at sweep boundaries exactly like the autoscaler.
An in-process green replica's weights are restored on the spawner
thread onto the device of the blue engines.  Knobs:
``serving.rollout.*``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.profiler.serving import fleet_summary
from easyparallellibrary_tpu_torch.utils.logging import get_logger

PARAMS_PREFIX = "params/"


class RolloutController:
  """Blue/green rollout state machine for one Router (module
  docstring).  Built by the router when ``serving.rollout.enabled``;
  the operator calls :meth:`begin` between sweeps, and every state
  transition happens in :meth:`on_step` on the router's thread.

  States: ``idle`` → ``spawning`` → ``canary`` → ``draining_blue`` →
  ``idle`` (completed), with ``rolling_back`` → ``idle`` reachable
  from ``spawning`` (spawn failure/timeout) and ``canary``
  (canary-scoped SLO breach, green replica death).
  """

  def __init__(self, router, config=None):
    conf = (config if config is not None
            else Env.get().config).serving.rollout
    self.router = router
    self.clock = router.clock
    self.canary_frac = conf.canary_frac
    self.canary_hold_s = conf.canary_hold_s
    self.min_replicas = conf.min_replicas
    self.spawn_timeout_s = conf.spawn_timeout_s
    self.drain_timeout_s = conf.drain_timeout_s
    self._rules = set(conf.rules)
    self.state = "idle"
    self.started = 0
    self.completed = 0
    self.rollbacks = 0
    self.spawn_failures = 0
    # One rollout's working set (valid while state != idle).
    self._checkpoint: Optional[str] = None
    self._blue_version = 0
    self._green_version = 0
    self._blue: List[int] = []        # replica indices serving blue
    self._green: List[int] = []       # adopted green replica indices
    self._target_greens = 0
    self._begin_t = 0.0
    self._canary_t = 0.0
    self._green_params = None         # inproc: loaded on spawner thread
    # Off-thread green spawns — the autoscaler's spawner-thread shape
    # (serving/autoscale.py init comment: the forking thread must
    # outlive every child it spawns, or PDEATHSIG reaps the fresh
    # replica the moment the thread exits).
    self._lock = threading.Lock()
    self._spawn_thread: Optional[threading.Thread] = None
    self._spawn_queue = None
    self._outcomes: List[tuple] = []
    if router._slo is None:
      get_logger().warning(
          "serving.rollout.enabled without observability.slo.enabled: "
          "the canary has no breach signal — a bad checkpoint will "
          "cut over after canary_hold_s unchallenged")
    get_logger().info(
        "rollout controller: canary %.0f%% for %.1fs, floor %d "
        "replica(s), spawn timeout %.1fs", 100.0 * self.canary_frac,
        self.canary_hold_s, self.min_replicas, self.spawn_timeout_s)

  # ------------------------------------------------------------ operator

  @property
  def active(self) -> bool:
    return self.state != "idle"

  def begin(self, checkpoint_dir: str) -> int:
    """Start a rollout to the newest valid checkpoint under
    ``checkpoint_dir``.  Validates BEFORE any replica exists (module
    docstring step 1) and raises on a bad checkpoint — a rollout that
    cannot even validate never touches the fleet.  Returns the green
    checkpoint version.  Must be called between sweeps on the router's
    thread (same contract as every replica-list mutation)."""
    if self.state != "idle":
      raise RuntimeError(
          f"rollout already in flight (state {self.state!r}); one "
          f"checkpoint transition at a time")
    router = self.router
    if not router.spawn_recipe_available:
      raise RuntimeError(
          "rollout needs a router that built its own replicas; an "
          "injected-replica fleet carries no recipe to spawn green "
          "from")
    from easyparallellibrary_tpu_torch.runtime.saver import (
        checkpoint_fingerprint, peek_leaf_shapes)
    # Checksum chain: index parses, shards exist, sizes + sha256 match,
    # and the recorded params fingerprint recomputes — all before a
    # single green replica is paid for.
    fingerprint, ckpt_step = checkpoint_fingerprint(checkpoint_dir)
    shapes, _ = peek_leaf_shapes(checkpoint_dir)
    params = router._replica_spec.get("params")
    if params is not None:
      self._check_geometry(shapes, params, checkpoint_dir)
    blue_live = [i for i, h in enumerate(router.health)
                 if h.state in ("healthy", "suspect")]
    if len(blue_live) < self.min_replicas:
      raise RuntimeError(
          f"rollout refused: {len(blue_live)} live replica(s) is "
          f"already below serving.rollout.min_replicas="
          f"{self.min_replicas}")
    self._checkpoint = checkpoint_dir
    self._blue_version = router._fleet_version
    self._green_version = self._blue_version + 1
    self._blue = blue_live
    self._green = []
    self._green_params = None
    self._target_greens = max(len(blue_live), self.min_replicas)
    self._begin_t = self.clock()
    self.started += 1
    self.state = "spawning"
    if router._autoscaler is not None:
      # The replica set belongs to this rollout until it retires —
      # autoscale grow/shrink mid-canary would change the capacity the
      # canary's SLO evidence is judging.
      router._autoscaler.hold("rollout in flight")
    self._emit("begin", checkpoint=checkpoint_dir,
               checkpoint_step=int(ckpt_step),
               fingerprint=fingerprint[:16],
               greens_to_spawn=self._target_greens)
    self._start_spawns()
    return self._green_version

  def _check_geometry(self, shapes: Dict[str, tuple], params,
                      checkpoint_dir: str) -> None:
    """Stored leaf geometry vs the serving params tree: every live leaf
    must exist in the checkpoint with a restorable shape (equal, or
    larger-and-sliceable — saver._slice_to_shape's contract covers
    padded saves).  Mirrors what restore_params would discover
    mid-load, but fails here in milliseconds with the leaf named."""
    from easyparallellibrary_tpu_torch.runtime import saver as saver_lib
    prefixed = any(p.startswith(PARAMS_PREFIX) for p in shapes)
    stored = {(p[len(PARAMS_PREFIX):] if prefixed else p): tuple(s)
              for p, s in shapes.items()
              if not prefixed or p.startswith(PARAMS_PREFIX)}
    # The serving params in the stored (JAX) layout: Dense kernels
    # [in, out], as the saver writes them.
    for path, value in saver_lib.params_tree(params).items():
      want = stored.get(path)
      if want is None:
        raise ValueError(
            f"rollout validation failed: serving leaf {path!r} is "
            f"missing from checkpoint {checkpoint_dir!r} — wrong "
            f"model?")
      got = tuple(value.shape)
      restorable = want == got
      if not restorable and len(want) == len(got):
        # A larger stored leaf slices down at load (padded save).
        restorable = all(w >= g for w, g in zip(want, got))
      if not restorable:
        raise ValueError(
            f"rollout validation failed: leaf {path!r} is "
            f"{want} in checkpoint {checkpoint_dir!r} but the "
            f"serving config expects {got} — geometry mismatch")

  # -------------------------------------------------------- green spawns

  def _start_spawns(self) -> None:
    import queue
    with self._lock:
      if self._spawn_thread is None or not self._spawn_thread.is_alive():
        self._spawn_queue = queue.Queue()
        self._spawn_thread = threading.Thread(
            target=self._spawner_loop, name="epl-rollout-spawner",
            daemon=True)
        self._spawn_thread.start()
    for _ in range(self._target_greens):
      self._spawn_queue.put(self._green_version)
    get_logger().info(
        "rollout: spawning %d green replica(s) off-thread (version "
        "%d); blue keeps serving", self._target_greens,
        self._green_version)

  def _spawner_loop(self) -> None:
    while True:
      version = self._spawn_queue.get()
      if version is None:
        return                        # close(): the thread lets go
      try:
        rep, err = self._build_green(version), None
      except Exception as e:  # noqa: BLE001 — posted, booked on_step
        rep, err = None, e
      with self._lock:
        self._outcomes.append((rep, err))

  def close(self) -> None:
    """Stop the spawner thread (it holds this controller, and so the
    router and its engines, for as long as it runs).  Router.close()
    calls it; a spawn in flight finishes first.  Idempotent."""
    with self._lock:
      thread, queue_ = self._spawn_thread, self._spawn_queue
      self._spawn_thread = None
    if thread is not None and thread.is_alive():
      queue_.put(None)

  def _build_green(self, version: int):
    """Build ONE green replica (spawner thread; recipe reads only).  A
    process replica's child restores the checkpoint itself
    (transport's ``checkpoint`` init key); an in-process replica gets
    the green params loaded HERE, once, against the recipe's params as
    the target tree — a failed load is a spawn failure, which rolls
    the rollout back."""
    router = self.router
    if router.transport == "process":
      return router.build_replica(checkpoint=self._checkpoint,
                                  checkpoint_version=version)
    if self._green_params is None:
      from easyparallellibrary_tpu_torch.runtime.saver import restore_params
      spec = router._replica_spec
      self._green_params, _ = restore_params(
          self._checkpoint, target=spec["params"],
          device=spec["engine_kwargs"].get("device"))
    return router.build_replica(checkpoint_version=version,
                                params=self._green_params)

  # --------------------------------------------------------------- sweep

  def on_step(self, now: Optional[float] = None) -> None:
    """One fleet-sweep boundary: land finished green spawns, then move
    the state machine (module docstring)."""
    if self.state == "idle":
      return
    now = self.clock() if now is None else now
    router = self.router
    with self._lock:
      outcomes, self._outcomes = self._outcomes, []
    for rep, err in outcomes:
      if err is not None:
        self.spawn_failures += 1
        get_logger().error(
            "rollout: green replica spawn failed (%s: %s)",
            type(err).__name__, err)
        self._emit("spawn_failed", error=type(err).__name__)
        if self.state in ("spawning", "canary"):
          self._rollback(f"green spawn failed ({type(err).__name__})",
                         now)
        continue
      if self.state not in ("spawning", "canary"):
        # A spawn landing after rollback began: the replica is not
        # wanted — close it instead of adopting a stray green.
        try:
          rep.close()
        except Exception:  # noqa: BLE001 — best-effort teardown
          pass
        continue
      index = router.adopt_replica(rep)
      self._green.append(index)
      self._emit("green_up", replica=index,
                 greens=len(self._green), target=self._target_greens)
    if self.state == "spawning":
      if len(self._green) >= self._target_greens:
        self._start_canary(now)
      elif now - self._begin_t > self.spawn_timeout_s:
        self.spawn_failures += 1
        self._rollback(
            f"green spawn timed out after {self.spawn_timeout_s:.1f}s "
            f"({len(self._green)}/{self._target_greens} up)", now)
    elif self.state == "canary":
      breach = self._canary_breach()
      dead = [i for i in self._green
              if router.health[i].state == "down"]
      if breach is not None:
        self._rollback(f"canary SLO breach: {breach[0]}@{breach[1]}",
                       now)
      elif dead:
        self._rollback(f"green replica {dead[0]} died during canary",
                       now)
      elif now - self._canary_t >= self.canary_hold_s:
        self._cutover(now)
    elif self.state == "draining_blue":
      if not self._holding_work(self._blue):
        self._complete(now)
    elif self.state == "rolling_back":
      if not self._holding_work(self._green):
        self._finish_rollback(now)

  def _holding_work(self, indices: List[int]) -> bool:
    router = self.router
    return any(router.replicas[i].has_work for i in indices
               if router.health[i].state != "down")

  def _canary_breach(self) -> Optional[tuple]:
    """First live breach on the green version's scoped streams
    (``serving/fleet/v<green>/*``), filtered to
    ``serving.rollout.rules`` when set; None when clean."""
    monitor = self.router._slo
    if monitor is None:
      return None
    scope = f"serving/fleet/v{self._green_version}"
    for rule, key in monitor.breached_streams(scope=scope):
      if not self._rules or rule in self._rules:
        return rule, key
    return None

  # --------------------------------------------------------- transitions

  def _start_canary(self, now: float) -> None:
    self.state = "canary"
    self._canary_t = now
    self.router.set_version_weights({
        self._blue_version: 1.0 - self.canary_frac,
        self._green_version: self.canary_frac})
    self._emit("canary_start", canary_frac=self.canary_frac,
               hold_s=self.canary_hold_s, greens=len(self._green))

  def _cutover(self, now: float) -> None:
    router = self.router
    self.state = "draining_blue"
    router.set_version_weights({self._green_version: 1.0})
    # Graceful blue drain: every in-flight blue request completes IN
    # PLACE on the weights that started it (complete-in-place
    # migration policy); the version pin on each request enforces it
    # even through a blue death — failover targets are blue-only.
    for index in self._blue:
      if router.health[index].state in ("healthy", "suspect"):
        router.drain(index, timeout_s=self.drain_timeout_s)
    self._emit("cutover", drained_blues=len(self._blue))

  def _complete(self, now: float) -> None:
    router = self.router
    # The recipe now builds GREEN: later autoscale spawns and breaker
    # respawns serve the new checkpoint with no override.
    spec = router._replica_spec
    spec["engine_kwargs"]["checkpoint_version"] = self._green_version
    if router.transport == "process":
      spec["checkpoint"] = self._checkpoint
    elif self._green_params is not None:
      spec["params"] = self._green_params
    router._fleet_version = self._green_version
    router.set_version_weights(None)
    self.completed += 1
    self.state = "idle"
    if router._autoscaler is not None:
      router._autoscaler.release()
    self._emit("completed", version=self._green_version,
               duration_s=now - self._begin_t)

  def _rollback(self, reason: str, now: float) -> None:
    """Automatic rollback: blue admission weights restore NOW (green
    stops receiving new requests this very sweep), green drains
    gracefully — its in-flight canary requests complete in place —
    and the fleet is bit-exactly the never-rolled fleet."""
    router = self.router
    get_logger().error("rollout ROLLBACK: %s", reason)
    self.rollbacks += 1
    self.state = "rolling_back"
    # Version-blind dispatch over blue: greens are drained (unroutable)
    # below, so restoring weights to None IS restoring blue's 100%.
    router.set_version_weights(None)
    for index in self._green:
      if router.health[index].state in ("healthy", "suspect"):
        router.drain(index, timeout_s=self.drain_timeout_s)
    self._emit("rollback_start", reason=reason,
               greens_draining=len(self._green))

  def _finish_rollback(self, now: float) -> None:
    router = self.router
    self.state = "idle"
    self._green_params = None
    if router._autoscaler is not None:
      router._autoscaler.release()
    self._emit("rollback_done", blue_version=self._blue_version,
               duration_s=now - self._begin_t)

  # ------------------------------------------------------- observability

  def version_rollups(self) -> Dict[int, Dict[str, float]]:
    """Per-checkpoint-version fleet sub-rollups, for the router to
    publish under ``serving/fleet/v<N>/*`` while a rollout is active —
    the canary's evidence streams (module docstring step 3)."""
    router = self.router
    by_ver: Dict[int, list] = {}
    for i, rep in enumerate(router.replicas):
      if router.health[i].state == "down":
        continue
      by_ver.setdefault(router._replica_version(i), []).append(rep)
    out: Dict[int, Dict[str, float]] = {}
    for ver, reps in by_ver.items():
      stats = [s for s in (r.stats for r in reps) if s is not None]
      if stats:
        out[ver] = fleet_summary(stats)
    return out

  def counters(self) -> Dict[str, float]:
    """Fleet-rollup counters (merged into Router.router_counters —
    the ``serving/fleet/rollout_*`` schema)."""
    return {"rollout_started": float(self.started),
            "rollout_completed": float(self.completed),
            "rollout_rollbacks": float(self.rollbacks),
            "rollout_spawn_failures": float(self.spawn_failures),
            "rollout_active": 1.0 if self.active else 0.0}

  def _emit(self, event: str, **args: Any) -> None:
    """Three-way emission per transition (module docstring): trace
    instant, slo_events line, immediate counter rollup."""
    router = self.router
    payload = {"actuator": "rollout", "transition": event,
               "state": self.state,
               "blue_version": int(self._blue_version),
               "green_version": int(self._green_version)}
    payload.update(args)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant("serving/rollout", cat="serving", track="serving",
                     args=dict(payload))
    if router._slo is not None:
      router._slo.note_actuation("rollout", payload, step=router.steps)
    # Immediate rollup: the transition's counter evidence lands at the
    # transition, not up to a heartbeat later.
    router._note_incident()
    get_logger().info("rollout: %s (state %s, blue v%d, green v%d)",
                      event, self.state, self._blue_version,
                      self._green_version)
