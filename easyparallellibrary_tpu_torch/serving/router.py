"""Replicated serving: a health-checked router over N engine replicas
with failover by prefix replay (port of
``easyparallellibrary_tpu/serving/router.py``).

The engines do not know the router exists; it speaks the host-side
currencies the serving stack already has: :class:`Request` snapshots,
:class:`ServingStats` signals and registry namespaces.

* Health: a :class:`~serving.resilience.ReplicaHealth` per replica, fed
  a beat by every completed replica step (watchdog timeouts, bad steps,
  the ITL EWMA), healthy -> suspect -> down, and a circuit breaker whose
  hold-out doubles per trip.
* Failover: a replica whose step raised (or whose beats aged out) has
  its queued and in-flight requests snapshotted and restored on
  survivors, where each replays prompt + committed prefix through
  chunked prefill and resumes its stream.  With no survivor they park
  until a replica rejoins.
* Drain and rejoin: :meth:`Router.drain` stops routing to a replica and
  migrates what is left after ``drain_timeout_s``; :meth:`Router.rejoin`
  returns it (a dead process replica is respawned first).
* Dispatch: prefix affinity (block-aligned prompt keys, the prefix
  cache's own) within spare capacity, else least loaded, else round
  robin while load signals are stale; per-checkpoint-version admission
  weights when set.

Every submitted request resolves exactly once in :attr:`Router.finished`.
One :meth:`Router.step` sweeps every live replica: process replicas get
their step frame first and are collected after, so children overlap
their steps.  Replicas sit behind serving/transport.py: ``inproc`` (the
default) or ``process`` (each replica a spawned child; a dead child's
requests come back from the parent-side journal).

The control plane acts at sweep boundaries only: the rollout controller
(``serving.rollout.enabled``, serving/rollout.py), then the autoscaler
(``serving.autoscale.enabled``, serving/autoscale.py), grow and shrink
the fleet through :meth:`Router.build_replica` / :meth:`adopt_replica`,
drain and rejoin.  ``serving.router.reactor`` makes :meth:`Router.run`
drive the fleet readiness-first (serving/reactor.py); :meth:`step`
stays the sweep.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np

from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.observability import slo as slo_lib
from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.observability.registry import (
    FLEET_NAMESPACE, MetricRegistry)
from easyparallellibrary_tpu_torch.profiler.serving import fleet_summary
from easyparallellibrary_tpu_torch.serving.prefix_cache import (
    block_prefix_keys)
from easyparallellibrary_tpu_torch.serving.replica import EngineReplica
from easyparallellibrary_tpu_torch.serving.resilience import ReplicaHealth
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FinishedRequest, Request, next_flow_id)
from easyparallellibrary_tpu_torch.serving.transport import (
    InprocTransport, ProcessTransport, TransportError)
from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Prefix-affinity routing hashes BLOCK-ALIGNED prefix content — the
# same content keys the prefix cache's radix tree matches at
# (serving/prefix_cache.py block_prefix_keys), one key per full-block
# depth up to AFFINITY_MAX_BLOCKS.  Routing and block reuse thereby
# agree on what "same prefix" means: a request routed on a depth-d key
# lands on the replica whose tree holds exactly those d blocks warm,
# and the deepest matching depth wins (longest shared prefix = most
# prefill skipped).
# Bounded prefix->replica map (LRU): affinity is a locality hint, not
# state — evicting an entry only costs a cold route.
AFFINITY_CAPACITY = 4096


class Router:
  """Health-checked dispatch over N engine replicas (module docstring).

      router = Router(model, params, num_replicas=2, device="cuda",
                      paged=True, num_slots=8)
      router.submit(Request(uid="a", prompt=ids, max_new_tokens=64))
      outputs = router.run()       # {uid: prompt+generated}
      router.finished["a"].finish_reason
      router.drain(0); router.run()           # rolling restart:
      router.rejoin(0)                        # ...replica 0 warm again

  Every knob defaults from ``serving.router.*``.  ``replicas`` injects
  prebuilt (or duck-typed fake) replicas; otherwise ``num_replicas``
  replicas are built here from ``model``/``params`` (in process) or from
  ``factory`` (``transport="process"``: a ``"module:attr"`` spec or
  ``{"fn": ..., "kwargs": ...}`` that each child calls), all sharing
  ``engine_kwargs`` (``device`` among them).  ``clock`` is injectable
  for deterministic health and drain tests.
  """

  def __init__(self, model=None, params=None, *, num_replicas=None,
               mesh=None, registry=None, config=None,
               clock=time.monotonic, replicas=None, factory=None,
               replica_factory=None, transport=None, **engine_kwargs):
    root_config = config if config is not None else Env.get().config
    rconf = root_config.serving.router
    self._root_config = root_config
    self._drain_timeout_s = rconf.drain_timeout_s
    self._affinity_enabled = rconf.affinity
    # Affinity keys are the prefix cache's block-aligned keys, carved at
    # the paged block size (fixed even when paging is off).
    self._affinity_block = root_config.serving.paged.block_size
    self._heartbeat_s = rconf.heartbeat_s
    self._suspect_after = rconf.suspect_after
    self._down_after = rconf.down_after
    self.clock = clock
    # The ambient SLO monitor sees the live fleet rollup on the
    # heartbeat cadence and at once on a failover.
    self._slo = slo_lib.ensure_configured(root_config)
    self._last_rollup = clock()
    self.transport = (transport if transport is not None
                      else rconf.transport)
    if "device" in engine_kwargs and engine_kwargs["device"] is not None:
      engine_kwargs["device"] = str(engine_kwargs["device"])  # JSON-able
    # What build_replica() needs to make one more fleet member (the
    # autoscaler's cold grow, the rollout's green spawns).  An injected
    # replica list carries no recipe unless `replica_factory` (an
    # ``index -> replica`` callable, the simulator's seam) is given.
    self._replica_spec: Optional[Dict[str, Any]] = None
    self._replica_factory = replica_factory
    if replicas is not None:
      self.replicas: List[EngineReplica] = list(replicas)
      self.transport = "injected"
    else:
      n = num_replicas if num_replicas is not None else rconf.replicas
      if n < 1:
        raise ValueError(f"num_replicas must be >= 1: {n}")
      if self.transport == "process":
        # Each child builds (model, params) from `factory` itself: live
        # tensors never cross the wire, and a SIGKILL takes exactly one
        # replica's memory.
        if factory is None:
          raise ValueError(
              "serving.router.transport='process' needs Router("
              "factory=...): a 'module:attr' spec (or module-level "
              "callable) building (model, params) in the child; live "
              "model/params objects cannot cross a process boundary")
        self.replicas = [
            ProcessTransport(i, factory, config=root_config,
                             engine_kwargs=engine_kwargs, start=False)
            for i in range(n)]
        # The children build their engines side by side.
        ProcessTransport.start_all(self.replicas)
      else:
        self.replicas = [
            InprocTransport(i, model, params, mesh=mesh,
                            registry=registry, config=root_config,
                            **engine_kwargs)
            for i in range(n)]
      self._replica_spec = {
          "model": model, "params": params, "mesh": mesh,
          "registry": registry, "factory": factory,
          "engine_kwargs": dict(engine_kwargs)}
    self._itl_slo = root_config.serving.resilience.itl_slo_s
    self.health: List[ReplicaHealth] = [
        self._make_health(i) for i in range(len(self.replicas))]
    # Fleet-wide streamed-token fanout: fn(uid, [tok, ...]) per engine
    # iteration as tokens commit (the scheduler's on_tokens in process,
    # the step reply's watermarks for process replicas).  A failover
    # replay pre-seeds the committed prefix, so nothing is re-emitted.
    self.on_tokens: List[Any] = []
    for rep in self.replicas:
      self._wire_stream(rep)
    # The readiness-driven driver (serving/reactor.py), built lazily;
    # `serving.router.reactor` makes run() drive through it.
    self._reactor = None
    self._reactor_enabled = bool(rconf.reactor)
    self.registry = registry
    if self._slo is not None and registry is not None:
      self._slo.attach(registry)
    # uid -> FinishedRequest: one entry per resolved request, whichever
    # replica (or the router itself) resolved it.
    self.finished: Dict[Any, FinishedRequest] = {}
    # uid -> index of the replica responsible for it now.
    self.placement: Dict[Any, int] = {}
    # Snapshots with nowhere to run (every replica down), flushed when a
    # replica is routable again: an outage delays, it never loses.
    self._parked: List[Dict[str, Any]] = []
    self._affinity: "OrderedDict[int, int]" = OrderedDict()
    self._rr = 0                     # round-robin cursor
    # Per-checkpoint-version admission weights (None: version-blind
    # dispatch), split by a deterministic deficit counter.
    # `_fleet_version` salts affinity keys, so a warm-prefix hint never
    # names a replica whose cache holds other weights' K/V.
    self._version_weights: Optional[Dict[int, float]] = None
    self._version_dispatched: Dict[int, int] = {}
    self._fleet_version = int(engine_kwargs.get("checkpoint_version", 0))
    self._drain_deadline: Dict[int, float] = {}
    self._rejoined_at: Dict[int, float] = {}
    self.steps = 0
    self.submitted_total = 0         # submit() calls (demand signal)
    self.failovers = 0               # replica-down events that migrated
    self.migrated_requests = 0       # snapshots moved (failover + drain)
    self.router_shed = 0             # shed here: no routable replica
    self.probes = 0                  # breaker half-open rejoins
    # The fleet's SLO actuator (serving/autoscale.py) and the blue/green
    # rollout controller (serving/rollout.py): both act in _sweep_begin,
    # the only point the replica list may change.
    self._autoscaler = None
    if root_config.serving.autoscale.enabled:
      from easyparallellibrary_tpu_torch.serving.autoscale import (
          FleetAutoscaler)
      self._autoscaler = FleetAutoscaler(self, config=root_config)
    self.rollout = None
    if root_config.serving.rollout.enabled:
      from easyparallellibrary_tpu_torch.serving.rollout import (
          RolloutController)
      self.rollout = RolloutController(self, config=root_config)
    get_logger().info(
        "serving router: %d replica(s) (%s), suspect/down after "
        "%.1fs/%.1fs, drain timeout %.1fs, affinity %s",
        len(self.replicas), self.transport, rconf.suspect_after,
        rconf.down_after, rconf.drain_timeout_s,
        "on" if self._affinity_enabled else "off")

  # ------------------------------------------------------------- growth

  @property
  def spawn_recipe_available(self) -> bool:
    """True when this router can build new replicas: it built its own
    fleet, or was given a ``replica_factory``."""
    return (self._replica_spec is not None
            or self._replica_factory is not None)

  def build_replica(self, index: Optional[int] = None, *,
                    checkpoint: Optional[str] = None,
                    checkpoint_version: Optional[int] = None,
                    params=None):
    """Build ONE replica from the stored recipe without registering it:
    the slow half of :meth:`add_replica` (a child's spawn and engine
    build, or an in-process engine's weight copy), which the autoscaler
    and the rollout run on a spawner thread.  Reads the recipe only; the
    replica list is :meth:`adopt_replica`'s.

    ``checkpoint`` / ``checkpoint_version`` / ``params`` override the
    recipe for this one build (the rollout's green spawn); a completed
    rollout rewrites the recipe itself."""
    if self._replica_spec is None:
      if self._replica_factory is not None:
        if (checkpoint is not None or checkpoint_version is not None
            or params is not None):
          raise RuntimeError(
              "build_replica() overrides (checkpoint/version/params) "
              "are recipe levers; a replica_factory fleet builds "
              "replicas from the factory alone")
        return self._replica_factory(
            len(self.replicas) if index is None else index)
      raise RuntimeError(
          "build_replica() needs a router that built its own replicas; "
          "a fleet constructed from injected replicas carries no "
          "(model, params)/factory recipe to grow from")
    spec = self._replica_spec
    index = len(self.replicas) if index is None else index
    kwargs = dict(spec["engine_kwargs"])
    if checkpoint_version is not None:
      kwargs["checkpoint_version"] = int(checkpoint_version)
    if self.transport == "process":
      ckpt = checkpoint if checkpoint is not None else (
          spec.get("checkpoint"))
      return ProcessTransport(
          index, spec["factory"], config=self._root_config,
          engine_kwargs=kwargs, checkpoint=ckpt)
    return InprocTransport(
        index, spec["model"],
        spec["params"] if params is None else params,
        mesh=spec["mesh"], registry=spec["registry"],
        config=self._root_config, **kwargs)

  def adopt_replica(self, rep) -> int:
    """Register a built replica (the fast half of :meth:`add_replica`):
    append it to the replica and health lists, emit the trace instant,
    flush the parked backlog.  Runs on the router's thread between
    sweeps only."""
    index = len(self.replicas)
    self.replicas.append(rep)
    self.health.append(self._make_health(index))
    self._wire_stream(rep)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          "serving/replica_added", cat="serving", track="serving",
          args={"replica": index, "transport": self.transport,
                "pid": getattr(rep, "child_pid", None) or -1})
    get_logger().info("fleet grew: replica %d added (%s transport)",
                      index, self.transport)
    self._flush_parked()
    return index

  def add_replica(self) -> int:
    """Grow the fleet by one replica built from the construction recipe
    (same transport, config and engine kwargs); returns its index.  The
    synchronous operator lever: it blocks for the build (a child's spawn
    on the process transport).  Raises on an injected fleet without a
    ``replica_factory``."""
    return self.adopt_replica(self.build_replica())

  # ------------------------------------------------------------- health

  def _make_health(self, index: int) -> ReplicaHealth:
    return ReplicaHealth(
        suspect_after=self._suspect_after, down_after=self._down_after,
        heartbeat_s=self._heartbeat_s, itl_slo_s=self._itl_slo,
        clock=self.clock, on_transition=self._make_health_hook(index))

  def _wire_stream(self, rep) -> None:
    """Attach the streamed-token fanout to one replica: the parent-side
    ``on_tokens`` of a process transport, the scheduler's in process
    (duck-typed: a fake without either does not stream)."""
    hook = getattr(rep, "on_tokens", None)
    if hook is None:
      sched = getattr(rep, "scheduler", None)
      hook = getattr(sched, "on_tokens", None) if sched is not None \
          else None
    if hook is not None:
      hook.append(self._emit_tokens)

  def _emit_tokens(self, uid: Any, tokens: List[int]) -> None:
    for fn in self.on_tokens:
      fn(uid, tokens)

  def _make_health_hook(self, index: int):
    def hook(old: str, new: str, reason: str):
      tracer = trace_lib.get_tracer()
      if tracer.enabled:
        tracer.instant(
            "serving/replica_health", cat="serving", track="serving",
            args={"replica": index, "from": old, "to": new,
                  "reason": reason})
    return hook

  def reactor(self):
    """The readiness-driven driver over this fleet (serving/reactor.py,
    built once): each replica is dispatched again the moment its reply
    lands.  ``run()`` drives through it when ``serving.router.reactor``
    is on; :meth:`step` stays the sweep either way."""
    if self._reactor is None:
      from easyparallellibrary_tpu_torch.serving.reactor import (
          RouterReactor)
      self._reactor = RouterReactor(self, config=self._root_config)
    return self._reactor

  def state(self, index: int) -> str:
    return self.health[index].state

  def states(self) -> List[str]:
    return [h.state for h in self.health]

  def _routable(self) -> List[int]:
    return [i for i, h in enumerate(self.health) if h.routable]

  # ----------------------------------------------------------- dispatch

  def _replica_version(self, index: int) -> int:
    """Checkpoint version replica ``index`` serves (0 = unversioned —
    injected test replicas and pre-rollout fleets)."""
    return int(getattr(self.replicas[index], "checkpoint_version", 0)
               or 0)

  def set_version_weights(self,
                          weights: Optional[Dict[int, float]]) -> None:
    """Install per-checkpoint-version admission weights (init comment on
    ``_version_weights``).  Resets
    the deficit counters so each stage's split is exact from its first
    admission; ``None`` restores version-blind dispatch."""
    if weights is None:
      self._version_weights = None
      self._version_dispatched = {}
      return
    self._version_weights = {int(v): float(w)
                             for v, w in weights.items() if w > 0.0}
    self._version_dispatched = {v: 0 for v in self._version_weights}

  def _pick_version(self, routable: List[int]) -> tuple:
    """Deterministic weighted split of NEW admissions across checkpoint
    versions: pick the version with the largest admission deficit
    (expected share minus actual dispatches — no RNG, so a replayed
    trace splits identically), restricted to versions with a routable
    replica.  Returns ``(version, candidates)``; falls back to the
    whole routable set when no weighted version is live (weights must
    degrade, never shed)."""
    by_ver: Dict[int, List[int]] = {}
    for i in routable:
      by_ver.setdefault(self._replica_version(i), []).append(i)
    weights = {v: w for v, w in self._version_weights.items()
               if v in by_ver}
    if not weights:
      return None, routable
    total = sum(weights.values())
    n = sum(self._version_dispatched.get(v, 0) for v in weights) + 1
    best = max(sorted(weights),
               key=lambda v: (weights[v] / total) * n
               - self._version_dispatched.get(v, 0))
    self._version_dispatched[best] = (
        self._version_dispatched.get(best, 0) + 1)
    return best, by_ver[best]

  def _prefix_keys(self, prompt: np.ndarray,
                   version: Optional[int] = None) -> List[int]:
    """Block-aligned content keys for ``prompt``, shallowest first —
    the SAME hashing the prefix cache's radix tree matches at
    (prefix_cache.block_prefix_keys), so a deep affinity hit predicts a
    deep block-reuse hit on the target replica.  Keys are salted with
    the serving checkpoint version (default: the steady-state fleet's)
    so an entry made under one version never names another's replica."""
    ver = self._fleet_version if version is None else int(version)
    return block_prefix_keys(prompt, self._affinity_block, version=ver)

  def _remember_affinity(self, key: int, index: int) -> None:
    self._affinity.pop(key, None)
    self._affinity[key] = index
    while len(self._affinity) > AFFINITY_CAPACITY:
      self._affinity.popitem(last=False)

  def _choose(self, prompt: np.ndarray) -> tuple:
    """Pick a replica for one request: ``(index, reason)`` with reason
    in {"only", "affinity", "least_loaded", "round_robin"}, or
    ``(None, "no_replica")`` when nothing is routable."""
    now = self.clock()
    for i, h in enumerate(self.health):
      if self.replicas[i].has_work:
        # Only a replica that OWES work can go stale; an idle one's
        # loop isn't running, and absence of beats proves nothing.
        h.observe(now)
      else:
        h.touch(now)
    self._reap(now)
    routable = self._routable()
    if not routable:
      return None, "no_replica"
    version: Optional[int] = None
    if self._version_weights is not None:
      # Rollout in flight: the admission-weight split picks the
      # checkpoint version FIRST, then normal dispatch ranks within it.
      version, routable = self._pick_version(routable)
    if len(routable) == 1:
      return routable[0], "only"
    if any(self.health[i].signals_stale(now) for i in routable):
      # Load numbers of unknown age rank nothing: fall back to fair
      # rotation until fresh beats return.
      self._rr = (self._rr + 1) % len(routable)
      return routable[self._rr], "round_robin"
    if self._affinity_enabled:
      # Deepest matching depth first: the longest shared block-aligned
      # prefix names the replica holding the most of this prompt warm.
      for key in reversed(self._prefix_keys(prompt, version)):
        aff = self._affinity.get(key)
        if (aff is not None and aff in routable
            and self.replicas[aff].load < self.replicas[aff].num_slots):
          # Warm prefix AND spare capacity: locality wins.  A saturated
          # affinity target falls through to least-loaded — affinity is
          # a tiebreak, never a queueing reason.
          return aff, "affinity"
    idx = min(routable, key=lambda i: (self.replicas[i].load, i))
    return idx, "least_loaded"

  def _shed_at_router(self, request: Request, prompt: np.ndarray,
                      tracer) -> bool:
    self.router_shed += 1
    self.finished[request.uid] = FinishedRequest(
        uid=request.uid, tokens=prompt, new_tokens=0,
        finish_reason="shed")
    if tracer.enabled:
      tracer.instant(
          "serving/route", cat="serving", track="serving/requests",
          args={"uid": str(request.uid), "replica": -1,
                "reason": "no_replica"})
      tracer.flow("f", request.flow_id, track="serving/requests",
                  args={"uid": str(request.uid), "reason": "shed"})
    get_logger().warning(
        "router shedding request %r: no routable replica (states %s)",
        request.uid, self.states())
    return False

  def submit(self, request: Request) -> bool:
    """Route and enqueue one request; False when it was shed — by the
    router (no routable replica) or by the chosen replica's admission
    control.  Either way the shed record lands in :attr:`finished` with
    reason ``"shed"``, exactly once.

    A replica that DIES during the submit (a process transport's child
    crashed or timed out mid-call) is failed over on the spot, and the
    request is admitted exactly once regardless of where the call was
    lost: the transport journals the request BEFORE the RPC, so an
    ambiguous submit rides the failover replay to a survivor, and
    child-side uid dedup stops a retried wire call from double
    admitting."""
    prompt = np.asarray(request.prompt, np.int32).reshape(-1)
    # Cumulative demand counter — counts every arrival regardless of
    # outcome (admitted, replica-shed, router-shed), so rate samples
    # over it measure offered load, not accepted load.
    self.submitted_total += 1
    # The trace-context id is minted HERE — the earliest point the
    # request touches the fleet — so its flow arc starts at routing and
    # stays one connected thread through dispatch, admission, any
    # failover, and retirement.
    if request.flow_id is None:
      request = dataclasses.replace(request, flow_id=next_flow_id())
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.flow("s", request.flow_id, track="serving/requests",
                  args={"uid": str(request.uid)})
    for _attempt in range(len(self.replicas) + 1):
      idx, reason = self._choose(prompt)
      if idx is None:
        return self._shed_at_router(request, prompt, tracer)
      if tracer.enabled:
        tracer.instant(
            "serving/route", cat="serving", track="serving/requests",
            args={"uid": str(request.uid), "replica": idx,
                  "reason": reason})
      # Pin the request to the checkpoint version it is admitted under:
      # the tag rides every snapshot, so a later failover can only
      # replay it onto a SAME-version survivor (prefix replay across
      # versions would fork the stream).
      version = self._replica_version(idx)
      if request.checkpoint_version != version:
        request = dataclasses.replace(request,
                                      checkpoint_version=version)
      try:
        accepted = self.replicas[idx].submit(request)
      except TransportError as e:
        # ONLY transport failures read as replica death here — a
        # client error (malformed request -> ValueError) propagates to
        # the caller exactly as the engine contract promises, and must
        # never cost a healthy replica (let alone cascade fleet-wide).
        get_logger().error(
            "replica %d died during submit of %r (%s: %s); failing over",
            idx, request.uid, type(e).__name__, e)
        self.health[idx].mark_down(f"submit raised {type(e).__name__}")
        self._failover(idx)
        if request.uid in self.placement or self._parked_uid(request.uid):
          # The transport journaled the ambiguous submit; the failover
          # (or parking) above already owns it — admitted exactly once.
          return True
        continue
      if accepted:
        self.placement[request.uid] = idx
        if self._affinity_enabled:
          # Every depth remembers the placement: a future prompt
          # sharing only a SHALLOWER block-aligned prefix still finds
          # the warm replica through its own deepest common key.  Keys
          # carry the target's version salt, so the hint only ever
          # matches lookups routed to that same version.
          for key in self._prefix_keys(prompt, version):
            self._remember_affinity(key, idx)
      else:
        # The replica's admission control shed it and recorded the
        # resolution in ITS finished map; mirror fleet-side so callers
        # never chase per-replica maps (the replica counted the shed —
        # don't count it again here).
        fin = self.replicas[idx].finished.get(request.uid)
        if fin is not None:
          self.finished[request.uid] = fin
      return accepted
    return self._shed_at_router(request, prompt, tracer)

  def _parked_uid(self, uid: Any) -> bool:
    return any(snap["request"]["uid"] == uid for snap in self._parked)

  def cancel(self, uid: Any) -> bool:
    """Cancel ``uid`` wherever it lives — on its replica, or in the
    parked backlog (a parked request must not silently resurrect on the
    next rejoin after the client abandoned it)."""
    for k, snap in enumerate(self._parked):
      if snap["request"]["uid"] == uid:
        del self._parked[k]
        generated = np.asarray(snap.get("generated", ()), np.int32)
        fin = FinishedRequest(
            uid=uid,
            tokens=np.concatenate([
                np.asarray(snap["request"]["prompt"], np.int32),
                generated]),
            new_tokens=int(generated.size), finish_reason="cancelled")
        self._note_finished(-1, fin)
        tracer = trace_lib.get_tracer()
        flow_id = snap["request"].get("flow_id")
        if tracer.enabled and flow_id is not None:
          # A parked request's cancellation is its resolution — the
          # flow terminates here, not on any replica track.
          tracer.flow("f", flow_id, track="serving/requests",
                      args={"uid": str(uid), "reason": "cancelled"})
        return True
    idx = self.placement.get(uid)
    if idx is not None:
      try:
        return self.replicas[idx].cancel(uid)
      except TransportError as e:
        # The replica died holding the request: fail it over (fence +
        # journal), then cancel it wherever it landed — parked or on a
        # survivor.  A cancellation must never be silently lost to a
        # later failover replay decoding the request to completion.
        get_logger().error(
            "replica %d died during cancel of %r (%s: %s); failing over",
            idx, uid, type(e).__name__, e)
        self.health[idx].mark_down(f"cancel raised {type(e).__name__}")
        self._failover(idx)
        return self.cancel(uid)
    for rep in self.replicas:
      try:
        if rep.cancel(uid):
          return True
      except TransportError:
        continue
    return False

  # --------------------------------------------------------------- step

  def _note_finished(self, index: int, fin: FinishedRequest) -> None:
    self.finished[fin.uid] = fin
    self.placement.pop(fin.uid, None)

  def _sweep_begin(self, now: float) -> None:
    """Control-plane actions at a sweep (or reactor cycle) boundary, the
    only point the replica list may change: rollout transitions, the
    autoscaler, drain expiry and the parked flush."""
    if self.rollout is not None:
      # A rollback or cutover this sweep holds or releases the
      # autoscaler before it reads the replica set.
      self.rollout.on_step(now)
    if self._autoscaler is not None:
      self._autoscaler.on_step(now)
    self._check_drains(now)
    self._flush_parked()

  def _dispatch_one(self, i: int, now: float) -> bool:
    """Phase-1 dispatch for one replica: post the step frame (process
    transports) or mark it due (in-process replicas compute at
    collect).  Down replicas are probed on the breaker cadence instead.
    Returns True when the replica now owes a :meth:`_collect_one`."""
    rep = self.replicas[i]
    h = self.health[i]
    if h.state == "down":
      if h.can_probe(now):
        self._probe(i)
      return False
    send = getattr(rep, "step_send", None)
    if send is not None:
      try:
        send()
      except Exception as e:  # noqa: BLE001 — dead at dispatch
        self._note_step_death(i, e)
        return False
    return True

  def _collect_one(self, i: int,
                   now: float) -> Optional[List[FinishedRequest]]:
    """Phase-2 collect for one dispatched replica (and run, for
    in-process replicas): retirements, the health beat, breaker
    forgiveness.  Returns None when the replica died collecting (its
    requests already failed over)."""
    rep = self.replicas[i]
    h = self.health[i]
    recv = getattr(rep, "step_recv", None)
    try:
      fins = rep.step() if recv is None else recv()
    except Exception as e:  # noqa: BLE001 — ANY escaping error = dead
      self._note_step_death(i, e)
      return None
    for fin in fins:
      self._note_finished(i, fin)
    wire = getattr(rep, "wire_beat", None)
    if wire:
      # Process replica: the beat dict rode the step reply over the
      # wire; same watermark semantics as the in-process signals.
      h.beat_from_wire(wire)
    else:
      h.beat(watchdog_timeouts=rep.watchdog_timeouts,
             bad_steps=rep.bad_steps, itl_s=rep.itl_ewma_s)
    if h.state == "healthy" and h.trips:
      # Breaker forgiveness: a rejoined replica that survives a full
      # cooldown window clean sheds one trip.
      since = self._rejoined_at.get(i, now)
      if now - since >= h.cooldown_s():
        h.note_stable()
        self._rejoined_at[i] = now
    return fins

  def _sweep_end(self, now: float) -> None:
    """Sweep/cycle epilogue: reap passively-down replicas, advance the
    step counter, publish the rollup on the heartbeat cadence."""
    # A replica that reached "down" without raising (heartbeat aged out
    # at dispatch time between sweeps) is dead weight holding requests —
    # fail it over now.  Replicas that just stepped beat above, so their
    # age is zero and this is a no-op for them.
    self._reap(now)
    self.steps += 1
    # Live fleet rollup on the heartbeat cadence: the registry's sinks
    # (report.py --follow tails the JSONL) and the SLO monitor's rules
    # both see the fleet mid-run, not just at drain.  Raw-sample
    # percentile merging is bounded by the stats' reservoirs
    # (profiler/serving.py), so this stays O(replicas * sample cap).
    if (self.registry is not None or self._slo is not None) and \
        self.clock() - self._last_rollup >= self._heartbeat_s:
      self._publish_rollup()

  def step(self) -> List[FinishedRequest]:
    """One fleet sweep: migrate expired drains, step every live replica
    (collecting retirements and feeding health beats), fail over any
    replica whose step raised or whose heartbeat aged out, and probe
    down replicas whose breaker cooldown elapsed.  Returns this sweep's
    retirements fleet-wide.  Phase 1 dispatches to every live replica,
    phase 2 collects in replica order."""
    now = self.clock()
    out: List[FinishedRequest] = []
    self._sweep_begin(now)
    # Phase 1 — dispatch: process transports get their step frame NOW,
    # so concurrent children overlap their sweeps (fleet wall-clock =
    # the slowest child, not the sum); in-process replicas compute at
    # collect time below, in replica order.
    stepped: List[int] = []
    for i in range(len(self.replicas)):
      if self._dispatch_one(i, now):
        stepped.append(i)
    # Phase 2 — collect (and run, for in-process replicas), in replica
    # order: retirements, health beats, failover of anything that died.
    for i in stepped:
      fins = self._collect_one(i, now)
      if fins:
        out.extend(fins)
    self._sweep_end(now)
    return out

  def _publish_rollup(self) -> None:
    self._last_rollup = self.clock()
    records = [(FLEET_NAMESPACE, self.fleet_summary())]
    if self.rollout is not None and self.rollout.active:
      # Per-version sub-rollups while a rollout is in flight: bare-name
      # SLO rules suffix-match ``serving/fleet/v<N>/...``, the canary's
      # evidence streams, with no new rules.
      for ver, sub in self.rollout.version_rollups().items():
        records.append((f"{FLEET_NAMESPACE}/v{ver}", sub))
    for namespace, rollup in records:
      if self.registry is not None:
        # The SLO monitor rides the registry as a sink (attach at init).
        self.registry.publish(self.steps, rollup, namespace)
      elif self._slo is not None:
        # Registry-less fleet: same validated schema helper the registry
        # path uses — never an ad-hoc key literal (namespaced() validates
        # the root; report.py reads back through the same constant).
        self._slo.observe(self.steps,
                          MetricRegistry.namespaced(namespace, rollup))

  def _reap(self, now: float) -> None:
    """Fail over any down replica still holding requests.  Idempotent —
    a replica already evacuated (its step raised) yields no snapshots
    and is skipped; this catches the passive path, where staleness
    marked it down without an exception ever unwinding."""
    for i, h in enumerate(self.health):
      if h.state == "down" and self.replicas[i].has_work:
        self._failover(i)

  def run(self, max_steps: Optional[int] = None
          ) -> Dict[Any, np.ndarray]:
    """Drive until the fleet drains (or ``max_steps``); returns
    ``{uid: prompt+generated}`` for requests finished during the call.
    Publishes the fleet rollup at the end when a registry is
    attached."""
    out: Dict[Any, np.ndarray] = {}
    steps = 0
    drive = (self.reactor().cycle if self._reactor_enabled
             else self.step)
    while self.has_work and (max_steps is None or steps < max_steps):
      for fin in drive():
        out[fin.uid] = fin.tokens
      steps += 1
      if self._parked_stalled():
        # The parked backlog cannot move (no healthy or suspect target
        # — or none of the pinned version) and no live replica has work
        # of its own to make progress on —
        # return instead of spinning; the backlog is preserved and a
        # later run()/step() resumes it after a breaker probe or an
        # operator rejoin().
        get_logger().warning(
            "router.run(): %d request(s) parked with no routable "
            "replica (states %s); returning — rejoin a replica to "
            "resume", len(self._parked), self.states())
        break
    if self.registry is not None or self._slo is not None:
      self._publish_rollup()
    return out

  def _parked_stalled(self) -> bool:
    """True when the parked backlog cannot move and no live replica has
    work of its own: run()'s spin guard."""
    return bool(
        self._parked
        and not any(rep.has_work
                    for i, rep in enumerate(self.replicas)
                    if self.health[i].state != "down")
        and not any(self._eligible_targets(s, self._survivors(-1))
                    for s in self._parked))

  @property
  def has_work(self) -> bool:
    if self._parked:
      return True
    return any(
        rep.has_work for i, rep in enumerate(self.replicas)
        if self.health[i].state != "down")

  # ----------------------------------------------------------- failover

  def _note_step_death(self, index: int, exc: BaseException) -> None:
    """One replica's step (dispatch or collect) raised: mark it down,
    emit the ``serving/replica_down`` incident instant — carrying the
    child's kill signal when the transport reaped one, so the SLO
    monitor and diagnostic bundles see real process incidents — and
    fail its requests over."""
    rep = self.replicas[index]
    sig = getattr(rep, "exit_signal", None)
    sig_name = ""
    if sig:
      try:
        import signal as _signal
        sig_name = _signal.Signals(sig).name
      except (ValueError, ImportError):
        sig_name = str(sig)
    get_logger().error(
        "replica %d died mid-step (%s: %s%s); failing over",
        index, type(exc).__name__, exc,
        f"; child exit signal {sig_name}" if sig_name else "")
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          "serving/replica_down", cat="serving", track="serving",
          args={"replica": index, "error": type(exc).__name__,
                "signal": sig_name,
                "pid": getattr(rep, "child_pid", None) or -1})
    self.health[index].mark_down(f"step raised {type(exc).__name__}")
    self._failover(index)

  def _survivors(self, exclude: int) -> List[int]:
    """Failover targets: healthy first; a draining replica is never a
    target (it is trying to empty), a suspect one only as last resort
    (it is alive, just slow — better slow than parked)."""
    healthy = [i for i in self._routable() if i != exclude]
    if healthy:
      return healthy
    return [i for i, h in enumerate(self.health)
            if h.state == "suspect" and i != exclude]

  def _eligible_targets(self, snap: Dict[str, Any],
                        targets: List[int]) -> List[int]:
    """Targets a snapshot may restore onto: all of them for an unpinned
    request, only SAME-version replicas for one pinned to a checkpoint
    version (_place_snapshots docstring)."""
    pinned = snap["request"].get("checkpoint_version")
    if pinned is None:
      return list(targets)
    return [i for i in targets
            if self._replica_version(i) == int(pinned)]

  def _place_snapshots(self, snaps: List[Dict[str, Any]],
                       targets: List[int]) -> int:
    """Distribute snapshots over ``targets`` (least-loaded each time,
    re-ranked as restores land).  Restores go to the queue FRONT in
    reverse snapshot order, so the dead replica's service order is
    preserved on each target.  Returns how many were placed.

    A target that DIES mid-placement must not take the remaining
    snapshots with it ("an outage delays, it never loses"): the dead
    target is dropped and marked down, an AMBIGUOUSLY-applied restore
    (the target's transport journaled it before the wire failed) stays
    placed there — its own failover recovers it, double-placing would
    fork the request — and when no target is left the remainder parks.

    A snapshot pinned to a checkpoint version only places on a
    SAME-version target: with none, it parks (delayed, never replayed
    across versions)."""
    placed = 0
    targets = list(targets)
    pending = list(snaps)
    while pending:
      if not targets:
        get_logger().warning(
            "placement ran out of targets: parking %d remaining "
            "request(s)", len(pending))
        self._parked.extend(pending)
        break
      snap = pending[-1]
      eligible = self._eligible_targets(snap, targets)
      if not eligible:
        get_logger().warning(
            "no version-%s target for request %r: parking (cross-"
            "version replay is refused)",
            snap["request"].get("checkpoint_version"),
            snap["request"].get("uid"))
        self._parked.append(pending.pop())
        continue
      idx = min(eligible, key=lambda i: (self.replicas[i].load, i))
      try:
        uid = self.replicas[idx].restore_request(snap, front=True)
      except Exception as e:  # noqa: BLE001 — target died mid-restore
        get_logger().error(
            "replica %d died during restore placement (%s: %s)",
            idx, type(e).__name__, e)
        self.health[idx].mark_down(f"restore raised {type(e).__name__}")
        targets.remove(idx)
        owns = getattr(self.replicas[idx], "owns", None)
        if owns is not None and owns(snap["request"]["uid"]):
          # Ambiguous outcome, journaled on the dead target: fail THAT
          # replica over NOW (fence first, so it cannot also serve the
          # request) — its journal re-places the snapshot on a live
          # survivor or parks it.  Leaving it for a later sweep would
          # strand it: run() does not drive down replicas.
          pending.pop()
          self._failover(idx)
        continue
      pending.pop()
      self.placement[uid] = idx
      placed += 1
    return placed

  def _failover(self, index: int) -> None:
    """Move a down replica's queued + in-flight requests to survivors
    (module docstring: prefix replay makes this bit-exact).  With no
    survivor the snapshots park and flush on the next rejoin — an
    outage delays, it never loses."""
    snaps = self.replicas[index].evacuate()
    for snap in snaps:
      self.placement.pop(snap["request"]["uid"], None)
    if not snaps:
      return
    self.failovers += 1
    self.migrated_requests += len(snaps)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          "serving/failover", cat="serving", track="serving",
          args={"replica": index, "requests": len(snaps),
                "reason": self.health[index].down_reason})
    targets = self._survivors(index)
    if not targets:
      get_logger().warning(
          "failover of replica %d found NO survivor: parking %d "
          "request(s) until a replica rejoins", index, len(snaps))
      self._parked.extend(snaps)
      self._note_incident()
      return
    self._place_snapshots(snaps, targets)
    get_logger().warning(
        "replica %d failed over: %d request(s) resumed on replica(s) %s "
        "via prefix replay", index, len(snaps), targets)
    self._note_incident()

  def _note_incident(self) -> None:
    """Publish the fleet rollup IMMEDIATELY (not on the heartbeat
    cadence): a failover must open its SLO breach window — and land in
    the tailed metrics log — at the kill, not up to a heartbeat later."""
    if self.registry is not None or self._slo is not None:
      self._publish_rollup()

  def _flush_parked(self) -> None:
    if not self._parked:
      return
    # Same target preference as failover: healthy, else suspect as a
    # last resort — a parked backlog waiting for a perfect replica is a
    # parked backlog not being served.
    targets = self._survivors(-1)
    if not targets:
      return
    # A version-pinned snapshot with no same-version target stays
    # parked QUIETLY (no per-step churn through _place_snapshots);
    # it moves the moment its version has a live replica again.
    movable = [s for s in self._parked
               if self._eligible_targets(s, targets)]
    if not movable:
      return
    moved = {id(s) for s in movable}
    self._parked = [s for s in self._parked if id(s) not in moved]
    self._place_snapshots(movable, targets)
    get_logger().info("flushed %d parked request(s) onto replica(s) %s",
                      len(movable), targets)

  def _probe(self, index: int) -> None:
    """Half-open breaker probe: the cooldown elapsed, let the replica
    serve again; a relapse re-trips with a doubled hold-out.  A process
    replica's child is respawned first (cold engine: fresh compile,
    empty cache — what a real restart costs); a failed respawn re-arms
    the breaker with its doubled hold-out instead of spawn-storming."""
    if not self._ensure_replica_host(index):
      return
    if self.health[index].rejoin():
      self.probes += 1
      self._rejoined_at[index] = self.clock()
      get_logger().info(
          "probing replica %d back into service (trip %d, next "
          "hold-out %.1fs)", index, self.health[index].trips,
          self.health[index].cooldown_s())

  def _ensure_replica_host(self, index: int) -> bool:
    """(Re)start a transport-hosted replica's process if it is gone;
    True when the replica is usable.  In-process replicas are always
    up (their ``ensure_started`` is a no-op)."""
    rep = self.replicas[index]
    ensure = getattr(rep, "ensure_started", None)
    if ensure is None:
      return True
    try:
      if ensure():
        get_logger().info(
            "replica %d: child respawned (restart %d)", index,
            getattr(rep, "child_restarts", 0))
    except Exception as e:  # noqa: BLE001 — spawn/init failed
      get_logger().error(
          "replica %d: respawn failed (%s: %s); breaker re-armed",
          index, type(e).__name__, e)
      self.health[index].probe_failed(f"respawn {type(e).__name__}")
      return False
    return True

  # ------------------------------------------------------ drain / rejoin

  def drain(self, index: int,
            timeout_s: Optional[float] = None) -> None:
    """Graceful drain (rolling restart, step 1): stop routing to
    ``index``; its active requests get ``timeout_s`` (default
    ``serving.router.drain_timeout_s``) of fleet steps to finish, then
    the leftovers migrate to survivors.  The replica stays unroutable
    (state ``draining``) until :meth:`rejoin`."""
    self.health[index].drain()
    timeout = self._drain_timeout_s if timeout_s is None else timeout_s
    self._drain_deadline[index] = self.clock() + timeout
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          "serving/drain", cat="serving", track="serving",
          args={"replica": index, "timeout_s": float(timeout)})

  def _check_drains(self, now: float) -> None:
    for index in list(self._drain_deadline):
      rep = self.replicas[index]
      if not rep.has_work:
        del self._drain_deadline[index]
        continue
      if now < self._drain_deadline[index]:
        continue
      targets = self._survivors(index)
      if targets and not any(
          self._replica_version(t) == self._replica_version(index)
          for t in targets):
        # Complete in place: survivors exist but
        # none serves this replica's checkpoint version, so evacuating
        # would only park its (version-pinned) requests — a LIVE
        # draining replica keeps serving them to completion instead.
        self._drain_deadline[index] = now + self._drain_timeout_s
        continue
      del self._drain_deadline[index]
      snaps = rep.evacuate()
      if not snaps:
        continue
      for snap in snaps:
        # _place_snapshots re-points placed uids; parked ones must not
        # keep a stale entry naming the evacuated replica.
        self.placement.pop(snap["request"]["uid"], None)
      self.migrated_requests += len(snaps)
      targets = self._survivors(index)
      tracer = trace_lib.get_tracer()
      if tracer.enabled:
        tracer.instant(
            "serving/drain_migrate", cat="serving", track="serving",
            args={"replica": index, "requests": len(snaps)})
      if targets:
        self._place_snapshots(snaps, targets)
        get_logger().info(
            "drain timeout on replica %d: migrated %d request(s) to %s",
            index, len(snaps), targets)
      else:
        self._parked.extend(snaps)

  def rejoin(self, index: int, force: bool = False) -> bool:
    """Return a drained (or down) replica to service.  An in-process
    replica rejoins warm — its engine, cache and compiled step were
    never torn down; a process replica whose child died is respawned
    (cold) first.  For a down replica the circuit breaker must agree
    (``force=True`` overrides)."""
    h = self.health[index]
    if h.state == "down" and not (force or h.can_probe()):
      return False
    if not self._ensure_replica_host(index):
      return False
    ok = self.health[index].rejoin(force=force)
    if ok:
      self._drain_deadline.pop(index, None)
      self._rejoined_at[index] = self.clock()
      self._flush_parked()
    return ok

  # -------------------------------------------------------- observability

  def router_counters(self) -> Dict[str, float]:
    states = self.states()
    counters = {
        "failovers": float(self.failovers),
        "migrated_requests": float(self.migrated_requests),
        "router_shed": float(self.router_shed),
        "probes": float(self.probes),
        "parked": float(len(self._parked)),
        "replicas_healthy": float(states.count("healthy")),
        "replicas_suspect": float(states.count("suspect")),
        "replicas_down": float(states.count("down")),
        "replicas_draining": float(states.count("draining")),
        # Transport-layer incident counters (serving/transport.py),
        # summed fleet-wide: retried idempotent RPCs, wire deadline
        # misses, and child respawns.  They ride the fleet rollup
        # through MetricRegistry.namespaced like every other counter,
        # so the SLO monitor and diagnostic bundles see real-process
        # incidents with zero new plumbing.  All 0 on inproc fleets.
        "rpc_retries": 0.0,
        "rpc_timeouts": 0.0,
        "child_restarts": 0.0,
    }
    for rep in self.replicas:
      rpc = getattr(rep, "rpc_counters", None)
      if rpc is None:
        continue
      for key, val in rpc().items():
        counters[key] = counters.get(key, 0.0) + float(val)
    if self._autoscaler is not None:
      counters.update(self._autoscaler.counters())
    if self.rollout is not None:
      counters.update(self.rollout.counters())
    return counters

  def fleet_summary(self) -> Dict[str, float]:
    """One fleet-wide record (profiler.serving.fleet_summary): summed
    rates/counters, percentiles re-ranked over raw per-replica samples,
    plus the router's own counters.  Total fleet sheds =
    ``shed`` (replica admission control) + ``router_shed`` (nothing
    routable)."""
    # Bind each stats ONCE: for a process replica the property is a
    # blocking child RPC — evaluating it in both the filter and the
    # value position would double every rollup's wire traffic.
    stats = [s for s in (rep.stats for rep in self.replicas)
             if s is not None]
    return fleet_summary(stats, self.router_counters())

  def publish(self, registry, step: int) -> None:
    """Publish the rollup under ``serving/fleet/*`` (every replica's own
    records live under ``serving/replica<i>/*`` beside it)."""
    registry.publish(step, self.fleet_summary(), FLEET_NAMESPACE)

  def harvest_traces(self, drain: bool = True) -> int:
    """Pull every process replica's tracer ring remainder into the
    ambient tracer.  The
    steady-state path needs no call here — bounded chunks ride every
    step reply, and a clean ``close()`` flushes the rest via the
    shutdown reply — but a caller exporting the merged trace while the
    fleet is still up drains explicitly first.  Returns events harvested; inproc and injected
    replicas (no ``harvest`` endpoint) contribute zero."""
    total = 0
    for rep in self.replicas:
      harvest = getattr(rep, "harvest", None)
      if harvest is None:
        continue
      try:
        total += int(harvest(drain=drain))
      except TransportError:
        continue
    return total

  # ----------------------------------------------------------- lifecycle

  def close(self):
    # Process replicas flush their ring remainder on the shutdown
    # reply, so closing the fleet completes the merged trace.  Then the
    # spawner threads stop: they hold the router, and every engine in
    # it, while they run (and a child dies with the thread that forked
    # it, so they stop after the replicas closed).
    for rep in self.replicas:
      rep.close()
    for owner in (self._autoscaler, self.rollout, self._reactor):
      if owner is not None:
        owner.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False
