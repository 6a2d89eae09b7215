"""Readiness-driven router core (port of
``easyparallellibrary_tpu/serving/reactor.py``): per-replica dispatch
the moment each previous reply lands, instead of the lock-step sweep.

``Router.step()`` is a barrier: phase 1 dispatches a step to every live
replica, phase 2 collects in replica order — so the fleet's cadence is
its slowest member's.  One stalled child (SIGSTOP, a long build, a
slow host) gates every fast replica behind the sweep barrier even
though the process transport's wire is fully pipelined.  This module
removes the barrier without touching the control plane: a
``selectors``-based event loop over the SAME four pieces the sweep is
built from (``Router._sweep_begin`` / ``_dispatch_one`` /
``_collect_one`` / ``_sweep_end``), re-dispatching each replica the
moment its reply lands.

* **Process replicas** wait on the transport socket
  (:meth:`ReplicaTransport.readiness_fd`): readable = the step reply
  (or a side-band frame) arrived.  A reply that an interleaved RPC
  already drained off the socket (``submit``/``cancel`` mid-cycle
  stashes or buffers it) never polls readable — :meth:`step_ready`
  catches those.
* **In-process replicas** compute synchronously inside ``step_recv``,
  so readiness is a queue-backed shim: dispatch appends the replica to
  a ready deque and collect runs its step — the execution order within
  a cycle stays deterministic (FIFO), which is what keeps the inproc
  N=1 reactor bit-exact with the sweep.

One **cycle** = one ``_sweep_begin`` (rollout -> autoscaler -> drains
-> parked flush: the only point the replica list may mutate — the
sweep's exact mutation-safety contract), then readiness-driven
dispatch/collect until every replica has either exhausted its
``serving.router.reactor_max_steps`` quota or run out of work, then
one ``_sweep_end`` (reap + rollup).  A fast replica thus runs up to
``reactor_max_steps`` steps per cycle while a slow peer finishes one —
the fleet's throughput decouples from its slowest member while health,
failover, journal recovery, autoscale and rollout all run UNMODIFIED
(they are the same router methods the sweep calls).

A straggler that never becomes readable is force-collected once its
wire deadline (``serving.router.rpc_timeout_s``) elapses —
``step_recv``'s own deadline/condemn/fence machinery then runs exactly
as it does under the sweep.

``Router.step()`` remains the sweep (the simulator's fixed-dt episode
loop and the golden replay depend on its determinism);
``serving.router.reactor = True`` routes ``Router.run()`` and the
front door's driver (serving/frontdoor/) through this loop.
"""

from __future__ import annotations

import selectors
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from easyparallellibrary_tpu_torch.serving.scheduler import FinishedRequest
from easyparallellibrary_tpu_torch.utils.logging import get_logger


class RouterReactor:
  """Readiness-driven driver over one :class:`~serving.router.Router`
  (module docstring).  Build via ``router.reactor()`` (cached) or
  directly; ``cycle()`` is the reactor's unit of progress — the
  readiness-first analogue of one ``router.step()`` sweep."""

  def __init__(self, router, *, config=None,
               max_steps_per_cycle: Optional[int] = None):
    root = config if config is not None else router._root_config
    rconf = root.serving.router
    self.router = router
    self.max_steps = int(max_steps_per_cycle
                         if max_steps_per_cycle is not None
                         else rconf.reactor_max_steps)
    if self.max_steps < 1:
      raise ValueError(
          f"reactor max_steps_per_cycle must be >= 1: {self.max_steps}")
    self._rpc_timeout_s = float(rconf.rpc_timeout_s)
    self._sel = selectors.DefaultSelector()
    self.cycles = 0
    self.dispatched = 0   # per-replica steps driven (all cycles)
    self.wire_waits = 0   # selector waits that actually blocked

  # ------------------------------------------------------------- cycle

  def cycle(self) -> List[FinishedRequest]:
    """One reactor cycle (module docstring): control-plane actions at
    the boundary, then dispatch/collect each live replica readiness-
    first up to ``max_steps`` steps each.  Returns the cycle's
    retirements fleet-wide — the same contract as ``router.step()``."""
    r = self.router
    r._sweep_begin(r.clock())
    out: List[FinishedRequest] = []
    steps_done: Dict[int, int] = {}
    ready: Deque[int] = deque()          # inproc readiness shim
    inflight: Dict[int, float] = {}      # index -> wire deadline
    registered: Dict[int, Any] = {}      # index -> selector key

    def dispatch(i: int) -> None:
      if not r._dispatch_one(i, r.clock()):
        return
      steps_done[i] = steps_done.get(i, 0) + 1
      self.dispatched += 1
      rep = r.replicas[i]
      getfd = getattr(rep, "readiness_fd", None)
      fd = getfd() if getfd is not None else None
      if fd is None:
        ready.append(i)
      else:
        inflight[i] = time.monotonic() + self._rpc_timeout_s
        try:
          registered[i] = self._sel.register(fd, selectors.EVENT_READ, i)
        except (ValueError, KeyError, OSError):
          # fd unusable (condemned between dispatch and register):
          # fall back to a direct collect, whose own deadline handles
          # the corpse.
          inflight.pop(i, None)
          ready.append(i)

    def collect(i: int) -> None:
      fins = r._collect_one(i, r.clock())
      if fins is None:
        return                     # died collecting; failover already ran
      out.extend(fins)
      rep = r.replicas[i]
      if (steps_done.get(i, 0) < self.max_steps
          and r.health[i].state not in ("down",)
          and getattr(rep, "has_work", False)):
        dispatch(i)

    def unregister(i: int) -> None:
      key = registered.pop(i, None)
      inflight.pop(i, None)
      if key is not None:
        try:
          self._sel.unregister(key.fileobj)
        except (KeyError, ValueError, OSError):
          pass

    for i in range(len(r.replicas)):
      dispatch(i)
    while ready or inflight:
      while ready:
        collect(ready.popleft())
      if not inflight:
        break
      # Replies an interleaved RPC already stashed never poll readable.
      stashed = [i for i in list(inflight)
                 if getattr(r.replicas[i], "step_ready", lambda: True)()]
      for i in stashed:
        unregister(i)
        collect(i)
      if stashed or ready or not inflight:
        continue
      now_w = time.monotonic()
      timeout = max(0.0, min(inflight.values()) - now_w)
      events = self._sel.select(timeout=timeout)
      self.wire_waits += 1
      if events:
        for key, _ in events:
          i = key.data
          if i in inflight:
            unregister(i)
            collect(i)
      else:
        # Deadline stragglers: force the collect — step_recv's own
        # wire deadline condemns/fences exactly as under the sweep.
        overdue = [i for i, dl in inflight.items()
                   if time.monotonic() >= dl]
        for i in overdue:
          unregister(i)
          collect(i)
    r._sweep_end(r.clock())
    self.cycles += 1
    return out

  # --------------------------------------------------------------- run

  def run(self, max_cycles: Optional[int] = None
          ) -> Dict[Any, Any]:
    """Drive cycles until the fleet drains (or ``max_cycles``); returns
    ``{uid: prompt+generated}`` — the same contract as
    ``Router.run()``, which delegates here when
    ``serving.router.reactor`` is on."""
    r = self.router
    out: Dict[Any, Any] = {}
    cycles = 0
    while r.has_work and (max_cycles is None or cycles < max_cycles):
      for fin in self.cycle():
        out[fin.uid] = fin.tokens
      cycles += 1
      if r._parked_stalled():
        get_logger().warning(
            "reactor.run(): %d request(s) parked with no routable "
            "replica (states %s); returning — rejoin a replica to "
            "resume", len(r._parked), r.states())
        break
    if r.registry is not None or r._slo is not None:
      r._publish_rollup()
    return out

  def close(self) -> None:
    try:
      self._sel.close()
    except OSError:
      pass
