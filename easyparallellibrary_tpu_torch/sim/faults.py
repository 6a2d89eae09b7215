"""Scripted fault injection for simulated fleet episodes.

A :class:`FaultInjector` is a time-ordered script of fault events over
the virtual clock (sim/engine.py EventQueue) that the episode loop
fires between router sweeps — the simulator's stand-in for
``testing/chaos.py``'s live drills.  Three fault kinds, matching the
failure modes the serving stack's self-healing machinery is built for:

* ``kill`` — the replica's next step() raises (SimReplicaDead): the
  router marks it down, journals failover, and the replicas_down SLO
  rule sees the gap.  ``revive`` undoes it (a rebooted worker).
* ``stall`` — one step is charged extra seconds (straggler /
  preemption blip): ITL-sensitive policies see a spike, nothing dies.
* ``spawn_delay`` — every autoscaler/rollout spawn through the fleet's
  replica factory charges the virtual clock (provisioning latency),
  so scale-up decisions pay a realistic lag before capacity lands.

Events are (time, kind, replica_index, value) tuples; determinism
comes from the EventQueue's insertion-order tie-break — no RNG here
(stochastic fault schedules belong to the caller, seeded).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from easyparallellibrary_tpu_torch.sim.engine import EventQueue

KINDS = ("kill", "revive", "stall")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
  at: float             # virtual seconds
  kind: str             # kill | revive | stall
  replica: int          # target replica index
  value: float = 0.0    # stall seconds (stall only)


class FaultInjector:
  """Feed scripted FaultEvents to a fleet as virtual time passes."""

  def __init__(self, events: Optional[List[FaultEvent]] = None,
               spawn_delay_s: float = 0.0):
    self.spawn_delay_s = float(spawn_delay_s)
    self._queue = EventQueue()
    self.fired: List[FaultEvent] = []
    for ev in events or []:
      self.schedule(ev)

  def schedule(self, ev: FaultEvent) -> None:
    if ev.kind not in KINDS:
      raise ValueError(f"unknown fault kind {ev.kind!r} "
                       f"(one of {KINDS})")
    self._queue.push(ev.at, ev)

  def next_time(self) -> Optional[float]:
    return self._queue.peek_time()

  @property
  def pending(self) -> int:
    return len(self._queue)

  def fire_due(self, now: float, replicas) -> List[FaultEvent]:
    """Apply every event due at ``now`` to ``replicas`` (a list of
    SimReplica, indexed by fleet position; events aimed past the end
    of the list — a replica that was never spawned or was reaped — are
    dropped, recorded as fired)."""
    due: List[FaultEvent] = self._queue.pop_due(now)
    for ev in due:
      self.fired.append(ev)
      if ev.replica >= len(replicas) or replicas[ev.replica] is None:
        continue
      rep = replicas[ev.replica]
      if ev.kind == "kill":
        rep.kill()
      elif ev.kind == "revive":
        rep.revive()
      elif ev.kind == "stall":
        rep.stall(ev.value)
    return due


def death_and_recovery(at: float, replica: int,
                       down_for_s: float) -> List[FaultEvent]:
  """The standard chaos shape: kill at ``at``, revive after
  ``down_for_s`` virtual seconds."""
  return [FaultEvent(at=at, kind="kill", replica=replica),
          FaultEvent(at=at + down_for_s, kind="revive", replica=replica)]
