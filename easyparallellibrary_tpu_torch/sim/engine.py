"""Deterministic discrete-event core for the fleet simulator.

Three tiny primitives, shared by every sim module:

* :class:`SimClock` — the virtual clock.  Monotone, advanced ONLY by
  the episode loop (never by wall time); callable so it drops into
  every ``clock=`` seam the serving stack already exposes (router,
  scheduler, ServingStats, health, autoscaler, rollout) and into
  ``utils.vclock`` for the ambient SLO-monitor timestamps.
* :class:`XorShift` — a seeded xorshift64* generator.  The simulator
  must never touch ``random``/``np.random`` global state or wall
  entropy: two runs with the same seed produce bit-identical episodes,
  which is what makes replay fidelity a pinnable contract rather than
  a statistical claim.
* :class:`EventQueue` — a heap of (time, seq, event) with a
  monotone sequence tie-break, so same-timestamp events fire in
  insertion order on every platform.  Fault injection and any future
  scripted stimulus ride this queue.

No wall clock anywhere: ``time.time``/``time.monotonic`` are
deliberately not imported.
"""

from __future__ import annotations

import heapq
from typing import Any, List, Optional, Tuple

_MASK64 = (1 << 64) - 1


class SimClock:
  """Virtual monotone clock; ``clock()`` returns simulated seconds."""

  def __init__(self, start: float = 0.0):
    self._now = float(start)

  def __call__(self) -> float:
    return self._now

  @property
  def now(self) -> float:
    return self._now

  def advance(self, dt: float) -> float:
    """Move forward by ``dt`` seconds (negative dt is a bug: the
    serving stack's cooldowns and EWMAs assume a monotone clock)."""
    if dt < 0:
      raise ValueError(f"SimClock cannot go backwards (dt={dt})")
    self._now += dt
    return self._now

  def advance_to(self, t: float) -> float:
    """Jump to absolute time ``t`` if it is in the future (no-op
    otherwise) — the idle fast-forward primitive."""
    if t > self._now:
      self._now = float(t)
    return self._now


class XorShift:
  """xorshift64* PRNG — tiny, seedable, platform-stable.

  Quality is far beyond what arrival sampling needs, state is one
  64-bit integer (trivially snapshottable), and the stream is fully
  determined by the seed — unlike ``random.Random`` whose sequence is
  only guaranteed per CPython version.
  """

  def __init__(self, seed: int = 0):
    # Seed 0 is the one fixed point of the xorshift map; displace it
    # (splitmix-style) so every user seed yields a live stream.
    self._s = ((int(seed) ^ 0x9E3779B97F4A7C15) * 0xBF58476D1CE4E5B9
               + 1) & _MASK64

  def next_u64(self) -> int:
    s = self._s
    s ^= (s >> 12)
    s ^= (s << 25) & _MASK64
    s ^= (s >> 27)
    self._s = s
    return (s * 0x2545F4914F6CDD1D) & _MASK64

  def uniform(self) -> float:
    """float in [0, 1) with 53 random bits."""
    return (self.next_u64() >> 11) * (1.0 / (1 << 53))

  def expovariate(self, rate: float) -> float:
    """Exponential inter-arrival sample (rate = events/second)."""
    import math
    if rate <= 0:
      raise ValueError(f"expovariate needs rate > 0, got {rate}")
    # 1 - uniform() is in (0, 1]: log never sees 0.
    return -math.log(1.0 - self.uniform()) / rate

  def randint(self, lo: int, hi: int) -> int:
    """Uniform integer in [lo, hi] inclusive."""
    if hi < lo:
      raise ValueError(f"randint needs lo <= hi, got [{lo}, {hi}]")
    span = hi - lo + 1
    return lo + self.next_u64() % span


class EventQueue:
  """Time-ordered event heap with deterministic same-time ordering."""

  def __init__(self):
    self._heap: List[Tuple[float, int, Any]] = []
    self._seq = 0

  def push(self, at: float, event: Any) -> None:
    heapq.heappush(self._heap, (float(at), self._seq, event))
    self._seq += 1

  def peek_time(self) -> Optional[float]:
    return self._heap[0][0] if self._heap else None

  def pop_due(self, now: float) -> List[Any]:
    """Every event with timestamp <= ``now``, in firing order."""
    due: List[Any] = []
    while self._heap and self._heap[0][0] <= now:
      due.append(heapq.heappop(self._heap)[2])
    return due

  def __len__(self) -> int:
    return len(self._heap)

  def __bool__(self) -> bool:
    return bool(self._heap)
