"""Arrival-process generators for simulated serving episodes.

Every generator is driven by a :class:`sim.engine.XorShift` stream —
no global RNG, no wall entropy — so a (kind, seed, params) tuple fully
determines the workload and an episode can be replayed bit-exactly.

Processes:

* **poisson** — homogeneous Poisson arrivals at ``rate_rps``.
* **diurnal** — inhomogeneous Poisson via thinning against the peak
  rate; intensity is a raised cosine between ``base_rps`` and
  ``peak_rps`` with period ``period_s`` (a day compressed to however
  many simulated seconds the sweep can afford).
* **overload** — the chaos-drill shape (testing/chaos.overload_burst):
  a burst phase at ``factor ×`` measured capacity followed by a
  recovery phase below capacity, which is the stimulus the admission
  ladder + autotuner + autoscaler chain is designed to absorb.

Prompts are drawn from a Zipf-popular template pool: requests sharing
a template share a prompt prefix, so the router's affinity dispatch
and the prefix cache see realistic skew instead of uniform noise.
Token VALUES never affect simulated cost or policy decisions (the sim
engine commits fabricated tokens); templates exist purely to exercise
content-keyed policies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from easyparallellibrary_tpu_torch.sim.engine import XorShift


@dataclasses.dataclass
class Workload:
  """One episode's stimulus: parallel lists, ascending ``times``."""

  times: List[float]
  prompts: List[np.ndarray]
  max_new: List[int]

  def __len__(self) -> int:
    return len(self.times)


def poisson_times(rate_rps: float, duration_s: float,
                  rng: XorShift) -> List[float]:
  times: List[float] = []
  t = 0.0
  if rate_rps <= 0:
    return times
  while True:
    t += rng.expovariate(rate_rps)
    if t >= duration_s:
      return times
    times.append(t)


def diurnal_times(base_rps: float, peak_rps: float, period_s: float,
                  duration_s: float, rng: XorShift) -> List[float]:
  """Thinning: draw candidates at the peak rate, keep each with
  probability rate(t)/peak — exact for any bounded intensity."""
  if peak_rps <= 0 or peak_rps < base_rps:
    raise ValueError(f"need 0 < peak_rps and base_rps <= peak_rps, "
                     f"got base={base_rps} peak={peak_rps}")
  times: List[float] = []
  t = 0.0
  while True:
    t += rng.expovariate(peak_rps)
    if t >= duration_s:
      return times
    # Trough at t=0, crest at period/2: sweeps start quiet, ramp up.
    rate = base_rps + (peak_rps - base_rps) * 0.5 * (
        1.0 - math.cos(2.0 * math.pi * t / period_s))
    if rng.uniform() < rate / peak_rps:
      times.append(t)


def overload_times(capacity_rps: float, n_burst: int, n_recover: int,
                   factor: float, rng: XorShift,
                   recover_frac: float = 0.4) -> List[float]:
  """Burst at ``factor × capacity`` for ``n_burst`` arrivals, then
  ``recover_frac × capacity`` for ``n_recover`` — overload the fleet
  MUST shed from, then a lull it must recover in."""
  if capacity_rps <= 0 or factor <= 0:
    raise ValueError("capacity_rps and factor must be positive")
  times: List[float] = []
  t = 0.0
  for _ in range(n_burst):
    t += rng.expovariate(capacity_rps * factor)
    times.append(t)
  for _ in range(n_recover):
    t += rng.expovariate(capacity_rps * recover_frac)
    times.append(t)
  return times


def zipf_prompts(n: int, rng: XorShift, *, num_templates: int = 16,
                 alpha: float = 1.1, plen: int = 6,
                 vocab: int = 256) -> List[np.ndarray]:
  """``n`` prompts drawn from ``num_templates`` fixed templates with
  Zipf(alpha) popularity — template rank r has weight 1/r^alpha."""
  if num_templates <= 0 or plen <= 0:
    raise ValueError("num_templates and plen must be positive")
  templates = [
      np.array([rng.randint(0, vocab - 1) for _ in range(plen)],
               dtype=np.int32)
      for _ in range(num_templates)]
  weights = [1.0 / (r + 1) ** alpha for r in range(num_templates)]
  total = sum(weights)
  cdf = []
  acc = 0.0
  for w in weights:
    acc += w / total
    cdf.append(acc)
  prompts: List[np.ndarray] = []
  for _ in range(n):
    u = rng.uniform()
    rank = next(i for i, c in enumerate(cdf) if u <= c)
    prompts.append(templates[rank])
  return prompts


def make_workload(kind: str, rng: XorShift, *, duration_s: float,
                  rate_rps: float, plen: int = 6, max_new: int = 8,
                  period_s: float = 0.0, peak_factor: float = 4.0,
                  overload_factor: float = 3.0) -> Workload:
  """Dispatcher the benchmarks use: (kind, seed, params) → Workload.

  ``rate_rps`` is the BASE rate; diurnal peaks at ``peak_factor ×``
  base, overload treats base as measured capacity and bursts at
  ``overload_factor ×``.
  """
  if kind == "poisson":
    times = poisson_times(rate_rps, duration_s, rng)
  elif kind == "diurnal":
    period = period_s if period_s > 0 else duration_s
    times = diurnal_times(rate_rps, rate_rps * peak_factor, period,
                          duration_s, rng)
  elif kind == "overload":
    # Arrival count sized so the episode roughly spans duration_s.
    n = max(1, int(rate_rps * duration_s))
    times = overload_times(rate_rps, (3 * n) // 4, n - (3 * n) // 4,
                           overload_factor, rng)
  else:
    raise ValueError(f"unknown workload kind {kind!r} "
                     f"(poisson | diurnal | overload)")
  prompts = zipf_prompts(len(times), rng, plen=plen)
  return Workload(times=times, prompts=prompts,
                  max_new=[max_new] * len(times))
