"""Serving-side metrics: tokens/s, TTFT, inter-token latency, occupancy.

The training profilers in this package score steps (flops.py) and bytes
(memory.py); serving is scored by what a CLIENT observes, so the
counters here are request-lifecycle timestamps aggregated into the
standard serving quartet:

* **tokens/s** — aggregate generated-token throughput over the engine's
  busy wall-clock (the number continuous batching exists to raise);
* **TTFT** — time-to-first-token per request (admission latency +
  prefill), p50/p99;
* **ITL** — mean inter-token latency per request after the first token
  (the decode cadence a streaming client feels), p50/p99 across
  requests;
* **slot occupancy** — mean fraction of KV-cache slots doing work per
  step (how full the continuous batch actually runs; low occupancy with
  a deep queue means admission is the bottleneck);
* **speculation** — drafted vs accepted draft tokens, overall acceptance
  rate, and accepted-tokens-per-step percentiles over the steps that
  actually drafted (docs/serving.md "Speculative decoding").  Early in a
  run — or on a non-speculative engine — that window is legitimately
  empty or a single sample; every rollup degrades gracefully to 0.0 /
  the lone sample rather than raising.
* **resilience** — shed / expired / cancelled / failed request counts,
  bad device steps and in-place retries, requeues, degradation-ladder
  transitions and watchdog timeouts (docs/robustness.md "Serving
  resilience"), plus ``itl_ewma_s``: an exponentially weighted moving
  average of decode-step time — the live inter-token-latency estimate
  the admission controller compares against ``itl_slo_s`` (per-request
  ITL percentiles only exist after requests FINISH; overload needs a
  signal mid-flight).

The engine feeds these via the ``note_*`` hooks; ``summary()`` rolls
them up for logs / ``MetricsWriter`` / BENCH_EVIDENCE records.  Host
wall-clock only — nothing here touches the device or forces a sync
beyond the engine's own per-step token fetch.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


# A full reservoir admits new samples with probability limit/count;
# clamping the count at DECAY_HORIZON * limit floors that at 1/8, so
# the sample tracks roughly the last 8*limit observations instead of
# diluting toward the replica's whole life — an SLO percentile blind to
# a fresh regression because the replica is old would defeat the
# monitor (observability/slo.py) these samples feed.
_RESERVOIR_DECAY_HORIZON = 8


class _Reservoir:
  """Deterministic sliding reservoir sample of an unbounded stream
  (algorithm R with a fixed xorshift32 stream instead of ``random``,
  and the admission count clamped — ``_RESERVOIR_DECAY_HORIZON``):
  bounded memory for the life of a replica, recency-weighted enough
  for live alerting, identical contents for identical input streams —
  benchmark records and bit-exactness guards must not drift run to
  run.  Until ``limit`` items have been seen the sample IS the stream,
  so short windows (tests, small episodes) keep exact percentiles."""

  __slots__ = ("limit", "items", "count", "_state")

  def __init__(self, limit: int):
    if limit < 1:
      raise ValueError(f"reservoir limit must be >= 1: {limit}")
    self.limit = limit
    self.items: List[float] = []
    self.count = 0
    self._state = 0x9E3779B9

  def add(self, x: float) -> None:
    self.count += 1
    if len(self.items) < self.limit:
      self.items.append(float(x))
      return
    s = self._state
    s ^= (s << 13) & 0xFFFFFFFF
    s ^= s >> 17
    s ^= (s << 5) & 0xFFFFFFFF
    self._state = s
    j = s % min(self.count, _RESERVOIR_DECAY_HORIZON * self.limit)
    if j < self.limit:
      self.items[j] = float(x)


def percentile(values: List[float], q: float) -> float:
  """Nearest-rank percentile; 0.0 on empty input, the lone sample on a
  1-element window, and ``q`` clamped into [0, 100] — small windows are
  legitimate (acceptance-rate rollups start empty), so no input here
  ever raises.  Kept dependency-free and deterministic — benchmark
  records must not drift with numpy interpolation-mode defaults."""
  if not values:
    return 0.0
  q = max(0.0, min(100.0, float(q)))
  xs = sorted(values)
  rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
  return float(xs[rank])


class _RequestTrace:
  __slots__ = ("submitted_at", "admitted_at", "first_token_at",
               "finished_at", "new_tokens")

  def __init__(self, now: float):
    self.submitted_at = now
    self.admitted_at: Optional[float] = None
    self.first_token_at: Optional[float] = None
    self.finished_at: Optional[float] = None
    self.new_tokens = 0


class ServingStats:
  """Request-lifecycle and per-step counters for the serving engine.

  ``clock`` is injectable for deterministic tests.  All ``note_*`` hooks
  are cheap (dict insert / float math) and safe to call from the
  engine's host loop.  ``finished_limit`` bounds how many FINISHED
  per-request traces are retained (oldest evicted first) — 0 keeps all,
  which on a long-running server grows host memory linearly with
  requests served.  In-flight traces are never evicted.

  Latency percentiles (TTFT / per-request mean ITL) are computed over
  deterministic :class:`_Reservoir` samples capped at ``sample_limit``
  per series — the raw-sample buffers are otherwise unbounded for the
  life of a replica, and the fleet rollup (:func:`fleet_summary`)
  extends every replica's buffer into a merged list on each rollup, so
  both the per-replica memory AND the per-rollup merge cost must stay
  O(sample_limit).  Below the cap the sample is exact.
  """

  def __init__(self, clock=time.monotonic, finished_limit: int = 0,
               sample_limit: int = 1024):
    self._clock = clock
    self.finished_limit = finished_limit
    self.sample_limit = sample_limit
    self.reset()

  def reset(self):
    """Zero every counter and trace — call after an engine warmup so the
    compile step never pollutes throughput/latency rollups."""
    self._req: Dict[Any, _RequestTrace] = {}
    # Insertion-ordered set (dict keys) of windowed finished uids:
    # pop-then-insert refreshes a reused uid's position in O(1).
    self._finished_order: Dict[Any, None] = {}
    self.steps = 0
    self.busy_time_s = 0.0
    self.prefill_tokens = 0
    self.decode_tokens = 0
    self.finished_requests = 0
    self.generated_tokens = 0
    self._occupancy_sum = 0.0
    self.drafted_tokens = 0
    self.accepted_tokens = 0
    # Accepted drafts per step, recorded only for steps that drafted —
    # legitimately empty early in a run (all-prefill steps) or on a
    # non-speculative engine.
    self._accepted_per_step: List[float] = []
    # Resilience counters (all stay 0 on a non-resilient engine).
    self.shed_requests = 0
    self.requeues = 0
    self.bad_steps = 0
    self.step_retries = 0
    self.degraded_transitions = 0
    self.degraded_level = 0
    self.watchdog_timeouts = 0
    # Unexpected fused-step recompiles (observability/slo.py
    # CompileSentinel): 0 is the contract; anything else is an incident.
    self.recompiles = 0
    self.finish_reasons: Dict[str, int] = {}
    # Bounded raw latency samples (class docstring).
    self._ttft_res = _Reservoir(self.sample_limit)
    self._itl_res = _Reservoir(self.sample_limit)
    # Paged KV block-pool gauges (last-seen; all 0 on a contiguous
    # engine): free/used blocks, internal fragmentation, and cumulative
    # preemptions (docs/serving.md "Paged KV cache").
    self.kv_blocks_free = 0
    self.kv_blocks_used = 0
    self.kv_fragmentation = 0.0
    self.preemptions = 0
    self.proactive_preemptions = 0
    # Prefix-cache counters (all 0 without serving.prefix_cache):
    # cumulative admission hits/misses, total blocks mapped by
    # reference instead of prefilled, tree evictions, and the tree's
    # current resident footprint (docs/serving.md "Prefix caching").
    self.prefix_hits = 0
    self.prefix_misses = 0
    self.prefix_blocks_reused = 0
    self.prefix_evictions = 0
    self.prefix_cached_blocks = 0
    # Live ITL estimate: EWMA of decode-step wall time (module
    # docstring).  0.0 until the SECOND decoding step — the first
    # decode-step sample can carry one-time XLA compile work (a draft
    # model's first roll, the resilient sanitize program's first bad
    # step), seconds against a millisecond SLO; seeding the EWMA with
    # it would floor the degradation ladder at spec_off for dozens of
    # steps on a healthy engine, so that sample is discarded.
    self.itl_ewma_s = 0.0
    self._itl_primed = False

  # ------------------------------------------------------------ lifecycle

  def note_submitted(self, uid: Any, at: Optional[float] = None):
    """``at`` backdates the submit timestamp (same clock domain) — a
    MIGRATED request keeps its original submit time on the survivor, so
    its TTFT sample includes the pre-failover wait instead of hiding
    exactly the latency failover costs."""
    self._req[uid] = _RequestTrace(self._clock() if at is None else at)

  def note_admitted(self, uid: Any):
    tr = self._req.setdefault(uid, _RequestTrace(self._clock()))
    tr.admitted_at = self._clock()

  def note_first_token(self, uid: Any):
    tr = self._req.setdefault(uid, _RequestTrace(self._clock()))
    tr.first_token_at = self._clock()
    self._ttft_res.add(tr.first_token_at - tr.submitted_at)

  def note_finished(self, uid: Any, new_tokens: int,
                    finish_reason: Optional[str] = None):
    tr = self._req.setdefault(uid, _RequestTrace(self._clock()))
    tr.finished_at = self._clock()
    tr.new_tokens = int(new_tokens)
    if tr.first_token_at is not None and tr.new_tokens >= 2:
      # Per-request mean inter-token latency; single-token requests
      # have no inter-token gap.
      self._itl_res.add((tr.finished_at - tr.first_token_at)
                        / (tr.new_tokens - 1))
    self.finished_requests += 1
    self.generated_tokens += int(new_tokens)
    if finish_reason is not None:
      self.finish_reasons[finish_reason] = (
          self.finish_reasons.get(finish_reason, 0) + 1)
    if self.finished_limit > 0:
      # Aggregate counters above keep the full history; only the
      # per-request traces (latency percentile inputs) are windowed.
      # pop-then-insert refreshes a reused uid's position (a stale
      # entry would otherwise make a later eviction a no-op and
      # transiently shrink the retained-trace window below the limit).
      self._finished_order.pop(uid, None)
      self._finished_order[uid] = None
      while len(self._finished_order) > self.finished_limit:
        oldest = next(iter(self._finished_order))
        del self._finished_order[oldest]
        self._req.pop(oldest, None)

  # ----------------------------------------------------------- resilience

  def note_shed(self, uid: Any):
    """Rejected at submit (never enters the request-trace map: a shed
    request has no lifecycle to time)."""
    self.shed_requests += 1
    self.finish_reasons["shed"] = self.finish_reasons.get("shed", 0) + 1

  def sync_bad_step_counters(self, counters: Dict[str, int]):
    """Adopt the engine's BadStepPolicy counters wholesale (single
    source of truth — maintaining a mirrored increment per event here
    would inevitably drift from the policy's own accounting)."""
    self.bad_steps = int(counters["bad_steps"])
    self.step_retries = int(counters["step_retries"])
    self.requeues = int(counters["requeues"])

  def note_blocks(self, free: int, used: int, fragmentation: float,
                  preemptions: int, proactive_preemptions: int = 0):
    """Paged block-pool gauges, fed per step by the paged engine
    (last-write-wins: these are levels, not counters — except the two
    preemption totals, which the scheduler accumulates:
    pool-exhaustion evictions and eager latency-class admission
    evictions respectively)."""
    self.kv_blocks_free = int(free)
    self.kv_blocks_used = int(used)
    self.kv_fragmentation = float(fragmentation)
    self.preemptions = int(preemptions)
    self.proactive_preemptions = int(proactive_preemptions)

  def note_prefix(self, hits: int, misses: int, blocks_reused: int,
                  evictions: int, cached_blocks: int = 0):
    """Prefix-cache counters, fed per step by a prefix-caching paged
    engine (serving/prefix_cache.py).  Same last-write-wins discipline
    as :meth:`note_blocks`: the scheduler's radix tree accumulates the
    totals; ``cached_blocks`` is a level (current tree footprint)."""
    self.prefix_hits = int(hits)
    self.prefix_misses = int(misses)
    self.prefix_blocks_reused = int(blocks_reused)
    self.prefix_evictions = int(evictions)
    self.prefix_cached_blocks = int(cached_blocks)

  def note_degraded(self, level: int):
    self.degraded_transitions += 1
    self.degraded_level = int(level)

  def note_watchdog_timeout(self):
    self.watchdog_timeouts += 1

  def note_recompile(self, n: int = 1):
    """Unexpected fused-step recompile(s) flagged by the compile
    sentinel (observability/slo.py) — a first-class incident counter,
    not a gauge."""
    self.recompiles += int(n)

  # ----------------------------------------------------------------- step

  def note_step(self, active_slots: int, num_slots: int,
                prefill_tokens: int, decode_tokens: int,
                step_time_s: float, drafted_tokens: int = 0,
                accepted_tokens: int = 0):
    self.steps += 1
    self.busy_time_s += step_time_s
    self.prefill_tokens += prefill_tokens
    self.decode_tokens += decode_tokens
    self._occupancy_sum += active_slots / max(num_slots, 1)
    if decode_tokens > 0:
      # Live EXPERIENCED-ITL proxy: a decoding request waits the whole
      # step (prefill share included — mixed steps genuinely delay its
      # next token; a prefill-only step says nothing and is skipped).
      # A speculative step hands each decoding request ~(decode+
      # accepted)/decode tokens at once, so the per-token gap is the
      # step time scaled down by that factor — without it one K+1-token
      # step would read as one token gap and overstate ITL by up to
      # (K+1)x, pinning the degradation ladder's SLO signal high.
      committed = decode_tokens + max(int(accepted_tokens), 0)
      sample = step_time_s * decode_tokens / committed
      if not self._itl_primed:
        self._itl_primed = True   # compile-polluted; see itl_ewma_s init
      else:
        self.itl_ewma_s = (sample if self.itl_ewma_s == 0.0
                           else 0.8 * self.itl_ewma_s + 0.2 * sample)
    if drafted_tokens > 0:
      self.drafted_tokens += int(drafted_tokens)
      self.accepted_tokens += int(accepted_tokens)
      self._accepted_per_step.append(float(accepted_tokens))

  # -------------------------------------------------------------- rollup

  def _ttfts(self) -> List[float]:
    return self._ttft_res.items

  def _itls(self) -> List[float]:
    return self._itl_res.items

  def ttft_samples(self) -> List[float]:
    """Raw per-request TTFT samples — the fleet rollup
    (:func:`fleet_summary`) merges RAW samples across replicas, because
    percentiles of percentiles are not percentiles.  Capped at
    ``sample_limit`` by deterministic reservoir sampling (class
    docstring), so the merge stays bounded no matter how long the
    replica has served."""
    return list(self._ttft_res.items)

  def itl_samples(self) -> List[float]:
    """Raw per-request mean-ITL samples (see :meth:`ttft_samples`)."""
    return list(self._itl_res.items)

  def publish(self, registry, step: int):
    """Publish :meth:`summary` under ``serving/*`` through a
    MetricRegistry (observability/registry.py) — the engine calls this
    when it finishes a ``run()`` drive with a registry attached."""
    registry.publish(step, self.summary(), "serving")

  # ----------------------------------------------------- wire round trip

  _STATE_SCALARS = (
      "steps", "busy_time_s", "prefill_tokens", "decode_tokens",
      "finished_requests", "generated_tokens", "drafted_tokens",
      "accepted_tokens", "shed_requests", "requeues", "bad_steps",
      "step_retries", "degraded_transitions", "degraded_level",
      "watchdog_timeouts", "recompiles", "kv_blocks_free",
      "kv_blocks_used", "kv_fragmentation", "preemptions",
      "proactive_preemptions", "prefix_hits", "prefix_misses",
      "prefix_blocks_reused", "prefix_evictions",
      "prefix_cached_blocks", "itl_ewma_s")

  def state_dict(self) -> Dict[str, Any]:
    """JSON-serializable rollup state: every aggregate counter plus the
    RAW latency/acceptance samples the fleet rollup re-ranks.  This is
    how a process-hosted replica's stats cross the wire
    (serving/transport.py): the parent loads the dict into a twin via
    :meth:`load_state` and :func:`fleet_summary` merges it exactly like
    an in-process replica's.  Per-request in-flight traces stay local —
    only resolved aggregates travel."""
    state: Dict[str, Any] = {k: getattr(self, k)
                             for k in self._STATE_SCALARS}
    state["occupancy_sum"] = float(self._occupancy_sum)
    state["accepted_per_step"] = list(self._accepted_per_step)
    state["finish_reasons"] = dict(self.finish_reasons)
    state["ttft_samples"] = self.ttft_samples()
    state["itl_samples"] = self.itl_samples()
    return state

  def load_state(self, state: Dict[str, Any]) -> None:
    """Adopt a :meth:`state_dict` wholesale (resets first).  The
    reservoirs are refilled in sample order — at or below the cap the
    contents are identical to the source's, which is all the rollup
    reads."""
    self.reset()
    for k in self._STATE_SCALARS:
      if k in state:
        setattr(self, k, type(getattr(self, k))(state[k]))
    self._occupancy_sum = float(state.get("occupancy_sum", 0.0))
    self._accepted_per_step = [float(x) for x in
                               state.get("accepted_per_step", ())]
    self.finish_reasons = {str(k): int(v) for k, v in
                           (state.get("finish_reasons") or {}).items()}
    for x in state.get("ttft_samples", ()):
      self._ttft_res.add(float(x))
    for x in state.get("itl_samples", ()):
      self._itl_res.add(float(x))

  def summary(self) -> Dict[str, float]:
    ttfts, itls = self._ttfts(), self._itls()
    busy = max(self.busy_time_s, 1e-9)
    acc = self._accepted_per_step
    return {
        "steps": float(self.steps),
        "finished_requests": float(self.finished_requests),
        "generated_tokens": float(self.generated_tokens),
        "tokens_per_s": self.generated_tokens / busy,
        "prefill_tokens_per_s": self.prefill_tokens / busy,
        "ttft_p50_s": percentile(ttfts, 50),
        "ttft_p99_s": percentile(ttfts, 99),
        "itl_mean_s": (sum(itls) / len(itls)) if itls else 0.0,
        "itl_p50_s": percentile(itls, 50),
        "itl_p99_s": percentile(itls, 99),
        "slot_occupancy_mean": (self._occupancy_sum / self.steps
                                if self.steps else 0.0),
        # Speculation (all 0.0 on a non-speculative engine): drafted vs
        # accepted totals, overall acceptance rate, and accepted-per-
        # step percentiles over the steps that drafted.
        "drafted_tokens": float(self.drafted_tokens),
        "accepted_tokens": float(self.accepted_tokens),
        "acceptance_rate": (self.accepted_tokens / self.drafted_tokens
                            if self.drafted_tokens else 0.0),
        "accepted_per_step_mean": (sum(acc) / len(acc)) if acc else 0.0,
        "accepted_per_step_p50": percentile(acc, 50),
        "accepted_per_step_p99": percentile(acc, 99),
        # Paged block pool (all 0.0 on a contiguous engine; docs/
        # serving.md "Paged KV cache").
        "kv_blocks_free": float(self.kv_blocks_free),
        "kv_blocks_used": float(self.kv_blocks_used),
        "kv_fragmentation": float(self.kv_fragmentation),
        "preemptions": float(self.preemptions),
        "proactive_preemptions": float(self.proactive_preemptions),
        # Prefix cache (all 0.0 without serving.prefix_cache; docs/
        # serving.md "Prefix caching").  Hit rate is per ADMISSION, not
        # per block — the signal an operator tunes TTL/budget against.
        "prefix_hits": float(self.prefix_hits),
        "prefix_misses": float(self.prefix_misses),
        "prefix_blocks_reused": float(self.prefix_blocks_reused),
        "prefix_evictions": float(self.prefix_evictions),
        "prefix_cached_blocks": float(self.prefix_cached_blocks),
        "prefix_hit_rate": (
            self.prefix_hits / (self.prefix_hits + self.prefix_misses)
            if (self.prefix_hits + self.prefix_misses) else 0.0),
        # Resilience (all 0.0 on a non-resilient engine; docs/
        # robustness.md "Serving resilience").
        "shed": float(self.shed_requests),
        "deadline_expired": float(self.finish_reasons.get("deadline", 0)),
        "cancelled": float(self.finish_reasons.get("cancelled", 0)),
        "failed": float(self.finish_reasons.get("failed", 0)),
        "bad_steps": float(self.bad_steps),
        "step_retries": float(self.step_retries),
        "requeues": float(self.requeues),
        "degraded": float(self.degraded_transitions),
        "degraded_level": float(self.degraded_level),
        "watchdog_timeouts": float(self.watchdog_timeouts),
        "recompiles": float(self.recompiles),
        "itl_ewma_s": float(self.itl_ewma_s),
    }


def fleet_summary(replica_stats: List["ServingStats"],
                  router_counters: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
  """Fleet-level rollup over N replicas' :class:`ServingStats` — ONE
  record for the whole serving deployment (serving/router.py publishes
  it under the ``serving/fleet/*`` registry namespace; docs/serving.md
  "Multi-replica serving").

  Merge rules, per metric kind:

  * **rates** (tokens/s) sum — replicas serve concurrently, so fleet
    throughput is the sum of per-replica throughput, NOT total tokens
    over summed busy time (which would read as a mean);
  * **latency percentiles** (TTFT/ITL) re-rank over the replicas' RAW
    per-request samples — percentiles of per-replica percentiles are
    not percentiles;
  * **counters** (tokens, requests, shed, retries, preemptions...) sum;
  * **occupancy** weights each replica's mean by its step count.

  ``router_counters`` (failovers, migrated requests, per-state replica
  counts, router-level sheds) merge in verbatim — the router owns
  those; a request that failed over finished on exactly ONE replica, so
  summed finish counters stay double-count-free."""
  stats = list(replica_stats)
  ttfts: List[float] = []
  itls: List[float] = []
  for s in stats:
    ttfts.extend(s.ttft_samples())
    itls.extend(s.itl_samples())
  steps = sum(s.steps for s in stats)
  occ = (sum(s._occupancy_sum for s in stats) / steps) if steps else 0.0
  drafted = sum(s.drafted_tokens for s in stats)
  accepted = sum(s.accepted_tokens for s in stats)
  out = {
      "replicas": float(len(stats)),
      "steps": float(steps),
      "finished_requests": float(
          sum(s.finished_requests for s in stats)),
      "generated_tokens": float(sum(s.generated_tokens for s in stats)),
      "tokens_per_s": sum(
          s.generated_tokens / max(s.busy_time_s, 1e-9) for s in stats),
      "ttft_p50_s": percentile(ttfts, 50),
      "ttft_p99_s": percentile(ttfts, 99),
      "itl_mean_s": (sum(itls) / len(itls)) if itls else 0.0,
      "itl_p50_s": percentile(itls, 50),
      "itl_p99_s": percentile(itls, 99),
      "slot_occupancy_mean": occ,
      "drafted_tokens": float(drafted),
      "accepted_tokens": float(accepted),
      "acceptance_rate": (accepted / drafted) if drafted else 0.0,
      "shed": float(sum(s.shed_requests for s in stats)),
      "deadline_expired": float(
          sum(s.finish_reasons.get("deadline", 0) for s in stats)),
      "cancelled": float(
          sum(s.finish_reasons.get("cancelled", 0) for s in stats)),
      "failed": float(
          sum(s.finish_reasons.get("failed", 0) for s in stats)),
      "bad_steps": float(sum(s.bad_steps for s in stats)),
      "step_retries": float(sum(s.step_retries for s in stats)),
      "requeues": float(sum(s.requeues for s in stats)),
      "preemptions": float(sum(s.preemptions for s in stats)),
      "proactive_preemptions": float(
          sum(s.proactive_preemptions for s in stats)),
      # Prefix cache: counters sum; the fleet hit rate re-derives from
      # the summed counters (a mean of per-replica rates would weight
      # an idle replica equally with a loaded one).
      "prefix_hits": float(sum(s.prefix_hits for s in stats)),
      "prefix_misses": float(sum(s.prefix_misses for s in stats)),
      "prefix_blocks_reused": float(
          sum(s.prefix_blocks_reused for s in stats)),
      "prefix_evictions": float(sum(s.prefix_evictions for s in stats)),
      "prefix_hit_rate": (
          sum(s.prefix_hits for s in stats)
          / max(1, sum(s.prefix_hits + s.prefix_misses for s in stats))),
      "degraded": float(sum(s.degraded_transitions for s in stats)),
      "watchdog_timeouts": float(
          sum(s.watchdog_timeouts for s in stats)),
      "recompiles": float(sum(s.recompiles for s in stats)),
  }
  if router_counters:
    out.update({k: float(v) for k, v in router_counters.items()})
  return out
