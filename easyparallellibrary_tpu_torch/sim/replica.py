"""A cost-card replica: the real serving policy stack over a modeled
device step (port of ``easyparallellibrary_tpu/sim/replica.py``).

:class:`SimReplica` IS the replica the router drives in a simulated
fleet — same duck surface as ``serving.replica.EngineReplica`` — but
where the real replica launches its device step, this one
charges a :class:`CostModel` price and commits fabricated tokens.
Everything that makes policy decisions is the REAL object, unmodified:

* ``FCFSScheduler`` — admission, chunked prefill, retirement;
* ``AdmissionController`` — the degradation ladder + shed gate;
* ``EngineAutotuner`` — the breach-driven knob ladder (this class is
  its duck "engine": ``scheduler`` / ``chunk`` / ``_twin_label`` /
  ``_admission`` / ``_track_prefix`` are the attributes it reads);
* ``ServingStats`` — counters/EWMAs on the SIM clock;
* the ambient ``SLOMonitor`` via the same per-step registry records.

Why fabricated tokens are sound: with ``itl_slo_s = 0`` (the fleet
chaos-drill config) every actuation signal in the stack is count- or
clock-driven — queue depth, shed/finished cumulative counters, breach
windows over per-step records, cooldowns on the injected clock.
Length-based retirement (``stop_token = -1``) fixes each request's
step count from (plen, chunk, max_new) alone.  Token VALUES influence
nothing, so committing zeros preserves the actuation sequence exactly
— which is what the golden replay asserts against a recorded
real-fleet episode (sim/replay.py).

The step/submit paths below mirror ``serving.engine.
ContinuousBatchingEngine`` ORDER faithfully (autotuner first, observe
after plan, idle path returns without publishing, 50-step stats
rollup) because the autotuner's hold windows and the burn rules'
record windows count those exact calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.observability import slo as slo_lib
from easyparallellibrary_tpu_torch.observability.registry import (
    SERVING_NAMESPACE, MetricRegistry)
from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
from easyparallellibrary_tpu_torch.serving.replica import _ReplicaRegistry
from easyparallellibrary_tpu_torch.serving.resilience import (
    AdmissionController, BadStepPolicy)
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FCFSScheduler, FinishedRequest, Request)
from easyparallellibrary_tpu_torch.utils import vclock

# Stats rollup cadence — MUST track serving/engine.py
# _STATS_PUBLISH_EVERY: percentile rollups are registry records the SLO
# monitor sees, so a different cadence would change breach timing
# between real and simulated episodes.
_STATS_PUBLISH_EVERY = 50

# Fallback per-token device cost when BENCH_EVIDENCE.json holds no
# hardware decode_throughput record taken on an NVIDIA card: 260.8
# generated tokens/s, the port's GPT-350M paged engine under
# chip_smoke.py phase 5's staggered load (16 requests, 8 slots, bf16)
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit.
_DEFAULT_TOKEN_COST_S = 1.0 / 260.8

# A calibration record must name the card it was taken on: a TPU's or a
# CPU's decode rate is not this port's cost.
_CARD_VENDOR = "nvidia"


@dataclasses.dataclass
class CostModel:
  """Linear step-time physics calibrated from measured evidence.

  ``step_time = overhead + prefill_tokens * pf + decode_tokens * dc``
  — the first-order shape of the fused step (token-proportional
  matmuls over a fixed dispatch floor).  Prefill and decode tokens
  default to the SAME per-token price because both flow through the
  same fused program; the config can split them when a finer card is
  measured (``sim.prefill_token_cost_s`` / ``sim.decode_token_cost_s``).
  """

  prefill_token_cost_s: float
  decode_token_cost_s: float
  step_overhead_s: float
  source: str = "default"

  def step_time(self, prefill_tokens: int, decode_tokens: int) -> float:
    return (self.step_overhead_s
            + prefill_tokens * self.prefill_token_cost_s
            + decode_tokens * self.decode_token_cost_s)

  @classmethod
  def calibrate(cls, path: Optional[str] = None,
                step_overhead_s: float = 5e-5) -> "CostModel":
    """Per-token cost from the most recent HARDWARE decode_throughput
    record in BENCH_EVIDENCE.json whose ``device_kind`` names an NVIDIA
    card.  Sim-provenance records are refused (a simulator calibrated
    on its own output would be circular), and so is a record of a TPU,
    a CPU or an unnamed device: its rate is not the card's."""
    from easyparallellibrary_tpu_torch.utils import bench_evidence
    recs = [r for r in bench_evidence.load_records(path)
            if r.get("metric") == "decode_throughput"
            and r.get("provenance", "hardware") == "hardware"
            and _CARD_VENDOR in str(r.get("device_kind") or "").lower()]
    if not recs:
      return cls(_DEFAULT_TOKEN_COST_S, _DEFAULT_TOKEN_COST_S,
                 step_overhead_s, source="default")
    rec = max(recs, key=lambda r: r.get("unix_time", 0))
    tps = None
    cont = rec.get("continuous")
    if isinstance(cont, dict):
      tps = cont.get("tokens_per_s")
    if tps is None:
      tps = rec.get("tokens_per_s") or rec.get("value")
    if not isinstance(tps, (int, float)) or tps <= 0:
      return cls(_DEFAULT_TOKEN_COST_S, _DEFAULT_TOKEN_COST_S,
                 step_overhead_s, source="default")
    per_tok = 1.0 / float(tps)
    return cls(per_tok, per_tok, step_overhead_s,
               source=f"decode_throughput@{rec.get('unix_time', 0):.0f}")

  @classmethod
  def from_config(cls, config=None) -> "CostModel":
    """``sim.*`` costs when set (> 0), else evidence calibration."""
    root = config if config is not None else Env.get().config
    sconf = root.sim
    if sconf.prefill_token_cost_s > 0 and sconf.decode_token_cost_s > 0:
      return cls(sconf.prefill_token_cost_s, sconf.decode_token_cost_s,
                 sconf.step_overhead_s, source="config")
    base = cls.calibrate(step_overhead_s=sconf.step_overhead_s)
    if sconf.prefill_token_cost_s > 0:
      base.prefill_token_cost_s = sconf.prefill_token_cost_s
      base.source += "+config"
    if sconf.decode_token_cost_s > 0:
      base.decode_token_cost_s = sconf.decode_token_cost_s
      base.source += "+config"
    return base


class SimReplicaDead(RuntimeError):
  """Raised by a killed replica's step() — the router's mark-down +
  failover path sees exactly what a crashed worker produces."""


class SimReplica:
  """One simulated fleet member (see module docstring).

  Duck surfaces:
  * router replica: submit/cancel/step/has_work/finished/queue_depth/
    num_active/num_slots/load/stats/watchdog_timeouts/bad_steps/
    itl_ewma_s/checkpoint_version/snapshot_requests/restore_request/
    evacuate/close
  * autotuner engine: scheduler/chunk/_twin_label/_admission/
    _track_prefix
  """

  def __init__(self, index: int, *, config=None, registry=None,
               clock=None, cost: Optional[CostModel] = None,
               num_slots: Optional[int] = None,
               prefill_chunk: Optional[int] = None,
               max_seq_len: int = 512,
               checkpoint_version: int = 0):
    root = config if config is not None else Env.get().config
    conf = root.serving
    self.index = index
    self.clock = clock if clock is not None else vclock.monotonic
    self.cost = cost if cost is not None else CostModel.from_config(root)
    self._track_prefix = f"serving/replica{index}"
    self._twin_label = f"{self._track_prefix}/fused_step"
    self.checkpoint_version = int(checkpoint_version)
    self.num_slots = (num_slots if num_slots is not None
                      else conf.num_slots)
    self.chunk = (prefill_chunk if prefill_chunk is not None
                  else conf.prefill_chunk)
    self._slo = slo_lib.ensure_configured(root)
    self.scheduler = FCFSScheduler(
        num_slots=self.num_slots, prefill_chunk=self.chunk,
        max_seq_len=max_seq_len,
        prefill_token_budget=conf.prefill_token_budget,
        max_batch=conf.max_batch, stop_token=conf.stop_token,
        clock=self.clock, track_prefix=self._track_prefix,
        checkpoint_version=self.checkpoint_version)
    self.stats = ServingStats(clock=self.clock,
                              finished_limit=conf.finished_limit)
    self.registry = (_ReplicaRegistry(registry, index)
                     if registry is not None else None)
    self.finished: Dict[Any, FinishedRequest] = {}
    self._finished_limit = conf.finished_limit
    self.scheduler.on_finish.append(self._record_finished)
    stats_obj = self.stats
    self.scheduler.on_admit.append(stats_obj.note_admitted)
    self.scheduler.on_first_token.append(stats_obj.note_first_token)
    self.scheduler.on_finish.append(
        lambda fin: stats_obj.note_finished(fin.uid, fin.new_tokens,
                                            fin.finish_reason))
    res_conf = root.serving.resilience
    self._resilient = res_conf.enabled
    self._admission: Optional[AdmissionController] = None
    self._bad_policy: Optional[BadStepPolicy] = None
    if self._resilient:
      self._admission = AdmissionController(
          queue_limit=res_conf.queue_limit,
          itl_slo_s=res_conf.itl_slo_s,
          degrade_queue_frac=res_conf.degrade_queue_frac,
          on_transition=self._on_degrade_transition)
      self._bad_policy = BadStepPolicy(
          max_step_retries=res_conf.max_step_retries,
          max_requeues=res_conf.max_requeues)
    if self._slo is not None and self.registry is not None:
      self._slo.attach(self.registry)
    self._autotuner = None
    if conf.autotune.enabled:
      from easyparallellibrary_tpu_torch.serving.autotune import EngineAutotuner
      self._autotuner = EngineAutotuner(self, self._slo, config=root)
    self._steps = 0      # non-idle engine steps (publish index)
    self.steps = 0       # every step() call (replica heartbeat count)
    # Fault state (sim/faults.py drives these)
    self._dead = False
    self._stall_s = 0.0
    # Last step's modeled device time — the fleet loop's dt source.
    self.last_step_cost = 0.0

  # ------------------------------------------------------------ faults

  def kill(self) -> None:
    """Next step() raises — the simulated SIGKILL."""
    self._dead = True

  def revive(self) -> None:
    self._dead = False

  def stall(self, extra_s: float) -> None:
    """Charge the next non-idle step ``extra_s`` more (a straggler /
    preemption stall, not a crash)."""
    self._stall_s += float(extra_s)

  # ------------------------------------------------------- engine mirror

  def _on_degrade_transition(self, old: int, new: int, signals) -> None:
    if self.stats is not None:
      self.stats.note_degraded(new)

  def _record_finished(self, fin: FinishedRequest) -> None:
    # pop first — mirrors engine._record_finished's reused-uid rule.
    self.finished.pop(fin.uid, None)
    self.finished[fin.uid] = fin
    if self._finished_limit > 0:
      while len(self.finished) > self._finished_limit:
        self.finished.pop(next(iter(self.finished)))

  def _apply_degradation(self) -> None:
    itl = self.stats.itl_ewma_s if self.stats is not None else 0.0
    cap = min(self.num_slots, self.scheduler.effective_max_batch)
    self._admission.observe(
        self.scheduler.queue_depth,
        self.scheduler.num_active / cap, itl)
    self.scheduler.spec_enabled = self._admission.speculation_enabled
    self.scheduler.budget_override = (
        self.chunk if self._admission.budget_tightened else 0)

  def submit(self, request: Request) -> bool:
    prompt = self.scheduler.validate(request)
    if self._admission is not None and not self.scheduler.has_work:
      self._apply_degradation()
    if (self._admission is not None
        and self._admission.should_shed(self.scheduler.queue_depth)):
      self._admission.note_shed()
      fin = FinishedRequest(uid=request.uid, tokens=prompt,
                            new_tokens=0, finish_reason="shed")
      self._record_finished(fin)
      if self.stats is not None:
        self.stats.note_shed(request.uid)
      return False
    if self.stats is not None:
      self.stats.note_submitted(request.uid)
    self.scheduler.submit(request, _prompt=prompt)
    return True

  def cancel(self, uid: Any) -> bool:
    return self.scheduler.cancel(uid)

  def step(self) -> List[FinishedRequest]:
    """One simulated engine iteration — the exact call/publish order of
    ``ContinuousBatchingEngine.step`` with the device dispatch replaced
    by a cost charge."""
    if self._dead:
      raise SimReplicaDead(f"replica {self.index} is down (sim fault)")
    if self._autotuner is not None:
      self._autotuner.on_step(self._steps)
    plan = self.scheduler.plan_step()
    if self._admission is not None:
      self._apply_degradation()
    self.steps += 1
    if plan is None:
      self.last_step_cost = 0.0
      return self.scheduler.take_finished()
    dt = self.cost.step_time(plan.prefill_tokens, plan.decode_tokens)
    if self._stall_s > 0:
      dt += self._stall_s
      self._stall_s = 0.0
    self.last_step_cost = dt
    # The fabricated device output: one token per slot.  Values are
    # irrelevant under length-based retirement (module docstring).
    nxt = np.zeros((self.num_slots,), np.int32)
    finished = self.scheduler.commit(nxt, slot_ok=None)
    self._steps += 1
    pf_tokens, dc_tokens = plan.prefill_tokens, plan.decode_tokens
    if self.stats is not None:
      self.stats.note_step(
          active_slots=plan.active_slots, num_slots=self.num_slots,
          prefill_tokens=pf_tokens, decode_tokens=dc_tokens,
          step_time_s=dt)
    if self.registry is not None or self._slo is not None:
      record = {
          "active_slots": plan.active_slots,
          "slot_occupancy": plan.active_slots / self.num_slots,
          "prefill_tokens": pf_tokens,
          "decode_tokens": dc_tokens,
          "step_time_s": dt,
      }
      if self._resilient:
        record["queue_depth"] = self.scheduler.queue_depth
        record["degraded_level"] = self._admission.level
        record["shed"] = self._admission.shed_total
        record.update(self._bad_policy.counters())
        if self.stats is not None:
          record["finished_requests"] = float(
              self.stats.finished_requests)
      if self._autotuner is not None:
        record["autotune_level"] = self._autotuner.level
        record["autotune_actuations"] = self._autotuner.actuations
      if self.registry is not None:
        self.registry.publish(self._steps, record, "serving")
      elif self._slo is not None:
        self._slo.observe(
            self._steps,
            MetricRegistry.namespaced(SERVING_NAMESPACE, record))
    if (self.stats is not None
        and self._steps % _STATS_PUBLISH_EVERY == 0
        and (self.registry is not None or self._slo is not None)):
      if self.registry is not None:
        self.stats.publish(self.registry, self._steps)
      else:
        self._slo.observe(
            self._steps,
            MetricRegistry.namespaced(SERVING_NAMESPACE,
                                      self.stats.summary()))
    return finished

  # ------------------------------------------------------ replica surface

  @property
  def has_work(self) -> bool:
    return self.scheduler.has_work

  @property
  def queue_depth(self) -> int:
    return self.scheduler.queue_depth

  @property
  def num_active(self) -> int:
    return self.scheduler.num_active

  @property
  def load(self) -> int:
    return self.num_active + self.queue_depth

  @property
  def watchdog_timeouts(self) -> int:
    return self.stats.watchdog_timeouts if self.stats is not None else 0

  @property
  def bad_steps(self) -> int:
    return self.stats.bad_steps if self.stats is not None else 0

  @property
  def itl_ewma_s(self) -> float:
    return self.stats.itl_ewma_s if self.stats is not None else 0.0

  # ---------------------------------------------------------- migration

  def snapshot_requests(self) -> List[Dict[str, Any]]:
    return self.scheduler.snapshot_requests()

  def restore_request(self, snap: Dict[str, Any],
                      front: bool = False) -> Any:
    uid = self.scheduler.restore_request(snap, front=front)
    if self.stats is not None:
      self.stats.note_submitted(uid, at=snap.get("submitted_at"))
    return uid

  def evacuate(self) -> List[Dict[str, Any]]:
    return self.scheduler.evacuate()

  def close(self) -> None:
    pass

  def __repr__(self):
    return (f"SimReplica({self.index}, active={self.num_active}, "
            f"queued={self.queue_depth}, "
            f"dead={self._dead})")
