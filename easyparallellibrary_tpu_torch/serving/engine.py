"""Continuous-batching inference engine (port of
``easyparallellibrary_tpu/serving/engine.py``), on two cache layouts.

One device step per iteration fuses the prefill chunks of newly admitted
requests and the one-token decodes of every other active slot:

* contiguous slots (the default, ``serving.paged.enabled = False``): one
  ``[num_slots, prefill_chunk]`` model call against the slot cache
  (``models.gpt.slot_step_logits``), each slot at its own cursor, which
  the step advances on the device; attention is plain PyTorch, as the
  JAX package's slot path is dense XLA;
* paged (``paged=True``): a single ``[token_budget]`` flat batch against
  the paged KV pool (``models.gpt.paged_step_logits``); each token is
  tagged with its slot and absolute position, and attends through its
  slot's block table — on the GPU with the hand-written CUDA kernel
  (``kernels/csrc/paged_attention.cu``), whose bf16 build takes the
  step's query tiles, planned here once per step from the scheduler's
  plan.

The step's input shapes never change: joins, leaves and block-table
reshuffles are data.  Every step goes through one replaceable callable,
``self._step_fn(params, plan[, num_draft])``, which the chaos injectors
of ``testing/chaos.py`` wrap.

:class:`FCFSScheduler` owns all host-side variability (admission,
budgets, preemption, retirement); this module owns the device step.
Sampling runs per slot (:func:`sample_token_slots`) with each request's
counter key folded by its token index, so a request's samples do not
depend on which slot or iteration serves it.  PyTorch runs eagerly, so
the step is written out directly (the JAX package jits it) and the
caches are written in place (the JAX package donates them).  The step
makes one designated device-to-host fetch: the sampled tokens (and,
with resilience on, each slot's verdict beside them).

Speculative decoding (``speculative=True``, ``drafter=``, or
``serving.speculative.*``; serving/speculative/) rides the same step:
drafts take a decode slot's unused chunk columns (contiguous) or the
leftover flat positions the scheduler reserved (paged), the one model
call scores them, and ``verify_tokens`` commits each slot's accepted
drafts plus one correction or bonus token.  Prefix caching
(``prefix_cache=True``, paged only; serving/prefix_cache.py) is the
scheduler's: warm admissions map shared blocks and prefill only the
tail.

Resilience (``resilience=True`` or ``serving.resilience.*``;
serving/resilience.py): the step also returns a per-slot finiteness
verdict on exactly the logit rows the commit consumes, computed on the
device and fetched with the tokens, and a bad slot's cursor does not
advance.  The host then replans: the retry re-feeds identical tokens,
a persistent offender is requeued with its committed prefix, a hopeless
one is failed, and the poisoned step's cache writes are zeroed
(:meth:`ContinuousBatchingEngine._handle_bad_slots`).  Overload is met
at submit (bounded queue, shedding) and by the degradation ladder
(speculation off, then the prefill budget clamped), and an optional
watchdog thread logs a step that overruns its deadline.

Observability (``observability.*``; observability/): the ambient tracer
records the step's phases (``serving/plan``, ``serving/draft``,
``serving/device_step`` around the dispatch and the one fetch,
``serving/commit``), each slot's ``prefill`` / ``decode`` /
``speculate`` span inside its request's lifecycle span, the lifecycle
instants and the counter tracks; every step publishes a ``serving/*``
record to ``metrics_writer`` / ``registry`` (the SLO monitor rides the
registry as a sink); the compile sentinel watches the loaded kernel
libraries; the device introspector captures the twin's cost card after
the first step and publishes HBM gauges on the stats cadence.  All of
it is host code on values the step already holds: a traced step makes
the same synchronising calls as an untraced one, and the same plans and
tokens.

Exactness contract: greedy engine output equals ``generate()`` per
request, including requests admitted mid-flight, slots and blocks reused
after retirement, requests preempted on pool exhaustion or requeued
after bad steps, speculative steps and warm admissions.

Migration (the router's failover and drain currency):
``snapshot_requests`` / ``restore_request`` / ``evacuate`` delegate to
the scheduler's prefix-replay snapshots; ``checkpoint_version`` names
the weights served, scoping the prefix tree and refusing a snapshot
pinned to other weights.

The autotuner (``serving.autotune.enabled``, serving/autotune.py)
moves the scheduler's clamps between steps, from SLO breaches.

Tensor parallelism (``mesh=`` with a ``model`` axis above 1).  The JAX
engine takes ``mesh=`` on one controller and GSPMD shards the one
program.  The port keeps that API on SPMD processes, one per rank of
the model group, each holding its shard of the weights and a K/V cache
of ``H / tp`` heads:

* rank 0 leads: it owns the scheduler, ``submit``, ``step`` and the
  streams, and each step broadcasts the step plan over the model group
  as one packed int32 buffer (tokens, slot ids, positions, validity,
  block tables and the fields the tile plan is made from; the slot
  layout's cursors follow as a second buffer);
* every other rank calls :meth:`ContinuousBatchingEngine.follow`, which
  receives each plan and runs the same model call on its shard
  (``paged_step_logits`` / ``slot_step_logits``) until the leader's
  ``close()``;
* the logits come back whole on every rank (an all-gather over the
  vocab shards) and rank 0 alone samples and commits;
* a draft model on the mesh proposes on every rank from the same
  pre-draft plan (its rollouts are greedy over whole logits, so every
  rank draws the same drafts); a bad step's cache zeroing is broadcast
  too.

The wall-clock features (SLO monitor, watchdog, autotune) act on rank 0
only, and no rank reaches a collective that the other skips.  A data
axis above 1 raises: replicas of a TP engine are the router's
(``serving/router.py``).
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.kernels import paged_attention as pa_lib
from easyparallellibrary_tpu_torch.observability import device as device_lib
from easyparallellibrary_tpu_torch.observability import slo as slo_lib
from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.observability.registry import (
    SERVING_NAMESPACE, MetricRegistry)
from easyparallellibrary_tpu_torch.profiler.flops import gpt_forward_flops
from easyparallellibrary_tpu_torch.runtime.amp import resolve_model_dtypes
from easyparallellibrary_tpu_torch.serving import kv_cache as kv_lib
from easyparallellibrary_tpu_torch.serving._capabilities import (
    check_draft_fits_chunk, check_servable)
from easyparallellibrary_tpu_torch.serving.resilience import (
    DEGRADE_LEVELS, AdmissionController, BadStepPolicy)
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FCFSScheduler, FinishedRequest, Request, _slot_track)
from easyparallellibrary_tpu_torch.utils import prng
from easyparallellibrary_tpu_torch.utils.device import resolve_device
from easyparallellibrary_tpu_torch.utils.logging import get_logger
from easyparallellibrary_tpu_torch.weights import (
    cast_for_compute, local_params)

# Periodic ServingStats rollup cadence (engine steps), as in the JAX
# engine: per-step records carry only step-local gauges, so the TTFT /
# ITL percentile SLO rules would otherwise see a rollup only at the end
# of a run() drive.  The HBM gauges ride the same cadence.
_STATS_PUBLISH_EVERY = 50

# Lockstep messages from the leader of a tensor-parallel engine.
_OP_STOP, _OP_STEP, _OP_PROPOSE, _OP_SANITIZE = 0, 1, 2, 3
_PAGED_FIELDS = ("tokens", "slot_ids", "positions", "valid", "block_tables",
                 "base_idx", "draft_base", "num_valid", "draft_cap")
_SLOT_FIELDS = ("tokens", "num_valid", "reset", "draft_cap")


def _check_mesh(mesh):
  """The engine's mesh: the ambient one (``epl.init`` + ``build_mesh``),
  whose model group carries the collectives, with no data axis."""
  from easyparallellibrary_tpu_torch.cluster import Mesh
  if not isinstance(mesh, Mesh):
    raise TypeError(f"mesh must be a cluster.Mesh (epl.init() then "
                    f"build_mesh()), got {type(mesh).__name__}")
  cluster = Env.get().cluster
  if cluster is None or cluster.built_mesh is not mesh:
    raise ValueError("the engine's mesh must be the ambient mesh "
                     "(Env.get().cluster.build_mesh()): the model's "
                     "collectives run over its groups")
  if mesh.axis_size(constants.DATA_AXIS) > 1:
    raise ValueError(
        f"a serving mesh with data={mesh.axis_size(constants.DATA_AXIS)}: "
        "the engine shards over the model axis only; replicate it with "
        "serving.router (one engine per replica)")
  return mesh


def filtered_logits(logits, temperature, top_k, top_p):
  """Per-row temperature / top-k / top-p filtering with per-row
  parameters (same filter semantics and order as ``sample_logits``).

  ``logits`` [M, V]; ``temperature``/``top_p`` f32 [M]; ``top_k`` int
  [M] (0 disables).  Returns the scaled, filtered logits (filtered
  entries at -1e30)."""
  V = logits.shape[-1]
  neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
  t = torch.where(temperature > 0, temperature,
                  torch.ones_like(temperature))[:, None]
  scaled = logits / t.to(logits.dtype)
  # top-k: threshold at the k-th largest value (ties at it survive).
  sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
  kth = torch.gather(sorted_desc, 1,
                     torch.clamp(top_k.long() - 1, 0, V - 1)[:, None])
  k_off = (top_k[:, None] <= 0) | (top_k[:, None] >= V)
  scaled = torch.where((scaled >= kth) | k_off, scaled, neg)
  # top-p over the survivors: keep entries whose preceding mass is < p.
  sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
  probs = torch.softmax(sorted_desc.float(), dim=-1)
  cum = torch.cumsum(probs, dim=-1)
  keep_sorted = (cum - probs) < top_p[:, None]
  inf = torch.tensor(float("inf"), dtype=scaled.dtype, device=scaled.device)
  thresh = torch.where(keep_sorted, sorted_desc, inf).min(
      dim=-1, keepdim=True).values
  p_on = top_p[:, None] < 1.0
  return torch.where(p_on & (scaled < thresh), neg, scaled)


def sample_token_slots(logits, keys, temperature, top_k, top_p):
  """Per-slot sampling with per-slot parameters; ``temperature<=0`` is
  greedy (the first maximum).  ``logits`` [N, V]; ``keys`` int64
  [N, 2] counter keys (already folded with each slot's token index).
  Returns int64 [N] token ids."""
  greedy = torch.argmax(logits, dim=-1)
  sampled = prng.categorical(keys, filtered_logits(logits, temperature,
                                                   top_k, top_p))
  return torch.where(temperature <= 0, greedy, sampled)


class ContinuousBatchingEngine:
  """Continuous-batching decode engine for a (non-pipelined) GPT.

  ``model`` is a ``models.gpt.GPT`` and ``params`` its state dict
  (``weights.init_params`` / ``weights.from_jax_params``); the engine
  keeps a copy cast to the compute dtype (the model config's, or amp
  O1's), and the KV cache, on ``device`` (default ``"cuda"``; ``"cpu"``
  must be asked for).  Knobs default from the port's ``Config``
  ``serving.*`` group; the default layout is the contiguous slot cache.

      eng = ContinuousBatchingEngine(model, params)
      eng.submit(Request(uid="a", prompt=ids, max_new_tokens=32))
      outputs = eng.run()          # {uid: prompt+generated np.int32}
      eng.finished["a"].finish_reason

  ``submit`` returns False when admission control sheds the request
  (``serving.resilience.queue_limit``); the record lands in
  ``finished`` with reason ``"shed"``.  ``drafter_failures`` counts the
  steps whose drafter raised (each ran without drafts).  ``close()`` (or
  ``with``, or garbage collection) stops the watchdog thread.
  ``metrics_writer`` (any ``write(step, record)`` sink) and ``registry``
  (``observability.registry.MetricRegistry``) receive the per-step
  ``serving/*`` records; ``track_prefix`` names this engine's Perfetto
  tracks (default ``"serving"``); ``checkpoint_version`` is the version
  of the weights served (0 before any rollout).  ``donate_cache`` is
  taken for the JAX package's signature and ignored: the port donates
  nothing, since the eager step writes the caches in place.
  """

  def __init__(self, model, params, *, device=None, mesh=None,
               num_slots: Optional[int] = None,
               prefill_chunk: Optional[int] = None,
               prefill_token_budget: Optional[int] = None,
               max_batch: Optional[int] = None,
               stop_token: Optional[int] = None,
               donate_cache: Optional[bool] = None,
               drafter=None, speculative: Optional[bool] = None,
               draft_model=None, draft_params=None,
               resilience: Optional[bool] = None,
               paged: Optional[bool] = None,
               block_size: Optional[int] = None,
               num_blocks: Optional[int] = None,
               token_budget: Optional[int] = None,
               prefix_cache: Optional[bool] = None,
               stats=None, metrics_writer=None, registry=None,
               config=None, track_prefix: Optional[str] = None,
               checkpoint_version: int = 0):
    cfg = model.cfg
    root_config = config if config is not None else Env.get().config
    conf = root_config.serving
    check_servable(cfg)
    self.mesh = None if mesh is None else _check_mesh(mesh)
    self._tp = 1 if mesh is None else mesh.axis_size(constants.MODEL_AXIS)
    self.is_leader = (mesh is None
                      or mesh.axis_index(constants.MODEL_AXIS) == 0)
    self._followers_stopped = False
    if mesh is not None:
      if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
      self.device = mesh.device
    else:
      self.device = resolve_device(device)
    # Reconcile the ambient tracer, SLO monitor and device introspector
    # with observability.*, so a config-enabled run traces and monitors
    # serving without any wiring at the call site (None = off; every
    # hook below is then an attribute test).
    trace_lib.ensure_configured(root_config)
    self._slo = slo_lib.ensure_configured(root_config)
    self._introspector = device_lib.ensure_configured(root_config)
    self._capture_device = root_config.observability.slo.capture_xla
    self._pending_device_dir: Optional[str] = None
    # This engine's Perfetto track namespace, and its twin label in
    # breach payloads: the exact-match key that routes engine-attributed
    # anomalies (recompile, watchdog) back to this engine alone.
    self._track_prefix = track_prefix or "serving"
    self._twin_label = f"{self._track_prefix}/fused_step"
    self.model = model
    # The dtype the model computes in (amp O1 resolves it at every
    # forward from the ambient config, as the JAX GPT does); the caches
    # stay in cfg.dtype.
    self.compute_dtype = resolve_model_dtypes(cfg).dtype
    self.params = cast_for_compute(
        {k: v.to(self.device)
         for k, v in local_params(model, params, mesh).items()},
        self.compute_dtype)
    self.num_slots = num_slots if num_slots is not None else conf.num_slots
    self.chunk = (prefill_chunk if prefill_chunk is not None
                  else conf.prefill_chunk)
    if self.chunk > cfg.max_seq_len:
      raise ValueError(f"prefill_chunk {self.chunk} exceeds max_seq_len "
                       f"{cfg.max_seq_len}")
    budget = (prefill_token_budget if prefill_token_budget is not None
              else conf.prefill_token_budget)
    if 0 < budget < self.chunk:
      raise ValueError(
          f"prefill_token_budget {budget} below prefill_chunk "
          f"{self.chunk}: no admission could ever afford its first chunk")
    pconf = conf.paged
    self.paged = paged if paged is not None else pconf.enabled
    if self.paged:
      self.block_size = (block_size if block_size is not None
                         else pconf.block_size)
      kv_lib.blocks_per_slot(cfg, self.block_size)
      self.num_blocks = (num_blocks if num_blocks is not None
                         else pconf.num_blocks)
      if self.num_blocks <= 0:
        self.num_blocks = kv_lib.default_num_blocks(cfg, self.num_slots,
                                                    self.block_size)
      self.token_budget = (token_budget if token_budget is not None
                           else pconf.token_budget)
      if self.token_budget <= 0:
        # Auto: every decode slot's guaranteed token plus two prefill
        # chunks of admission headroom per step.
        self.token_budget = self.num_slots + 2 * self.chunk
    else:
      self.block_size = self.num_blocks = self.token_budget = 0
    pc_conf = conf.prefix_cache
    self.prefix_caching = (prefix_cache if prefix_cache is not None
                           else pc_conf.enabled)
    self.drafter = self._resolve_drafter(conf, drafter, speculative,
                                         draft_model, draft_params)
    self.drafter_failures = 0
    self.checkpoint_version = int(checkpoint_version)
    self.scheduler = FCFSScheduler(
        num_slots=self.num_slots, prefill_chunk=self.chunk,
        max_seq_len=cfg.max_seq_len, prefill_token_budget=budget,
        max_batch=max_batch if max_batch is not None else conf.max_batch,
        stop_token=stop_token if stop_token is not None
        else conf.stop_token,
        spec_k=self.drafter.k if self.drafter is not None else 0,
        block_size=self.block_size, num_blocks=self.num_blocks,
        token_budget=self.token_budget, track_prefix=self._track_prefix,
        prefix_cache=self.prefix_caching,
        prefix_session_ttl_s=pc_conf.session_ttl_s,
        prefix_max_cached_blocks=pc_conf.max_cached_blocks,
        checkpoint_version=self.checkpoint_version)
    res_conf = conf.resilience
    self._resilient = bool(resilience if resilience is not None
                           else res_conf.enabled)
    self.stats = stats
    if self._resilient and self.stats is None:
      # The degradation ladder reads the measured ITL from ServingStats.
      from easyparallellibrary_tpu_torch.profiler.serving import (
          ServingStats)
      self.stats = ServingStats(finished_limit=conf.finished_limit)
    self.metrics_writer = metrics_writer
    self.registry = registry
    self.finished: Dict[Any, FinishedRequest] = {}
    self._finished_limit = conf.finished_limit
    self.scheduler.on_finish.append(self._record_finished)
    if self.stats is not None:
      stats_obj = self.stats
      self.scheduler.on_admit.append(stats_obj.note_admitted)
      self.scheduler.on_first_token.append(stats_obj.note_first_token)
      self.scheduler.on_finish.append(
          lambda fin: stats_obj.note_finished(fin.uid, fin.new_tokens,
                                              fin.finish_reason))
    self._admission: Optional[AdmissionController] = None
    self._bad_policy: Optional[BadStepPolicy] = None
    self._watchdog = None
    if self._resilient:
      self._admission = AdmissionController(
          queue_limit=res_conf.queue_limit, itl_slo_s=res_conf.itl_slo_s,
          degrade_queue_frac=res_conf.degrade_queue_frac,
          on_transition=self._on_degrade_transition)
      self._bad_policy = BadStepPolicy(
          max_step_retries=res_conf.max_step_retries,
          max_requeues=res_conf.max_requeues)
      if res_conf.step_timeout_s > 0:
        from easyparallellibrary_tpu_torch.runtime.resilience import (
            StepWatchdog)
        # on_timeout binds the stats and monitor objects, not the
        # engine: the finalizer below holds the watchdog, and a
        # watchdog -> engine reference would keep the engine alive.  The
        # monitor raises the hang as a first-class SLO breach (and deep
        # captures) from the watchdog's thread; both are thread-safe.
        stats_obj = self.stats

        def _on_timeout(step, _stats=stats_obj, _slo=self._slo,
                        _twin=self._twin_label):
          _stats.note_watchdog_timeout()
          if _slo is not None:
            _slo.note_event("watchdog_timeout",
                            {"engine_step": int(step), "twin": _twin},
                            step=int(step))

        self._watchdog = StepWatchdog(
            res_conf.step_timeout_s, on_timeout=_on_timeout,
            knob="serving.resilience.step_timeout_s")
        # The monitor thread pins the watchdog, never the engine: a
        # discarded engine closes it when collected, so no
        # epl-step-watchdog thread outlives its engine.
        self._watchdog_finalizer = weakref.finalize(
            self, self._watchdog.close)
    if self.paged:
      self._kv = kv_lib.allocate_paged_kv_cache(
          cfg, self.num_blocks, self.block_size, self.device)
      self._cursors = None
    else:
      self._kv, self._cursors = kv_lib.allocate_kv_cache(
          cfg, self.num_slots, self.chunk, self.device)
    # Perfetto track per slot (the scheduler's lifecycle spans and the
    # per-step spans share it), precomputed for the per-step loop.
    self._slot_tracks = [_slot_track(i, self._track_prefix)
                         for i in range(self.num_slots)]
    if self.drafter is not None:
      self.drafter.bind(self)
      self._step_fn = (self._paged_spec_step if self.paged
                       else self._slot_spec_step)
    else:
      self._step_fn = self._paged_step if self.paged else self._slot_step
    if self._tp > 1:
      self._shapes = self._field_shapes(cfg)
      rows = self.num_blocks if self.paged else self.num_slots
      self._packet_len = 1 + max(
          sum(int(np.prod(v)) for v in self._shapes.values()), 2 * rows)
      if self.is_leader:
        inner = self._step_fn

        def lockstep(params, plan, *rest):
          self._send(_OP_STEP, plan)
          return inner(params, plan, *rest)

        self._step_fn = lockstep
    self._steps = 0
    # Always-on compile sentinel: the GPU counterpart of a mid-serving
    # recompile is a kernel library built or loaded for the first time
    # mid-run (tens of seconds of nvcc).  The warmup count is taken at
    # the end of the first step (earlier work may have loaded libraries
    # already); any later growth is a first-class SLO breach.
    self._compile_sentinel = slo_lib.CompileSentinel(
        self._twin_label, _build.loaded_count,
        on_recompile=[self._note_recompile])
    self._card_ptrs: Optional[List[int]] = None
    self._card_peak: Optional[device_lib.StepPeak] = None
    if self._slo is not None:
      # The monitor consumes this engine's registry records (it is a
      # registry sink) and merges this engine's state summary into
      # diagnostic bundles; both hold the engine weakly or idempotently,
      # since the ambient monitor outlives engines.
      if self.registry is not None:
        self._slo.attach(self.registry)
      self._slo.add_context_provider(self._capture_context)
      if self._capture_device:
        self._slo.add_listener(self._arm_device_capture, weak=True)
    # The engine's SLO actuator: breaches move the scheduler's clamps
    # and the admission ladder's floor between steps, never a shape.
    self._autotuner = None
    if conf.autotune.enabled:
      from easyparallellibrary_tpu_torch.serving.autotune import (
          EngineAutotuner)
      self._autotuner = EngineAutotuner(self, self._slo,
                                        config=root_config)
    if self.paged:
      mb = kv_lib.paged_cache_bytes(cfg, self.num_blocks,
                                    self.block_size) / 1e6
      layout = (f"paged: {self.num_blocks} x {self.block_size}-token "
                f"blocks, token budget {self.token_budget}, {mb:.1f} MB")
    else:
      mb = kv_lib.cache_bytes(cfg, self.num_slots, self.chunk) / 1e6
      layout = f"contiguous slots, {mb:.1f} MB"
    get_logger().info(
        "serving engine: %d slots x chunk %d (%s, %s), prefill budget %s, "
        "max batch %d, speculation %s, resilience %s", self.num_slots,
        self.chunk, layout, self.device, budget or "uncapped",
        self.scheduler.max_batch,
        f"{type(self.drafter).__name__}(k={self.drafter.k})"
        if self.drafter is not None else "off",
        f"on (queue_limit {res_conf.queue_limit or 'unbounded'}, itl_slo "
        f"{res_conf.itl_slo_s or 'off'}, watchdog "
        f"{res_conf.step_timeout_s or 'off'})" if self._resilient
        else "off")

  def _resolve_drafter(self, conf, drafter, speculative, draft_model,
                       draft_params):
    """``speculative=False`` wins over everything; otherwise an explicit
    ``drafter`` wins, and ``serving.speculative.*`` decides the rest
    (``speculative=True`` overrides its ``enabled``).  A drafter must
    fit the chunk (k + 1 <= prefill_chunk)."""
    from easyparallellibrary_tpu_torch.serving.speculative import (
        DraftModelDrafter, NgramDrafter)
    if speculative is False:
      return None
    spec = conf.speculative
    if drafter is None and (spec.enabled or speculative):
      if spec.kind == "ngram":
        drafter = NgramDrafter(k=spec.k, ngram_max=spec.ngram_max,
                               ngram_min=spec.ngram_min)
      else:  # "draft_model" (config validation rejects anything else)
        if draft_model is None or draft_params is None:
          raise ValueError(
              "serving.speculative.kind='draft_model' needs the drafter's "
              "weights: pass draft_model=/draft_params= or a drafter= "
              "instance")
        drafter = DraftModelDrafter(draft_model, draft_params, k=spec.k)
    if drafter is not None:
      check_draft_fits_chunk(drafter.k, self.chunk)
    return drafter

  # ---------------------------------------------------- resilience hooks

  def _on_degrade_transition(self, old: int, new: int, signals):
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          "serving/degraded", cat="serving", track="serving",
          args={"from": DEGRADE_LEVELS[old], "to": DEGRADE_LEVELS[new],
                **signals})
      tracer.counter("serving/degraded_level", new)
    if self.stats is not None:
      self.stats.note_degraded(new)

  # -------------------------------------------------- observability hooks

  def _describe_signature(self, plan) -> Dict[str, Any]:
    """Shape/dtype signature of the step's host-side inputs, built only
    on the (rare) recompile path to attribute it."""
    sig: Dict[str, Any] = {"twin": type(plan).__name__,
                           "resilient": self._resilient,
                           "paged": self.paged,
                           "kernel_libraries": _build.loaded_count()}
    for name, v in vars(plan).items():
      if hasattr(v, "shape"):
        sig[name] = f"{v.dtype}{list(v.shape)}"
    return sig

  def _note_recompile(self, label: str, cache_size: int,
                      new_compiles: int, signature) -> None:
    """CompileSentinel subscriber: a kernel library loaded mid-run
    becomes a trace instant, a stats counter and a first-class SLO
    breach (which also deep-captures when configured)."""
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          "serving/recompile", cat="serving", track="serving",
          args={"twin": label, "cache_size": int(cache_size),
                "new_compiles": int(new_compiles),
                "signature": str(signature)[:512]})
    if self.stats is not None:
      self.stats.note_recompile(new_compiles)
    if self._slo is not None:
      self._slo.note_event(
          "unexpected_recompile",
          {"twin": label, "cache_size": int(cache_size),
           "signature": str(signature)[:512]},
          step=self._steps)

  def _capture_context(self) -> Dict[str, Any]:
    """Scheduler/allocator state summary merged into diagnostic bundles
    (observability/slo.py DiagnosticCapture), keyed by this engine's
    track prefix."""
    sched = self.scheduler
    ctx: Dict[str, Any] = {
        "engine_steps": self._steps,
        "queue_depth": sched.queue_depth,
        "num_active": sched.num_active,
        "num_slots": self.num_slots,
        "paged": self.paged,
        "recompiles": self._compile_sentinel.recompiles,
        "active_uids": [str(st.req.uid)
                        for st in sched.active.values()][:32],
    }
    if self._admission is not None:
      ctx["degraded_level"] = self._admission.level
      ctx["shed_total"] = self._admission.shed_total
    if self._autotuner is not None:
      ctx["autotune_level"] = self._autotuner.level
      ctx["autotune_actuations"] = self._autotuner.actuations
    if self._bad_policy is not None:
      ctx.update(self._bad_policy.counters())
    if self.paged:
      ctx.update(kv_blocks_free=sched.kv_blocks_free,
                 kv_blocks_used=sched.kv_blocks_used,
                 kv_fragmentation=sched.kv_fragmentation,
                 preemptions=sched.preemptions,
                 proactive_preemptions=sched.proactive_preemptions)
      if self.prefix_caching:
        ctx.update(prefix_hits=sched.prefix_hits,
                   prefix_misses=sched.prefix_misses,
                   prefix_blocks_reused=sched.prefix_blocks_reused,
                   prefix_evictions=sched.prefix_evictions,
                   prefix_cached_blocks=sched.prefix_cached_blocks)
    out = {self._track_prefix: ctx}
    if self._introspector is not None:
      # Device truth rides every bundle: cost cards and live HBM gauges.
      out["device"] = self._introspector.context()
    return out

  def _twin_meta(self) -> Dict[str, Any]:
    """Geometry the cost card is normalised by: the step's token
    capacity and the KV footprint per request."""
    cfg = self.model.cfg
    if self.paged:
      kv_bytes = kv_lib.paged_cache_bytes(cfg, self.num_blocks,
                                          self.block_size)
      tokens = self.token_budget
    else:
      kv_bytes = kv_lib.cache_bytes(cfg, self.num_slots, self.chunk)
      tokens = self.num_slots * self.chunk
    return {"tokens_per_step": tokens, "kv_cache_bytes": kv_bytes,
            "kv_bytes_per_request": kv_bytes / max(self.num_slots, 1),
            "num_slots": self.num_slots, "paged": self.paged}

  def _kv_leaves(self) -> List[torch.Tensor]:
    return [leaf for layer in self._kv.values()
            for leaf in layer["attn"].values()]

  def _cost_card(self, ptrs_before: List[int]) -> Dict[str, Any]:
    """The twin's cost card after its first step: the GPT forward's
    FLOPs at the step's token capacity, each attending the full context
    (``profiler.flops.gpt_forward_flops``); the bytes the step must move
    at that capacity — the parameters and the KV caches read once (what
    the attention kernel reads at most); the parameter and cache bytes
    as its arguments; its peak: the arguments plus what the step added
    at its peak (``observability.device.StepPeak``: measured, so the
    rest of the process's memory is not the twin's); and
    whether the step wrote the caches in place (their ``data_ptr()``
    unchanged)."""
    cfg = self.model.cfg
    tokens = self._twin_meta()["tokens_per_step"]
    param_bytes = float(sum(p.numel() * p.element_size()
                            for p in self.params.values()))
    leaves = self._kv_leaves()
    kv_bytes = float(sum(x.numel() * x.element_size() for x in leaves))
    added, self._card_peak = self._card_peak.added, None
    peak = param_bytes + kv_bytes + (added or 0.0)
    return dict(
        flops=gpt_forward_flops(cfg, tokens, cfg.max_seq_len),
        bytes_accessed=param_bytes + kv_bytes,
        argument_bytes=param_bytes + kv_bytes,
        peak_hbm_bytes=peak, donation_requested=True,
        donation_verified=[x.data_ptr() for x in leaves] == ptrs_before)

  def _arm_device_capture(self, rule: str, payload: Dict[str, Any]) -> None:
    """Breach listener (``observability.slo.capture_xla``): arm a
    ``torch.profiler`` capture around the NEXT step, written under the
    breach's diagnostic bundle.  Only for breaches the payload
    attributes to THIS engine's twin: the ambient monitor is shared, and
    a fleet-level breach arming a heavy capture on every engine at once
    would be the anomaly."""
    del rule
    bundle = payload.get("bundle")
    if bundle and payload.get("twin") == self._twin_label:
      self._pending_device_dir = os.path.join(bundle, "device")

  # ----------------------------------------------------------- device step

  def _tensor(self, array: np.ndarray) -> torch.Tensor:
    """A plan array as a tensor of the step: a copy on the engine's
    device (also on the CPU, so that the step's inputs are the step's
    memory there as on the card)."""
    return torch.tensor(np.ascontiguousarray(array), device=self.device)

  def _sampling_args(self, plan):
    return (self._tensor(plan.keys.astype(np.int64)),
            self._tensor(plan.tok_index), self._tensor(plan.temperature),
            self._tensor(plan.top_k), self._tensor(plan.top_p))

  def _score(self, params, plan) -> torch.Tensor:
    """Run the paged plan's flat batch through the model (writing its
    K/V into the pool); returns the logits ``[T, V]``."""
    from easyparallellibrary_tpu_torch.models.gpt import paged_step_logits
    # The attention kernel's tiled build takes the step's query tiles,
    # which the plan already knows: planned here once for every layer.
    pool = self._kv["block_0"]["attn"]["cached_key"]
    tiles = {}
    if pa_lib.needs_tiles(pool, self.compute_dtype):
      runs = pa_lib.tile_runs_from_plan(
          plan.base_idx, plan.num_valid, self.token_budget,
          plan.draft_base, plan.draft_cap)
      tiles["tiles"] = pa_lib.plan_tiles(
          runs, plan.positions, plan.block_tables.shape[1], pool.shape[1],
          pool.shape[2], self.device)
    logits, self._kv = paged_step_logits(
        self.model, params, self._kv, self._tensor(plan.tokens),
        self._tensor(plan.slot_ids), self._tensor(plan.positions),
        self._tensor(plan.valid), self._tensor(plan.block_tables), **tiles)
    return logits

  def _fetch(self, *columns):
    """The step's one device-to-host fetch: ``[N]`` / ``[N, k]`` columns
    stacked into one int64 array."""
    cols = [c.long().reshape(c.shape[0], -1) for c in columns]
    return torch.cat(cols, dim=1).cpu().numpy()

  def _slot_verdict(self, rows, live):
    """The finiteness verdict on exactly the logit rows the commit reads
    (``rows [N, ..., V]``): a slot with no work this step is never
    convicted."""
    return torch.isfinite(rows).flatten(1).all(dim=1) | ~live

  @torch.inference_mode()
  def _slot_step(self, params, plan):
    """The contiguous step: one model call over ``[num_slots, C]`` at the
    slots' cursors (reset slots from 0), each slot's last live row
    gathered and sampled, the cursors advanced on the device (a bad
    slot's not, with resilience on).  Returns ``(tokens [N], slot_ok
    [N] or None)`` from one fetch."""
    from easyparallellibrary_tpu_torch.models.gpt import slot_step_logits
    N, C = self.num_slots, self.chunk
    num_valid = self._tensor(plan.num_valid)
    cursors = torch.where(self._tensor(plan.reset),
                          torch.zeros_like(self._cursors), self._cursors)
    logits, self._kv = slot_step_logits(
        self.model, params, self._kv, self._tensor(plan.tokens), cursors)
    # Idle slots (num_valid = 0) read row 0, which nothing commits.
    rows = torch.arange(N, device=self.device)
    last = logits[rows, torch.clamp(num_valid.long() - 1, 0, C - 1)]
    keys, tok_index, temperature, top_k, top_p = self._sampling_args(plan)
    nxt = sample_token_slots(last.float(), prng.fold_in(keys, tok_index),
                             temperature, top_k, top_p)
    advanced = cursors + num_valid
    if not self._resilient:
      self._cursors = advanced
      return self._fetch(nxt)[:, 0], None
    slot_ok = self._slot_verdict(last, num_valid > 0)
    self._cursors = torch.where(slot_ok, advanced, cursors)
    out = self._fetch(nxt, slot_ok)
    return out[:, 0], out[:, 1].astype(bool)

  @torch.inference_mode()
  def _slot_spec_step(self, params, plan, num_draft: np.ndarray):
    """The speculative contiguous step: the same one model call, with
    each decode slot's drafts in chunk columns 1..num_draft; target rows
    ``base - 1 + j`` (``base`` = non-draft tokens fed) verify draft j,
    and the cursor advances past the fed tokens and the accepted drafts.
    Returns ``(committed [N, K+1], n_committed [N], slot_ok or None)``
    from one fetch."""
    from easyparallellibrary_tpu_torch.models.gpt import slot_step_logits
    from easyparallellibrary_tpu_torch.serving.speculative.verify import (
        verify_tokens)
    N, C, K = self.num_slots, self.chunk, self.drafter.k
    nd = self._tensor(num_draft)
    num_valid = self._tensor(plan.num_valid) + nd
    cursors = torch.where(self._tensor(plan.reset),
                          torch.zeros_like(self._cursors), self._cursors)
    tokens = self._tensor(plan.tokens)
    logits, self._kv = slot_step_logits(self.model, params, self._kv,
                                        tokens, cursors)
    base = (num_valid - nd).long()
    j = torch.arange(K + 1, device=self.device)[None]
    pos = torch.clamp(base[:, None] - 1 + j, 0, C - 1)
    rows = torch.arange(N, device=self.device)[:, None]
    tgt = logits[rows, pos].float()                       # [N, K+1, V]
    drafts = tokens.long()[rows, torch.clamp(base[:, None] + j[:, :K], 0,
                                             C - 1)]
    committed, n_committed, accepted = verify_tokens(
        tgt, drafts, nd, *self._sampling_args(plan))
    advanced = cursors + base.int() + accepted.int()
    if not self._resilient:
      self._cursors = advanced
      out = self._fetch(committed, n_committed)
      return out[:, :K + 1], out[:, K + 1], None
    slot_ok = self._slot_verdict(tgt, num_valid > 0)
    self._cursors = torch.where(slot_ok, advanced, cursors)
    out = self._fetch(committed, n_committed, slot_ok)
    return out[:, :K + 1], out[:, K + 1], out[:, K + 2].astype(bool)

  @torch.inference_mode()
  def _paged_step(self, params, plan):
    """The paged step: score the flat batch, gather each slot's last
    scheduled row, sample.  Returns ``(tokens [N], slot_ok [N] or
    None)`` from one fetch."""
    T = self.token_budget
    logits = self._score(params, plan)
    # Each slot's next-token logits sit at its last scheduled flat
    # position; idle slots read row 0, which the scheduler never reads.
    last_idx = np.clip(plan.base_idx + plan.num_valid - 1, 0, T - 1)
    last = logits.index_select(0, self._tensor(last_idx).long())
    keys, tok_index, temperature, top_k, top_p = self._sampling_args(plan)
    nxt = sample_token_slots(last.float(), prng.fold_in(keys, tok_index),
                             temperature, top_k, top_p)
    if not self._resilient:
      return self._fetch(nxt)[:, 0], None
    slot_ok = self._slot_verdict(last, self._tensor(plan.num_valid > 0))
    out = self._fetch(nxt, slot_ok)
    return out[:, 0], out[:, 1].astype(bool)

  @torch.inference_mode()
  def _paged_spec_step(self, params, plan, num_draft: np.ndarray):
    """The speculative paged step: score the flat batch (drafts
    included), gather each slot's K+1 target rows by flat index (row 0
    at its last real token, rows 1..K at its draft positions), verify.
    Returns ``(committed [N, K+1], n_committed [N], slot_ok or None)``
    from one fetch.  Rejected drafts' K/V lie past the committed count;
    the next feed overwrites them."""
    from easyparallellibrary_tpu_torch.serving.speculative.verify import (
        verify_tokens)
    T, K = self.token_budget, self.drafter.k
    logits = self._score(params, plan)
    base_last = np.clip(plan.base_idx + plan.num_valid - 1, 0, T - 1)
    j = np.arange(K + 1)[None]
    idx = np.concatenate(
        [base_last[:, None], plan.draft_base[:, None] + j[:, :K]], axis=1)
    # Rows past a slot's draft count read its own last row; the verifier
    # masks them, and the verdict never convicts a slot on another's.
    idx = np.clip(np.where(j <= num_draft[:, None], idx,
                           base_last[:, None]), 0, T - 1)
    dpos = np.clip(plan.draft_base[:, None] + j[:, :K], 0, T - 1)
    N = idx.shape[0]
    tgt = logits.index_select(0, self._tensor(idx.reshape(-1)).long())
    tgt = tgt.reshape(N, K + 1, -1).float()
    committed, n_committed, _ = verify_tokens(
        tgt, self._tensor(plan.tokens[dpos]), self._tensor(num_draft),
        *self._sampling_args(plan))
    if not self._resilient:
      out = self._fetch(committed, n_committed)
      return out[:, :K + 1], out[:, K + 1], None
    slot_ok = self._slot_verdict(tgt, self._tensor(plan.num_valid > 0))
    out = self._fetch(committed, n_committed, slot_ok)
    return out[:, :K + 1], out[:, K + 1], out[:, K + 2].astype(bool)

  def _propose_drafts(self, tracer, plan) -> np.ndarray:
    """Run the drafter for one step and write its drafts into the plan:
    chunk columns 1.. of each decode slot (contiguous) or the slot's
    reserved flat positions, flipped valid (paged).  A drafter that
    raises, or returns what cannot be written, degrades to zero drafts
    for the step (verification would reject garbage anyway) and is
    counted in ``drafter_failures``; a ladder at ``spec_off`` or above
    skips the drafter.  Returns ``num_draft [N]``."""
    N = plan.draft_cap.shape[0]
    if not self.scheduler.spec_enabled:
      # getattr: observe_skip postdates the drafter protocol, so a
      # duck-typed drafter without it must not crash the engine the
      # first time the ladder reaches spec_off.
      skip = getattr(self.drafter, "observe_skip", None)
      if skip is not None:
        skip(plan)
      return np.zeros((N,), np.int32)
    if self._tp > 1 and getattr(self.drafter, "mesh", None) is not None:
      # A draft model on the mesh runs its rollouts on every rank.
      self._send(_OP_PROPOSE, plan)
    with tracer.span("serving/draft", cat="serving", track="serving"):
      try:
        histories = self.scheduler.slot_histories(plan)
        draft_tokens, num_draft = self.drafter.propose(plan, histories)
        num_draft = np.clip(np.asarray(num_draft, np.int32), 0,
                            plan.draft_cap)
        for slot in np.nonzero(num_draft)[0]:
          nd = int(num_draft[slot])
          if self.paged:
            b = int(plan.draft_base[slot])
            plan.tokens[b:b + nd] = draft_tokens[slot, :nd]
            plan.valid[b:b + nd] = True
          else:
            plan.tokens[slot, 1:1 + nd] = draft_tokens[slot, :nd]
      except Exception as e:  # noqa: BLE001 — any drafter fault degrades
        self.drafter_failures += 1
        if self.drafter_failures == 1:
          get_logger().warning(
              "drafter %s failed (%s: %s); serving continues without "
              "drafts this step (logged once; counted in "
              "drafter_failures)", type(self.drafter).__name__,
              type(e).__name__, e)
        if tracer.enabled:
          tracer.instant("serving/drafter_failure", cat="serving",
                         track="serving",
                         args={"error": type(e).__name__})
        if self.paged:
          # Drafts written before the failure stay out of the step.
          for slot in np.nonzero(plan.draft_cap)[0]:
            b = int(plan.draft_base[slot])
            plan.valid[b:b + int(plan.draft_cap[slot])] = False
        # Contiguous: with zero drafts every decode slot feeds one token,
        # so columns already written are masked garbage nothing reads.
        return np.zeros((N,), np.int32)
    return num_draft

  # ------------------------------------------------------ bad-step policy

  def _apply_degradation(self):
    """Feed the ladder this iteration's post-admission load signals and
    apply its level to the scheduler (speculation gate, budget clamp).
    Occupancy is judged against the concurrency cap in force (the
    autotuner's slot cap included)."""
    itl = self.stats.itl_ewma_s if self.stats is not None else 0.0
    cap = min(self.num_slots, self.scheduler.effective_max_batch)
    self._admission.observe(self.scheduler.queue_depth,
                            self.scheduler.num_active / cap, itl)
    self.scheduler.spec_enabled = self._admission.speculation_enabled
    self.scheduler.budget_override = (
        self.chunk if self._admission.budget_tightened else 0)

  def _handle_bad_slots(self, plan, slot_ok: np.ndarray) -> List[int]:
    """After the commit: update the streaks, requeue or fail the slots
    the policy quarantines, and zero the bad step's cache writes.
    Returns the bad slots."""
    bad = [int(s) for s in np.nonzero(~slot_ok & (plan.num_valid > 0))[0]]
    exercised = {int(s) for s in np.nonzero(plan.num_valid)[0]}
    actions = self._bad_policy.judge(self.scheduler.active, bad,
                                     exercised=exercised)
    if not bad:
      return bad
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      retries = sum(1 for a in actions.values() if a == BadStepPolicy.RETRY)
      tracer.instant("serving/bad_step", cat="serving", track="serving",
                     args={"slots": bad, "retries": retries})
    get_logger().warning(
        "bad device step (non-finite logits) on slot(s) %s: %s", bad,
        actions)
    # Paged: the block lists before a requeue or failure returns them to
    # the pool; their rows are zeroed either way.
    blocks_by_slot = ({s: self.scheduler.slot_blocks(s) for s in bad}
                      if self.paged else None)
    slot_starts: Dict[int, int] = {}
    cursors = None
    for slot, action in actions.items():
      freed = action in (BadStepPolicy.REQUEUE, BadStepPolicy.FAIL)
      if action == BadStepPolicy.REQUEUE:
        self.scheduler.requeue_slot(slot, reason="bad_step")
      elif action == BadStepPolicy.FAIL:
        self.scheduler.retire_slot(slot, "failed")
      if self.paged:
        # From the committed watermark up, freed or not: the plan's first
        # position for the slot is it (no fetch), and every write of the
        # bad step landed at or above it.  Rows below hold committed K/V
        # that a prefix-sharing sibling may still map.
        slot_starts[slot] = int(plan.positions[plan.base_idx[slot]])
      elif freed:
        slot_starts[slot] = 0
      else:  # retry: zero the bad step's uncommitted writes only
        if cursors is None:  # the one fetch of this rare path
          cursors = self._cursors.cpu().numpy()
        slot_starts[slot] = int(cursors[slot])
    if self.paged:
      self._sanitize_paged(slot_starts, blocks_by_slot)
    else:
      self._sanitize_slots(slot_starts)
    if self.stats is not None:
      self.stats.sync_bad_step_counters(self._bad_policy.counters())
    return bad

  @torch.inference_mode()
  def _sanitize(self, mask: np.ndarray, start: np.ndarray) -> None:
    """Zero rows ``>= start[i]`` of every cache leaf's entry ``i`` where
    ``mask[i]``, in place.  Dim 0 is slots (contiguous) or pool blocks
    (paged), dim 1 the rows within."""
    if self._tp > 1 and self.is_leader:
      self._send(_OP_SANITIZE, None, extra=(mask, start))
    m = self._tensor(mask)
    st = self._tensor(start.astype(np.int64))
    for layer in self._kv.values():
      for leaf in layer["attn"].values():
        rows = torch.arange(leaf.shape[1], device=self.device)
        zero = m[:, None] & (rows[None, :] >= st[:, None])
        leaf.masked_fill_(zero[:, :, None, None], 0)

  def _sanitize_slots(self, slot_starts: Dict[int, int]) -> None:
    """Zero poisoned slots' K/V from each slot's start row up: masking
    zeroes a stale row's probability, but the V contraction still
    touches every row and ``0 * NaN = NaN``.  A freed slot passes 0 (its
    next occupant starts clean); a retried slot its committed cursor
    (the retry's grant may not rewrite every row the bad step wrote)."""
    mask = np.zeros((self.num_slots,), bool)
    start = np.zeros((self.num_slots,), np.int64)
    for slot, row in slot_starts.items():
      mask[slot], start[slot] = True, row
    self._sanitize(mask, start)

  def _sanitize_paged(self, slot_starts: Dict[int, int],
                      blocks_by_slot: Dict[int, list]) -> None:
    """The paged twin of :meth:`_sanitize_slots`: each poisoned slot's
    block list maps to per-block start rows, blocks wholly below the
    watermark are skipped, and the null block is always zeroed (a
    NaN-params step poisons it through the padding writes)."""
    bs = self.block_size
    mask = np.zeros((self.num_blocks,), bool)
    start = np.zeros((self.num_blocks,), np.int64)
    mask[kv_lib.NULL_BLOCK] = True
    for slot, pos in slot_starts.items():
      for j, blk in enumerate(blocks_by_slot.get(slot, ())):
        if (j + 1) * bs <= pos:
          continue  # wholly below the committed watermark: rows are real
        row = max(0, pos - j * bs)
        start[blk] = row if not mask[blk] else min(start[blk], row)
        mask[blk] = True
    # Zeroed content must never satisfy a later prefix match.
    self.scheduler.invalidate_cached_blocks(
        int(b) for b in np.nonzero(mask)[0] if b != kv_lib.NULL_BLOCK)
    self._sanitize(mask, start)

  # ------------------------------------------------- tensor-parallel lockstep

  def _fields(self):
    return _PAGED_FIELDS if self.paged else _SLOT_FIELDS

  def _field_shapes(self, cfg):
    """The shape of each plan field a lockstep message carries; the
    message is the fields flattened, after the op code, or a sanitize's
    mask and start rows."""
    N, T = self.num_slots, self.token_budget
    if not self.paged:
      return {"tokens": (N, self.chunk), "num_valid": (N,), "reset": (N,),
              "draft_cap": (N,)}
    mb = kv_lib.blocks_per_slot(cfg, self.block_size)
    return {"tokens": (T,), "slot_ids": (T,), "positions": (T,),
            "valid": (T,), "block_tables": (N, mb), "base_idx": (N,),
            "draft_base": (N,), "num_valid": (N,), "draft_cap": (N,)}

  def _send(self, op: int, plan, extra=None) -> None:
    """Leader: broadcast one lockstep message over the model group (the
    plan's integer fields, or a sanitize's mask and start rows), and for
    the slot layout the cursors after it."""
    buf = np.zeros((self._packet_len,), np.int32)
    buf[0] = op
    parts = []
    if plan is not None:
      parts = [np.asarray(getattr(plan, f)).astype(np.int32).reshape(-1)
               for f in self._fields()]
    elif extra is not None:
      parts = [np.asarray(a).astype(np.int32).reshape(-1) for a in extra]
    if parts:
      flat = np.concatenate(parts)
      buf[1:1 + flat.size] = flat
    collectives.broadcast(self._tensor(buf), constants.MODEL_AXIS)
    if plan is not None and not self.paged:
      collectives.broadcast(self._cursors, constants.MODEL_AXIS)

  def _recv(self):
    """Follower: the next message: ``(op, plan or None, payload)``."""
    import types
    buf = torch.zeros((self._packet_len,), dtype=torch.int32,
                      device=self.device)
    buf = collectives.broadcast(buf, constants.MODEL_AXIS).cpu().numpy()
    op = int(buf[0])
    if op in (_OP_STOP, _OP_SANITIZE):
      return op, None, buf[1:]
    plan, offset = types.SimpleNamespace(), 1
    for f in self._fields():
      shape = self._shapes[f]
      size = int(np.prod(shape))
      arr = buf[offset:offset + size].reshape(shape)
      setattr(plan, f, arr.astype(bool) if f in ("valid", "reset") else arr)
      offset += size
    if not self.paged:
      self._cursors = collectives.broadcast(self._cursors,
                                            constants.MODEL_AXIS)
      if self.drafter is not None:
        self.drafter.observe_commit(self._cursors)
    return op, plan, None

  @torch.inference_mode()
  def follow(self) -> int:
    """Serve as a follower rank of a tensor-parallel engine: run the
    leader's steps on this rank's shard until the leader's ``close()``.
    Returns the number of steps run."""
    if self._tp <= 1 or self.is_leader:
      raise RuntimeError("follow() runs on the non-leader ranks of a "
                         "tensor-parallel engine (mesh model axis > 1)")
    from easyparallellibrary_tpu_torch.models.gpt import slot_step_logits
    steps = 0
    while True:
      op, plan, payload = self._recv()
      if op == _OP_STOP:
        return steps
      if op == _OP_SANITIZE:
        rows = self.num_blocks if self.paged else self.num_slots
        self._sanitize(payload[:rows].astype(bool),
                       payload[rows:2 * rows].astype(np.int64))
      elif op == _OP_PROPOSE:
        self.drafter.propose(plan, {})
      elif self.paged:
        self._score(self.params, plan)
        steps += 1
      else:
        cursors = torch.where(self._tensor(plan.reset),
                              torch.zeros_like(self._cursors),
                              self._cursors)
        slot_step_logits(self.model, self.params, self._kv,
                         self._tensor(plan.tokens), cursors)
        steps += 1

  # ------------------------------------------------------------ host loop

  def _record_finished(self, fin: FinishedRequest) -> None:
    """Record a resolution, evicting oldest-first past
    ``serving.finished_limit`` (0 = unbounded)."""
    self.finished.pop(fin.uid, None)
    self.finished[fin.uid] = fin
    if self._finished_limit > 0:
      while len(self.finished) > self._finished_limit:
        self.finished.pop(next(iter(self.finished)))

  def submit(self, request: Request) -> bool:
    """Validate and enqueue ``request``; False when admission control
    sheds it (the bounded queue is full, or the ladder is at its shed
    level), with a ``"shed"`` record in ``finished``.  A malformed
    request raises whatever the load."""
    prompt = self.scheduler.validate(request)
    if self._admission is not None and not self.scheduler.has_work:
      # An idle engine never steps, so a stale shed level would reject
      # every later submit: re-observe with the idle signals first.
      self._apply_degradation()
    if (self._admission is not None
        and self._admission.should_shed(self.scheduler.queue_depth)):
      self._admission.note_shed()
      self._record_finished(FinishedRequest(
          uid=request.uid, tokens=prompt, new_tokens=0,
          finish_reason="shed"))
      if self.stats is not None:
        self.stats.note_shed(request.uid)
      tracer = trace_lib.get_tracer()
      if tracer.enabled:
        tracer.instant(
            "serving/shed", cat="serving", track="serving/requests",
            args={"uid": str(request.uid),
                  "queue_depth": int(self.scheduler.queue_depth),
                  "level": DEGRADE_LEVELS[self._admission.level]})
        if request.flow_id is not None:
          # An upstream-minted flow must terminate even on a shed: the
          # rejection is this request's resolution.
          tracer.flow("f", request.flow_id, track="serving/requests",
                      args={"uid": str(request.uid), "reason": "shed"})
      get_logger().warning(
          "shedding request %r at submit (queue %d/%d, level %s)",
          request.uid, self.scheduler.queue_depth,
          self._admission.queue_limit,
          DEGRADE_LEVELS[self._admission.level])
      return False
    if self.stats is not None:
      self.stats.note_submitted(request.uid)
    self.scheduler.submit(request, _prompt=prompt)
    return True

  def cancel(self, uid: Any) -> bool:
    """Retire ``uid`` wherever it is; the record lands in
    ``self.finished`` at once and in the next ``step()``'s return."""
    return self.scheduler.cancel(uid)

  # ------------------------------------------------------- migration

  def snapshot_requests(self) -> List[Dict[str, Any]]:
    """Snapshots of every queued and in-flight request
    (``scheduler.snapshot_requests``): restored on another engine over
    the same weights, each stream resumes by prefix replay."""
    return self.scheduler.snapshot_requests()

  def restore_request(self, snap: Dict[str, Any],
                      front: bool = False) -> Any:
    """Queue a snapshotted request.  Admission control is bypassed: the
    fleet admitted it once already.  The stats keep its original submit
    time, so its TTFT includes the wait before the migration."""
    uid = self.scheduler.restore_request(snap, front=front)
    if self.stats is not None:
      self.stats.note_submitted(uid, at=snap.get("submitted_at"))
    return uid

  def evacuate(self) -> List[Dict[str, Any]]:
    """Snapshot and remove every queued and in-flight request (no finish
    records: they finish elsewhere).  The engine stays warm and can
    serve again at once."""
    return self.scheduler.evacuate()

  @property
  def has_work(self) -> bool:
    return self.scheduler.has_work

  @property
  def steps(self) -> int:
    """Device steps run so far (iterations whose plan was not None)."""
    return self._steps

  def close(self):
    """Stop the watchdog thread, and release the followers of a
    tensor-parallel leader (their :meth:`follow` returns).  Idempotent;
    the engine still steps afterwards, unless it leads followers.  Also
    runs on ``with`` exit, and (the watchdog) when the engine is
    collected."""
    if self._tp > 1 and self.is_leader and not self._followers_stopped:
      self._followers_stopped = True
      self._send(_OP_STOP, None)
    if self._watchdog is not None:
      self._watchdog.close()
      self._watchdog = None
      self._watchdog_finalizer.detach()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False

  def _trace_slot_spans(self, tracer, plan, t0_us: float, t1_us: float,
                        num_draft=None, n_committed=None):
    """Per-slot timeline spans for one device step: the one step covers
    every active slot, so each slot's prefill / decode / speculate span
    shares its bounds and nests inside the request's lifecycle span
    (opened at admission by the scheduler).  Speculating slots carry
    drafted / accepted counts, paged slots their block count.  Host
    values only."""
    if not tracer.enabled:
      return
    for slot in np.nonzero(plan.num_valid)[0]:
      slot = int(slot)
      track = self._slot_tracks[slot]
      extra = {}
      if self.paged:
        extra["kv_blocks"] = len(self.scheduler.slot_blocks(slot))
      if plan.prefilling[slot]:
        tracer.span_at("prefill", t0_us, t1_us, cat="serving",
                       track=track,
                       args={"tokens": int(plan.num_valid[slot]), **extra})
      elif num_draft is not None and int(num_draft[slot]) > 0:
        tracer.span_at(
            "speculate", t0_us, t1_us, cat="serving", track=track,
            args={"drafted": int(num_draft[slot]),
                  "accepted": int(n_committed[slot]) - 1, **extra})
      else:
        tracer.span_at("decode", t0_us, t1_us, cat="serving",
                       track=track,
                       args={"tok_index": int(plan.tok_index[slot]),
                             **extra})

  def step(self) -> List[FinishedRequest]:
    """One engine iteration: [autotune ->] plan [-> degrade] [-> draft]
    -> device step -> commit [-> bad-step policy] [-> observability].
    Returns the requests that retired this iteration (empty when idle),
    expiries and cancellations included."""
    tracer = trace_lib.get_tracer()
    if self._autotuner is not None:
      # Knob moves land here, between steps, steering the plan below.
      self._autotuner.on_step(self._steps)
    with tracer.span("serving/plan", cat="serving", track="serving"):
      plan = self.scheduler.plan_step()
    if self._admission is not None:
      # Observed after admission: the queue signal is the backlog this
      # step could not absorb.  The gates steer the next plan.
      self._apply_degradation()
    if plan is None:
      return self.scheduler.take_finished()
    if (self._introspector is not None and self._steps == 0
        and not self._introspector.has_card(self._twin_label)):
      # The cost card's peak is measured over the first step, and its
      # in-place check reads the caches' addresses before it.
      self._card_peak = device_lib.StepPeak(self.device).start()
      self._card_ptrs = [x.data_ptr() for x in self._kv_leaves()]
    t0 = time.monotonic()
    if self._watchdog is not None:
      self._watchdog.arm(self._steps)
    device_ctx = None
    if self._pending_device_dir is not None:
      # Deep capture armed a device profile of the step after an
      # engine-attributed breach (observability.slo.capture_xla).
      device_dir, self._pending_device_dir = self._pending_device_dir, None
      device_ctx = tracer.device_trace(device_dir)
      device_ctx.__enter__()
    drafted = accepted = 0
    try:
      if self.drafter is not None:
        # Propose before the plan's draft positions fill: the draft
        # model's mirror needs the plan the target sees.
        num_draft = self._propose_drafts(tracer, plan)
        t0_us = tracer.now_us()
        committed, n_committed, slot_ok = self._step_fn(self.params, plan,
                                                        num_draft)
        t1_us = tracer.now_us()
        tracer.span_at("serving/device_step", t0_us, t1_us,
                       cat="serving", track="serving")
        self._trace_slot_spans(tracer, plan, t0_us, t1_us, num_draft,
                               n_committed)
        with tracer.span("serving/commit", cat="serving", track="serving"):
          finished = self.scheduler.commit(committed, n_committed,
                                           slot_ok=slot_ok)
          self.drafter.observe_commit(self._cursors)
        # A bad slot's drafts are spent again on its retry: count only
        # the slots whose verdict committed.
        ok = (np.ones(num_draft.shape, bool) if slot_ok is None
              else slot_ok)
        drafted = int(num_draft[ok].sum())
        accepted = int((n_committed[(num_draft > 0) & ok] - 1).sum())
      else:
        t0_us = tracer.now_us()
        nxt, slot_ok = self._step_fn(self.params, plan)
        t1_us = tracer.now_us()
        tracer.span_at("serving/device_step", t0_us, t1_us,
                       cat="serving", track="serving")
        self._trace_slot_spans(tracer, plan, t0_us, t1_us)
        with tracer.span("serving/commit", cat="serving", track="serving"):
          finished = self.scheduler.commit(nxt, slot_ok=slot_ok)
    finally:
      if self._watchdog is not None:
        self._watchdog.disarm()
      if device_ctx is not None:
        device_ctx.__exit__(None, None, None)
      if self._card_peak is not None:
        self._card_peak.stop()
    if slot_ok is not None:
      self._handle_bad_slots(plan, slot_ok)
      finished.extend(self.scheduler.take_finished())
    self._steps += 1
    if self._steps == 1:
      # The warmup count: whatever this process had loaded by the end of
      # the first step (kernel libraries load at first use).
      self._compile_sentinel.expected = _build.loaded_count()
    self._compile_sentinel.check(
        signature_fn=lambda: self._describe_signature(plan))
    dt = time.monotonic() - t0
    # Device introspection runs below the dt cut, like every publish
    # path: the card's capture and the gauges' driver call must never
    # inflate the step_time_s sample the ITL EWMA and SLO rules act on.
    if self._card_ptrs is not None:
      ptrs, self._card_ptrs = self._card_ptrs, None
      self._introspector.capture_twin(
          self._twin_label, lambda: self._cost_card(ptrs),
          # The twin's step program once, plus every kernel library the
          # sentinel saw load past warmup: 1 on a healthy twin on any
          # device, as the JAX twin's jit cache size.
          compile_count=1 + self._compile_sentinel.recompiles,
          meta=self._twin_meta())
    if (self._introspector is not None
        and (self._steps == 1
             or self._steps % _STATS_PUBLISH_EVERY == 0)):
      # HBM gauges on the stats cadence (plus once right after warmup,
      # so short episodes still carry a sample).
      self._introspector.publish_hbm(self._steps, registry=self.registry,
                                     monitor=self._slo)
    # Throughput counts committed tokens only: a bad slot's work is fed
    # again next step.
    if slot_ok is None or bool(slot_ok.all()):
      pf_tokens, dc_tokens = plan.prefill_tokens, plan.decode_tokens
    else:
      ok = (plan.num_valid > 0) & slot_ok
      pf_tokens = int(plan.num_valid[ok & plan.prefilling].sum())
      dc_tokens = int((ok & ~plan.prefilling).sum())
    sched = self.scheduler
    if tracer.enabled:
      tracer.counter("serving/active_slots", plan.active_slots)
      if self.paged:
        tracer.counter("serving/kv_blocks_used", sched.kv_blocks_used)
        tracer.counter("serving/kv_blocks_free", sched.kv_blocks_free)
        if self.prefix_caching:
          tracer.counter("serving/prefix_hits", sched.prefix_hits)
          tracer.counter("serving/prefix_misses", sched.prefix_misses)
          tracer.counter("serving/prefix_blocks_reused",
                         sched.prefix_blocks_reused)
          tracer.counter("serving/prefix_evictions", sched.prefix_evictions)
          tracer.counter("serving/prefix_cached_blocks",
                         sched.prefix_cached_blocks)
      if drafted:
        tracer.counter("serving/drafted_tokens", drafted)
        tracer.counter("serving/accepted_tokens", accepted)
    if self.stats is not None:
      self.stats.note_step(
          active_slots=plan.active_slots, num_slots=self.num_slots,
          prefill_tokens=pf_tokens, decode_tokens=dc_tokens,
          step_time_s=dt, drafted_tokens=drafted, accepted_tokens=accepted)
      if self.paged:
        self.stats.note_blocks(sched.kv_blocks_free, sched.kv_blocks_used,
                               sched.kv_fragmentation, sched.preemptions,
                               sched.proactive_preemptions)
        if self.prefix_caching:
          self.stats.note_prefix(sched.prefix_hits, sched.prefix_misses,
                                 sched.prefix_blocks_reused,
                                 sched.prefix_evictions,
                                 sched.prefix_cached_blocks)
    if (self.metrics_writer is not None or self.registry is not None
        or self._slo is not None):
      self._publish_record(plan, pf_tokens, dc_tokens, dt, drafted,
                           accepted)
    if (self.stats is not None
        and self._steps % _STATS_PUBLISH_EVERY == 0
        and (self.registry is not None or self._slo is not None)):
      # Periodic percentile rollup, so latency SLO rules stay live on a
      # long-serving engine.
      if self.registry is not None:
        self.stats.publish(self.registry, self._steps)
      else:
        self._slo.observe(
            self._steps,
            MetricRegistry.namespaced(SERVING_NAMESPACE,
                                      self.stats.summary()))
    return finished

  def _publish_record(self, plan, pf_tokens: int, dc_tokens: int,
                      dt: float, drafted: int, accepted: int) -> None:
    """The per-step ``serving/*`` record (the JAX engine's keys): to the
    flat ``metrics_writer``, to the registry (whose sinks include the
    SLO monitor), or straight to the monitor on a registry-less engine.
    Every value is a host number the scheduler already holds."""
    sched = self.scheduler
    record = {
        "active_slots": plan.active_slots,
        "slot_occupancy": plan.active_slots / self.num_slots,
        "prefill_tokens": pf_tokens,
        "decode_tokens": dc_tokens,
        "step_time_s": dt,
    }
    if self.paged:
      record["kv_blocks_free"] = sched.kv_blocks_free
      record["kv_blocks_used"] = sched.kv_blocks_used
      record["kv_fragmentation"] = sched.kv_fragmentation
      record["preemptions"] = sched.preemptions
      record["proactive_preemptions"] = sched.proactive_preemptions
      if self.prefix_caching:
        record["prefix_hits"] = sched.prefix_hits
        record["prefix_misses"] = sched.prefix_misses
        record["prefix_blocks_reused"] = sched.prefix_blocks_reused
        record["prefix_evictions"] = sched.prefix_evictions
        record["prefix_cached_blocks"] = sched.prefix_cached_blocks
    if self.drafter is not None:
      record["drafted_tokens"] = drafted
      record["accepted_tokens"] = accepted
      record["drafter_failures"] = self.drafter_failures
    if self._resilient:
      record["queue_depth"] = sched.queue_depth
      record["degraded_level"] = self._admission.level
      record["shed"] = self._admission.shed_total
      record.update(self._bad_policy.counters())
      if self.stats is not None:
        # The cumulative good-counter partner of "shed", so burn-rate
        # rules evaluate on every per-step record.
        record["finished_requests"] = float(self.stats.finished_requests)
    if self._autotuner is not None:
      record["autotune_level"] = self._autotuner.level
      record["autotune_actuations"] = self._autotuner.actuations
    if self.metrics_writer is not None:
      # Legacy flat keys, as the JAX engine writes them.
      self.metrics_writer.write(self._steps, record)
    if self.registry is not None:
      self.registry.publish(self._steps, record, SERVING_NAMESPACE)
    elif self._slo is not None:
      self._slo.observe(self._steps,
                        MetricRegistry.namespaced(SERVING_NAMESPACE, record))

  def run(self, max_steps: Optional[int] = None) -> Dict[Any, np.ndarray]:
    """Drive until the queue drains (or ``max_steps``); returns
    ``{uid: prompt+generated}`` for every request finished during the
    call.  With a registry and stats, ends with the ``serving/*``
    rollup (tokens/s, TTFT / ITL percentiles, occupancy, counters)."""
    out: Dict[Any, np.ndarray] = {}
    steps = 0
    while self.has_work and (max_steps is None or steps < max_steps):
      for fin in self.step():
        out[fin.uid] = fin.tokens
      steps += 1
    if self.registry is not None and self.stats is not None:
      self.stats.publish(self.registry, self._steps)
    return out
