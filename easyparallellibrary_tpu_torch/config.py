"""Typed, frozen, environment-overridable configuration.

Mirrors the semantics of the reference's config system
(``epl/config.py``): a nested config object whose every leaf is

  * typed (value coerced / validated against the default's type),
  * settable via environment variable ``EPL_<CATEGORY>_<ATTRIBUTE>``
    (reference: epl/config.py:283-287),
  * overridable by a python dict passed to ``Config(...)`` with dict
    values taking precedence over env vars (reference: epl/config.py:289-299),
  * protected against typos — setting an unknown attribute raises
    (reference: epl/config.py:49-53).

The categories are re-designed for TPU: communication tuning maps to XLA
collective/fusion knobs, offload targets TPU host DRAM, and a new
``sequence`` category covers ring/Ulysses context parallelism which the
reference lacks (SURVEY §5.7).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

from easyparallellibrary_tpu_torch import constants


def _coerce(value: Any, default: Any, where: str) -> Any:
  """Coerce `value` to the type of `default` (env strings included)."""
  if default is None:
    return value
  typ = type(default)
  if isinstance(value, typ) and not (typ is int and isinstance(value, bool)):
    # bool is a subclass of int; require exact semantics for int fields.
    if typ is bool or not isinstance(value, bool):
      return value
  if typ is bool:
    if isinstance(value, str):
      low = value.strip().lower()
      if low in ("true", "1", "yes", "on"):
        return True
      if low in ("false", "0", "no", "off", ""):
        return False
      raise ValueError(f"{where}: cannot parse bool from {value!r}")
    return bool(value)
  if typ is int:
    return int(value)
  if typ is float:
    return float(value)
  if typ is str:
    return str(value)
  if typ in (list, tuple):
    if isinstance(value, str):
      items = [v for v in value.split(",") if v != ""]
      return typ(items)
    return typ(value)
  raise ValueError(f"{where}: unsupported config type {typ}")


class _Category:
  """One nested config section; subclasses define `_fields`.

  `_fields` maps attribute name → default value.  Precedence when
  constructing: python override > env var > default.
  """

  _fields: Dict[str, Any] = {}
  _name = ""

  def __init__(self, overrides: Dict[str, Any]):
    # Sub-group fields are dotted ("speculative.enabled"); accept the
    # equivalent nested-dict override form {"speculative": {"enabled": 1}}.
    flat: Dict[str, Any] = {}
    for key, value in overrides.items():
      if isinstance(value, dict):
        for sub_key, sub_value in value.items():
          flat[f"{key}.{sub_key}"] = sub_value
      else:
        flat[key] = value
    overrides = flat
    unknown = set(overrides) - set(self._fields)
    if unknown:
      raise ValueError(
          f"Unknown config key(s) {sorted(unknown)} in category "
          f"'{self._name}'. Valid keys: {sorted(self._fields)}")
    for key, default in self._fields.items():
      env_key = (f"{constants.ENV_PREFIX}_{self._name.upper()}_"
                 f"{key.upper().replace('.', '_')}")
      value = default
      if env_key in os.environ:
        value = _coerce(os.environ[env_key], default, env_key)
      if key in overrides:
        value = _coerce(overrides[key], default, f"{self._name}.{key}")
      object.__setattr__(self, key, value)

  def __setattr__(self, key: str, value: Any):
    if key not in self._fields:
      raise AttributeError(
          f"Unknown config key '{self._name}.{key}'. "
          f"Valid keys: {sorted(self._fields)}")
    object.__setattr__(self, key, _coerce(value, self._fields[key],
                                          f"{self._name}.{key}"))

  def to_dict(self) -> Dict[str, Any]:
    return {k: getattr(self, k) for k in self._fields}

  def __repr__(self):
    inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in self._fields)
    return f"{type(self).__name__}({inner})"


class _SubGroup:
  """Attribute view over a category's dotted sub-group fields, so
  ``config.serving.speculative.enabled`` reads/writes the flat
  ``serving`` field ``"speculative.enabled"`` with the category's own
  coercion and unknown-key protection."""

  def __init__(self, category: _Category, prefix: str):
    object.__setattr__(self, "_category", category)
    object.__setattr__(self, "_prefix", prefix)

  def __getattr__(self, key: str) -> Any:
    return getattr(self._category, f"{self._prefix}.{key}")

  def __setattr__(self, key: str, value: Any):
    setattr(self._category, f"{self._prefix}.{key}", value)

  def __repr__(self):
    cat = self._category
    inner = ", ".join(
        f"{k.split('.', 1)[1]}={getattr(cat, k)!r}"
        for k in cat._fields if k.startswith(self._prefix + "."))
    return f"{type(cat).__name__}.{self._prefix}({inner})"


class AutoParallelConfig(_Category):
  """Automatic parallelism (reference: epl/config.py:55-60)."""
  _name = "auto"
  _fields = {
      # Enable automatic pipeline-stage partitioning of a block list.
      "auto_parallel": False,
      # Stage search policy: balance_param | balance_flops | repeated_layers
      # (reference policies: balance-op-num / repeated-layers / heuristic,
      # epl/parallel/planner.py:66-112).
      "stage_policy": "balance_param",
      # Auto tensor-split placement (the reference leaves this TODO,
      # epl/ir/graph.py:124): inside a `split` scope, auto-named sibling
      # Dense layers alternate column -> row (Megatron pairing), so
      # back-to-back projections chain through a sharded activation with
      # a single psum instead of an activation all-gather.  Explicit
      # `parallel=` always wins; numerics are unchanged either way
      # (GSPMD inserts whatever collectives the placement implies).
      # Opt-in: the pairing is positional, so NON-chained auto-named
      # siblings (parallel branches off one input) would trade their
      # free column placement for a psum, and row-mode kernels pad the
      # CONTRACTION dim, so uneven-dim checkpoints saved with the flag
      # off do not load with it on.  Annotate explicitly where it
      # matters.
      "tensor_split": False,
  }


class IOConfig(_Category):
  """Input pipeline (reference: epl/config.py:62-75)."""
  _name = "io"
  _fields = {
      # Shard input files/samples across data-parallel replicas
      # (reference io_slicing: epl/parallel/graph_editor.py:116-215).
      "slicing": False,
      # Allow replicas to get unequal file counts (reference:
      # fetch_slice_objects_proportion_to_local_num_replicas,
      # epl/parallel/graph_editor.py:787-854).
      "unbalanced_io_slicing": False,
      "drop_last_files": False,
      # Host-side prefetch depth for the native loader.
      "prefetch": 2,
      # Number of C++ reader threads (0 = python fallback).
      "num_threads": 4,
  }


class CommunicationConfig(_Category):
  """Collective tuning (reference: epl/config.py:77-101)."""
  _name = "communication"
  _fields = {
      # Number of overlapping "communicators" — on TPU this maps to how many
      # fusion buckets may be in flight concurrently (reference pool:
      # epl/communicators/communication_pool.py:26).
      "num_communicators": constants.DEFAULT_NUM_COMMUNICATORS,
      # Gradient-fusion bucket size in MB (reference: 32 MB,
      # epl/utils/constant.py:82).
      "fusion_threshold_mb": constants.DEFAULT_FUSION_BUCKET_MB,
      "max_splits": constants.DEFAULT_MAX_FUSION_SPLITS,
      # Compress gradients to bf16 for the all-reduce (reference fp16
      # compression + scale: epl/config.py:90-94).
      "compress_dtype": "",          # "" | "bf16" | "fp16"
      "compress_scale": 1.0,
      # Convert sparse grads (embedding scatter) to dense before reduction
      # (reference: sparse_as_dense, epl/parallel/hooks.py:161-167).
      "sparse_as_dense": False,
      # mean | sum across replicas (reference: gradients_reduce_method).
      "gradients_reduce_method": "mean",
      # Latency-hiding collective-matmul (communicators/overlap.py):
      # decompose all_gather->matmul / matmul->reduce_scatter adjacencies
      # into a compute-overlapped ppermute ring.  "auto" consults the
      # planner's analytic crossover (parallel/planner.py:
      # plan_collective_matmul) per site; "on"/"off" force it.  "off"
      # emits exactly the fused programs.
      "overlap": "auto",
      # Ring chunk count for the overlap path (0 = let the policy pick;
      # non-divisors of the axis size round down to the nearest divisor).
      "overlap_chunks": 0,
  }


class PipelineConfig(_Category):
  """Pipeline parallelism (reference: epl/config.py:103-114)."""
  _name = "pipeline"
  _fields = {
      "num_micro_batch": 1,
      # Number of stages when auto-partitioning (reference:
      # pipeline.num_stages consumed by planner, epl/parallel/hooks.py:129-135).
      "num_stages": 1,
      # Schedule policy (reference: epl/strategies/scheduler.py:120-124).
      "strategy": constants.SCHEDULE_PREFER_BACKWARD,
      # Interleaved (circular) pipeline: blocks per stage > 1.
      "num_stages_per_device": 1,
      # Pipeline engine: "" (= "vmap", the lockstep SPMD engines) or
      # "smap" (per-device stage programs under shard_map — real-branch
      # bubbles, stage-resident boundary layers; see
      # parallel/pipeline_smap.py).  The schedule policy above still
      # picks GPipe vs 1F1B order within either engine.
      "engine": "",
  }


class GradientCheckpointConfig(_Category):
  """Rematerialization (reference: epl/config.py:116-127)."""
  _name = "gradient_checkpoint"
  _fields = {
      # "" (off) | "collection" (user-tagged tensors) | "auto"
      "type": "",
      # Stop auto-GC at this taskgraph index (reference:
      # gradient_checkpoint.end_taskgraph).
      "end_taskgraph": -1,
      # Verify checkpointed grads against baseline (reference:
      # check_gradients, epl/runtime/gc/gradient_checkpoint.py:310-325).
      "check_gradients": False,
  }


class ZeroConfig(_Category):
  """Optimizer-state / gradient sharding (reference: epl/config.py:129-138)."""
  _name = "zero"
  _fields = {
      # "" (off) | "v0" (shard optimizer state) | "v1" (+ gradients)
      "level": "",
  }


class OffloadConfig(_Category):
  """Host-DRAM offload (reference: epl/config.py:140-146)."""
  _name = "offload"
  _fields = {
      # "" (off) | "v0" (params+opt state live in TPU host memory)
      "level": "",
  }


class AMPConfig(_Category):
  """Mixed precision (reference: epl/config.py:148-159)."""
  _name = "amp"
  _fields = {
      # "" (off) | "O1" (bf16 compute, fp32 params)
      "level": "",
      # Loss scale: "dynamic" | numeric string (bf16 on TPU usually
      # needs no scaling; kept for fp16 parity, reference
      # epl/runtime/amp/loss_scale.py).
      "loss_scale": "dynamic",
      # Compute dtype under O1: "bf16" (TPU-native) | "fp16".
      "compute_dtype": "bf16",
      "debug_log": False,
  }


class ClusterConfig(_Category):
  """Device layout (reference: epl/config.py:161-172)."""
  _name = "cluster"
  _fields = {
      # Reuse the same devices for split and replicate (DP×TP colocation;
      # reference: colocate_split_and_replicate, epl/config.py:170-171).
      "colocate_split_and_replicate": True,
      # Prefer packing mesh axes within a host before crossing hosts
      # (reference: device_place_prefer_intra_node, epl/cluster.py:137).
      "device_place_prefer_intra_node": True,
      # Explicit mesh shape override, e.g. "stage:2,data:2,model:2".
      "mesh_shape": "",
  }


class OptimizerConfig(_Category):
  """Optimizer apply tuning (reference: epl/config.py:174-179)."""
  _name = "optimizer"
  _fields = {
      # Split the weight-update into N serialized groups to bound peak
      # memory (reference: epl/runtime/optimizer_helper.py:75-128).
      "num_apply_group": 1,
  }


class SequenceConfig(_Category):
  """Sequence/context parallelism — new vs the reference (SURVEY §5.7)."""
  _name = "sequence"
  _fields = {
      # "" (off) | "ring" (ring attention over seq axis) | "ulysses"
      "parallelism": "",
      # Size of the seq mesh axis.
      "axis_size": 1,
      # Block size for blockwise/ring attention; 0 = one block per
      # seq-axis device (finer blocking is opt-in).
      "block_size": 0,
      # "flash" (default): shard_map ring with the Pallas flash kernel
      # per block and a KV-recommunicating backward — O(S/n) live memory
      # per device.  "einsum": global-array formulation (GSPMD-
      # composable; used automatically when num_blocks/block_size asks
      # for finer-than-device blocking).
      "ring_impl": "flash",
      # Same choice for Ulysses' head-sharded attention region: "flash"
      # runs the Pallas kernel per device (no [S, S] scores), "einsum"
      # keeps the pure sharding-constraint formulation.
      "ulysses_impl": "flash",
      # Causal ring block layout: "zigzag" (default — half-chunks i and
      # 2n-1-i on device i) balances the causal mask so every device
      # does uniform half-block work each step, cutting causal ring
      # compute ~2x; measured 1.84x fwd+bwd compiled (dense blocks, CPU
      # mesh) and 1.54x interpret-mode (benchmarks/ring_layout.py,
      # BASELINE.md round 4) — hence the default.  "contiguous" (block i
      # on device i) is the fallback; non-causal rings and odd
      # per-device splits automatically use contiguous behavior, and
      # flash blocks additionally require tileable half-blocks (dense
      # blocks have no tiling bound).  shard_map ring only.
      "ring_layout": "zigzag",
  }


class ResilienceConfig(_Category):
  """Failure recovery — crash-consistent checkpoints, anomaly sentinel,
  IO retry, step watchdog (docs/robustness.md).  New vs the reference,
  whose recovery story is kill-and-retry (SURVEY §5.3)."""
  _name = "resilience"
  _fields = {
      # Stage each checkpoint in a step_N.tmp dir with per-shard sha256
      # checksums, fsync, then atomically rename to commit — a crash
      # mid-save can never shadow the previous good checkpoint
      # (CheckFreq-style crash consistency, Mohan et al. FAST'21).
      "atomic_checkpoints": True,
      # Retain only the newest N committed checkpoints (0 = keep all).
      "keep_last": 0,
      # In-jit anomaly sentinel: finite-check loss/grads every step and
      # suppress the update via jnp.where on a bad step (no extra host
      # sync); consecutive bad steps are counted on-device and surfaced
      # as the `bad_steps` metric.  Implied on when max_bad_steps > 0.
      "sentinel": False,
      # After this many CONSECUTIVE non-finite steps, fit() rolls the
      # training state back to the newest valid checkpoint (0 = never;
      # skip-only).  The host checks the on-device counter once per
      # max_bad_steps window, so the guard stays sync-free per step.
      "max_bad_steps": 0,
      # What to do when max_bad_steps trips: True = restore the last
      # valid checkpoint and replay; False = raise (fail fast).
      "rollback": True,
      # Multiply the learning rate by this factor on each rollback
      # (1.0 = off).  Requires the optimizer to expose its LR via
      # optax.inject_hyperparams; logged and skipped otherwise.
      "rollback_lr_backoff": 1.0,
      # Transient-IO retries (checkpoint shard read/write, record-file
      # open, data-iterator next) and the initial backoff between them.
      "io_retries": 3,
      "io_retry_backoff_s": 0.05,
      # Log diagnostics when one fit() step (data fetch + dispatch)
      # exceeds this wall-clock deadline (0 = off).
      "step_timeout_s": 0.0,
  }


class ServingConfig(_Category):
  """Continuous-batching inference engine (serving/, docs/serving.md).
  New vs the reference, which is training-only (SURVEY §1)."""
  _name = "serving"
  _fields = {
      # Request slots in the preallocated KV cache = max concurrently
      # resident requests.  Cache bytes scale linearly
      # (serving.kv_cache.cache_bytes).
      "num_slots": 8,
      # Token width of the fused step: prefill streams through the
      # engine this many prompt tokens per iteration (Sarathi-style
      # chunked prefill); decode slots use 1 of the positions.  Larger =
      # fewer prefill iterations but more compute per step.
      "prefill_chunk": 16,
      # Per-iteration cap on scheduled prompt tokens across all slots
      # (admission control: decode latency vs prefill throughput).
      # 0 = uncapped.  Must be 0 or >= prefill_chunk.
      "prefill_token_budget": 0,
      # Cap on concurrently active requests (0 = num_slots).
      "max_batch": 0,
      # Default stop-token id for requests that don't set one (-1 = no
      # stop token; requests run to max_new_tokens).
      "stop_token": -1,
      # Donate the cache + cursor buffers to the jitted step (in-place
      # update; steady-state device allocation = one cache).  Turn off
      # only for debugging (keeps every step's input cache alive).
      "donate_cache": True,
      # Retention bound on resolved-request records (engine.finished
      # and the stats' finished per-request traces): keep only the most
      # recent N, evicting oldest-first.  0 = keep all (fine for
      # episodic runs; a long-running server otherwise grows host
      # memory linearly with requests served).  run()'s return value is
      # unaffected — it collects each call's retirements directly.
      "finished_limit": 0,
      # --- paged KV cache + token-flat fused step (serving/kv_cache.py,
      # docs/serving.md "Paged KV cache").  Off by default: the
      # contiguous slot layout stays byte-identical.  On, per-slot K/V
      # lives in fixed-size blocks behind a block table, the fused step
      # becomes a [token_budget] flat batch (decode cost scales with
      # scheduled tokens, not num_slots * chunk), and block-pool
      # exhaustion preempts the youngest lowest-priority slot instead of
      # capping admission at worst-case length.
      "paged.enabled": False,
      # Tokens per KV block.  Must divide max_seq_len (the paged
      # attend's reduction length must equal the oracle's cache length
      # for greedy bit-exactness — kv_cache.blocks_per_slot).
      "paged.block_size": 16,
      # Pool size in blocks (one is reserved as the null block).  0 =
      # auto: num_slots * max_seq_len / block_size + 1 — byte parity
      # with the contiguous layout.  Size it SMALLER (or raise
      # num_slots) to turn unused worst-case tail into extra concurrent
      # requests; must always hold at least one full-length request.
      "paged.num_blocks": 0,
      # Flat positions per fused step (the step's whole compute bill).
      # 0 = auto: num_slots + 2 * prefill_chunk.  Must at least cover
      # every decoding slot's one guaranteed token (>= the effective
      # batch cap); prefill chunks and speculative drafts share the
      # rest.
      "paged.token_budget": 0,
      # --- copy-on-write prefix caching over the paged pool
      # (serving/prefix_cache.py, docs/serving.md "Prefix caching").
      # Requires paged.enabled: admission walks a content-addressed
      # radix tree over full prompt blocks, maps matched blocks by
      # reference (refcount++, no device copy) and prefills only the
      # unmatched tail; retired requests' blocks stay pinned in the
      # tree so multi-turn follow-ups admit warm.  Off by default: with
      # it on, cached blocks keep kv_blocks_used nonzero between
      # requests by design.
      "prefix_cache.enabled": False,
      # Seconds an unused cached entry survives before the per-step
      # expiry sweep drops it (session persistence horizon).  0 = no
      # TTL: entries live until LRU/space eviction reclaims them.
      "prefix_cache.session_ttl_s": 0.0,
      # Cap on tree-resident blocks; beyond it the least-recent entries
      # are shed regardless of sharing.  0 = uncapped (the pool itself
      # still bounds residency: a dry pool evicts unmapped cached
      # blocks before preempting any live slot).
      "prefix_cache.max_cached_blocks": 0,
      # --- speculative decoding (serving/speculative/, docs/serving.md).
      # Draft k tokens per decode slot and verify them in the SAME fused
      # step (the drafts ride chunk positions plain decode wastes), so
      # an accepted draft is a free committed token.  Off by default:
      # speculation changes sampled streams (never their distribution).
      "speculative.enabled": False,
      # Draft tokens per decode slot per step; the fused step needs
      # prefill_chunk >= k + 1 (k drafts + the last committed token).
      "speculative.k": 4,
      # Drafter: "ngram" (prompt-lookup over each request's committed
      # history — no extra weights) or "draft_model" (a small GPT passed
      # to the engine / DraftModelDrafter.from_checkpoint).
      "speculative.kind": "ngram",
      # Longest/shortest history suffix the n-gram drafter matches.
      "speculative.ngram_max": 4,
      "speculative.ngram_min": 1,
      # --- serving resilience (serving/resilience.py,
      # docs/robustness.md "Serving resilience").  Master switch: off
      # keeps the engine's pre-resilience fused step and host loop
      # byte-identical.  On, the fused step gains an in-jit finiteness
      # verdict (no extra host sync — it rides the step's own token
      # fetch) and the host loop gains admission control, deadlines and
      # bad-step recovery.
      "resilience.enabled": False,
      # Bounded admission queue: submits beyond this many waiting
      # requests are shed (finish_reason "shed").  0 = unbounded (no
      # shedding, no queue-driven degradation).
      "resilience.queue_limit": 0,
      # Inter-token-latency SLO: a measured ITL (EWMA of decode-step
      # time, profiler/serving.py) above this forces at least the
      # spec_off degradation level.  0 = off.
      "resilience.itl_slo_s": 0.0,
      # Queue-depth fraction of queue_limit that enters degradation
      # level 1 (spec_off); level 2 enters halfway between it and full,
      # level 3 (shed) at full.  De-escalation at half the entry
      # threshold (hysteresis).
      "resilience.degrade_queue_frac": 0.5,
      # Bad-step recovery: in-place exact retries per slot before the
      # request is quarantined (requeued with its committed prefix),
      # and requeues per request before it is failed.
      "resilience.max_step_retries": 1,
      "resilience.max_requeues": 1,
      # Hung-step watchdog: log + trace when one fused step (dispatch +
      # result fetch) exceeds this wall-clock deadline (0 = off).  The
      # step is not interrupted — observability, like the fit() one.
      "resilience.step_timeout_s": 0.0,
      # --- replicated serving control plane (serving/router.py,
      # docs/serving.md "Multi-replica serving").  N engine replicas —
      # each with its own mesh/engine, sharing nothing but the params
      # source — behind a health-checked Router: bit-exact failover of
      # queued AND in-flight requests via the prefix-replay path,
      # graceful drain + warm rejoin, prefix-affinity + least-loaded
      # dispatch degrading to round-robin on stale signals.
      "router.replicas": 1,
      # Expected heartbeat interval: each completed replica step beats;
      # load signals older than 2x this are considered stale (dispatch
      # degrades to round-robin).
      "router.heartbeat_s": 1.0,
      # Heartbeat age that moves a replica healthy -> suspect (no new
      # dispatch, existing work continues) and suspect -> down (its
      # requests fail over to survivors).  suspect_after <= down_after.
      "router.suspect_after": 3.0,
      "router.down_after": 10.0,
      # Graceful drain: a draining replica gets this long to finish its
      # active requests before the leftovers are migrated to survivors
      # (0 = migrate immediately).
      "router.drain_timeout_s": 30.0,
      # Prefix-affinity dispatch: route requests sharing a prompt prefix
      # to the replica that served it last (warm KV / prefix-cache
      # locality), load permitting.  Off = pure least-loaded.
      "router.affinity": True,
      # --- replica transports (serving/transport.py, docs/serving.md
      # "Replica transports").  "inproc" (default) hosts replicas in
      # the router's process, byte-for-byte the PR-8 behavior;
      # "process" spawns each replica as a subprocess owning its own
      # JAX runtime (the REAL fault domain: SIGKILL-survivable
      # failover via the router-side journal, wire-level timeouts,
      # idempotent retries).  Process mode needs a Router(factory=...)
      # spec ("module:attr" building (model, params) in the child).
      "router.transport": "inproc",
      # Per-RPC wire deadline.  Generous by default — a child's first
      # step carries XLA compilation; chaos tests tighten it.  A STEP
      # that misses the deadline condemns the replica (fenced with
      # SIGKILL at evacuation) because steps are not idempotent.
      "router.rpc_timeout_s": 30.0,
      # Idempotent-call retries (submit/restore/cancel/snapshot) after
      # the first attempt, with jittered exponential backoff from
      # rpc_backoff_s.  Retried submits cannot double-admit: the child
      # dedups by uid.
      "router.rpc_retries": 2,
      "router.rpc_backoff_s": 0.05,
      # Deadline for a spawned child to import JAX, build its engine
      # from the factory, and answer the init frame.
      "router.spawn_timeout_s": 120.0,
      # --- reactor router core (serving/reactor.py, docs/serving.md
      # "Front door").  Readiness-driven dispatch: each live replica
      # gets its next step the moment its previous reply lands
      # (selectors over the process transport's socket; in-process
      # replicas through a queue-backed readiness shim), so one slow
      # replica no longer gates the fleet.  Consumed by router.run()
      # and the front door's driver; router.step() stays the lock-step
      # sweep either way (simulator / replay compatibility).
      "router.reactor": False,
      # Per-replica step quota inside one reactor cycle: a fast replica
      # may run up to this many steps while a slow peer finishes one;
      # control-plane actions (autoscale/rollout/drain/parked flush)
      # still land only at cycle boundaries — the same mutation-safety
      # contract as the sweep.
      "router.reactor_max_steps": 4,
      # --- streaming front door (serving/frontdoor/, docs/serving.md
      # "Front door").  A stdlib HTTP/1.1 server exposing POST
      # /v1/generate with SSE token streaming — tokens surface per
      # engine iteration as they commit (scheduler.on_tokens), never
      # by polling `finished` — plus per-connection backpressure and
      # cancel-on-disconnect wired to the router's cancel(uid).
      "frontdoor.host": "127.0.0.1",
      # 0 = ephemeral: the OS picks a free port; FrontDoor.address
      # reports the bound one (tests and the bench always use this).
      "frontdoor.port": 0,
      # Per-connection bounded buffer, in SSE token events: a slow
      # reader's flow queues up to this many undelivered events, then
      # its request is cancelled (finish_reason "cancelled", SSE
      # `shed` terminal) — backpressure sheds ONLY that flow, never
      # the fleet.
      "frontdoor.stream_buffer": 64,
      # Per-connection socket write deadline: a reader that keeps a
      # write blocked this long is treated as disconnected (its flow
      # cancelled), bounding a handler thread's stall.
      "frontdoor.write_timeout_s": 10.0,
      # SSE keepalive comment cadence while a stream is idle — also
      # the cancel-on-disconnect probe: a dropped client surfaces as
      # the keepalive write failing.
      "frontdoor.keepalive_s": 2.0,
      # --- engine autotuner (serving/autotune.py, docs/robustness.md
      # "Self-healing fleet").  An SLO-breach-driven actuator that moves
      # DATA-VALUED knobs between fused steps — speculation-k clamp,
      # prefill-budget clamp, effective slot cap, degradation-ladder
      # floor — under the compile-once constraint (never a shape).
      # Needs observability.slo.enabled to hear breaches.
      "autotune.enabled": False,
      # Clean engine steps (no matching breach) before the autotuner
      # releases ONE level — hysteretic recovery mirroring the
      # admission ladder, so a stale breach cannot pin the engine slow.
      "autotune.hold_steps": 50,
      # Highest tune level the autotuner may reach (1 = spec_trim,
      # 2 = budget_tight, 3 = slot_cap; see serving/autotune.py).
      "autotune.max_level": 3,
      # Effective-slot-cap floor at the slot_cap level: the autotuner
      # never clamps concurrency below this many slots.
      "autotune.min_slots": 1,
      # Prefill-budget clamp at budget_tight and above, in chunks:
      # effective budget = budget_chunks * prefill_chunk.
      "autotune.budget_chunks": 1,
      # --- fleet autoscaler (serving/autoscale.py, docs/robustness.md
      # "Self-healing fleet").  SLO-burn-driven replica-set policy over
      # the router's existing drain()/rejoin()/add_replica() levers:
      # grow on sustained fast+slow-window burn, shrink via graceful
      # drain once the budget recovers.  Needs observability.slo.enabled.
      "autoscale.enabled": False,
      # Live-replica-set bounds (live = healthy + suspect).
      "autoscale.min_replicas": 1,
      "autoscale.max_replicas": 4,
      # Cooldown after a scale-up before the next one (the base of the
      # flap breaker's doubling hold-out), and the quiet period (no
      # relevant breach) required before a scale-down.
      "autoscale.scale_up_cooldown_s": 5.0,
      "autoscale.scale_down_cooldown_s": 30.0,
      # A scale-up this soon after a scale-down counts as a flap and
      # doubles the scale-up hold-out (trip decay after a clean window),
      # reusing the replica breaker's doubling-hold-out shape.
      "autoscale.flap_window_s": 60.0,
      # Extra SLO rule names (beyond every burn-rate rule, which always
      # actuates) whose breaches trigger scale-up, e.g. "ttft_p99".
      "autoscale.rules": (),
      # Spawn replicas synchronously inside on_step() instead of on the
      # router's spawn thread.  Deterministic (replay/simulation) at the
      # cost of blocking the sweep for the spawn's duration; the async
      # path stays the production default.
      "autoscale.sync_spawn": False,
      # Predictive scale-up (promoted from fleet simulation, see
      # docs/simulator.md): sample the router's cumulative submitted
      # count, estimate the arrival-rate slope over this window as
      # (late-half rate - early-half rate) / (window/2), and scale up
      # BEFORE the burn-rate breach when the slope exceeds the
      # threshold below.  0 slope = rule off (the repo-wide idiom).
      "autoscale.predictive_window_s": 1.0,
      # Arrival-rate slope threshold in requests/s per second.  Tune
      # via `make sim-bench`; must stay high enough that steady
      # fault-free traffic (slope ~ 0) never fires it.
      "autoscale.predictive_slope": 0.0,
      # --- blue/green checkpoint rollout (serving/rollout.py,
      # docs/robustness.md "Blue/green rollout").  A RolloutController
      # on the router ships checkpoint N+1 under live traffic: validate
      # the checkpoint, spawn green replicas off the sweep thread,
      # shift admission weight green-ward in stages (canary fraction
      # first, watched by version-scoped SLO breach streams), then cut
      # over and drain blue complete-in-place — with automatic
      # rollback (drain green, restore blue weights) on any
      # canary-scoped breach or green spawn failure.
      "rollout.enabled": False,
      # Admission-weight fraction routed to green during the canary
      # stage (the rest stays on blue).
      "rollout.canary_frac": 0.1,
      # How long the canary stage must run breach-free before full
      # cutover.
      "rollout.canary_hold_s": 10.0,
      # Blues below this live count are never drained mid-rollout (the
      # fleet's capacity floor while green capacity is still unproven).
      "rollout.min_replicas": 1,
      # Deadline for ALL green replicas to spawn + init; exceeded =
      # rollback (greens drained, blue weights restored).
      "rollout.spawn_timeout_s": 300.0,
      # Graceful-drain window for blue replicas after cutover (their
      # in-flight requests complete in place; leftovers past the
      # window migrate — only ever to a same-version survivor).
      "rollout.drain_timeout_s": 30.0,
      # Extra SLO rule names (beyond every burn-rate rule) whose
      # green-scoped breaches roll the canary back, e.g. "ttft_p99".
      "rollout.rules": (),
  }

  @property
  def speculative(self) -> _SubGroup:
    return _SubGroup(self, "speculative")

  @property
  def paged(self) -> _SubGroup:
    return _SubGroup(self, "paged")

  @property
  def prefix_cache(self) -> _SubGroup:
    return _SubGroup(self, "prefix_cache")

  @property
  def resilience(self) -> _SubGroup:
    return _SubGroup(self, "resilience")

  @property
  def router(self) -> _SubGroup:
    return _SubGroup(self, "router")

  @property
  def frontdoor(self) -> _SubGroup:
    return _SubGroup(self, "frontdoor")

  @property
  def autotune(self) -> _SubGroup:
    return _SubGroup(self, "autotune")

  @property
  def autoscale(self) -> _SubGroup:
    return _SubGroup(self, "autoscale")

  @property
  def rollout(self) -> _SubGroup:
    return _SubGroup(self, "rollout")


class ObservabilityConfig(_Category):
  """Unified tracing & telemetry (observability/, docs/observability.md).
  New vs the reference, whose observability is re-pointed TF summaries
  plus RunMetadata FULL_TRACE capture (epl/parallel/hooks.py:593-664)."""
  _name = "observability"
  _fields = {
      # Master switch for the host-side span tracer: fit() and the
      # serving engine record phase spans / per-request timelines into
      # the ambient tracer (observability.trace.get_tracer()).  Off by
      # default; when off every instrumentation site is a no-op context
      # manager (no allocation, no host sync).
      "enabled": False,
      # Where fit() exports the Chrome-trace / Perfetto JSON at the end
      # of a run ("" = <checkpoint_dir>/trace.json when a checkpoint dir
      # is set, else no auto-export).  Serving callers export explicitly
      # via get_tracer().export(path).  Load at ui.perfetto.dev.
      "trace_path": "",
      # Ring-buffer capacity in EVENTS (a span is two events).  The ring
      # keeps the most recent window and counts what it evicted — a
      # bounded-memory flight recorder, not a full-run archive.
      "ring_capacity": 65536,
      # Sampling for the per-step train-loop phase spans (data-next /
      # step-dispatch / metrics-flush): record every 1/sample_rate-th
      # step's phases.  Request-lifecycle, checkpoint, and resilience
      # events are never sampled.  1.0 records everything.
      "sample_rate": 1.0,
      # When fit() gets a checkpoint_dir but no metrics_writer,
      # auto-construct a leader-only JSONL MetricsWriter at
      # <checkpoint_dir>/metrics.jsonl behind a namespaced
      # MetricRegistry (train/* + resilience/* keys), so runs are never
      # silently unlogged.  An explicitly passed writer always wins.
      "metrics_jsonl": True,
      # --- SLO monitoring & anomaly-triggered deep capture
      # (observability/slo.py, docs/observability.md "SLO monitoring").
      # Master switch: the serving engine and router build/attach the
      # ambient SLOMonitor at entry when on; every breach/recovery is a
      # slo_events.jsonl line + slo/breach trace instant + listener
      # callback.  Off keeps every record path byte-identical.
      "slo.enabled": False,
      # Machine-readable breach/recovery log ("" = memory + trace only).
      "slo.events_path": "",
      # Threshold rules (0 = rule off).  Bare-name metric matching:
      # each target evaluates against the fleet rollup, every
      # serving/replica<i>/* record, AND a bare engine's serving/*
      # records, as separate breach streams.
      "slo.ttft_p99_s": 0.0,
      "slo.itl_p99_s": 0.0,
      # Shed-rate error budget: promised non-shed fraction (e.g. 0.99 =
      # at most 1% of requests may shed; 0 = rule off), evaluated as
      # multi-window burn rates over the last fast_window / slow_window
      # records — both must exceed their thresholds to breach.
      "slo.shed_objective": 0.0,
      "slo.fast_window": 5,
      "slo.slow_window": 20,
      "slo.fast_burn": 10.0,
      "slo.slow_burn": 2.0,
      # Fleet availability rule: any replicas_down > 0 in the fleet
      # rollup is a breach window (the failover acceptance signal).
      "slo.replicas_down": True,
      # Anomaly-triggered deep capture: on breach / watchdog fire /
      # recompile, dump a bounded diagnostic bundle (tracer ring tail,
      # registry snapshot, scheduler state summary) into this dir
      # ("" = capture off), staged + atomically renamed, keeping at
      # most capture_limit bundles and at most one per
      # capture_min_interval_s (a flapping fleet cannot fill the disk).
      "slo.capture_dir": "",
      "slo.capture_limit": 8,
      "slo.capture_min_interval_s": 30.0,
      "slo.capture_ring_tail": 2048,
      # Also arm a jax.profiler device capture around the NEXT fused
      # step after an ENGINE-ATTRIBUTED breach (recompile / watchdog —
      # the payload's twin names the engine; fleet-level rule breaches
      # arm nothing, lest one kill device-profile every healthy
      # replica).  Written under <bundle>/xla.  Off by default: device
      # captures are heavy.
      "slo.capture_xla": False,
      # Breach when any local device's bytes_in_use / bytes_limit
      # exceeds this fraction (0 = rule off).  Fed by the device
      # introspector's HBM gauges (observability/device.py) — only
      # backends whose memory_stats() reports a limit ever produce the
      # hbm_frac metric, so the rule is naturally inert on CPU.
      "slo.hbm_frac": 0.0,
      # --- Device-truth introspection (observability/device.py,
      # docs/observability.md "Device truth").  Master switch: at
      # warmup every compiled twin's cost/memory analysis is captured
      # into a CostCard (flops, wire bytes per overlap site, static HBM
      # plan, donation-verified), HBM watermark gauges ride the serving
      # stats cadence, and measured per-site collective bytes feed the
      # overlap planner automatically.  Off by default: capture pays
      # one extra (AOT) compile per twin at warmup.
      "device.enabled": False,
      # Sample jax.local_devices()[i].memory_stats() (static cost-card
      # bound where unavailable) into observability/device/* gauges +
      # Perfetto counters on the engine's stats cadence.
      "device.hbm_gauges": True,
      # Feed introspector-measured per-SITE collective bytes into
      # communicators.overlap.resolve_num_chunks (analytic fallback
      # preserved; ROADMAP item 5c).
      "device.site_feed": True,
      # Also dump every captured cost card to this JSON path (atomic
      # rewrite per capture; "" = memory only).
      "device.cards_path": "",
      # --- Cross-process trace harvest (docs/observability.md
      # "Distributed tracing").  With observability.enabled on a
      # process-transport fleet, each child replica drains its tracer
      # ring over the wire (bounded chunks piggybacked on step replies
      # + a final flush on clean shutdown/evacuation) and the parent
      # merges the rebased events into one Perfetto export.  Off keeps
      # child rings child-local (the pre-distributed behaviour).
      "harvest.enabled": True,
      # Encoded-byte bound per harvest sweep: one step reply carries at
      # most this many bytes of trace events, so harvest can never
      # stall dispatch; the remainder rides later sweeps.
      "harvest.max_bytes_per_sweep": 65536,
      # Deadline for the explicit full-ring drain (`harvest` RPC loop)
      # used by Router.harvest_traces() and the final flush paths.
      "harvest.final_timeout_s": 5.0,
  }

  @property
  def slo(self) -> _SubGroup:
    return _SubGroup(self, "slo")

  @property
  def device(self) -> _SubGroup:
    return _SubGroup(self, "device")

  @property
  def harvest(self) -> _SubGroup:
    return _SubGroup(self, "harvest")


class SimConfig(_Category):
  """Cost-card fleet simulator (easyparallellibrary_tpu/sim/,
  docs/simulator.md).  Every knob feeds the discrete-event episode
  builder only — nothing here is read by live serving."""
  _name = "sim"
  _fields = {
      # Seed for the simulator's xorshift RNG (arrivals, prompt shapes,
      # fault draws).  Same seed + same config = bit-identical episode.
      "seed": 0,
      # Fleet size for a sweep episode (the replay harness takes its
      # size from the recorded episode instead).
      "replicas": 100,
      # Simulated episode length in virtual seconds.
      "duration_s": 60.0,
      # Arrival trace shape: poisson | zipf | diurnal | overload
      # (sim/arrivals.py; diurnal modulates a Poisson base rate by a
      # day-curve, overload reuses testing/chaos.py's burst shape).
      "trace": "diurnal",
      # Mean arrival rate in requests/s across the whole fleet
      # (0 = derive from the fleet's modeled capacity: ~70% of
      # aggregate decode throughput, so default sweeps run loaded but
      # not saturated).
      "arrival_rate_rps": 0.0,
      # SimReplica step-cost physics, seconds per token.  0 = calibrate
      # from the newest hardware-provenance serving record in
      # BENCH_EVIDENCE.json (sim/replica.py::calibrate); set explicitly
      # to model other hardware from its cost card.
      "prefill_token_cost_s": 0.0,
      "decode_token_cost_s": 0.0,
      # Fixed per-step host overhead (dispatch, bookkeeping) added to
      # every modeled step.
      "step_overhead_s": 5e-5,
      # Fault injector: virtual seconds a simulated spawn takes before
      # the new replica lands (0 = spawns land on the next sweep).
      "spawn_delay_s": 0.0,
  }


class Config:
  """Root configuration (reference: epl/config.py:181).

  Accepts a flat dict with dotted keys (EPL style), e.g.::

      Config({"pipeline.num_micro_batch": 4, "zero.level": "v1"})

  or a nested dict ``{"pipeline": {"num_micro_batch": 4}}``.
  """

  _categories: Tuple[type, ...] = (
      AutoParallelConfig, IOConfig, CommunicationConfig, PipelineConfig,
      GradientCheckpointConfig, ZeroConfig, OffloadConfig, AMPConfig,
      ClusterConfig, OptimizerConfig, SequenceConfig, ResilienceConfig,
      ServingConfig, ObservabilityConfig, SimConfig,
  )

  def __init__(self, param_dict: Dict[str, Any] | None = None):
    by_cat: Dict[str, Dict[str, Any]] = {c._name: {} for c in self._categories}
    for key, value in (param_dict or {}).items():
      if isinstance(value, dict):
        cat, sub = key, value
        if cat not in by_cat:
          raise ValueError(f"Unknown config category '{cat}'")
        by_cat[cat].update(sub)
      else:
        if "." not in key:
          raise ValueError(
              f"Config key '{key}' must be '<category>.<attr>' or a nested "
              f"dict. Categories: {sorted(by_cat)}")
        cat, attr = key.split(".", 1)
        if cat not in by_cat:
          raise ValueError(f"Unknown config category '{cat}' in key '{key}'")
        by_cat[cat][attr] = value
    for cls in self._categories:
      object.__setattr__(self, cls._name, cls(by_cat[cls._name]))
    self.validate()

  def __setattr__(self, key, value):
    raise AttributeError(
        "Config categories are fixed; set leaves like "
        "`config.pipeline.num_micro_batch = 4` instead.")

  def validate(self):
    """Cross-field validation (reference: epl/config.py:301-305)."""
    from easyparallellibrary_tpu_torch.utils.logging import get_logger
    if self.communication.sparse_as_dense:
      # Accepted for API parity but a no-op here: JAX gradients are always
      # dense arrays (the reference converts IndexedSlices,
      # epl/parallel/hooks.py:161-167).  Warn loudly so nobody believes
      # the knob did something (VERDICT round-1 weak item 6).
      get_logger().warning(
          "communication.sparse_as_dense=True has NO effect on TPU: JAX "
          "gradients are always dense; the knob exists only for config "
          "compatibility with the reference.")
    if self.gradient_checkpoint.end_taskgraph != -1:
      get_logger().warning(
          "gradient_checkpoint.end_taskgraph=%s has NO effect: remat is "
          "applied per block/stage (gradient_checkpoint.type, "
          "GPTConfig.remat), not per taskgraph index; the knob exists "
          "only for config compatibility with the reference.",
          self.gradient_checkpoint.end_taskgraph)
    if self.zero.level not in ("", constants.ZERO_V0, constants.ZERO_V1):
      raise ValueError(f"zero.level must be '', 'v0' or 'v1'; "
                       f"got {self.zero.level!r}")
    if self.offload.level not in ("", constants.OFFLOAD_V0):
      raise ValueError(f"offload.level must be '' or 'v0'; "
                       f"got {self.offload.level!r}")
    if self.amp.level not in ("", constants.AMP_O0, constants.AMP_O1):
      raise ValueError(f"amp.level must be '', 'O0' or 'O1'; "
                       f"got {self.amp.level!r}")
    if self.amp.compute_dtype not in ("bf16", "fp16"):
      raise ValueError(f"amp.compute_dtype must be 'bf16' or 'fp16'; "
                       f"got {self.amp.compute_dtype!r}")
    if self.gradient_checkpoint.type not in (
        "", constants.GC_COLLECTION, constants.GC_AUTO):
      raise ValueError("gradient_checkpoint.type must be '', 'collection' "
                       f"or 'auto'; got {self.gradient_checkpoint.type!r}")
    if self.sequence.parallelism not in (
        "", constants.SEQ_PARALLEL_RING, constants.SEQ_PARALLEL_ULYSSES):
      raise ValueError("sequence.parallelism must be '', 'ring' or "
                       f"'ulysses'; got {self.sequence.parallelism!r}")
    if self.sequence.ring_impl not in ("flash", "einsum", "dense"):
      raise ValueError("sequence.ring_impl must be 'flash', 'einsum' or "
                       f"'dense'; got {self.sequence.ring_impl!r}")
    if self.sequence.ulysses_impl not in ("flash", "einsum"):
      raise ValueError("sequence.ulysses_impl must be 'flash' or "
                       f"'einsum'; got {self.sequence.ulysses_impl!r}")
    if self.sequence.ring_layout not in ("contiguous", "zigzag"):
      raise ValueError("sequence.ring_layout must be 'contiguous' or "
                       f"'zigzag'; got {self.sequence.ring_layout!r}")
    if self.pipeline.num_micro_batch < 1:
      raise ValueError("pipeline.num_micro_batch must be >= 1")
    if self.pipeline.num_stages < 1:
      raise ValueError("pipeline.num_stages must be >= 1")
    if self.pipeline.engine not in ("", "vmap", "smap"):
      raise ValueError("pipeline.engine must be '', 'vmap' or 'smap'; "
                       f"got {self.pipeline.engine!r}")
    if self.communication.gradients_reduce_method not in ("mean", "sum"):
      raise ValueError("communication.gradients_reduce_method must be "
                       "'mean' or 'sum'")
    if self.communication.compress_dtype not in ("", "bf16", "fp16"):
      raise ValueError("communication.compress_dtype must be '', 'bf16' "
                       f"or 'fp16'; got {self.communication.compress_dtype!r}")
    if self.communication.overlap not in ("auto", "on", "off"):
      raise ValueError("communication.overlap must be 'auto', 'on' or "
                       f"'off'; got {self.communication.overlap!r}")
    if self.communication.overlap_chunks < 0:
      raise ValueError("communication.overlap_chunks must be >= 0; got "
                       f"{self.communication.overlap_chunks}")
    for field in ("keep_last", "max_bad_steps", "io_retries"):
      if getattr(self.resilience, field) < 0:
        raise ValueError(f"resilience.{field} must be >= 0; got "
                         f"{getattr(self.resilience, field)}")
    for field in ("io_retry_backoff_s", "step_timeout_s"):
      if getattr(self.resilience, field) < 0:
        raise ValueError(f"resilience.{field} must be >= 0; got "
                         f"{getattr(self.resilience, field)}")
    if not 0 < self.resilience.rollback_lr_backoff <= 1:
      raise ValueError("resilience.rollback_lr_backoff must be in (0, 1]; "
                       f"got {self.resilience.rollback_lr_backoff}")
    if self.serving.num_slots < 1:
      raise ValueError(f"serving.num_slots must be >= 1; "
                       f"got {self.serving.num_slots}")
    if self.serving.prefill_chunk < 1:
      raise ValueError(f"serving.prefill_chunk must be >= 1; "
                       f"got {self.serving.prefill_chunk}")
    if self.serving.prefill_token_budget < 0:
      raise ValueError(f"serving.prefill_token_budget must be >= 0; "
                       f"got {self.serving.prefill_token_budget}")
    if 0 < self.serving.prefill_token_budget < self.serving.prefill_chunk:
      raise ValueError(
          "serving.prefill_token_budget must be 0 (uncapped) or >= "
          f"serving.prefill_chunk ({self.serving.prefill_chunk}); a "
          "smaller budget could never afford any request's first chunk; "
          f"got {self.serving.prefill_token_budget}")
    if self.serving.max_batch < 0:
      raise ValueError(f"serving.max_batch must be >= 0; "
                       f"got {self.serving.max_batch}")
    if self.serving.stop_token < -1:
      raise ValueError(f"serving.stop_token must be >= -1; "
                       f"got {self.serving.stop_token}")
    if self.serving.finished_limit < 0:
      raise ValueError(f"serving.finished_limit must be >= 0 (0 = keep "
                       f"all); got {self.serving.finished_limit}")
    paged = self.serving.paged
    if paged.block_size < 1:
      raise ValueError(f"serving.paged.block_size must be >= 1; "
                       f"got {paged.block_size}")
    if paged.num_blocks < 0:
      raise ValueError(f"serving.paged.num_blocks must be >= 0 (0 = "
                       f"auto); got {paged.num_blocks}")
    if paged.token_budget < 0:
      raise ValueError(f"serving.paged.token_budget must be >= 0 (0 = "
                       f"auto); got {paged.token_budget}")
    pcache = self.serving.prefix_cache
    if pcache.enabled and not paged.enabled:
      raise ValueError(
          "serving.prefix_cache.enabled requires serving.paged.enabled: "
          "prefix caching shares KV at the paged layout's block "
          "granularity (engine kwargs can still combine paged=True with "
          "prefix_cache=True explicitly)")
    if pcache.session_ttl_s < 0:
      raise ValueError(f"serving.prefix_cache.session_ttl_s must be >= 0 "
                       f"(0 = no TTL); got {pcache.session_ttl_s}")
    if pcache.max_cached_blocks < 0:
      raise ValueError(f"serving.prefix_cache.max_cached_blocks must be "
                       f">= 0 (0 = uncapped); "
                       f"got {pcache.max_cached_blocks}")
    spec = self.serving.speculative
    if spec.k < 1:
      raise ValueError(
          f"serving.speculative.k must be >= 1; got {spec.k}")
    if spec.kind not in ("ngram", "draft_model"):
      raise ValueError("serving.speculative.kind must be 'ngram' or "
                       f"'draft_model'; got {spec.kind!r}")
    if not 1 <= spec.ngram_min <= spec.ngram_max:
      raise ValueError(
          "serving.speculative needs 1 <= ngram_min <= ngram_max; got "
          f"ngram_min={spec.ngram_min}, ngram_max={spec.ngram_max}")
    if self.observability.ring_capacity < 1:
      raise ValueError(f"observability.ring_capacity must be >= 1; "
                       f"got {self.observability.ring_capacity}")
    if not 0.0 < self.observability.sample_rate <= 1.0:
      raise ValueError(f"observability.sample_rate must be in (0, 1]; "
                       f"got {self.observability.sample_rate}")
    slo = self.observability.slo
    for field in ("ttft_p99_s", "itl_p99_s", "capture_min_interval_s"):
      if getattr(slo, field) < 0:
        raise ValueError(f"observability.slo.{field} must be >= 0 "
                         f"(0 = off); got {getattr(slo, field)}")
    if not 0.0 <= slo.shed_objective < 1.0:
      raise ValueError(
          f"observability.slo.shed_objective must be in [0, 1) (0 = "
          f"rule off); got {slo.shed_objective}")
    if not 1 <= slo.fast_window <= slo.slow_window:
      raise ValueError(
          f"observability.slo needs 1 <= fast_window <= slow_window; "
          f"got fast_window={slo.fast_window}, "
          f"slow_window={slo.slow_window}")
    if slo.fast_burn <= 0 or slo.slow_burn <= 0:
      raise ValueError(
          f"observability.slo burn thresholds must be > 0; got "
          f"fast_burn={slo.fast_burn}, slow_burn={slo.slow_burn}")
    if slo.capture_limit < 1:
      raise ValueError(f"observability.slo.capture_limit must be >= 1; "
                       f"got {slo.capture_limit}")
    if slo.capture_ring_tail < 1:
      raise ValueError(
          f"observability.slo.capture_ring_tail must be >= 1; got "
          f"{slo.capture_ring_tail}")
    if not 0.0 <= slo.hbm_frac < 1.0:
      raise ValueError(
          f"observability.slo.hbm_frac must be in [0, 1) (0 = rule "
          f"off); got {slo.hbm_frac}")
    harvest = self.observability.harvest
    if harvest.max_bytes_per_sweep < 1024:
      raise ValueError(
          f"observability.harvest.max_bytes_per_sweep must be >= 1024 "
          f"(one sweep must fit at least a few events); got "
          f"{harvest.max_bytes_per_sweep}")
    if harvest.final_timeout_s <= 0:
      raise ValueError(
          f"observability.harvest.final_timeout_s must be > 0; got "
          f"{harvest.final_timeout_s}")
    if spec.enabled and spec.k + 1 > self.serving.prefill_chunk:
      raise ValueError(
          f"serving.speculative.k={spec.k} needs serving.prefill_chunk "
          f">= k + 1 (the fused step carries each decode slot's last "
          f"committed token plus its k drafts in one chunk); got "
          f"prefill_chunk {self.serving.prefill_chunk}")
    res = self.serving.resilience
    if res.queue_limit < 0:
      raise ValueError(f"serving.resilience.queue_limit must be >= 0 "
                       f"(0 = unbounded); got {res.queue_limit}")
    if res.itl_slo_s < 0:
      raise ValueError(f"serving.resilience.itl_slo_s must be >= 0 "
                       f"(0 = off); got {res.itl_slo_s}")
    if not 0.0 < res.degrade_queue_frac <= 1.0:
      raise ValueError(
          f"serving.resilience.degrade_queue_frac must be in (0, 1]; "
          f"got {res.degrade_queue_frac}")
    if res.max_step_retries < 0 or res.max_requeues < 0:
      raise ValueError(
          "serving.resilience.max_step_retries and max_requeues must be "
          f">= 0; got {res.max_step_retries}, {res.max_requeues}")
    if res.step_timeout_s < 0:
      raise ValueError(f"serving.resilience.step_timeout_s must be >= 0 "
                       f"(0 = off); got {res.step_timeout_s}")
    router = self.serving.router
    if router.replicas < 1:
      raise ValueError(f"serving.router.replicas must be >= 1; "
                       f"got {router.replicas}")
    if router.heartbeat_s <= 0:
      raise ValueError(f"serving.router.heartbeat_s must be > 0; "
                       f"got {router.heartbeat_s}")
    if not 0 < router.suspect_after <= router.down_after:
      raise ValueError(
          f"serving.router.suspect_after must be > 0 and <= down_after "
          f"(a replica cannot go down before it goes suspect); got "
          f"suspect_after={router.suspect_after}, "
          f"down_after={router.down_after}")
    if router.transport not in ("inproc", "process"):
      raise ValueError(
          f"serving.router.transport must be 'inproc' or 'process'; "
          f"got {router.transport!r}")
    if router.rpc_timeout_s <= 0:
      raise ValueError(f"serving.router.rpc_timeout_s must be > 0; "
                       f"got {router.rpc_timeout_s}")
    if router.rpc_retries < 0:
      raise ValueError(f"serving.router.rpc_retries must be >= 0; "
                       f"got {router.rpc_retries}")
    if router.rpc_backoff_s < 0:
      raise ValueError(f"serving.router.rpc_backoff_s must be >= 0; "
                       f"got {router.rpc_backoff_s}")
    if router.spawn_timeout_s <= 0:
      raise ValueError(f"serving.router.spawn_timeout_s must be > 0; "
                       f"got {router.spawn_timeout_s}")
    if router.reactor_max_steps < 1:
      raise ValueError(f"serving.router.reactor_max_steps must be >= 1; "
                       f"got {router.reactor_max_steps}")
    frontdoor = self.serving.frontdoor
    if not 0 <= frontdoor.port <= 65535:
      raise ValueError(f"serving.frontdoor.port must be in [0, 65535]; "
                       f"got {frontdoor.port}")
    if frontdoor.stream_buffer < 1:
      raise ValueError(f"serving.frontdoor.stream_buffer must be >= 1; "
                       f"got {frontdoor.stream_buffer}")
    if frontdoor.write_timeout_s <= 0:
      raise ValueError(f"serving.frontdoor.write_timeout_s must be > 0; "
                       f"got {frontdoor.write_timeout_s}")
    if frontdoor.keepalive_s <= 0:
      raise ValueError(f"serving.frontdoor.keepalive_s must be > 0; "
                       f"got {frontdoor.keepalive_s}")
    if router.drain_timeout_s < 0:
      raise ValueError(f"serving.router.drain_timeout_s must be >= 0 "
                       f"(0 = migrate immediately); got "
                       f"{router.drain_timeout_s}")
    tune = self.serving.autotune
    if tune.hold_steps < 1:
      raise ValueError(f"serving.autotune.hold_steps must be >= 1; "
                       f"got {tune.hold_steps}")
    if not 0 <= tune.max_level <= 3:
      raise ValueError(f"serving.autotune.max_level must be in [0, 3]; "
                       f"got {tune.max_level}")
    if tune.min_slots < 1:
      raise ValueError(f"serving.autotune.min_slots must be >= 1; "
                       f"got {tune.min_slots}")
    if tune.budget_chunks < 1:
      raise ValueError(
          f"serving.autotune.budget_chunks must be >= 1 (a smaller "
          f"clamp could never afford any request's first chunk); got "
          f"{tune.budget_chunks}")
    scale = self.serving.autoscale
    if not 1 <= scale.min_replicas <= scale.max_replicas:
      raise ValueError(
          f"serving.autoscale needs 1 <= min_replicas <= max_replicas; "
          f"got min_replicas={scale.min_replicas}, "
          f"max_replicas={scale.max_replicas}")
    for field in ("scale_up_cooldown_s", "scale_down_cooldown_s",
                  "flap_window_s", "predictive_slope"):
      if getattr(scale, field) < 0:
        raise ValueError(f"serving.autoscale.{field} must be >= 0; "
                         f"got {getattr(scale, field)}")
    if scale.predictive_window_s <= 0:
      raise ValueError(
          f"serving.autoscale.predictive_window_s must be > 0 (the "
          f"slope estimate divides by it); got "
          f"{scale.predictive_window_s}")
    sim = self.sim
    if sim.replicas < 1:
      raise ValueError(f"sim.replicas must be >= 1; got {sim.replicas}")
    if sim.duration_s <= 0:
      raise ValueError(f"sim.duration_s must be > 0; got {sim.duration_s}")
    if sim.trace not in ("poisson", "zipf", "diurnal", "overload"):
      raise ValueError(
          f"sim.trace must be one of poisson/zipf/diurnal/overload; "
          f"got {sim.trace!r}")
    for field in ("arrival_rate_rps", "prefill_token_cost_s",
                  "decode_token_cost_s", "step_overhead_s",
                  "spawn_delay_s"):
      if getattr(sim, field) < 0:
        raise ValueError(f"sim.{field} must be >= 0; "
                         f"got {getattr(sim, field)}")
    roll = self.serving.rollout
    if not 0.0 < roll.canary_frac <= 1.0:
      raise ValueError(
          f"serving.rollout.canary_frac must be in (0, 1] (a zero "
          f"canary never observes green under load); got "
          f"{roll.canary_frac}")
    if roll.min_replicas < 1:
      raise ValueError(f"serving.rollout.min_replicas must be >= 1; "
                       f"got {roll.min_replicas}")
    for field in ("canary_hold_s", "drain_timeout_s"):
      if getattr(roll, field) < 0:
        raise ValueError(f"serving.rollout.{field} must be >= 0; "
                         f"got {getattr(roll, field)}")
    if roll.spawn_timeout_s <= 0:
      raise ValueError(f"serving.rollout.spawn_timeout_s must be > 0; "
                       f"got {roll.spawn_timeout_s}")

  def to_dict(self) -> Dict[str, Dict[str, Any]]:
    return {c._name: getattr(self, c._name).to_dict()
            for c in self._categories}

  def __repr__(self):
    return f"Config({self.to_dict()})"
