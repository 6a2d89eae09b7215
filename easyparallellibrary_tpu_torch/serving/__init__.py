"""Continuous-batching serving (PyTorch port): the contiguous-slot engine
(the default) and the paged one, with speculative decoding, copy-on-write
prefix caching (paged) and serving resilience; and the replicated fleet:
engine replicas (:mod:`replica`) in process or in child processes
(:mod:`transport`) behind a health-checked router with failover by
prefix replay (:mod:`router`), healed by the engine autotuner
(:mod:`autotune`) and the fleet autoscaler (:mod:`autoscale`), rolled
to a new checkpoint blue/green (:mod:`rollout`), driven readiness-first
(:mod:`reactor`) and served over HTTP/SSE (:mod:`frontdoor`)."""

from easyparallellibrary_tpu_torch.serving._capabilities import (
    FINISH_REASONS, PRIORITIES, check_draft_compatible, check_servable)
from easyparallellibrary_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, filtered_logits, sample_token_slots)
from easyparallellibrary_tpu_torch.serving.kv_cache import (
    NULL_BLOCK, BlockAllocator, SlotAllocator, allocate_kv_cache,
    allocate_paged_kv_cache, blocks_per_slot, cache_bytes, cache_length,
    default_num_blocks, kv_cache_shardings, paged_cache_bytes)
from easyparallellibrary_tpu_torch.serving.prefix_cache import (
    PrefixCache, block_prefix_keys)
from easyparallellibrary_tpu_torch.serving.resilience import (
    DEGRADE_LEVELS, HEALTH_STATES, AdmissionController, BadStepPolicy,
    ReplicaHealth)
from easyparallellibrary_tpu_torch.serving.autoscale import FleetAutoscaler
from easyparallellibrary_tpu_torch.serving.autotune import (
    TUNE_LEVELS, EngineAutotuner)
from easyparallellibrary_tpu_torch.serving.replica import EngineReplica
from easyparallellibrary_tpu_torch.serving.rollout import RolloutController
from easyparallellibrary_tpu_torch.serving.router import Router
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FCFSScheduler, FinishedRequest, PagedStepPlan, Request, StepPlan)
from easyparallellibrary_tpu_torch.serving.speculative import (
    Drafter, DraftModelDrafter, NgramDrafter, ngram_propose, verify_tokens)
from easyparallellibrary_tpu_torch.serving.transport import (
    InprocTransport, ProcessTransport, RemoteError, ReplicaDeadError,
    ReplicaTransport, TransportError, TransportTimeout)

__all__ = [
    "DEGRADE_LEVELS", "NULL_BLOCK", "AdmissionController", "BadStepPolicy",
    "BlockAllocator", "ContinuousBatchingEngine", "Drafter",
    "DraftModelDrafter", "EngineAutotuner", "EngineReplica",
    "FCFSScheduler", "FleetAutoscaler", "RolloutController", "TUNE_LEVELS",
    "FINISH_REASONS", "FinishedRequest", "HEALTH_STATES", "InprocTransport",
    "NgramDrafter",
    "PagedStepPlan", "PrefixCache", "PRIORITIES", "ProcessTransport",
    "RemoteError", "ReplicaDeadError", "ReplicaHealth", "ReplicaTransport",
    "Request", "Router", "SlotAllocator", "StepPlan", "TransportError",
    "TransportTimeout",
    "allocate_kv_cache", "allocate_paged_kv_cache", "kv_cache_shardings",
    "block_prefix_keys",
    "blocks_per_slot", "cache_bytes", "cache_length",
    "check_draft_compatible", "check_servable", "default_num_blocks",
    "filtered_logits", "ngram_propose", "paged_cache_bytes",
    "sample_token_slots", "verify_tokens",
]
