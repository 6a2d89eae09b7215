"""Continuous-batching serving (PyTorch port): the contiguous-slot engine
(the default) and the paged one, with speculative decoding, copy-on-write
prefix caching (paged) and serving resilience."""

from easyparallellibrary_tpu_torch.serving._capabilities import (
    FINISH_REASONS, PRIORITIES, check_draft_compatible, check_servable)
from easyparallellibrary_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, filtered_logits, sample_token_slots)
from easyparallellibrary_tpu_torch.serving.kv_cache import (
    NULL_BLOCK, BlockAllocator, SlotAllocator, allocate_kv_cache,
    allocate_paged_kv_cache, blocks_per_slot, cache_bytes, cache_length,
    default_num_blocks, paged_cache_bytes)
from easyparallellibrary_tpu_torch.serving.prefix_cache import (
    PrefixCache, block_prefix_keys)
from easyparallellibrary_tpu_torch.serving.resilience import (
    DEGRADE_LEVELS, AdmissionController, BadStepPolicy, ReplicaHealth)
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FCFSScheduler, FinishedRequest, PagedStepPlan, Request, StepPlan)
from easyparallellibrary_tpu_torch.serving.speculative import (
    Drafter, DraftModelDrafter, NgramDrafter, ngram_propose, verify_tokens)

__all__ = [
    "DEGRADE_LEVELS", "NULL_BLOCK", "AdmissionController", "BadStepPolicy",
    "BlockAllocator", "ContinuousBatchingEngine", "Drafter",
    "DraftModelDrafter", "FCFSScheduler", "FINISH_REASONS",
    "FinishedRequest", "NgramDrafter", "PagedStepPlan", "PrefixCache",
    "PRIORITIES", "ReplicaHealth", "Request", "SlotAllocator", "StepPlan",
    "allocate_kv_cache", "allocate_paged_kv_cache", "block_prefix_keys",
    "blocks_per_slot", "cache_bytes", "cache_length",
    "check_draft_compatible", "check_servable", "default_num_blocks",
    "filtered_logits", "ngram_propose", "paged_cache_bytes",
    "sample_token_slots", "verify_tokens",
]
