"""Paged continuous-batching serving (PyTorch port), with speculative
decoding and copy-on-write prefix caching."""

from easyparallellibrary_tpu_torch.serving._capabilities import (
    FINISH_REASONS, PRIORITIES, check_draft_compatible, check_servable)
from easyparallellibrary_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, filtered_logits, sample_token_slots)
from easyparallellibrary_tpu_torch.serving.kv_cache import (
    NULL_BLOCK, BlockAllocator, SlotAllocator, allocate_paged_kv_cache,
    blocks_per_slot, default_num_blocks, paged_cache_bytes)
from easyparallellibrary_tpu_torch.serving.prefix_cache import (
    PrefixCache, block_prefix_keys)
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FCFSScheduler, FinishedRequest, PagedStepPlan, Request)
from easyparallellibrary_tpu_torch.serving.speculative import (
    Drafter, DraftModelDrafter, NgramDrafter, ngram_propose, verify_tokens)

__all__ = [
    "NULL_BLOCK", "BlockAllocator", "ContinuousBatchingEngine",
    "Drafter", "DraftModelDrafter", "FCFSScheduler", "FINISH_REASONS",
    "FinishedRequest", "NgramDrafter", "PagedStepPlan", "PrefixCache",
    "PRIORITIES", "Request", "SlotAllocator", "allocate_paged_kv_cache",
    "block_prefix_keys", "blocks_per_slot", "check_draft_compatible",
    "check_servable", "default_num_blocks", "filtered_logits",
    "ngram_propose", "paged_cache_bytes", "sample_token_slots",
    "verify_tokens",
]
