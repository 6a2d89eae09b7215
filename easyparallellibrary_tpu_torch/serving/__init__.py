"""Paged continuous-batching serving (PyTorch port)."""

from easyparallellibrary_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, filtered_logits, sample_token_slots)
from easyparallellibrary_tpu_torch.serving.kv_cache import (
    NULL_BLOCK, BlockAllocator, SlotAllocator, allocate_paged_kv_cache,
    blocks_per_slot, default_num_blocks, paged_cache_bytes)
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FCFSScheduler, FinishedRequest, PagedStepPlan, Request)

__all__ = [
    "NULL_BLOCK", "BlockAllocator", "ContinuousBatchingEngine",
    "FCFSScheduler", "FinishedRequest", "PagedStepPlan", "Request",
    "SlotAllocator", "allocate_paged_kv_cache", "blocks_per_slot",
    "default_num_blocks", "filtered_logits", "paged_cache_bytes",
    "sample_token_slots",
]
