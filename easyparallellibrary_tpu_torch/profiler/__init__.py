"""Profiling of the PyTorch port: the step's FLOPs, bytes and memory,
MFU, and the serving statistics (the JAX package's exports)."""

from easyparallellibrary_tpu_torch.profiler.flops import (
    FlopsProfiler, compiled_cost, estimate_mfu, peak_flops_per_chip,
)
from easyparallellibrary_tpu_torch.profiler.memory import (
    MemoryProfiler, compiled_memory, device_memory_stats,
)
from easyparallellibrary_tpu_torch.profiler.profiler import StepProfiler
from easyparallellibrary_tpu_torch.profiler.serving import (
    ServingStats, fleet_summary, percentile,
)

__all__ = [
    "FlopsProfiler", "compiled_cost", "estimate_mfu", "peak_flops_per_chip",
    "MemoryProfiler", "device_memory_stats", "compiled_memory",
    "StepProfiler",
    "ServingStats", "fleet_summary", "percentile",
]
