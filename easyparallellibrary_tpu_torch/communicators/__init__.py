"""Collectives, fusion buckets and the overlap rings on
``torch.distributed`` (port of ``easyparallellibrary_tpu/communicators``)."""

from easyparallellibrary_tpu_torch.communicators.collectives import (
    all_gather, all_reduce, all_to_all, axis_index, axis_size, broadcast,
    ppermute, reduce, reduce_scatter, ring_shift,
)
from easyparallellibrary_tpu_torch.communicators.fusion import (
    FusionPlan, batch_all_reduce, batch_reduce_scatter, build_fusion_plan,
)
from easyparallellibrary_tpu_torch.communicators.overlap import (
    all_gather_matmul, matmul_reduce_scatter, resolve_num_chunks, ring_step,
)

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast",
    "reduce", "ppermute", "ring_shift", "axis_index", "axis_size",
    "FusionPlan", "build_fusion_plan", "batch_all_reduce",
    "batch_reduce_scatter",
    "all_gather_matmul", "matmul_reduce_scatter", "resolve_num_chunks",
    "ring_step",
]
