"""Sequence parallelism over the ``seq`` axis: ring attention and
Ulysses (port of ``easyparallellibrary_tpu/sequence``)."""

from easyparallellibrary_tpu_torch.sequence.ring_attention import (
    ring_attention)
from easyparallellibrary_tpu_torch.sequence.ulysses import ulysses_attention

__all__ = ["ring_attention", "ulysses_attention"]
