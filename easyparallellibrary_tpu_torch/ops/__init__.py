"""Layers, losses and optimizers of the PyTorch port."""

from easyparallellibrary_tpu_torch.ops.adamw import adam_weight_decay_optimizer
from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding, LayerNorm
from easyparallellibrary_tpu_torch.ops.losses import (
    distributed_sparse_softmax_cross_entropy_with_logits)

__all__ = ["Dense", "Embedding", "LayerNorm", "adam_weight_decay_optimizer",
           "distributed_sparse_softmax_cross_entropy_with_logits"]
