"""Layers, losses, bridges and optimizers of the PyTorch port."""

from easyparallellibrary_tpu_torch.ops.adamw import adam_weight_decay_optimizer
from easyparallellibrary_tpu_torch.ops.bridging import (
    copy_to_split, replica_to_split, split_to_replica)
from easyparallellibrary_tpu_torch.ops.distributed_ops import (
    distributed_argmax, distributed_equal, gather_matmul, matmul_scatter)
from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding, LayerNorm
from easyparallellibrary_tpu_torch.ops.losses import (
    distributed_sparse_softmax_cross_entropy_with_logits)

__all__ = ["Dense", "Embedding", "LayerNorm", "adam_weight_decay_optimizer",
           "distributed_sparse_softmax_cross_entropy_with_logits",
           "copy_to_split", "replica_to_split", "split_to_replica",
           "distributed_argmax", "distributed_equal", "gather_matmul",
           "matmul_scatter"]
