"""Layers of the PyTorch port."""

from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding, LayerNorm

__all__ = ["Dense", "Embedding", "LayerNorm"]
