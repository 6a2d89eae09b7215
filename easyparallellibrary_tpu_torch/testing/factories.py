"""Deterministic ``(model, params)`` builders (port of
``easyparallellibrary_tpu/testing/factories.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def tiny_gpt(vocab_size: int = 64, num_layers: int = 2,
             num_heads: int = 4, d_model: int = 32, d_ff: int = 64,
             max_seq_len: int = 32, seed: int = 0, device=None
             ) -> Tuple[object, Dict[str, torch.Tensor]]:
  """A tiny fp32 GPT and its weights from ``weights.init_params(seed)``
  on ``device`` (default ``"cuda"``): identical kwargs give identical
  weights in every process."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.weights import init_params

  cfg = GPTConfig(vocab_size=vocab_size, num_layers=num_layers,
                  num_heads=num_heads, d_model=d_model, d_ff=d_ff,
                  max_seq_len=max_seq_len, dtype=torch.float32)
  return GPT(cfg), init_params(cfg, seed, device=device)
