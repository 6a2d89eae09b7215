"""Deterministic ``(model, params)`` builders (port of
``easyparallellibrary_tpu/testing/factories.py``): what a process
replica's child imports by name (``"module:attr"`` plus JSON kwargs)
and the parent calls for its oracle.  Identical kwargs give identical
weights in every process: ``weights.init_params`` draws with numpy."""

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


# GPT-350M's published widths (bench.py's model, chip_smoke.py's serving
# phases).
GPT_350M = dict(vocab_size=32768, num_heads=16, d_model=1024, d_ff=4096,
                max_seq_len=1024)


def gpt_350m(dtype: str = "bfloat16", num_layers: int = 24, seed: int = 0,
             device=None) -> Tuple[object, Dict[str, torch.Tensor]]:
  """GPT-350M in ``dtype`` (a ``torch`` dtype name, so the kwargs stay
  JSON for a process replica's factory spec) with fp32 weights from
  ``weights.init_params(seed)`` on ``device`` (default ``"cuda"``).
  ``num_layers`` cuts depth, never width.  Deterministic in its kwargs:
  a parent and its children hold bit-identical weights."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.weights import init_params

  cfg = GPTConfig(**GPT_350M, num_layers=num_layers,
                  dtype=getattr(torch, dtype))
  return GPT(cfg), init_params(cfg, seed, device=device)
