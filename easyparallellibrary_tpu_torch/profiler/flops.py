"""MFU accounting (port of ``easyparallellibrary_tpu/profiler/flops.py``).

The peak table (the dense bf16 tensor-core rate of the card, the one
denominator of every MFU number of the port), :func:`estimate_mfu`, and
the GPT forward's FLOP count that the serving engine's cost card
reports (observability/device.py).  The XLA cost analysis and the collective
parsers of the JAX version wait for later work (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Dense bf16 FLOP/s per card by `torch.cuda.get_device_name()` prefix
# (NVIDIA data sheets, without sparsity).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,   # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
    "NVIDIA H200": 989e12,
}
_GUESS = 989e12


def peak_flops_info(device=None) -> Tuple[float, bool]:
  """(peak bf16 FLOP/s, recognized?) for the card, matched on the
  longest name prefix.  An unknown card is flagged: the MFU denominator
  is then a guess."""
  name = torch.cuda.get_device_name(device)
  for prefix, flops in sorted(PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
    if name.startswith(prefix):
      return flops, True
  get_logger().warning("unknown device %r; assuming %.0f TFLOP/s — MFU "
                       "numbers against this denominator are guesses", name,
                       _GUESS / 1e12)
  return _GUESS, False


def peak_flops_per_chip(device=None) -> float:
  return peak_flops_info(device)[0]


def estimate_mfu(flops_per_step: float, step_time_s: float,
                 n_chips: Optional[int] = None, device=None) -> float:
  """Model FLOPs utilisation: ``flops_per_step`` over ``step_time_s``
  against the card's dense bf16 peak times ``n_chips`` (default: the
  visible CUDA devices)."""
  if n_chips is None:
    n_chips = max(1, torch.cuda.device_count())
  achieved = flops_per_step / max(step_time_s, 1e-12)
  return achieved / (peak_flops_per_chip(device) * n_chips)


def gpt_forward_flops(cfg: Any, tokens: int, context: int) -> float:
  """Forward FLOPs of ``tokens`` query tokens through a GPT of config
  ``cfg`` (``d_model``, ``d_ff``, ``num_layers``, ``vocab_size``), each
  attending ``context`` keys: two per multiply-add of every weight
  matrix (qkv and output projections, the MLP, the tied head) plus
  QK^T and PV."""
  D, F, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
  n_matmul = L * (4 * D * D + 2 * D * F) + D * V
  return float(tokens) * (2.0 * n_matmul + 4.0 * L * D * context)
