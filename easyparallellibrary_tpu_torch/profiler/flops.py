"""MFU accounting (port of ``easyparallellibrary_tpu/profiler/flops.py``).

Only the peak table: the dense bf16 tensor-core rate of the card, the
one denominator of every MFU number of the port.  The XLA cost analysis
and the collective parsers of the JAX version wait for later work
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
