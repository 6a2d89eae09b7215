"""The yardstick: the card's published peaks and the work an operation
requires.

Peaks are NVIDIA's data-sheet figures for the H100 SXM part (dense, no
sparsity, at its 700 W limit): 989 TFLOP/s for bf16 and fp16 on the
tensor cores, 495 for TF32, 67 for float32 outside them, and 3.35 TB/s
of HBM3.  A run on another card is refused rather than measured
against a guessed peak.

Counts are of the work the inputs require, whatever implements it:
two FLOPs a multiply-add; only the score pairs a mask leaves (a causal
mask keeps ``S (S + 1) / 2`` of ``S * S``); no recompute; each input
read once and each output written once.  An attention *operation* is
counted whole (the forward; the backward as dQ, dK and dV together), so
fusing or splitting its kernels leaves the count unchanged.
"""

from __future__ import annotations

import dataclasses

# Card name (``torch.cuda.get_device_name``) -> published peaks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
                  "float32": 67e12},
        "bytes_per_s": 3.35e12,
    },
}


def peaks(card: str) -> dict:
  """The published peaks of ``card``; raises for a card not listed."""
  for name, peak in PEAKS.items():
    if card.startswith(name):
      return peak
  raise ValueError(f"no published peaks for {card!r}: the benchmark "
                   f"measures against {sorted(PEAKS)}")


@dataclasses.dataclass(frozen=True)
class Attention:
  """One attention operation's shapes: ``B`` sequences, ``H`` heads of
  ``D``, ``S`` queries over ``S`` keys, elements of ``itemsize`` bytes
  (the log-sum-exp rows are float32)."""
  B: int
  H: int
  S: int
  D: int
  causal: bool
  itemsize: int = 2

  @property
  def pairs(self) -> int:
    """Score pairs the mask keeps, a sequence and a head."""
    S = self.S
    return S * (S + 1) // 2 if self.causal else S * S


def attention_forward(a: Attention):
  """``(flops, bytes)`` of the forward: QK^T and PV over the kept pairs;
  q, k, v read, the output and the log-sum-exp written."""
  flops = 4 * a.B * a.H * a.D * a.pairs
  rows = a.B * a.H * a.S
  return flops, a.itemsize * rows * a.D * 4 + 4 * rows


def attention_backward(a: Attention):
  """``(flops, bytes)`` of the backward: dP = dO V^T, dV = P^T dO, dQ =
  dS K and dK = dS^T Q over the kept pairs (the scores' recompute is
  not counted); q, k, v, the output, dO and the log-sum-exp read, dQ,
  dK and dV written."""
  flops = 8 * a.B * a.H * a.D * a.pairs
  rows = a.B * a.H * a.S
  return flops, a.itemsize * rows * a.D * 8 + 4 * rows


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes_per_s: float) -> float:
  """The least time the card could take: the larger of the operations
  over the peak rate and the bytes over the peak bandwidth."""
  return max(flops / peak_flops, nbytes / peak_bytes_per_s)


def dense_flops_per_token(layers: int, d_model: int, d_ff: int) -> float:
  """Training FLOPs a token of the blocks' matrix products (QKV, the
  output projection and the two MLP products): forward and backward,
  ``6 x`` their parameters."""
  return 6.0 * layers * (4 * d_model * d_model + 2 * d_model * d_ff)


def attention_flops_per_token(layers: int, a: Attention) -> float:
  """Training FLOPs a token of attention's products: the forward's
  required products and the backward's, which are twice as many."""
  fwd, _ = attention_forward(a)
  bwd, _ = attention_backward(a)
  return layers * (fwd + bwd) / (a.B * a.S)
