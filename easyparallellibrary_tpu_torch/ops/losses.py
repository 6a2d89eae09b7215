"""Cross-entropy over the vocab (port of ``easyparallellibrary_tpu/ops/losses.py``).

The JAX version writes the vocab-sharded softmax once over the global
array and lets GSPMD insert the max/sum collectives.  The port runs on
one device, so the vocab sharding is a no-op and only the numerics
remain, kept as there.
"""

from __future__ import annotations

import torch


def distributed_sparse_softmax_cross_entropy_with_logits(
    labels, logits, *, z_loss: float = 0.0):
  """Per-example cross entropy (fp32, ``labels``' shape) of int labels
  ``[...]`` against logits ``[..., vocab]`` in their compute dtype.

  The max is taken in the storage dtype (exact: an order statistic) and
  carries no gradient.  One fp32 view of the logits feeds both the
  normalizer and the label pick, so in the backward both cotangents (the
  softmax probabilities and the -1 at the label) add in fp32 and round
  to the storage dtype once: the label gradient ``p - 1`` survives even
  where ``bf16(p) == 1``.  ``z_loss`` adds ``z_loss * log(Z)^2``.
  """
  m32 = logits.amax(-1, keepdim=True).detach().float()
  logits32 = logits.float()
  sum_exp = torch.exp(logits32 - m32).sum(-1, keepdim=True)
  total_log_z = torch.log(sum_exp) + m32
  label_logit = logits32.gather(-1, labels[..., None].long())
  loss = (total_log_z - label_logit)[..., 0]
  if z_loss:
    loss = loss + z_loss * torch.square(total_log_z[..., 0])
  return loss
