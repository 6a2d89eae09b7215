"""Cross-entropy over the vocab, plain or vocab-parallel (port of
``easyparallellibrary_tpu/ops/losses.py``).

The JAX version writes the softmax once over the global array and lets
GSPMD lower the max and the sums into collectives over ``model``.  With
the vocab split over ranks the port writes those collectives out, as the
reference library did by hand: the maximum (MAX), the normaliser (SUM)
and the label logit (SUM, each rank contributing the labels in its
range), all in fp32.  On a mesh without a model axis it is the plain
softmax.
"""

from __future__ import annotations

from typing import Optional

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives


def distributed_sparse_softmax_cross_entropy_with_logits(
    labels, logits, *, z_loss: float = 0.0,
    vocab_size: Optional[int] = None):
  """Per-example cross entropy (fp32, ``labels``' shape) of int labels
  ``[...]`` against logits ``[..., vocab]`` in their compute dtype, or
  against this rank's vocab block ``[..., V_pad / tp]`` on a model axis
  above 1 (``vocab_size``: the unpadded width, whose padded columns are
  left out of the normaliser).

  The max is taken in the storage dtype (exact: an order statistic) and
  carries no gradient.  One fp32 view of the logits feeds both the
  normalizer and the label pick, so in the backward both cotangents (the
  softmax probabilities and the -1 at the label) add in fp32 and round
  to the storage dtype once: the label gradient ``p - 1`` survives even
  where ``bf16(p) == 1``.  ``z_loss`` adds ``z_loss * log(Z)^2``.
  """
  axis = constants.MODEL_AXIS
  tp = collectives.axis_size(axis)
  block = logits.shape[-1]
  offset = collectives.axis_index(axis) * block if tp > 1 else 0
  logits32 = logits.float()
  pad = (vocab_size is not None and tp > 1
         and offset + block > vocab_size)
  if pad:
    cols = offset + torch.arange(block, device=logits.device)
    logits32 = torch.where(cols < vocab_size, logits32,
                           torch.tensor(float("-inf"), device=logits.device))
  m32 = logits32.amax(-1, keepdim=True).detach()
  if tp > 1:
    m32 = collectives.all_reduce(m32, axis, op=collectives.MAX)
  sum_exp = torch.exp(logits32 - m32).sum(-1, keepdim=True)
  if tp > 1:
    sum_exp = collectives.all_reduce(sum_exp, axis)
  total_log_z = torch.log(sum_exp) + m32
  labels = labels[..., None].long()
  if tp > 1:
    mine = (labels >= offset) & (labels < offset + block)
    local = torch.where(mine, labels - offset, torch.zeros_like(labels))
    picked = logits32.gather(-1, local)
    label_logit = collectives.all_reduce(
        torch.where(mine, picked, torch.zeros_like(picked)), axis)
  else:
    label_logit = logits32.gather(-1, labels)
  loss = (total_log_z - label_logit)[..., 0]
  if z_loss:
    loss = loss + z_loss * torch.square(total_log_z[..., 0])
  return loss
