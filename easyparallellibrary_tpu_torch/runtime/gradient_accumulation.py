"""Gradient accumulation — a large effective batch without a pipeline
(port of ``easyparallellibrary_tpu/runtime/gradient_accumulation.py``).

The JAX package scans ``num_micro_batch`` slices of the batch inside one
jitted step and averages loss, aux metrics and gradients.  Here a
gradient function accumulates into the parameters' ``.grad``:
:func:`backward_fn` makes one from a loss function, and
:func:`accumulate_gradients` runs it over the micro-batches with each
backward weighted by ``1 / num_micro_batch``, so ``.grad`` ends as the
average and the optimizer applies once per step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from easyparallellibrary_tpu_torch.observability.trace import step_span
from easyparallellibrary_tpu_torch.utils import prng


def backward_fn(loss_fn: Callable,
                loss_scale: Optional[torch.Tensor] = None) -> Callable:
  """``grad_fn(params, batch, rng, weight=1.0) -> (loss, aux)`` from
  ``loss_fn(params, batch, rng) -> (loss, aux)``: runs the forward and
  the backward of ``weight * loss`` (times ``loss_scale`` when given,
  the fp16 loss scale), adding the gradients into each parameter's
  ``.grad``.  Returns the unweighted loss, detached, and ``aux``."""

  def grad_fn(params, batch, rng, weight: float = 1.0):
    with step_span("train/forward"):
      loss, aux = loss_fn(params, batch, rng)
    scaled = loss * weight if weight != 1.0 else loss
    if loss_scale is not None:
      scaled = scaled * loss_scale.to(loss.dtype)
    with step_span("train/backward"):
      scaled.backward()
    return loss.detach(), dict(aux or {})

  return grad_fn


def fold_rng(rng, i: int):
  """The key of micro-batch (or step) ``i``: ``rng`` folded with ``i``
  (``utils.prng.fold_in``), kept as a host ``uint32 [2]`` array."""
  if rng is None:
    return None
  import numpy as np
  key = torch.as_tensor(np.asarray(rng).astype(np.int64))
  return prng.fold_in(key, torch.tensor(i)).numpy().astype(np.uint32)


def accumulate_gradients(grad_fn: Callable, num_micro_batch: int):
  """Wrap ``grad_fn(params, batch, rng, weight) -> (loss, aux)`` to run
  over ``num_micro_batch`` slices of the leading batch dimension: each
  slice's backward is weighted by ``weight / num_micro_batch``, each
  gets its own key (``rng`` folded with the slice index, so dropout
  masks differ between slices), and the loss and aux metrics are
  averaged over every slice."""
  if num_micro_batch <= 1:
    return grad_fn

  def accumulated(params, batch, rng, weight: float = 1.0):
    from easyparallellibrary_tpu_torch.utils.pytree import (
        split_micro_batches)
    micro = split_micro_batches(batch, num_micro_batch)
    inv = 1.0 / num_micro_batch
    loss_sum, aux_sum = None, {}
    for i in range(num_micro_batch):
      mb = {k: v[i] for k, v in micro.items()}
      loss, aux = grad_fn(params, mb, fold_rng(rng, i), weight * inv)
      loss_sum = loss if loss_sum is None else loss_sum + loss
      for k, v in aux.items():
        aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
    return loss_sum * inv, {k: v * inv for k, v in aux_sum.items()}

  return accumulated
