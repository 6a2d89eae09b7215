"""Explicit-collective data parallelism (port of
``easyparallellibrary_tpu/parallel/explicit.py``).

The step the JAX package runs inside ``shard_map`` over the data axis,
on this rank: the local gradients of its rows of the global batch,
reduced over the data group through the fusion buckets of
``communicators/fusion.py`` (``communication.fusion_threshold_mb``,
``max_splits``, ``compress_dtype`` / ``compress_scale`` for a bf16 or
fp16 wire, ``num_communicators``), divided for a mean, then the
optimizer's step; the loss and the aux metrics are averaged over the
data group.
"""

from __future__ import annotations

from typing import Callable

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives, fusion
from easyparallellibrary_tpu_torch.env import Env


def make_explicit_dp_train_step(loss_fn: Callable, mesh,
                                config=None) -> Callable:
  """``(state, batch, rng) -> (state, metrics)`` with the gradient
  all-reduce written out over the data axis.  Parameters and optimizer
  state are replicated; ``batch`` is the global batch, of which this
  rank takes its rows."""
  cfg = config if config is not None else Env.get().config
  comm = cfg.communication
  axis = constants.DATA_AXIS

  def step(state, batch, rng):
    from easyparallellibrary_tpu_torch.parallel.api import local_batch
    for p in state.params.values():
      p.grad = None
    loss, aux = loss_fn(state.params, local_batch(batch, mesh), rng)
    loss.backward()
    with torch.no_grad():
      grads = {n: p.grad for n, p in state.params.items()}
      grads = fusion.batch_all_reduce(
          grads, axis, op=collectives.SUM,
          fusion_threshold_mb=comm.fusion_threshold_mb,
          max_splits=comm.max_splits, compress_dtype=comm.compress_dtype,
          compress_scale=comm.compress_scale,
          num_communicators=comm.num_communicators)
      n = collectives.axis_size(axis, mesh)
      for name, p in state.params.items():
        g = grads[name]
        p.grad = g / n if comm.gradients_reduce_method == "mean" else g
    state.apply_gradients()
    metrics = {"loss": collectives.all_reduce(loss.detach(), axis,
                                              op=collectives.MEAN)}
    for k, v in (aux or {}).items():
      metrics[k] = collectives.all_reduce(
          torch.as_tensor(v).detach().float(), axis, op=collectives.MEAN)
    return state, metrics

  step.mesh = mesh
  return step
