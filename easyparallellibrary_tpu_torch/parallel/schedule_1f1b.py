"""True 1F1B (one-forward-one-backward) pipeline schedule (port of
``easyparallellibrary_tpu/parallel/schedule_1f1b.py``).

The point of 1F1B is the live-activation bound: a stage holds at most
``min(M, 2S - 1)`` in-flight micro-batches' inputs instead of GPipe's
``M``, and recomputes its forward in the backward (the reference's
PreferBackward frees and recomputes).  The JAX package writes the
gradient by hand as one scan whose every tick advances a forward and a
backward wavefront; the port writes the same timeline as a table for
the per-rank executor (``parallel/pipeline.py``):

  forward   of m at stage s       at t = m + s
  loss+emit of m (after stage S-1) at t = m + (S - 1)
  backward  of m at stage s       at t = m + 2(S - 1) - s

so stage s keeps its input for m from tick m + s to m + 2(S-1) - s.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from easyparallellibrary_tpu_torch.parallel.pipeline import (
    PipeSchedule, Pipeline, make_ticks)


def one_f_one_b_schedule(S: int, M: int) -> PipeSchedule:
  """The 1F1B timeline above as a table, with stage remat."""
  if S < 2:
    raise ValueError("a pipeline needs at least 2 stages")
  T = M + 2 * (S - 1)
  fwd = [[None] * S for _ in range(T)]
  bwd = [[None] * S for _ in range(T)]
  for m in range(M):
    for s in range(S):
      fwd[m + s][s] = (0, m)
      bwd[m + 2 * (S - 1) - s][s] = (0, m)
  return PipeSchedule("1f1b", S, 1, M, make_ticks(S, 1, fwd, bwd),
                      remat_stage=True)


def one_f_one_b(feed_fn: Callable, stage_fn: Callable, emit_fn: Callable,
                num_stages: int, num_micro_batch: int, *,
                act_shape: Sequence[int], act_dtype: torch.dtype, device,
                mesh=None) -> Callable:
  """A 1F1B gradient function with the boundary layers replicated (the
  ``vmap`` layout: rank 0 feeds, the last rank emits).  Contracts as
  ``parallel.pipeline.Pipeline``'s; returns ``grad_fn(mbs,
  loss_scale=None) -> loss`` (the executor), which adds the gradients of
  ``loss_scale * mean_m loss_m`` into the parameters' ``.grad``."""
  return Pipeline(one_f_one_b_schedule(num_stages, num_micro_batch),
                  feed_fn, stage_fn, emit_fn, act_shape=act_shape,
                  act_dtype=act_dtype, device=device, mesh=mesh)
