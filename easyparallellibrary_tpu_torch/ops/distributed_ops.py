"""Distributed prediction ops and the boundary dense paths (port of
``easyparallellibrary_tpu/ops/distributed_ops.py``).

``distributed_argmax`` is the reference's two-level argmax, written out
as GSPMD compiles it: each rank's local maximum and its global index,
gathered over ``model``, then the first global maximum (``jnp.argmax``'s
tie rule).  ``gather_matmul`` / ``matmul_scatter`` route a gather ->
matmul or matmul -> scatter boundary through the overlap rings of
``communicators/overlap.py`` under the ``communication.overlap`` policy.
"""

from __future__ import annotations

from typing import Optional

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives


def distributed_argmax(logits, axis: int = -1,
                       vocab_size: Optional[int] = None):
  """Argmax over logits, or over this rank's vocab block of them on a
  model axis above 1 (``vocab_size``: the unpadded width).  Returns the
  global index (int64) on every rank."""
  name = constants.MODEL_AXIS
  tp = collectives.axis_size(name)
  if tp <= 1:
    return torch.argmax(logits, dim=axis)
  x = logits.movedim(axis, -1)
  block = x.shape[-1]
  offset = collectives.axis_index(name) * block
  if vocab_size is not None and offset + block > vocab_size:
    cols = offset + torch.arange(block, device=x.device)
    x = torch.where(cols < vocab_size, x,
                    torch.tensor(float("-inf"), dtype=x.dtype,
                                 device=x.device))
  val, idx = x.max(dim=-1)
  vals = collectives.all_gather(val, name, axis=0, tiled=False)
  idxs = collectives.all_gather(idx + offset, name, axis=0, tiled=False)
  # The first rank holding the maximum has its lowest index.
  best = torch.argmax(vals, dim=0)
  return idxs.gather(0, best[None])[0]


def distributed_equal(predictions, labels):
  """Elementwise equality of (possibly shard-derived) predictions and
  replicated labels."""
  return torch.eq(predictions.to(torch.int32), labels.to(torch.int32))


def gather_matmul(x, w, axis_name: str = constants.SEQ_AXIS,
                  num_chunks: Optional[int] = None):
  """``all_gather(x, axis=0) @ w`` at a parallel boundary (``x`` this
  rank's ``[t_loc, D]`` rows), ring-overlapped per the overlap policy;
  bit-exact against the fused gather and product."""
  from easyparallellibrary_tpu_torch.communicators import overlap
  from easyparallellibrary_tpu_torch.parallel.planner import (
      SITE_GATHER_MATMUL)
  n = collectives.axis_size(axis_name)
  if num_chunks is None:
    num_chunks = overlap.resolve_num_chunks(
        "all_gather_matmul", n, m=x.shape[0], k=x.shape[1],
        n_out=w.shape[1], dtype=x.dtype, site=SITE_GATHER_MATMUL)
  return overlap.all_gather_matmul(x, w, axis_name, num_chunks=num_chunks)


def matmul_scatter(x, w, axis_name: str = constants.SEQ_AXIS,
                   num_chunks: Optional[int] = None):
  """``reduce_scatter(x @ w, axis=0)`` at a parallel boundary,
  ring-overlapped per the overlap policy; equal to the fused product and
  scatter up to the order of the sums."""
  from easyparallellibrary_tpu_torch.communicators import overlap
  from easyparallellibrary_tpu_torch.parallel.planner import (
      SITE_MATMUL_SCATTER)
  n = collectives.axis_size(axis_name)
  if num_chunks is None:
    num_chunks = overlap.resolve_num_chunks(
        "matmul_reduce_scatter", n, m=x.shape[0], k=x.shape[1],
        n_out=w.shape[1], dtype=x.dtype, site=SITE_MATMUL_SCATTER)
  return overlap.matmul_reduce_scatter(x, w, axis_name,
                                       num_chunks=num_chunks)
