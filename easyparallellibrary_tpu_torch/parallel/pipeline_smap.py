"""The ``smap`` pipeline engine: stage-resident boundary layers (port of
``easyparallellibrary_tpu/parallel/pipeline_smap.py``).

The JAX engine drops to ``shard_map`` over the ``stage`` axis so that
each device runs its own stage program, with real branches for bubble
ticks, and makes the tied embedding and the LM head stage-resident: the
``[V, D]`` table is vocab-sharded over the stage axis (``[V/S, D]`` a
stage), the lookup sums partial lookups over the axis, and the softmax
cross-entropy takes its max and sums over the axis in fp32.  The port's
executor (``parallel/pipeline.py``) is per-rank already; this module
keeps the stage-resident layers' collectives and builds the GPipe and
1F1B gradient functions with ``collective_boundary``: every rank feeds,
emits and runs the feed's backward at the same tick.

Where the model is tensor-parallel too, the vocab splits over
``(stage, model)``, stage-major (:func:`vocab_axes`): the sums run over
both groups, and a rank's ``[V / (S tp), D]`` rows sit at
``(stage * tp + model) * V / (S tp)``.

Gradients, in the port's explicit SPMD: the emit runs on every rank on
the last stage's output (broadcast over the stage axis); each rank's
vocab slab takes its exact gradient from the sharded cross-entropy, and
the hidden state's gradient, the sum of the slabs' partials
(``bridging.copy_to_split``), is whole on every rank, so the final
LayerNorm's gradient is the same on every rank.  The feed's backward
broadcasts stage 0's input cotangent, so each rank scatters it into its
own rows and the position table's gradient is whole on every rank.  No
stage-replicated leaf needs the JAX engine's sum over the stage axis;
the ``vmap`` layout's boundary leaves do (:func:`_reduce_grads`).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives, fusion
from easyparallellibrary_tpu_torch.parallel.pipeline import (
    Pipeline, gpipe_schedule)
from easyparallellibrary_tpu_torch.parallel.schedule_1f1b import (
    one_f_one_b_schedule)


def vocab_axes(tensor_parallel: bool) -> Tuple[str, ...]:
  """The axes a stage-resident vocab splits over, outermost first."""
  if tensor_parallel:
    return (constants.STAGE_AXIS, constants.MODEL_AXIS)
  return (constants.STAGE_AXIS,)


def vocab_shard(axes: Sequence[str], mesh=None) -> Tuple[int, int]:
  """``(n, i)``: the number of vocab shards over ``axes`` and this
  rank's index among them (row-major over the axes)."""
  n, i = 1, 0
  for axis in axes:
    size = collectives.axis_size(axis, mesh)
    n, i = n * size, i * size + collectives.axis_index(axis, mesh)
  return n, i


def vocab_rows(vocab_size: int, axes: Sequence[str], mesh=None) -> int:
  """Rows of a stage-resident table on this rank; the vocab must divide
  the shards (padded rows would corrupt the sharded normaliser)."""
  n, _ = vocab_shard(axes, mesh)
  if vocab_size % n:
    raise ValueError(f"vocab_size {vocab_size} must divide into {n} "
                     f"stage-resident shards (over {tuple(axes)})")
  return vocab_size // n


def vocab_partial_embed(table_local, ids, axes: Sequence[str] = (
    constants.STAGE_AXIS,), mesh=None):
  """Lookup of ``ids`` in this rank's rows of the table (JAX
  ``vocab_partial_embed``): rows of ids outside the range are zero, so
  the sum over ``axes`` of the partials is the whole lookup."""
  rows = table_local.shape[0]
  _, i = vocab_shard(axes, mesh)
  loc = ids - i * rows
  ok = (loc >= 0) & (loc < rows)
  out = torch.nn.functional.embedding(torch.where(ok, loc,
                                                  torch.zeros_like(loc)),
                                      table_local)
  return torch.where(ok[..., None], out, torch.zeros_like(out))


def sharded_softmax_ce(local_logits, labels, *, z_loss: float = 0.0,
                       axes: Sequence[str] = (constants.STAGE_AXIS,),
                       mesh=None):
  """Cross-entropy over vocab-sharded logits (JAX ``sharded_softmax_ce``):
  ``local_logits [..., V/n]`` this rank's slab; the max (no gradient),
  the normaliser and the label logit are reduced over ``axes`` in fp32.
  Returns the per-token fp32 loss, ``labels``' shape.  Every rank holds
  the same loss, and the sums' backward is the identity (the port's
  replicated-loss convention), so each slab gets its own exact
  gradient."""
  Vs = local_logits.shape[-1]
  _, i = vocab_shard(axes, mesh)
  ll32 = local_logits.float()
  lmax = ll32.amax(-1).detach()
  for axis in axes:
    lmax = collectives.all_reduce(lmax, axis, op=collectives.MAX, mesh=mesh)
  ll32 = ll32 - lmax[..., None]
  z = torch.exp(ll32).sum(-1)
  loc = labels.long() - i * Vs
  ok = (loc >= 0) & (loc < Vs)
  picked = ll32.gather(-1, torch.where(ok, loc,
                                       torch.zeros_like(loc))[..., None])[..., 0]
  label_logit = torch.where(ok, picked, torch.zeros_like(picked))
  for axis in axes:
    z = collectives.all_reduce(z, axis, mesh=mesh)
    label_logit = collectives.all_reduce(label_logit, axis, mesh=mesh)
  logz = torch.log(z)
  loss = logz - label_logit
  if z_loss:
    loss = loss + z_loss * torch.square(logz + lmax)
  return loss


def check_unpadded_vocab(vocab_size: int, mesh) -> None:
  """TP with the stage-resident CE needs an unpadded vocab table:
  ``vocab_size`` must divide the mesh's ``model`` axis (the JAX rule)."""
  model_size = mesh.axis_size(constants.MODEL_AXIS) if mesh else 1
  if vocab_size % max(model_size, 1):
    raise ValueError(
        f"smap engine with tensor_parallel needs an unpadded vocab "
        f"table: vocab_size {vocab_size} must divide the model axis "
        f"({model_size}) — padded vocab rows would corrupt the "
        f"stage-resident CE normalizer")


def _reduce_grads(params: Dict[str, torch.Tensor],
                  stage_summed: Iterable[str], mesh=None) -> None:
  """The engines' cross-rank gradient reduction over the stage axis:
  each leaf of ``stage_summed`` (a boundary leaf of the ``vmap`` layout,
  whose gradient each rank holds only its part of: the feed's on stage
  0, the emit's on the last) is summed over the stage group, bucketed,
  in place.  The mean over ``data`` is the train step's
  (``parallel.api.reduce_gradients``), as every step's; ZeRO-1 under the
  pipeline is not ported (ROADMAP.md Queue 1)."""
  if collectives.axis_size(constants.STAGE_AXIS, mesh) <= 1:
    return
  grads = {}
  for n in stage_summed:
    p = params[n]
    grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
  if not grads:
    return
  summed = fusion.batch_all_reduce(grads, constants.STAGE_AXIS)
  for n, g in summed.items():
    params[n].grad = g


def make_smap_gpipe_grad_fn(feed_fn: Callable, stage_fn: Callable,
                            emit_fn: Callable, num_stages: int,
                            num_micro_batch: int, *,
                            act_shape: Sequence[int],
                            act_dtype: torch.dtype, device,
                            mesh=None) -> Callable:
  """GPipe order with stage-resident boundary layers: ``feed_fn`` and
  ``emit_fn`` hold stage-axis collectives and run on every rank at the
  same tick (``parallel.pipeline.Pipeline``'s contracts).  Returns
  ``grad_fn(mbs, loss_scale=None) -> loss`` (the executor)."""
  return Pipeline(gpipe_schedule(num_stages, num_micro_batch), feed_fn,
                  stage_fn, emit_fn, act_shape=act_shape,
                  act_dtype=act_dtype, device=device,
                  collective_boundary=True, mesh=mesh)


def make_smap_1f1b_grad_fn(feed_fn: Callable, stage_fn: Callable,
                           emit_fn: Callable, num_stages: int,
                           num_micro_batch: int, *,
                           act_shape: Sequence[int],
                           act_dtype: torch.dtype, device,
                           mesh=None) -> Callable:
  """True 1F1B with stage-resident boundary layers (the 1F1B table of
  ``schedule_1f1b``, stage remat; a stage holds at most ``min(M,
  2S - 1)`` inputs).  Returns ``grad_fn(mbs, loss_scale=None) ->
  loss`` (the executor)."""
  return Pipeline(one_f_one_b_schedule(num_stages, num_micro_batch),
                  feed_fn, stage_fn, emit_fn, act_shape=act_shape,
                  act_dtype=act_dtype, device=device,
                  collective_boundary=True, mesh=mesh)

