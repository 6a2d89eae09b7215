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
the ``vmap`` layout's boundary leaves do (``parallel.api._reduce_grads``).

Sequence parallelism composes (:func:`seq_manual_mode`): under ring or
Ulysses attention on a seq axis the stage programs hold a slice of the
tokens (positions from :func:`token_offset_slice`) and run the
attention's seq collectives themselves.  The JAX engine must then run
stage compute branch-uniformly, since XLA lowers a collective-permute to
one channel over the whole mesh; the port's seq peers share a stage
index, walk the same table and skip the same ticks, so they meet at
every collective without it.  The gradients are averaged over the split
axes (the seq mean first) and then over ``data``, or reduce-scattered
there to their ZeRO owners, by the reduction every engine shares
(``parallel.api._reduce_grads``; the owner dims are
``runtime.zero.zero1_grad_layout``'s).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
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


def seq_manual_mode(attn_impl: str, num_heads: int):
  """``(seq_size, seq_manual)`` of a model wiring on the ambient mesh,
  with the JAX guards: the einsum ring cannot run in a stage program,
  and Ulysses needs the heads to divide the seq axis."""
  from easyparallellibrary_tpu_torch.env import Env
  seq_size = collectives.axis_size(constants.SEQ_AXIS)
  seq_manual = attn_impl in ("ring", "ulysses") and seq_size > 1
  if seq_manual:
    if attn_impl == "ring":
      ring_impl = Env.get().config.sequence.ring_impl
      if ring_impl not in ("flash", "dense"):
        raise ValueError(
            f"sequence.ring_impl={ring_impl!r} cannot run inside the "
            "smap engine's seq-manual region (the einsum ring is a "
            "global-array GSPMD program); use ring_impl='flash' or "
            "'dense', or a vmapped engine (pipeline.engine='')")
    elif num_heads % seq_size:
      raise ValueError(
          f"Ulysses on the smap engine requires num_heads "
          f"({num_heads}) divisible by the seq axis ({seq_size})")
  return seq_size, seq_manual


def token_offset_slice(table, t_loc: int, seq_manual: bool):
  """Rows of a replicated position table for this rank's token slice
  (offset ``seq_rank * t_loc``); the plain prefix otherwise."""
  if seq_manual:
    off = collectives.axis_index(constants.SEQ_AXIS) * t_loc
    return table[off:off + t_loc]
  return table[:t_loc]


def check_seq_token_count(n_tokens: int, seq_size: int,
                          seq_manual: bool) -> None:
  if seq_manual and n_tokens % seq_size:
    raise ValueError(
        f"token count {n_tokens} must divide into {seq_size} seq "
        "shards for sequence parallelism")


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

