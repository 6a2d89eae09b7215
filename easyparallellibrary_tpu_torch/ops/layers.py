"""Layers, with the tensor-parallel modes (port of
``easyparallellibrary_tpu/ops/layers.py``).

``Dense``, ``Embedding`` with its tied-head ``attend``, and
``LayerNorm`` with flax's numerics.  The JAX layers shard their
parameters by GSPMD metadata; here each rank holds its shard
(Megatron-style explicit SPMD) and the collectives GSPMD inserted are
written out:

* ``Dense(parallel="column")``: weight rows ``[out_pad / tp, in]``; the
  replicated input enters through ``bridging.copy_to_split`` and the
  output stays sharded on the feature dim (``bridging.split_to_replica``
  gathers it);
* ``Dense(parallel="row")``: weight ``[out, in_pad / tp]``; the input is
  this rank's feature block (a replicated input is cut to it), and the
  partial products are all-reduced over ``model`` before the bias, or
  run through the overlap ring (``communication.overlap``);
* ``Embedding(parallel="vocab")``: table rows ``[V_pad / tp, D]``; ids
  outside the rank's range are masked and the lookups all-reduced, and
  ``attend`` gives vocab-sharded logits.

Uneven widths are zero-padded to an even tiling, as the JAX layers pad
(``_round_up``, ``_padded_init``): the padded rows and columns are zero,
so they add nothing.  The tensor-parallel size is the ambient mesh's
``model`` axis when the layer is built.

``parallel="auto"`` (the default of both layers, as in JAX) is resolved
when the layer is built, from the innermost active ``split`` scope
(:func:`_active_split`): under one, a Dense is column-parallel and an
Embedding vocab-parallel; outside one, or at a model axis of 1, both are
``"none"``.  With ``auto.tensor_split`` the auto Dense layers built
inside one split scope alternate column, row, column... in the order
they are built (flax's ``Dense_<i>`` auto-names in the JAX layer; a
nested split continues its outer scope's count and does not re-shard).
A column layer fed this rank's feature block (another column layer's
output) gathers it first, the activation gather GSPMD inserts between
two column layers.

The stage-resident boundary layers of the ``smap`` pipeline engine
(``parallel/pipeline_smap.py``) split the vocab over the ``stage`` axis
(and over ``model`` inside it, stage-major, when the model is also
tensor-parallel): ``Embedding(parallel="stage_vocab")`` holds
``[V / n, D]`` rows and sums its partial lookups over the axes, and
``Dense(parallel="stage_column")`` (the untied head) holds ``[V / n,
D]`` and gives this rank's vocab slab of the logits, as ``attend``
does.  The vocab must divide ``n``.

Parameters are stored in ``param_dtype`` (fp32) like the flax modules.
The JAX layers cast a weight to the compute dtype on every call; the
serving engine casts the weights once at load instead
(:func:`easyparallellibrary_tpu_torch.weights.cast_for_compute`), which
gives the same numbers because a cast of a cast to the same dtype is the
identity (the per-call ``.to(dtype)`` below is then a no-op).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.kernels.layer_norm import layer_norm
from easyparallellibrary_tpu_torch.ops import bridging


def _model_axis_size() -> int:
  return collectives.axis_size(constants.MODEL_AXIS)


def _active_split():
  """The split scope that owns the layers being built: the innermost
  active scope when it is a split, or, for a nested split, the outer
  split it continues (``is_nested``); None outside a split."""
  from easyparallellibrary_tpu_torch.env import Env
  ctx = Env.get().strategy_context
  if ctx is None or ctx.current is None or ctx.current.kind != "split":
    return None
  for scope in reversed(ctx.stack):
    if scope.kind == "split" and not scope.is_nested:
      return scope
  return ctx.current


def _auto_mode(layer: str) -> str:
  """``parallel="auto"`` resolved at build time: ``"none"`` outside a
  split scope or at a model axis of 1; else an Embedding is ``"vocab"``
  and a Dense ``"column"``, or with ``auto.tensor_split`` ``"row"`` for
  every second auto Dense the scope builds."""
  scope = _active_split()
  if scope is None or _model_axis_size() <= 1:
    return "none"
  if layer == "embedding":
    return "vocab"
  from easyparallellibrary_tpu_torch.env import Env
  if not Env.get().config.auto.tensor_split:
    return "column"
  built = scope.auto_dense_built
  scope.auto_dense_built = built + 1
  return "row" if built % 2 else "column"


def _round_up(dim: int, multiple: int) -> int:
  return ((dim + multiple - 1) // multiple) * multiple


def _padded_init(value: torch.Tensor, padded_shape) -> torch.Tensor:
  """A parameter initialised at its logical shape, zero-padded to the
  padded shape (init statistics stay exact for uneven widths)."""
  pad = []
  for s, l in reversed(list(zip(padded_shape, value.shape))):
    pad += [0, s - l]
  return F.pad(value, pad) if any(pad) else value


class Dense(nn.Module):
  """``y = x @ kernel + bias`` in the compute dtype.

  ``weight`` is ``[out, in]`` (torch's ``Linear`` layout; the flax
  kernel is its transpose).  As in the JAX layer, the product is
  rounded to ``dtype`` before the bias is added in ``dtype``
  (``ops/layers.py:280,298`` of the JAX package).
  """

  def __init__(self, in_features: int, features: int, use_bias: bool = True,
               parallel: str = "auto", dtype: Optional[torch.dtype] = None,
               param_dtype: torch.dtype = torch.float32, device=None):
    super().__init__()
    if parallel not in ("auto", "none", "column", "row", "stage_column"):
      raise ValueError(f"Dense.parallel must be auto/none/column/row/"
                       f"stage_column, got {parallel!r}")
    if parallel == "auto":
      parallel = _auto_mode("dense")
    self.parallel = parallel
    self.tp = _model_axis_size() if parallel != "none" else 1
    self.in_features, self.features = in_features, features
    self.dtype = dtype
    out_local, in_local = features, in_features
    if parallel == "stage_column":
      from easyparallellibrary_tpu_torch.parallel import pipeline_smap
      self.vocab_axes = pipeline_smap.vocab_axes(self.tp > 1)
      out_local = pipeline_smap.vocab_rows(features, self.vocab_axes)
    elif parallel == "column":
      out_local = _round_up(features, self.tp) // self.tp
    elif parallel == "row":
      in_local = _round_up(in_features, self.tp) // self.tp
    self.weight = nn.Parameter(torch.empty(out_local, in_local,
                                           dtype=param_dtype, device=device))
    self.bias = (nn.Parameter(torch.empty(out_local, dtype=param_dtype,
                                          device=device))
                 if use_bias else None)
    # A column layer whose output dim is this many groups, each split
    # over ``model`` on its own (a fused QKV: q, k and v of the same
    # heads on a rank).  The checkpoint layout reads it.
    self.out_groups = 1

  def forward(self, x, dtype: Optional[torch.dtype] = None):
    """``dtype`` overrides the constructor's compute dtype for this call
    (amp O1: the GPT resolves its compute dtype at every forward)."""
    dtype = dtype or self.dtype or x.dtype
    if self.parallel == "stage_column":
      for axis in self.vocab_axes:
        x = bridging.copy_to_split(x, axis)
    elif self.tp > 1 and self.parallel == "column":
      if x.shape[-1] != self.in_features:     # my block: gather it
        x = bridging.split_to_replica(x, dim=-1, logical=self.in_features)
      x = bridging.copy_to_split(x)
    elif self.tp > 1 and self.parallel == "row":
      if x.shape[-1] == self.in_features:     # replicated: keep my block
        pad = self.weight.shape[1] * self.tp - self.in_features
        x = bridging.replica_to_split(F.pad(x, (0, pad)) if pad else x,
                                      dim=-1)
      y = self._row_product(x.to(dtype), dtype)
      if self.bias is not None:
        y = y + self.bias.to(dtype)
      return y
    y = F.linear(x.to(dtype), self.weight.to(dtype))
    if self.bias is not None:
      y = y + self.bias.to(dtype)
    return y

  def _row_product(self, x, dtype):
    """The row-parallel product summed over ``model``: the fused
    all-reduce GSPMD inserts, or, under ``communication.overlap``, the
    overlap ring (matmul -> ring reduce-scatter -> all-gather)."""
    w = self.weight.to(dtype)
    chunks = _row_overlap_chunks(x, self.tp, self.features)
    if chunks >= 2:
      return _row_overlap_matmul(x, w, chunks)
    return collectives.all_reduce(F.linear(x, w), constants.MODEL_AXIS)


def _row_overlap_chunks(x, tp: int, out_features: int) -> int:
  """Ring chunk count for a row-parallel product under
  ``communication.overlap``; 1 keeps the fused all-reduce.  The ring
  engages only on a pure tensor-parallel mesh (every other axis 1) whose
  flattened rows divide the model axis, as in the JAX layer."""
  mesh = collectives._mesh()
  if mesh is None or any(s > 1 for a, s in mesh.shape.items()
                         if a != constants.MODEL_AXIS):
    return 1
  rows = x.numel() // x.shape[-1]
  if rows % tp:
    return 1
  from easyparallellibrary_tpu_torch.communicators import overlap
  from easyparallellibrary_tpu_torch.parallel.planner import SITE_ROW_DENSE
  return overlap.resolve_num_chunks(
      "matmul_reduce_scatter", tp, m=rows, k=x.shape[-1],
      n_out=out_features, dtype=x.dtype, site=SITE_ROW_DENSE)


def _row_overlap_matmul(x, w, num_chunks: int):
  """``matmul_reduce_scatter`` ring over the rows, then an all-gather
  that rebuilds the replicated activation: the bytes of the fused
  all-reduce, with the scatter half under the partial products."""
  from easyparallellibrary_tpu_torch.communicators import overlap
  lead = x.shape[:-1]
  y = overlap.matmul_reduce_scatter(x.reshape(-1, x.shape[-1]), w.t(),
                                    constants.MODEL_AXIS,
                                    num_chunks=num_chunks)
  # The gather back to the replicated activation: a layout change whose
  # backward keeps this rank's rows (the replicated-loss convention of
  # the fused path's all-reduce).
  y = bridging.split_to_replica(y, dim=0)
  return y.reshape(tuple(lead) + (w.shape[0],))


class LayerNorm(nn.Module):
  """flax ``nn.LayerNorm``: epsilon 1e-6, fp32 statistics with the fast
  variance ``E[x^2] - E[x]^2`` clipped at 0, scale and bias applied in
  fp32, the result cast to ``dtype``.  One custom op,
  ``epl_torch::layer_norm`` (``kernels/layer_norm.py``): K3's kernels on
  the card, the formula on the CPU."""

  def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
               param_dtype: torch.dtype = torch.float32,
               epsilon: float = 1e-6, device=None):
    super().__init__()
    self.dtype = dtype
    self.epsilon = epsilon
    self.weight = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                           device=device))
    self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                         device=device))

  def forward(self, x, dtype: Optional[torch.dtype] = None):
    return layer_norm(x, self.weight, self.bias, self.epsilon,
                      dtype or self.dtype or x.dtype)


class Embedding(nn.Module):
  """Token embedding ``[num_embeddings, features]`` with the tied head
  :meth:`attend`; vocab-sharded with ``parallel="vocab"`` (``"auto"``,
  the default: under a ``split`` scope)."""

  def __init__(self, num_embeddings: int, features: int,
               parallel: str = "auto",
               param_dtype: torch.dtype = torch.float32, device=None):
    super().__init__()
    if parallel not in ("auto", "none", "vocab", "stage_vocab"):
      raise ValueError(f"Embedding.parallel must be auto/none/vocab/"
                       f"stage_vocab, got {parallel!r}")
    if parallel == "auto":
      parallel = _auto_mode("embedding")
    self.parallel = parallel
    self.tp = _model_axis_size() if parallel != "none" else 1
    self.num_embeddings = num_embeddings
    if parallel == "stage_vocab":
      from easyparallellibrary_tpu_torch.parallel import pipeline_smap
      self.vocab_axes = pipeline_smap.vocab_axes(self.tp > 1)
      rows = pipeline_smap.vocab_rows(num_embeddings, self.vocab_axes)
    else:
      rows = _round_up(num_embeddings, self.tp) // self.tp
    self.weight = nn.Parameter(torch.empty(rows, features,
                                           dtype=param_dtype, device=device))

  def forward(self, ids):
    if self.parallel == "stage_vocab":
      from easyparallellibrary_tpu_torch.parallel import pipeline_smap
      out = pipeline_smap.vocab_partial_embed(self.weight, ids,
                                              self.vocab_axes)
      for axis in self.vocab_axes:
        out = collectives.all_reduce(out, axis)
      return out
    if self.tp <= 1:
      return F.embedding(ids, self.weight)
    rows = self.weight.shape[0]
    offset = collectives.axis_index(constants.MODEL_AXIS) * rows
    mine = (ids >= offset) & (ids < offset + rows)
    local = torch.where(mine, ids - offset, torch.zeros_like(ids))
    out = F.embedding(local, self.weight)
    out = torch.where(mine[..., None], out, torch.zeros_like(out))
    return collectives.all_reduce(out, constants.MODEL_AXIS)

  def attend(self, x):
    """Tied-softmax logits ``x @ table.T`` in ``x``'s dtype, so a bf16
    model's logits come out in bf16.  Vocab-sharded, each rank's block
    of ``V_pad / tp`` columns (padded columns are 0; the CE and
    ``split_to_replica`` cut them); stage-vocab-sharded, this rank's
    slab of ``V / n`` columns."""
    if self.parallel == "stage_vocab":
      for axis in self.vocab_axes:
        x = bridging.copy_to_split(x, axis)
    elif self.tp > 1:
      x = bridging.copy_to_split(x)
    return torch.matmul(x, self.weight.to(x.dtype).t())
