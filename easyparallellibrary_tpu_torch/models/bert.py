"""BERT — the bidirectional encoder family of BASELINE row 2 (port of
``easyparallellibrary_tpu/models/bert.py``).

As :class:`~easyparallellibrary_tpu_torch.models.gpt.GPT`, the model is
structure on the ``meta`` device and the weights travel beside it
(``weights.init_params`` / ``weights.from_jax_params``), run through
``torch.func.functional_call``.  Parameter names follow the flax tree:
``wte``, ``wpe``, ``wse`` (segments), ``ln_emb``, ``block_i.{ln1, qkv,
proj, ln2, wi, wo}``, ``ln_f``; the MLM logits are the tied table's.

Attention is never causal.  ``attn_impl``: ``"xla"`` (dense, the
softmax in fp32), ``"pallas_flash"`` (the flash kernels with
``causal=False``: K1 on the card), ``"ring"`` / ``"ulysses"`` (the
port's ``sequence/``, over a ``seq`` axis; no zigzag, which only
balances a causal mask).  ``remat=True`` checkpoints whole blocks.

The tensor-parallel, pipelined and sequence-parallel layouts are GPT's
(``models/gpt.py``): QKV split by whole heads, the MLP column / row, the
table vocab-parallel; the blocks stacked over ``pipeline_stages`` (one
process runs the chunks in layer order, the JAX sequential ground
truth), the table stage-resident under the ``smap`` engine; each ``seq``
rank holding a slice of the tokens.

The masked-LM loss is a ratio of sums: the masked tokens' cross-entropy
over their count, clamped at 1.  Where the batch is split over ranks
(``data``, and ``seq`` under ring or Ulysses) both sums are taken over
them before the division (``collectives.psum``, whose backward sums the
cotangents, so the gradient mean over those axes gives the gradient of
the global ratio): per-rank ratios, or a mean of the denominators, would
shrink the loss wherever the masks are sparse.  The ``smap`` engine
takes this ratio for each micro-batch and averages the ``M`` ratios, as
the JAX engine does; every other path takes the whole batch's ratio, as
``bert_mlm_loss`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.kernels.flash_attention import (
    flash_attention)
from easyparallellibrary_tpu_torch.models import gpt as gpt_lib
from easyparallellibrary_tpu_torch.ops import bridging
from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding, LayerNorm
from easyparallellibrary_tpu_torch.ops.losses import (
    distributed_sparse_softmax_cross_entropy_with_logits)
from easyparallellibrary_tpu_torch.runtime.amp import resolve_model_dtypes
from easyparallellibrary_tpu_torch.utils.logging import get_logger


@dataclasses.dataclass(frozen=True)
class BertConfig:
  """Every field of the JAX ``BertConfig``."""
  vocab_size: int = 30528          # multiple of 64 for sharding
  num_layers: int = 12
  num_heads: int = 12
  d_model: int = 768
  d_ff: int = 3072
  max_seq_len: int = 512
  type_vocab_size: int = 2
  dtype: Any = torch.bfloat16
  param_dtype: Any = torch.float32
  tensor_parallel: bool = False
  remat: bool = False
  attn_impl: str = "xla"
  seq_parallel: bool = False
  pipeline_stages: int = 1
  num_micro_batch: int = 1
  pipeline_schedule: str = ""
  pipeline_interleave: int = 1
  pipeline_debug_sequential: bool = False


def bert_large_config(**kw):
  base = dict(num_layers=24, num_heads=16, d_model=1024, d_ff=4096)
  base.update(kw)
  return BertConfig(**base)


def _dense_attention(q, k, v, dtype):
  """Full attention over ``[B, S, H, hd]``: the products in the compute
  dtype, the softmax in fp32 (the JAX ``xla`` path)."""
  scale = gpt_lib._attention_scale(q.shape[-1], dtype, q.device)
  logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
  probs = torch.softmax(logits.float(), dim=-1).to(dtype)
  return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class EncoderBlock(nn.Module):
  """Pre-norm encoder block: ``x + proj(attn(ln1 x))``, then ``x +
  wo(gelu(wi(ln2 x)))``, every Dense with a bias; GELU is flax's tanh
  form.  ``forward(x, dtype, drop_key=None, return_aux=False)`` (the
  pipeline's stage blocks call it as GPT's ``Block``)."""

  def __init__(self, cfg: BertConfig, device=None):
    super().__init__()
    self.cfg = cfg
    D = cfg.d_model
    self.heads = gpt_lib.local_heads(cfg)
    col, row = ("column", "row") if cfg.tensor_parallel else ("none", "none")
    dt, pd = cfg.dtype, cfg.param_dtype
    self.ln1 = LayerNorm(D, dtype=dt, device=device)
    self.qkv = Dense(D, 3 * D, parallel=col, dtype=dt, param_dtype=pd,
                     device=device)
    self.proj = Dense(D, D, parallel=row, dtype=dt, param_dtype=pd,
                      device=device)
    self.ln2 = LayerNorm(D, dtype=dt, device=device)
    self.wi = Dense(D, cfg.d_ff, parallel=col, dtype=dt, param_dtype=pd,
                    device=device)
    self.wo = Dense(cfg.d_ff, D, parallel=row, dtype=dt, param_dtype=pd,
                    device=device)
    # A stage program of the smap engine (the JAX seq-manual region).
    self.manual = gpt_lib._engine_is_smap(cfg) and \
        gpt_lib.stage_size(cfg) > 1

  def attend(self, q, k, v, dtype):
    impl = self.cfg.attn_impl
    if impl == "pallas_flash":
      return flash_attention(q, k, v, causal=False)
    if impl == "ring":
      from easyparallellibrary_tpu_torch.sequence.ring_attention import (
          ring_attention)
      return ring_attention(q, k, v, causal=False, manual=self.manual)
    if impl == "ulysses":
      from easyparallellibrary_tpu_torch.sequence.ulysses import (
          ulysses_attention)
      return ulysses_attention(q, k, v, causal=False, manual=self.manual)
    if impl == "xla":
      return _dense_attention(q, k, v, dtype)
    # A typo'd impl silently falling back to dense attention would
    # mislabel any benchmark run on top of it (the same guard as GPT).
    raise ValueError(f"attn_impl must be 'xla', 'pallas_flash', 'ring' or "
                     f"'ulysses'; got {impl!r}")

  def forward(self, x, dtype=None, drop_key=None, return_aux=False):
    del drop_key   # BERT has no dropout
    cfg = self.cfg
    dtype = dtype or cfg.dtype
    B, S, D = x.shape
    H = self.heads
    qkv = self.qkv(self.ln1(x, dtype), dtype).reshape(
        B, S, 3, H, D // cfg.num_heads)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = self.attend(q, k, v, dtype).reshape(B, S, -1)
    x = x + self.proj(attn, dtype)
    h = F.gelu(self.wi(self.ln2(x, dtype), dtype), approximate="tanh")
    x = x + self.wo(h, dtype)
    return (x, None) if return_aux else x


class BertStage(gpt_lib.StageBlocks):
  """One pipeline chunk's encoder blocks, each parameter stacked over
  ``rows`` stage rows (the JAX ``BertStage`` under ``Pipeline``)."""

  def __init__(self, cfg: BertConfig, blocks_per_stage: int, rows: int,
               device=None):
    super().__init__(cfg, blocks_per_stage, rows, device=device,
                     block_fn=lambda i: EncoderBlock(cfg, device=device))


def split_axes(cfg: BertConfig) -> tuple:
  """The mesh axes besides ``data`` over which a model of ``cfg`` splits
  the global batch: ``seq`` under ring or Ulysses on a seq axis above 1
  (each rank a slice of the tokens)."""
  if (cfg.attn_impl in ("ring", "ulysses")
      and collectives.axis_size(constants.SEQ_AXIS) > 1):
    return (constants.SEQ_AXIS,)
  return ()


class Bert(nn.Module):
  """The encoder with the tied MLM head.  ``forward(ids, type_ids=None)
  -> logits [B, S, vocab]`` (``return_hidden``: the final LayerNorm's
  output); ``pipeline_part`` runs one piece for the pipeline engines
  (:func:`make_bert_train_step`)."""

  def __init__(self, cfg: BertConfig, device="meta"):
    super().__init__()
    self.cfg = cfg
    self.tp = gpt_lib.tp_size(cfg)
    self.stages = gpt_lib.stage_size(cfg)
    self.split_axes = split_axes(cfg)
    self.n_active = None
    if gpt_lib._engine_is_smap(cfg):
      vocab = "stage_vocab"
    else:
      vocab = "vocab" if cfg.tensor_parallel else "none"
    D, pd = cfg.d_model, cfg.param_dtype
    self.wte = Embedding(cfg.vocab_size, D, parallel=vocab, param_dtype=pd,
                         device=device)
    self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, D, dtype=pd,
                                        device=device))
    self.wse = Embedding(cfg.type_vocab_size, D, param_dtype=pd,
                         device=device)
    self.ln_emb = LayerNorm(D, dtype=cfg.dtype, device=device)
    if cfg.pipeline_stages > 1:
      S, K = cfg.pipeline_stages, max(1, cfg.pipeline_interleave)
      if cfg.num_layers % (S * K):
        raise ValueError("num_layers must be divisible by pipeline_stages "
                         "* pipeline_interleave")
      gpt_lib.add_stage_passes(self, cfg, cfg.num_layers // (S * K),
                               device, stage_cls=BertStage)
    else:
      for i in range(cfg.num_layers):
        self.add_module(f"block_{i}", EncoderBlock(cfg, device=device))
    self.ln_f = LayerNorm(D, dtype=cfg.dtype, device=device)

  def _embed(self, ids, type_ids, dtype):
    """Token, position (offset by this rank's token slice under
    sequence parallelism) and segment embeddings, then ``ln_emb``."""
    from easyparallellibrary_tpu_torch.parallel.pipeline_smap import (
        token_offset_slice, vocab_partial_embed)
    if type_ids is None:
      type_ids = torch.zeros_like(ids)
    if self.wte.parallel == "stage_vocab":
      # One rank owns each id's row: the sum of the partials cast to the
      # compute dtype is the cast lookup (as GPT's feed).
      x = vocab_partial_embed(self.wte.weight, ids,
                              self.wte.vocab_axes).to(dtype)
      for axis in self.wte.vocab_axes:
        x = collectives.all_reduce(x, axis)
    else:
      x = self.wte(ids).to(dtype)
    pos = token_offset_slice(self.wpe, ids.shape[1],
                             constants.SEQ_AXIS in self.split_axes)
    x = x + pos[None].to(dtype) + self.wse(type_ids).to(dtype)
    return self.ln_emb(x, dtype)

  def _blocks(self, x, dtype):
    cfg = self.cfg
    if cfg.pipeline_stages > 1:
      S, K = cfg.pipeline_stages, max(1, cfg.pipeline_interleave)
      for k in range(K):
        for s in range(S):
          x, _ = gpt_lib.run_chunk(self, x, k, s, dtype)
      return x
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
      block = getattr(self, f"block_{i}")
      if remat:
        x, _ = gpt_lib._remat_block(block, x, "nothing", dtype)
      else:
        x = block(x, dtype)
    return x

  def _pipeline_part(self, part, x, type_ids, cfg):
    if part == "feed":
      return self._embed(x, type_ids, cfg.dtype)
    if part == "emit":
      h = self.ln_f(x, cfg.dtype)
      return self.wte.attend(h)
    _, j, remat = part
    s = collectives.axis_index(constants.STAGE_AXIS)
    y, _ = gpt_lib.run_chunk(self, x, j, s, cfg.dtype, remat=remat)
    return y

  def forward(self, ids, type_ids=None, return_hidden: bool = False,
              gather_logits: bool = True, pipeline_part=None):
    """``gather_logits=False`` (tensor-parallel training) returns this
    rank's vocab block of the logits; ``pipeline_part``: ``"feed"``
    (ids -> the first stage's input), ``("stage", chunk, remat)`` (this
    rank's chunk) or ``"emit"`` (the last stage's output -> this rank's
    logits, the vocab slab of a stage-resident table)."""
    cfg = resolve_model_dtypes(self.cfg)
    if pipeline_part is not None:
      return self._pipeline_part(pipeline_part, ids, type_ids, cfg)
    if self.stages > 1:
      raise ValueError(
          "this rank's model holds one pipeline stage; train it through "
          "make_bert_train_step (the pipeline engines), or run the whole "
          "model on a process without a stage axis")
    x = self._blocks(self._embed(ids, type_ids, cfg.dtype), cfg.dtype)
    x = self.ln_f(x, cfg.dtype)
    if return_hidden:
      return x
    logits = self.wte.attend(x)   # MLM logits through the tied table
    if self.tp > 1 and gather_logits:
      logits = bridging.split_to_replica(logits, dim=-1,
                                         logical=cfg.vocab_size)
    return logits


class BertEncoderTrunk(Bert):
  """Bert without the MLM head (the shared trunk of task heads):
  ``forward(ids, type_ids=None) -> hidden [B, S, D]``.  It stacks no
  pipeline stages, as the JAX trunk."""

  def __init__(self, cfg: BertConfig, device="meta"):
    super().__init__(dataclasses.replace(cfg, pipeline_stages=1),
                     device=device)

  def forward(self, ids, type_ids=None):
    return super().forward(ids, type_ids, return_hidden=True)


class BertForQuestionAnswering(nn.Module):
  """SQuAD-style span prediction: the trunk (``bert.*``) and an fp32
  ``qa_outputs`` Dense to two logits a token.  ``forward(ids,
  type_ids=None) -> (start_logits, end_logits)``, each ``[B, S]``."""

  def __init__(self, cfg: BertConfig, device="meta"):
    super().__init__()
    self.cfg = cfg
    self.split_axes = ()
    self.bert = BertEncoderTrunk(cfg, device=device)
    self.qa_outputs = Dense(cfg.d_model, 2, dtype=torch.float32,
                            param_dtype=cfg.param_dtype, device=device)

  def forward(self, ids, type_ids=None):
    span = self.qa_outputs(self.bert(ids, type_ids), torch.float32)
    return span[..., 0], span[..., 1]


def _span_ce(labels, logits):
  """Per-example fp32 cross entropy of int ``labels`` against whole
  (replicated) ``logits [..., n]``."""
  logits = logits.float()
  return torch.logsumexp(logits, -1) - logits.gather(
      -1, labels.long()[..., None])[..., 0]


def bert_qa_loss(model: BertForQuestionAnswering, params, batch, rng=None):
  """Span loss; ``batch = {"ids", "start_positions", "end_positions"}``
  (``"type_ids"`` optional).  Returns ``(loss, {})``."""
  del rng
  start, end = torch.func.functional_call(
      model, params, (batch["ids"].long(),),
      {"type_ids": batch.get("type_ids")}, strict=True)
  loss = (_span_ce(batch["start_positions"], start)
          + _span_ce(batch["end_positions"], end))
  return loss.mean() / 2, {}


def _ratio_axes(model) -> tuple:
  return (constants.DATA_AXIS,) + tuple(model.split_axes)


def masked_ratio(ce, mask, axes, den=None):
  """``sum(ce * mask) / max(sum(mask), 1)`` with both sums taken over
  ``axes`` (the numerator by ``collectives.psum``, so the gradient mean
  over the axes is the global ratio's gradient).  ``den``: the
  denominator's local sum, when it is not this ``mask``'s."""
  mask = mask.float()
  num = (ce * mask).sum()
  den = mask.sum() if den is None else den
  den = den.detach()
  for axis in axes:
    num = collectives.psum(num, axis)
    den = collectives.all_reduce(den, axis)
  return num / torch.clamp(den, min=1.0)


def local_tokens(model, batch) -> Dict[str, torch.Tensor]:
  """This rank's ``ids`` / ``labels`` / ``mask`` / ``type_ids`` of the
  (data-local) batch: the tokens of its ``seq`` rank under sequence
  parallelism (JAX ``check_seq_token_count``'s guard)."""
  out = {k: batch[k] for k in ("ids", "labels", "mask", "type_ids")
         if batch.get(k) is not None}
  if constants.SEQ_AXIS in model.split_axes:
    from easyparallellibrary_tpu_torch.parallel.pipeline_smap import (
        check_seq_token_count)
    n = collectives.axis_size(constants.SEQ_AXIS)
    check_seq_token_count(out["ids"].shape[1], n, True)
    s = out["ids"].shape[1] // n
    i = collectives.axis_index(constants.SEQ_AXIS)
    out = {k: v[:, i * s:(i + 1) * s] for k, v in out.items()}
  return out


def _mlm_ce(model, logits, labels):
  if model.wte.parallel == "stage_vocab":
    from easyparallellibrary_tpu_torch.parallel import pipeline_smap
    return pipeline_smap.sharded_softmax_ce(logits, labels,
                                            axes=model.wte.vocab_axes)
  return distributed_sparse_softmax_cross_entropy_with_logits(
      labels, logits, vocab_size=model.cfg.vocab_size)


def bert_mlm_loss(model: Bert, params, batch, rng=None):
  """Masked-LM loss; ``batch = {"ids": [B, S], "labels": [B, S],
  "mask": [B, S] float}`` (1 where a token is predicted): the whole
  batch's ratio of sums (module docstring).  As the JAX loss, it reads
  no ``"type_ids"`` (segment 0 everywhere; the ``smap`` engine's feed
  reads them).  Returns ``(loss, {})``."""
  del rng
  tokens = local_tokens(model, {k: torch.as_tensor(v) for k, v in
                                batch.items() if k != "type_ids"})
  logits = torch.func.functional_call(
      model, params, (tokens["ids"].long(),), {"gather_logits": False},
      strict=True)
  ce = _mlm_ce(model, logits, tokens["labels"].long())
  return masked_ratio(ce, tokens["mask"], _ratio_axes(model)), {}


def _pipeline_grad_fn(model: Bert, schedule, collective: bool):
  """``grad_fn(params, batch, rng, loss_scale=None) -> (loss, {})``: the
  per-rank executor (``parallel.pipeline.Pipeline``) walks ``schedule``
  over this rank's rows (and tokens) of the batch cut into micro-batches.
  ``collective``: the ``smap`` layout (every rank feeds and emits, the
  table stage-resident), whose emit takes each micro-batch's own ratio of
  sums; otherwise (the ``vmap`` layout) stage 0 feeds, the last stage
  emits each micro-batch's share of the whole batch's ratio, and the
  boundary leaves' gradients and the loss are summed over the stage
  axis.  A stage recomputed by its schedule runs its blocks without a
  second checkpoint."""
  from easyparallellibrary_tpu_torch.parallel.api import _reduce_grads
  from easyparallellibrary_tpu_torch.parallel.pipeline import Pipeline
  from easyparallellibrary_tpu_torch.utils.pytree import split_micro_batches
  cfg = resolve_model_dtypes(model.cfg)
  M = cfg.num_micro_batch
  axes = _ratio_axes(model)
  block_remat = None if not schedule.remat_stage else False

  def grad_fn(params, batch, rng, loss_scale=None):
    del rng
    device = next(iter(params.values())).device
    tokens = local_tokens(model, {k: torch.as_tensor(v).to(device)
                                  for k, v in batch.items()})
    if "type_ids" not in tokens or not collective:
      # The vmap layout is bert_mlm_loss's, which reads no segments.
      tokens["type_ids"] = torch.zeros_like(tokens["ids"])
    split = split_micro_batches(tokens, M)
    mbs = [{k: v[m] for k, v in split.items()} for m in range(M)]
    whole_den = None if collective else tokens["mask"].float().sum()

    def call(x, **kw):
      return torch.func.functional_call(model, params, (x,), kw, strict=True)

    def feed(mb):
      return call(mb["ids"].long(), type_ids=mb["type_ids"].long(),
                  pipeline_part="feed")

    def stage(j, x, m):
      del m
      return call(x, pipeline_part=("stage", j, block_remat))

    def emit(y, mb):
      logits = call(y, pipeline_part="emit")
      ce = _mlm_ce(model, logits, mb["labels"].long())
      if collective:
        return masked_ratio(ce, mb["mask"], axes)
      # This micro-batch's share of the whole batch's ratio, times M (the
      # executor averages the M emits).
      return M * masked_ratio(ce, mb["mask"], axes, den=whole_den)

    rows, length = mbs[0]["ids"].shape
    pipe = Pipeline(schedule, feed, stage, emit,
                    act_shape=(rows, length, cfg.d_model),
                    act_dtype=cfg.dtype, device=device,
                    collective_boundary=collective)
    loss = pipe(mbs, loss_scale)
    if not collective:
      loss = collectives.all_reduce(loss, constants.STAGE_AXIS)
      _reduce_grads(
          params, [n for n in params if not n.startswith("pipeline")])
    for p in params.values():
      if p.requires_grad and p.grad is None:
        p.grad = torch.zeros_like(p)
    return loss, {}

  grad_fn.schedule = schedule
  return grad_fn


def make_bert_smap_grad_fn(model: Bert, mesh=None, schedule: str = "1f1b"):
  """The ``smap`` engine's gradient function for BERT (the GPT wiring,
  ``models.gpt.make_gpt_smap_grad_fn``, applied to the encoder): the
  feed is the stage-vocab lookup with the position and segment
  embeddings and ``ln_emb``, a stage is this rank's encoder blocks, the
  emit the final LayerNorm, this rank's vocab slab of the tied logits,
  the sharded cross-entropy and the micro-batch's ratio of sums over
  every shard of it (``data``, and ``seq`` under sequence parallelism).
  ``schedule``: ``"1f1b"`` (interleaved 1F1B when ``pipeline_interleave``
  K > 1), ``"gpipe"`` or ``"interleaved"``.  Each guard raises as the
  JAX one does.  Returns ``grad_fn(params, batch, rng, loss_scale=None)
  -> (loss, metrics)``."""
  from easyparallellibrary_tpu_torch.parallel import pipeline_smap
  from easyparallellibrary_tpu_torch.parallel.pipeline import gpipe_schedule
  from easyparallellibrary_tpu_torch.parallel.pipeline_interleaved import (
      interleaved_pipe_schedule)
  from easyparallellibrary_tpu_torch.parallel.schedule_1f1b import (
      one_f_one_b_schedule)
  cfg = resolve_model_dtypes(model.cfg)
  S, M = cfg.pipeline_stages, cfg.num_micro_batch
  K = max(1, cfg.pipeline_interleave)
  if S <= 1:
    raise ValueError("smap pipeline needs pipeline_stages > 1")
  pipeline_smap.seq_manual_mode(cfg.attn_impl, cfg.num_heads)
  if schedule == "1f1b" and K > 1:
    schedule = "interleaved"
  if schedule == "interleaved" and K < 2:
    raise ValueError("schedule='interleaved' needs pipeline_interleave "
                     ">= 2 (K virtual chunks per device)")
  if schedule == "gpipe" and K > 1:
    raise ValueError(
        "pipeline_interleave > 1 on the smap engine requires the "
        "interleaved-1F1B schedule (pipeline.strategy PreferBackward*); "
        "GPipe order does not interleave chunks")
  if cfg.vocab_size % S:
    raise ValueError(f"vocab_size {cfg.vocab_size} must divide into "
                     f"{S} stage-resident shards")
  if cfg.num_layers % (S * K):
    raise ValueError("num_layers must be divisible by pipeline_stages "
                     "* pipeline_interleave (the model's own constraint)")
  if schedule not in ("gpipe", "1f1b", "interleaved"):
    raise ValueError(f"schedule must be gpipe|1f1b|interleaved, "
                     f"got {schedule!r}")
  if cfg.tensor_parallel:
    from easyparallellibrary_tpu_torch.env import Env
    pipeline_smap.check_unpadded_vocab(
        cfg.vocab_size, mesh if mesh is not None else Env.get().cluster.mesh)
  if model.wte.parallel != "stage_vocab":
    raise ValueError("the smap engine needs the stage-resident boundary "
                     "layers: build the model under pipeline.engine='smap'")
  gpt_lib._check_stage_mesh(model, "the smap engine")
  if schedule == "interleaved":
    table = interleaved_pipe_schedule(S, K, M)
  elif schedule == "gpipe":
    table = gpipe_schedule(S, M)
  else:
    table = one_f_one_b_schedule(S, M)
  return _pipeline_grad_fn(model, table, collective=True)


def make_bert_gpipe_grad_fn(model: Bert, remat_stage: bool = False):
  """The ``vmap`` layout's GPipe for BERT (boundary layers on every
  stage rank; ``K`` chained passes for an interleaved model), where the
  JAX package differentiates ``bert_mlm_loss`` through its vmapped
  ``Pipeline``: the same whole-batch ratio."""
  from easyparallellibrary_tpu_torch.parallel.pipeline import gpipe_schedule
  cfg = model.cfg
  gpt_lib._check_stage_mesh(model, "the GPipe engine")
  return _pipeline_grad_fn(model, gpipe_schedule(
      cfg.pipeline_stages, cfg.num_micro_batch,
      max(1, cfg.pipeline_interleave), remat_stage), collective=False)


def make_bert_train_step(model: Bert, config=None):
  """Config-driven train step for BERT (the JAX dispatch):
  ``pipeline.engine = "smap"`` with pipeline stages runs
  :func:`make_bert_smap_grad_fn` (``PreferBackward*`` -> 1F1B,
  ``PreferForward`` -> GPipe; ``PreferBackwardOptimizer`` applies in one
  group a stage unless ``optimizer.num_apply_group`` pins a count);
  otherwise a pipelined model on a stage axis runs the ``vmap`` layout's
  GPipe (:func:`make_bert_gpipe_grad_fn`; a 1F1B strategy warns, as the
  JAX package does), and everything else trains through
  :func:`bert_mlm_loss`.  The step carries ``dispatch``: ``(engine,
  schedule, num_apply_group)``, and ``grad_fn``."""
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.runtime.trainer import build_train_step
  from easyparallellibrary_tpu_torch.strategies.scheduler import (
      get_scheduler)
  cfg = model.cfg
  conf = config if config is not None else Env.get().config
  groups, grad_fn = None, None
  dispatch = ("autodiff", None, None)
  if cfg.pipeline_stages > 1 and not cfg.pipeline_debug_sequential:
    sched = get_scheduler(cfg.pipeline_schedule or conf.pipeline.strategy)
    if conf.pipeline.engine == "smap":
      if sched.grouped_apply and conf.optimizer.num_apply_group <= 1:
        groups = cfg.pipeline_stages
      schedule = "1f1b" if sched.remat_stage else "gpipe"
      grad_fn = make_bert_smap_grad_fn(model, schedule=schedule)
      dispatch = ("smap", grad_fn.schedule.name, groups)
    else:
      if sched.remat_stage:
        # Unlike GPT, BERT has no vmapped 1F1B: without the smap engine,
        # PreferBackward* runs GPipe order (M live activations a stage).
        get_logger().warning(
            "pipeline.strategy=%s on BERT runs as GPipe-order autodiff "
            "unless pipeline.engine='smap' (no vmapped 1F1B wiring for "
            "BERT); set pipeline.engine='smap' for true 1F1B order.",
            sched.name)
      if model.stages > 1:
        grad_fn = make_bert_gpipe_grad_fn(
            model, sched.remat_stage or cfg.remat)
        dispatch = ("vmap", grad_fn.schedule.name, None)
  if grad_fn is None:
    step = build_train_step(lambda p, b, r: bert_mlm_loss(model, p, b, r),
                            config=conf, num_apply_group=groups)
  else:
    step = build_train_step(grad_fn=grad_fn, config=conf,
                            num_apply_group=groups)
  step.dispatch = dispatch
  step.grad_fn = grad_fn
  return step


def bert_flops_per_token(cfg: BertConfig, seq_len: Optional[int] = None
                         ) -> float:
  """Training FLOPs a token, ``benchmarks/single_chip_models.py``'s
  count: ``6 (L (4 D^2 + 2 D F) + D V) + 6 L 2 D S``."""
  S = seq_len or cfg.max_seq_len
  D, F, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
  return 6.0 * (L * (4 * D * D + 2 * D * F) + D * V) + 6.0 * L * 2 * D * S
