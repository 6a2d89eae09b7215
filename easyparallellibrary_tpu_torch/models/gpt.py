"""GPT — the flagship decoder, for serving and training (port of
``easyparallellibrary_tpu/models/gpt.py``).

Like the flax module, :class:`GPT` is the model's structure and the
weights travel beside it: ``GPT(cfg)`` holds parameters on the ``meta``
device, and the entry points (:func:`paged_step_logits`,
:func:`generate`, the serving engine) run it through
``torch.func.functional_call`` with a ``params`` state dict
(``weights.init_params`` / ``weights.from_jax_params``).

Four position modes, as ``GPT.__call__`` in the JAX package: plain
(a whole sequence), legacy decode (``generate``'s KV cache, grown in the
``cache`` dict the caller passes), slot mode (the contiguous serving
engine's ``[num_slots, C]`` step against its slot cache, each slot at
its own cursor: :func:`slot_step_logits`), and paged (the paged engine's
flat-token step through :class:`PagedInfo`).  Caches are updated in
place, where the JAX package returns new (donated) arrays.

Training: :func:`gpt_loss` (next-token cross-entropy, optionally the
chunked tied head of :func:`_chunked_tied_ce`) differentiates through
the same forward, with ``attn_impl="pallas_flash"`` routed to the flash
attention kernels (``kernels/flash_attention.py``) and ``remat=True``
checkpointing every block under ``remat_policy`` (:func:`_remat_context`).
Training takes the fp32 parameters as they are: the Dense and Embedding
layers cast them to the compute dtype in the forward, so the gradients
reach the fp32 parameters.

bf16 compute over fp32 parameters by default.  ``amp.level = "O1"``
resolves the compute dtype at every forward
(``runtime.amp.resolve_model_dtypes``, as ``GPT.__call__`` does), and
the resolved dtype is threaded to every layer; the serving caches stay
in the model config's own dtype, as the JAX package allocates them.
Dropout in training mode (``dropout_rate > 0`` with an rng in
:func:`gpt_loss`) masks the attention and MLP residual branches, as the
JAX blocks do, with counter-based masks (``utils.prng.keep_mask``)
keyed by the step's rng folded with the layer and the branch; the two
frameworks' masks differ, their statistics agree.

Tensor parallelism (``tensor_parallel=True`` on a mesh whose ``model``
axis is above 1) is Megatron-style explicit SPMD, one process per rank:
QKV is column-parallel with ``H / tp`` whole heads per rank (q, k and v
of the same heads), the output projection row-parallel; the MLP's
``wi`` column- and ``wo`` row-parallel; the tied embedding
vocab-parallel and the untied head column-parallel.  Attention runs the
port's kernels per rank at ``H / tp`` heads.  ``forward`` returns the
whole logits (gathered over the vocab shards); training takes the
vocab-sharded logits into the vocab-parallel cross entropy
(``ops.losses``), chunked or not.  ``weights.shard_params`` gives each
rank its slice of the JAX package's parameters.

Pipeline parallelism (``pipeline_stages`` S > 1): the blocks are grouped
into ``S * pipeline_interleave`` chunks (:func:`stage_layout`; uneven
layers give masked slots, skipped), stacked over the stages as the JAX
parameter tree stacks them (``pipeline.stages.stacked.block_i.*`` with a
leading ``[S]`` dim, ``pipeline_{k}`` for pass k of an interleaved
model).  On one process the model holds every row and ``forward`` runs
the chunks in layer order (the JAX package's sequential ground truth).
Built on a mesh whose ``stage`` axis is S, it holds this rank's row
(``[1, ...]``), and under ``pipeline.engine = "smap"`` its vocab slice
of the tied table or head (``stage_vocab`` / ``stage_column``); the
pipeline engines (:func:`make_gpt_train_step`) run it a part at a time
(``forward(..., pipeline_part=...)``: the feed, one chunk, the emit).

Mixture-of-experts (``num_experts > 0``): every ``moe_every``-th block's
MLP is ``models.moe.MoEMLP`` (a stage's blocks follow the pattern by
their index in the stage, as the JAX ``StageBlocks``).  The JAX blocks
sow the load-balancing loss into a flax collection; here an MoE block
returns it (``return_aux=True``), ``forward(..., return_aux=True)`` sums
it over the blocks, and :func:`gpt_loss` and the pipeline engines add
``moe_aux_weight`` times it (``moe_aux_loss`` in the metrics).  Under
``moe_impl="a2a"`` on an ``expert`` axis the batch rows split over
``("data", "expert")``.

Sequence parallelism (``attn_impl="ring"`` / ``"ulysses"`` on a mesh
whose ``seq`` axis is above 1): each rank holds a contiguous slice of
the tokens (:func:`local_tokens`: the next-token shift is taken over the
whole sequence first), its positions offset by the slice's start (JAX
``token_offset_slice``), and attention is ``sequence.ring_attention`` /
``sequence.ulysses_attention`` over the seq group.  Each rank's loss is
the mean over its tokens; the gradients of the replicated leaves are
averaged over ``data`` and the split axes (``split_axes``,
``parallel.api.reduce_gradients``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.kernels.flash_attention import (
    FLASH_FWD_OP, flash_attention)
from easyparallellibrary_tpu_torch.kernels.paged_attention import (
    PagedTiles, paged_attention)
from easyparallellibrary_tpu_torch.observability.trace import step_span
from easyparallellibrary_tpu_torch.ops import bridging
from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding, LayerNorm
from easyparallellibrary_tpu_torch.ops.losses import (
    distributed_sparse_softmax_cross_entropy_with_logits)
from easyparallellibrary_tpu_torch.parallel.pipeline_smap import (
    check_unpadded_vocab)
from easyparallellibrary_tpu_torch.runtime.amp import resolve_model_dtypes
from easyparallellibrary_tpu_torch.utils import prng
from easyparallellibrary_tpu_torch.utils.logging import get_logger


@dataclasses.dataclass(frozen=True)
class GPTConfig:
  """Every field of the JAX ``GPTConfig``."""
  vocab_size: int = 32768
  num_layers: int = 12
  num_heads: int = 16
  d_model: int = 1024
  d_ff: int = 4096
  max_seq_len: int = 1024
  dtype: Any = torch.bfloat16
  param_dtype: Any = torch.float32
  tensor_parallel: bool = False
  remat: bool = False
  remat_policy: str = "nothing"
  tie_embeddings: bool = True
  z_loss: float = 0.0
  dropout_rate: float = 0.0
  num_experts: int = 0
  moe_every: int = 2
  capacity_factor: float = 1.25
  moe_aux_weight: float = 0.01
  moe_top_k: int = 1
  moe_impl: str = "einsum"
  seq_parallel: bool = False
  attn_impl: str = "xla"
  pipeline_stages: int = 1
  num_micro_batch: int = 1
  pipeline_schedule: str = ""
  pipeline_debug_sequential: bool = False
  pipeline_interleave: int = 1
  stage_plan: Optional[tuple] = None
  loss_chunk: int = 0


def tp_size(cfg: GPTConfig) -> int:
  """The tensor-parallel width a model of ``cfg`` is built at: the
  ambient mesh's ``model`` axis when ``tensor_parallel``, else 1."""
  if not cfg.tensor_parallel:
    return 1
  return collectives.axis_size(constants.MODEL_AXIS)


def local_heads(cfg: GPTConfig) -> int:
  """Attention heads per rank (``H / tp``).  Heads that do not divide
  the model axis raise: the JAX package replicates such a cache and lets
  GSPMD pad the heads; the port shards whole heads only."""
  tp = tp_size(cfg)
  if cfg.num_heads % tp:
    raise ValueError(
        f"tensor_parallel needs num_heads ({cfg.num_heads}) divisible by "
        f"the model axis ({tp}); the port shards whole heads per rank")
  return cfg.num_heads // tp


def stage_size(cfg: GPTConfig) -> int:
  """The stage axis a pipelined model of ``cfg`` is built at: the
  ambient mesh's ``stage`` axis (1: one process holds every stage).  An
  axis above 1 must equal ``pipeline_stages``."""
  if cfg.pipeline_stages <= 1:
    return 1
  n = collectives.axis_size(constants.STAGE_AXIS)
  if n > 1 and n != cfg.pipeline_stages:
    raise ValueError(f"pipeline_stages={cfg.pipeline_stages} on a mesh "
                     f"whose stage axis is {n}")
  return n


def split_axes(cfg: GPTConfig) -> tuple:
  """The mesh axes besides ``data`` over which a model of ``cfg`` built on
  the ambient mesh splits the global batch: ``expert`` for the a2a MoE
  (the rows), ``seq`` for ring or Ulysses attention on a seq axis above 1
  (the tokens, JAX ``seq_manual_mode``)."""
  out = ()
  if (cfg.num_experts > 0 and cfg.moe_impl == "a2a"
      and collectives.axis_size(constants.EXPERT_AXIS) > 1):
    out += (constants.EXPERT_AXIS,)
  if (cfg.attn_impl in ("ring", "ulysses")
      and collectives.axis_size(constants.SEQ_AXIS) > 1):
    out += (constants.SEQ_AXIS,)
  return out


def _uses_moe(cfg: GPTConfig, i: int) -> bool:
  return cfg.num_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


def local_tokens(model, ids):
  """``(inputs, targets)`` of this rank from the (data-local) ``ids [B,
  S+1]``: the rows of its ``expert`` rank under the a2a MoE, the
  next-token shift over the whole sequence, then the tokens of its
  ``seq`` rank under sequence parallelism (JAX
  ``check_seq_token_count``'s guard)."""
  axes = model.split_axes
  if constants.EXPERT_AXIS in axes:
    from easyparallellibrary_tpu_torch.sequence._util import (
        axis_if_divisible)
    from easyparallellibrary_tpu_torch.env import Env
    mesh = Env.get().cluster.mesh
    if axis_if_divisible(ids.shape[0], mesh, constants.EXPERT_AXIS) is None:
      raise ValueError(f"batch rows {ids.shape[0]} must divide the expert "
                       f"axis ({mesh.axis_size(constants.EXPERT_AXIS)}) "
                       "for the a2a MoE")
    rows = ids.shape[0] // mesh.axis_size(constants.EXPERT_AXIS)
    i = mesh.axis_index(constants.EXPERT_AXIS)
    ids = ids[i * rows:(i + 1) * rows]
  inputs, targets = ids[:, :-1], ids[:, 1:]
  if constants.SEQ_AXIS in axes:
    from easyparallellibrary_tpu_torch.parallel.pipeline_smap import (
        check_seq_token_count)
    n = collectives.axis_size(constants.SEQ_AXIS)
    check_seq_token_count(inputs.shape[1], n, True)
    s = inputs.shape[1] // n
    i = collectives.axis_index(constants.SEQ_AXIS)
    inputs, targets = (t[:, i * s:(i + 1) * s] for t in (inputs, targets))
  return inputs, targets


def _engine_is_smap(cfg: GPTConfig) -> bool:
  """True when the active Config dispatches the ``smap`` engine for this
  (pipelined) model."""
  if cfg.pipeline_stages <= 1:
    return False
  from easyparallellibrary_tpu_torch.env import Env
  return Env.get().config.pipeline.engine == "smap"


def _attention_scale(hd: int, dtype, device) -> torch.Tensor:
  # 1 / sqrt(hd) with sqrt in fp32 rounded to the dtype, as
  # 1.0 / jnp.sqrt(hd).astype(dtype).
  return 1.0 / torch.sqrt(torch.tensor(float(hd), device=device)).to(dtype)


def _masked_softmax_attend(q, k, v, valid, dtype):
  """``softmax(q k^T * scale)`` with ``-1e9`` outside ``valid``, fp32
  softmax, probabilities cast to ``dtype`` before the V product.  A cache
  of another float type than the queries (amp O1 over a model config in
  a wider type) is multiplied in the promoted type, as ``jnp.einsum``
  promotes."""
  scale = _attention_scale(q.shape[-1], dtype, q.device)
  qk_type = torch.promote_types(q.dtype, k.dtype)
  logits = torch.einsum("bqhd,bkhd->bhqk", q.to(qk_type),
                        k.to(qk_type)) * scale
  logits = torch.where(valid, logits,
                       torch.tensor(-1e9, dtype=logits.dtype,
                                    device=q.device))
  probs = torch.softmax(logits.float(), dim=-1).to(dtype)
  pv_type = torch.promote_types(dtype, v.dtype)
  return torch.einsum("bhqk,bkhd->bqhd", probs.to(pv_type), v.to(pv_type))


def _dense_causal_attention(q, k, v, dtype):
  """Plain causal attention over ``[B, S, H, hd]``: matmuls in the
  compute dtype, fp32 softmax."""
  S = q.shape[1]
  mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
  return _masked_softmax_attend(q, k, v, mask[None, None], dtype)


def slot_cache_attend(q, k, v, cached_k, cached_v, cursors, dtype):
  """Slot-indexed KV-cache attention: ``generate``'s decode step and the
  contiguous serving engine's fused step.

  ``q``/``k``/``v`` are ``[B, C, H, hd]``; ``cached_k``/``cached_v``
  ``[B, Lc, H, hd]``; token ``i`` of row ``b`` is written at
  ``cursors[b] + i`` and attends positions ``<= cursors[b] + i``, so
  each slot writes a window at its own cursor (one advanced-index write
  over the ``[B, C]`` rows; ``Lc >= max(cursors) + C``, which the serving
  cache's one chunk of slack guarantees).  The caches are written in
  place.  Returns ``(out, cached_k, cached_v)``.

  Finiteness invariant (as in the JAX package): the masked rows still
  enter the V contraction with probability 0, and ``0 * NaN = NaN``, so
  no cache row that a later step reads unwritten may hold a non-finite
  value.  The resilient engine zeroes a poisoned step's writes
  (``serving.engine``'s sanitize) instead of masking here.
  """
  B, C = q.shape[:2]
  Lc = cached_k.shape[1]
  cursors = cursors.long()
  rows = torch.arange(B, device=q.device)[:, None]
  cols = cursors[:, None] + torch.arange(C, device=q.device)[None]
  cached_k[rows, cols] = k.to(cached_k.dtype)
  cached_v[rows, cols] = v.to(cached_v.dtype)
  pos = cols[:, None, :, None]                                # [B,1,C,1]
  valid = torch.arange(Lc, device=q.device)[None, None, None, :] <= pos
  out = _masked_softmax_attend(q, cached_k, cached_v, valid, dtype)
  return out, cached_k, cached_v


@dataclasses.dataclass
class PagedInfo:
  """Per-step paged-decode routing, threaded to every attention layer.

  ``write_idx`` int64 ``[T]``: flat pool row each token's K/V is
  written to (padding tokens go to rows of the null block).
  ``tables_tok`` int32 ``[T, MB]``: each token's slot block-table row.
  ``positions`` int32 ``[T]``: absolute positions (the causal bound).
  ``tiles``: the step's query-tile plan (``kernels.paged_attention.
  PagedTiles``), planned once per step for the kernel's tiled build, or
  None where no kernel needs one.
  """
  write_idx: torch.Tensor
  tables_tok: torch.Tensor
  positions: torch.Tensor
  tiles: Optional[PagedTiles] = None


def paged_cache_attend(q, k, v, k_pages, v_pages, paged_info, dtype):
  """Paged-pool KV attention: write this step's K/V into the pool, then
  attend through the block tables (``kernels.paged_attention``: the CUDA
  kernel for CUDA tensors, the plain version on the CPU).

  ``q``/``k``/``v`` ``[T, H, hd]``; pools ``[NB, bs, H, hd]``.  The JAX
  package scatters into a donated copy of the pool; here the pool is
  updated in place (``index_copy_``).  Pool rows that are never attended
  (the null block, stale rows) hold finite garbage, which the mask
  removes.  Returns ``(out [T, H, hd], k_pages, v_pages)``.
  """
  NB, bs, H, hd = k_pages.shape
  flat = (NB * bs, H, hd)
  k_pages.view(flat).index_copy_(0, paged_info.write_idx,
                                 k.to(k_pages.dtype))
  v_pages.view(flat).index_copy_(0, paged_info.write_idx,
                                 v.to(v_pages.dtype))
  out = paged_attention(q.contiguous(), k_pages, v_pages,
                        paged_info.tables_tok, paged_info.positions,
                        paged_info.tiles)
  return out.to(dtype), k_pages, v_pages


def paged_step_logits(model, params, kv, tokens, slot_ids, positions,
                      valid, block_tables, tiles=None):
  """Flat-token scoring against the paged KV cache — the device entry of
  the serving engine's step.

  ``tokens`` int ``[T]``, each tagged with its slot (``slot_ids``) and
  absolute position (``positions``, int32); ``valid`` bool ``[T]``;
  ``block_tables`` int32 ``[N, MB]``; ``kv`` the pool dict of
  ``serving.kv_cache.allocate_paged_kv_cache``, written in place.
  Invalid (padding) tokens write to the null block and their logits are
  garbage the scheduler never reads.  ``tiles`` is the step's query-tile
  plan (``kernels.paged_attention.plan_tiles``) for the attention
  kernel's tiled build, which the engine makes once per step; without
  one, each attention call that needs a plan derives its own.  Returns
  ``(logits [T, vocab], kv)``.
  """
  T = tokens.shape[0]
  MB = block_tables.shape[1]
  bs = kv["block_0"]["attn"]["cached_key"].shape[1]
  L = MB * bs
  tables_tok = block_tables.index_select(0, slot_ids.long()).contiguous()
  blk = tables_tok.gather(
      1, torch.clamp(positions // bs, 0, MB - 1).long()[:, None])[:, 0]
  real_idx = blk.long() * bs + (positions % bs).long()
  trash_idx = torch.arange(T, device=tokens.device) % bs
  write_idx = torch.where(valid & (positions < L), real_idx, trash_idx)
  info = PagedInfo(write_idx=write_idx, tables_tok=tables_tok,
                   positions=positions, tiles=tiles)
  logits = torch.func.functional_call(
      model, params, (tokens[:, None].long(),),
      {"decode": True, "paged_info": info, "cache": kv}, strict=True)
  return logits[:, 0], kv


def slot_step_logits(model, params, kv, tokens, cursors):
  """Multi-token scoring against the slot KV cache — the device entry of
  the contiguous engine's step and of the draft model's slot rollouts.

  ``tokens`` int ``[num_slots, C]`` (any C >= 1): token ``i`` of slot
  ``b`` lands at position ``cursors[b] + i``, attends its own causal
  prefix (:func:`slot_cache_attend`), and position ``i``'s logits are the
  distribution of the token at ``cursors[b] + i + 1`` — chunked prefill,
  one-token decode and speculative verification in one call.  ``kv`` is
  the cache dict of ``serving.kv_cache.allocate_kv_cache``, written in
  place; the caller owns the cursors.  Returns ``(logits [num_slots, C,
  vocab], kv)``.
  """
  logits = torch.func.functional_call(
      model, params, (tokens.long(),),
      {"decode": True, "slot_cursors": cursors, "cache": kv}, strict=True)
  return logits, kv


class CausalSelfAttention(nn.Module):

  def __init__(self, cfg: GPTConfig, device=None):
    super().__init__()
    self.cfg = cfg
    D = cfg.d_model
    self.heads = local_heads(cfg)
    col, row = ("column", "row") if cfg.tensor_parallel else ("none", "none")
    self.qkv = Dense(D, 3 * D, use_bias=False, parallel=col,
                     dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                     device=device)
    self.qkv.out_groups = 3     # q, k and v of this rank's heads
    self.proj = Dense(D, D, use_bias=False, parallel=row, dtype=cfg.dtype,
                      param_dtype=cfg.param_dtype, device=device)
    # A stage program of the smap engine (the JAX seq-manual region).
    self.manual = _engine_is_smap(cfg) and stage_size(cfg) > 1

  def forward(self, x, paged_info=None, cache=None, decode=False,
              slot_cursors=None, dtype=None):
    cfg = self.cfg
    dtype = dtype or cfg.dtype
    B, S, D = x.shape
    H = self.heads
    qkv = self.qkv(x, dtype).reshape(B, S, 3, H, D // cfg.num_heads)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if paged_info is not None:
      out, _, _ = paged_cache_attend(
          q[:, 0], k[:, 0], v[:, 0], cache["cached_key"],
          cache["cached_value"], paged_info, dtype)
      out = out[:, None]
    elif slot_cursors is not None:
      if "cached_key" not in cache:
        raise ValueError(
            "slot-mode decode (slot_cursors=...) needs an externally "
            "allocated slot KV cache; build one with serving.kv_cache."
            "allocate_kv_cache(cfg, num_slots, chunk)")
      out, _, _ = slot_cache_attend(q, k, v, cache["cached_key"],
                                    cache["cached_value"], slot_cursors,
                                    dtype)
    elif decode:
      out = self._decode_attend(q, k, v, cache, dtype)
    elif cfg.attn_impl == "ring":
      from easyparallellibrary_tpu_torch.sequence.ring_attention import (
          ring_attention)
      out = ring_attention(q, k, v, causal=True, manual=self.manual)
    elif cfg.attn_impl == "ulysses":
      from easyparallellibrary_tpu_torch.sequence.ulysses import (
          ulysses_attention)
      out = ulysses_attention(q, k, v, causal=True, manual=self.manual)
    elif cfg.attn_impl == "pallas_flash":
      out = flash_attention(q, k, v, causal=True)
    elif cfg.attn_impl == "xla":
      out = _dense_causal_attention(q, k, v, dtype)
    else:
      # A typo'd impl silently falling back to dense attention would
      # mislabel any benchmark run on top of it.
      raise ValueError(
          f"attn_impl must be 'xla', 'pallas_flash', 'ring' or "
          f"'ulysses'; got {cfg.attn_impl!r}")
    return self.proj(out.reshape(B, S, -1), dtype)

  def _decode_attend(self, q, k, v, cache, dtype):
    """``generate``'s KV cache: ``[B, max_seq_len, H, hd]`` grown in the
    caller's ``cache`` dict, in the compute dtype (the JAX module
    allocates it from its resolved config).  Prefill (S > 1) is plain
    causal attention with the prompt's K/V stored; a one-token step
    appends at the cursor and attends the valid prefix."""
    cfg = self.cfg
    B, S, H, hd = q.shape
    if "cached_key" not in cache:
      shape = (B, cfg.max_seq_len, H, hd)
      cache["cached_key"] = torch.zeros(shape, dtype=dtype, device=q.device)
      cache["cached_value"] = torch.zeros(shape, dtype=dtype,
                                          device=q.device)
      cache["cache_index"] = 0
    if S > 1:
      cache["cached_key"][:, :S] = k.to(dtype)
      cache["cached_value"][:, :S] = v.to(dtype)
      cache["cache_index"] = S
      return _dense_causal_attention(q, k, v, dtype)
    cursors = torch.full((B,), cache["cache_index"], device=q.device)
    out, _, _ = slot_cache_attend(q, k, v, cache["cached_key"],
                                  cache["cached_value"], cursors, dtype)
    cache["cache_index"] += 1
    return out


class MLP(nn.Module):

  def __init__(self, cfg: GPTConfig, device=None):
    super().__init__()
    col, row = ("column", "row") if cfg.tensor_parallel else ("none", "none")
    self.wi = Dense(cfg.d_model, cfg.d_ff, parallel=col, dtype=cfg.dtype,
                    param_dtype=cfg.param_dtype, device=device)
    self.wo = Dense(cfg.d_ff, cfg.d_model, parallel=row, dtype=cfg.dtype,
                    param_dtype=cfg.param_dtype, device=device)

  def forward(self, x, dtype=None):
    # flax nn.gelu is the tanh approximation.
    return self.wo(F.gelu(self.wi(x, dtype), approximate="tanh"), dtype)


def _dropout(y, key, rate: float):
  """flax ``nn.Dropout`` in training mode: ``y / keep_prob`` where the
  mask keeps, else 0; ``key`` (a host ``uint32 [2]``) None is the
  deterministic identity."""
  if key is None or rate <= 0.0:
    return y
  keep = prng.keep_mask(key, tuple(y.shape), rate, y.device)
  return torch.where(keep, y / (1.0 - rate), torch.zeros_like(y))


class Block(nn.Module):
  """``use_moe``: the MLP is ``models.moe.MoEMLP`` (submodule ``moe``),
  whose load-balancing loss ``forward(..., return_aux=True)`` returns
  beside the output."""

  def __init__(self, cfg: GPTConfig, device=None, use_moe: bool = False):
    super().__init__()
    self.cfg = cfg
    self.use_moe = use_moe
    self.ln1 = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
    self.attn = CausalSelfAttention(cfg, device=device)
    self.ln2 = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
    if use_moe:
      from easyparallellibrary_tpu_torch.models.moe import MoEMLP
      self.moe = MoEMLP(cfg, top_k=cfg.moe_top_k, impl=cfg.moe_impl,
                        device=device)
      self.moe.split_axes = (constants.DATA_AXIS,) + tuple(
          a for a in split_axes(cfg) if a != constants.EXPERT_AXIS)
    else:
      self.mlp = MLP(cfg, device=device)

  def forward(self, x, paged_info=None, cache=None, decode=False,
              slot_cursors=None, dtype=None, drop_key=None,
              return_aux=False):
    rate = self.cfg.dropout_rate
    attn_key = mlp_key = None
    if drop_key is not None:
      attn_key = prng.host_fold_in(drop_key, 0)
      mlp_key = prng.host_fold_in(drop_key, 1)
    x = x + _dropout(self.attn(self.ln1(x, dtype), paged_info, cache,
                               decode, slot_cursors, dtype), attn_key, rate)
    aux = None
    if self.use_moe:
      y, aux = self.moe(self.ln2(x, dtype), dtype)
    else:
      y = self.mlp(self.ln2(x, dtype), dtype)
    x = x + _dropout(y, mlp_key, rate)
    return (x, aux) if return_aux else x


def _add_aux(total, aux):
  if aux is None:
    return total
  return aux if total is None else total + aux


# Matrix products as the dispatcher sees them below autograd: F.linear,
# matmul and einsum all reach these.  The counterpart of XLA's dots for
# jax.checkpoint_policies.checkpoint_dots.
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
})


def _save_ops_policy(saved):
  def policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)
  return policy


def _remat_context(name: str):
  """The ``context_fn`` of ``torch.utils.checkpoint`` for a remat policy
  name, or None to save nothing but the block input:

  * ``"dots"`` saves every matrix-product output (recomputing only the
    elementwise work); the flash forward then re-runs in the backward;
  * ``"dots_flash"`` also saves the flash op's and the ring's ``(out,
    lse)``, so the backward never re-runs the flash forward kernel or the
    ring (the JAX policy saves the ``flash_out`` / ``flash_lse`` names);
  * ``"nothing"``, ``"everything"`` (and any other name, as in the JAX
    ``_remat_policy``) recompute the whole block.
  """
  if name == "dots":
    saved = _DOT_OPS
  elif name == "dots_flash":
    from easyparallellibrary_tpu_torch.sequence.ring_attention import (
        RING_FWD_OP)
    saved = _DOT_OPS | {FLASH_FWD_OP, RING_FWD_OP}
  else:
    return None
  return functools.partial(create_selective_checkpoint_contexts,
                           _save_ops_policy(saved))


def _remat_block(block: nn.Module, x, policy: str, dtype, drop_key=None,
                 params=None):
  """``block(x)`` under ``torch.utils.checkpoint``: ``(x, aux)``.  The
  block's parameters (``params``, default its own) are bound explicitly,
  since the recompute runs in the backward, after the caller's
  ``functional_call`` has unbound them; a dropout key redraws the same
  masks in the recompute."""
  if params is None:
    params = dict(block.named_parameters())

  def run(h):
    with step_span("train/remat"):
      return torch.func.functional_call(block, params, (h,),
                                        {"dtype": dtype, "drop_key": drop_key,
                                         "return_aux": True})

  context = _remat_context(policy)
  if context is None:
    return checkpoint(run, x, use_reentrant=False)
  return checkpoint(run, x, use_reentrant=False, context_fn=context)


def stage_layout(num_layers: int, num_chunks: int,
                 stage_plan: Optional[tuple] = None):
  """Blocks over pipeline chunks: ``(blocks_per_chunk, n_active)``.
  Even models give ``(L / chunks, None)``; uneven ones allocate
  ``ceil(L / chunks)`` slots a chunk with ``n_active[c]`` real blocks in
  chunk ``c`` (the first ``L % chunks`` chunks carry the extra block).
  ``stage_plan`` (the planner's) pins the per-chunk counts."""
  if stage_plan is not None:
    counts = tuple(int(c) for c in stage_plan)
    if len(counts) != num_chunks or sum(counts) != num_layers \
        or min(counts) < 1:
      raise ValueError(
          f"stage_plan {counts} must hold {num_chunks} positive counts "
          f"summing to num_layers={num_layers}")
    slots = max(counts)
    if all(c == slots for c in counts):
      return slots, None
    return slots, counts
  if num_layers % num_chunks == 0:
    return num_layers // num_chunks, None
  base, rem = divmod(num_layers, num_chunks)
  counts = tuple(base + 1 if c < rem else base for c in range(num_chunks))
  return base + 1, counts


class StageBlocks(nn.Module):
  """One pipeline chunk's blocks, each parameter stacked over ``rows``
  stage rows (``[rows, ...]``: every stage on one process, or this
  rank's one).  ``forward(x, row, n_active) -> (x, aux)`` runs row
  ``row``'s blocks (``aux`` their summed MoE loss, None without MoE); a
  slot at ``i >= n_active`` (an uneven stage's spare) is skipped, and its
  parameters take a zero gradient."""

  def __init__(self, cfg: GPTConfig, blocks_per_stage: int, rows: int,
               device=None, block_fn=None):
    super().__init__()
    self.cfg = cfg
    self.blocks_per_stage = blocks_per_stage
    for i in range(blocks_per_stage):
      block = (block_fn(i) if block_fn is not None else
               Block(cfg, device=device, use_moe=_uses_moe(cfg, i)))
      for mod in block.modules():
        for name, p in list(mod._parameters.items()):
          if p is not None:
            mod._parameters[name] = nn.Parameter(torch.empty(
                (rows,) + tuple(p.shape), dtype=p.dtype, device=p.device))
      self.add_module(f"block_{i}", block)

  def forward(self, x, row: int, n_active: Optional[int] = None, dtype=None,
              drop_key=None, remat: Optional[bool] = None):
    """``remat`` overrides ``cfg.remat`` (False: the caller recomputes
    the whole stage already)."""
    cfg = self.cfg
    remat = (cfg.remat if remat is None else remat) and \
        torch.is_grad_enabled()
    aux = None
    for i in range(self.blocks_per_stage):
      if n_active is not None and i >= n_active:
        break
      block = getattr(self, f"block_{i}")
      params = {n: p[row] for n, p in block.named_parameters()}
      key = None if drop_key is None else prng.host_fold_in(drop_key, i)
      if remat:
        x, a = _remat_block(block, x, getattr(cfg, "remat_policy", "nothing"),
                            dtype, key, params)
      else:
        x, a = torch.func.functional_call(
            block, params, (x,),
            {"dtype": dtype, "drop_key": key, "return_aux": True})
      aux = _add_aux(aux, a)
    return x, aux


def stage_dropout_key(rng, cfg: GPTConfig, m: int, k: int, s: int):
  """The dropout key of micro-batch ``m`` in chunk ``k`` of stage ``s``:
  ``rng`` folded with ``m * (S K) + k S + s`` (the JAX engines' fold), the
  same in a stage's forward and its recompute, distinct for every
  (micro-batch, virtual stage)."""
  S, K = cfg.pipeline_stages, max(1, cfg.pipeline_interleave)
  return prng.host_fold_in(rng, m * (S * K) + k * S + s)


def _pass_name(k: int, K: int) -> str:
  return "pipeline" if K == 1 else f"pipeline_{k}"


def run_chunk(model, x, k: int, s: int, dtype, drop_key=None, remat=None):
  """Chunk ``k`` of stage ``s`` (virtual stage ``k * S + s``) of a
  pipelined ``model`` (GPT or BERT) on ``x``: row ``s`` of pass ``k`` on
  one process, this rank's row on a stage mesh.  Returns ``(x, aux)``."""
  cfg = model.cfg
  S = cfg.pipeline_stages
  K = max(1, cfg.pipeline_interleave)
  v = k * S + s
  stacked = getattr(model, _pass_name(k, K)).stages.stacked
  return stacked(x, 0 if model.stages > 1 else s,
                 None if model.n_active is None else model.n_active[v],
                 dtype, drop_key, remat)


def add_stage_passes(model, cfg, per_chunk: int, device, stage_cls=None):
  """The stacked stage rows of a pipelined model: ``pipeline`` (or
  ``pipeline_{k}`` for pass ``k`` of an interleaved one) ``.stages.
  stacked``, a ``stage_cls`` (default :class:`StageBlocks`) of
  ``per_chunk`` blocks over every stage row on one process, or this
  rank's one on a stage mesh."""
  S, K = cfg.pipeline_stages, max(1, cfg.pipeline_interleave)
  for k in range(K):
    stages = nn.Module()
    stages.add_module("stacked", (stage_cls or StageBlocks)(
        cfg, per_chunk, 1 if model.stages > 1 else S, device=device))
    holder = nn.Module()
    holder.add_module("stages", stages)
    model.add_module(_pass_name(k, K), holder)


class GPT(nn.Module):
  """Decoder-only LM.  ``forward(ids) -> logits``; parameter names follow
  the flax tree (``block_0.attn.qkv.weight``, ``wte.weight``, ``wpe``)."""

  def __init__(self, cfg: GPTConfig, device="meta"):
    super().__init__()
    self.cfg = cfg
    self.tp = tp_size(cfg)
    self.stages = stage_size(cfg)
    self.split_axes = split_axes(cfg)
    smap = _engine_is_smap(cfg)
    if smap:
      vocab, head = "stage_vocab", "stage_column"
    elif cfg.tensor_parallel:
      vocab, head = "vocab", "column"
    else:
      vocab, head = "none", "none"
    self.wte = Embedding(cfg.vocab_size, cfg.d_model, parallel=vocab,
                         param_dtype=cfg.param_dtype, device=device)
    self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model,
                                        dtype=cfg.param_dtype,
                                        device=device))
    if cfg.pipeline_stages > 1:
      S, K = cfg.pipeline_stages, max(1, cfg.pipeline_interleave)
      per_chunk, self.n_active = stage_layout(cfg.num_layers, S * K,
                                              cfg.stage_plan)
      if self.n_active is not None and cfg.num_experts > 0:
        raise ValueError(
            f"num_layers={cfg.num_layers} must divide evenly into "
            f"{S * K} stages when MoE is enabled (the aux losses of "
            f"masked slots cannot be skipped per stage)")
      add_stage_passes(self, cfg, per_chunk, device)
    else:
      for i in range(cfg.num_layers):
        self.add_module(f"block_{i}", Block(cfg, device=device,
                                            use_moe=_uses_moe(cfg, i)))
    self.ln_f = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
    if not cfg.tie_embeddings:
      self.lm_head = Dense(
          cfg.d_model, cfg.vocab_size, use_bias=False, parallel=head,
          dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)

  def _pipeline_part(self, part, x, targets, cfg, dropout_rng):
    """The pipeline engines' pieces on this rank (``pipeline_part``):
    ``"feed"`` (ids -> the first stage's input), ``("stage", chunk,
    micro_batch)`` (this rank's chunk; ``(y, aux)`` with MoE) and
    ``"emit"`` (the last stage's output and ``targets`` -> the
    micro-batch's mean loss)."""
    dtype = cfg.dtype
    if part == "feed":
      if self.wte.parallel == "stage_vocab":
        # One rank owns each id's row, so the sum over the axes of the
        # partials cast to the compute dtype is the cast lookup, exactly
        # (half the bytes of JAX's fp32 sum, the same values).
        from easyparallellibrary_tpu_torch.parallel import pipeline_smap
        h = pipeline_smap.vocab_partial_embed(
            self.wte.weight, x, self.wte.vocab_axes).to(dtype)
        for axis in self.wte.vocab_axes:
          h = collectives.all_reduce(h, axis)
      else:
        h = self.wte(x).to(dtype)
      return h + self._positions(x.shape[1])[None].to(dtype)
    if part == "emit":
      h = self.ln_f(x, dtype)
      logits = (self.wte.attend(h) if cfg.tie_embeddings
                else self.lm_head(h, dtype))
      if self.wte.parallel == "stage_vocab":
        from easyparallellibrary_tpu_torch.parallel import pipeline_smap
        loss = pipeline_smap.sharded_softmax_ce(
            logits, targets, z_loss=cfg.z_loss, axes=self.wte.vocab_axes)
      else:
        loss = distributed_sparse_softmax_cross_entropy_with_logits(
            targets, logits, z_loss=cfg.z_loss, vocab_size=cfg.vocab_size)
      return loss.mean()
    _, j, m = part
    s = collectives.axis_index(constants.STAGE_AXIS)
    key = None
    if dropout_rng is not None:
      key = stage_dropout_key(dropout_rng, cfg, m, j, s)
    y, aux = run_chunk(self, x, j, s, dtype, key)
    return y if aux is None else (y, aux)

  def _positions(self, S: int):
    """The position rows of this rank's ``S`` tokens: offset by its
    slice's start when the tokens split over ``seq`` (JAX
    ``token_offset_slice``)."""
    from easyparallellibrary_tpu_torch.parallel.pipeline_smap import (
        token_offset_slice)
    return token_offset_slice(self.wpe, S,
                              constants.SEQ_AXIS in self.split_axes)

  def forward(self, ids, deterministic: bool = True, decode: bool = False,
              return_hidden: bool = False, slot_cursors=None,
              paged_info: Optional[PagedInfo] = None,
              cache: Optional[Dict[str, Any]] = None, dropout_rng=None,
              gather_logits: bool = True, pipeline_part=None,
              targets=None, return_aux: bool = False):
    """``gather_logits=False`` (tensor-parallel training) returns this
    rank's vocab block of the logits instead of the whole;
    ``pipeline_part`` runs one piece for the pipeline engines
    (:meth:`_pipeline_part`); ``return_aux`` returns ``(out, aux)``, the
    blocks' summed MoE loss (0 without MoE).  Under sequence
    parallelism ``ids`` are this rank's tokens (:func:`local_tokens`)."""
    cfg = resolve_model_dtypes(self.cfg)
    train = not deterministic and cfg.dropout_rate > 0
    if train and dropout_rng is None:
      raise ValueError("dropout in training mode (deterministic=False) "
                       "needs a dropout_rng key")
    if pipeline_part is not None:
      return self._pipeline_part(pipeline_part, ids, targets, cfg,
                                 dropout_rng if train else None)
    if cfg.pipeline_stages > 1 and decode:
      raise ValueError("KV-cache decode is single-program; run generation "
                       "on a non-pipelined config (pipeline_stages=1)")
    if self.stages > 1:
      raise ValueError(
          "this rank's model holds one pipeline stage; train it through "
          "make_gpt_train_step (the pipeline engines), or run the whole "
          "model on a process without a stage axis")
    if (slot_cursors is not None or paged_info is not None) and not decode:
      raise ValueError("slot_cursors/paged_info are decode-mode arguments "
                       "(serving engine); pass decode=True")
    if decode and cache is None:
      raise ValueError("decode=True needs a cache dict (generate() passes "
                       "one; the serving engines pass their caches)")
    B, S = ids.shape
    dtype = cfg.dtype
    if paged_info is not None:
      # Flat-token mode: ids is [T, 1]; out-of-range positions (padding
      # rows) clip, and their outputs are never read.
      pos_ids = torch.clamp(paged_info.positions, 0,
                            cfg.max_seq_len - 1).long()[:, None]
      pos = self.wpe[pos_ids]                                  # [T, 1, D]
    elif slot_cursors is not None:
      # Slot mode: each slot's positions start at its cursor; past-
      # capacity positions of idle slots clip (never read).
      pos_ids = torch.clamp(
          slot_cursors.long()[:, None]
          + torch.arange(S, device=ids.device)[None], 0,
          cfg.max_seq_len - 1)
      pos = self.wpe[pos_ids]                                  # [B, S, D]
    elif decode:
      if S > 1 or "pos_index" not in cache:
        cache["pos_index"] = 0
      offset = cache["pos_index"]
      cache["pos_index"] = S if S > 1 else offset + 1
      pos = self.wpe[offset:offset + S][None]
    else:
      pos = self._positions(S)[None]
    x = self.wte(ids).to(dtype) + pos.to(dtype)
    remat = cfg.remat and not decode and torch.is_grad_enabled()
    aux = None
    if cfg.pipeline_stages > 1:
      S, K = cfg.pipeline_stages, max(1, cfg.pipeline_interleave)
      for k in range(K):
        for s in range(S):
          key = (prng.host_fold_in(dropout_rng, k * S + s) if train
                 else None)
          x, a = run_chunk(self, x, k, s, dtype, key)
          aux = _add_aux(aux, a)
    for i in range(0 if cfg.pipeline_stages > 1 else cfg.num_layers):
      block = getattr(self, f"block_{i}")
      drop_key = prng.host_fold_in(dropout_rng, i) if train else None
      if remat:
        x, a = _remat_block(block, x, cfg.remat_policy, dtype, drop_key)
        aux = _add_aux(aux, a)
        continue
      layer_cache = None
      if cache is not None:
        layer_cache = cache.setdefault(f"block_{i}", {}).setdefault(
            "attn", {})
      x, a = block(x, paged_info, layer_cache, decode, slot_cursors, dtype,
                   drop_key, return_aux=True)
      aux = _add_aux(aux, a)
    x = self.ln_f(x, dtype)
    if return_hidden:
      out = x
    elif cfg.tie_embeddings:
      out = self.wte.attend(x)
    else:
      out = self.lm_head(x, dtype)
    if not return_hidden and self.tp > 1 and gather_logits:
      out = bridging.split_to_replica(out, dim=-1, logical=cfg.vocab_size)
    if return_aux:
      return out, (aux if aux is not None else
                   torch.zeros((), dtype=torch.float32, device=x.device))
    return out


def _chunked_tied_ce(model: GPT, params, hidden, targets):
  """Tied-head cross-entropy over sequence chunks of ``cfg.loss_chunk``
  tokens, each under a checkpoint that saves only its inputs: one
  ``[B, chunk, vocab]`` logits block is live at a time, forward and
  backward (the chunk's logit product is recomputed in the backward).
  Returns the mean over ``B * S`` tokens."""
  cfg = model.cfg
  C = cfg.loss_chunk
  B, S = targets.shape
  if S % C != 0:
    raise ValueError(f"loss_chunk={C} must divide sequence length {S}")
  wte = params["wte.weight"]

  def chunk_loss(h, t, table):
    # Vocab-parallel: the table is this rank's block; the hidden state
    # enters the split region (its gradient sums over the ranks).
    with step_span("train/remat"):
      h = bridging.copy_to_split(h) if model.tp > 1 else h
      logits = torch.matmul(h, table.to(h.dtype).t())
      return distributed_sparse_softmax_cross_entropy_with_logits(
          t, logits, z_loss=cfg.z_loss, vocab_size=cfg.vocab_size).sum()

  total = torch.zeros((), dtype=torch.float32, device=hidden.device)
  for i in range(S // C):
    chunk = slice(i * C, (i + 1) * C)
    total = total + checkpoint(chunk_loss, hidden[:, chunk],
                               targets[:, chunk], wte, use_reentrant=False)
  return total / (B * S)


def gpt_loss(model: GPT, params, batch, rng=None):
  """Next-token cross entropy; ``batch = {"ids": [B, S+1] int}``.
  Returns ``(loss, metrics)``.  With ``cfg.loss_chunk > 0`` (tied
  embeddings, no pipeline) the LM head and CE run chunked over the
  sequence (:func:`_chunked_tied_ce`).  With MoE the blocks' summed
  load-balancing loss is added with weight ``moe_aux_weight`` and
  reported as ``moe_aux_loss``.  Under the split axes of the model
  (``split_axes``) the loss is the mean over this rank's tokens
  (:func:`local_tokens`)."""
  cfg = model.cfg
  inputs, targets = local_tokens(model, batch["ids"].long())
  train = cfg.dropout_rate > 0 and rng is not None
  chunked = cfg.loss_chunk > 0
  if chunked and (not cfg.tie_embeddings or cfg.pipeline_stages > 1):
    raise ValueError(
        "loss_chunk requires tie_embeddings=True and pipeline_stages<=1 "
        f"(got tie_embeddings={cfg.tie_embeddings}, "
        f"pipeline_stages={cfg.pipeline_stages})")
  moe = cfg.num_experts > 0
  out = torch.func.functional_call(
      model, params, (inputs,),
      {"deterministic": not train, "return_hidden": chunked,
       "dropout_rng": rng if train else None, "gather_logits": False,
       "return_aux": moe},
      strict=True)
  if moe:
    out, aux = out
  if chunked:
    loss = _chunked_tied_ce(model, params, out, targets)
  else:
    loss = distributed_sparse_softmax_cross_entropy_with_logits(
        targets, out, z_loss=cfg.z_loss, vocab_size=cfg.vocab_size).mean()
  if not moe:
    return loss, {}
  return loss + cfg.moe_aux_weight * aux, {"moe_aux_loss": aux.detach()}


def _pipeline_grad_fn(model: GPT, schedule, collective: bool):
  """``grad_fn(params, batch, rng, loss_scale=None) -> (loss, metrics)``
  over this rank's parameters: the per-rank executor
  (``parallel.pipeline.Pipeline``) walks ``schedule`` over this rank's
  rows (and tokens, :func:`local_tokens`) of the batch cut into
  micro-batches, adding the gradients of ``loss_scale * loss`` into the
  parameters' ``.grad``.  With MoE the stages' load-balancing losses
  enter the objective with ``moe_aux_weight`` (JAX
  ``stage_aux_weight``): ``mean_m loss_m + w sum_{s,m} aux / M``.  ``collective``:
  the stage-resident boundary layers of the ``smap`` layout, fed and
  emitted by every rank at the same tick; without it (the ``vmap``
  layout) the boundary leaves' gradients and the loss are summed over
  the stage axis after the schedule.  A leaf the schedule gave no
  gradient (an uneven stage's masked slot) takes zeros, so AdamW decays
  it as the JAX package's does.  ``grad_fn.schedule`` is ``schedule``,
  the table the executor walks."""
  from easyparallellibrary_tpu_torch.parallel.api import _reduce_grads
  from easyparallellibrary_tpu_torch.parallel.pipeline import Pipeline
  cfg = resolve_model_dtypes(model.cfg)
  M = cfg.num_micro_batch

  def grad_fn(params, batch, rng, loss_scale=None):
    from easyparallellibrary_tpu_torch.utils.pytree import (
        split_micro_batches)
    train = cfg.dropout_rate > 0 and rng is not None
    device = next(iter(params.values())).device
    inputs, targets = local_tokens(
        model, torch.as_tensor(batch["ids"]).long().to(device))
    split = split_micro_batches({"inputs": inputs, "targets": targets}, M)
    mbs = [{k: v[m] for k, v in split.items()} for m in range(M)]

    def call(x, **kw):
      return torch.func.functional_call(model, params, (x,), kw, strict=True)

    def feed(mb):
      return call(mb["inputs"], pipeline_part="feed")

    def stage(j, x, m):
      return call(x, pipeline_part=("stage", j, m), deterministic=not train,
                  dropout_rng=rng if train else None)

    def emit(y, mb):
      return call(y, pipeline_part="emit", targets=mb["targets"])

    rows, length = mbs[0]["inputs"].shape
    aux_w = cfg.moe_aux_weight if cfg.num_experts > 0 else None
    pipe = Pipeline(schedule, feed, stage, emit,
                    act_shape=(rows, length, cfg.d_model),
                    act_dtype=cfg.dtype, device=device,
                    collective_boundary=collective, stage_aux_weight=aux_w)
    loss = pipe(mbs, loss_scale)
    if not collective:
      loss = collectives.all_reduce(loss, constants.STAGE_AXIS)
      _reduce_grads(
          params, [n for n in params if not n.startswith("pipeline")])
    for p in params.values():
      if p.requires_grad and p.grad is None:
        p.grad = torch.zeros_like(p)
    if cfg.num_experts <= 0:
      return loss, {}
    return (loss + aux_w * pipe.stage_aux_loss,
            {"moe_aux_loss": pipe.stage_aux_loss.detach()})

  grad_fn.schedule = schedule
  return grad_fn


def _check_stage_mesh(model: GPT, what: str) -> None:
  if model.stages <= 1:
    raise ValueError(
        f"{what} runs one stage a rank: build the model on a mesh whose "
        f"stage axis is pipeline_stages={model.cfg.pipeline_stages} "
        f"(cluster.mesh_shape 'stage:{model.cfg.pipeline_stages}')")


def make_gpt_1f1b_grad_fn(model: GPT):
  """1F1B gradient function for a pipelined GPT with the boundary layers
  replicated on every stage rank (the ``vmap`` layout): rank 0 feeds,
  the last rank emits, and the tied table's gradient is summed over the
  stage axis before the update, as GSPMD does in the JAX engine.
  Returns ``grad_fn(params, batch, rng, loss_scale=None) -> (loss,
  metrics)`` that adds the gradients of ``loss_scale * loss`` into the
  parameters' ``.grad`` (``runtime.trainer.build_train_step``'s
  ``grad_fn``)."""
  from easyparallellibrary_tpu_torch.parallel.schedule_1f1b import (
      one_f_one_b_schedule)
  cfg = model.cfg
  if cfg.pipeline_stages <= 1:
    raise ValueError("1F1B needs pipeline_stages > 1")
  if cfg.num_experts > 0 and cfg.num_layers % cfg.pipeline_stages:
    raise ValueError(
        f"num_layers={cfg.num_layers} must divide evenly into "
        f"{cfg.pipeline_stages} stages when MoE is enabled (the aux "
        f"losses of masked slots cannot be skipped per stage)")
  if cfg.pipeline_interleave > 1:
    raise ValueError(
        "1F1B with pipeline_interleave > 1 is not supported on the "
        "vmap layout (as the JAX package's lockstep engine); use "
        "pipeline.engine='smap' for true Megatron-interleaved 1F1B, "
        "interleave=1, or PreferForward for circular weight placement")
  _check_stage_mesh(model, "the 1F1B engine")
  return _pipeline_grad_fn(
      model, one_f_one_b_schedule(cfg.pipeline_stages, cfg.num_micro_batch),
      collective=False)


def make_gpt_gpipe_grad_fn(model: GPT, remat_stage: bool = False):
  """GPipe gradient function with the boundary layers replicated (the
  ``vmap`` layout's PreferForward, and its fallback for an interleaved
  model: ``K`` chained passes, the circular weight placement), where
  the JAX package differentiates through its vmapped ``Pipeline``."""
  from easyparallellibrary_tpu_torch.parallel.pipeline import gpipe_schedule
  cfg = model.cfg
  _check_stage_mesh(model, "the GPipe engine")
  schedule = gpipe_schedule(cfg.pipeline_stages, cfg.num_micro_batch,
                            max(1, cfg.pipeline_interleave), remat_stage)
  return _pipeline_grad_fn(model, schedule, collective=False)


def make_gpt_smap_grad_fn(model: GPT, mesh=None, schedule: str = "1f1b"):
  """The ``smap`` engine's gradient function for GPT: stage-resident
  boundary layers (the tied table or head ``[V/S, D]`` a stage, the
  lookup and the cross-entropy collective over the stage axis), every
  rank feeding and emitting at the same tick (``parallel.pipeline_smap``).
  ``schedule``: ``"1f1b"`` (interleaved 1F1B when ``pipeline_interleave``
  K > 1) or ``"gpipe"``.  Takes the same parameter names as the other
  engines (``weights.shard_params`` cuts each rank's rows), so
  checkpoints move between engines.  Returns ``grad_fn(params, batch,
  rng, loss_scale=None) -> (loss, metrics)``."""
  from easyparallellibrary_tpu_torch.parallel import pipeline_smap
  from easyparallellibrary_tpu_torch.parallel.pipeline import gpipe_schedule
  from easyparallellibrary_tpu_torch.parallel.pipeline_interleaved import (
      interleaved_pipe_schedule)
  from easyparallellibrary_tpu_torch.parallel.schedule_1f1b import (
      one_f_one_b_schedule)
  cfg = model.cfg
  S, M = cfg.pipeline_stages, cfg.num_micro_batch
  K = max(1, cfg.pipeline_interleave)
  if S <= 1:
    raise ValueError("smap pipeline needs pipeline_stages > 1")
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
  if schedule not in ("gpipe", "1f1b", "interleaved"):
    raise ValueError(f"schedule must be gpipe|1f1b|interleaved, "
                     f"got {schedule!r}")
  # Sequence parallelism composes: the stage programs run the ring or
  # Ulysses over the seq group (seq peers share a stage index, so they
  # walk the same ticks and meet at every collective; no uniform-compute
  # mode is needed), tokens split like rows over data.
  pipeline_smap.seq_manual_mode(cfg.attn_impl, cfg.num_heads)
  if cfg.num_experts > 0 and cfg.num_layers % (S * K):
    raise ValueError(
        f"num_layers={cfg.num_layers} must divide evenly into "
        f"{S * K} stages/chunks when MoE is enabled (matches the "
        f"model's own constraint)")
  if cfg.vocab_size % S:
    raise ValueError(f"vocab_size {cfg.vocab_size} must divide into "
                     f"{S} stage-resident shards")
  if cfg.tensor_parallel:
    from easyparallellibrary_tpu_torch.env import Env
    check_unpadded_vocab(cfg.vocab_size,
                         mesh if mesh is not None else Env.get().cluster.mesh)
  if model.wte.parallel != "stage_vocab":
    raise ValueError("the smap engine needs the stage-resident boundary "
                     "layers: build the model under pipeline.engine='smap'")
  _check_stage_mesh(model, "the smap engine")
  if schedule == "interleaved":
    table = interleaved_pipe_schedule(S, K, M)
  elif schedule == "gpipe":
    table = gpipe_schedule(S, M)
  else:
    table = one_f_one_b_schedule(S, M)
  return _pipeline_grad_fn(model, table, collective=True)


def auto_parallel_gpt(cfg: GPTConfig, config=None) -> GPT:
  """Auto-parallel model build: with ``auto.auto_parallel`` on and
  ``pipeline.num_stages`` N > 1 (and stages not pinned already), the
  stage layout comes from ``parallel.planner.AutoStageGenerator`` over
  the blocks and lands in ``GPTConfig.stage_plan``, with N stages and
  ``pipeline.num_micro_batch``; otherwise the config passes through.
  Only the transformer blocks are planned (the boundary layers run
  outside the stacked trunk), with unit weights: GPT blocks are
  uniform."""
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.parallel.planner import (
      AutoStageGenerator)
  conf = config if config is not None else Env.get().config
  N = conf.pipeline.num_stages
  if not conf.auto.auto_parallel or N <= 1 or cfg.pipeline_stages > 1:
    return GPT(cfg)
  K = max(1, cfg.pipeline_interleave)
  chunks = N * K
  L = cfg.num_layers
  if L < chunks:
    raise ValueError(
        f"auto-parallel needs num_layers >= stages*interleave "
        f"({L} < {chunks}); reduce pipeline.num_stages")
  stages = AutoStageGenerator(num_stages=chunks).search(
      [f"block_{i}" for i in range(L)])
  counts = tuple(len(s) for s in stages)
  if len(counts) != chunks or min(counts) < 1:
    raise ValueError(
        f"auto stage search produced an invalid plan {counts} for "
        f"{chunks} chunks over {L} blocks")
  mb = conf.pipeline.num_micro_batch
  return GPT(dataclasses.replace(
      cfg, pipeline_stages=N, stage_plan=counts,
      num_micro_batch=mb if mb > 1 else max(cfg.num_micro_batch, 1)))


# Once-per-process latches: the advisory and generate()'s pipeline
# fallback say the same thing every time.
_SMAP_ADVICE_LOGGED = [False]
_PP_GENERATE_FALLBACK_LOGGED = [False]


def _smap_preconditions_ok(cfg: GPTConfig, conf, sched) -> bool:
  """True iff ``pipeline.engine='smap'`` would take this config (the
  advisory of :func:`make_gpt_train_step` never recommends an engine that
  would raise)."""
  S = cfg.pipeline_stages
  K = max(1, cfg.pipeline_interleave)
  if cfg.vocab_size % S:
    return False
  if K > 1 and not sched.remat_stage:
    return False
  if cfg.num_experts > 0 and cfg.num_layers % (S * K):
    return False
  model_size = collectives.axis_size(constants.MODEL_AXIS)
  if cfg.tensor_parallel and model_size > 1 \
      and cfg.vocab_size % (S * model_size):
    return False
  seq = collectives.axis_size(constants.SEQ_AXIS)
  if seq > 1 and cfg.attn_impl == "ring" and \
      conf.sequence.ring_impl not in ("flash", "dense"):
    return False  # the einsum ring cannot run in a stage program
  return not (seq > 1 and cfg.attn_impl == "ulysses"
              and cfg.num_heads % seq)


def make_gpt_train_step(model: GPT, config=None):
  """Config-driven train step for GPT, engine- and schedule-aware (the
  JAX dispatch):

  * ``pipeline.engine = "smap"``: :func:`make_gpt_smap_grad_fn`,
    ``PreferBackward*`` -> ``"1f1b"`` (interleaved with
    ``pipeline_interleave`` > 1), ``PreferForward`` -> ``"gpipe"``;
  * ``""`` / ``"vmap"``: ``PreferBackward*`` -> :func:`make_gpt_1f1b_grad_fn`,
    ``PreferForward`` (or an interleaved model, with a warning) -> GPipe
    (:func:`make_gpt_gpipe_grad_fn`);
  * ``PreferBackwardOptimizer`` applies the update in one group a stage
    unless ``optimizer.num_apply_group`` pins a count.

  A non-pipelined config, ``pipeline_debug_sequential``, or a pipelined
  model held whole by one process (no stage axis) train through
  :func:`gpt_loss`.  ZeRO (``zero.level``, a state built by
  ``create_sharded_train_state``) composes with every engine: the step
  reduce-scatters the gradients to their data-axis owners
  (``runtime.zero.apply_sharded``).  The returned step carries
  ``dispatch``: ``(engine, schedule, num_apply_group)``.
  """
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.runtime.trainer import build_train_step
  from easyparallellibrary_tpu_torch.strategies.scheduler import (
      get_scheduler)
  cfg = model.cfg
  conf = config if config is not None else Env.get().config
  groups = None
  grad_fn = None
  dispatch = ("autodiff", None, None)
  if cfg.pipeline_stages > 1 and not cfg.pipeline_debug_sequential:
    sched = get_scheduler(cfg.pipeline_schedule or conf.pipeline.strategy)
    if sched.grouped_apply and conf.optimizer.num_apply_group <= 1:
      groups = cfg.pipeline_stages
    if model.stages <= 1:
      dispatch = ("autodiff", None, groups)
    elif conf.pipeline.engine == "smap":
      schedule = "1f1b" if sched.remat_stage else "gpipe"
      grad_fn = make_gpt_smap_grad_fn(model, schedule=schedule)
      dispatch = ("smap", grad_fn.schedule.name, groups)
    else:
      if not _SMAP_ADVICE_LOGGED[0] and \
          _smap_preconditions_ok(cfg, conf, sched):
        _SMAP_ADVICE_LOGGED[0] = True
        get_logger().info(
            "pipeline.engine=%r keeps the embedding and head on every stage "
            "rank; pipeline.engine='smap' makes them stage-resident "
            "([V/S, D] a stage).", conf.pipeline.engine)
      use_1f1b = sched.remat_stage
      if use_1f1b and cfg.pipeline_interleave > 1:
        get_logger().warning(
            "pipeline.strategy=%s requests 1F1B but pipeline_interleave=%d "
            "is only interleaved on the smap engine "
            "(pipeline.engine='smap'); falling back to GPipe order (M "
            "live activations per stage).", sched.name,
            cfg.pipeline_interleave)
        use_1f1b = False
      if use_1f1b:
        grad_fn = make_gpt_1f1b_grad_fn(model)
      else:
        grad_fn = make_gpt_gpipe_grad_fn(model, sched.remat_stage)
        groups = None
      dispatch = ("vmap", grad_fn.schedule.name, groups)
  if grad_fn is None:
    step = build_train_step(lambda p, b, r: gpt_loss(model, p, b, r),
                            config=conf, num_apply_group=groups)
  else:
    step = build_train_step(grad_fn=grad_fn, config=conf,
                            num_apply_group=groups)
  step.dispatch = dispatch
  step.grad_fn = grad_fn
  return step


def gpt_flops_per_token(cfg: GPTConfig, seq_len: Optional[int] = None
                        ) -> float:
  """Training FLOPs/token (fwd+bwd ≈ 3x fwd): 6*N_dense + attention."""
  S = seq_len or cfg.max_seq_len
  D, F, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
  n_matmul = L * (4 * D * D + 2 * D * F) + D * V   # qkv+proj, mlp, head
  if cfg.num_experts > 0 and cfg.moe_top_k > 1:
    # Top-k > 1 runs the FFN of every MoE block k times a token.
    n_moe = sum(_uses_moe(cfg, i) for i in range(L))
    n_matmul += n_moe * 2 * D * F * (cfg.moe_top_k - 1)
  attn = L * 2 * D * S                              # qk^T and attn*v
  return 6.0 * n_matmul + 6.0 * attn


def sample_logits(logits, key, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
  """Sample token ids from ``[..., vocab]`` logits with the counter key
  ``key [..., 2]`` (``utils.prng``).  ``temperature <= 0`` is greedy
  (the first maximum, as ``jnp.argmax``); ``top_k > 0`` keeps the k
  highest logits; ``top_p < 1`` keeps the smallest set whose mass
  reaches p (the top token always survives).  Top-k first, then top-p
  over the survivors."""
  if not 0.0 < top_p <= 1.0:
    raise ValueError(f"top_p must be in (0, 1]: {top_p}")
  if top_k < 0:
    raise ValueError(f"top_k must be >= 0: {top_k}")
  if temperature <= 0:
    return torch.argmax(logits, dim=-1)
  logits = logits / temperature
  neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
  if top_k and top_k < logits.shape[-1]:
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    logits = torch.where(logits < kth, neg, logits)
  if top_p < 1.0:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    inf = torch.tensor(float("inf"), dtype=logits.dtype,
                       device=logits.device)
    thresh = torch.where(keep_sorted, sorted_logits, inf).min(
        dim=-1, keepdim=True).values
    logits = torch.where(logits < thresh, neg, logits)
  return prng.categorical(key, logits)


@torch.inference_mode()
def generate(model: GPT, params, prompt_ids, max_new_tokens: int,
             temperature: float = 0.0, rng=None, use_cache: bool = True,
             top_k: int = 0, top_p: float = 1.0):
  """Autoregressive decoding; returns int64 ``[B, prompt +
  max_new_tokens]`` on ``prompt_ids``' device.

  With ``use_cache`` each layer keeps a K/V cache (one prefill, then one
  token per forward); ``use_cache=False`` re-runs the full forward per
  token, the simple path the cached one is held against.  ``rng`` is a
  ``utils.prng`` key (default ``prng_key(0)``), folded with the token
  index for each draw.
  """
  B, plen = prompt_ids.shape
  if plen == 0:
    raise ValueError("generate() needs a non-empty prompt (at least a BOS "
                     "token)")
  if not 0.0 < top_p <= 1.0:
    raise ValueError(f"top_p must be in (0, 1]: {top_p}")
  if top_k < 0:
    raise ValueError(f"top_k must be >= 0: {top_k}")
  total = plen + max_new_tokens
  if total > model.cfg.max_seq_len:
    raise ValueError(f"prompt + new tokens ({total}) exceeds "
                     f"max_seq_len {model.cfg.max_seq_len}")
  device = prompt_ids.device
  ids = torch.zeros((B, total), dtype=torch.int64, device=device)
  ids[:, :plen] = prompt_ids
  key = torch.as_tensor(
      np.asarray(rng if rng is not None else prng.prng_key(0), np.int64),
      device=device)

  def pick(next_logits, t):
    step_key = prng.fold_in(key, torch.tensor(t, device=device))
    return sample_logits(next_logits, step_key, temperature, top_k, top_p)

  def call(x, **kw):
    return torch.func.functional_call(model, params, (x,), kw, strict=True)

  if max_new_tokens <= 0:
    return ids
  if use_cache and model.cfg.pipeline_stages > 1:
    # KV-cache decode is single-program: a pipelined config re-runs the
    # whole forward for every token (logged once per process).
    if not _PP_GENERATE_FALLBACK_LOGGED[0]:
      _PP_GENERATE_FALLBACK_LOGGED[0] = True
      get_logger().warning(
          "generate(use_cache=True) on a pipelined config "
          "(pipeline_stages=%d) falls back to full-forward-per-token: "
          "KV-cache decode is single-program and cannot span pipeline "
          "stages.  Restore the checkpoint into a pipeline_stages=1 config "
          "for O(1)-per-token decoding.  (Logged once per process.)",
          model.cfg.pipeline_stages)
    use_cache = False
  if use_cache:
    cache: Dict[str, Any] = {}
    logits = call(ids[:, :plen], decode=True, cache=cache)
    ids[:, plen] = pick(logits[:, plen - 1], plen)
    for t in range(plen + 1, total):
      logits = call(ids[:, t - 1:t], decode=True, cache=cache)
      ids[:, t] = pick(logits[:, 0], t)
    return ids
  for t in range(plen, total):
    logits = call(ids)
    ids[:, t] = pick(logits[:, t - 1], t)
  return ids
