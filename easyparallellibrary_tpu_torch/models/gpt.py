"""GPT — the flagship decoder, for serving and training (port of
``easyparallellibrary_tpu/models/gpt.py``).

Like the flax module, :class:`GPT` is the model's structure and the
weights travel beside it: ``GPT(cfg)`` holds parameters on the ``meta``
device, and the entry points (:func:`paged_step_logits`,
:func:`generate`, the serving engine) run it through
``torch.func.functional_call`` with a ``params`` state dict
(``weights.init_params`` / ``weights.from_jax_params``).

Three position modes, as ``GPT.__call__`` in the JAX package: plain
(a whole sequence), legacy decode (``generate``'s KV cache, grown in the
``cache`` dict the caller passes), and paged (the serving engine's
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

bf16 compute over fp32 parameters by default.  Dropout in training mode,
pipeline, MoE, tensor-parallel and the ring/Ulysses attention
implementations raise (ROADMAP.md Queue 1).
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
from easyparallellibrary_tpu_torch._not_ported import (
    AMP, CONTIGUOUS_ENGINE, PARALLEL_STRATEGIES, RUNTIME, TENSOR_PARALLEL,
    not_ported)
from easyparallellibrary_tpu_torch.kernels.flash_attention import (
    FLASH_FWD_OP, flash_attention)
from easyparallellibrary_tpu_torch.kernels.paged_attention import (
    PagedTiles, paged_attention)
from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding, LayerNorm
from easyparallellibrary_tpu_torch.ops.losses import (
    distributed_sparse_softmax_cross_entropy_with_logits)
from easyparallellibrary_tpu_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class GPTConfig:
  """Every field of the JAX ``GPTConfig``.  A field whose feature the
  port has not reached raises when set to anything but its default."""
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

  def __post_init__(self):
    if self.tensor_parallel:
      raise not_ported("GPTConfig(tensor_parallel=True)", TENSOR_PARALLEL)
    if self.attn_impl in ("ring", "ulysses"):
      raise not_ported(f"GPTConfig(attn_impl={self.attn_impl!r})",
                       PARALLEL_STRATEGIES)
    if self.pipeline_stages > 1:
      raise not_ported("GPTConfig(pipeline_stages > 1)", PARALLEL_STRATEGIES)
    if self.num_experts > 0:
      raise not_ported("GPTConfig(num_experts > 0)", PARALLEL_STRATEGIES)
    if self.seq_parallel:
      raise not_ported("GPTConfig(seq_parallel=True)", PARALLEL_STRATEGIES)


def _attention_scale(hd: int, dtype, device) -> torch.Tensor:
  # 1 / sqrt(hd) with sqrt in fp32 rounded to the dtype, as
  # 1.0 / jnp.sqrt(hd).astype(dtype).
  return 1.0 / torch.sqrt(torch.tensor(float(hd), device=device)).to(dtype)


def _masked_softmax_attend(q, k, v, valid, dtype):
  """``softmax(q k^T * scale)`` with ``-1e9`` outside ``valid``, fp32
  softmax, probabilities cast to ``dtype`` before the V product."""
  scale = _attention_scale(q.shape[-1], dtype, q.device)
  logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
  logits = torch.where(valid, logits,
                       torch.tensor(-1e9, dtype=logits.dtype,
                                    device=q.device))
  probs = torch.softmax(logits.float(), dim=-1)
  return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v)


def _dense_causal_attention(q, k, v, dtype):
  """Plain causal attention over ``[B, S, H, hd]``: matmuls in the
  compute dtype, fp32 softmax."""
  S = q.shape[1]
  mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
  return _masked_softmax_attend(q, k, v, mask[None, None], dtype)


def slot_cache_attend(q, k, v, cached_k, cached_v, cursors, dtype):
  """Slot-indexed KV-cache attention (``generate``'s decode step).

  ``q``/``k``/``v`` are ``[B, C, H, hd]``; ``cached_k``/``cached_v``
  ``[B, Lc, H, hd]``; token ``i`` of row ``b`` is written at
  ``cursors[b] + i`` and attends positions ``<= cursors[b] + i``.  The
  caches are written in place.  Returns ``(out, cached_k, cached_v)``.
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


class CausalSelfAttention(nn.Module):

  def __init__(self, cfg: GPTConfig, device=None):
    super().__init__()
    self.cfg = cfg
    D = cfg.d_model
    self.qkv = Dense(D, 3 * D, use_bias=False, dtype=cfg.dtype,
                     param_dtype=cfg.param_dtype, device=device)
    self.proj = Dense(D, D, use_bias=False, dtype=cfg.dtype,
                      param_dtype=cfg.param_dtype, device=device)

  def forward(self, x, paged_info=None, cache=None, decode=False):
    cfg = self.cfg
    B, S, D = x.shape
    H = cfg.num_heads
    qkv = self.qkv(x).reshape(B, S, 3, H, D // H)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if paged_info is not None:
      out, _, _ = paged_cache_attend(
          q[:, 0], k[:, 0], v[:, 0], cache["cached_key"],
          cache["cached_value"], paged_info, cfg.dtype)
      out = out[:, None]
    elif decode:
      out = self._decode_attend(q, k, v, cache)
    elif cfg.attn_impl == "pallas_flash":
      out = flash_attention(q, k, v, causal=True)
    elif cfg.attn_impl == "xla":
      out = _dense_causal_attention(q, k, v, cfg.dtype)
    else:
      # A typo'd impl silently falling back to dense attention would
      # mislabel any benchmark run on top of it.
      raise ValueError(
          f"attn_impl must be 'xla', 'pallas_flash', 'ring' or "
          f"'ulysses'; got {cfg.attn_impl!r}")
    return self.proj(out.reshape(B, S, D))

  def _decode_attend(self, q, k, v, cache):
    """``generate``'s KV cache: ``[B, max_seq_len, H, hd]`` grown in the
    caller's ``cache`` dict.  Prefill (S > 1) is plain causal attention
    with the prompt's K/V stored; a one-token step appends at the cursor
    and attends the valid prefix."""
    cfg = self.cfg
    B, S, H, hd = q.shape
    if "cached_key" not in cache:
      shape = (B, cfg.max_seq_len, H, hd)
      cache["cached_key"] = torch.zeros(shape, dtype=cfg.dtype,
                                        device=q.device)
      cache["cached_value"] = torch.zeros(shape, dtype=cfg.dtype,
                                          device=q.device)
      cache["cache_index"] = 0
    if S > 1:
      cache["cached_key"][:, :S] = k.to(cfg.dtype)
      cache["cached_value"][:, :S] = v.to(cfg.dtype)
      cache["cache_index"] = S
      return _dense_causal_attention(q, k, v, cfg.dtype)
    cursors = torch.full((B,), cache["cache_index"], device=q.device)
    out, _, _ = slot_cache_attend(q, k, v, cache["cached_key"],
                                  cache["cached_value"], cursors, cfg.dtype)
    cache["cache_index"] += 1
    return out


class MLP(nn.Module):

  def __init__(self, cfg: GPTConfig, device=None):
    super().__init__()
    self.wi = Dense(cfg.d_model, cfg.d_ff, dtype=cfg.dtype,
                    param_dtype=cfg.param_dtype, device=device)
    self.wo = Dense(cfg.d_ff, cfg.d_model, dtype=cfg.dtype,
                    param_dtype=cfg.param_dtype, device=device)

  def forward(self, x):
    # flax nn.gelu is the tanh approximation.
    return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class Block(nn.Module):

  def __init__(self, cfg: GPTConfig, device=None):
    super().__init__()
    self.ln1 = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
    self.attn = CausalSelfAttention(cfg, device=device)
    self.ln2 = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
    self.mlp = MLP(cfg, device=device)

  def forward(self, x, paged_info=None, cache=None, decode=False):
    x = x + self.attn(self.ln1(x), paged_info, cache, decode)
    return x + self.mlp(self.ln2(x))


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
  * ``"dots_flash"`` also saves the flash op's ``(out, lse)``, so the
    backward never re-runs the flash forward kernel (the JAX policy saves
    the ``flash_out`` / ``flash_lse`` names);
  * ``"nothing"``, ``"everything"`` (and any other name, as in the JAX
    ``_remat_policy``) recompute the whole block.
  """
  if name == "dots":
    saved = _DOT_OPS
  elif name == "dots_flash":
    saved = _DOT_OPS | {FLASH_FWD_OP}
  else:
    return None
  return functools.partial(create_selective_checkpoint_contexts,
                           _save_ops_policy(saved))


def _remat_block(block: nn.Module, x, policy: str):
  """``block(x)`` under ``torch.utils.checkpoint``.  The block's
  parameters are bound explicitly, since the recompute runs in the
  backward, after the caller's ``functional_call`` has unbound them."""
  params = dict(block.named_parameters())

  def run(h):
    return torch.func.functional_call(block, params, (h,))

  context = _remat_context(policy)
  if context is None:
    return checkpoint(run, x, use_reentrant=False)
  return checkpoint(run, x, use_reentrant=False, context_fn=context)


class GPT(nn.Module):
  """Decoder-only LM.  ``forward(ids) -> logits``; parameter names follow
  the flax tree (``block_0.attn.qkv.weight``, ``wte.weight``, ``wpe``)."""

  def __init__(self, cfg: GPTConfig, device="meta"):
    super().__init__()
    self.cfg = cfg
    self.wte = Embedding(cfg.vocab_size, cfg.d_model,
                         param_dtype=cfg.param_dtype, device=device)
    self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model,
                                        dtype=cfg.param_dtype,
                                        device=device))
    for i in range(cfg.num_layers):
      self.add_module(f"block_{i}", Block(cfg, device=device))
    self.ln_f = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
    if not cfg.tie_embeddings:
      self.lm_head = Dense(cfg.d_model, cfg.vocab_size, use_bias=False,
                           dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                           device=device)

  def forward(self, ids, deterministic: bool = True, decode: bool = False,
              return_hidden: bool = False, slot_cursors=None,
              paged_info: Optional[PagedInfo] = None,
              cache: Optional[Dict[str, Any]] = None):
    from easyparallellibrary_tpu_torch.env import Env
    cfg = self.cfg
    if Env.get().config.amp.level == constants.AMP_O1:
      raise not_ported("amp.level='O1'", AMP)
    if not deterministic and cfg.dropout_rate > 0:
      raise not_ported("dropout in training mode", RUNTIME)
    if (slot_cursors is not None or paged_info is not None) and not decode:
      raise ValueError("slot_cursors/paged_info are decode-mode arguments "
                       "(serving engine); pass decode=True")
    if slot_cursors is not None:
      raise not_ported("slot-mode decode (slot_cursors=...)",
                       CONTIGUOUS_ENGINE)
    if decode and cache is None:
      raise ValueError("decode=True needs a cache dict (generate() passes "
                       "one; the paged engine passes its pools)")
    B, S = ids.shape
    dtype = cfg.dtype
    if paged_info is not None:
      # Flat-token mode: ids is [T, 1]; out-of-range positions (padding
      # rows) clip, and their outputs are never read.
      pos_ids = torch.clamp(paged_info.positions, 0,
                            cfg.max_seq_len - 1).long()[:, None]
      pos = self.wpe[pos_ids]                                  # [T, 1, D]
    elif decode:
      if S > 1 or "pos_index" not in cache:
        cache["pos_index"] = 0
      offset = cache["pos_index"]
      cache["pos_index"] = S if S > 1 else offset + 1
      pos = self.wpe[offset:offset + S][None]
    else:
      pos = self.wpe[:S][None]
    x = self.wte(ids).to(dtype) + pos.to(dtype)
    remat = cfg.remat and not decode and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
      block = getattr(self, f"block_{i}")
      if remat:
        x = _remat_block(block, x, cfg.remat_policy)
        continue
      layer_cache = None
      if cache is not None:
        layer_cache = cache.setdefault(f"block_{i}", {}).setdefault(
            "attn", {})
      x = block(x, paged_info, layer_cache, decode)
    x = self.ln_f(x)
    if return_hidden:
      return x
    if cfg.tie_embeddings:
      return self.wte.attend(x)
    return self.lm_head(x)


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
    logits = torch.matmul(h, table.to(h.dtype).t())
    return distributed_sparse_softmax_cross_entropy_with_logits(
        t, logits, z_loss=cfg.z_loss).sum()

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
  sequence (:func:`_chunked_tied_ce`)."""
  cfg = model.cfg
  ids = batch["ids"].long()
  inputs, targets = ids[:, :-1], ids[:, 1:]
  train = cfg.dropout_rate > 0 and rng is not None
  chunked = cfg.loss_chunk > 0
  if chunked and (not cfg.tie_embeddings or cfg.pipeline_stages > 1):
    raise ValueError(
        "loss_chunk requires tie_embeddings=True and pipeline_stages<=1 "
        f"(got tie_embeddings={cfg.tie_embeddings}, "
        f"pipeline_stages={cfg.pipeline_stages})")
  out = torch.func.functional_call(
      model, params, (inputs,),
      {"deterministic": not train, "return_hidden": chunked}, strict=True)
  if chunked:
    return _chunked_tied_ce(model, params, out, targets), {}
  loss = distributed_sparse_softmax_cross_entropy_with_logits(
      targets, out, z_loss=cfg.z_loss)
  return loss.mean(), {}


def gpt_flops_per_token(cfg: GPTConfig, seq_len: Optional[int] = None
                        ) -> float:
  """Training FLOPs/token (fwd+bwd ≈ 3x fwd): 6*N_dense + attention."""
  S = seq_len or cfg.max_seq_len
  D, F, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
  n_matmul = L * (4 * D * D + 2 * D * F) + D * V   # qkv+proj, mlp, head
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
