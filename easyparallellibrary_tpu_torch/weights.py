"""Model weights for the port (GPT, BERT, ResNet): the bridge from the
JAX parameter tree, and seeded initialisers.

The port's models name their parameters after the flax tree, so
``block_3/mlp/wi/kernel`` becomes ``block_3.mlp.wi.weight``:

* Dense ``kernel [in, out]`` -> ``weight [out, in]`` (transposed; a
  pipelined model's stacked ``[S, in, out]`` -> ``[S, out, in]``),
  ``bias`` -> ``bias``;
* Conv ``kernel`` HWIO ``[kh, kw, in, out]`` -> ``weight [out, in, kh,
  kw]``;
* Embedding ``embedding`` -> ``weight``; ``wpe`` -> ``wpe``;
* LayerNorm, GroupNorm and BatchNorm ``scale`` -> ``weight``, ``bias``
  -> ``bias`` (only norms have a ``scale``); a BatchNorm's
  ``batch_stats`` (``mean``, ``var``) keep their names, as the model's
  buffers (``from_jax_params(variables["batch_stats"])``);
* an MoE block's ``moe/router_kernel [D, E]``, ``moe/wi [E, D, F]`` and
  ``moe/wo [E, F, D]`` keep their names and layout
  (``block_1.moe.wi``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch.ops.adamw import is_norm
from easyparallellibrary_tpu_torch.utils.device import resolve_device


def _flatten(tree: Dict[str, Any], prefix: str = ""):
  for key, value in tree.items():
    path = f"{prefix}{key}"
    if isinstance(value, dict):
      yield from _flatten(value, path + "/")
    else:
      yield path, value


def _torch_name(path: str) -> str:
  parts = path.split("/")
  if parts[-1] in ("kernel", "embedding", "scale"):
    parts[-1] = "weight"
  return ".".join(parts)


def from_jax_params(tree: Dict[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
  """Map a JAX parameter tree (GPT, BERT, ResNet, or a ResNet's
  ``batch_stats``) — nested dicts of numpy arrays, with any
  ``nn.Partitioned`` boxes already unboxed — to the port's state dict on
  ``device`` (default ``"cuda"``).  ``dtype`` recasts every leaf
  (default: keep each array's own)."""
  dev = resolve_device(device)
  out = {}
  for path, value in _flatten(tree):
    arr = np.asarray(value)
    if path.split("/")[-1] == "kernel":
      arr = (np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4
             else np.swapaxes(arr, -1, -2))
    if arr.dtype.name == "bfloat16":
      # ml_dtypes' bf16 (the JAX package's) as its bits: torch reads no
      # ml_dtypes array.
      t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()
                           ).view(torch.bfloat16)
    else:
      t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    out[_torch_name(path)] = t.to(device=dev, dtype=dtype or t.dtype)
  return out


def _lecun_normal(rng: np.random.Generator, fan_in: int, shape):
  """flax ``lecun_normal``: variance_scaling(1, fan_in, truncated_normal)
  — a normal truncated to two standard deviations, rescaled so the
  variance is ``1 / fan_in``."""
  stddev = np.sqrt(1.0 / fan_in) / 0.87962566103423978
  x = rng.standard_normal(shape, dtype=np.float32)
  flat = x.reshape(-1)
  # Redraw the draws outside two deviations, in index order, until none
  # is: only the redrawn entries are looked at again.
  bad = np.flatnonzero(np.abs(flat) > 2.0)
  while bad.size:
    draw = rng.standard_normal(bad.size, dtype=np.float32)
    flat[bad] = draw
    bad = bad[np.abs(draw) > 2.0]
  x *= np.float32(stddev)
  return x


def init_params(cfg, seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
  """Fresh weights of a GPT, BERT or ResNet config drawn with numpy from
  ``seed``, in the JAX package's initialiser families: ``lecun_normal``
  for Dense kernels, Conv kernels (fan-in ``kh * kw * in``, flax's
  receptive field) and the expert weights (flax counts an expert
  weight's leading ``E`` as receptive field: fan-in ``E * D`` for
  ``wi``, ``E * F`` for ``wo``), ``normal(0.02)`` for the token,
  position and segment embeddings and the MoE router, zeros for biases,
  ones for norm scales.  (The JAX package draws from its own PRNG, so
  the values differ from ``model.init``; the CPU tests bridge the JAX
  package's own initialised tree with :func:`from_jax_params`.)
  Parameters are in ``cfg.param_dtype`` on ``device`` (default
  ``"cuda"``).  A ResNet's batch statistics come from
  :func:`init_model_state`."""
  dev = resolve_device(device)
  rng = np.random.default_rng(seed)
  model = _meta_model(cfg)
  shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
  for name, shape in shapes.items():
    # The whole experts, whatever expert axis the ambient mesh has.
    if _is_expert(name):
      E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
      shapes[name] = shape[:-3] + ((E, D, F) if name.endswith("wi")
                                   else (E, F, D))
  out = {}
  for name, shape in shapes.items():
    leaf_owner = name.split(".")[-2] if "." in name else ""
    if name in ("wte.weight", "wpe", "wse.weight") \
        or name.endswith("moe.router_kernel"):
      arr = rng.standard_normal(shape, dtype=np.float32)
      arr *= np.float32(0.02)
    elif leaf_owner == "moe":   # wi / wo [(S,) E, in, out]
      arr = _lecun_normal(rng, shape[-3] * shape[-2], shape)
    elif is_norm(leaf_owner):
      arr = np.full(shape, 1.0 if name.endswith("weight") else 0.0,
                    np.float32)
    elif name.endswith("bias"):
      arr = np.zeros(shape, np.float32)
    elif len(shape) == 4:      # Conv weight [out, in, kh, kw]
      arr = _lecun_normal(rng, shape[1] * shape[2] * shape[3], shape)
    else:  # Dense weight [(S,) out, in]: fan_in is the input width.
      arr = _lecun_normal(rng, shape[-1], shape)
    dtype = torch.float32 if name.endswith("router_kernel") \
        else cfg.param_dtype
    out[name] = torch.from_numpy(arr).to(device=dev, dtype=dtype)
  return out


def _meta_model(cfg):
  """The model of ``cfg`` on the ``meta`` device (its parameter names
  and shapes)."""
  from easyparallellibrary_tpu_torch.models.bert import BertConfig
  from easyparallellibrary_tpu_torch.models.resnet import ResNet, ResNetConfig
  if isinstance(cfg, ResNetConfig):
    return ResNet(cfg, device="meta")
  if isinstance(cfg, BertConfig):
    from easyparallellibrary_tpu_torch.models.bert import Bert
    return Bert(cfg, device="meta")
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  return GPT(cfg, device="meta")


def init_model_state(cfg, device=None) -> Dict[str, torch.Tensor]:
  """A batch-norm ResNet's fresh running statistics (flax's: means 0,
  variances 1, fp32), named as the model's buffers; empty for a model
  without any."""
  dev = resolve_device(device)
  return {name: (torch.zeros if name.endswith("mean") else torch.ones)(
      tuple(b.shape), dtype=torch.float32, device=dev)
          for name, b in _meta_model(cfg).named_buffers()}


def cast_for_compute(params: Dict[str, torch.Tensor], compute_dtype
                     ) -> Dict[str, torch.Tensor]:
  """Cast every weight the model reads in the compute dtype (Dense
  kernels and biases, the embeddings) once, keeping the norm
  parameters in their fp32 storage (flax applies them in fp32).  Same
  numbers as the JAX package's cast on every call."""
  out = {}
  for name, p in params.items():
    owner = name.split(".")[-2] if "." in name else ""
    out[name] = p if is_norm(owner) else p.to(compute_dtype)
  return out


def _tp_layout(name: str, cfg):
  """How a GPT parameter is split over ``model``: ``("qkv", None)``,
  ``("rows" | "cols" | "inner", logical width)`` (the first, last or
  second-to-last dim) or None (replicated)."""
  parts = name.split(".")
  leaf, owner = parts[-1], (parts[-2] if len(parts) > 1 else "")
  if owner == "moe":
    return {"wi": ("cols", cfg.d_ff), "wo": ("inner", cfg.d_ff)}.get(leaf)
  if owner == "qkv":
    return ("qkv", None)
  if owner == "proj" and leaf == "weight":
    return ("cols", cfg.d_model)
  if owner == "wi":
    return ("rows", cfg.d_ff)
  if owner == "wo" and leaf == "weight":
    return ("cols", cfg.d_ff)
  if owner in ("wte", "lm_head"):
    return ("rows", cfg.vocab_size)
  return None


def _block(t: torch.Tensor, dim: int, logical: int, tp: int, rank: int):
  from easyparallellibrary_tpu_torch.ops.layers import _padded_init, _round_up
  padded = list(t.shape)
  padded[dim] = _round_up(logical, tp)
  t = _padded_init(t.narrow(dim, 0, min(t.shape[dim], padded[dim])), padded)
  size = padded[dim] // tp
  return t.narrow(dim, rank * size, size).contiguous()


def _split_dim(kind: str, lead: int, t: torch.Tensor) -> int:
  return {"rows": lead, "cols": t.dim() - 1, "inner": t.dim() - 2}[kind]


def _is_expert(name: str) -> bool:
  return name.endswith(("moe.wi", "moe.wo"))


def _stacked(name: str) -> bool:
  """A pipelined model's stage-stacked leaf (leading ``[S]`` dim)."""
  return name.startswith("pipeline")


def shard_params(params: Dict[str, torch.Tensor], model, mesh=None,
                 rank: Optional[int] = None, tp: Optional[int] = None,
                 stage: Optional[int] = None,
                 stage_rank: Optional[int] = None,
                 expert: Optional[int] = None,
                 expert_rank: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
  """This rank's slice of a whole GPT or BERT state dict, in ``model``'s
  layout (its ``cfg`` and its vocab layout, ``model.wte.parallel``), or
  of a ResNet's, whose split head keeps this rank's block of the classes.

  Pipelined (``pipeline_stages > 1`` on a ``stage`` axis of ``stage``
  ranks): each stage-stacked leaf keeps this rank's row (``[1, ...]``),
  and where the model's table is stage-resident (``stage_vocab``, the
  ``smap`` engine's layout) the tied table or head keeps this rank's
  ``[V / n, D]`` vocab rows (``n`` over stage, and model inside it,
  stage-major).  ``tensor_parallel``: the logical (or the JAX package's
  padded) parameters in, each split as ``models.gpt`` lays its layers
  out — QKV by whole heads (q, k and v of the same ``H / tp`` heads),
  the column layers' rows and the row layers' columns zero-padded to an
  even tiling, the embedding and head by vocab rows; everything else
  replicated.  The experts of an MoE block (``wi``, ``wo``) keep this rank's
  ``E / ep`` of them over ``expert``, their ``F`` dim cut over
  ``model`` under ``tensor_parallel``.  ``tp`` / ``rank``, ``stage`` /
  ``stage_rank`` and ``expert`` / ``expert_rank`` default to the mesh's
  (the ambient mesh's) ``model``, ``stage`` and ``expert`` axes."""
  from easyparallellibrary_tpu_torch import constants
  from easyparallellibrary_tpu_torch.communicators import collectives
  cfg = model.cfg
  from easyparallellibrary_tpu_torch.models.resnet import ResNetConfig
  if isinstance(cfg, ResNetConfig):
    # Only a head built under a split scope is cut, by classes.
    tp = model.tp if tp is None else tp
    if rank is None:
      rank = collectives.axis_index(constants.MODEL_AXIS, mesh)
    out = dict(params)
    if tp > 1:
      for name in ("head.weight", "head.bias"):
        out[name] = _block(params[name], 0, cfg.num_classes, tp, rank)
    return out
  if tp is None:
    tp = (collectives.axis_size(constants.MODEL_AXIS, mesh)
          if cfg.tensor_parallel else 1)
  if rank is None:
    rank = collectives.axis_index(constants.MODEL_AXIS, mesh)
  pipelined = cfg.pipeline_stages > 1
  if stage is None:
    stage = collectives.axis_size(constants.STAGE_AXIS, mesh) \
        if pipelined else 1
  if stage_rank is None:
    stage_rank = collectives.axis_index(constants.STAGE_AXIS, mesh)
  if expert is None:
    expert = collectives.axis_size(constants.EXPERT_AXIS, mesh)
  if expert_rank is None:
    expert_rank = collectives.axis_index(constants.EXPERT_AXIS, mesh)
  stage_vocab = pipelined and model.wte.parallel == "stage_vocab"
  if tp <= 1 and stage <= 1 and expert <= 1 and not stage_vocab:
    return dict(params)
  if cfg.num_heads % tp:
    raise ValueError(f"num_heads {cfg.num_heads} does not divide the "
                     f"model axis ({tp})")
  H, hd, D = cfg.num_heads, cfg.d_model // cfg.num_heads, cfg.d_model
  out = {}
  for name, t in params.items():
    lead = 1 if _stacked(name) else 0
    if lead and stage > 1:
      t = t.narrow(0, stage_rank, 1)
    if expert > 1 and _is_expert(name):
      el = cfg.num_experts // expert
      t = t.narrow(lead, expert_rank * el, el)
    layout = _tp_layout(name, cfg)
    if stage_vocab and name.split(".")[0] in ("wte", "lm_head"):
      n = stage * tp
      if cfg.vocab_size % n:
        raise ValueError(f"vocab_size {cfg.vocab_size} must divide into "
                         f"{n} stage-resident shards")
      rows = cfg.vocab_size // n
      out[name] = t.narrow(0, (stage_rank * tp + rank) * rows,
                           rows).contiguous()
    elif layout is None or tp <= 1:
      out[name] = t.contiguous()
    elif layout[0] == "qkv":
      hl = H // tp
      # The weight's rows hold (3, H, hd); a bias (BERT's) has no D.
      tail = (D,) if name.endswith("weight") else ()
      w = t.reshape(t.shape[:lead] + (3, H, hd) + tail)
      w = w.narrow(lead + 1, rank * hl, hl)
      out[name] = w.reshape(t.shape[:lead] + (3 * hl * hd,) + tail
                            ).contiguous()
    else:
      kind, logical = layout
      out[name] = _block(t, _split_dim(kind, lead, t), logical, tp, rank)
  return out


def local_params(model, params: Dict[str, torch.Tensor], mesh=None
                 ) -> Dict[str, torch.Tensor]:
  """``params`` in ``model``'s own layout on this rank: as they are when
  their shapes are the model's (already sharded, or no tensor
  parallelism), else this rank's slice of the whole
  (:func:`shard_params`)."""
  own = {n: tuple(p.shape) for n, p in model.named_parameters()}
  if all(tuple(params[n].shape) == s for n, s in own.items()
         if n in params):
    return params
  return shard_params(params, model, mesh)


def unshard_params(shards, cfg) -> Dict[str, torch.Tensor]:
  """The inverse of :func:`shard_params`, padding cut.  ``shards``: the
  ranks' slices in model-axis order, or, for a pipelined model, one
  such list a stage (stage order).  The slices say their layout: the
  tied table or head is stage-resident (the ``smap`` layout) when the
  stages' slices of it together hold ``vocab_size`` rows, not a whole
  table a stage."""
  if cfg.pipeline_stages <= 1 or isinstance(shards[0], dict):
    per_stage = [list(shards)]
  else:
    per_stage = [list(s) for s in shards]
  stage_vocab = len(per_stage) > 1 and sum(
      p["wte.weight"].shape[0] for s in per_stage for p in s
  ) == cfg.vocab_size
  tp = len(per_stage[0])
  H, hd, D = cfg.num_heads, cfg.d_model // cfg.num_heads, cfg.d_model
  out = {}
  for name in per_stage[0][0]:
    lead = 1 if _stacked(name) else 0
    if stage_vocab and name.split(".")[0] in ("wte", "lm_head"):
      out[name] = torch.cat([p[name] for s in per_stage for p in s], dim=0)
      continue
    layout = _tp_layout(name, cfg) if tp > 1 else None
    rows = []
    for parts in ([p[name] for p in s] for s in per_stage):
      if layout is None:
        rows.append(parts[0])
      elif layout[0] == "qkv":
        hl = H // tp
        tail = (D,) if name.endswith("weight") else ()
        w = torch.cat([p.reshape(p.shape[:lead] + (3, hl, hd) + tail)
                       for p in parts], dim=lead + 1)
        rows.append(w.reshape(w.shape[:lead] + (3 * D,) + tail))
      else:
        kind, logical = layout
        dim = _split_dim(kind, lead, parts[0])
        rows.append(torch.cat(parts, dim=dim).narrow(dim, 0, logical))
    out[name] = torch.cat(rows, dim=0) if lead else rows[0]
  return out


def gather_experts(shards) -> Dict[str, torch.Tensor]:
  """The inverse of the expert cut of :func:`shard_params`: ``shards``
  the slices of the ranks of one expert group, in expert-axis order;
  the expert weights concatenated over their ``E`` dim (after a
  pipelined model's stage dim), the rest as rank 0 holds them."""
  out = {}
  for name, t in shards[0].items():
    if _is_expert(name):
      out[name] = torch.cat([s[name] for s in shards],
                            dim=1 if _stacked(name) else 0)
    else:
      out[name] = t
  return out


def stack_stages(params: Dict[str, torch.Tensor], cfg
                 ) -> Dict[str, torch.Tensor]:
  """A non-pipelined state dict (``block_i.*``) in the pipelined layout
  of ``cfg`` (``pipeline[_k].stages.stacked.block_j.*``, ``[S, ...]``):
  chunk ``k * S + s`` is row ``s`` of pass ``k``, holding its blocks in
  layer order (``models.gpt.stage_layout``); a masked slot's row is
  zeros."""
  from easyparallellibrary_tpu_torch.models.gpt import _pass_name, stage_layout
  S, K = cfg.pipeline_stages, max(1, cfg.pipeline_interleave)
  per_chunk, n_active = stage_layout(cfg.num_layers, S * K,
                                     getattr(cfg, "stage_plan", None))
  counts = n_active or (per_chunk,) * (S * K)
  starts = np.cumsum((0,) + tuple(counts))
  out = {n: t for n, t in params.items() if not n.startswith("block_")}
  for k in range(K):
    for j in range(per_chunk):
      # Slot j's leaves, as the first chunk holding a block there has
      # them (an MoE pattern must repeat in every chunk).
      first = next(c for c in range(S * K) if j < counts[c])
      subs = sorted(n.split(".", 1)[1] for n in params
                    if n.startswith(f"block_{starts[first] + j}."))
      for sub in subs:
        rows = []
        for s in range(S):
          c = k * S + s
          like = params[f"block_{starts[first] + j}.{sub}"]
          rows.append(params[f"block_{starts[c] + j}.{sub}"]
                      if j < counts[c] else torch.zeros_like(like))
        out[f"{_pass_name(k, K)}.stages.stacked.block_{j}.{sub}"] = \
            torch.stack(rows)
  return out


def unstack_stages(params: Dict[str, torch.Tensor], cfg
                   ) -> Dict[str, torch.Tensor]:
  """The inverse of :func:`stack_stages` (masked slots dropped): a
  pipelined checkpoint in a non-pipelined model's layout."""
  from easyparallellibrary_tpu_torch.models.gpt import _pass_name, stage_layout
  S, K = cfg.pipeline_stages, max(1, cfg.pipeline_interleave)
  per_chunk, n_active = stage_layout(cfg.num_layers, S * K,
                                     getattr(cfg, "stage_plan", None))
  counts = n_active or (per_chunk,) * (S * K)
  starts = np.cumsum((0,) + tuple(counts))
  out = {n: t for n, t in params.items() if not _stacked(n)}
  for k in range(K):
    prefix = f"{_pass_name(k, K)}.stages.stacked.block_"
    for name, t in params.items():
      if not name.startswith(prefix):
        continue
      j, sub = name[len(prefix):].split(".", 1)
      for s in range(S):
        c = k * S + s
        if int(j) < counts[c]:
          out[f"block_{starts[c] + int(j)}.{sub}"] = t[s]
  return out
