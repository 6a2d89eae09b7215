"""GPT weights for the port: the bridge from the JAX parameter tree, and a
seeded initialiser.

The port's GPT (``models/gpt.py``) names its parameters after the flax
tree, so ``block_3/mlp/wi/kernel`` becomes ``block_3.mlp.wi.weight``:

* Dense ``kernel [in, out]`` -> ``weight [out, in]`` (transposed; a
  pipelined model's stacked ``[S, in, out]`` -> ``[S, out, in]``),
  ``bias`` -> ``bias``;
* Embedding ``embedding`` -> ``weight``; ``wpe`` -> ``wpe``;
* LayerNorm ``scale`` -> ``weight``, ``bias`` -> ``bias`` (only
  LayerNorms have a ``scale``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch.utils.device import resolve_device

_LAYER_NORMS = ("ln1", "ln2", "ln_f")


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
  """Map a JAX GPT parameter tree — nested dicts of numpy arrays, with
  any ``nn.Partitioned`` boxes already unboxed — to the port's state
  dict on ``device`` (default ``"cuda"``).  ``dtype`` recasts every leaf
  (default: keep each array's own)."""
  dev = resolve_device(device)
  out = {}
  for path, value in _flatten(tree):
    arr = np.asarray(value)
    if path.split("/")[-1] == "kernel":
      arr = np.swapaxes(arr, -1, -2)
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
  """Fresh GPT weights drawn with numpy from ``seed``, in the JAX
  package's initialiser families: ``lecun_normal`` for Dense kernels,
  ``normal(0.02)`` for the token and position embeddings, zeros for
  biases, ones for LayerNorm scales.  (The JAX package draws from its
  own PRNG, so the values differ from ``GPT.init``; the CPU tests bridge
  the JAX package's own initialised tree with :func:`from_jax_params`.)
  Parameters are in ``cfg.param_dtype`` on ``device`` (default
  ``"cuda"``)."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  dev = resolve_device(device)
  rng = np.random.default_rng(seed)
  shapes = {name: tuple(p.shape) for name, p in
            GPT(cfg, device="meta").named_parameters()}
  out = {}
  for name, shape in shapes.items():
    leaf_owner = name.split(".")[-2] if "." in name else ""
    if name in ("wte.weight", "wpe"):
      arr = rng.standard_normal(shape, dtype=np.float32)
      arr *= np.float32(0.02)
    elif leaf_owner in _LAYER_NORMS:
      arr = np.full(shape, 1.0 if name.endswith("weight") else 0.0,
                    np.float32)
    elif name.endswith("bias"):
      arr = np.zeros(shape, np.float32)
    else:  # Dense weight [(S,) out, in]: fan_in is the input width.
      arr = _lecun_normal(rng, shape[-1], shape)
    out[name] = torch.from_numpy(arr).to(device=dev, dtype=cfg.param_dtype)
  return out


def cast_for_compute(params: Dict[str, torch.Tensor], compute_dtype
                     ) -> Dict[str, torch.Tensor]:
  """Cast every weight the model reads in the compute dtype (Dense
  kernels and biases, the embeddings) once, keeping the LayerNorm
  parameters in their fp32 storage (flax applies them in fp32).  Same
  numbers as the JAX package's cast on every call."""
  out = {}
  for name, p in params.items():
    owner = name.split(".")[-2] if "." in name else ""
    out[name] = p if owner in _LAYER_NORMS else p.to(compute_dtype)
  return out


def _tp_layout(name: str, cfg):
  """How a GPT parameter is split over ``model``: ``("qkv", None)``,
  ``("rows" | "cols", logical width)`` or None (replicated)."""
  parts = name.split(".")
  leaf, owner = parts[-1], (parts[-2] if len(parts) > 1 else "")
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


def _stacked(name: str) -> bool:
  """A pipelined model's stage-stacked leaf (leading ``[S]`` dim)."""
  return name.startswith("pipeline")


def shard_params(params: Dict[str, torch.Tensor], model, mesh=None,
                 rank: Optional[int] = None, tp: Optional[int] = None,
                 stage: Optional[int] = None,
                 stage_rank: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
  """This rank's slice of a whole GPT state dict, in ``model``'s layout
  (its ``cfg`` and its vocab layout, ``model.wte.parallel``).

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
  replicated.  ``tp`` / ``rank`` and ``stage`` / ``stage_rank`` default
  to the mesh's (the ambient mesh's) ``model`` and ``stage`` axes."""
  from easyparallellibrary_tpu_torch import constants
  from easyparallellibrary_tpu_torch.communicators import collectives
  cfg = model.cfg
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
  stage_vocab = pipelined and model.wte.parallel == "stage_vocab"
  if tp <= 1 and stage <= 1 and not stage_vocab:
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
      out[name] = t.contiguous() if lead else t
    elif layout[0] == "qkv":
      hl = H // tp
      w = t.reshape(t.shape[:lead] + (3, H, hd, D))
      w = w.narrow(lead + 1, rank * hl, hl)
      out[name] = w.reshape(t.shape[:lead] + (3 * hl * hd, D)).contiguous()
    else:
      kind, logical = layout
      out[name] = _block(t, lead if kind == "rows" else t.dim() - 1,
                         logical, tp, rank)
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
        w = torch.cat([p.reshape(p.shape[:lead] + (3, hl, hd, D))
                       for p in parts], dim=lead + 1)
        rows.append(w.reshape(w.shape[:lead] + (3 * D, D)))
      else:
        kind, logical = layout
        dim = lead if kind == "rows" else parts[0].dim() - 1
        rows.append(torch.cat(parts, dim=dim).narrow(dim, 0, logical))
    out[name] = torch.cat(rows, dim=0) if lead else rows[0]
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
  per_chunk, n_active = stage_layout(cfg.num_layers, S * K, cfg.stage_plan)
  counts = n_active or (per_chunk,) * (S * K)
  starts = np.cumsum((0,) + tuple(counts))
  out = {n: t for n, t in params.items() if not n.startswith("block_")}
  subs = sorted({n.split(".", 1)[1] for n in params
                 if n.startswith("block_0.")})
  for k in range(K):
    for j in range(per_chunk):
      for sub in subs:
        rows = []
        for s in range(S):
          c = k * S + s
          like = params[f"block_0.{sub}"]
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
  per_chunk, n_active = stage_layout(cfg.num_layers, S * K, cfg.stage_plan)
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
