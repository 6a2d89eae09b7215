"""GPT weights for the port: the bridge from the JAX parameter tree, and a
seeded initialiser.

The port's GPT (``models/gpt.py``) names its parameters after the flax
tree, so ``block_3/mlp/wi/kernel`` becomes ``block_3.mlp.wi.weight``:

* Dense ``kernel [in, out]`` -> ``weight [out, in]`` (transposed),
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
      arr = arr.T
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
  bad = np.abs(x) > 2.0
  while bad.any():
    x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
    bad = np.abs(x) > 2.0
  return x * np.float32(stddev)


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
      arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
    elif leaf_owner in _LAYER_NORMS:
      arr = np.full(shape, 1.0 if name.endswith("weight") else 0.0,
                    np.float32)
    elif name.endswith("bias"):
      arr = np.zeros(shape, np.float32)
    else:  # Dense weight [out, in]: fan_in is the input width.
      arr = _lecun_normal(rng, shape[1], shape)
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


def shard_params(params: Dict[str, torch.Tensor], cfg, mesh=None,
                 rank: Optional[int] = None, tp: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
  """This rank's slice of a whole GPT state dict for a
  ``tensor_parallel`` model: the logical (or the JAX package's padded)
  parameters in, each split as ``models.gpt`` lays its layers out —
  QKV by whole heads (q, k and v of the same ``H / tp`` heads), the
  column layers' rows and the row layers' columns zero-padded to an even
  tiling, the embedding and head by vocab rows; everything else
  replicated.  ``tp`` / ``rank`` default to the mesh's (the ambient
  mesh's) ``model`` axis.  A model without ``tensor_parallel`` takes
  the parameters as they are."""
  from easyparallellibrary_tpu_torch import constants
  from easyparallellibrary_tpu_torch.communicators import collectives
  if tp is None:
    tp = (collectives.axis_size(constants.MODEL_AXIS, mesh)
          if cfg.tensor_parallel else 1)
  if rank is None:
    rank = collectives.axis_index(constants.MODEL_AXIS, mesh)
  if tp <= 1:
    return dict(params)
  if cfg.num_heads % tp:
    raise ValueError(f"num_heads {cfg.num_heads} does not divide the "
                     f"model axis ({tp})")
  H, hd, D = cfg.num_heads, cfg.d_model // cfg.num_heads, cfg.d_model
  out = {}
  for name, t in params.items():
    layout = _tp_layout(name, cfg)
    if layout is None:
      out[name] = t
    elif layout[0] == "qkv":
      hl = H // tp
      w = t.reshape(3, H, hd, D)[:, rank * hl:(rank + 1) * hl]
      out[name] = w.reshape(3 * hl * hd, D).contiguous()
    else:
      kind, logical = layout
      out[name] = _block(t, 0 if kind == "rows" else t.dim() - 1, logical,
                         tp, rank)
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
  return shard_params(params, model.cfg, mesh)


def unshard_params(shards, cfg) -> Dict[str, torch.Tensor]:
  """The whole logical state dict from every rank's
  :func:`shard_params` slice (rank order): the inverse, padding cut."""
  tp = len(shards)
  H, hd, D = cfg.num_heads, cfg.d_model // cfg.num_heads, cfg.d_model
  out = {}
  for name in shards[0]:
    layout = _tp_layout(name, cfg) if tp > 1 else None
    parts = [s[name] for s in shards]
    if layout is None:
      out[name] = parts[0]
    elif layout[0] == "qkv":
      hl = H // tp
      w = torch.cat([p.reshape(3, hl, hd, D) for p in parts], dim=1)
      out[name] = w.reshape(3 * D, D)
    else:
      kind, logical = layout
      dim = 0 if kind == "rows" else parts[0].dim() - 1
      out[name] = torch.cat(parts, dim=dim).narrow(dim, 0, logical)
  return out
