"""Mixed precision: the dtype policy and loss scaling (port of
``easyparallellibrary_tpu/runtime/amp.py``).

``amp.level = "O1"`` is the model's compute dtype and nothing more: the
GPT resolves its config through :func:`resolve_model_dtypes` at every
forward, so the config knob, not the model's constructor argument,
decides the dtype its layers compute in while the parameters stay in
``param_dtype``.

Loss scaling (the reference's ``loss_scale.py``) keeps the JAX
package's functional form: :class:`DynamicLossScale` is a small
dataclass of 0-d tensors whose :meth:`DynamicLossScale.update` returns
a new state, and :func:`scaled_value_and_grad` scales the loss before
``torch.autograd.grad`` and unscales the gradients after, leaving inf
and NaN in place for :func:`all_finite` to see.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from easyparallellibrary_tpu_torch import constants


def _map_floats(tree, fn):
  """``fn`` over every floating tensor of a nested dict / list / tuple
  tree; other leaves pass through."""
  if isinstance(tree, dict):
    return {k: _map_floats(v, fn) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map_floats(v, fn) for v in tree)
  if isinstance(tree, torch.Tensor) and tree.is_floating_point():
    return fn(tree)
  return tree


@dataclasses.dataclass(frozen=True)
class Policy:
  """Dtype policy (the role of the reference's O1 conversion lists)."""
  param_dtype: Any = torch.float32
  compute_dtype: Any = torch.bfloat16
  output_dtype: Any = torch.float32

  def _cast(self, tree, dtype):
    return _map_floats(tree, lambda x: x.to(dtype))

  def cast_to_compute(self, tree):
    return self._cast(tree, self.compute_dtype)

  def wrap_apply(self, fn: Callable) -> Callable:
    """O1 for an arbitrary ``fn(params, *inputs)``: float params and
    float inputs cast to the compute dtype around ``fn``, float outputs
    cast back to ``output_dtype``."""

    def wrapped(params, *args, **kw):
      out = fn(self.cast_to_compute(params),
               *self._cast(args, self.compute_dtype), **kw)
      return self._cast(out, self.output_dtype)

    return wrapped


_COMPUTE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def policy_from_config(config=None) -> Optional[Policy]:
  """The active dtype policy, or None when ``amp.level`` is off or O0."""
  from easyparallellibrary_tpu_torch.env import Env
  cfg = config if config is not None else Env.get().config
  if cfg.amp.level != constants.AMP_O1:
    return None
  return Policy(compute_dtype=_COMPUTE_DTYPES[cfg.amp.compute_dtype])


def resolve_model_dtypes(model_cfg, config=None):
  """Apply ``amp.level="O1"`` to a model's dataclass config: its
  ``dtype`` (compute) becomes the policy's compute dtype, its
  ``param_dtype`` stays."""
  policy = policy_from_config(config)
  if policy is None or not hasattr(model_cfg, "dtype"):
    return model_cfg
  return dataclasses.replace(model_cfg, dtype=policy.compute_dtype)


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
  """Dynamic loss-scale state: ``scale`` fp32 and ``counter`` int32, 0-d
  tensors on one device."""
  scale: torch.Tensor
  growth_interval: int = 2000
  growth_factor: float = 2.0
  backoff_factor: float = 0.5
  counter: torch.Tensor = dataclasses.field(
      default_factory=lambda: torch.zeros((), dtype=torch.int32))

  @classmethod
  def create(cls, initial_scale: float = 2.0 ** 15, device=None, **kw
             ) -> "DynamicLossScale":
    return cls(scale=torch.tensor(initial_scale, dtype=torch.float32,
                                  device=device),
               counter=torch.zeros((), dtype=torch.int32, device=device),
               **kw)

  def update(self, grads_finite) -> "DynamicLossScale":
    """Grow the scale after ``growth_interval`` finite steps in a row,
    back it off on a non-finite one, clip it to [1, 2^24]."""
    finite = torch.as_tensor(grads_finite, device=self.scale.device)
    grow = (self.counter + 1) >= self.growth_interval
    new_scale = torch.where(
        finite, torch.where(grow, self.scale * self.growth_factor,
                            self.scale),
        self.scale * self.backoff_factor)
    new_scale = torch.clamp(new_scale, 1.0, 2.0 ** 24)
    new_counter = torch.where(finite & ~grow, self.counter + 1,
                              torch.zeros_like(self.counter))
    return dataclasses.replace(self, scale=new_scale, counter=new_counter)


def fixed_loss_scale(value: float, device=None) -> DynamicLossScale:
  """A scale that never changes (reference fixed loss scale)."""
  return DynamicLossScale.create(value, device=device, growth_factor=1.0,
                                 backoff_factor=1.0,
                                 growth_interval=2 ** 30)


def all_finite(tree) -> torch.Tensor:
  """0-d bool tensor: every floating leaf of ``tree`` is finite.  Stays
  on the device (no host sync)."""
  from easyparallellibrary_tpu_torch.utils.pytree import (
      tree_paths_and_leaves)
  checks = [torch.isfinite(leaf).all()
            for _, leaf in tree_paths_and_leaves(tree)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
  if not checks:
    return torch.tensor(True)
  return torch.stack(checks).all()


def nonfinite_report(tree, max_entries: int = 8) -> "dict[str, int]":
  """``{path: nonfinite_count}`` for the offending leaves: the diagnostic
  that names which tensors went bad.  Reads every leaf back to the host;
  for post-mortem use, never the hot path."""
  from easyparallellibrary_tpu_torch.utils.pytree import (
      tree_paths_and_leaves)
  report = {}
  for path, leaf in tree_paths_and_leaves(tree):
    if not (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
      continue
    bad = int((~torch.isfinite(leaf.detach())).sum().item())
    if bad:
      report[path] = bad
      if len(report) >= max_entries:
        break
  return report


def scaled_value_and_grad(loss_fn: Callable, scale: torch.Tensor,
                          has_aux: bool = True) -> Callable:
  """``value_and_grad`` with loss scaling over ``torch.autograd``:
  ``wrapped(params, *args)`` returns ``((loss, aux), grads)``, the loss
  unscaled and ``grads`` a dict like ``params`` (a flat ``name ->
  tensor`` dict) of unscaled gradients, each in its parameter's dtype
  (non-finite values kept).  Gradients are taken with respect to
  ``params`` only; a parameter the loss does not reach gets zeros."""

  def wrapped(params, *args, **kw):
    names = list(params)
    leaves = [params[n] if params[n].requires_grad
              else params[n].detach().requires_grad_(True) for n in names]
    out = loss_fn(dict(zip(names, leaves)), *args, **kw)
    loss, aux = out if has_aux else (out, {})
    scaled = loss * scale.to(loss.dtype)
    grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
    inv = 1.0 / scale
    unscaled = {}
    for name, leaf, g in zip(names, leaves, grads):
      if g is None:
        g = torch.zeros_like(leaf)
      unscaled[name] = (g.float() * inv).to(g.dtype)
    return (scaled.detach() / scale.to(loss.dtype), aux), unscaled

  return wrapped
