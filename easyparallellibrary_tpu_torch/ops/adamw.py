"""AdamW with weight-decay exclusion by name pattern (port of
``easyparallellibrary_tpu/ops/adamw.py``).

The JAX package builds optax transformations; here :func:`adamw`
returns a recipe whose ``init(params)`` builds a ``torch.optim.AdamW``
over a named parameter dict, the counterpart of ``tx.init(params)``.
The decay mask becomes two parameter groups.  optax's ``adamw`` and
torch's apply the same decoupled update — ``p -= lr * (m_hat /
(sqrt(v_hat) + eps) + weight_decay * p)``, eps outside the square root,
the same bias corrections — which ``tests/test_torch_train.py`` pins
against optax over a training trajectory.

:func:`inject_hyperparams` is ``optax.inject_hyperparams``'s
counterpart: the optimizer it builds is the same, marked so the saver
writes its hyperparameters (the learning rate a rollback backed off
among them) at the JAX ``InjectHyperparamsState`` leaf paths and reads
them back on restore.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch

# Port parameter names -> the JAX tree's leaf names (weights.py maps the
# other way): the exclusion patterns are written against the JAX paths.
_LAYER_NORMS = ("ln1", "ln2", "ln_f", "ln_emb", "proj_norm")
_EMBEDDINGS = ("wte", "wse")


def is_norm(owner: str) -> bool:
  """True for a norm layer's name: the transformers' LayerNorms and
  ResNet's ``GroupNorm_i`` / ``BatchNorm_i`` / ``proj_norm`` (their
  weight is flax's ``scale``)."""
  return owner in _LAYER_NORMS or owner.startswith(("GroupNorm_",
                                                     "BatchNorm_"))


def jax_path(name: str) -> str:
  """``block_0.ln1.weight`` -> ``block_0/ln1/scale``; Dense and Conv
  weights are ``kernel``, the token and segment tables ``embedding``."""
  parts = name.split(".")
  if parts[-1] == "weight":
    owner = parts[-2] if len(parts) > 1 else ""
    parts[-1] = ("scale" if is_norm(owner)
                 else "embedding" if owner in _EMBEDDINGS else "kernel")
  return "/".join(parts)


class Recipe(NamedTuple):
  """What :func:`adamw` returns, as optax's ``GradientTransformation``:
  ``init(params, fused=None)`` builds the optimizer over a named
  parameter dict (``fused=True``: torch's fused AdamW, whose
  ``found_inf`` input skips a step on the device)."""
  init: Callable[..., torch.optim.Optimizer]


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4,
          mask: Optional[Callable[[str], bool]] = None) -> Recipe:
  """``optax.adamw``'s signature and defaults.  ``mask(name) -> bool``
  selects the parameters that decay (all when None)."""

  def init(params: Dict[str, torch.Tensor],
           fused: Optional[bool] = None) -> torch.optim.AdamW:
    decays = {n: mask is None or mask(n) for n in params}
    groups = [{"params": [p for n, p in params.items() if decays[n]],
               "weight_decay": weight_decay}]
    keep = [p for n, p in params.items() if not decays[n]]
    if keep:
      groups.append({"params": keep, "weight_decay": 0.0})
    return torch.optim.AdamW(groups, lr=learning_rate, betas=(b1, b2),
                             eps=eps, fused=fused)

  return Recipe(init)


def inject_hyperparams(make: Callable[..., Recipe]) -> Callable[..., Recipe]:
  """``inject_hyperparams(adamw)(learning_rate=..., ...)``: the recipe
  ``make`` builds, its optimizer marked ``inject_hyperparams = True``.
  ``runtime.saver.state_tree`` then lays the state out as optax's
  ``inject_hyperparams(optax.adamw)`` does — ``opt_state/count``,
  ``opt_state/hyperparams/{b1, b2, eps, eps_root, learning_rate,
  weight_decay}``, the moments under ``opt_state/inner_state/0`` — and
  a restore sets every group's rate from the checkpoint, so a run
  restarted after a rollback resumes at the backed-off rate.  Without
  it the layout is optax's plain ``adamw`` state."""

  @functools.wraps(make)
  def build(*args, **kwargs) -> Recipe:
    inner = make(*args, **kwargs)

    def init(params: Dict[str, torch.Tensor],
             fused: Optional[bool] = None) -> torch.optim.Optimizer:
      opt = inner.init(params, fused=fused)
      opt.inject_hyperparams = True
      return opt

    return Recipe(init)

  return build


def adam_weight_decay_optimizer(
    learning_rate: float,
    weight_decay_rate: float = 0.01,
    beta_1: float = 0.9,
    beta_2: float = 0.999,
    epsilon: float = 1e-6,
    exclude_from_weight_decay: Optional[Sequence[str]] = (
        "layer_norm", "LayerNorm", "layernorm", "bias", "scale"),
) -> Recipe:
  """AdamW where parameters whose JAX path matches an
  ``exclude_from_weight_decay`` regex skip decay (LayerNorm, biases)."""
  patterns = [re.compile(p) for p in (exclude_from_weight_decay or [])]

  def decays(name: str) -> bool:
    path = jax_path(name)
    return not any(p.search(path) for p in patterns)

  return adamw(learning_rate, beta_1, beta_2, epsilon, weight_decay_rate,
               mask=decays)
