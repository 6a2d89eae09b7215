"""Gradient checkpointing (port of
``easyparallellibrary_tpu/runtime/gc.py``).

The JAX package wraps a function in ``jax.checkpoint`` with a remat
policy; here the function runs under ``torch.utils.checkpoint`` with a
selective-checkpoint context (the one ``models/gpt.py`` uses for its
blocks).  The reference's two selection modes map as:

* ``collection`` — the user tags tensors with :func:`mark_checkpoint`
  (an identity custom op carrying the tag's name) and the policy saves
  exactly the tagged values;
* ``auto`` — save every matrix product's output and recompute the
  elementwise work (``jax.checkpoint_policies.checkpoint_dots``).

:func:`auto_checkpoint_segments` is the memory-balanced segmentation of
the reference's auto search.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.env import Env

EPL_CHECKPOINT_TAG = "epl_checkpoint"


@torch.library.custom_op("epl_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
  return x.clone()


@_checkpoint_name.register_fake
def _(x, name):
  return torch.empty_like(x)


def _checkpoint_name_backward(ctx, grad):
  return grad, None


_checkpoint_name.register_autograd(_checkpoint_name_backward)
CHECKPOINT_NAME_OP = torch.ops.epl_torch.checkpoint_name.default


def mark_checkpoint(x: torch.Tensor, name: str = EPL_CHECKPOINT_TAG
                    ) -> torch.Tensor:
  """Tag ``x`` as a remat checkpoint named ``name`` (the value is
  unchanged; under :func:`collection_policy` the tagged value is saved
  for the backward instead of recomputed)."""
  return _checkpoint_name(x, name)


def _policy(save: Callable) -> Callable:
  def policy(ctx, op, *args, **kwargs):
    del ctx, kwargs
    return (CheckpointPolicy.MUST_SAVE if save(op, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)
  return functools.partial(create_selective_checkpoint_contexts, policy)


def collection_policy(names: Sequence[str] = (EPL_CHECKPOINT_TAG,)):
  """The ``context_fn`` that saves only the tensors tagged with one of
  ``names``."""
  names = frozenset(names)
  return _policy(lambda op, args: op == CHECKPOINT_NAME_OP
                 and args[1] in names)


def policy_for(gc_type: str, policy_name: str = ""):
  """The ``context_fn`` of ``gradient_checkpoint.type``: ``collection``
  saves the tagged tensors, ``auto`` every matrix product; None for no
  policy (the checkpoint then saves only its inputs)."""
  del policy_name
  if gc_type == constants.GC_COLLECTION:
    return collection_policy()
  if gc_type == constants.GC_AUTO:
    from easyparallellibrary_tpu_torch.models.gpt import _remat_context
    return _remat_context("dots")
  return None


def auto_checkpoint_segments(block_costs: Sequence[float],
                             num_segments: int = 0):
  """Memory-balanced checkpoint segmentation: the block indices that
  start each of ``num_segments`` segments (default ~sqrt(n)) balanced by
  ``block_costs``."""
  from easyparallellibrary_tpu_torch.parallel.partitioner import (
      partition_balance)
  n = len(block_costs)
  if n == 0:
    return []
  if num_segments <= 0:
    num_segments = max(1, int(np.sqrt(n)))
  num_segments = min(num_segments, n)
  ranges = partition_balance([float(c) for c in block_costs], num_segments)
  return [s for s, _ in ranges]


def gradients(fn: Callable, gc_type: Optional[str] = None,
              has_aux: bool = False):
  """``jax.grad`` with rematerialization per the active config: returns
  ``grad_fn(params, *args)`` giving the gradients of ``fn(params,
  *args)`` (a scalar, or ``(scalar, aux)`` with ``has_aux``) with
  respect to the ``params`` dict — ``(grads, aux)`` with ``has_aux`` —
  with ``fn`` run under ``torch.utils.checkpoint`` when ``gc_type`` (or
  ``gradient_checkpoint.type``) is set.  ``gradient_checkpoint.
  check_gradients`` also takes the plain gradients and checks their
  shapes and dtypes."""
  cfg = Env.get().config
  gc_type = gc_type if gc_type is not None else cfg.gradient_checkpoint.type

  def make(remat: bool):
    def grad_fn(params, *args, **kw):
      names = list(params)
      leaves = [params[n] if params[n].requires_grad
                else params[n].detach().requires_grad_(True) for n in names]

      def run(*xs):
        return fn(dict(zip(names, xs)), *args, **kw)

      if remat:
        context = policy_for(gc_type)
        extra = {} if context is None else {"context_fn": context}
        out = checkpoint(run, *leaves, use_reentrant=False, **extra)
      else:
        out = run(*leaves)
      value, aux = out if has_aux else (out, None)
      grads = torch.autograd.grad(value, leaves, allow_unused=True)
      g = {n: torch.zeros_like(x) if d is None else d
           for n, x, d in zip(names, leaves, grads)}
      return (g, aux) if has_aux else g
    return grad_fn

  grad_fn = make(bool(gc_type))
  if cfg.gradient_checkpoint.check_gradients:
    return _checked(grad_fn, make(False), has_aux)
  return grad_fn


def _checked(grad_fn, base_grad_fn, has_aux):
  """Check the remat gradients' structure against the plain ones."""

  def wrapped(*args, **kw):
    g = grad_fn(*args, **kw)
    b = base_grad_fn(*args, **kw)
    gl, bl = (g[0], b[0]) if has_aux else (g, b)
    assert gl.keys() == bl.keys(), "GC grads structure mismatch"
    for name in gl:
      a, c = gl[name], bl[name]
      assert a.shape == c.shape and a.dtype == c.dtype, (
          f"GC grad mismatch: {a.shape}/{a.dtype} vs {c.shape}/{c.dtype}")
    return g

  return wrapped
