"""The train step (port of ``easyparallellibrary_tpu/parallel/api.py``).

The JAX version derives a sharding for every leaf of the train state,
shards the batch over the ``data`` axis and compiles one ``jit`` program
over the mesh.  The port runs eagerly on the one device of its mesh
(``cluster.py``): the shardings are trivial, there is no compilation,
and "donation" means the state is updated in place — ``loss.backward()``
fills each parameter's ``.grad`` and ``optimizer.step()`` writes the new
parameters and moments over the old ones.

    state, shardings = create_sharded_train_state(init_fn, mesh, seed)
    step = parallelize(make_train_step(loss_fn), mesh, shardings)
    state, metrics = step(state, batch, rng)    # metrics["loss"] on device
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from easyparallellibrary_tpu_torch._not_ported import (
    RUNTIME, TENSOR_PARALLEL, not_ported)
from easyparallellibrary_tpu_torch.env import Env


class TrainState:
  """The model (``apply_fn``, run with ``torch.func.functional_call``),
  its fp32 parameters as a dict of leaf tensors, the optimizer over them
  (``opt_state``) and the step count, as flax's ``TrainState``."""

  def __init__(self, *, step: int, apply_fn, params: Dict[str, torch.Tensor],
               tx, opt_state: torch.optim.Optimizer):
    self.step = step
    self.apply_fn = apply_fn
    self.params = params
    self.tx = tx
    self.opt_state = opt_state

  @classmethod
  def create(cls, *, apply_fn, params: Dict[str, torch.Tensor], tx
             ) -> "TrainState":
    """Own copies of ``params`` as leaves that take gradients (the
    caller's tensors are never updated), and ``tx.init`` over them."""
    own = {name: p.detach().clone().requires_grad_(True)
           for name, p in params.items()}
    return cls(step=0, apply_fn=apply_fn, params=own, tx=tx,
               opt_state=tx.init(own))

  def apply_gradients(self) -> "TrainState":
    """One optimizer step from the parameters' ``.grad``, in place."""
    self.opt_state.step()
    self.step += 1
    return self


def create_sharded_train_state(init_fn: Callable[..., TrainState],
                               mesh, *init_args,
                               zero_level: Optional[str] = None,
                               offload: Optional[bool] = None,
                               ) -> Tuple[TrainState, Dict[str, Any]]:
  """``state = init_fn(*init_args)`` with every parameter on the mesh's
  device.  Returns ``(state, shardings)``; on one device each parameter
  is replicated (``()``).  ZeRO and host offload (``zero.level``,
  ``offload.level``, or the arguments) raise."""
  cfg = Env.get().config
  zero_level = cfg.zero.level if zero_level is None else zero_level
  offload = bool(cfg.offload.level) if offload is None else offload
  if zero_level:
    raise not_ported(f"ZeRO (zero.level={zero_level!r})", TENSOR_PARALLEL)
  if offload:
    raise not_ported("host offload (offload.level)", RUNTIME)
  state = init_fn(*init_args)
  wrong = sorted(n for n, p in state.params.items()
                 if p.device != mesh.device)
  if wrong:
    raise ValueError(f"init_fn placed {wrong[:3]} (and {len(wrong)} in all) "
                     f"off the mesh's device {mesh.device}")
  return state, {name: () for name in state.params}


def make_train_step(loss_fn: Callable, *,
                    reduce_method: Optional[str] = None) -> Callable:
  """The canonical train step from ``loss_fn(params, batch, rng) ->
  (loss, aux_metrics_dict)``: forward, ``loss.backward()``, one optimizer
  step.  Returns ``(state, metrics)`` with ``metrics["loss"]`` a device
  tensor (the step never waits for the device).  ``reduce_method``
  (``"sum"`` scales the gradients by the data-parallel degree) changes
  nothing at degree 1."""
  del reduce_method

  def train_step(state: TrainState, batch, rng):
    from easyparallellibrary_tpu_torch.parallel.metrics import collect_merged
    for p in state.params.values():
      p.grad = None
    loss, aux = loss_fn(state.params, batch, rng)
    aux = {**(aux or {}), **collect_merged()}
    loss.backward()
    state.apply_gradients()
    return state, {"loss": loss.detach(), **aux}

  return train_step


def parallelize(step_fn: Callable, mesh, state_sharding,
                batch_spec=None, donate_state: bool = True) -> Callable:
  """The ``(state, batch, rng) -> (state, metrics)`` step on the mesh's
  device: batch leaves are moved there, and the state is updated in
  place (the donation of the JAX version; ``donate_state=False`` is
  refused).  With one device the shardings and ``batch_spec`` are
  trivial."""
  del state_sharding, batch_spec
  if not donate_state:
    raise ValueError("the port updates the train state in place; "
                     "donate_state=False is not supported")
  device = mesh.device

  @functools.wraps(step_fn)
  def wrapped(state, batch, rng):
    batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
             for k, v in batch.items()}
    return step_fn(state, batch, rng)

  wrapped.mesh = mesh
  return wrapped
