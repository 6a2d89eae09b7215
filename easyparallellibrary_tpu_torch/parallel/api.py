"""The train step (port of ``easyparallellibrary_tpu/parallel/api.py``).

The JAX version derives a sharding for every leaf of the train state,
shards the batch over the ``data`` axis and compiles one ``jit`` program
over the mesh, GSPMD inserting the collectives.  The port is explicit
SPMD (``cluster.py``): each rank holds its shard of every parameter (the
tensor-parallel layers' slices, replicated otherwise), runs eagerly on
its rows of the global batch, and the step writes out the gradient
all-reduce over the data group that GSPMD inserted; the
tensor-parallel layers carry their own collectives.  "Donation" means
the state is updated in place — ``loss.backward()`` fills each
parameter's ``.grad`` and ``optimizer.step()`` writes the new
parameters and moments over the old ones.  ``state_shardings`` records
each parameter's spec as bookkeeping (``utils/sharding.py``); ZeRO
(``zero.level``) shards the optimizer over the data axis
(``runtime/zero.py``).

    state, shardings = create_sharded_train_state(init_fn, mesh, seed)
    step = parallelize(make_train_step(loss_fn), mesh, shardings)
    state, metrics = step(state, batch, rng)    # metrics["loss"] on device
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives, fusion
from easyparallellibrary_tpu_torch.env import Env


class TrainState:
  """The model (``apply_fn``, run with ``torch.func.functional_call``),
  its fp32 parameters as a dict of leaf tensors, the optimizer over them
  (``opt_state``) and the step count, as flax's ``TrainState``.

  ``step`` is a host ``int``, or a 0-d device tensor once a guarded step
  (the anomaly sentinel, a loss scale: ``runtime/trainer.py``) advanced
  it only on finite steps without reading the verdict back.  ``sentinel``
  (``runtime.resilience.SentinelState``) and ``loss_scale``
  (``runtime.amp.DynamicLossScale``) are None unless the state carries
  them."""

  def __init__(self, *, step, apply_fn, params: Dict[str, torch.Tensor],
               tx, opt_state: torch.optim.Optimizer, sentinel=None,
               loss_scale=None, zero=None):
    self.zero = zero   # runtime.zero.ZeroLayout of a ZeRO state
    self.step = step
    self.apply_fn = apply_fn
    self.params = params
    self.tx = tx
    self.opt_state = opt_state
    self.sentinel = sentinel
    self.loss_scale = loss_scale

  @classmethod
  def create(cls, *, apply_fn, params: Dict[str, torch.Tensor], tx,
             fused: Optional[bool] = None, **extra) -> "TrainState":
    """Own copies of ``params`` as leaves that take gradients (the
    caller's tensors are never updated), and ``tx.init`` over them
    (``fused=True`` builds torch's fused AdamW, which a guarded step
    needs).  ``extra`` sets ``sentinel`` / ``loss_scale``."""
    own = {name: p.detach().clone().requires_grad_(True)
           for name, p in params.items()}
    opt = tx.init(own) if fused is None else tx.init(own, fused=fused)
    return cls(step=0, apply_fn=apply_fn, params=own, tx=tx, opt_state=opt,
               **extra)

  def replace(self, **fields) -> "TrainState":
    """A shallow copy with ``fields`` replaced (flax's ``replace``); the
    tensors are shared, not copied."""
    new = copy.copy(self)
    for key, value in fields.items():
      if not hasattr(new, key):
        raise AttributeError(f"TrainState has no field {key!r}")
      setattr(new, key, value)
    return new

  def apply_gradients(self) -> "TrainState":
    """One optimizer step from the parameters' ``.grad``, in place."""
    self.opt_state.step()
    self.step = self.step + 1   # a new value: never an in-place tensor add
    return self


def param_specs(model) -> Dict[str, tuple]:
  """Each parameter's spec from the layers of ``model`` (an
  ``nn.Module``): ``model`` on the split dim of the tensor-parallel
  layers (column rows, row columns, vocab rows), the vocab axes on the
  rows of a stage-resident table or head, ``stage`` on the leading dim
  of a pipelined model's stacked leaves on a stage mesh, ``()``
  (replicated) otherwise."""
  from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding
  specs: Dict[str, tuple] = {}
  if not isinstance(model, torch.nn.Module):
    return specs
  m = constants.MODEL_AXIS
  for prefix, mod in model.named_modules():
    name = f"{prefix}." if prefix else ""
    stage_vocab = getattr(mod, "parallel", "") in ("stage_column",
                                                   "stage_vocab")
    if stage_vocab:
      specs[name + "weight"] = (tuple(mod.vocab_axes), None)
    elif isinstance(mod, Dense) and mod.tp > 1:
      if mod.parallel == "column":
        specs[name + "weight"] = (m, None)
        if mod.bias is not None:
          specs[name + "bias"] = (m,)
      else:
        specs[name + "weight"] = (None, m)
    elif isinstance(mod, Embedding) and mod.tp > 1:
      specs[name + "weight"] = (m, None)
  if getattr(model, "stages", 1) > 1:
    # A pipelined model's stacked leaves: the stage row is this rank's.
    for name, p in model.named_parameters():
      if name.startswith("pipeline"):
        specs[name] = (constants.STAGE_AXIS,) + tuple(
            specs.get(name, (None,) * (p.dim() - 1)))
  return specs


def state_shardings(state, mesh) -> Dict[str, tuple]:
  """The spec of every parameter of ``state`` (``param_specs`` of its
  ``apply_fn``; replicated ``()`` otherwise)."""
  del mesh
  specs = param_specs(state.apply_fn)
  return {name: specs.get(name, ()) for name in state.params}


def create_sharded_train_state(init_fn: Callable[..., TrainState],
                               mesh, *init_args,
                               zero_level: Optional[str] = None,
                               offload: Optional[bool] = None,
                               ) -> Tuple[TrainState, Dict[str, Any]]:
  """``state = init_fn(*init_args)`` with every parameter (this rank's
  shard of it) on the mesh's device.  Returns ``(state, shardings)``,
  each parameter's spec (``state_shardings``).  ZeRO (``zero.level``,
  or ``zero_level``) rebuilds the optimizer over this rank's owner
  slices on a data axis above 1 (``runtime.zero.shard_opt_state``; its
  entries' specs land under ``opt_state/<name>``).  Host offload
  (``offload.level``, or ``offload=True``) puts the optimizer's moments
  in pinned host memory (``runtime.offload.offload_to_host``; a CPU
  state is left as it is)."""
  cfg = Env.get().config
  zero_level = cfg.zero.level if zero_level is None else zero_level
  offload = bool(cfg.offload.level) if offload is None else offload
  state = init_fn(*init_args)
  wrong = sorted(n for n, p in state.params.items()
                 if p.device != mesh.device)
  if wrong:
    raise ValueError(f"init_fn placed {wrong[:3]} (and {len(wrong)} in all) "
                     f"off the mesh's device {mesh.device}")
  shardings = state_shardings(state, mesh)
  if zero_level:
    from easyparallellibrary_tpu_torch.runtime import zero as zero_lib
    state, shardings = zero_lib.shard_opt_state(state, shardings, mesh,
                                                zero_level)
  if offload:
    from easyparallellibrary_tpu_torch.runtime.offload import offload_to_host
    state = offload_to_host(state)
  return state, shardings


def local_batch(batch, mesh, device=None):
  """This rank's rows of the global ``batch`` (leading dim split over
  the data axis), on the mesh's device."""
  dp = mesh.axis_size(constants.DATA_AXIS)
  idx = mesh.axis_index(constants.DATA_AXIS)
  device = device or mesh.device
  out = {}
  for k, v in batch.items():
    t = torch.as_tensor(v)
    if dp > 1:
      if t.shape[0] % dp:
        raise ValueError(f"batch leaf {k!r} has {t.shape[0]} rows, not "
                         f"divisible by the data axis ({dp})")
      rows = t.shape[0] // dp
      t = t[idx * rows:(idx + 1) * rows]
    out[k] = t.to(device, non_blocking=True)
  return out


def reduce_gradients(params: Dict[str, torch.Tensor], reduce_method: str,
                     mesh=None) -> None:
  """The gradient all-reduce over the data axis that GSPMD inserts:
  the mean of the ranks' gradients (``"sum"``: scaled by the data-
  parallel degree), bucketed (``communicators.fusion``), in place."""
  dp = collectives.axis_size(constants.DATA_AXIS, mesh)
  if dp <= 1:
    return
  grads = {n: p.grad for n, p in params.items() if p.grad is not None}
  summed = fusion.batch_all_reduce(grads, constants.DATA_AXIS)
  for n, g in summed.items():
    params[n].grad = g if reduce_method == "sum" else g / dp


def make_train_step(loss_fn: Callable, *,
                    reduce_method: Optional[str] = None) -> Callable:
  """The canonical train step from ``loss_fn(params, batch, rng) ->
  (loss, aux_metrics_dict)``: forward on this rank's rows, backward,
  the gradient mean over the data axis (``reduce_method="sum"`` scales
  it by the data-parallel degree, as the JAX step), one optimizer step.
  Returns ``(state, metrics)`` with ``metrics["loss"]`` a device tensor,
  the mean over the data axis (the step never waits for the device)."""
  method = reduce_method or \
      Env.get().config.communication.gradients_reduce_method

  def train_step(state: TrainState, batch, rng):
    from easyparallellibrary_tpu_torch.parallel.metrics import collect_merged
    for p in state.params.values():
      p.grad = None
    loss, aux = loss_fn(state.params, batch, rng)
    aux = {**(aux or {}), **collect_merged()}
    loss.backward()
    reduce_gradients(state.params, method)
    state.apply_gradients()
    loss = collectives.all_reduce(loss.detach(), constants.DATA_AXIS,
                                  op=collectives.MEAN)
    return state, {"loss": loss, **aux}

  return train_step


def parallelize(step_fn: Callable, mesh, state_sharding,
                batch_spec=None, donate_state: bool = True) -> Callable:
  """The ``(state, batch, rng) -> (state, metrics)`` step on this rank:
  ``batch`` is the global batch, of which the rank takes its rows of the
  data axis (``local_batch``; ``batch_spec`` is the JAX default, dim 0
  over ``data``) on the mesh's device, and the state is updated in place
  (the donation of the JAX version; ``donate_state=False`` is
  refused)."""
  del state_sharding, batch_spec
  if not donate_state:
    raise ValueError("the port updates the train state in place; "
                     "donate_state=False is not supported")

  @functools.wraps(step_fn)
  def wrapped(state, batch, rng):
    return step_fn(state, local_batch(batch, mesh), rng)

  wrapped.mesh = mesh
  return wrapped
