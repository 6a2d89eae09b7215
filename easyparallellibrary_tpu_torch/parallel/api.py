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
from typing import (Any, Callable, Dict, Iterable, Optional, Sequence,
                    Tuple)

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


class MutableTrainState(TrainState):
  """A TrainState carrying non-trainable model state beside the
  parameters (JAX ``MutableTrainState``): ``model_state`` is a dict of
  tensors named as the model's buffers (batch norm's running statistics,
  ``stage0_block0.BatchNorm_0.mean``), replaced by every step of
  :func:`make_mutable_train_step`.  ``create`` keeps its own copies, as
  of the parameters."""

  def __init__(self, *, model_state: Optional[Dict[str, torch.Tensor]] = None,
               **fields):
    super().__init__(**fields)
    self.model_state = model_state

  @classmethod
  def create(cls, *, apply_fn, params: Dict[str, torch.Tensor], tx,
             model_state: Optional[Dict[str, torch.Tensor]] = None,
             fused: Optional[bool] = None, **extra) -> "MutableTrainState":
    own = None if model_state is None else {
        name: t.detach().clone() for name, t in model_state.items()}
    return super().create(apply_fn=apply_fn, params=params, tx=tx,
                          fused=fused, model_state=own, **extra)

  def apply_gradients(self, model_state=None) -> "MutableTrainState":
    """One optimizer step from the parameters' ``.grad`` and the new
    ``model_state`` (when given), in place."""
    super().apply_gradients()
    if model_state is not None:
      self.model_state = {k: v.detach() for k, v in model_state.items()}
    return self


def param_specs(model) -> Dict[str, tuple]:
  """Each parameter's spec from the layers of ``model`` (an
  ``nn.Module``): ``model`` on the split dim of the tensor-parallel
  layers (column rows, row columns, vocab rows), the vocab axes on the
  rows of a stage-resident table or head, ``expert`` (and ``model``) on
  the expert weights of an MoE layer, ``stage`` on the leading dim of a
  pipelined model's stacked leaves on a stage mesh, ``()`` (replicated)
  otherwise."""
  from easyparallellibrary_tpu_torch.models.moe import MoEMLP
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
    elif isinstance(mod, MoEMLP):
      for leaf, spec in mod.param_specs().items():
        specs[name + leaf] = spec
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
  each parameter's spec (``state_shardings``); a
  :class:`MutableTrainState`'s ``model_state`` rides beside the
  parameters, on the same device.  ZeRO (``zero.level``,
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
  leaves = dict(state.params)
  for name, t in (getattr(state, "model_state", None) or {}).items():
    leaves[f"model_state/{name}"] = t
  wrong = sorted(n for n, p in leaves.items() if p.device != mesh.device)
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


def grad_mean_axes(model) -> Tuple[str, ...]:
  """The axes whose ranks hold distinct parts of the global batch, over
  which the gradients are averaged: ``data``, and the model's own split
  axes (``models.gpt.split_axes``: the seq tokens, the a2a MoE's
  expert rows)."""
  return (constants.DATA_AXIS,) + tuple(getattr(model, "split_axes", ()))


def _sharded_over(spec, axis: str) -> bool:
  for entry in spec or ():
    if entry == axis or (isinstance(entry, tuple) and axis in entry):
      return True
  return False


def _batch_sum(grads, axis: str):
  return fusion.batch_all_reduce(grads, axis) if grads else {}


def _reduce_grads(params: Dict[str, torch.Tensor],
                  stage_summed: Iterable[str] = (),
                  mean_axes: Sequence[str] = (),
                  specs: Optional[Dict[str, tuple]] = None,
                  owners: Optional[Dict[str, torch.Tensor]] = None,
                  dims: Optional[Dict[str, Optional[int]]] = None,
                  reduce_method: str = "mean", mesh=None) -> None:
  """The cross-rank gradient reduction every engine shares (JAX
  ``pipeline_smap._reduce_grads``), in place.

  1. Each leaf of ``stage_summed`` (a boundary leaf of the pipeline's
     ``vmap`` layout, whose gradient each rank holds only its part of:
     the feed's on stage 0, the emit's on the last) is summed over the
     stage group.
  2. Over each axis of ``mean_axes`` but ``data`` (the seq mean first):
     a leaf replicated over it is averaged, a leaf sharded over it (an
     expert shard under the a2a MoE, which gathers its gradient from
     every rank's tokens) divided by the axis size.
  3. Over ``data`` (when in ``mean_axes``): the mean (``reduce_method
     "sum"``: the sum), or, with ZeRO (``owners`` and ``dims``), each
     leaf with an owner dim reduce-scattered to this rank's owner slice
     (``owners[name].grad``, divided by dp), bucketed through
     ``fusion.batch_reduce_scatter`` (a ring when ``communication.
     overlap`` asks), the others averaged.

  Every reduction is bucketed (``communicators.fusion``)."""
  specs = specs or {}
  if collectives.axis_size(constants.STAGE_AXIS, mesh) > 1:
    grads = {}
    for n in stage_summed:
      p = params[n]
      grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
    for n, g in _batch_sum(grads, constants.STAGE_AXIS).items():
      params[n].grad = g
  live = {n: p for n, p in params.items() if p.grad is not None}
  for axis in mean_axes:
    size = collectives.axis_size(axis, mesh)
    if axis == constants.DATA_AXIS or size <= 1:
      continue
    whole = {n: p.grad for n, p in live.items()
             if not _sharded_over(specs.get(n), axis)}
    for n, g in _batch_sum(whole, axis).items():
      live[n].grad = g / size
    for n, p in live.items():
      if n not in whole:
        p.grad = p.grad / size
  dp = collectives.axis_size(constants.DATA_AXIS, mesh)
  if constants.DATA_AXIS not in mean_axes or dp <= 1:
    return
  div = 1 if reduce_method == "sum" else dp
  scattered = {}
  if owners is not None:
    scattered = {n: p.grad for n, p in live.items()
                 if dims.get(n) is not None}
  rest = {n: p.grad for n, p in live.items() if n not in scattered}
  for n, g in _batch_sum(rest, constants.DATA_AXIS).items():
    live[n].grad = g / div
  if scattered:
    from easyparallellibrary_tpu_torch.runtime.zero import (
        _zero1_overlap_chunks)
    chunks = _zero1_overlap_chunks(scattered, dims, dp)
    red = fusion.batch_reduce_scatter(
        scattered, constants.DATA_AXIS, {n: dims[n] for n in scattered},
        dp, num_chunks=chunks if chunks >= 2 else 0)
    for n, g in red.items():
      owners[n].grad = g / div


def reduce_gradients(params: Dict[str, torch.Tensor], reduce_method: str,
                     mesh=None, model=None) -> None:
  """The gradient reduction GSPMD inserts, in place and bucketed
  (``communicators.fusion``): over the split axes of ``model`` (the
  step's ``apply_fn``; :func:`grad_mean_axes`) the mean, a leaf sharded
  over such an axis divided by its size; over ``data`` the mean of the
  ranks' gradients (``"sum"``: scaled by the data-parallel degree)
  (:func:`_reduce_grads`)."""
  _reduce_grads(params, mean_axes=grad_mean_axes(model),
                specs=param_specs(model), reduce_method=reduce_method,
                mesh=mesh)


def mean_loss(loss, model=None):
  """The reported loss: the mean of the ranks' over
  :func:`grad_mean_axes`."""
  loss = loss.detach()
  for axis in grad_mean_axes(model):
    loss = collectives.all_reduce(loss, axis, op=collectives.MEAN)
  return loss


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
    reduce_gradients(state.params, method, model=state.apply_fn)
    state.apply_gradients()
    return state, {"loss": mean_loss(loss, state.apply_fn), **aux}

  return train_step


def make_mutable_train_step(loss_fn: Callable) -> Callable:
  """The train step of a model with mutable state (batch norm's running
  statistics), for a :class:`MutableTrainState`: ``loss_fn(params,
  model_state, batch, rng) -> (loss, (aux, new_model_state))``,
  typically ``functional_call(model, {**params, **model_state}, (x,),
  {"train": True, "mutable": True})``.  The gradients are averaged over
  the data axis (the JAX step's GSPMD mean; it reads no
  ``gradients_reduce_method``), and the optimizer step and the new model
  state are applied together.  Under a data axis the statistics are the
  global batch's already (the model sums them over ``data``, as GSPMD
  does in the JAX program), so every rank's new state is the same."""

  def train_step(state: MutableTrainState, batch, rng):
    for p in state.params.values():
      p.grad = None
    loss, (aux, new_model_state) = loss_fn(state.params, state.model_state,
                                           batch, rng)
    loss.backward()
    reduce_gradients(state.params, "mean", model=state.apply_fn)
    state.apply_gradients(model_state=new_model_state)
    return state, {"loss": mean_loss(loss, state.apply_fn), **(aux or {})}

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
