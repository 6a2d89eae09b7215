"""Config-driven train-step assembly (port of
``easyparallellibrary_tpu/runtime/trainer.py``).

Composes the configured runtime features around the user's loss, in the
JAX package's order: gradient accumulation when
``pipeline.num_micro_batch > 1`` without pipeline stages, the fp16 loss
scale when ``amp.level`` is set with a loss scale, the finite check of
the anomaly sentinel, and the grouped optimizer apply
(``optimizer.num_apply_group``).

The JAX step runs the update and then selects the old state wholesale
on a bad step.  Here the verdict goes to torch's fused AdamW as its
``found_inf`` input: on a bad step the kernel leaves the parameters,
both moments and the decoupled weight decay untouched and takes its
step increment back, on the device, so the host never reads the
verdict.  ``TrainState.step`` then advances by the verdict as a device
tensor — it lags the loop count by the skips, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.parallel.api import (
    TrainState, mean_loss, reduce_gradients)
from easyparallellibrary_tpu_torch.runtime import amp as amp_lib
from easyparallellibrary_tpu_torch.runtime import resilience as resilience_lib
from easyparallellibrary_tpu_torch.runtime.gradient_accumulation import (
    accumulate_gradients, backward_fn)
from easyparallellibrary_tpu_torch.runtime.optimizer_helper import (
    apply_grad_group)


class AmpTrainState(TrainState):
  """TrainState carrying a loss scale (fp16 training)."""


def _loss_scale_on(cfg) -> bool:
  return bool(cfg.amp.level and cfg.amp.loss_scale not in ("", "none", "0"))


def _is_fused(opt: torch.optim.Optimizer) -> bool:
  return all(g.get("fused") for g in opt.param_groups)


def build_train_step(loss_fn: Optional[Callable] = None,
                     config=None,
                     use_loss_scale: Optional[bool] = None,
                     grad_fn: Optional[Callable] = None,
                     num_apply_group: Optional[int] = None) -> Callable:
  """``step(state, batch, rng) -> (state, metrics)`` from
  ``loss_fn(params, batch, rng) -> (loss, aux)``.

  Or pass ``grad_fn(params, batch, rng, loss_scale=None) -> (loss,
  aux)``, which adds the gradients of ``loss * loss_scale`` into the
  parameters' ``.grad`` itself (a path that owns its micro-batching:
  no accumulation is added around it).  The step unscales, checks and
  applies as for ``loss_fn``.

  A ZeRO state (``state.zero``: ``create_sharded_train_state`` under
  ``zero.level``) reduce-scatters the gradients to their data-axis
  owners, steps the owner slices and all-gathers the parameters
  (``runtime.zero.apply_sharded``), under every engine.

  A guarded step (a loss scale, or the state's sentinel counters) needs
  a fused optimizer (``create_train_state`` builds one); the metrics
  then carry ``grads_finite``, and ``bad_steps`` / ``bad_steps_total`` /
  ``update_skipped`` with the sentinel, ``loss_scale`` with the scale,
  all device tensors.
  """
  if (loss_fn is None) == (grad_fn is None):
    raise ValueError("pass exactly one of loss_fn / grad_fn")
  cfg = config if config is not None else Env.get().config
  ga_steps = 1
  if grad_fn is None and cfg.pipeline.num_micro_batch > 1 \
      and cfg.pipeline.num_stages <= 1:
    ga_steps = cfg.pipeline.num_micro_batch
  scaled = use_loss_scale if use_loss_scale is not None else \
      _loss_scale_on(cfg)
  if num_apply_group is None:
    num_apply_group = cfg.optimizer.num_apply_group

  def step(state, batch, rng):
    params = state.params
    for p in params.values():
      p.grad = None
    scale = state.loss_scale.scale if scaled else None
    if grad_fn is not None:
      loss, aux = grad_fn(params, batch, rng, loss_scale=scale)
    else:
      loss, aux = accumulate_gradients(backward_fn(loss_fn, scale),
                                       ga_steps)(params, batch, rng)
    model = state.apply_fn
    loss = mean_loss(loss, model)
    sentinel_on = getattr(state, "sentinel", None) is not None
    if getattr(state, "zero", None) is not None:
      if scaled or sentinel_on:
        raise ValueError("a guarded step (loss scale or anomaly sentinel) "
                         "does not compose with ZeRO")
      from easyparallellibrary_tpu_torch.runtime.zero import apply_sharded
      apply_sharded(state, cfg.communication.gradients_reduce_method)
      return state, {"loss": loss, **(aux or {})}
    # Over a data axis (and the model's split axes), the gradient mean
    # GSPMD inserts in the JAX step (a no-op on one rank); the loss
    # reported is the mean too.
    reduce_gradients(params, cfg.communication.gradients_reduce_method,
                     model=model)
    if not (scaled or sentinel_on):
      apply_grad_group(state.opt_state, params, num_apply_group)
      state.step = state.step + 1
      return state, {"loss": loss, **(aux or {})}
    if not _is_fused(state.opt_state):
      raise ValueError(
          "a guarded step (loss scale or anomaly sentinel) skips bad "
          "updates inside torch's fused AdamW: build the state with "
          "runtime.trainer.create_train_state or TrainState.create(..., "
          "fused=True)")
    grads = [p.grad for p in params.values()]
    inv = torch.reciprocal(scale) if scaled else None
    grads_finite = resilience_lib.grads_nonfinite(grads, inv) == 0
    finite = grads_finite & resilience_lib.finite_check(loss) \
        if sentinel_on else grads_finite
    apply_grad_group(state.opt_state, params, num_apply_group,
                     found_inf=(~finite).to(torch.float32))
    # A tensor plus the host count: no copy of the count to the device.
    state.step = finite.to(torch.int32) + state.step
    metrics = {"loss": loss, "grads_finite": finite.to(torch.float32)}
    if scaled:
      # The scale's own contract: backoff on gradient overflow alone.
      state.loss_scale = state.loss_scale.update(grads_finite)
      metrics["loss_scale"] = state.loss_scale.scale
    if sentinel_on:
      state.sentinel = state.sentinel.update(finite)
      metrics.update(resilience_lib.sentinel_metrics(state.sentinel,
                                                     finite))
    if aux:
      metrics.update(aux)
    return state, metrics

  return step


def create_train_state(apply_fn, params, tx, config=None) -> TrainState:
  """TrainState factory honoring the amp and resilience configs: sentinel
  counters when ``resilience.sentinel`` / ``max_bad_steps`` ask for them,
  a loss scale under ``amp.loss_scale``, and then a fused optimizer, on
  the parameters' device."""
  cfg = config if config is not None else Env.get().config
  device = next(iter(params.values())).device if params else None
  extra = {}
  if resilience_lib.sentinel_enabled(cfg):
    extra["sentinel"] = resilience_lib.SentinelState.create(device)
  if _loss_scale_on(cfg):
    if cfg.amp.loss_scale == "dynamic":
      scale = amp_lib.DynamicLossScale.create(device=device)
    else:
      scale = amp_lib.fixed_loss_scale(float(cfg.amp.loss_scale),
                                       device=device)
    return AmpTrainState.create(apply_fn=apply_fn, params=params, tx=tx,
                                fused=True, loss_scale=scale, **extra)
  return TrainState.create(apply_fn=apply_fn, params=params, tx=tx,
                           fused=True if extra else None, **extra)
