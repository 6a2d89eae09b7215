"""Rank programs for the pipeline parity tests and ``chip_smoke.py``
phase 22.

Each function runs on one rank of ``utils.launcher.spawn``
(``fn(rank, world_size, *args)``), numpy in and numpy out, and imports
nothing of JAX.  The whole parameters go in in the pipelined layout
(``weights.from_jax_params`` of a JAX pipelined tree, or
``weights.stack_stages``); each rank cuts its slice
(``weights.shard_params``) and returns its slice's gradients, which
:func:`gather` puts back together.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch.testing.tp_workers import (
    gpt_config, setup, to_numpy, to_torch)


def _pipeline_config(engine: str, strategy: str, extra=None) -> dict:
  return {"pipeline.engine": engine, "pipeline.strategy": strategy,
          **(extra or {})}


def _model(cfg_kwargs: dict, mesh, **extra):
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  tp = mesh.axis_size("model") > 1
  return GPT(gpt_config(cfg_kwargs, tensor_parallel=tp, **extra))


def _coords(mesh) -> dict:
  return {a: mesh.axis_index(a)
          for a in ("stage", "data", "seq", "expert", "model")}


def grads(rank, world, mesh_shape: str, engine: str, strategy: str,
          cfg_kwargs: dict, params: Dict[str, np.ndarray],
          ids: np.ndarray, loss_scale: Optional[float] = None,
          rng=None, dropout_draws: int = 0, config=None):
  """One gradient of the pipelined GPT through
  ``make_gpt_train_step``'s grad function on ``mesh_shape``: the loss,
  the rank's coordinates and its slice's gradients (the mean over the
  data and split axes taken).  ``dropout_draws``: also the losses of
  that many extra draws with ``rng`` folded by the draw index.
  ``config``: more Config entries."""
  from easyparallellibrary_tpu_torch.models import gpt as gpt_lib
  from easyparallellibrary_tpu_torch.parallel.api import (
      local_batch, mean_loss, reduce_gradients)
  from easyparallellibrary_tpu_torch.weights import shard_params
  mesh = setup(mesh_shape, config=_pipeline_config(engine, strategy,
                                                   config))
  model = _model(cfg_kwargs, mesh)
  cfg = model.cfg
  local = shard_params(to_torch(params, mesh.device), model)
  for p in local.values():
    p.requires_grad_(True)
  step = gpt_lib.make_gpt_train_step(model)
  batch = local_batch({"ids": ids}, mesh)
  grad_fn = step.grad_fn
  key = None if rng is None else np.asarray(rng, np.uint32)
  loss, _ = grad_fn(local, batch, key, loss_scale=loss_scale)
  reduce_gradients(local, "mean", model=model)
  loss = mean_loss(loss, model)
  out = {"loss": float(loss), "coords": _coords(mesh),
         "grads": to_numpy({k: p.grad for k, p in local.items()}),
         "dispatch": step.dispatch}
  if dropout_draws:
    from easyparallellibrary_tpu_torch.utils import prng
    draws = []
    for d in range(dropout_draws):
      for p in local.values():
        p.grad = None
      loss, _ = grad_fn(local, batch, prng.host_fold_in(key, d))
      draws.append(float(loss))
    out["draws"] = draws
  return out


def train(rank, world, mesh_shape: str, engine: str, strategy: str,
          cfg_kwargs: dict, params: Dict[str, np.ndarray], batches,
          lr: float, weight_decay: float = 0.01, device: str = "cpu",
          backend: Optional[str] = None, config=None):
  """``len(batches)`` AdamW steps through ``create_sharded_train_state``
  and ``parallelize(make_gpt_train_step(model))``: the losses, the
  dispatch, the optimizer's moment bytes and the rank's final parameter
  slice.  ``config``: more Config entries (``zero.level``,
  ``sequence.*``)."""
  from easyparallellibrary_tpu_torch.runtime.zero import moment_bytes
  from easyparallellibrary_tpu_torch.models.gpt import make_gpt_train_step
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.weights import local_params
  mesh = setup(mesh_shape, device=device, backend=backend,
               config=_pipeline_config(engine, strategy, config))
  model = _model(cfg_kwargs, mesh)
  local = local_params(model, to_torch(params, mesh.device), mesh)
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(lr, weight_decay=weight_decay)),
      mesh)
  step = make_gpt_train_step(model)
  run = parallelize(step, mesh, shardings)
  losses = []
  for batch in batches:
    state, m = run(state, {"ids": np.asarray(batch)}, None)
    losses.append(float(m["loss"]))
  return {"losses": losses, "dispatch": step.dispatch,
          "coords": _coords(mesh), "params": to_numpy(dict(state.params)),
          "moment_bytes": moment_bytes(state.opt_state)}


def zero_refuses_coupled(rank, world, mesh_shape: str, engine: str,
                         strategy: str, level: str, cfg_kwargs: dict,
                         params: Dict[str, np.ndarray], ids):
  """The message of a ZeRO (``level``) train step of the pipelined GPT on
  ``mesh_shape`` under an optimizer that clips by the global norm
  (``tp_workers.clipped_adamw``; empty when nothing was raised)."""
  from easyparallellibrary_tpu_torch.models.gpt import make_gpt_train_step
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.testing.tp_workers import clipped_adamw
  from easyparallellibrary_tpu_torch.weights import local_params
  mesh = setup(mesh_shape, config=_pipeline_config(
      engine, strategy, {"zero.level": level}))
  model = _model(cfg_kwargs, mesh)
  local = local_params(model, to_torch(params, mesh.device), mesh)
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=clipped_adamw()), mesh)
  run = parallelize(make_gpt_train_step(model), mesh, shardings)
  try:
    run(state, {"ids": np.asarray(ids)}, None)
  except ValueError as e:
    return str(e)
  return ""


def composition_losses(rank, world):
  """The compositions that once raised build and take a train step (ZeRO
  under the pipeline, a pipelined MoE, ring attention on a seq axis of
  ``world`` ranks): each one's loss; and the FLOPs ``profile_step``
  counts on a rank of the group (a ``[4, 4] @ [4, 4]`` product)."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, make_gpt_train_step
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.profiler.profiler import profile_step
  from easyparallellibrary_tpu_torch.weights import (
      init_params, shard_params, stack_stages)
  base = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
              max_seq_len=16)
  pipe = dict(pipeline_stages=2, num_micro_batch=2)
  ids = np.random.RandomState(0).randint(0, 64, (4, 17))
  out = {}
  for key, mesh_shape, config, over in (
      ("zero", "stage:2", {"zero.level": "v1"}, pipe),
      ("moe", "stage:2", {}, dict(pipe, num_experts=4, moe_every=1)),
      ("seq", f"seq:{world}", {}, {"attn_impl": "ring",
                                   "seq_parallel": True})):
    mesh = setup(mesh_shape, config=config)
    cfg = gpt_config(dict(base, **over))
    model = GPT(cfg)
    flat = {k: v for k, v in over.items() if k not in pipe}
    whole = init_params(gpt_config(dict(base, **flat)), seed=1,
                        device="cpu")
    if cfg.pipeline_stages > 1:
      whole = stack_stages(whole, cfg)
    local = shard_params(whole, model)
    state, shardings = create_sharded_train_state(
        lambda: TrainState.create(apply_fn=model, params=local,
                                  tx=adamw(1e-2)), mesh)
    run = parallelize(make_gpt_train_step(model), mesh, shardings)
    _, metrics = run(state, {"ids": ids}, None)
    out[key] = float(metrics["loss"])
  out["profile_flops"] = profile_step(
      torch.matmul, torch.ones(4, 4), torch.ones(4, 4))["cost_flops"]
  return out


def gather(ranks, cfg_kwargs: dict, key: str = "grads"
           ) -> Dict[str, np.ndarray]:
  """The whole tree from every rank's slice (``ranks``: the workers'
  returns with their ``coords``); data replicas hold the same slice."""
  from easyparallellibrary_tpu_torch.weights import unshard_params
  cfg = gpt_config(cfg_kwargs)
  S = 1 + max(r["coords"]["stage"] for r in ranks)
  tp = 1 + max(r["coords"]["model"] for r in ranks)
  grid = [[None] * tp for _ in range(S)]
  for r in ranks:
    if r["coords"]["data"] == 0:
      grid[r["coords"]["stage"]][r["coords"]["model"]] = {
          k: torch.from_numpy(np.asarray(v)) for k, v in r[key].items()}
  if tp > 1:
    import dataclasses
    cfg = dataclasses.replace(cfg, tensor_parallel=True)
  whole = unshard_params(grid, cfg)
  return {k: v.numpy() for k, v in whole.items()}


def suite(rank, world, cases):
  """Several of this module's programs in one group of ranks (each rank
  started once): ``cases`` is ``[(name, args)]``, ``name`` one of
  ``grads``, ``train``, ``composition_losses`` and
  ``zero_refuses_coupled``.  Returns each case's result, in order."""
  programs = {"grads": grads, "train": train,
              "composition_losses": composition_losses,
              "zero_refuses_coupled": zero_refuses_coupled}
  return [programs[name](rank, world, *args) for name, args in cases]


# ------------------------------------------------------- the card's phase


def _stage_kernel_check(dev, rows: int, heads: int, seq: int, hd: int):
  """K1's forward and dK/dV at one stage's micro-batch shape (bf16,
  causal) against their plain versions: ``(rel_l2, max_rel)`` of each."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  g = torch.Generator().manual_seed(22)
  q, k, v, dout = (torch.randn(rows, heads, seq, hd, generator=g).to(
      dev, torch.bfloat16) for _ in range(4))
  out, lse = fa.flash_fwd_cuda(q, k, v, True)
  want_out, want_lse = fa.flash_fwd_reference(q, k, v, True)
  delta = (dout.float() * want_out.float()).sum(-1)
  dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, dout, want_lse, delta, True)
  wdk, wdv = fa.flash_bwd_dkv_reference(q, k, v, dout, want_lse, delta,
                                        True)

  def errs(got, want):
    diff, want = got.float() - want.float(), want.float()
    return ((diff.norm() / want.norm()).item(),
            (diff.abs().max() / want.abs().max()).item())

  return {"fwd": errs(out, want_out),
          "dkv": errs(torch.cat([dk, dv]), torch.cat([wdk, wdv]))}


def _profiled_step(run, state, batch, dev):
  """One more step under ``torch.profiler`` (device activity only): its
  host wall, the union of this process's device intervals (kernels and
  copies) and the copies' share of it, in ms."""
  import time

  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize(dev)
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    state, _ = run(state, batch, None)
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3
  spans, copy_us = [], 0.0
  for e in prof.events():
    start, end = e.time_range.start, e.time_range.end
    if e.device_type == torch.autograd.DeviceType.CUDA and end > start:
      spans.append((start, end))
      if "Memcpy" in e.name:
        copy_us += end - start
  busy, last = 0.0, None
  for start, end in sorted(spans):
    if last is None or start > last:
      busy += end - start
      last = end
    elif end > last:
      busy += end - last
      last = end
  return state, {"wall_ms": wall, "device_busy_ms": busy / 1e3,
                 "copy_ms": copy_us / 1e3}


def chip_pipeline(rank, world, backend: str, spec: dict,
                  device: str = "cuda", flat=None):
  """Phase 22 on a rank: ``spec["runs"]`` (``[(name, engine, strategy,
  interleave)]``) each train ``spec["cfg"]`` (a non-pipelined GPT
  config, cut into ``world`` stages of ``spec["M"]`` micro-batches by
  ``auto_parallel_gpt`` from ``pipeline.num_stages`` /
  ``num_micro_batch``) from ``init_params(spec["seed"])`` through
  ``create_sharded_train_state`` and
  ``parallelize(make_gpt_train_step(model))``, ``spec["steps"]``
  AdamW(3e-4, wd 0.01) steps on ``spec["batch"]``.  Per run: the losses,
  each step's ms, the peak memory, K1's launches and the plain versions'
  calls (counts set to 0 just before the steps), the bytes staged
  through the host and sent on hops, the schedule's launch formula, and
  for the run ``spec["profile"]`` names one more step under
  ``torch.profiler`` (:func:`_profiled_step`); and K1 at the stage's
  shapes against its plain version.  ``flat``: the draw of
  ``init_params(spec["seed"])`` on the host, when the caller holds it
  already."""
  import gc
  import time

  from easyparallellibrary_tpu_torch.communicators import collectives
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.models.gpt import (
      auto_parallel_gpt, make_gpt_train_step)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel import pipeline as pp
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.weights import (
      init_params, shard_params, stack_stages)
  t_start = time.monotonic()
  torch.backends.cuda.matmul.allow_tf32 = False
  if flat is None:
    flat = init_params(gpt_config(spec["cfg"]), spec["seed"], device="cpu")
  M, steps = spec["M"], spec["steps"]
  batch = {"ids": torch.from_numpy(np.asarray(spec["batch"]))}
  out = {"runs": {}}
  for name, engine, strategy, interleave in spec["runs"]:
    # The user's entry: the stages and micro-batches from the Config,
    # planned by auto_parallel_gpt.
    mesh = setup(f"stage:{world}", device=device, backend=backend,
                 config=_pipeline_config(engine, strategy, {
                     "auto.auto_parallel": True,
                     "pipeline.num_stages": world,
                     "pipeline.num_micro_batch": M}))
    dev = mesh.device
    model = auto_parallel_gpt(gpt_config(spec["cfg"],
                                         pipeline_interleave=interleave))
    cfg = model.cfg
    local = {k: v.to(dev) for k, v in shard_params(
        stack_stages(flat, cfg), model).items()}
    state, shardings = create_sharded_train_state(
        lambda: TrainState.create(apply_fn=model, params=local,
                                  tx=adamw(3e-4, weight_decay=0.01)), mesh)
    del local
    step = make_gpt_train_step(model)
    run = parallelize(step, mesh, shardings)
    if "kernels" not in out:
      out["kernels"] = _stage_kernel_check(
          dev, batch["ids"].shape[0] // M, cfg.num_heads,
          cfg.max_seq_len, cfg.d_model // cfg.num_heads)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_counts()
    collectives.staged_bytes = 0
    pp.hop_bytes = 0
    losses, ms = [], []
    for _ in range(steps):
      t0 = time.perf_counter()
      state, m = run(state, batch, None)
      losses.append(float(m["loss"]))
      torch.cuda.synchronize(dev)
      ms.append((time.perf_counter() - t0) * 1e3)
    sched = step.grad_fn.schedule
    out["runs"][name] = {
        "losses": losses, "warm_ms": ms[0], "step_ms": ms[1:],
        # epl-lint: disable=device-introspection — a rank program's one
        # read per measured configuration, after its steps
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": {"fwd": fa.flash_fwd_cuda.launches,
                     "dkv": fa.flash_bwd_dkv_cuda.launches,
                     "dq": fa.flash_bwd_dq_cuda.launches},
        "plain_calls": fa.flash_fwd_reference.calls
        + fa.flash_bwd_dkv_reference.calls + fa.flash_bwd_dq_reference.calls,
        "formula": {k: v * steps for k, v in sched.launches_per_rank(
            cfg.num_layers // world).items()},
        "staged_bytes_per_step": collectives.staged_bytes / steps,
        "hop_bytes_per_step": pp.hop_bytes / steps,
        "dispatch": step.dispatch, "ticks": len(sched.ticks),
        "bubble_fraction": pp.bubble_fraction(world, M)}
    if name == spec.get("profile"):
      _, out["runs"][name]["profiled"] = _profiled_step(run, state, batch,
                                                        dev)
    del state, run, step, model
    gc.collect()
    torch.cuda.empty_cache()
  out["wall_s"] = time.monotonic() - t_start
  return out
