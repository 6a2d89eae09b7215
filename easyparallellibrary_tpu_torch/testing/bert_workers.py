"""Rank programs for the BERT and ResNet parity tests and ``chip_smoke.py``
phase 24.

Each function runs on one rank of ``utils.launcher.spawn``
(``fn(rank, world_size, *args)``), numpy in and numpy out, and imports
nothing of JAX.  The whole parameters go in (a pipelined model's in its
stacked layout); each rank cuts its slice (``weights.local_params``) and
returns its slice's gradients or parameters with its mesh coordinates,
which :func:`gather` puts back together.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch.testing.tp_workers import (
    setup, to_numpy, to_torch)


def bert_config(cfg_kwargs: dict, **extra):
  """A port ``BertConfig`` from JSON-able kwargs (``dtype`` a torch dtype
  name, default ``"float32"``)."""
  from easyparallellibrary_tpu_torch.models.bert import BertConfig
  kwargs = {**cfg_kwargs, **extra}
  dtype = kwargs.pop("dtype", "float32")
  return BertConfig(**kwargs, dtype=getattr(torch, dtype)
                    if isinstance(dtype, str) else dtype)


def _coords(mesh) -> dict:
  return {a: mesh.axis_index(a)
          for a in ("stage", "data", "seq", "expert", "model")}


def _bert(cfg_kwargs: dict, mesh):
  from easyparallellibrary_tpu_torch.models.bert import Bert
  return Bert(bert_config(cfg_kwargs,
                          tensor_parallel=mesh.axis_size("model") > 1))


def bert_grads(rank, world, mesh_shape: str, config: dict, cfg_kwargs: dict,
               params: Dict[str, np.ndarray], batch: Dict[str, np.ndarray]):
  """One gradient of BERT through ``make_bert_train_step``'s dispatch on
  ``mesh_shape`` under the Config entries ``config``: the pipeline
  engine's grad function, or ``bert_mlm_loss``; then the reduction the
  step makes.  Returns the loss, the rank's coordinates, its slice's
  gradients and the dispatch."""
  from easyparallellibrary_tpu_torch.models import bert as bert_lib
  from easyparallellibrary_tpu_torch.parallel.api import (
      local_batch, mean_loss, reduce_gradients)
  from easyparallellibrary_tpu_torch.weights import local_params
  mesh = setup(mesh_shape, config=config)
  model = _bert(cfg_kwargs, mesh)
  local = local_params(model, to_torch(params, mesh.device), mesh)
  for p in local.values():
    p.requires_grad_(True)
  step = bert_lib.make_bert_train_step(model)
  data = local_batch(batch, mesh)
  if step.grad_fn is not None:
    loss, _ = step.grad_fn(local, data, None)
  else:
    loss, _ = bert_lib.bert_mlm_loss(model, local, data)
    loss.backward()
  reduce_gradients(local, "mean", model=model)
  return {"loss": float(mean_loss(loss, model)), "coords": _coords(mesh),
          "grads": to_numpy({k: p.grad for k, p in local.items()}),
          "dispatch": step.dispatch}


def bert_train(rank, world, mesh_shape: str, config: dict, cfg_kwargs: dict,
               params: Dict[str, np.ndarray], batches, lr: float):
  """``len(batches)`` Adam(``lr``) steps (optax's ``adam``: AdamW without
  decay) through ``create_sharded_train_state`` and
  ``parallelize(make_bert_train_step(model))``: the losses, the
  dispatch and the optimizer's moment bytes on this rank."""
  from easyparallellibrary_tpu_torch.models.bert import make_bert_train_step
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.runtime.zero import moment_bytes
  from easyparallellibrary_tpu_torch.weights import local_params
  mesh = setup(mesh_shape, config=config)
  model = _bert(cfg_kwargs, mesh)
  local = local_params(model, to_torch(params, mesh.device), mesh)
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(lr, weight_decay=0.0)), mesh)
  step = make_bert_train_step(model)
  run = parallelize(step, mesh, shardings)
  losses = []
  for batch in batches:
    state, m = run(state, batch, None)
    losses.append(float(m["loss"]))
  return {"losses": losses, "dispatch": step.dispatch,
          "coords": _coords(mesh),
          "moment_bytes": moment_bytes(state.opt_state)}


def gather(ranks, cfg_kwargs: dict, key: str = "grads"
           ) -> Dict[str, np.ndarray]:
  """The whole BERT tree from every rank's slice (data and seq replicas
  hold the same slice)."""
  from easyparallellibrary_tpu_torch.weights import unshard_params
  cfg = bert_config(cfg_kwargs)
  S = 1 + max(r["coords"]["stage"] for r in ranks)
  tp = 1 + max(r["coords"]["model"] for r in ranks)
  grid = [[None] * tp for _ in range(S)]
  for r in ranks:
    c = r["coords"]
    if c["data"] == 0 and c["seq"] == 0:
      grid[c["stage"]][c["model"]] = {
          k: torch.from_numpy(np.asarray(v)) for k, v in r[key].items()}
  if tp > 1:
    cfg = dataclasses.replace(cfg, tensor_parallel=True)
  whole = unshard_params(grid if S > 1 else grid[0], cfg)
  return {k: v.numpy() for k, v in whole.items()}


def resnet_data_parallel(rank, world, cfg_kwargs: dict,
                         params: Dict[str, np.ndarray],
                         stats: Dict[str, np.ndarray], x: np.ndarray,
                         y: np.ndarray, device: str = "cpu",
                         backend: Optional[str] = None):
  """Batch-norm ResNet on ``data:<world>``: one training forward on this
  rank's rows (the statistics summed over the data axis), the
  cross-entropy's mean, backward and the data mean of the gradients.
  Returns the new running statistics, the loss and the gradients."""
  from easyparallellibrary_tpu_torch.models.resnet import (
      ResNet, ResNetConfig)
  from easyparallellibrary_tpu_torch.parallel.api import (
      local_batch, mean_loss, reduce_gradients)
  mesh = setup(f"data:{world}", device=device, backend=backend)
  kw = dict(cfg_kwargs)
  dtype = getattr(torch, kw.pop("dtype", "float32"))
  model = ResNet(ResNetConfig(**kw, dtype=dtype))
  local = {k: v.requires_grad_(True)
           for k, v in to_torch(params, mesh.device).items()}
  data = local_batch({"x": x, "y": y}, mesh)
  logits, new = torch.func.functional_call(
      model, {**local, **to_torch(stats, mesh.device)}, (data["x"],),
      {"train": True, "mutable": True})
  loss = torch.nn.functional.cross_entropy(logits, data["y"].long())
  loss.backward()
  reduce_gradients(local, "mean", model=model)
  return {"stats": to_numpy(new), "loss": float(mean_loss(loss, model)),
          "grads": to_numpy({k: p.grad for k, p in local.items()})}


def resnet_split_head(rank, world, cfg_kwargs: dict,
                      params, x: np.ndarray, y: np.ndarray,
                      steps: int = 0, lr: float = 0.0,
                      device: str = "cpu", backend: Optional[str] = None):
  """ResNet built under ``epl.split(world)`` on ``model:<world>``: the
  classifier head column-parallel (above one rank), this rank's block of
  the classes; ``params`` the whole tree (numpy arrays or tensors).
  The gathered logits, the distributed cross-entropy's mean and the
  rank's gradients; with ``steps``, that many AdamW(``lr``) steps
  through ``parallelize(make_train_step(...))`` and their losses and
  step ms."""
  import time

  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.resnet import (
      ResNet, ResNetConfig)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.ops.losses import (
      distributed_sparse_softmax_cross_entropy_with_logits as ce)
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, make_train_step, parallelize,
      reduce_gradients)
  from easyparallellibrary_tpu_torch.weights import local_params
  mesh = setup(f"model:{world}", device=device, backend=backend)
  kw = dict(cfg_kwargs)
  dtype = getattr(torch, kw.pop("dtype", "float32"))
  cfg = ResNetConfig(**kw, dtype=dtype)
  with epl.split(world):
    model = ResNet(cfg)
  assert model.tp == world
  local = local_params(model, {k: torch.as_tensor(v).to(mesh.device)
                               for k, v in params.items()}, mesh)

  def loss_fn(p, batch, rng):
    del rng
    logits = torch.func.functional_call(model, p, (batch["x"],),
                                        {"gather_logits": False})
    return ce(batch["y"].long(), logits,
              vocab_size=cfg.num_classes).mean(), {}

  data = {"x": torch.from_numpy(x).to(mesh.device),
          "y": torch.from_numpy(y).to(mesh.device)}
  out = {"coords": _coords(mesh)}
  if not steps:
    for p in local.values():
      p.requires_grad_(True)
    logits = torch.func.functional_call(model, local, (data["x"],))
    loss, _ = loss_fn(local, data, None)
    loss.backward()
    reduce_gradients(local, "mean", model=model)
    out.update(logits=to_numpy(logits), loss=float(loss),
               grads=to_numpy({k: p.grad for k, p in local.items()}))
    return out
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(lr, weight_decay=0.01)), mesh)
  run = parallelize(make_train_step(loss_fn), mesh, shardings)
  losses, ms = [], []
  for _ in range(steps):
    if mesh.device.type == "cuda":
      torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    state, m = run(state, {"x": x, "y": y}, None)
    losses.append(float(m["loss"]))
    ms.append((time.perf_counter() - t0) * 1e3)
  out.update(losses=losses, step_ms=ms,
             head_rows=int(state.params["head.weight"].shape[0]))
  if mesh.device.type == "cuda":
    out["peak_gib"] = torch.cuda.max_memory_allocated(mesh.device) / 2**30
  return out


def suite(rank, world, cases):
  """Several of this module's programs in one group of ranks (each rank
  started once): ``cases`` is ``[(name, args)]``.  Returns each case's
  result, in order."""
  programs = {"bert_grads": bert_grads, "bert_train": bert_train,
              "resnet_data_parallel": resnet_data_parallel,
              "resnet_split_head": resnet_split_head}
  return [programs[name](rank, world, *args) for name, args in cases]


# ------------------------------------------------------- the card's phase


def mlm_batch(vocab_size: int, batch: int, seq: int, masked: int,
              seed: int) -> Dict[str, np.ndarray]:
  """An MLM batch as ``benchmarks/single_chip_models.py`` makes it (the
  labels are the ids), with ``masked`` predicted tokens in every row (a
  fixed count, so every micro-batch holds as many and the ``smap``
  engine's mean of per micro-batch ratios is the whole batch's ratio)."""
  r = np.random.RandomState(seed)
  ids = r.randint(0, vocab_size, (batch, seq)).astype(np.int64)
  mask = np.zeros((batch, seq), np.float32)
  for row in range(batch):
    mask[row, r.choice(seq, masked, replace=False)] = 1.0
  return {"ids": ids, "labels": ids.copy(), "mask": mask}


def images(batch: int, hw: int, classes: int, seed: int):
  """NHWC fp32 images and int labels from a numpy seed."""
  r = np.random.RandomState(seed)
  return (r.randn(batch, hw, hw, 3).astype(np.float32),
          r.randint(0, classes, (batch,)).astype(np.int64))


def chip_bert_pipeline(rank, world, backend: str, spec: dict,
                       device: str = "cuda"):
  """Phase 24c on a rank: BERT (``spec["cfg"]``, a non-pipelined config)
  in ``world`` stages of ``spec["M"]`` micro-batches under
  ``pipeline.engine="smap"`` / ``PreferBackward`` (1F1B), from the
  weights in the file ``spec["weights"]`` (stacked and cut here),
  ``spec["steps"]`` AdamW steps on :func:`mlm_batch` of ``spec["batch"]``
  through ``create_sharded_train_state`` and ``parallelize(
  make_bert_train_step(model))``: the losses, each step's ms, the peak
  memory, K1's launches (counts set to 0 just before the steps) and the
  schedule's formula, the plain versions' calls, the dispatch and the
  bytes staged through the host."""
  import time

  from easyparallellibrary_tpu_torch.communicators import collectives
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.models.bert import (
      Bert, make_bert_train_step)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.weights import (
      shard_params, stack_stages)
  torch.backends.cuda.matmul.allow_tf32 = False
  mesh = setup(f"stage:{world}", device=device, backend=backend, config={
      "pipeline.engine": "smap", "pipeline.strategy": "PreferBackward"})
  dev = mesh.device
  cfg = bert_config(spec["cfg"], pipeline_stages=world,
                    num_micro_batch=spec["M"])
  model = Bert(cfg)
  flat = torch.load(spec["weights"], map_location="cpu")
  local = {k: v.to(dev) for k, v in shard_params(
      stack_stages(flat, cfg), model).items()}
  del flat
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(spec["lr"], weight_decay=0.01)),
      mesh)
  del local
  step = make_bert_train_step(model)
  run = parallelize(step, mesh, shardings)
  batch = mlm_batch(cfg.vocab_size, *spec["batch"])
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
  fa.reset_counts()
  collectives.staged_bytes = 0
  losses, ms = [], []
  for _ in range(spec["steps"]):
    t0 = time.perf_counter()
    state, m = run(state, batch, None)
    losses.append(float(m["loss"]))
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)
    ms.append((time.perf_counter() - t0) * 1e3)
  sched = step.grad_fn.schedule
  return {
      "losses": losses, "step_ms": ms, "coords": _coords(mesh),
      "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                   if dev.type == "cuda" else None),
      "launches": {"fwd": fa.flash_fwd_cuda.launches,
                   "dkv": fa.flash_bwd_dkv_cuda.launches,
                   "dq": fa.flash_bwd_dq_cuda.launches},
      "formula": {k: v * spec["steps"] for k, v in sched.launches_per_rank(
          cfg.num_layers // world).items()},
      "plain_calls": fa.flash_fwd_reference.calls
      + fa.flash_bwd_dkv_reference.calls + fa.flash_bwd_dq_reference.calls,
      "dispatch": step.dispatch,
      "staged_bytes_per_step": collectives.staged_bytes / spec["steps"]}


def chip_phase24(rank, world, backend: str, spec: dict,
                 device: str = "cuda"):
  """Phase 24c and 24e on the ranks of phase 21's group:
  :func:`chip_bert_pipeline` (``spec["bert"]``), and ResNet's split head
  on ``model:world`` (``spec["resnet"]``: the config, the weights' file,
  the images' batch and seed, the steps and learning rate;
  :func:`resnet_split_head`)."""
  import gc
  import time

  t0 = time.monotonic()
  out = {"bert": chip_bert_pipeline(rank, world, backend, spec["bert"],
                                    device)}
  gc.collect()
  if torch.device(device).type == "cuda":
    torch.cuda.empty_cache()
  rs = spec["resnet"]
  x, y = images(rs["batch"], rs["image"], rs["cfg"]["num_classes"],
                rs["seed"])
  params = torch.load(rs["weights"], map_location="cpu")
  out["resnet"] = resnet_split_head(rank, world, rs["cfg"], params, x, y,
                                    steps=rs["steps"], lr=rs["lr"],
                                    device=device, backend=backend)
  out["wall_s"] = time.monotonic() - t0
  return out
