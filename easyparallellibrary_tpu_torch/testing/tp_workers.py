"""Rank programs for the multi-rank parity tests and ``chip_smoke.py``
phase 21.

Each function runs on one rank of ``utils.launcher.spawn``:
``fn(rank, world_size, *args)``, with numpy in and numpy out, so a test
process that also holds JAX hands the same arrays to both.  Every
program starts the group through ``epl.init`` (gloo on the CPU, or the
``backend`` named), builds the mesh from a ``cluster.mesh_shape`` spec,
and imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def setup(mesh_shape: str, device: str = "cpu",
          backend: Optional[str] = None, config: Optional[dict] = None):
  """``epl.init`` + ``build_mesh`` on this rank; returns the mesh."""
  import easyparallellibrary_tpu_torch as epl
  if torch.device(device).type == "cpu":
    # Small CPU ranks, several at once: one intra-op thread each.
    torch.set_num_threads(1)
  epl.init(epl.Config({"cluster.mesh_shape": mesh_shape, **(config or {})}),
           device=device, backend=backend)
  return epl.Env.get().cluster.build_mesh()


def gpt_config(cfg_kwargs: dict, **extra):
  """A port ``GPTConfig`` from JSON-able kwargs: ``dtype`` a torch dtype
  name (default ``"float32"``, the CPU parity tests' type)."""
  from easyparallellibrary_tpu_torch.models.gpt import GPTConfig
  kwargs = {**cfg_kwargs, **extra}
  dtype = kwargs.pop("dtype", "float32")
  return GPTConfig(**kwargs, dtype=getattr(torch, dtype)
                   if isinstance(dtype, str) else dtype)


def to_torch(tree: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
  return {k: torch.from_numpy(np.array(v)).to(device)
          for k, v in tree.items()}


def to_numpy(x):
  if isinstance(x, dict):
    return {k: to_numpy(v) for k, v in x.items()}
  if isinstance(x, torch.Tensor):
    return x.detach().float().cpu().numpy()
  return x


def gpt_logits_and_loss(rank, world, mesh_shape: str, cfg_kwargs: dict,
                        params: Dict[str, np.ndarray], ids: np.ndarray,
                        loss_chunks=(0,)):
  """Whole logits of ``ids[:, :-1]``, and for each of ``loss_chunks``
  the ``gpt_loss`` and this rank's parameter gradients, of a
  ``tensor_parallel`` GPT."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, gpt_loss
  from easyparallellibrary_tpu_torch.weights import shard_params
  mesh = setup(mesh_shape)
  out = []
  x = torch.from_numpy(ids).long()
  logits = None
  for chunk in loss_chunks:
    cfg = gpt_config(cfg_kwargs, tensor_parallel=True, loss_chunk=chunk)
    model = GPT(cfg)
    local = shard_params(to_torch(params, mesh.device), model)
    for p in local.values():
      p.requires_grad_(True)
    if logits is None:
      with torch.no_grad():
        logits = torch.func.functional_call(model, local, (x[:, :-1],))
    loss, _ = gpt_loss(model, local, {"ids": x})
    loss.backward()
    out.append((float(loss.detach()),
                to_numpy({k: p.grad for k, p in local.items()})))
  return to_numpy(logits), out


def _drafter(spec, mesh, device):
  """``None``, ``("ngram", k)`` or ``("draft", cfg_kwargs, params, k,
  tensor_parallel)``."""
  if spec is None:
    return None
  from easyparallellibrary_tpu_torch.serving import (
      DraftModelDrafter, NgramDrafter)
  if spec[0] == "ngram":
    return NgramDrafter(k=spec[1])
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  _, cfg_kwargs, params, k, tp = spec
  model = GPT(gpt_config(cfg_kwargs, tensor_parallel=tp))
  return DraftModelDrafter(model, to_torch(params, device), k=k,
                           mesh=mesh if tp else None)


def tp_engine_streams(rank, world, mesh_shape: str, cfg_kwargs: dict,
                      params: Dict[str, np.ndarray], prompts, max_new,
                      engine_kwargs: dict, drafter=None,
                      first_wave: int = 2, device: str = "cpu",
                      backend: Optional[str] = None):
  """Staggered greedy streams of a tensor-parallel engine: rank 0 leads
  (``first_wave`` requests, one step, the rest join mid-flight), the
  other ranks ``follow()``.  Rank 0 returns ``{uid: tokens}`` and the
  engine's counters, the others their step count."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  mesh = setup(mesh_shape, device=device, backend=backend)
  model = GPT(gpt_config(cfg_kwargs, tensor_parallel=True))
  eng = ContinuousBatchingEngine(
      model, to_torch(params, mesh.device), mesh=mesh,
      drafter=_drafter(drafter, mesh, mesh.device), **engine_kwargs)
  if not eng.is_leader:
    return {"follower_steps": eng.follow()}
  try:
    for i in range(first_wave):
      eng.submit(Request(uid=i, prompt=np.asarray(prompts[i], np.int32),
                         max_new_tokens=int(max_new[i])))
    out = {}
    for fin in eng.step():
      out[fin.uid] = fin.tokens
    for i in range(first_wave, len(prompts)):
      eng.submit(Request(uid=i, prompt=np.asarray(prompts[i], np.int32),
                         max_new_tokens=int(max_new[i])))
    out.update(eng.run())
  finally:
    eng.close()
  sched = eng.scheduler
  return {"streams": {k: np.asarray(v) for k, v in out.items()},
          "steps": eng.steps,
          "prefix_hits": sched.prefix_hits if eng.paged else 0}


def engine_mesh_errors(rank, world):
  """The messages a TP engine raises for heads that do not divide the
  model axis (on ``model:2``) and for a data axis above 1 (on
  ``data:2``)."""
  import torch.distributed as dist

  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.serving import ContinuousBatchingEngine
  from easyparallellibrary_tpu_torch.weights import init_params
  out = {}
  mesh = setup("model:2")
  try:
    GPT(gpt_config(dict(vocab_size=64, num_layers=1, num_heads=3,
                        d_model=24, d_ff=32, max_seq_len=16),
                   tensor_parallel=True))
  except ValueError as e:
    out["heads"] = str(e)
  del mesh
  epl.init(epl.Config({"cluster.mesh_shape": "data:2"}), device="cpu")
  mesh = epl.Env.get().cluster.build_mesh()
  cfg = gpt_config(dict(vocab_size=64, num_layers=1, num_heads=4,
                        d_model=32, d_ff=32, max_seq_len=16))
  try:
    ContinuousBatchingEngine(GPT(cfg), init_params(cfg, 0, device="cpu"),
                             mesh=mesh, paged=True)
  except ValueError as e:
    out["data"] = str(e)
  dist.barrier()
  return out


def collectives_suite(rank, world, x: np.ndarray, tree: Dict[str, np.ndarray]):
  """Every collective of ``communicators`` on this rank's block of ``x``
  (rows split over a ``data`` axis of ``world``) and a fused
  all-reduce of ``tree``'s blocks; gradients of the differentiable
  ones.  Returns ``{op: numpy}``."""
  from easyparallellibrary_tpu_torch.communicators import (
      collectives as C, fusion, overlap)
  setup(f"data:{world}")
  rows = x.shape[0] // world
  v = torch.from_numpy(x[rank * rows:(rank + 1) * rows].copy())
  out = {}
  for op in ("sum", "max", "min", "mean", "prod"):
    out[f"all_reduce_{op}"] = C.all_reduce(v, "data", op=op)
  out["all_gather"] = C.all_gather(v, "data")
  out["all_gather_untiled"] = C.all_gather(v, "data", tiled=False)
  out["reduce_scatter"] = C.reduce_scatter(C.all_gather(v, "data"), "data")
  out["broadcast"] = C.broadcast(v, "data", root=1)
  out["reduce"] = C.reduce(v, "data", root=1)
  out["ring_shift"] = C.ring_shift(v, "data", 1)
  out["ppermute"] = C.ppermute(v, "data", [(0, 1)])
  out["all_to_all"] = C.all_to_all(v, "data", split_axis=1, concat_axis=0)
  w = torch.from_numpy(np.arange(x.shape[1] * 3, dtype=np.float32)
                       .reshape(x.shape[1], 3) / 7)
  out["all_gather_matmul_ring"] = overlap.all_gather_matmul(
      v, w, "data", num_chunks=world)
  out["all_gather_matmul_fused"] = overlap.all_gather_matmul(v, w, "data")
  out["matmul_reduce_scatter_ring"] = overlap.matmul_reduce_scatter(
      v, w, "data", num_chunks=world)
  out["matmul_reduce_scatter_fused"] = overlap.matmul_reduce_scatter(
      v, w, "data")
  out["reduce_scatter_ring"] = overlap.reduce_scatter(v, "data",
                                                      num_chunks=world)
  from easyparallellibrary_tpu_torch.ops import distributed_ops
  from easyparallellibrary_tpu_torch.parallel.metrics import (
      merge_shard_metrics)
  out["gather_matmul"] = distributed_ops.gather_matmul(v, w, "data",
                                                       num_chunks=world)
  out["matmul_scatter"] = distributed_ops.matmul_scatter(v, w, "data",
                                                         num_chunks=world)
  for how in ("mean", "sum", "concat"):
    out[f"merge_{how}"] = merge_shard_metrics({"m": v.sum(1)}, how)["m"]
  blocks = {k: torch.from_numpy(a[rank * (a.shape[0] // world):
                                  (rank + 1) * (a.shape[0] // world)].copy())
            for k, a in tree.items()}
  for name, kw in (("fused", {}), ("tiny_buckets",
                                   dict(fusion_threshold_mb=0,
                                        max_splits=2)),
                   ("bf16_wire", dict(compress_dtype="bf16",
                                      compress_scale=4.0))):
    red = fusion.batch_all_reduce(blocks, "data", **kw)
    for k, t in red.items():
      out[f"batch_all_reduce_{name}_{k}"] = t
  # Gradients: d(sum(all_reduce(v) * coeff)) / dv and the same for the
  # gather and the scatter.
  for name, fn in (("all_reduce", lambda t: C.all_reduce(t, "data")),
                   ("all_gather", lambda t: C.all_gather(t, "data")),
                   ("reduce_scatter", lambda t: C.reduce_scatter(
                       t, "data")),
                   ("ring_shift", lambda t: C.ring_shift(t, "data", 1))):
    t = v.clone().requires_grad_(True)
    y = fn(t)
    coeff = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
    if name != "all_reduce":      # a replicated cotangent for the reduce
      coeff = coeff + rank
    (y * coeff).sum().backward()
    out[f"grad_{name}"] = t.grad
  return to_numpy(out)


def gpt_train_losses(rank, world, mesh_shape: str, cfg_kwargs: dict,
                     params: Dict[str, np.ndarray], batches, lr: float,
                     weight_decay: float = 0.01, device: str = "cpu",
                     backend: Optional[str] = None, timed: bool = False):
  """``len(batches)`` AdamW steps of ``gpt_loss`` through
  ``create_sharded_train_state`` / ``parallelize(make_train_step)`` on
  ``mesh_shape`` (a ``tensor_parallel`` model when the mesh has a model
  axis above 1), each rank fed the same global batches.  Returns the
  losses, and with ``timed`` the per-step ms and peak memory of the
  rank."""
  import time

  from easyparallellibrary_tpu_torch.models.gpt import GPT, gpt_loss
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, make_train_step, parallelize)
  from easyparallellibrary_tpu_torch.weights import shard_params
  mesh = setup(mesh_shape, device=device, backend=backend)
  tp = mesh.axis_size("model") > 1
  cfg = gpt_config(cfg_kwargs, tensor_parallel=tp)
  model = GPT(cfg)
  local = shard_params(to_torch(params, mesh.device), model)
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(lr, weight_decay=weight_decay)),
      mesh)
  step = parallelize(make_train_step(
      lambda p, b, r: gpt_loss(model, p, b, r)), mesh, shardings)
  losses, ms = [], []
  if mesh.device.type == "cuda":
    torch.cuda.reset_peak_memory_stats(mesh.device)
  for batch in batches:
    t0 = time.perf_counter()
    state, m = step(state, {"ids": np.asarray(batch)}, None)
    losses.append(float(m["loss"]))
    ms.append((time.perf_counter() - t0) * 1e3)
  out = {"losses": losses,
         "specs": {k: v for k, v in shardings.items() if v}}
  if timed:
    out["step_ms"] = ms
    if mesh.device.type == "cuda":
      out["peak_gib"] = torch.cuda.max_memory_allocated(mesh.device) / 2**30
  return out


def _mlp_loss(params, batch):
  """A two-layer MLP's softmax CE over (x, y): the DP / ZeRO model."""
  import torch.nn.functional as F

  from easyparallellibrary_tpu_torch.ops.losses import (
      distributed_sparse_softmax_cross_entropy_with_logits as ce)
  h = torch.relu(F.linear(batch["x"], params["Dense_0.weight"],
                          params["Dense_0.bias"]))
  logits = F.linear(h, params["Dense_1.weight"], params["Dense_1.bias"])
  return ce(batch["y"], logits).mean(), {}


def dp_train(rank, world, kind: str, params: Dict[str, np.ndarray],
             batches, lr: float, config: Optional[dict] = None,
             device: str = "cpu", backend: Optional[str] = None):
  """Data-parallel AdamW steps of :func:`_mlp_loss` over ``data:world``,
  every rank fed the same global batches: ``kind`` is ``"implicit"``
  (``make_train_step``), ``"guarded"`` (``runtime.trainer.
  build_train_step``), ``"explicit"`` (``make_explicit_dp_train_step``
  under ``config``'s ``communication.*``) or ``"zero1"``.  Returns the
  losses, the final parameters and the rank's optimizer moment bytes."""
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, make_train_step, parallelize)
  from easyparallellibrary_tpu_torch.parallel.explicit import (
      make_explicit_dp_train_step)
  from easyparallellibrary_tpu_torch.runtime import zero
  mesh = setup(f"data:{world}", device=device, backend=backend,
               config=config)
  tx = adamw(lr, weight_decay=0.0)
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=None,
                                params=to_torch(params, mesh.device), tx=tx),
      mesh, zero_level="v1" if kind == "zero1" else "")

  def loss_fn(p, b, r):
    return _mlp_loss(p, b)

  if kind == "implicit":
    step = parallelize(make_train_step(loss_fn), mesh, shardings)
  elif kind == "guarded":
    from easyparallellibrary_tpu_torch.runtime.trainer import (
        build_train_step)
    step = parallelize(build_train_step(loss_fn), mesh, shardings)
  elif kind == "explicit":
    step = make_explicit_dp_train_step(loss_fn, mesh)
  else:
    step = zero.make_zero1_train_step(loss_fn, mesh)
  losses = []
  for x, y in batches:
    state, m = step(state, {"x": np.asarray(x), "y": np.asarray(y)}, None)
    losses.append(float(m["loss"]))
  return {"losses": losses, "params": to_numpy(dict(state.params)),
          "moment_bytes": zero.moment_bytes(state.opt_state)}


def clipped_adamw(lr: float = 1e-2):
  """An optimizer recipe that clips the gradients by their global norm
  before AdamW's step: it couples every position, so ZeRO refuses it."""
  from easyparallellibrary_tpu_torch.ops.adamw import Recipe, adamw
  inner = adamw(lr)

  class Clipped(torch.optim.Optimizer):
    def __init__(self, named):
      self.opt = inner.init(named)
      self.named = named
      super().__init__(list(named.values()), {})
      self.state = self.opt.state

    def step(self, closure=None):
      torch.nn.utils.clip_grad_norm_(list(self.named.values()), 1.0)
      return self.opt.step(closure)

  return Recipe(lambda named, fused=None: Clipped(named))


def zero_refuses_coupled_optimizer(rank, world, params):
  """The ZeRO-1 step's message for an optimizer that clips by a global
  norm (it couples every position)."""
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state)
  from easyparallellibrary_tpu_torch.runtime import zero
  mesh = setup(f"data:{world}")
  state, _ = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=None, params=to_torch(params,
                                                               "cpu"),
                                tx=clipped_adamw()), mesh, zero_level="v1")
  step = zero.make_zero1_train_step(lambda p, b, r: _mlp_loss(p, b), mesh)
  try:
    step(state, {"x": np.zeros((2, 16), np.float32),
                 "y": np.zeros((2,), np.int64)}, None)
  except ValueError as e:
    return str(e)
  return ""


def dense_layers(rank, world, params: Dict[str, np.ndarray], x: np.ndarray,
                 ids: np.ndarray, labels: np.ndarray, sizes: dict):
  """The tensor-parallel layers at ``model:world`` on JAX-layout
  parameters: a column Dense (output gathered), a column -> relu -> row
  chain (row input this rank's block), a row Dense on a replicated
  input, the vocab Embedding's lookup and tied logits, the
  vocab-parallel CE and its gradient wrt the (gathered) logits, and a
  bf16 confident-label CE gradient."""
  from easyparallellibrary_tpu_torch.ops import bridging
  from easyparallellibrary_tpu_torch.ops.distributed_ops import (
      distributed_argmax)
  from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding
  from easyparallellibrary_tpu_torch.ops.losses import (
      distributed_sparse_softmax_cross_entropy_with_logits as ce)
  from easyparallellibrary_tpu_torch.weights import _block
  setup(f"model:{world}")
  d_in, hidden, out_dim, vocab = (sizes["in"], sizes["hidden"], sizes["out"],
                                  sizes["vocab"])
  res = {}

  def load(layer, prefix, kind):
    w = torch.from_numpy(np.array(params[prefix + "kernel"]).T.copy())
    b = torch.from_numpy(np.array(params[prefix + "bias"]))
    if kind == "column":
      layer.weight.data = _block(w, 0, layer.features, world, rank)
      layer.bias.data = _block(b, 0, layer.features, world, rank)
    else:
      layer.weight.data = _block(w, 1, layer.in_features, world, rank)
      layer.bias.data = b
    return layer

  col = load(Dense(d_in, hidden, parallel="column"), "col/", "column")
  row = load(Dense(hidden, out_dim, parallel="row"), "row/", "row")
  xt = torch.from_numpy(x).requires_grad_(True)
  h = col(xt)
  res["column"] = bridging.split_to_replica(h, logical=hidden)
  y = row(torch.relu(h))
  res["column_row"] = y
  (y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
  res["column_row_dx"] = xt.grad
  res["row_replicated_in"] = row(torch.from_numpy(
      np.maximum(x @ np.array(params["col/kernel"]) + np.array(
          params["col/bias"]), 0)[..., :hidden].copy()))
  emb = Embedding(vocab, d_in, parallel="vocab")
  table = torch.from_numpy(np.array(params["emb/embedding"]))
  emb.weight.data = _block(table, 0, vocab, world, rank)
  res["embed"] = emb(torch.from_numpy(ids).long())
  logits = emb.attend(torch.from_numpy(x))
  res["attend"] = bridging.split_to_replica(logits, logical=vocab)
  res["argmax"] = distributed_argmax(logits, vocab_size=vocab)
  lg = logits.detach().requires_grad_(True)
  loss = ce(torch.from_numpy(labels).long(), lg, vocab_size=vocab)
  res["ce"] = loss
  loss.sum().backward()
  res["ce_grad"] = bridging.split_to_replica(lg.grad, logical=vocab)
  confident = torch.zeros((1, 4 // world), dtype=torch.bfloat16)
  if rank == 0:
    confident[0, 0] = 10.0
  confident.requires_grad_(True)
  ce(torch.zeros((1,), dtype=torch.long), confident).sum().backward()
  res["bf16_label_grad"] = confident.grad[0, 0].float() if rank == 0 else \
      torch.tensor(0.0)
  return to_numpy(res)


def row_dense_overlap(rank, world, x: np.ndarray, w: np.ndarray,
                      b: np.ndarray):
  """A row-parallel Dense at ``model:world`` through the overlap ring
  (``communication.overlap="on"``) and fused (``"off"``): the outputs
  and the input and weight gradients of each."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.ops.layers import Dense
  from easyparallellibrary_tpu_torch.weights import _block
  setup(f"model:{world}")
  out = {}
  for policy in ("off", "on"):
    epl.Env.get().config.communication.overlap = policy
    layer = Dense(w.shape[0], w.shape[1], parallel="row")
    layer.weight.data = _block(torch.from_numpy(w.T.copy()), 1, w.shape[0],
                               world, rank)
    layer.bias.data = torch.from_numpy(b)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    out[policy] = {"y": y, "dx": xt.grad, "dw": layer.weight.grad}
  return to_numpy(out)


def resume_disagreement(rank, world, root: str):
  """``fit`` resumed by two ranks that read different chains: rank 1
  reads a copy of the shared checkpoint directory whose newest
  checkpoint is gone (as a transient read error would make it fall
  back).  Returns the error each rank raised ("" for none)."""
  import os
  import shutil

  import torch.distributed as dist

  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import TrainState
  from easyparallellibrary_tpu_torch.runtime import loop
  setup(f"data:{world}")
  shared = os.path.join(root, "shared")
  data = [{"x": np.zeros(1, np.float32)}] * 8

  def step_fn(s, batch, rng):
    s.step = s.step + 1
    return s, {"loss": torch.zeros(())}

  def fresh():
    return TrainState.create(apply_fn=None, params={"w": torch.ones(4)},
                             tx=adamw(0.1))

  loop.fit(step_fn, fresh(), data, num_steps=3, checkpoint_dir=shared,
           checkpoint_every=1, log_every=0, device="cpu")
  ckpt = shared
  if rank == 1:
    ckpt = os.path.join(root, "rank1")
    shutil.copytree(shared, ckpt)
    newest = sorted(d for d in os.listdir(ckpt) if d.startswith("step_"))
    shutil.rmtree(os.path.join(ckpt, newest[-1]))
  dist.barrier()
  try:
    loop.fit(step_fn, fresh(), data, num_steps=6, checkpoint_dir=ckpt,
             checkpoint_every=0, log_every=0, device="cpu")
  except RuntimeError as e:
    return str(e)
  return ""


def imported_modules(rank, world):
  """The top-level modules this rank has imported after a
  tensor-parallel forward and backward of a small GPT (the hygiene
  check that a worker never loads JAX)."""
  import sys

  from easyparallellibrary_tpu_torch.models.gpt import GPT, gpt_loss
  from easyparallellibrary_tpu_torch.weights import init_params, shard_params
  setup("model:2")
  cfg = gpt_config(dict(vocab_size=32, num_layers=1, num_heads=2,
                        d_model=8, d_ff=16, max_seq_len=8),
                   tensor_parallel=True)
  whole = init_params(gpt_config(dict(vocab_size=32, num_layers=1,
                                      num_heads=2, d_model=8, d_ff=16,
                                      max_seq_len=8)), 0, device="cpu")
  model = GPT(cfg)
  local = {k: v.requires_grad_(True)
           for k, v in shard_params(whole, model).items()}
  loss, _ = gpt_loss(model, local, {"ids": torch.zeros((1, 5),
                                                       dtype=torch.long)})
  loss.backward()
  return sorted({m.split(".")[0] for m in sys.modules})


def row_dense_site_bytes(rank, world, rows: int, d_in: int, d_out: int):
  """The row-parallel Dense site measured with ``torch.profiler``
  (``observability.device.profile_site_bytes``) at ``model:world`` with
  the introspector on and ``communication.overlap="auto"``: the bytes
  measured, and the measurement the overlap policy then reads for the
  site."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.observability import device as dev
  from easyparallellibrary_tpu_torch.ops.layers import Dense
  from easyparallellibrary_tpu_torch.parallel.planner import SITE_ROW_DENSE
  setup(f"model:{world}")
  dev.install(dev.DeviceIntrospector())
  try:
    epl.Env.get().config.communication.overlap = "auto"
    layer = Dense(d_in, d_out, parallel="row")
    torch.nn.init.normal_(layer.weight)
    torch.nn.init.zeros_(layer.bias)
    x = torch.ones(rows, d_in)
    layer(x)                      # registers the site (auto policy)
    wire = dev.profile_site_bytes(SITE_ROW_DENSE, lambda: layer(x))
    return {"wire": wire,
            "read_back": dev.measured_collective_bytes(SITE_ROW_DENSE),
            "registered": SITE_ROW_DENSE in dev.get_introspector().sites()}
  finally:
    dev.install(None)


def row_dense_collectives(mesh, rows: int, d_in: int, d_out: int,
                          dtype: str = "float32"):
  """``profiler.flops.collective_op_sizes`` of one forward of a
  row-parallel Dense at the fused all-reduce
  (``communication.overlap="off"`` for the call) on ``mesh``'s model
  axis, and their sum (``collective_bytes``)."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.ops.layers import Dense
  from easyparallellibrary_tpu_torch.profiler import flops
  config = epl.Env.get().config
  policy, config.communication.overlap = config.communication.overlap, "off"
  try:
    layer = Dense(d_in, d_out, parallel="row", dtype=getattr(torch, dtype),
                  device=mesh.device)
    x = torch.ones(rows, d_in // mesh.axis_size("model"),
                   device=mesh.device, dtype=getattr(torch, dtype))
    with torch.no_grad():
      sizes = flops.collective_sizes_of(layer, x)
      total = flops.collective_bytes(layer, x)
  finally:
    config.communication.overlap = policy
  return {"sizes": sizes, "bytes": total}


def row_dense_collective_sizes(rank, world, rows: int, d_in: int,
                               d_out: int, device: str = "cpu",
                               backend: Optional[str] = None,
                               dtype: str = "float32"):
  """:func:`row_dense_collectives` at ``model:world``."""
  mesh = setup(f"model:{world}", device=device, backend=backend)
  return row_dense_collectives(mesh, rows, d_in, d_out, dtype)


# ------------------------------------------------------- the card's phase


def _sync(dev) -> None:
  if torch.device(dev).type == "cuda":
    torch.cuda.synchronize(dev)


def lead_waves(eng, prompts, waves, steps_between: int = 3,
               max_new: int = 32):
  """Submit each wave of ``waves`` (index ranges), stepping
  ``steps_between`` times after every wave but the last, then run until
  the queue drains (``chip_smoke.py``'s staggered loads).  Returns
  ``{index: tokens}``."""
  from easyparallellibrary_tpu_torch.serving import Request
  out = {}
  for w, (a, b) in enumerate(waves):
    for i in range(a, b):
      eng.submit(Request(uid=i, prompt=np.asarray(prompts[i], np.int32),
                         max_new_tokens=max_new))
    for _ in range(steps_between if w < len(waves) - 1 else 0):
      for fin in eng.step():
        out[fin.uid] = fin.tokens
  out.update(eng.run())
  return out


def nccl_probe(rank, world):
  """Whether NCCL takes ``world`` ranks on this machine's cards (ranks
  share cards round-robin): an all-reduce of one float, or the error."""
  import datetime
  import os

  import torch.distributed as dist
  dev = torch.device("cuda", rank % torch.cuda.device_count())
  torch.cuda.set_device(dev)
  try:
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    x = torch.ones(1, device=dev)
    dist.all_reduce(x)
    _sync(dev)
    out = f"ok (all_reduce {x.item():g})"
  except Exception as e:  # noqa: BLE001 — the probe reports the refusal
    out = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
  finally:
    if dist.is_initialized():
      dist.destroy_process_group()
  return out


def _serve(eng, prompts, waves, steps_between, pa):
  """Drive ``eng`` (leader) or follow (other ranks) with the paged
  kernel's counts set to 0 just before; the rank's launch counts,
  steps, wall and (leader) streams and stats."""
  import time
  dev = eng.device
  pa.reset_counts()
  _sync(dev)
  t0 = time.monotonic()
  if eng.is_leader:
    try:
      out = lead_waves(eng, prompts, waves, steps_between)
    finally:
      eng.close()
    steps = eng.steps
  else:
    out, steps = None, eng.follow()
  _sync(dev)
  wall = time.monotonic() - t0
  rec = {"steps": steps, "wall_s": wall,
         "host_ms_per_step": wall / max(steps, 1) * 1e3,
         "tiled_launches": pa.paged_attention_tiled_cuda.launches,
         "all_launches": pa.paged_attention_cuda.launches,
         "plain_calls": pa.paged_attention_reference.calls}
  if eng.is_leader:
    rec["streams"] = {k: np.asarray(v) for k, v in out.items()}
    if eng.stats is not None:
      rec["stats"] = eng.stats.summary()
    rec["prefix_hits"] = eng.scheduler.prefix_hits
    rec["drafted"] = rec.get("stats", {}).get("drafted_tokens", 0)
  return rec


def _serve_runs(rank, mesh, cfg, local, runs: dict, engine_kwargs: dict):
  """For each of ``runs`` (name -> (prompts, waves, steps_between,
  n-gram k or 0, prefix_cache)) a paged engine of ``cfg`` over
  ``local`` on ``mesh``, driven by rank 0 and followed by the others."""
  from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, NgramDrafter)
  out = {}
  for name, (prompts, waves, between, drafter, prefix) in runs.items():
    eng = ContinuousBatchingEngine(
        GPT(cfg), local, mesh=mesh, paged=True, prefix_cache=prefix,
        drafter=NgramDrafter(k=drafter) if drafter else None,
        stats=ServingStats() if rank == 0 else None, **engine_kwargs)
    out[name] = _serve(eng, prompts, waves, between, pa)
    out[name]["kv_heads"] = int(
        eng._kv["block_0"]["attn"]["cached_key"].shape[2])
    del eng
  return out


def chip_tp_serving(rank, world, backend: str, cfg_kwargs: dict, seed: int,
                    runs: dict, engine_kwargs: dict, device: str = "cuda"):
  """TP serving: :func:`_serve_runs` over the rank's shard of
  ``init_params(seed)`` at ``model:world``."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.weights import init_params, shard_params
  mesh = setup(f"model:{world}", device=device, backend=backend)
  cfg = gpt_config(cfg_kwargs, tensor_parallel=True)
  local = shard_params(init_params(gpt_config(cfg_kwargs), seed,
                                   device=mesh.device), GPT(cfg))
  return _serve_runs(rank, mesh, cfg, local, runs, engine_kwargs)


def train_steps(mesh, cfg_kwargs: dict, params, batch: np.ndarray,
                steps: int):
  """``bench.py``'s training step (bf16 over fp32 parameters, AdamW(3e-4,
  weight_decay=0.01), flash attention, remat ``dots_flash``,
  ``loss_chunk``) on ``mesh`` (tensor-parallel on a model axis above 1),
  ``steps`` times on one batch, from a copy of ``params`` (whole, or the
  rank's shard; of a deeper model, its first blocks): the losses, each
  step's ms, the rank's peak memory and its flash launches over the
  steps (counts set to 0 just before)."""
  import time

  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.models.gpt import GPT, gpt_loss
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, make_train_step, parallelize)
  from easyparallellibrary_tpu_torch.weights import local_params
  torch.backends.cuda.matmul.allow_tf32 = False
  dev = mesh.device
  cfg = gpt_config(cfg_kwargs, tensor_parallel=mesh.axis_size("model") > 1)
  model = GPT(cfg)
  local = local_params(model, params, mesh)
  # The model's leaves: a config of fewer layers takes the first blocks.
  local = {n: local[n] for n, _ in model.named_parameters()}
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(3e-4, weight_decay=0.01)), mesh)
  step = parallelize(make_train_step(
      lambda p, b, r: gpt_loss(model, p, b, r)), mesh, shardings)
  data = {"ids": torch.from_numpy(batch)}
  _sync(dev)
  if dev.type == "cuda":
    torch.cuda.reset_peak_memory_stats(dev)
  fa.reset_counts()
  losses, ms = [], []
  for _ in range(steps):
    t0 = time.perf_counter()
    state, m = step(state, data, None)
    losses.append(float(m["loss"]))
    ms.append((time.perf_counter() - t0) * 1e3)
  return {"losses": losses, "step_ms": ms,
          "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                       if dev.type == "cuda" else None),
          "launches": {"fwd": fa.flash_fwd_cuda.launches,
                       "dkv": fa.flash_bwd_dkv_cuda.launches,
                       "dq": fa.flash_bwd_dq_cuda.launches},
          "plain_calls": fa.flash_fwd_reference.calls
          + fa.flash_bwd_dkv_reference.calls + fa.flash_bwd_dq_reference.calls,
          "heads_per_rank": model.block_0.attn.heads}


def dp_steps(mesh, kind: str, cfg_kwargs: dict, batches, seed: int = 0):
  """Data-parallel training of a GPT on ``mesh`` (``data`` axis; one
  rank: one process on the whole batch): ``kind`` is ``"explicit"`` (the
  fusion buckets of ``communication.*``), ``"zero1"`` or ``"implicit"``.
  Returns the losses, the rank's optimizer moment bytes and each step's
  ms."""
  import time

  from easyparallellibrary_tpu_torch.models.gpt import GPT, gpt_loss
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, make_train_step, parallelize)
  from easyparallellibrary_tpu_torch.parallel.explicit import (
      make_explicit_dp_train_step)
  from easyparallellibrary_tpu_torch.runtime import zero
  from easyparallellibrary_tpu_torch.weights import init_params
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = gpt_config(cfg_kwargs)
  model = GPT(cfg)
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(
          apply_fn=model, params=init_params(cfg, seed, device=mesh.device),
          tx=adamw(3e-4, weight_decay=0.01)),
      mesh, zero_level="v1" if kind == "zero1" else "")

  def loss_fn(p, b, r):
    return gpt_loss(model, p, b, r)

  if kind == "explicit":
    step = make_explicit_dp_train_step(loss_fn, mesh)
  elif kind == "zero1":
    step = zero.make_zero1_train_step(loss_fn, mesh)
  else:
    step = parallelize(make_train_step(loss_fn), mesh, shardings)
  losses, ms = [], []
  for batch in batches:
    t0 = time.perf_counter()
    state, m = step(state, {"ids": np.asarray(batch)}, None)
    losses.append(float(m["loss"]))
    ms.append((time.perf_counter() - t0) * 1e3)
  return {"losses": losses, "step_ms": ms,
          "moment_bytes": zero.moment_bytes(state.opt_state)}


def _collectives_and_ring(rank, world, mesh, x: np.ndarray, dense: dict):
  """Every collective of :func:`collectives_suite` on this rank's block
  of ``x`` on the mesh's device, and one row-parallel Dense (``dense``:
  rows, d_in, d_out, a seed) through the overlap ring against
  ``overlap="off"`` (output and gradients), with each path's ms."""
  import time

  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.communicators import (
      collectives as C, overlap)
  from easyparallellibrary_tpu_torch.ops.layers import Dense
  from easyparallellibrary_tpu_torch.weights import _block
  dev = mesh.device
  rows = x.shape[0] // world
  v = torch.from_numpy(x[rank * rows:(rank + 1) * rows].copy()).to(dev)
  ax = "model"
  res = {}
  for op in ("sum", "max", "min", "mean", "prod"):
    res[f"all_reduce_{op}"] = C.all_reduce(v, ax, op=op)
  res["all_gather"] = C.all_gather(v, ax)
  res["reduce_scatter"] = C.reduce_scatter(C.all_gather(v, ax), ax)
  res["broadcast"] = C.broadcast(v, ax, root=1)
  res["reduce"] = C.reduce(v, ax, root=1)
  res["ring_shift"] = C.ring_shift(v, ax, 1)
  res["all_to_all"] = C.all_to_all(v, ax, split_axis=1, concat_axis=0)
  w = torch.from_numpy(np.arange(x.shape[1] * 3, dtype=np.float32)
                       .reshape(x.shape[1], 3) / 7).to(dev)
  res["all_gather_matmul_ring"] = overlap.all_gather_matmul(
      v, w, ax, num_chunks=world)
  res["matmul_reduce_scatter_ring"] = overlap.matmul_reduce_scatter(
      v, w, ax, num_chunks=world)
  out = {"collectives": to_numpy(res)}
  r = np.random.RandomState(dense["seed"])
  xd = torch.from_numpy(r.randn(dense["rows"], dense["d_in"]).astype(
      np.float32)).to(dev, torch.bfloat16)
  wd = torch.from_numpy((r.randn(dense["d_in"], dense["d_out"]) /
                         np.sqrt(dense["d_in"])).astype(np.float32))
  ring = {}
  config = epl.Env.get().config
  for policy in ("off", "on"):
    config.communication.overlap = policy
    layer = Dense(dense["d_in"], dense["d_out"], parallel="row",
                  dtype=torch.bfloat16, device=dev)
    layer.weight.data = _block(wd.t().contiguous(), 1, dense["d_in"],
                               world, rank).to(dev)
    torch.nn.init.zeros_(layer.bias)
    xt = xd.clone().requires_grad_(True)
    y = layer(xt)
    y.float().sum().backward()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
      layer(xd)
    _sync(dev)
    ring[policy] = {"y": y, "dx": xt.grad, "dw": layer.weight.grad,
                    "ms": (time.perf_counter() - t0) / 5 * 1e3}
  config.communication.overlap = "auto"
  out["ring"] = to_numpy(ring)
  return out


def chip_tp_suite(rank, world, backend: str, spec: dict,
                  device: str = "cuda"):
  """Phases 21 and 22 on the ranks, in one group (each rank started
  once), each part run where ``spec`` holds it: at ``model:world`` the
  collectives and the overlap ring (``spec["collectives"]``: x, dense),
  TP serving (``spec["serving"]``: cfg_kwargs, seed, runs, engine_kwargs
  and optionally the serving depth) and ``bench.py``'s training step
  (``spec["training"]``: cfg_kwargs, batch, steps) over one draw of
  ``init_params(seed)``; at
  ``data:world`` explicit DP and ZeRO-1 (``spec["dp"]``: cfg_kwargs,
  batches, the explicit step's config); at ``stage:world`` the
  pipeline runs (``spec["pipeline"]``, ``pp_workers.chip_pipeline``);
  phase 23's a2a MoE at ``expert:world`` (``spec["moe"]``) and
  sequence-parallel runs at ``seq:world`` (``spec["sequence"]``,
  ``sp_workers.chip_moe_a2a`` / ``chip_sequence``); and phase 24's
  BERT pipeline and ResNet split head (``spec["p24"]``,
  ``bert_workers.chip_phase24``); phase 26's sharded checkpoints
  (``spec["p26"]["runs"]``: ``ckpt_workers.train_resume``'s arguments,
  one run a mesh)."""
  import gc

  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.weights import init_params, shard_params
  out, flat = {}, None
  if "collectives" in spec:
    mesh = setup(f"model:{world}", device=device, backend=backend)
    out = _collectives_and_ring(rank, world, mesh, *spec["collectives"])
    if "row_dense" in spec:
      out["row_dense_collectives"] = row_dense_collectives(
          mesh, dtype="bfloat16", **spec["row_dense"])
    cfg_kwargs, seed, runs, engine_kwargs, *layers = spec["serving"]
    # The draw at cfg_kwargs' depth (the pipeline's and the sequence
    # runs' too); serving at the first ``layers`` blocks of it, if given.
    serve_kwargs = dict(cfg_kwargs, num_layers=layers[0]) if layers \
        else cfg_kwargs
    cfg = gpt_config(serve_kwargs, tensor_parallel=True)
    whole = init_params(gpt_config(cfg_kwargs), seed, device=mesh.device)
    names = {n for n, _ in GPT(gpt_config(serve_kwargs)).named_parameters()}
    local = shard_params({k: v for k, v in whole.items() if k in names},
                         GPT(cfg))
    if seed in (spec.get("pipeline", {}).get("seed"),
                spec.get("sequence", {}).get("seed")):
      # The pipeline and sequence runs start from the same draw: keep it
      # on the host.
      flat = {k: v.cpu() for k, v in whole.items()}
    del whole
    out["serving"] = _serve_runs(rank, mesh, cfg, local, runs,
                                 engine_kwargs)
    gc.collect()
    train_cfg, batch, steps = spec["training"]
    out["training"] = train_steps(mesh, train_cfg, local, batch, steps)
    del local
    gc.collect()
    if torch.device(device).type == "cuda":
      torch.cuda.empty_cache()
    dp_cfg, batches, config = spec["dp"]
    for kind, conf in (("explicit", config), ("zero1", None)):
      mesh = setup(f"data:{world}", device=device, backend=backend,
                   config=conf)
      out[kind] = dp_steps(mesh, kind, dp_cfg, batches)
  if "pipeline" in spec:
    from easyparallellibrary_tpu_torch.testing import pp_workers
    gc.collect()
    if torch.device(device).type == "cuda":
      torch.cuda.empty_cache()
    out["pipeline"] = pp_workers.chip_pipeline(rank, world, backend,
                                               spec["pipeline"], device, flat)
  if "moe" in spec or "sequence" in spec:
    import time

    from easyparallellibrary_tpu_torch.testing import sp_workers
    t0 = time.monotonic()
    gc.collect()
    out["moe"] = sp_workers.chip_moe_a2a(rank, world, backend, spec["moe"],
                                         device)
    out["sequence"] = sp_workers.chip_sequence(rank, world, backend,
                                               spec["sequence"], device, flat)
    out["p23_wall_s"] = time.monotonic() - t0
  if "p24" in spec:
    from easyparallellibrary_tpu_torch.testing import bert_workers
    gc.collect()
    if torch.device(device).type == "cuda":
      torch.cuda.empty_cache()
    out["p24"] = bert_workers.chip_phase24(rank, world, backend,
                                           spec["p24"], device)
  if "p26" in spec:
    import time

    from easyparallellibrary_tpu_torch.testing import ckpt_workers
    t0 = time.monotonic()
    runs = []
    for args in spec["p26"]["runs"]:
      gc.collect()
      if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
      runs.append(ckpt_workers.train_resume(rank, world, *args))
    out["p26"] = {"runs": runs, "wall_s": time.monotonic() - t0}
  return out
