"""Rank programs for the sharded-checkpoint and automatic-placement tests
and ``chip_smoke.py`` phase 26.

As in ``tp_workers``: each runs on one rank of ``utils.launcher.spawn``
as ``fn(rank, world_size, *args)``, numpy in and numpy out, starts the
group through ``epl.init`` (``tp_workers.setup``; several meshes may
follow each other in one group) and imports nothing of JAX.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from easyparallellibrary_tpu_torch.testing.tp_workers import (
    gpt_config, setup, to_numpy, to_torch)


class DenseNet(nn.Module):
  """One ``Dense_0(d_in, features)``, built in a ``split`` scope when
  ``split`` (its default ``parallel="auto"``: column-parallel on a model
  axis above 1), else ``parallel="none"``: the JAX saver tests' ``Net``
  and ``UnevenNet``.  ``forward`` gives the whole output."""

  def __init__(self, d_in: int, features: int, split: bool):
    super().__init__()
    import easyparallellibrary_tpu_torch as epl
    from easyparallellibrary_tpu_torch.ops.layers import Dense
    self.features = features
    if split:
      with epl.split():
        self.Dense_0 = Dense(d_in, features)
    else:
      self.Dense_0 = Dense(d_in, features, parallel="none")

  def forward(self, x):
    from easyparallellibrary_tpu_torch.ops import bridging
    y = self.Dense_0(x)
    if self.Dense_0.parallel == "column":
      y = bridging.split_to_replica(y, dim=-1, logical=self.features)
    return y


class AutoNet(nn.Module):
  """JAX ``tests/test_split_tp.py``'s ``AutoNet``: three Dense layers
  with no ``parallel=``, built in one ``split`` scope; the logits are
  this rank's vocab block when the last layer is column-parallel."""

  def __init__(self, d_in: int = 16, hidden: int = 64, vocab: int = 96):
    super().__init__()
    import easyparallellibrary_tpu_torch as epl
    from easyparallellibrary_tpu_torch.ops.layers import Dense
    with epl.split():
      self.Dense_0 = Dense(d_in, hidden)
      self.Dense_1 = Dense(hidden, hidden)
      self.Dense_2 = Dense(hidden, vocab)

  def forward(self, x):
    h = torch.relu(self.Dense_0(x))
    h = torch.relu(self.Dense_1(h))
    return self.Dense_2(h)


def _named(module) -> Dict[str, torch.Tensor]:
  return dict(module.named_parameters())


def _zeroed(module):
  with torch.no_grad():
    for p in module.parameters():
      p.zero_()
  return module


# ------------------------------------------------ the layouts' contract


def fault_pin(rank, world, root: str):
  """A column-parallel ``Dense(16, 64)`` at ``model:world`` whose rank r
  holds r + 1 everywhere, saved and restored by its layouts: the block
  each rank restores."""
  from easyparallellibrary_tpu_torch.parallel.api import param_specs
  from easyparallellibrary_tpu_torch.runtime import saver
  setup(f"model:{world}")
  net = DenseNet(16, 64, split=True)
  with torch.no_grad():
    for p in net.parameters():
      p.fill_(rank + 1.0)
  specs = param_specs(net)
  saver.save_checkpoint(root, saver.params_tree(_named(net), specs), step=1)
  target = _named(_zeroed(DenseNet(16, 64, split=True)))
  got, step = saver.restore_params(root, target=target, shardings=specs,
                                   device="cpu")
  return {"step": step, **to_numpy(got)}


def layouts(rank, world, root: str, x: np.ndarray):
  """The JAX saver tests' layout cases on ``model:world``: the one-process
  checkpoints ``root/dp64`` (Dense 16 -> 64) and ``root/dp9`` (16 -> 9,
  padded to 10) restored into column-parallel nets, their outputs on
  ``x``, and the nets saved back by their layouts (``root/tp64``,
  ``root/tp9``); a save of a leaf without a layout, and a restore of
  ``dp9`` by a spec that attests no logical shape (both must raise)."""
  from easyparallellibrary_tpu_torch.parallel.api import param_specs
  from easyparallellibrary_tpu_torch.runtime import saver
  setup(f"model:{world}")
  out = {}
  xt = torch.from_numpy(x)
  for features in (64, 9):
    net = _zeroed(DenseNet(16, features, split=True))
    specs = param_specs(net)
    got, _ = saver.restore_params(os.path.join(root, f"dp{features}"),
                                  target=_named(net), shardings=specs,
                                  device="cpu")
    with torch.no_grad():
      for name, p in net.named_parameters():
        p.copy_(got[name])
      out[f"y{features}"] = net(xt).numpy()
    out[f"blocks{features}"] = to_numpy(got)
    out[f"logical{features}"] = specs["Dense_0.weight"].logical_shape
    saver.save_checkpoint(os.path.join(root, f"tp{features}"),
                          saver.params_tree(_named(net), specs), step=1)
  try:
    saver.save_checkpoint(os.path.join(root, "bare"),
                          {"w": torch.ones(2)}, step=1)
    out["bare_error"] = ""
  except ValueError as e:
    out["bare_error"] = str(e)
  net = _zeroed(DenseNet(16, 9, split=True))
  try:
    saver.restore_params(os.path.join(root, "dp9"), target=_named(net),
                         shardings={"Dense_0.weight": ("model", None)},
                         device="cpu")
    out["unattested_error"] = ""
  except ValueError as e:
    out["unattested_error"] = str(e)
  return out


# -------------------------------------------------- training and resume


def _snapshot(state) -> Dict[str, torch.Tensor]:
  """Copies of the state's parameters and the moments of what its
  optimizer steps (a ZeRO state's owner slices)."""
  from easyparallellibrary_tpu_torch.runtime.saver import _owner
  out = {}
  for name, p in state.params.items():
    out[name] = p.detach().clone()
    st = state.opt_state.state.get(_owner(state, name), {})
    for key in ("exp_avg", "exp_avg_sq"):
      if key in st:
        out[f"{key}/{name}"] = st[key].detach().clone()
  return out


def _differing(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
  """The names whose tensors are not bit-equal (a missing name counts)."""
  return sorted(k for k in set(a) | set(b)
                if k not in a or k not in b or not torch.equal(a[k], b[k]))


class _RssPeak:
  """This process's peak resident memory above its level at entry,
  sampled every 5 ms from ``/proc/self/statm`` (0 where it is absent)."""

  def __enter__(self):
    self.page = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 0
    self.base = self._rss()
    self.peak = self.base
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._run, daemon=True)
    self._thread.start()
    return self

  def _rss(self) -> int:
    try:
      with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * self.page
    except (OSError, ValueError, IndexError):
      return 0

  def _run(self):
    while not self._stop.wait(0.005):
      self.peak = max(self.peak, self._rss())

  def __exit__(self, *exc):
    self._stop.set()
    self._thread.join()
    self.peak = max(self.peak, self._rss())
    self.bytes = self.peak - self.base
    return False


def train_resume(rank, world, mesh_shape: str, cfg_kwargs: dict,
                 params, batches, root: str,
                 split: int, config: Optional[dict] = None,
                 lr: float = 1e-2, held: Optional[np.ndarray] = None,
                 device: str = "cpu", backend: Optional[str] = None):
  """``fit`` of ``make_gpt_train_step`` on ``mesh_shape`` (a
  tensor-parallel GPT on a model axis above 1, the pipelined layout of
  ``pipeline_stages``; ``config``: ``zero.level``, the pipeline engine)
  from the whole ``params`` (or ``init_params`` of the unpipelined
  config drawn from the seed ``params``), AdamW(``lr``, weight_decay
  0.01): a run that
  checkpoints at step ``split`` into ``root`` and goes on to
  ``len(batches)`` steps, then a fresh state that restores the
  checkpoint and resumes to the end.  Returns both runs' losses and step
  ms; the names (parameters, ``exp_avg/<name>``, ``exp_avg_sq/<name>``)
  whose restored values differ from the saving run's at ``split``, and
  whose final values differ between the runs; rank 0's index of the
  checkpoint (``{path: shape}``); the save's seconds, bytes gathered and
  host bytes held (the saver's count and the process's resident peak),
  the restore's seconds; K1's launches and plain calls over the saving
  run beside their formula (a layer's launch a step, or the 1F1B
  table's a stage rank); and the loss of the restored state on ``held``
  (a batch), when given."""
  import json

  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.models.gpt import (
      GPT, gpt_loss, make_gpt_train_step)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, local_batch, mean_loss,
      parallelize, state_shardings)
  from easyparallellibrary_tpu_torch.runtime import loop, saver
  from easyparallellibrary_tpu_torch.parallel.schedule_1f1b import (
      one_f_one_b_schedule)
  from easyparallellibrary_tpu_torch.weights import (
      init_params, local_params, stack_stages)
  mesh = setup(mesh_shape, device=device, backend=backend, config=config)
  cfg = gpt_config(cfg_kwargs, tensor_parallel=mesh.axis_size("model") > 1)
  model = GPT(cfg)
  if isinstance(params, int):
    flat = {k: v for k, v in cfg_kwargs.items()
            if k not in ("pipeline_stages", "num_micro_batch")}
    whole = init_params(gpt_config(flat), params, device=mesh.device)
  else:
    whole = to_torch(params, mesh.device)
  if cfg.pipeline_stages > 1:
    whole = stack_stages(whole, cfg)
  local = local_params(model, whole, mesh)
  del whole
  step = parallelize(make_gpt_train_step(model), mesh, None)
  dev = mesh.device

  def fresh():
    return create_sharded_train_state(
        lambda: TrainState.create(apply_fn=model, params=local,
                                  tx=adamw(lr, weight_decay=0.01)), mesh)[0]

  def data(start_step=0):
    return [{"ids": b} for b in batches[start_step:]]

  losses: List[float] = []
  ms: List[float] = []

  def recorded(state, batch, rng):
    t0 = time.perf_counter()
    state, m = step(state, batch, rng)
    losses.append(float(m["loss"]))
    ms.append((time.perf_counter() - t0) * 1e3)
    return state, m

  real_save = saver.save_checkpoint
  saves = []

  def measured_save(*args, **kwargs):
    with _RssPeak() as rss:
      out = real_save(*args, **kwargs)
    saves.append(dict(saver.last_save, rss_peak_bytes=rss.bytes))
    return out

  n = len(batches)
  fa.reset_counts()
  first = fresh()
  saver.save_checkpoint = measured_save
  try:
    first, _ = loop.fit(recorded, first, data, num_steps=split,
                        checkpoint_dir=root, checkpoint_every=split,
                        log_every=0, device=device)
  finally:
    saver.save_checkpoint = real_save
  at_split = _snapshot(first)
  first, _ = loop.fit(recorded, first, data, num_steps=n, log_every=0,
                      device=device)
  launches = {"fwd": fa.flash_fwd_cuda.launches,
              "dkv": fa.flash_bwd_dkv_cuda.launches,
              "dq": fa.flash_bwd_dq_cuda.launches}
  plain = {"fwd": fa.flash_fwd_reference.calls,
           "dkv": fa.flash_bwd_dkv_reference.calls,
           "dq": fa.flash_bwd_dq_reference.calls}
  if cfg.pipeline_stages > 1:
    per_step = one_f_one_b_schedule(cfg.pipeline_stages,
                                    cfg.num_micro_batch).launches_per_rank(
                                        cfg.num_layers // cfg.pipeline_stages)
  else:
    per_step = dict.fromkeys(launches, cfg.num_layers)
  formula = {k: v * n for k, v in per_step.items()}
  straight, straight_ms = list(losses), list(ms)
  losses.clear()
  ms.clear()
  resumed = fresh()
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)
  t0 = time.perf_counter()
  resumed, rstep = saver.restore_train_state(
      root, resumed, shardings=state_shardings(resumed))
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)
  restore_s = time.perf_counter() - t0
  restored_differ = _differing(_snapshot(resumed), at_split)
  del at_split
  held_loss = None
  if held is not None:
    with torch.no_grad():
      loss, _ = gpt_loss(model, resumed.params,
                         local_batch({"ids": held}, mesh), None)
      held_loss = float(mean_loss(loss, model))
  resumed, _ = loop.fit(recorded, resumed, data, num_steps=n,
                        checkpoint_dir=root, checkpoint_every=0,
                        log_every=0, device=device)
  index = None
  if rank == 0:
    with open(os.path.join(root, f"step_{split:08d}", "index.json")) as f:
      index = {p: info["shape"] for p, info in json.load(f)["leaves"].items()}
  return {"straight": straight, "resumed": list(losses), "rstep": rstep,
          "straight_ms": straight_ms, "resumed_ms": list(ms),
          "restored_differ": restored_differ,
          "final_differ": _differing(_snapshot(resumed), _snapshot(first)),
          "index": index, "save": saves[0], "restore_s": restore_s,
          "launches": launches, "formula": formula, "plain_calls": plain,
          "held_loss": held_loss,
          "specs": {k: tuple(v) for k, v in state_shardings(first).items()
                    if v}}


# --------------------------------------------------- across the packages


def _blocks(state) -> Dict[str, np.ndarray]:
  """:func:`_snapshot` as numpy arrays (fp32 states)."""
  return {k: v.cpu().numpy() for k, v in _snapshot(state).items()}


def interop(rank, world, mesh_shape: str, config: Optional[dict],
            cfg_kwargs: dict, params: Dict[str, np.ndarray], batches,
            jax_root: str, root: str):
  """The port's side of the checkpoints the JAX package reads and
  writes, on ``mesh_shape`` (``model:2``: tensor-parallel; ``data:2``
  with ``zero.level``: ZeRO): a fresh state restored from the JAX
  checkpoint ``jax_root`` (its blocks), then a state trained from
  ``params`` on ``batches`` and saved by its layouts to ``root`` (native)
  and ``root + "_dcp"`` (DCP) (its blocks and ZeRO owner dims), and the
  parameters ``restore_params(shardings=)`` and
  ``DraftModelDrafter.from_checkpoint(shardings=)`` read back from
  ``root`` (the names that differ from the trained state's)."""
  from easyparallellibrary_tpu_torch.models.gpt import (
      GPT, make_gpt_train_step)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, param_specs, parallelize,
      state_shardings)
  from easyparallellibrary_tpu_torch.runtime import saver
  from easyparallellibrary_tpu_torch.serving.speculative import (
      DraftModelDrafter)
  from easyparallellibrary_tpu_torch.weights import local_params
  mesh = setup(mesh_shape, config=config)
  cfg = gpt_config(cfg_kwargs, tensor_parallel=mesh.axis_size("model") > 1)
  model = GPT(cfg)
  local = local_params(model, to_torch(params, mesh.device), mesh)

  def fresh(values):
    return create_sharded_train_state(
        lambda: TrainState.create(apply_fn=model, params=values,
                                  tx=adamw(1e-2, weight_decay=0.01)), mesh)[0]

  restored, rstep = saver.restore_train_state(
      jax_root, fresh({k: torch.zeros_like(v) for k, v in local.items()}))
  state = fresh(local)
  step = parallelize(make_gpt_train_step(model), mesh, None)
  for b in batches:
    state, _ = step(state, {"ids": b}, None)
  layouts = state_shardings(state)
  saver.save_checkpoint(root, saver.state_tree(state, layouts),
                        step=len(batches))
  saver.save_checkpoint_orbax(root + "_dcp",
                              saver.state_tree(state, layouts),
                              step=len(batches))
  specs = param_specs(model)
  target = {k: torch.zeros_like(v) for k, v in state.params.items()}
  served, _ = saver.restore_params(root, target=target, shardings=specs,
                                   device="cpu")
  drafter = DraftModelDrafter.from_checkpoint(root, model, k=2, mesh=mesh,
                                              shardings=specs, device="cpu")
  trained = dict(state.params)
  zero = getattr(state, "zero", None)
  return {"restored": _blocks(restored), "rstep": rstep,
          "trained": _blocks(state),
          "dims": None if zero is None else dict(zero.dims),
          "served_differ": _differing(served, trained),
          "drafter_differ": _differing(drafter.params, trained)}


# ------------------------------------------------- automatic placement


def _sgd(lr: float):
  from easyparallellibrary_tpu_torch.ops.adamw import Recipe
  return Recipe(lambda params, fused=None: torch.optim.SGD(
      list(params.values()), lr=lr))


def split_auto(rank, world, jax_root: str, x: np.ndarray, y: np.ndarray,
               steps: int):
  """``AutoNet`` on ``model:world`` with ``auto.tensor_split`` off and on:
  each Dense's mode and spec, and ``steps`` SGD(0.1) losses of its
  vocab-parallel cross entropy from the JAX init in ``jax_root``
  (restored by the net's layouts); then an Embedding, explicit modes and
  a nested split built under ``split``."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding
  from easyparallellibrary_tpu_torch.ops.losses import (
      distributed_sparse_softmax_cross_entropy_with_logits as ce)
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, make_train_step, param_specs,
      parallelize)
  from easyparallellibrary_tpu_torch.runtime import saver
  out = {}
  for pairs in (False, True):
    mesh = setup(f"model:{world}", config={"auto.tensor_split": pairs})
    net = AutoNet()
    specs = param_specs(net)
    got, _ = saver.restore_params(jax_root, target=_named(net),
                                  shardings=specs, device="cpu")
    state, _ = create_sharded_train_state(
        lambda: TrainState.create(apply_fn=net, params=got, tx=_sgd(0.1)),
        mesh)

    def loss_fn(params, batch, rng, net=net):
      logits = torch.func.functional_call(net, params, (batch["x"],))
      return ce(batch["y"], logits, vocab_size=96).mean(), {}

    step = parallelize(make_train_step(loss_fn), mesh, None)
    losses = []
    for _ in range(steps):
      state, m = step(state, {"x": x, "y": y}, None)
      losses.append(float(m["loss"]))
    out[pairs] = {"modes": [getattr(net, f"Dense_{i}").parallel
                            for i in range(3)],
                  "specs": {k: tuple(v) for k, v in specs.items()},
                  "losses": losses}
  setup(f"model:{world}", config={"auto.tensor_split": True})
  with epl.split():
    emb = Embedding(64, 16)
    none = Dense(16, 8, parallel="none")
    row = Dense(16, 8, parallel="row")
    outer = Dense(16, 64)
    with epl.split():
      inner = Dense(64, 64)
      inner_emb = Embedding(64, 16)
    last = Dense(64, 32)
  with torch.no_grad():
    emb.weight.copy_(torch.arange(emb.weight.numel(), dtype=torch.float32)
                     .reshape(emb.weight.shape) + 1000.0 * rank)
    looked_up = emb(torch.tensor([[1, 2], [3, 40]]))
  out["layers"] = {
      "embedding": (emb.parallel, tuple(emb.weight.shape)),
      "lookup": looked_up.numpy(),
      "explicit_none": (none.parallel, tuple(none.weight.shape)),
      "explicit_row": (row.parallel, tuple(row.weight.shape)),
      "outer": (outer.parallel, tuple(outer.weight.shape)),
      "nested": (inner.parallel, tuple(inner.weight.shape)),
      "nested_embedding": (inner_emb.parallel, tuple(inner_emb.weight.shape)),
      "after_nested": (last.parallel, tuple(last.weight.shape))}
  return out


def suite(rank, world, cases):
  """Several of this module's programs in one group of ranks (each rank
  started once): ``cases`` is ``[(name, args)]``; returns each case's
  result, in order."""
  programs = {"fault_pin": fault_pin, "layouts": layouts,
              "train_resume": train_resume, "interop": interop,
              "split_auto": split_auto}
  return [programs[name](rank, world, *args) for name, args in cases]
