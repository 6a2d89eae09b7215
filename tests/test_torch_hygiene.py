"""Boundaries of the PyTorch port.

No module of ``easyparallellibrary_tpu_torch`` (nor ``chip_smoke.py``)
imports JAX, flax or the JAX package, and the entry points never drop to
the CPU on their own: without a GPU they raise unless the caller passes
``device="cpu"``.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "easyparallellibrary_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "easyparallellibrary_tpu")


def _imported_modules(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module


def _port_sources():
  return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_exist():
  names = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
  assert "chip_smoke.py" in names
  assert "easyparallellibrary_tpu_torch/serving/engine.py" in names
  assert (PORT / "kernels" / "csrc" / "paged_attention.cu").is_file()


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
  bad = [m for m in _imported_modules(path)
         if m.split(".")[0] in FORBIDDEN]
  assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _entry_points(tmp):
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, allocate_paged_kv_cache)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  from easyparallellibrary_tpu_torch.io import DevicePrefetcher
  from easyparallellibrary_tpu_torch.runtime.saver import restore_params
  from easyparallellibrary_tpu_torch.serving import (
      DraftModelDrafter, Router)
  from easyparallellibrary_tpu_torch.weights import (
      from_jax_params, init_params)
  from easyparallellibrary_tpu_torch.cluster import Cluster
  from easyparallellibrary_tpu_torch.utils.launcher import init_distributed
  from easyparallellibrary_tpu_torch.observability.perfgate import (
      collect_cards)
  from easyparallellibrary_tpu_torch.examples import (
      generate_gpt, train_gpt)
  cfg = GPTConfig(vocab_size=64, num_layers=1, num_heads=2, d_model=16,
                  d_ff=32, max_seq_len=16, dtype=torch.float32)
  cpu_params = init_params(cfg, device="cpu")
  ckpt = _checkpoint(str(tmp / "ckpt"), cpu_params)
  return {
      "init_params": lambda **kw: init_params(cfg, **kw),
      "from_jax_params": lambda **kw: from_jax_params(
          {"wpe": np.zeros((16, 16), np.float32)}, **kw),
      "allocate_paged_kv_cache": lambda **kw: allocate_paged_kv_cache(
          cfg, 17, 4, **kw),
      "tiny_gpt": lambda **kw: tiny_gpt(**kw),
      "ContinuousBatchingEngine": lambda **kw: ContinuousBatchingEngine(
          GPT(cfg), cpu_params, paged=True, num_slots=2, prefill_chunk=4,
          block_size=4, **kw),
      "fit": lambda **kw: _fit(cfg, cpu_params, **kw),
      "DevicePrefetcher": lambda **kw: next(DevicePrefetcher(
          iter([{"x": np.zeros(2, np.float32)}]), **kw)),
      "restore_params": lambda **kw: restore_params(ckpt, **kw),
      "DraftModelDrafter.from_checkpoint":
          lambda **kw: DraftModelDrafter.from_checkpoint(ckpt, GPT(cfg),
                                                         **kw),
      "Router": lambda **kw: Router(
          GPT(cfg), cpu_params, num_replicas=1, paged=True, num_slots=2,
          prefill_chunk=4, block_size=4, **kw),
      "Cluster.build_mesh": lambda **kw: Cluster(**kw).build_mesh(),
      "init_distributed": lambda **kw: init_distributed(world_size=1,
                                                        **kw),
      "perfgate.collect_cards": lambda **kw: collect_cards(
          twins=("plain",), **kw),
      "examples.train_gpt": lambda **kw: train_gpt.main(
          _example_flags(kw, "--layers", "1", "--d-model", "16", "--heads",
                         "2", "--vocab", "64", "--seq-len", "8", "--batch",
                         "2", "--steps", "1")),
      "examples.generate_gpt": lambda **kw: generate_gpt.main(
          _example_flags(kw, "--layers", "1", "--d-model", "16", "--heads",
                         "2", "--vocab", "64", "--seq-len", "16",
                         "--max-new-tokens", "2")),
  }


def _example_flags(kw, *flags):
  """An example's flags, with ``--device`` when the caller names one."""
  return list(flags) + (["--device", kw["device"]] if kw else [])


def _checkpoint(root, params):
  from easyparallellibrary_tpu_torch.runtime import saver
  saver.save_checkpoint(root, {"params": saver.params_tree(params)}, step=1)
  return root


def _fit(cfg, params, **kw):
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, make_train_step)
  from easyparallellibrary_tpu_torch.runtime.loop import fit
  state = TrainState.create(apply_fn=GPT(cfg), params=params,
                            tx=adamw(1e-3))
  step = make_train_step(lambda p, b, r: (sum(v.sum() for v in p.values())
                                          * 0.0, {}))
  return fit(step, state, [{}], num_steps=1, log_every=0, **kw)


@pytest.mark.parametrize("name", ["init_params", "from_jax_params",
                                  "allocate_paged_kv_cache", "tiny_gpt",
                                  "ContinuousBatchingEngine", "fit",
                                  "DevicePrefetcher", "restore_params",
                                  "DraftModelDrafter.from_checkpoint",
                                  "Router", "Cluster.build_mesh",
                                  "init_distributed",
                                  "perfgate.collect_cards",
                                  "examples.train_gpt",
                                  "examples.generate_gpt"])
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(
    name, monkeypatch, tmp_path):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  entry = _entry_points(tmp_path)[name]
  with pytest.raises(RuntimeError, match="device='cpu'"):
    entry()
  entry(device="cpu")


# The modules of the tensor-parallel slice; each is held to the import
# rule above by test_no_jax_imports as well.
TP_MODULES = ("communicators/collectives.py", "communicators/fusion.py",
              "communicators/overlap.py", "ops/bridging.py",
              "ops/distributed_ops.py", "parallel/explicit.py",
              "parallel/planner.py", "runtime/zero.py", "utils/compat.py",
              "utils/sharding.py", "utils/launcher.py",
              "testing/tp_workers.py")


def test_tensor_parallel_modules_exist_and_import_no_jax():
  for rel in TP_MODULES:
    path = PORT / rel
    assert path.is_file(), rel
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_spawned_workers_load_no_jax():
  """A rank started by ``utils.launcher.spawn`` runs a tensor-parallel
  forward and backward without JAX, flax, optax or the JAX package
  among its loaded modules."""
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  ranks = spawn(tp_workers.imported_modules, 2, (), timeout_s=120)
  for loaded in ranks:
    assert "torch" in loaded
    assert not set(loaded) & set(FORBIDDEN), set(loaded) & set(FORBIDDEN)


# The modules of the tooling slice; each is held to the import rule above
# by test_no_jax_imports as well.
TOOLING_MODULES = ("analysis/__init__.py", "analysis/__main__.py",
                   "analysis/core.py", "analysis/rules.py",
                   "examples/__init__.py", "examples/_ranks.py",
                   "examples/train_gpt.py", "examples/generate_gpt.py",
                   "examples/train_bert_pipeline.py",
                   "examples/train_resnet_dp.py",
                   "observability/perfgate.py", "profiler/flops.py",
                   "profiler/memory.py", "profiler/profiler.py",
                   "kernels/_cost.py", "utils/bench_evidence.py")


@pytest.mark.parametrize("rel", TOOLING_MODULES)
def test_tooling_modules_exist_and_import_no_jax(rel):
  path = PORT / rel
  assert path.is_file(), rel
  bad = [m for m in _imported_modules(path)
         if m.split(".")[0] in FORBIDDEN]
  assert not bad, f"{rel} imports {bad}"


def test_every_jax_module_has_a_port_counterpart():
  """Each module of the JAX package has its namesake in the port (the
  deliberate differences are ROADMAP.md Queue 3's), its data files too,
  and nothing in the port raises "not ported" any more."""
  jax_root = ROOT / "easyparallellibrary_tpu"
  for path in sorted(jax_root.rglob("*.py")):
    rel = path.relative_to(jax_root)
    assert (PORT / rel).is_file(), rel
  for name in ("analysis/baseline.json",):
    assert (PORT / name).is_file(), name
  assert (PORT / "perf_budget.json").is_file()
  for path in PORT.rglob("*.py"):
    text = path.read_text()
    assert "not_ported" not in text and "not ported" not in text, path
