"""Boundaries of the PyTorch port.

No module of ``easyparallellibrary_tpu_torch`` (nor ``chip_smoke.py``)
imports JAX, flax or the JAX package, and the entry points never drop to
the CPU on their own: without a GPU they raise unless the caller passes
``device="cpu"``.
"""

import ast
import re
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


# ------------------------------------------------ the packages' exports --

# JAX public names the port leaves out on purpose (ROADMAP.md Queue 3):
# sharding objects with no PyTorch meaning, and the TPU kernel's Pallas
# entry, whose role the CUDA wrapper plays.  Each names the module that
# exports it in the JAX package; test_deliberate_differences_are_current
# keeps the list from going stale.
DELIBERATE_DIFFERENCES = {
    "kernels.paged_attention_pallas":
        "the Pallas call; the port's is paged_attention_cuda",
    "parallel.batch_sharding": "a jax.sharding.NamedSharding",
    "parallel.named_sharding": "a jax.sharding.NamedSharding",
    "parallel.replicated_sharding": "a jax.sharding.NamedSharding",
    "serving.kv_cache.kv_spec": "a PartitionSpec of the cache",
    "observability.device.specs_of": "PartitionSpecs of a jax.Array tree",
    "ops.layers.PaddedPartitioned": "flax partitioning metadata",
    "ops.layers.default_kernel_init": "a flax initializer",
    "utils.pytree.tree_map_with_path_str": "a jax.tree_util path walk",
    "runtime.offload.DEVICE_MEMORY_KIND": "a jax memory kind",
}


def _top_level(path):
  """``(names bound at the top level of a source, its __all__ or None)``:
  what its own imports, assignments and definitions bind (a submodule
  imported elsewhere does not count)."""
  tree = ast.parse(path.read_text(), filename=str(path))
  names, exported = set(), None
  for node in tree.body:
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
      targets = node.targets if isinstance(node, ast.Assign) else [
          node.target]
      for target in targets:
        if isinstance(target, ast.Name) and target.id == "__all__":
          exported = set(ast.literal_eval(node.value))
        elif isinstance(target, ast.Name):
          names.add(target.id)
    elif isinstance(node, (ast.Import, ast.ImportFrom)):
      names.update((a.asname or a.name).split(".")[0] for a in node.names)
    elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
      names.add(node.name)
  return names, exported


def _bound_names(init):
  """The public names an ``__init__.py`` exports: its ``__all__`` when
  it has one, else the public names its top level binds."""
  names, exported = _top_level(init)
  if exported is not None:
    return exported
  return {n for n in names if not n.startswith("_")}


def _jax_packages():
  jax_root = ROOT / "easyparallellibrary_tpu"
  return sorted(p.parent.relative_to(jax_root).as_posix()
                for p in jax_root.rglob("__init__.py"))


@pytest.mark.parametrize("package", _jax_packages())
def test_package_exports_match_the_jax_package(package):
  """Every public name of a JAX package's ``__init__`` is bound by the
  port's namesake ``__init__`` too, or is a deliberate difference; and
  each bound name resolves once the port's package is imported."""
  import importlib
  jax_init = ROOT / "easyparallellibrary_tpu" / package / "__init__.py"
  port_init = PORT / package / "__init__.py"
  assert port_init.is_file(), package
  prefix = "" if package == "." else package.replace("/", ".") + "."
  port_names = _bound_names(port_init)
  missing = sorted(n for n in _bound_names(jax_init) - port_names
                   if prefix + n not in DELIBERATE_DIFFERENCES)
  assert not missing, f"{package}: the port does not export {missing}"
  module = importlib.import_module(
      "easyparallellibrary_tpu_torch" + ("" if package == "."
                                         else "." + prefix[:-1]))
  assert all(hasattr(module, n) for n in port_names), package


def test_deliberate_differences_are_current():
  """Each listed name is bound by the JAX package's module and by no
  top level of the port's namesake (read from the sources: the JAX
  package is not imported here)."""
  for dotted in DELIBERATE_DIFFERENCES:
    *mod, name = dotted.split(".")
    paths = []
    for root in (ROOT / "easyparallellibrary_tpu", PORT):
      base = root.joinpath(*mod)
      paths.append(base / "__init__.py" if base.is_dir()
                   else base.with_suffix(".py"))
    assert name in _top_level(paths[0])[0], dotted
    names, exported = _top_level(paths[1])
    assert name not in names | (exported or set()), dotted


# ------------------------------------------------- the modules' surfaces --

# Public top-level names and public class methods of a JAX module that
# its namesake in the port leaves out on purpose, by module, each with
# its reason (ROADMAP.md Queue 3).
MODULE_DIFFERENCES = {
    "communicators/overlap.py": {
        "part_dtype": "jnp.result_type of the preallocated partials; "
                      "torch.matmul takes one dtype and nothing is "
                      "preallocated",
    },
    "kernels/paged_attention.py": {
        "NEG_INF": "the Pallas kernel's mask and running-max start; the "
                   "CUDA kernels hold their own, the plain version masks "
                   "with -1e9 as the JAX reference does",
        "default_paged_impl": "a process-wide backend rule; the port "
                              "dispatches by the tensor's device",
        "paged_attention_pallas": "the Pallas call; the port's is "
                                  "paged_attention_cuda",
    },
    "observability/device.py": {
        "specs_of": "PartitionSpecs of a jax.Array tree",
    },
    "observability/trace.py": {
        "Tracer.xla_trace": "the port's Tracer.device_trace "
                            "(torch.profiler)",
    },
    "ops/layers.py": {
        "Dtype": "flax's dtype alias",
        "PaddedPartitioned": "flax partitioning metadata",
        "default_kernel_init": "a flax initializer",
    },
    "parallel/api.py": {
        "batch_sharding": "a jax.sharding.NamedSharding",
        "named_sharding": "a jax.sharding.NamedSharding",
        "replicated_sharding": "a jax.sharding.NamedSharding",
    },
    "parallel/pipeline.py": {
        "SCAN_THRESHOLD": "when lax.scan replaces the unrolled tick loop; "
                          "the port's executor loops in Python",
    },
    "parallel/pipeline_smap.py": {
        "MANUAL_AXES": "shard_map's manual axes",
        "engine_meta_specs": "PartitionSpecs of the engine's tree",
        "grad_mean_axes": "in parallel/api.py",
        "grad_out_specs": "PartitionSpecs of the gradients",
        "make_engine_tree_fns": "flax boxing of the stacked tree",
        "rebox_grads": "flax boxing of the gradients",
        "run_smap_engine": "the shard_map call; the port runs one "
                           "executor a rank",
        "seq_engine_axes": "models.gpt.split_axes",
        "stage_stacked_specs": "PartitionSpecs of the stacked stages",
        "uniform_stage_compute": "no uniform stage compute: seq and "
                                 "expert peers walk the same table",
        "zero1_grad_layout": "runtime/zero.py",
    },
    "parallel/planner.py": {
        "DEFAULT_ICI_BYTES_PER_S": "the TPU ICI's rate; the port's is "
                                   "DEFAULT_LINK_BYTES_PER_S (NVLink)",
    },
    "runtime/offload.py": {
        "DEVICE_MEMORY_KIND": "a jax memory kind",
    },
    "sequence/ulysses.py": {
        "SEQ_SHARDED": "a PartitionSpec",
        "HEAD_SHARDED": "a PartitionSpec",
    },
    "serving/kv_cache.py": {
        "kv_spec": "a PartitionSpec of the cache",
    },
    "utils/compat.py": {
        "shard_map": "jax.experimental.shard_map's import shim",
    },
    "utils/pytree.py": {
        "tree_map_with_path_str": "a jax.tree_util path walk",
    },
}


def _surface(path):
  """``(names, methods)`` of a source: the names its top level binds
  (imports included), and the public methods of each class it defines,
  those of bases defined in the same source included."""
  tree = ast.parse(path.read_text(), filename=str(path))
  classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

  def methods(name, seen=()):
    node = classes[name]
    own = {b.name for b in node.body
           if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
    own |= {t.id for b in node.body if isinstance(b, ast.Assign)
            for t in b.targets if isinstance(t, ast.Name)}
    for base in node.bases:
      if isinstance(base, ast.Name) and base.id in classes and \
          base.id not in seen:
        own |= methods(base.id, seen + (name,))
    return own

  return _top_level(path)[0], {c: methods(c) for c in classes}


def _jax_defined(path):
  """The public names a JAX source defines (not imports) and its public
  classes' public methods, as ``Class.method``."""
  tree = ast.parse(path.read_text(), filename=str(path))
  names = set()
  for node in tree.body:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
      names.add(node.name)
    elif isinstance(node, (ast.Assign, ast.AnnAssign)):
      targets = node.targets if isinstance(node, ast.Assign) else [
          node.target]
      names |= {t.id for t in targets if isinstance(t, ast.Name)}
  names = {n for n in names if not n.startswith("_")}
  _, methods = _surface(path)
  return names | {f"{c}.{m}" for c, ms in methods.items()
                  if not c.startswith("_") for m in ms
                  if not m.startswith("_")}


def _jax_modules():
  jax_root = ROOT / "easyparallellibrary_tpu"
  return sorted(p.relative_to(jax_root).as_posix()
                for p in jax_root.rglob("*.py"))


@pytest.mark.parametrize("module", _jax_modules())
def test_module_surface_matches_the_jax_module(module):
  """Every public name a JAX module defines, and every public method of
  its public classes, is bound by the port's namesake (a method where
  the port defines that class), or is one of ``MODULE_DIFFERENCES``."""
  jax_path = ROOT / "easyparallellibrary_tpu" / module
  names, methods = _surface(PORT / module)
  listed = MODULE_DIFFERENCES.get(module, {})
  missing = []
  for name in sorted(_jax_defined(jax_path)):
    cls, _, method = name.rpartition(".")
    if cls and cls in methods:
      present = method in methods[cls]
    elif cls:
      present = cls in names    # bound by an import: its own module's pin
    else:
      present = name in names
    if not present and name not in listed:
      missing.append(name)
  assert not missing, f"{module}: the port does not define {missing}"


def test_module_differences_are_current():
  """Each listed name is still defined by the JAX module and still
  absent from the port's namesake."""
  for module, names in MODULE_DIFFERENCES.items():
    defined = _jax_defined(ROOT / "easyparallellibrary_tpu" / module)
    port_names, port_methods = _surface(PORT / module)
    for name in names:
      assert name in defined, (module, name)
      cls, _, method = name.rpartition(".")
      if cls:
        assert method not in port_methods.get(cls, set()), (module, name)
      else:
        assert name not in port_names, (module, name)


def test_cluster_counts_one_device_per_process():
  """``Cluster.devices_per_process`` as JAX ``cluster.py`` has it: the
  port runs one device per process."""
  from easyparallellibrary_tpu_torch.cluster import Cluster
  assert Cluster(device="cpu").devices_per_process == 1
  assert Cluster(devices=[torch.device("cpu")]).devices_per_process == 1


def test_engine_takes_donate_cache_and_ignores_it():
  """The JAX engine's ``donate_cache`` keyword: taken, and the same
  greedy stream whichever value it has."""
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  model, params = tiny_gpt(device="cpu")
  outs = []
  for donate in (None, True, False):
    eng = ContinuousBatchingEngine(model, params, device="cpu",
                                   num_slots=2, prefill_chunk=4,
                                   donate_cache=donate)
    eng.submit(Request(uid="a", prompt=np.array([1, 2, 3], np.int32),
                       max_new_tokens=4))
    outs.append(eng.run()["a"])
    eng.close()
  assert all(np.array_equal(o, outs[0]) for o in outs), outs


# ------------------------------------------- the Config keys each reads --

# Config keys the JAX package reads outside config.py that the port does
# not read, each with its reason (ROADMAP.md Queue 3).
CONFIG_KEYS_NOT_READ = {
    "cluster.device_place_prefer_intra_node":
        "orders a host's devices in the JAX mesh; the port runs one "
        "device a process, ranks in the JAX device order",
    "serving.donate_cache":
        "buffer donation of the jitted step; the port donates nothing "
        "(the engine takes the keyword and ignores it)",
}


def _config_keys():
  from easyparallellibrary_tpu_torch.config import Config
  return [(section,) + tuple(key.split("."))
          for section, values in Config().to_dict().items()
          for key in values]


def _config_reads(root):
  """``(attribute names read, string literals)`` in the code of a
  package outside ``config.py`` and ``testing/`` (whose programs set
  Config entries, not read them); comments and docstrings' prose are no
  reads."""
  import io
  import tokenize
  attrs, strings = set(), set()
  for path in sorted(root.rglob("*.py")):
    if path.name == "config.py" or path.relative_to(root).parts[0] == \
        "testing":
      continue
    toks = list(tokenize.generate_tokens(io.StringIO(
        path.read_text()).readline))
    for prev, tok in zip(toks, toks[1:]):
      if tok.type == tokenize.NAME and prev.string == ".":
        attrs.add(tok.string)
      elif tok.type == tokenize.STRING:
        try:
          value = ast.literal_eval(tok.string)
        except (ValueError, SyntaxError):
          continue
        if isinstance(value, str):
          strings.add(value)
  return attrs, strings


def _reads_key(reads, key) -> bool:
  """A key is read by an attribute access of its last name
  (``cfg.auto.tensor_split``, ``res.keep_last``) or by its dotted name
  as a string."""
  attrs, strings = reads
  return (key[-1] in attrs or ".".join(key) in strings
          or ".".join(key[1:]) in strings)


def test_every_config_key_the_jax_package_reads_is_read_by_the_port():
  """Each Config key the JAX package reads outside ``config.py`` is read
  by the port too, or is named in ``CONFIG_KEYS_NOT_READ`` with its
  reason (and each named key is still read by JAX and not by the
  port)."""
  jax_reads = _config_reads(ROOT / "easyparallellibrary_tpu")
  port_reads = _config_reads(PORT)
  unread = {".".join(k) for k in _config_keys()
            if _reads_key(jax_reads, k) and not _reads_key(port_reads, k)}
  assert unread == set(CONFIG_KEYS_NOT_READ), (
      f"read by JAX, not by the port: {sorted(unread)}")
