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


def _entry_points():
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, allocate_paged_kv_cache)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  from easyparallellibrary_tpu_torch.weights import (
      from_jax_params, init_params)
  cfg = GPTConfig(vocab_size=64, num_layers=1, num_heads=2, d_model=16,
                  d_ff=32, max_seq_len=16, dtype=torch.float32)
  cpu_params = init_params(cfg, device="cpu")
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
  }


@pytest.mark.parametrize("name", ["init_params", "from_jax_params",
                                  "allocate_paged_kv_cache", "tiny_gpt",
                                  "ContinuousBatchingEngine"])
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(
    name, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  entry = _entry_points()[name]
  with pytest.raises(RuntimeError, match="device='cpu'"):
    entry()
  entry(device="cpu")
