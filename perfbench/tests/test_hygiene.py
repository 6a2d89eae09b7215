"""What the benchmark loads: nothing of JAX or of the JAX package in a
run, nothing of the port in the reference.  Top-level module names are
compared whole (``easyparallellibrary_tpu_torch`` begins with
``easyparallellibrary_tpu``).  Each check runs in a fresh interpreter."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "easyparallellibrary_tpu"}
PORT = "easyparallellibrary_tpu_torch"

EVERY_MODULE_AND_A_RUN = r"""
import importlib, json, sys, pathlib
ROOT = sys.argv[1]
sys.path.insert(0, ROOT)
sys.path.insert(0, ROOT + "/perfbench/tests")
bench = pathlib.Path(ROOT) / "perfbench"
from perfbench import run
for path in sorted(bench.rglob("*.py")):
  rel = path.relative_to(bench)
  if rel.parts[0] in ("tests", "metrics"):
    continue
  importlib.import_module(".".join(("perfbench",) + rel.with_suffix("").parts)
                          .replace(".__init__", ""))
for path in sorted((bench / "metrics").glob("*.py")):
  run.reader(path.stem)
import tiny
for cell in tiny.CELLS:
  result = run.run_cell(cell, 3, 0.2, True, tiny.CPU, tiny.CARD,
                        overrides=tiny.OVERRIDES[tiny.CELLS[cell]])
  assert result["attempted"] > 0
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ALONE = r"""
import json, sys
ROOT = sys.argv[1]
sys.path.insert(0, ROOT)
import torch
from perfbench import traffic, weights
from perfbench.reference import bert, common, gpt
D, F, V, P, L = 32, 64, 128, 32, 2
shapes = {"wte.weight": (V, D), "wpe": (P, D)}
for i in range(L):
  b = f"block_{i}."
  shapes.update({b + "ln1.weight": (D,), b + "ln1.bias": (D,),
                 b + "attn.qkv.weight": (3 * D, D),
                 b + "attn.proj.weight": (D, D),
                 b + "ln2.weight": (D,), b + "ln2.bias": (D,),
                 b + "mlp.wi.weight": (F, D), b + "mlp.wi.bias": (F,),
                 b + "mlp.wo.weight": (D, F), b + "mlp.wo.bias": (D,)})
shapes.update({"ln_f.weight": (D,), "ln_f.bias": (D,)})
config = {"num_layers": L, "num_heads": 4, "token_vocab": V,
          "optimizer": {"learning_rate": 3e-4, "b1": 0.9, "b2": 0.999,
                        "eps": 1e-8, "weight_decay": 0.01}}
mix = {"objective": "lm", "batch": 2, "seq_len": 16, "pool": 3,
       "tokens": {"dist": "zipf", "exponent": 1.0}}
cpu = torch.device("cpu")
params = weights.make(shapes, weights.transformer_rule(("wte.weight", "wpe"),
                                                       0.02), 5, cpu)
got = gpt.train(params, traffic.batches(config, mix, 5, cpu), config, mix,
                {"qkv": 3})
assert len(got.losses) == 3
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(code: str) -> set:
  out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
  assert out.returncode == 0, out.stderr[-4000:]
  return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
  loaded = _loaded(EVERY_MODULE_AND_A_RUN)
  assert PORT in loaded          # the system under test was loaded
  assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
  loaded = _loaded(REFERENCE_ALONE)
  assert not loaded & (FORBIDDEN | {PORT}), sorted(loaded & (FORBIDDEN | {PORT}))
