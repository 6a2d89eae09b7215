"""The harness on the CPU: every piece found by name, BENCHMARK.json in
the contract's form, the generator and the weights repeating by seed,
the reference against itself and against a tiny step of the port, and a
whole run's result line."""

import json
import math
import re

import pytest
import torch

import tiny
from perfbench import check, run, trace, traffic, weights

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_loads_by_name(cell):
  spec, config, mix = run.cell_spec(cell)
  entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
  assert {k: spec[k] for k in ("config", "traffic", "chips", "why")} == {
      k: entry[k] for k in ("config", "traffic", "chips", "why")}
  listed = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
  assert listed["file"] == f"perfbench/configs/{spec['config']}.json"
  assert listed["reduced"] == config["reduced"]
  __import__(f"perfbench.families.{config['family']}")
  __import__(f"perfbench.reference.{config['family']}")
  assert mix["pool"] >= run.CHECKED_STEPS
  assert all(isinstance(spec["limits"][k], float) for k in check.NUMBERS)
  for metric in run.metrics_of(cell, False) + run.metrics_of(cell, True):
    assert callable(run.reader(metric["name"]))


def test_benchmark_json_keeps_the_contract():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
  keys = {"configs": {"name", "source", "file", "reduced", "why"},
          "workloads": {"name", "config", "traffic", "chips", "why"},
          "end_to_end": {"name", "unit", "better", "bound", "source"},
          "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
  for section, allowed in keys.items():
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
      assert set(e) - {"workloads"} == allowed, e
      assert NAME.match(e["name"]), e["name"]
      for text in ("why", "layer", "source"):
        assert text not in e or 1 <= len(e[text]) <= 200
  e2e = {m["name"] for m in BENCH["end_to_end"]}
  assert "setup_s" in e2e
  for m in BENCH["end_to_end"] + BENCH["per_layer"]:
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
  for m in BENCH["end_to_end"]:
    assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
        "host_clock", "device_trace")
  for m in BENCH["per_layer"]:
    assert m["moves"] in e2e and set(m.get("workloads", CELLS)) <= set(CELLS)
  used = {w["config"] for w in BENCH["workloads"]}
  assert used == {c["name"] for c in BENCH["configs"]}
  assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == \
      len(CELLS)
  assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_batches_repeat_by_seed_and_differ_between_seeds(cell):
  config, mix, _ = tiny.spec(cell)
  a = traffic.batches(config, mix, 2 ** 31 + 11, tiny.CPU)
  b = traffic.batches(config, mix, 2 ** 31 + 11, tiny.CPU)
  c = traffic.batches(config, mix, 2 ** 31 + 12, tiny.CPU)
  for x, y in zip(a, b):
    assert all(torch.equal(x[k], y[k]) for k in x)
  assert not torch.equal(a[0]["ids"], c[0]["ids"])
  rows = torch.cat([p["ids"] for p in a])
  assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
  assert int(rows.max()) < config["token_vocab"]
  if mix["objective"] == "mlm":
    n = traffic.predictions(mix["seq_len"], mix["mlm"])
    for p in a:
      assert (p["mask"].sum(1) == n).all()
      kept = p["mask"] == 0
      assert torch.equal(p["ids"][kept], p["labels"][kept])


def test_the_full_cells_predict_as_bert_did():
  for name, want in (("mlm.b128.s512", 77), ("mlm.b256.s128", 19)):
    mix = run.load("traffic", name)
    assert traffic.predictions(mix["seq_len"], mix["mlm"]) == want


def test_weights_repeat_by_seed():
  shapes = {"a.weight": (8, 4), "ln1.weight": (4,), "a.bias": (8,),
            "wte.weight": (16, 4)}
  rule = weights.transformer_rule(("wte.weight",), 0.02)
  w1 = weights.make(shapes, rule, 99, tiny.CPU)
  w2 = weights.make(shapes, rule, 99, tiny.CPU)
  assert all(torch.equal(w1[k], w2[k]) for k in shapes)
  assert torch.equal(w1["ln1.weight"], torch.ones(4))
  assert torch.equal(w1["a.bias"], torch.zeros(8))
  assert float(w1["wte.weight"].std()) < 0.05 < float(w1["a.weight"].std())


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_reference_against_itself_and_a_tiny_port_step(cell):
  """In float32 the port's three steps and the reference's agree to
  round-off, and the reference repeats bit for bit."""
  import importlib
  config, mix, _ = tiny.spec(cell)
  fam = importlib.import_module(f"perfbench.families.{config['family']}")
  prog = fam.build(config, tiny.CPU)
  program, _, _, pool, shapes = run.program_readings(
      prog, fam, config, mix, 17, tiny.CPU)
  ref = run.reference_readings(fam, config, mix, 17, tiny.CPU, pool, shapes)
  again = run.reference_readings(fam, config, mix, 17, tiny.CPU, pool, shapes)
  assert ref == again
  numbers = check.compare(program, ref)
  assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-5
  assert numbers["change_gap"] < 1e-3, numbers
  assert 0 < ref.losses[0] and all(math.isfinite(x) for x in ref.losses)


def test_the_reference_restores_the_tf32_settings_it_turns_off():
  config, mix, _ = tiny.spec("gpt3-medium.train.s1024")
  import importlib
  fam = importlib.import_module("perfbench.families.gpt")
  shapes = fam.build(config, tiny.CPU).shapes()
  pool = traffic.batches(config, mix, 3, tiny.CPU)
  flags = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  try:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    run.reference_readings(fam, config, mix, 3, tiny.CPU, pool, shapes,
                           rows=1)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_reports_the_cells_metrics_and_checks_last(traced):
  cell = "gpt3-medium.train.s1024"
  result = run.run_cell(cell, 2 ** 31 + 5, 0.3, traced, tiny.CPU, tiny.CARD,
                        overrides=tiny.OVERRIDES["gpt"])
  assert list(result)[-1] == "checks"
  assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
  assert result["correct"] is True and result["failed"] == 0
  assert result["setup"]["kernels_compiled"] == []   # nothing to build here
  wanted = {m["name"] for m in run.metrics_of(cell, traced)}
  got = set(result["metrics"])
  # The CPU launches no device kernel: the device-trace readers find
  # nothing and are left out.
  trace_only = {"flash_roofline", "flash_device_share.train",
                "device_idle_share.train"}
  assert got == wanted - (trace_only if traced else set())
  if traced:
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_busy_time_is_the_union_of_intervals():
  assert trace.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_a_launch_is_held_by_the_ops_around_it():
  ops = [(0, 10, "step"), (1, 4, "flash"), (2, 3, "mul"), (5, 9, "mm")]
  held = trace.covering(ops, [2.5, 4.5, 6, 11])
  assert held == {2.5: ("step", "flash", "mul"), 4.5: ("step",),
                  6: ("step", "mm"), 11: ()}


@pytest.mark.gpu
def test_the_trace_gives_k1_every_kernel_its_op_launched():
  """On the card, the flash op's forward and its backward node own the
  flash kernels and the backward's eager ``delta``."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  from torch.profiler import ProfilerActivity, profile
  from easyparallellibrary_tpu_torch.kernels.flash_attention import (
      flash_attention)
  q, k, v = (torch.randn(2, 256, 4, 64, device="cuda", dtype=torch.bfloat16,
                         requires_grad=True) for _ in range(3))
  flash_attention(q, k, v, causal=True).sum().backward()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    flash_attention(q, k, v, causal=True).sum().backward()
    torch.cuda.synchronize()
  got = trace.read(prof, 1.0, 1)
  names = [n for n, _, _ in trace.under(got, "flash_attention_fwd")]
  for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
    assert any(kernel in n for n in names), names
  assert any("flash" not in n for n in names), names   # delta's kernels
  assert 0 < got["busy_s"] < 1.0
