"""The port's training benchmark: one cell, one seed, one run.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for.  Everything is found by name: the cell in
``perfbench/workloads/<cell>.json`` names its configuration
(``configs/<config>.json``, whose ``family`` names
``families/<family>.py`` and ``reference/<family>.py``) and its mix
(``traffic/<mix>.json``); the metrics a run reports are the cell's in
``BENCHMARK.json``, each read by ``metrics/<metric>.py``.

A run builds the port's train step, compiles the port's kernel
libraries where the checkout has none yet (timed apart, reported under
``setup``), draws the weights and the pool of batches on the device
from ``--seed``, and runs three checked steps on three batches, which
also warm every shape; that is the set-up.  Then
it runs steps back to back for ``--seconds`` and ends the window with a
synchronize.  With ``--trace 1`` a few more steps are timed one by one
on the host and a few run under ``torch.profiler``.  Once the program's
state is freed, the float32 reference retraces the three checked steps
and ``perfbench/check.py`` decides ``correct``.  The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "easyparallellibrary_tpu")
CHECKED_STEPS = 3
TRACED_STEPS = 3
# Kernel and compiler caches of anything the run may load, at fixed paths
# inside the checkout.
CACHES = {"TRITON_CACHE_DIR": BENCH / ".cache" / "triton",
          "TORCHINDUCTOR_CACHE_DIR": BENCH / ".cache" / "inductor"}


def load(kind: str, name: str) -> dict:
  with open(BENCH / kind / f"{name}.json") as f:
    return json.load(f)


def cell_spec(name: str):
  """``(cell, config, mix)`` of the cell ``name``."""
  cell = load("workloads", name)
  return cell, load("configs", cell["config"]), load("traffic",
                                                      cell["traffic"])


def metrics_of(cell: str, trace: bool) -> list:
  """The cell's end-to-end metrics (``trace`` False) or per-layer ones,
  as ``BENCHMARK.json`` lists them: a metric with ``workloads`` where
  they name the cell; a per-layer one without, where the cell reports
  the end-to-end metric it moves."""
  with open(ROOT / "BENCHMARK.json") as f:
    bench = json.load(f)

  def applies(m):
    return cell in m.get("workloads", [cell])

  e2e = [m for m in bench["end_to_end"] if applies(m)]
  if not trace:
    return e2e
  names = {m["name"] for m in e2e}
  return [m for m in bench["per_layer"]
          if cell in m.get("workloads", ()) or (
              "workloads" not in m and m["moves"] in names)]


def reader(metric: str):
  path = BENCH / "metrics" / f"{metric}.py"
  spec = importlib.util.spec_from_file_location(
      "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.read


def forbidden_modules() -> list:
  return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
  import torch
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def program_readings(prog, fam, config, mix, seed, device, wrap=None):
  """A fresh state from the seed's weights, driven through the three
  checked steps on the pool's first three batches by the program's step
  (``wrap(step)`` instead, when given: a planted fault).  Returns
  ``(readings, state, step, pool, shapes)``."""
  from perfbench import check, traffic
  t = time.perf_counter()
  marks = []

  def mark():
    _sync(device)
    marks.append(time.perf_counter() - t - sum(marks))

  shapes = prog.shapes()
  params0 = fam.make_weights(shapes, config, seed, device)
  mark()
  pool = traffic.batches(config, mix, seed, device)
  mark()
  state = prog.state(params0)
  step = prog.step if wrap is None else wrap(prog.step)
  mark()
  losses, grads = [], None
  for i in range(CHECKED_STEPS):
    state, metrics = step(state, pool[i], None)
    losses.append(metrics["loss"])
    if grads is None:
      grads = check.first_gradient_norms(state, fam.GROUPS)
    mark()
  changes = check.change_norms(state, params0, fam.GROUPS)
  print("setup: weights %.2f s, batches %.2f s, state %.2f s; checked steps "
        "%s s" % (*marks[:3], ", ".join("%.2f" % m for m in marks[3:])),
        file=sys.stderr)
  readings = check.Readings([float(x) for x in losses],
                            check.to_host(grads), check.to_host(changes))
  return readings, state, step, pool, shapes


def reference_readings(fam, config, mix, seed, device, pool, shapes,
                       precision="fp32", rows=None):
  """The reference's three steps from the seed's weights (redrawn) on
  the pool's first three batches, or on their first ``rows`` rows."""
  ref = importlib.import_module(f"perfbench.reference.{config['family']}")
  params0 = fam.make_weights(shapes, config, seed, device)
  batches = pool[:CHECKED_STEPS]
  if rows is not None:
    batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
  return ref.train(params0, batches, config, mix, fam.GROUPS,
                   precision=precision)


def build_kernels(names, device) -> dict:
  """Builds the port's kernel libraries ``names`` where the checkout
  lacks them, as its first run must, and times that apart from the rest
  of the set-up: ``{"built": [names built], "seconds": s}``."""
  if device.type != "cuda":
    return {"built": [], "seconds": 0.0}
  from easyparallellibrary_tpu_torch.kernels import _build
  t = time.perf_counter()
  built = sorted(_build.build(names))
  return {"built": built, "seconds": time.perf_counter() - t}


def _power_limit():
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return float(out.split()[0])
  except (OSError, subprocess.SubprocessError, ValueError, IndexError):
    return None


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             card: str, overrides=None, step_fault=None) -> dict:
  """One run of cell ``name``; returns the result object.  ``overrides``
  (``{"config": {...}, "mix": {...}}``) and ``step_fault`` (wraps the
  program's step) serve the CPU tests."""
  import torch
  from perfbench import check, roofline
  from perfbench import trace as trace_lib
  cell, config, mix = cell_spec(name)
  overrides = overrides or {}
  config = {**config, **overrides.get("config", {})}
  mix = {**mix, **overrides.get("mix", {})}
  fam = importlib.import_module(f"perfbench.families.{config['family']}")
  peaks = roofline.peaks(card)
  t = time.perf_counter()
  prog = fam.build(config, device)
  print("setup: start to build %.2f s; build %.2f s"
        % (t - T0, time.perf_counter() - t), file=sys.stderr)
  kernels = build_kernels(fam.KERNELS, device)
  print("setup: kernel libraries %.2f s, compiled %s"
        % (kernels["seconds"], kernels["built"] or "none"), file=sys.stderr)
  program, state, step, pool, shapes = program_readings(
      prog, fam, config, mix, seed, device, wrap=step_fault)
  _sync(device)
  setup_s = time.perf_counter() - T0

  cuda = device.type == "cuda"
  if cuda:
    torch.cuda.reset_peak_memory_stats(device)
  losses, n, metrics = [], 0, None
  t0 = time.perf_counter()
  while time.perf_counter() - t0 < seconds:
    state, metrics = step(state, pool[(CHECKED_STEPS + n) % len(pool)], None)
    losses.append(metrics["loss"])
    n += 1
  _sync(device)
  window_s = time.perf_counter() - t0
  memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
  failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
  run = {
      "setup_s": setup_s,
      "window": {"steps": n, "seconds": window_s,
                 "tokens": n * fam.tokens_per_step(config, mix),
                 "memory_peak_bytes": memory_peak},
      "flops_per_token": fam.flops_per_token(config, mix),
      "peak_flops": peaks["flops"][config["dtype"]],
      "peak_bytes_per_s": peaks["bytes_per_s"],
      "attention_ops": fam.attention_ops(config, mix),
  }
  if traced:
    enqueue = []
    for i in range(TRACED_STEPS):
      _sync(device)
      t = time.perf_counter()
      state, _ = step(state, pool[i % len(pool)], None)
      enqueue.append(time.perf_counter() - t)
    run["enqueue_s"] = enqueue
    from torch.profiler import ProfilerActivity, profile
    # The device's own trace first (busy and idle, without the host-side
    # recording that slows a host-paced step), then one with the CPU ops
    # that own each launch (K1's time, the breakdown).
    for key, activities in (("device_trace", [ProfilerActivity.CUDA]),
                            ("trace", [ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])):
      if not cuda:
        activities = [ProfilerActivity.CPU]
      with profile(activities=activities) as prof:
        _sync(device)
        t = time.perf_counter()
        for i in range(TRACED_STEPS):
          state, _ = step(state, pool[i % len(pool)], None)
        _sync(device)
        traced_s = time.perf_counter() - t
      run[key] = trace_lib.read(prof, traced_s, TRACED_STEPS)
      del prof
  del state, metrics, prog, step
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()

  reference = reference_readings(fam, config, mix, seed, device, pool,
                                 shapes)
  numbers = check.compare(program, reference)
  print(f"losses: program {program.losses}; reference {reference.losses}",
        file=sys.stderr)
  limits = cell.get("limits", {})
  result = {
      "correct": check.verdict(numbers, limits) and failed == 0,
      "attempted": n,
      "failed": failed,
      "metrics": {},
      "device": {"platform": "gpu" if cuda else device.type,
                 "kind": card, "count": cell["chips"],
                 "memory_peak_bytes": memory_peak},
  }
  for metric in metrics_of(name, traced):
    value = reader(metric["name"])(run)
    if value is not None:
      result["metrics"][metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
  if traced:
    result["device"]["busy_s"] = run["device_trace"]["busy_s"]
    result["device"]["window_s"] = run["device_trace"]["window_s"]
    result["breakdown"] = run["trace"]["breakdown"]
  # setup_s holds the kernel libraries' build where this run compiled
  # them; the build's own seconds stand apart here.
  result["setup"] = {"setup_s": setup_s,
                     "kernel_build_s": kernels["seconds"],
                     "kernels_compiled": kernels["built"]}
  result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                      for k, v in numbers.items()}
  return result


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seed", type=int, required=True)
  parser.add_argument("--seconds", type=float, required=True)
  parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  cell, _, _ = cell_spec(args.workload)
  for key, path in CACHES.items():
    path.mkdir(parents=True, exist_ok=True)
    os.environ[key] = str(path)
  import torch
  if not torch.cuda.is_available() or \
      torch.cuda.device_count() < cell["chips"]:
    print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
          f"this machine has "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return 2
  device = torch.device("cuda", 0)
  result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    device, torch.cuda.get_device_name(device))
  result["device"]["power_limit_w"] = _power_limit()
  bad = forbidden_modules()
  if bad:
    print(f"perfbench: the run loaded {bad}", file=sys.stderr)
    return 3
  for key, check in result["checks"].items():
    print(f"check {key} {check['value']!r} limit {check['limit']!r}",
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
