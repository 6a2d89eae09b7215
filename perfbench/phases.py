"""Where one cell's train step spends its time, phase by phase, read
from the program's own spans (``train/forward``, ``train/backward``,
``train/optimizer``, ``train/remat``, ``train/flash_delta``), on the
card, in one process:

    python3 -m perfbench.phases --workload <cell> --seed <n> \\
        [--cost <seconds>]

The run builds the cell's program and warms it as ``perfbench.run``
does (the three checked steps), then takes, in turn:

* the host enqueue of ``STEPS`` steps, each begun on an idle device;
* the same steps with the port's tracer installed, and each phase's
  host milliseconds from its ring (a span's B to its E);
* a trace of the device alone (launches a step, idle share) and one
  with the host's ops (device milliseconds a step under each span, the
  device time outside the forward, backward and optimizer with the ops
  that launched it, the idle gaps by the op the host was in, K1's share
  and roofline as the benchmark's readers take them);
* the host enqueue of steps under that profiler.

``--cost <seconds>`` then times windows of back-to-back steps with the
tracer off and on in ABBA rounds (tokens/s of each), and the host
microseconds of a span with neither a tracer nor a profiler on.  The
last line of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

from perfbench import run
from perfbench import trace as trace_lib

STEPS = 3
PHASES = ("train/forward", "train/backward", "train/optimizer")
COST_ROUNDS = 2           # ABBA rounds: each an off, on, on, off window
SPAN_CALLS = 200_000


def device_ms(trace: dict, span: str, within: Optional[str] = None
              ) -> Optional[float]:
  """Device milliseconds a step of the events launched under ``span``
  (and under ``within`` too, when given); None where no event is."""
  if within is not None:
    held = {(n, s, e) for n, s, e in trace_lib.under(trace, within)}
    events = [k for k in trace_lib.under(trace, span) if k in held]
  else:
    events = trace_lib.under(trace, span)
  if not events:
    return None
  return sum(e - s for _, s, e in events) / 1e3 / trace["steps"]


def launches_per_step(trace: dict) -> Optional[float]:
  """Device events (kernels, copies, sets; no annotation) a step."""
  if not trace["kernels"]:
    return None
  return len(trace["kernels"]) / trace["steps"]


def outside(trace: dict, spans=PHASES, top: int = 5) -> dict:
  """The device time of events launched under none of ``spans``: its
  share of all device time, and the largest by the innermost op that
  launched them (``"(no op)"`` where none held the launch)."""
  total, rest, by_op = 0.0, 0.0, {}
  for name, start, end, ops in trace["kernels"]:
    total += end - start
    if any(s in op for op in ops for s in spans):
      continue
    rest += end - start
    key = f"{ops[-1] if ops else '(no op)'} :: {trace_lib.short(name)[:60]}"
    by_op[key] = by_op.get(key, 0.0) + end - start
  return {"share_pct": 100.0 * rest / total if total else None,
          "ms_per_step": rest / 1e3 / trace["steps"],
          "largest": [[k, us / 1e3 / trace["steps"]] for k, us in
                      sorted(by_op.items(), key=lambda kv: -kv[1])[:top]]}


def ring_ms(events: List[dict]) -> Dict[str, float]:
  """Host milliseconds by span name over a ring's Chrome-trace events
  (each span's B to its E on one track, summed over its repeats)."""
  open_at: Dict[tuple, List[float]] = {}
  out: Dict[str, float] = {}
  for e in events:
    key = (e.get("tid"), e.get("name"))
    if e.get("ph") == "B":
      open_at.setdefault(key, []).append(e["ts"])
    elif e.get("ph") == "E" and open_at.get(key):
      t0 = open_at[key].pop()
      out[e["name"]] = out.get(e["name"], 0.0) + (e["ts"] - t0) / 1e3
  return out


def host_phase_ms(per_step: List[Dict[str, float]]) -> Dict[str, float]:
  """The median over steps of each span's host milliseconds."""
  names = sorted({n for step in per_step for n in step})
  return {n: statistics.median(step.get(n, 0.0) for step in per_step)
          for n in names}


def _timed_steps(step, state, pool, device, after=None):
  """``STEPS`` steps, each begun on an idle device: the state and the
  host seconds each call took to return (``after()`` runs after each
  call has returned)."""
  times = []
  for i in range(STEPS):
    run._sync(device)
    t = time.perf_counter()
    state, _ = step(state, pool[i % len(pool)], None)
    times.append(time.perf_counter() - t)
    if after is not None:
      after()
  run._sync(device)
  return state, times


def _window(step, state, pool, device, seconds, offset):
  """Back-to-back steps for ``seconds``, ended by a synchronize:
  ``(state, steps, wall seconds)``."""
  run._sync(device)
  n, t0 = 0, time.perf_counter()
  while time.perf_counter() - t0 < seconds:
    state, _ = step(state, pool[(offset + n) % len(pool)], None)
    n += 1
  run._sync(device)
  return state, n, time.perf_counter() - t0


def span_cost_us() -> dict:
  """Host microseconds of one span's enter and exit with neither a
  tracer nor a profiler on, beside the profiler check alone and an
  ungated ``record_function`` (what mirroring would cost if it were not
  gated)."""
  import torch
  from torch._C._autograd import _profiler_enabled
  from easyparallellibrary_tpu_torch.observability import trace as port
  out = {}

  def timed(key, body):
    t = time.perf_counter()
    body()
    out[key] = (time.perf_counter() - t) / SPAN_CALLS * 1e6

  def spans():
    for _ in range(SPAN_CALLS):
      with port.step_span("train/forward"):
        pass

  def checks():
    for _ in range(SPAN_CALLS):
      _profiler_enabled()

  def ranges():
    for _ in range(SPAN_CALLS):
      with torch.autograd.profiler.record_function("train/forward"):
        pass

  def empty():
    for _ in range(SPAN_CALLS):
      pass

  for key, body in (("loop", empty), ("span_off", spans),
                    ("profiler_check", checks),
                    ("record_function_ungated", ranges)):
    timed(key, body)
  return out


def measure(name: str, seed: int, cost_s: float, device, card: str) -> dict:
  import torch
  from torch.profiler import ProfilerActivity, profile
  from easyparallellibrary_tpu_torch.observability import trace as port
  from perfbench import roofline
  _, config, mix = run.cell_spec(name)
  fam = importlib.import_module(f"perfbench.families.{config['family']}")
  peaks = roofline.peaks(card)
  prog = fam.build(config, device)
  run.build_kernels(fam.KERNELS, device)
  _, state, step, pool, _ = run.program_readings(prog, fam, config, mix,
                                                 seed, device)
  out = {"workload": name, "seed": seed, "card": card,
         "power_limit_w": run._power_limit()}
  state, enqueue = _timed_steps(step, state, pool, device)
  out["host_enqueue_ms"] = 1e3 * statistics.median(enqueue)

  # A program without the step's spans (the commit before them) reads
  # no host phases and no tracing cost.
  spans = hasattr(port, "step_span")
  if spans:
    tracer = port.install(port.Tracer(enabled=True))
    per_step = []

    def harvest():
      per_step.append(ring_ms(tracer.events()))
      tracer.clear()

    try:
      state, traced = _timed_steps(step, state, pool, device, after=harvest)
    finally:
      port.install(None)
    host = host_phase_ms(per_step)
    out["host_phase_ms"] = host
    out["host_enqueue_traced_ms"] = 1e3 * statistics.median(traced)
    phase_sum = sum(host.get(p, 0.0) for p in PHASES)
    out["host_phase_sum_over_enqueue_pct"] = (
        100.0 * phase_sum / out["host_enqueue_ms"])

  cpu, cuda = [ProfilerActivity.CPU], [ProfilerActivity.CUDA]
  if device.type != "cuda":       # a rehearsal on the CPU
    cuda = []
  traces = {}
  for key, activities in (("device_trace", cuda or cpu),
                          ("trace", cpu + cuda)):
    with profile(activities=activities) as prof:
      run._sync(device)
      t = time.perf_counter()
      for i in range(STEPS):
        state, _ = step(state, pool[i % len(pool)], None)
      run._sync(device)
      traced_s = time.perf_counter() - t
    traces[key] = trace_lib.read(prof, traced_s, STEPS)
    del prof
  with profile(activities=cpu + cuda):
    state, profiled = _timed_steps(step, state, pool, device)
  out["host_enqueue_profiled_ms"] = 1e3 * statistics.median(profiled)

  dt, t = traces["device_trace"], traces["trace"]
  out["launches_per_step"] = launches_per_step(dt)
  out["device_busy_ms"] = dt["busy_s"] * 1e3 / STEPS
  out["device_ms"] = {
      "forward": device_ms(t, "train/forward"),
      "backward": device_ms(t, "train/backward"),
      "recompute": device_ms(t, "train/remat", within="train/backward"),
      "optimizer": device_ms(t, "train/optimizer"),
      "flash_delta": device_ms(t, "train/flash_delta"),
      "all": sum(e - s for _, s, e, _ in t["kernels"]) / 1e3 / STEPS}
  out["outside_phases"] = outside(t)
  out["idle_gaps"] = t["breakdown"]["idle_gaps"]
  readings = {"trace": t, "device_trace": dt,
              "attention_ops": fam.attention_ops(config, mix),
              "peak_flops": peaks["flops"][config["dtype"]],
              "peak_bytes_per_s": peaks["bytes_per_s"]}
  for metric in ("device_idle_share.train", "flash_device_share.train",
                 "flash_roofline"):
    out[metric] = run.reader(metric)(readings)

  if cost_s and spans:
    tokens = fam.tokens_per_step(config, mix)
    rates = {"off": [], "on": []}
    for i, arm in enumerate(["off", "on", "on", "off"] * COST_ROUNDS):
      port.install(port.Tracer(enabled=True) if arm == "on" else None)
      try:
        state, n, wall = _window(step, state, pool, device, cost_s, i)
      finally:
        port.install(None)
      rates[arm].append(n * tokens / wall)
    out["tokens_per_s"] = rates
    out["tracer_on_over_off_pct"] = 100.0 * (
        statistics.median(rates["on"]) / statistics.median(rates["off"])
        - 1.0)
    out["span_us"] = span_cost_us()
  del state, step, prog
  gc.collect()
  if device.type == "cuda":
    torch.cuda.empty_cache()
  return out


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seed", type=int, required=True)
  parser.add_argument("--cost", type=float, default=0.0,
                      help="seconds a window of the tracer's cost; 0: none")
  args = parser.parse_args(argv)
  for key, path in run.CACHES.items():
    path.mkdir(parents=True, exist_ok=True)
    os.environ[key] = str(path)
  import torch
  if not torch.cuda.is_available():
    print("phases: no CUDA device", file=sys.stderr)
    return 2
  device = torch.device("cuda", 0)
  out = measure(args.workload, args.seed, args.cost, device,
                torch.cuda.get_device_name(device))
  print(json.dumps(out), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
