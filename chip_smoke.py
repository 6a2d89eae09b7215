#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and
``nvcc``.  It drives the port's main path, the paged continuous-batching
engine of GPT-350M (``easyparallellibrary_tpu_torch``), and holds every
CUDA kernel of that path against its plain PyTorch version:

1. build the kernels from the checkout's sources (one ``nvcc`` per
   source, started together) and print the card's name and power limit;
2. each kernel against its plain version on the card, at the engine's
   full-width shapes and at the JAX package's test shapes, fp32 and bf16;
3. kernel, plain version and library-yardstick times (CUDA events), and
   the least time the card could take for the same work;
4. GPT-350M at full width in fp32: the paged engine's greedy streams
   against the port's ``generate(use_cache=False)``;
5. GPT-350M in bf16, serving staggered requests as users run it: tokens/s,
   TTFT and ITL from ``ServingStats``, and each kernel's launch count
   over this run (every launch counter set to 0 just before it); then
   its greedy streams against ``generate(use_cache=False)`` in bf16;
6. where the bf16 engine step's time goes: a ``torch.profiler`` window
   of engine steps under load (device busy and idle share, time by
   kernel).

Every phase raises on failure.  The second-to-last line of the output is
the ``{"kernels": [...]}`` record, the last one
``{"ok": true, "device": {...}}``.  Without a GPU, or outside a checkout
of the repository, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the peak rates the
# bound uses for each input type (fp32 without tensor cores, bf16 dense
# tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

GPT_350M = dict(vocab_size=32768, num_layers=24, num_heads=16, d_model=1024,
                d_ff=4096, max_seq_len=1024)
NUM_SLOTS, PREFILL_CHUNK, BLOCK_SIZE = 8, 128, 16
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_GAP_STEPS = 8
PROFILE_STEPS = 20


def log(msg: str) -> None:
  print(msg, flush=True)


class Phase:
  """Prints each phase's wall time."""

  def __init__(self, name: str):
    self.name = name

  def __enter__(self):
    self.t0 = time.monotonic()
    log(f"== {self.name}")
    return self

  def __exit__(self, *exc):
    if exc[0] is None:
      log(f"   {self.name}: {time.monotonic() - self.t0:.1f} s")
    return False


# ------------------------------------------------------------ kernel inputs


def paged_case(torch, dtype, seed, T, H, hd, NB, bs, MB, engine_like):
  """Paged-attention inputs on the card.  ``engine_like`` draws what the
  engine hands the kernel: each token a slot-like table whose live
  entries are distinct pool blocks and whose tail is the null block 0,
  positions spread over the whole context, and a few padding tokens
  (position 0, all-null table).  Otherwise the JAX test's draw."""
  r = np.random.RandomState(seed)
  q = r.randn(T, H, hd).astype(np.float32)
  kp = r.randn(NB, bs, H, hd).astype(np.float32)
  vp = r.randn(NB, bs, H, hd).astype(np.float32)
  if engine_like:
    positions = r.randint(0, MB * bs, (T,)).astype(np.int32)
    tables = np.zeros((T, MB), np.int32)
    for t in range(T):
      live = positions[t] // bs + 1
      tables[t, :live] = 1 + r.permutation(NB - 1)[:live]
    positions[-4:] = 0
    tables[-4:] = 0
  else:
    tables = r.randint(0, NB, (T, MB)).astype(np.int32)
    positions = r.randint(0, MB * bs, (T,)).astype(np.int32)
  floats = [torch.from_numpy(a).to("cuda", dtype) for a in (q, kp, vp)]
  ints = [torch.from_numpy(a).to("cuda") for a in (tables, positions)]
  return (*floats, *ints)


def paged_bound(torch, q, kp, tables, positions):
  """(least ms, "bytes" | "operations") for one paged-attention call on
  these inputs: the K/V rows it must read (each distinct pool row once),
  q, the live table entries, positions and the output, over the HBM
  rate; ~4 operations per attended K/V element over the input type's
  peak rate."""
  T, H, hd = q.shape
  bs, MB = kp.shape[1], tables.shape[1]
  pos = positions.cpu().numpy().astype(np.int64)
  tab = tables.cpu().numpy().astype(np.int64)
  last = np.minimum(pos, MB * bs - 1)
  rows = []
  for t in range(T):
    j = np.arange(last[t] + 1)
    rows.append(tab[t, j // bs] * bs + j % bs)
  distinct = np.unique(np.concatenate(rows)).size
  itemsize = q.element_size()
  nbytes = (2 * distinct * H * hd * itemsize + 2 * q.numel() * itemsize
            + 4 * int((last // bs + 1).sum()) + 4 * T)
  ops = 4 * int((last + 1).sum()) * H * hd
  dtype = str(q.dtype).replace("torch.", "")
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_paged_attention(torch, q, kp, vp, tables, positions):
  """Yardstick only (the port never calls it): gather the table rows,
  then ``scaled_dot_product_attention`` with a boolean causal mask."""
  T, H, hd = q.shape
  L = tables.shape[1] * kp.shape[1]
  idx = tables.long()
  kk = kp[idx].reshape(T, L, H, hd).transpose(1, 2)
  vv = vp[idx].reshape(T, L, H, hd).transpose(1, 2)
  mask = (torch.arange(L, device=q.device)[None, :]
          <= positions.long()[:, None])[:, None, None, :]
  out = torch.nn.functional.scaled_dot_product_attention(
      q[:, :, None, :], kk, vv, attn_mask=mask)
  return out[:, :, 0]


def time_ms(torch, fn, arg_sets, reps=7):
  """Median device time of one call, from CUDA events around a run of
  calls over ``arg_sets`` (several copies of the inputs, so each call
  finds its K/V cold in L2, as each layer's pool is in the engine).  A
  device sleep queued first keeps the host's launch time out of the
  measurement."""
  for args in arg_sets:
    fn(*args)
  torch.cuda.synchronize()
  samples = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for args in arg_sets:
      fn(*args)
    end.record()
    end.synchronize()
    samples.append(start.elapsed_time(end) / len(arg_sets))
  return statistics.median(samples)


# ------------------------------------------------------------------ phases


def build_kernels():
  from easyparallellibrary_tpu_torch.kernels import _build
  t0 = time.monotonic()
  reports = _build.build(_build.KERNELS)
  log(f"   built {list(reports)} in {time.monotonic() - t0:.1f} s")
  for name in _build.KERNELS:
    log(f"   {name}: {_build.library_path(name).name} (source+flags hash)")
  for name, report in reports.items():     # registers and spills, raw
    print(f"ptxas report of {name}:\n{report}", file=sys.stderr, flush=True)
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      timeout=60, check=True).stdout.strip()
  for line in smi.splitlines():
    print(line, flush=True)
  return smi


def kernel_parity(torch, pa):
  """Kernel vs plain version; returns max abs error per dtype."""
  shapes = [
      ("engine", dict(T=NUM_SLOTS + 2 * PREFILL_CHUNK, H=16, hd=64,
                      NB=NUM_SLOTS * 64 + 1, bs=BLOCK_SIZE, MB=64,
                      engine_like=True)),
      ("jax_parity_case", dict(T=6, H=4, hd=16, NB=9, bs=8, MB=4,
                               engine_like=False)),
      ("jax_tpu_case", dict(T=16, H=8, hd=64, NB=17, bs=16, MB=8,
                            engine_like=False)),
  ]
  errs = {}
  for dtype_name, tol in TOLERANCE.items():
    dtype = getattr(torch, dtype_name)
    worst = 0.0
    for seed, (label, shape) in enumerate(shapes):
      args = paged_case(torch, dtype, seed, **shape)
      got = pa.paged_attention(*args)   # the dispatcher: CUDA -> kernel
      want = pa.paged_attention_reference(*args)
      torch.cuda.synchronize()
      assert got.shape == want.shape and got.dtype == dtype
      assert bool(torch.isfinite(got).all()), f"{label}: non-finite"
      err = (got.float() - want.float()).abs().max().item()
      torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                 atol=tol, msg=lambda m: f"{label} "
                                 f"{dtype_name}: {m}")
      log(f"   {label:16s} {dtype_name:8s} max|kernel - plain| = {err:.3e} "
          f"(rtol = atol = {tol:g})")
      worst = max(worst, err)
    errs[dtype_name] = worst
  return errs


def kernel_timing(torch, pa):
  """Times at the engine's full-width shapes, per dtype."""
  T = NUM_SLOTS + 2 * PREFILL_CHUNK
  shape = dict(T=T, H=16, hd=64, NB=NUM_SLOTS * 64 + 1, bs=BLOCK_SIZE,
               MB=64, engine_like=True)
  out = {}
  for dtype_name in TOLERANCE:
    dtype = getattr(torch, dtype_name)
    sets = [paged_case(torch, dtype, 100 + i, **shape) for i in range(4)]
    bound, bound_by = paged_bound(torch, *[sets[0][i] for i in (0, 1, 3, 4)])
    lib = lambda *a: library_paged_attention(torch, *a)  # noqa: E731
    row = {
        "kernel_ms": time_ms(torch, pa.paged_attention_cuda, sets),
        "plain_ms": time_ms(torch, pa.paged_attention_reference, sets,
                            reps=3),
        "library_ms": time_ms(torch, lib, sets, reps=3),
        "bound_ms": bound, "bound_by": bound_by,
    }
    log(f"   {dtype_name:8s} T={T} H=16 hd=64 bs={BLOCK_SIZE} MB=64: "
        + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in row.items()))
    out[dtype_name] = row
  return out


def make_prompts(seed, n, vocab):
  r = np.random.RandomState(seed)
  lengths = r.randint(64, 513, n)
  return [r.randint(0, vocab, (int(k),)).astype(np.int32) for k in lengths]


def greedy_vs_generate(torch, model, params, prompts, out, max_gap, label):
  """Each request's engine stream ``out[i]`` against the port's
  ``generate(use_cache=False)``.  Where a stream first differs, the
  reference's top-2 logit gap there must be below ``max_gap(top1)``: a
  near-tie that rounding in another order may flip.  Returns the number
  of equal streams."""
  from easyparallellibrary_tpu_torch.models.gpt import generate
  equal = 0
  for i, p in enumerate(prompts):
    got = out[i]
    new = len(got) - len(p)
    want = generate(model, params, torch.from_numpy(p[None]).long().cuda(),
                    new, use_cache=False)[0].cpu().numpy()
    assert got.shape == want.shape == (len(p) + new,)
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
      equal += 1
      continue
    k = int(diff[0])
    with torch.inference_mode():
      logits = torch.func.functional_call(
          model, params, (torch.from_numpy(want[None, :k]).long().cuda(),))
    top2 = torch.topk(logits[0, k - 1].float(), 2).values
    gap, limit = (top2[0] - top2[1]).item(), max_gap(top2[0].item())
    log(f"   {label} request {i}: streams differ first at position {k} "
        f"(prompt {len(p)}); reference top-2 logit gap {gap:.3e} "
        f"(limit {limit:.3e})")
    assert gap < limit, f"{label} request {i} diverged at a gap of {gap}"
  log(f"   {label}: {equal}/{len(prompts)} greedy streams equal generate("
      f"use_cache=False)")
  return equal


def engine_fp32_vs_generate(torch, params):
  """Full width, fp32: engine greedy streams vs ``generate(use_cache=
  False)``, diverging only at a top-2 gap below 1e-3."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = GPTConfig(**GPT_350M, dtype=torch.float32)
  model = GPT(cfg)
  prompts = make_prompts(1, NUM_SLOTS, cfg.vocab_size)
  eng = ContinuousBatchingEngine(model, params, paged=True,
                                 num_slots=NUM_SLOTS,
                                 prefill_chunk=PREFILL_CHUNK,
                                 block_size=BLOCK_SIZE)
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
  out = eng.run()
  assert eng.scheduler.kv_blocks_used == 0
  log(f"   engine steps {eng.steps}")
  greedy_vs_generate(torch, model, params, prompts, out,
                     lambda top1: 1e-3, "fp32")


def bf16_gap_limit(top1):
  """``BF16_GAP_STEPS`` bf16 spacings at the top logit's magnitude: the
  engine and the reference round in other places in each layer, so
  their bf16 logits may differ by a few spacings; a fault in the bf16
  path shows as a divergence at a clear winner."""
  eps = 2.0 ** -7                       # torch.finfo(torch.bfloat16).eps
  return BF16_GAP_STEPS * eps * 2.0 ** np.floor(np.log2(max(abs(top1),
                                                            1e-30)))


def engine_bf16_serving(torch, params, pa):
  """Full width, bf16, staggered submits; the main path's launch counts,
  then the greedy streams against ``generate(use_cache=False)`` in
  bf16.  Returns the launch count and the engine."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  cfg = GPTConfig(**GPT_350M, dtype=torch.bfloat16)
  stats = ServingStats()
  model = GPT(cfg)
  eng = ContinuousBatchingEngine(model, params, paged=True,
                                 num_slots=NUM_SLOTS,
                                 prefill_chunk=PREFILL_CHUNK,
                                 block_size=BLOCK_SIZE, stats=stats)
  prompts = make_prompts(2, 16, cfg.vocab_size)
  waves = [(0, 8), (8, 12), (12, 16)]
  pa.paged_attention_cuda.launches = 0
  pa.paged_attention_reference.calls = 0
  t0 = time.monotonic()
  out = {}
  for w, (a, b) in enumerate(waves):
    for i in range(a, b):
      eng.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=32))
    for _ in range(3 if w < len(waves) - 1 else 0):
      for fin in eng.step():
        out[fin.uid] = fin.tokens
  out.update(eng.run())
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  launches = pa.paged_attention_cuda.launches
  plain_calls = pa.paged_attention_reference.calls
  assert launches == cfg.num_layers * eng.steps, (launches, eng.steps)
  assert launches > 0
  assert plain_calls == 0, plain_calls
  assert sorted(out) == list(range(16))
  for i, p in enumerate(prompts):
    assert eng.finished[i].finish_reason == "length"
    assert out[i].shape == (len(p) + 32,)
    np.testing.assert_array_equal(out[i][:len(p)], p)
    assert ((out[i] >= 0) & (out[i] < cfg.vocab_size)).all()
  assert eng.scheduler.kv_blocks_used == 0
  s = stats.summary()
  log(f"   {len(prompts)} requests, {eng.steps} engine steps, {wall:.2f} s "
      f"wall; tokens/s {s['tokens_per_s']:.1f}, TTFT p50 "
      f"{s['ttft_p50_s'] * 1e3:.1f} ms p99 {s['ttft_p99_s'] * 1e3:.1f} ms, "
      f"ITL p50 {s['itl_p50_s'] * 1e3:.2f} ms, prefill tokens/s "
      f"{s['prefill_tokens_per_s']:.1f}")
  log(f"   paged_attention kernel launches {launches} = {cfg.num_layers} "
      f"layers x {eng.steps} steps; plain-version calls {plain_calls}")
  greedy_vs_generate(torch, model, eng.params, prompts, out,
                     bf16_gap_limit, "bf16")
  return launches, eng


def _busy_us(intervals):
  """Length of the union of ``(start, end)`` intervals."""
  total, cur_start, cur_end = 0.0, None, None
  for start, end in sorted(intervals):
    if cur_end is None or start > cur_end:
      if cur_end is not None:
        total += cur_end - cur_start
      cur_start, cur_end = start, end
    else:
      cur_end = max(cur_end, end)
  if cur_end is not None:
    total += cur_end - cur_start
  return total


def step_breakdown(torch, eng):
  """Where a bf16 engine step's time goes: ``PROFILE_STEPS`` public
  ``step()`` calls under a full load of 16 requests (96 new tokens
  each, 8 of them admitted mid-flight), profiled with ``torch.profiler``
  (CPU and CUDA activities).  Prints host wall and device busy time per
  step, the device's idle share, the host time outside the device step
  (scheduler planning, from ``ServingStats`` step times) and device time
  by kernel."""
  from torch.profiler import ProfilerActivity, profile
  from easyparallellibrary_tpu_torch.serving import Request
  prompts = make_prompts(3, 16, eng.model.cfg.vocab_size)
  for i in range(16):
    eng.submit(Request(uid=f"profile-{i}", prompt=prompts[i],
                       max_new_tokens=96))
    if i == 7:
      for _ in range(6):                # warm, then the second wave joins
        eng.step()
  steps0, busy0 = eng.steps, eng.stats.busy_time_s
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
      eng.step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
  n = eng.steps - steps0
  assert n == PROFILE_STEPS, f"the load drained after {n} steps"
  outside_us = wall_us - (eng.stats.busy_time_s - busy0) * 1e6
  eng.run()
  kernels, intervals = {}, []
  for e in prof.events():
    start, end = e.time_range.start, e.time_range.end
    if e.device_type != torch.autograd.DeviceType.CUDA or end <= start:
      continue
    intervals.append((start, end))
    calls, us = kernels.get(e.name, (0, 0.0))
    kernels[e.name] = (calls + 1, us + end - start)
  busy_us = _busy_us(intervals)
  device_us = sum(us for _, us in kernels.values())
  paged_us = sum(us for name, (_, us) in kernels.items()
                 if "paged_attention_kernel" in name)
  assert paged_us > 0, "the profile holds no paged-attention kernel"
  log(f"   {n} steps, profiler on: host wall {wall_us / n / 1e3:.3f} "
      f"ms/step, device busy {busy_us / n / 1e3:.3f} ms/step, idle share "
      f"{1 - busy_us / wall_us:.3f}; host outside the device step "
      f"{outside_us / n / 1e3:.3f} ms/step; kernel launches "
      f"{sum(c for c, _ in kernels.values()) / n:.1f}/step; paged "
      f"attention {paged_us / n / 1e3:.3f} ms/step "
      f"({paged_us / device_us:.3f} of device time)")
  log(f"   {'device ms/step':>14s} {'share':>6s} {'calls/step':>10s}  kernel")
  for name, (calls, us) in sorted(kernels.items(),
                                  key=lambda kv: -kv[1][1])[:12]:
    log(f"   {us / n / 1e3:14.4f} {us / device_us:6.3f} {calls / n:10.1f}  "
        f"{name[:100]}")


def main() -> int:
  try:
    import torch
  except ImportError:
    print("chip_smoke: PyTorch is not installed", file=sys.stderr)
    return 2
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    return 2
  if not (ROOT / "easyparallellibrary_tpu_torch").is_dir():
    print("chip_smoke: run it from a checkout of the repository (the "
          "easyparallellibrary_tpu_torch package is missing)",
          file=sys.stderr)
    return 2
  sys.path.insert(0, str(ROOT))
  from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
  from easyparallellibrary_tpu_torch.models.gpt import GPTConfig
  from easyparallellibrary_tpu_torch.weights import init_params

  t_start = time.monotonic()
  log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
      f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
  with Phase("1. build kernels"):
    build_kernels()
  with Phase("2. kernel vs plain version"):
    errs = kernel_parity(torch, pa)
  with Phase("3. kernel timing"):
    times = kernel_timing(torch, pa)
  with Phase("init GPT-350M weights (numpy, seed 0)"):
    params = init_params(GPTConfig(**GPT_350M), seed=0, device="cuda")
  with Phase("4. GPT-350M fp32: engine vs generate(use_cache=False)"):
    engine_fp32_vs_generate(torch, params)
  with Phase("5. GPT-350M bf16: serving staggered requests"):
    launches, eng = engine_bf16_serving(torch, params, pa)
  with Phase("6. GPT-350M bf16: where the engine step's time goes"):
    step_breakdown(torch, eng)
  log(f"total {time.monotonic() - t_start:.1f} s")

  bf16 = times["bfloat16"]
  print(json.dumps({"kernels": [{
      "name": "paged_attention",
      "route": "cuda",
      "source": "easyparallellibrary_tpu_torch/kernels/csrc/"
                "paged_attention.cu",
      "replaces": "easyparallellibrary_tpu/kernels/paged_attention.py:119",
      "launches": launches,
      "max_abs_err": max(errs.values()),
      "ms": bf16["kernel_ms"],
      "plain_ms": bf16["plain_ms"],
      "bound_ms": bf16["bound_ms"],
      "bound_by": bf16["bound_by"],
      "library_ms": bf16["library_ms"],
      "parity_fp32": errs["float32"],
      "parity_bf16": errs["bfloat16"],
      "kernel_ms": bf16["kernel_ms"],
      "fp32": times["float32"],
  }]}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
