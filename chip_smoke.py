#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and
``nvcc``.  It drives the port's two main paths at the full width of
GPT-350M (``easyparallellibrary_tpu_torch``) — the paged
continuous-batching engine (plain, speculative, with the prefix cache),
and the training step of ``bench.py`` — and holds every CUDA kernel of
those paths against its plain PyTorch version:

1. build the kernels from the checkout's sources (one ``nvcc`` per
   source, started together) and print the card's name and power limit;
2. paged attention against its plain version on the card, fp32 and
   bf16, at an engine step (``engine_step``: decode tokens, two prefill
   chunks and padding, as the scheduler lays them out; at head dim 64
   and 128), at three steps of the real scheduler (``spec_step``:
   decode tokens with their k = 4 draft runs, a prefill chunk, padding;
   ``rollout_step``: a draft model's four one-token-per-slot calls on
   one tile plan, crossing a split boundary; ``warm_prefix_step``: a
   chunk from position 256 over blocks another slot shares), at the
   earlier random-table engine shape and at the JAX package's test
   shapes; bf16 at head dim 64 and 128 runs the slot-tiled build, with
   the planner's tiles and with derived tiles;
3. kernel, plain version and library-yardstick times (CUDA events) at
   ``engine_step``, at ``spec_step`` and at the random-table shape, the
   warp build beside the tiled one in bf16, and the least time the card
   could take for the same work;
4. GPT-350M at full width in fp32: the paged engine's greedy streams
   against the port's ``generate(use_cache=False)``, with the warp
   build's launch count over the run (counts set to 0 just before it);
5. GPT-350M in bf16, serving staggered requests as users run it: tokens/s,
   TTFT and ITL from ``ServingStats``, and each kernel's launch count
   over this run (every launch counter set to 0 just before it); then
   its greedy streams against ``generate(use_cache=False)`` in bf16;
6. where the bf16 engine step's time goes: a ``torch.profiler`` window
   of engine steps under load (device busy and idle share, time by
   kernel);
7. the three flash-attention kernels (forward, dK/dV, dQ) against their
   plain versions, fp32 and bf16, causal and not, at the training shape
   (batch cut to 2), the JAX tests' shapes, a ragged length across heads
   and head dim 128 (bf16 by normalized error); the bf16 limits against
   plain versions with one fault each; and ``flash_attention_lse`` with
   an lse cotangent through autograd against plain autograd;
8. flash kernel, plain version and library-yardstick times at the
   training shape (B=16, H=16, S=1024, D=64, causal, bf16; SDPA's
   forward, and its backward alone for the backward kernels), each
   kernel's bound, and each wrapper's host time per call;
9. GPT-350M widths at 4 layers in fp32: 3 AdamW steps with the flash
   kernels against 3 with dense attention, losses and launch counts;
10. GPT-350M bf16 training through ``easyparallellibrary_tpu_torch.bench``
    (its one JSON record), with each flash kernel's launch count over the
    run (counts set to 0 just before it);
11. where a bf16 training step's time goes: a ``torch.profiler`` window
    of training steps at phase 10's batch (device time by kernel, the
    flash kernels' share);
12. GPT-350M bf16, speculative serving: phase 5's staggered load over
    prompts whose spans repeat, with the n-gram drafter and then with the
    target's own weights as the draft model: tokens/s, TTFT, ITL,
    drafted / accepted tokens, the target's and the draft model's
    launches against layers x calls, streams against ``generate(
    use_cache=False)``, an acceptance floor for the self-draft run, and
    a ``torch.profiler`` window of the n-gram engine's steps;
13. GPT-350M bf16, prefix caching: 16 requests sharing a 256-token
    system prompt, then 8 second turns, with the cache off and on: hits,
    blocks reused, prefill tokens saved, TTFT of the same requests in
    both runs, the shared blocks' pool rows unchanged, streams against
    ``generate(use_cache=False)``, launch counts;
14. the contiguous-slot engine, the default serving layout (8 slots,
    chunk 128): fp32 streams against ``generate(use_cache=False)``;
    bf16 under phase 5's staggered load (tokens/s, TTFT, ITL, the bf16
    gap rule, no paged-attention launch); n-gram and a short self-draft
    run on the slot layout (the acceptance floor); a ``torch.profiler``
    window of its steps;
15. serving resilience, bf16, on the paged engine (prefix cache on) and
    the contiguous one: a fault-free resilient run token-equal to the
    same engine without resilience (both runs' host ms per step), a
    transient and a persistent ``NaNLogitsInjector`` fault (streams
    against the fault-free run, the counters), and the poisoned rows read
    back as zero right after the bad step (shared prefix blocks
    bit-identical);
16. amp O1 and the fp16 builds: the fp16 flash kernels against their
    plain versions at phase 7's shapes and the fp16 warp paged kernel at
    ``engine_step`` and ``spec_step`` (normalized-error limits, their
    sensitivity to faults), each timed beside its plain version, its
    bound and SDPA in fp16; the bench's training step with an fp32
    GPTConfig under ``amp.level=O1`` against the explicit-bf16 config
    (equal losses); O1-fp16 training at 4 layers (fp16 flash launches);
    a short O1-fp16 paged serving run through the fp16 warp build.

Every phase raises on failure.  The second-to-last line of the output is
the ``{"kernels": [...]}`` record, the last one
``{"ok": true, "device": {...}}``.  Without a GPU, or outside a checkout
of the repository, it exits with code 2 and prints no result.
``python3 chip_smoke.py --phases 2,3`` runs the build and the listed
phases only (5 and 6, 10 and 11 run together) and prints no result
lines.  ``--phases 14,15,16`` runs this slice's: the contiguous engine,
serving resilience, amp O1 and the fp16 builds.
"""

from __future__ import annotations

import gc
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
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

GPT_350M = dict(vocab_size=32768, num_layers=24, num_heads=16, d_model=1024,
                d_ff=4096, max_seq_len=1024)
NUM_SLOTS, PREFILL_CHUNK, BLOCK_SIZE = 8, 128, 16
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
# Flash attention, fp32: the JAX tests' tolerances (forward rtol 2e-5 /
# atol 2e-6, gradients 5e-4 / 1e-5).
FLASH_TOLERANCE = dict(fwd=(2e-5, 2e-6), grad=(5e-4, 1e-5))
# bf16: the kernels and the plain versions round p and dS at the same
# points, from scores summed in another order (and the forward rounds p
# against a running max), so a value may land on the other side of a
# bf16 rounding.  Elementwise limits would have to allow for the largest
# values; instead each output is held, per shape, to a normalized error:
# ||kernel - plain|| / ||plain|| and max|kernel - plain| / max|plain|.
# The limits are 2-4 times the largest reading over the shapes here on
# an H100 (out 2.3e-3 / 4.7e-3, gradients 1.2e-4 / 3.3e-3), which
# tests/test_torch_gpu.py's shapes also meet, and
# flash_check_sensitivity shows the faults they catch.
FLASH_BF16_LIMIT = {"fwd": dict(rel_l2=5e-3, max_rel=1e-2),
                    "grad": dict(rel_l2=5e-4, max_rel=1e-2)}
# fp16 (the CUDA-core builds instantiated for __half): the same rule.
# The largest readings over phase 7's shapes on an NVIDIA H100 80GB HBM3
# at 700 W: out 2.8e-4 /
# 7.0e-4; the gradients 0 (the CUDA-core backward sums in the order of
# the plain version's fp32 products, and fp16 output hides the rest).
# The forward limits are 3.5 / 2.9 times its readings; the gradient
# limits catch every fault flash_check_sensitivity must catch, at 0.6 /
# 0.4 of the smallest such reading (tests/test_torch_gpu.py holds its
# shapes to them).
FLASH_FP16_LIMIT = {"fwd": dict(rel_l2=1e-3, max_rel=2e-3),
                    "grad": dict(rel_l2=2e-4, max_rel=2e-3)}
# The fp16 warp paged build against its plain version (p rounded after
# a running max there, after the full softmax in the plain version):
# 1.8 / 2.1 times the largest readings (5.6e-4 / 9.4e-4, at rollout_step;
# NVIDIA H100 80GB HBM3, 700 W), and below p rounded to bf16 (1.26e-3).
PAGED_FP16_LIMIT = dict(rel_l2=1e-3, max_rel=2e-3)
# The training shape (batch cut to 2), the JAX tests' shapes, a ragged
# length whose last tile of each head runs past S (B*H > 1), and the
# wgmma kernels' second head dim.
FLASH_SHAPES = [("training_b2", dict(B=2, H=16, S=1024, D=64)),
                ("jax_qkv", dict(B=2, H=2, S=128, D=32)),
                ("jax_multiblock", dict(B=2, H=2, S=256, D=32)),
                ("ragged_s200", dict(B=2, H=3, S=200, D=64)),
                ("d128", dict(B=2, H=4, S=384, D=128))]
FLASH_BENCH_SHAPE = dict(B=16, H=16, S=1024, D=64)
TRAIN_FP32_LAYERS, TRAIN_FP32_BATCH, TRAIN_FP32_STEPS = 4, 4, 3
TRAIN_PROFILE_STEPS = 2
BF16_GAP_STEPS = 8
SPEC_K = 4                  # serving.speculative.k's default
# Phase 12's self-draft acceptance floor.  The first run on an H100 read
# 0.9486 (351 of 370 drafts): the draft model is the target, and only
# bf16 near-ties between its 8-row rollout products and the 264-row
# verify step's flip a draft.  A draft attending the wrong slot's K/V
# would be rejected nearly always, driving acceptance towards 0.
SELF_DRAFT_ACCEPTANCE_FLOOR = 0.8
PROFILE_STEPS = 20
# Phase 15: the injected faults (step-call indices after the load's
# prefill has started), and phase 16's O1-fp16 training cut.
TRANSIENT_FAULT, PERSISTENT_FAULT = (6,), (6, 7)
O1_FP16_LAYERS, O1_FP16_BATCH, O1_STEPS = 4, 4, 3


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


def engine_step_case(torch, dtype, seed, H=16, hd=64):
  """One engine step as ``FCFSScheduler._plan_flat`` lays it out, at the
  engine's geometry (T = 264, bs = 16, MB = 64, 8 slots): 6 decoding
  slots at positions drawn from 64-543, 2 prefilling slots each with a
  128-token chunk at [p, p + 128), p in {0, 128, 256, 384}, the rest
  padding (slot 0, position 0); every slot its own distinct blocks.
  Returns the kernel's inputs on the card and the plan's tile runs."""
  from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
  T, bs, MB = NUM_SLOTS + 2 * PREFILL_CHUNK, BLOCK_SIZE, 64
  NB = NUM_SLOTS * MB + 1
  r = np.random.RandomState(seed)
  q = r.randn(T, H, hd).astype(np.float32)
  kp = r.randn(NB, bs, H, hd).astype(np.float32)
  vp = r.randn(NB, bs, H, hd).astype(np.float32)
  blocks = 1 + r.permutation(NB - 1)
  tables = np.zeros((NUM_SLOTS, MB), np.int32)
  slot_ids = np.zeros((T,), np.int32)
  positions = np.zeros((T,), np.int32)
  base_idx = np.zeros((NUM_SLOTS,), np.int32)
  num_valid = np.zeros((NUM_SLOTS,), np.int32)
  pos = 0
  for slot in range(NUM_SLOTS):
    if slot < 6:
      first, n = r.randint(64, 544), 1
    else:
      first, n = 128 * r.randint(0, 4), PREFILL_CHUNK
    base_idx[slot], num_valid[slot] = pos, n
    slot_ids[pos:pos + n] = slot
    positions[pos:pos + n] = np.arange(first, first + n)
    live = (first + n - 1) // bs + 1
    tables[slot, :live] = blocks[slot * MB:slot * MB + live]
    pos += n
  floats = [torch.from_numpy(a).to("cuda", dtype) for a in (q, kp, vp)]
  ints = [torch.from_numpy(a).to("cuda") for a in (tables[slot_ids],
                                                   positions)]
  return (*floats, *ints), pa.tile_runs_from_plan(base_idx, num_valid, T)


def scheduled_step_case(torch, dtype, seed, kind, H=16, hd=64):
  """Paged-attention calls at a step of the port's real scheduler, at
  the engine's geometry (``testing.step_plans``: 8 slots, chunk 128, bs
  16, token budget 264, k = 4).  ``kind``: "spec_step" (7 decode tokens
  with their k = 4 draft runs, partly filled, a 128-token prefill chunk
  and padding), "warm_prefix_step" (the same with the prefix cache on:
  the chunk starts at position 256 over blocks that another slot's
  table holds) or "rollout_step" (a draft model's 4 one-token-per-slot
  calls, slot 0's crossing position 256, a split boundary).  Returns
  ``[(args, plan_positions, runs)]``, one per call: the kernel's inputs
  on the card, and the positions and runs the planner plans the call's
  tiles from (the rollout's last call's, for all four)."""
  from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
  from easyparallellibrary_tpu_torch.testing import step_plans
  plan = step_plans.scheduled_step(seed, num_slots=NUM_SLOTS,
                                   chunk=PREFILL_CHUNK,
                                   block_size=BLOCK_SIZE,
                                   warm=kind == "warm_prefix_step")
  MB = plan.block_tables.shape[1]
  NB = NUM_SLOTS * MB + 1
  if kind == "rollout_step":
    calls = step_plans.rollout_positions(plan, 4, cross=256)
    tables = plan.block_tables
    runs = pa.one_row_runs(NUM_SLOTS)
  else:
    calls = [plan.positions]
    tables = plan.block_tables[plan.slot_ids]
    runs = pa.tile_runs_from_plan(plan.base_idx, plan.num_valid,
                                  len(plan.positions), plan.draft_base,
                                  plan.draft_cap)
  r = np.random.RandomState(seed)
  floats = [torch.from_numpy(r.randn(*s).astype(np.float32)).to("cuda",
                                                                 dtype)
            for s in ((len(tables), H, hd), (NB, BLOCK_SIZE, H, hd),
                      (NB, BLOCK_SIZE, H, hd))]
  tables = torch.from_numpy(np.ascontiguousarray(tables)).to("cuda")
  return [((*floats, tables, torch.from_numpy(p).to("cuda")), calls[-1],
           runs) for p in calls]


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


def paged_tiles(pa, args, runs=None, plan_positions=None):
  """The tile plan of one paged-attention batch: the given runs (planned
  from ``plan_positions``, by default the batch's own), or those
  derived from the batch itself."""
  q, kp, _, tables, positions = args
  pos = positions.cpu().numpy()
  if runs is None:
    runs = pa.tile_runs_from_tokens(tables.cpu().numpy(), pos)
  return pa.plan_tiles(runs, pos if plan_positions is None
                       else plan_positions, tables.shape[1], kp.shape[1],
                       q.shape[1], q.device)


def kernel_parity(torch, pa):
  """Kernel vs plain version; returns max abs error per dtype.  Where
  the tiled build takes a case, it runs with derived tiles (the
  dispatcher's own plan) and, at ``engine_step`` and at the scheduler's
  speculative, rollout and warm-prefix steps, also with the planner's
  tiles."""
  shapes = [
      ("engine_step", None, dict()),
      ("engine_step_hd128", None, dict(H=8, hd=128)),
      ("random_tables", dict(T=NUM_SLOTS + 2 * PREFILL_CHUNK, H=16, hd=64,
                             NB=NUM_SLOTS * 64 + 1, bs=BLOCK_SIZE, MB=64,
                             engine_like=True), None),
      ("jax_parity_case", dict(T=6, H=4, hd=16, NB=9, bs=8, MB=4,
                               engine_like=False), None),
      ("jax_tpu_case", dict(T=16, H=8, hd=64, NB=17, bs=16, MB=8,
                            engine_like=False), None),
  ] + [(f"{kind}{sfx}", None, dict(kind=kind, **geo))
       for kind in ("spec_step", "rollout_step", "warm_prefix_step")
       for sfx, geo in (("", {}), ("_hd128", dict(H=8, hd=128)))]
  errs = {}
  for dtype_name, tol in TOLERANCE.items():
    dtype = getattr(torch, dtype_name)
    worst = 0.0
    for seed, (label, shape, step) in enumerate(shapes):
      if shape is not None:
        calls = [(paged_case(torch, dtype, seed, **shape), None, None)]
      elif "kind" in step:
        calls = scheduled_step_case(torch, dtype, seed, **step)
      else:
        args, runs = engine_step_case(torch, dtype, seed, **step)
        calls = [(args, None, runs)]
      err = 0.0
      for args, plan_pos, runs in calls:
        tiled = pa.takes_tiles(dtype, args[0].shape[2])
        before = pa.paged_attention_tiled_cuda.launches
        outs = [pa.paged_attention(*args)]  # the dispatcher -> the kernel
        if tiled and runs is not None:
          outs.append(pa.paged_attention(
              *args, paged_tiles(pa, args, runs, plan_pos)))
        want = pa.paged_attention_reference(*args)
        torch.cuda.synchronize()
        assert (pa.paged_attention_tiled_cuda.launches - before
                == (len(outs) if tiled else 0)), label
        for got in outs:
          assert got.shape == want.shape and got.dtype == dtype
          assert bool(torch.isfinite(got).all()), f"{label}: non-finite"
          err = max(err, (got.float() - want.float()).abs().max().item())
          torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                     atol=tol, msg=lambda m: f"{label} "
                                     f"{dtype_name}: {m}")
      build = "tiled" if tiled else "warp"
      log(f"   {label:22s} {dtype_name:8s} {build:5s} max|kernel - plain| "
          f"= {err:.3e} (rtol = atol = {tol:g})"
          + (", planner and derived tiles" if len(outs) > 1 else "")
          + (f", {len(calls)} calls on one plan" if len(calls) > 1 else ""))
      worst = max(worst, err)
    errs[dtype_name] = worst
  return errs


def kernel_timing(torch, pa):
  """Times per dtype at ``engine_step``, at the scheduler's speculative
  step (``spec_step``) and at the random-table shape of earlier PRs: the
  kernel the dispatcher takes (in bf16 the tiled build,
  over tiles planned before the timed window, as the engine plans them
  once per step), in bf16 also the warp build, the plain version, the
  gather + SDPA yardstick and the bound."""
  random_shape = dict(T=NUM_SLOTS + 2 * PREFILL_CHUNK, H=16, hd=64,
                      NB=NUM_SLOTS * 64 + 1, bs=BLOCK_SIZE, MB=64,
                      engine_like=True)
  out = {}
  for dtype_name in TOLERANCE:
    dtype = getattr(torch, dtype_name)
    for label in ("engine_step", "spec_step", "random_tables"):
      if label == "engine_step":
        cases = [engine_step_case(torch, dtype, 100 + i) for i in range(4)]
      elif label == "spec_step":
        cases = [(args, runs) for i in range(4) for args, _, runs in
                 scheduled_step_case(torch, dtype, 100 + i, label)]
      else:
        cases = [(paged_case(torch, dtype, 100 + i, **random_shape), None)
                 for i in range(4)]
      sets = [args for args, _ in cases]
      kernel_sets = sets
      if pa.takes_tiles(dtype, sets[0][0].shape[2]):
        kernel_sets = [(*args, paged_tiles(pa, args, runs))
                       for args, runs in cases]
      bound, bound_by = paged_bound(torch, *[sets[0][i] for i in (0, 1, 3,
                                                                  4)])
      lib = lambda *a: library_paged_attention(torch, *a)  # noqa: E731
      row = {"kernel_ms": time_ms(torch, pa.paged_attention_cuda,
                                  kernel_sets)}
      if kernel_sets is not sets:
        row["warp_build_ms"] = time_ms(torch, pa.paged_attention_warp_cuda,
                                       sets)
        row["kernel_ms_again"] = time_ms(torch, pa.paged_attention_cuda,
                                         kernel_sets)
      row.update(plain_ms=time_ms(torch, pa.paged_attention_reference, sets,
                                  reps=3),
                 library_ms=time_ms(torch, lib, sets, reps=3),
                 bound_ms=bound, bound_by=bound_by)
      log(f"   {dtype_name:8s} {label:13s} T={sets[0][0].shape[0]} H=16 hd=64 "
          f"bs={BLOCK_SIZE} MB=64: "
          + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in row.items()))
      out[(dtype_name, label)] = row
  return out


def make_prompts(seed, n, vocab):
  r = np.random.RandomState(seed)
  lengths = r.randint(64, 513, n)
  return [r.randint(0, vocab, (int(k),)).astype(np.int32) for k in lengths]


def greedy_vs_generate(torch, model, params, prompts, out, max_gap, label,
                       refs=None, ref_name="generate(use_cache=False)"):
  """Each request's engine stream ``out[i]`` against the port's
  ``generate(use_cache=False)`` (kept in ``refs`` by prompt index, when
  given, for a later run over the same prompts).  Where a stream first
  differs, the reference's top-2 logit gap there must be below
  ``max_gap(top1)``: a near-tie that rounding in another order may
  flip.  Returns the number of equal streams."""
  from easyparallellibrary_tpu_torch.models.gpt import generate
  refs = {} if refs is None else refs
  equal = 0
  for i, p in enumerate(prompts):
    got = out[i]
    new = len(got) - len(p)
    if i not in refs:
      refs[i] = generate(model, params,
                         torch.from_numpy(p[None]).long().cuda(), new,
                         use_cache=False)[0].cpu().numpy()
    want = refs[i]
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
  log(f"   {label}: {equal}/{len(prompts)} greedy streams equal "
      f"{ref_name}")
  return equal


def engine_fp32_vs_generate(torch, params, pa, refs):
  """Full width, fp32: engine greedy streams vs ``generate(use_cache=
  False)`` (kept in ``refs`` for phase 14), diverging only at a top-2 gap
  below 1e-3.  fp32 runs the paged kernel's warp build: returns its
  launch count over the run."""
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
  pa.reset_counts()
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
  out = eng.run()
  torch.cuda.synchronize()
  launches = pa.paged_attention_warp_cuda.launches
  assert launches == cfg.num_layers * eng.steps > 0, (launches, eng.steps)
  assert pa.paged_attention_tiled_cuda.launches == 0
  assert pa.paged_attention_reference.calls == 0
  assert eng.scheduler.kv_blocks_used == 0
  log(f"   engine steps {eng.steps}; warp-build launches {launches} = "
      f"{cfg.num_layers} layers x {eng.steps} steps")
  greedy_vs_generate(torch, model, params, prompts, out,
                     lambda top1: 1e-3, "fp32", refs)
  return launches


def bf16_gap_limit(top1, eps=2.0 ** -7):
  """``BF16_GAP_STEPS`` bf16 spacings at the top logit's magnitude: the
  engine and the reference round in other places in each layer, so
  their bf16 logits may differ by a few spacings; a fault in the bf16
  path shows as a divergence at a clear winner.  ``eps`` is the type's
  (``torch.finfo(torch.bfloat16).eps``; fp16's is 2^-10)."""
  return BF16_GAP_STEPS * eps * 2.0 ** np.floor(np.log2(max(abs(top1),
                                                            1e-30)))


def drive_waves(eng, request_cls, prompts, max_new=32):
  """Phase 5's staggered load: 8 requests, 3 steps, 4 more, 3 steps, the
  last 4, then until the queue drains.  Returns ``{index: tokens}``."""
  out = {}
  waves = [(0, 8), (8, 12), (12, 16)]
  for w, (a, b) in enumerate(waves):
    for i in range(a, b):
      eng.submit(request_cls(uid=i, prompt=prompts[i],
                             max_new_tokens=max_new))
    for _ in range(3 if w < len(waves) - 1 else 0):
      for fin in eng.step():
        out[fin.uid] = fin.tokens
  out.update(eng.run())
  return out


def engine_bf16_serving(torch, params, pa, refs):
  """Full width, bf16, staggered submits; the main path's launch counts,
  then the greedy streams against ``generate(use_cache=False)`` in bf16
  (kept in ``refs`` for phase 14).  Returns the launch count and the
  engine."""
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
  pa.reset_counts()
  t0 = time.monotonic()
  out = drive_waves(eng, Request, prompts)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  launches = pa.paged_attention_tiled_cuda.launches
  plain_calls = pa.paged_attention_reference.calls
  assert launches == cfg.num_layers * eng.steps, (launches, eng.steps)
  assert launches > 0
  assert pa.paged_attention_cuda.launches == launches
  assert pa.paged_attention_warp_cuda.launches == 0
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
  log(f"   paged_attention tiled-build launches {launches} = "
      f"{cfg.num_layers} layers x {eng.steps} steps; warp-build launches "
      f"0; plain-version calls {plain_calls}")
  greedy_vs_generate(torch, model, eng.params, prompts, out,
                     bf16_gap_limit, "bf16", refs)
  return launches, eng


def repeating_prompts(seed, n, vocab):
  """Prompts of 64-512 tokens, each one random span of 8-48 tokens
  repeated, 2% of its tokens redrawn: text whose spans recur, where a
  prompt-lookup drafter finds continuations to propose."""
  r = np.random.RandomState(seed)
  out = []
  for length in r.randint(64, 513, n):
    p = np.resize(r.randint(0, vocab, (r.randint(8, 49),)), int(length))
    flip = r.rand(len(p)) < 0.02
    p[flip] = r.randint(0, vocab, int(flip.sum()))
    out.append(p.astype(np.int32))
  return out


def speculative_serving(torch, params, pa, refs):
  """Phase 12: GPT-350M bf16, phase 5's staggered load over prompts whose
  spans repeat, on the speculative engine: first the n-gram drafter,
  then ``DraftModelDrafter`` with the target's own weights (greedy
  drafts of the target itself: acceptance near 1 shows the verify and
  rollout tiles right).  Each run counts the paged-attention launches of
  the target's steps and of the draft model's calls (counts set to 0
  just before it) against layers x calls: the target calls the model
  once a step; the draft model mirrors every step once and, in steps
  with a draft reservation, adds k calls (k - 1 rollouts and the
  write-only feed of the last draft).  Streams are held to
  ``generate(use_cache=False)`` by the bf16 gap rule.  After the n-gram
  run, a ``torch.profiler`` window of its steps as phase 6 takes one
  (prompts whose spans repeat).  Streams' references are kept in
  ``refs`` for phase 14.  Returns the launch counts and acceptance per
  run."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, DraftModelDrafter, NgramDrafter, Request)
  cfg = GPTConfig(**GPT_350M, dtype=torch.bfloat16)
  model = GPT(cfg)
  L = cfg.num_layers
  prompts = repeating_prompts(4, 16, cfg.vocab_size)
  result = {}
  for label in ("ngram", "self_draft"):
    drafter = (NgramDrafter(k=SPEC_K) if label == "ngram"
               else DraftModelDrafter(model, params, k=SPEC_K))
    stats = ServingStats()
    eng = ContinuousBatchingEngine(model, params, paged=True,
                                   num_slots=NUM_SLOTS,
                                   prefill_chunk=PREFILL_CHUNK,
                                   block_size=BLOCK_SIZE, drafter=drafter,
                                   stats=stats)
    draft_launches, draft_s = [0], [0.0]

    def counted(plan, histories, _propose=drafter.propose):
      before, t = pa.paged_attention_cuda.launches, time.monotonic()
      made = _propose(plan, histories)
      draft_s[0] += time.monotonic() - t
      draft_launches[0] += pa.paged_attention_cuda.launches - before
      return made

    drafter.propose = counted
    pa.reset_counts()
    t0 = time.monotonic()
    out = drive_waves(eng, Request, prompts)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    total = pa.paged_attention_cuda.launches
    target = total - draft_launches[0]
    rollouts = getattr(drafter, "rollout_steps", 0)
    want_draft = (L * (eng.steps + SPEC_K * rollouts)
                  if label == "self_draft" else 0)
    assert target == L * eng.steps > 0, (label, target, eng.steps)
    assert draft_launches[0] == want_draft, (label, draft_launches,
                                             want_draft)
    assert pa.paged_attention_tiled_cuda.launches == total
    assert pa.paged_attention_warp_cuda.launches == 0
    assert pa.paged_attention_reference.calls == 0
    assert eng.drafter_failures == 0
    assert sorted(out) == list(range(16))
    for i, p in enumerate(prompts):
      assert eng.finished[i].finish_reason == "length"
      assert out[i].shape == (len(p) + 32,)
      np.testing.assert_array_equal(out[i][:len(p)], p)
    assert eng.scheduler.kv_blocks_used == 0
    s = stats.summary()
    log(f"   {label}: {len(prompts)} requests, {eng.steps} engine steps, "
        f"{wall:.2f} s wall; tokens/s {s['tokens_per_s']:.1f}, TTFT p50 "
        f"{s['ttft_p50_s'] * 1e3:.1f} ms p99 {s['ttft_p99_s'] * 1e3:.1f} "
        f"ms, ITL p50 {s['itl_p50_s'] * 1e3:.2f} ms; step "
        f"{stats.busy_time_s / eng.steps * 1e3:.2f} ms, "
        f"of it the drafter {draft_s[0] / eng.steps * 1e3:.2f} ms (host "
        f"clock)")
    log(f"   {label}: drafted {s['drafted_tokens']:.0f}, accepted "
        f"{s['accepted_tokens']:.0f}, acceptance rate "
        f"{s['acceptance_rate']:.4f}, accepted per drafting step p50 "
        f"{s['accepted_per_step_p50']:.1f} (mean "
        f"{s['accepted_per_step_mean']:.2f})")
    drafts = (f"{draft_launches[0]} = {L} x ({eng.steps} mirrors + "
              f"{SPEC_K} x {rollouts} rollout steps)"
              if label == "self_draft" else "0 (no draft model)")
    log(f"   {label}: paged_attention launches: target {target} = {L} "
        f"layers x {eng.steps} steps; draft model {drafts}; all tiled "
        f"build; plain-version calls 0")
    greedy_vs_generate(torch, model, eng.params, prompts, out,
                       bf16_gap_limit, f"spec {label}", refs)
    result[label] = dict(target=target, draft=draft_launches[0],
                         acceptance=s["acceptance_rate"], steps=eng.steps)
    if label == "ngram":
      step_breakdown(torch, eng, repeating_prompts)
    del eng, drafter
  assert result["self_draft"]["acceptance"] >= SELF_DRAFT_ACCEPTANCE_FLOOR, (
      result["self_draft"])
  return result


def prefix_cache_serving(torch, params, pa):
  """Phase 13: GPT-350M bf16, 16 requests that share a 256-token system
  prompt (16 blocks) with distinct 32-256-token suffixes: request 0
  alone for two steps (its head's blocks register), then the other 15;
  then 8 of them return with prompt + reply + a new turn of 16-64
  tokens.  The same load runs with the prefix cache off, then on; TTFT
  (submit to first token, host clock) of the same requests in both.
  With the cache on: the system prompt's shared blocks keep their pool
  rows bit for bit through the run, every block still held at the end
  is the cache's, the streams pass the bf16 gap rule against
  ``generate(use_cache=False)``; in both runs the tiled build's
  launches are layers x steps and the plain version is never called.
  Returns the launch counts and the prefix counters."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  cfg = GPTConfig(**GPT_350M, dtype=torch.bfloat16)
  model = GPT(cfg)
  L, V = cfg.num_layers, cfg.vocab_size
  r = np.random.RandomState(5)
  system = r.randint(0, V, (256,)).astype(np.int32)
  prompts = [np.concatenate([system, r.randint(0, V, (n,))]).astype(np.int32)
             for n in r.randint(32, 257, 16)]
  turns = [r.randint(0, V, (n,)).astype(np.int32)
           for n in r.randint(16, 65, 8)]
  result = {}
  for cached in (False, True):
    stats = ServingStats()
    eng = ContinuousBatchingEngine(model, params, paged=True,
                                   num_slots=NUM_SLOTS,
                                   prefill_chunk=PREFILL_CHUNK,
                                   block_size=BLOCK_SIZE,
                                   prefix_cache=cached, stats=stats)
    sched = eng.scheduler
    submitted, first, warm = {}, {}, set()
    hits = [0]

    def on_admit(uid):
      if sched.prefix_hits > hits[0]:
        warm.add(uid)
      hits[0] = sched.prefix_hits

    sched.on_admit.append(on_admit)
    sched.on_first_token.append(
        lambda uid: first.setdefault(uid, time.monotonic()))

    def submit(uid, prompt):
      submitted[uid] = time.monotonic()
      eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=32))

    pa.reset_counts()
    submit(0, prompts[0])
    out = {}
    for _ in range(2):
      for fin in eng.step():
        out[fin.uid] = fin.tokens
    if cached:
      # Request 0's first 16 blocks: registered by now, shared by 1-15.
      head = sched.slot_blocks(next(iter(sched.active)))[:16]
      rows = lambda: [torch.cat([  # noqa: E731
          eng._kv[f"block_{i}"]["attn"][n][head].flatten()
          for n in ("cached_key", "cached_value")]).clone()
          for i in range(L)]
      before = rows()
    for i in range(1, 16):
      submit(i, prompts[i])
    out.update(eng.run())
    second = [np.concatenate([out[i], turns[i]]) for i in range(8)]
    for i in range(8):
      submit(16 + i, second[i])
    out.update(eng.run())
    torch.cuda.synchronize()
    launches = pa.paged_attention_tiled_cuda.launches
    assert launches == L * eng.steps > 0, (launches, eng.steps)
    assert pa.paged_attention_cuda.launches == launches
    assert pa.paged_attention_reference.calls == 0
    assert sorted(out) == list(range(24))
    ttft = {uid: first[uid] - submitted[uid] for uid in submitted}
    p50 = lambda uids: statistics.median(ttft[u] for u in uids)  # noqa
    row = dict(launches=launches, steps=eng.steps,
               ttft_turn1_p50=p50(range(1, 16)),
               ttft_turn2_p50=p50(range(16, 24)))
    if cached:
      row.update(hits=sched.prefix_hits, misses=sched.prefix_misses,
                 blocks_reused=sched.prefix_blocks_reused,
                 saved_tokens=sched.prefix_blocks_reused * BLOCK_SIZE,
                 cached_blocks=sched.prefix_cached_blocks,
                 evictions=sched.prefix_evictions)
      assert set(range(1, 24)) <= warm and 0 not in warm, sorted(warm)
      assert sched.kv_blocks_used == sched.prefix_cached_blocks > 0
      again = sched.prefix_cache.match(prompts[0])[:16]   # a probe
      for blk in again:
        sched.block_allocator.decref(blk)
      assert again == head, "the system prompt's blocks left the cache"
      for a, b in zip(before, rows()):
        assert torch.equal(a, b), "a shared block's pool rows changed"
      log(f"   prefix hits {row['hits']}, misses {row['misses']}, blocks "
          f"reused {row['blocks_reused']}, prefill tokens saved "
          f"{row['saved_tokens']}, cached blocks at the end "
          f"{row['cached_blocks']} = kv_blocks_used, evictions "
          f"{row['evictions']}; the 16 system-prompt blocks' pool rows "
          f"unchanged")
      greedy_vs_generate(torch, model, eng.params, prompts + second,
                         [out[i] for i in range(24)], bf16_gap_limit,
                         "prefix cache")
    else:
      assert sched.kv_blocks_used == 0
    s = stats.summary()
    log(f"   prefix cache {'on ' if cached else 'off'}: {eng.steps} steps, "
        f"tokens/s {s['tokens_per_s']:.1f}, TTFT p50 of requests 1-15 "
        f"{row['ttft_turn1_p50'] * 1e3:.1f} ms, of the 8 second turns "
        f"{row['ttft_turn2_p50'] * 1e3:.1f} ms; tiled-build launches "
        f"{launches} = {L} x {eng.steps}; plain-version calls 0")
    result["on" if cached else "off"] = row
    del eng
  return result


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


def step_breakdown(torch, eng, prompt_fn=None, paged=True):
  """Where a bf16 engine step's time goes: ``PROFILE_STEPS`` public
  ``step()`` calls under a full load of 16 requests (96 new tokens
  each, 8 of them admitted mid-flight), profiled with ``torch.profiler``
  (CPU and CUDA activities).  Prints host wall and device busy time per
  step, the device's idle share, the host time outside the device step
  (scheduler planning, from ``ServingStats`` step times) and device time
  by kernel.  ``prompt_fn(seed, n, vocab)`` draws the prompts
  (default :func:`make_prompts`).  ``paged=False`` (the contiguous
  engine, whose attention is dense) requires the profile to hold no
  paged-attention kernel."""
  from torch.profiler import ProfilerActivity, profile
  from easyparallellibrary_tpu_torch.serving import Request
  prompts = (prompt_fn or make_prompts)(3, 16, eng.model.cfg.vocab_size)
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
  # Both builds: paged_attention_tiled_kernel and paged_attention_kernel.
  paged_us = sum(us for name, (_, us) in kernels.items()
                 if "paged_attention" in name)
  if paged:
    assert paged_us > 0, "the profile holds no paged-attention kernel"
  else:
    assert paged_us == 0, "the contiguous engine launched paged attention"
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


def flash_case(torch, dtype, seed, B, H, S, D):
  """q, k, v, dout ``[B, H, S, D]`` on the card from a numpy seed."""
  r = np.random.RandomState(seed)
  return [torch.from_numpy(r.randn(B, H, S, D).astype(np.float32)).to(
      "cuda", dtype) for _ in range(4)]


def normalized_errors(got, want):
  """``(||got - want|| / ||want||, max|got - want| / max|want|)``."""
  diff, want = got.float() - want.float(), want.float()
  return ((diff.norm() / want.norm()).item(),
          (diff.abs().max() / want.abs().max()).item())


def flash_parity(torch, fa):
  """Each flash kernel against its plain version.  Returns the max abs
  error per kernel over every case, and per kernel the largest bf16
  normalized errors ``(rel_l2, max_rel)``."""
  torch.backends.cuda.matmul.allow_tf32 = False
  errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
  rel = {kernel: (0.0, 0.0) for kernel in errs}
  for dtype_name in ("float32", "bfloat16"):
    dtype = getattr(torch, dtype_name)
    for seed, (label, shape) in enumerate(FLASH_SHAPES):
      for causal in (True, False):
        q, k, v, dout = flash_case(torch, dtype, seed, **shape)
        out, lse = fa.flash_fwd(q, k, v, causal)    # CUDA -> the kernels
        want_out, want_lse = fa.flash_fwd_reference(q, k, v, causal)
        delta = (dout.float() * want_out.float()).sum(-1)
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal)
        dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal)
        want_dk, want_dv = fa.flash_bwd_dkv_reference(
            q, k, v, dout, want_lse, delta, causal)
        want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                            causal)
        torch.cuda.synchronize()
        case = f"{label} {dtype_name} causal={causal}"
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-6,
                                   msg=lambda m: f"{case} lse: {m}")
        checks = [("fwd", "out", out, want_out, FLASH_TOLERANCE["fwd"]),
                  ("dkv", "dk", dk, want_dk, FLASH_TOLERANCE["grad"]),
                  ("dkv", "dv", dv, want_dv, FLASH_TOLERANCE["grad"]),
                  ("dq", "dq", dq, want_dq, FLASH_TOLERANCE["grad"])]
        readings = []
        for kernel, name, got, want, (rtol, atol) in checks:
          assert got.shape == want.shape and got.dtype == want.dtype, case
          assert bool(torch.isfinite(got).all()), f"{case} {name}: non-finite"
          err = (got.float() - want.float()).abs().max().item()
          errs[kernel] = max(errs[kernel], err)
          rel_l2, max_rel = normalized_errors(got, want)
          readings.append(f"{name} {err:.2e} ({rel_l2:.2e}, {max_rel:.2e})")
          if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{case} {name}: {m}")
          else:
            limit = FLASH_BF16_LIMIT["fwd" if kernel == "fwd" else "grad"]
            assert (rel_l2 <= limit["rel_l2"]
                    and max_rel <= limit["max_rel"]), (
                        f"{case} {name}: normalized errors {rel_l2:.3e}, "
                        f"{max_rel:.3e} over {limit}")
            rel[kernel] = (max(rel[kernel][0], rel_l2),
                           max(rel[kernel][1], max_rel))
        log(f"   {label:14s} {dtype_name:8s} causal={causal!s:5s} "
            f"max|kernel - plain| (rel_l2, max_rel): " + ", ".join(readings))
  log(f"   bf16 limits (rel_l2, max_rel): {FLASH_BF16_LIMIT}; fp32: the "
      f"JAX tests' tolerances")
  return errs, rel


def flash_check_sensitivity(torch, fa, dtype_name="bfloat16"):
  """The bf16 (or fp16) limits against faults a kernel could have: plain
  versions with one fault each, at the training shape (batch cut to 2, causal),
  held against the faultless plain version.  A fault is caught when
  either normalized error exceeds its limit; every fault here must be,
  but one: a forward that skips the rounding of p moves the output by
  about as much as the kernel's own rounding of p against a running
  max does, so no comparison with the plain version can see it.  Its
  reading is printed beside the others."""
  B, H, S, D = FLASH_SHAPES[0][1].values()
  dtype = getattr(torch, dtype_name)
  limits = FLASH_BF16_LIMIT if dtype_name == "bfloat16" else FLASH_FP16_LIMIT
  q, k, v, dout = flash_case(torch, dtype, 0, B=B, H=H, S=S, D=D)
  want_out, lse = fa.flash_fwd_reference(q, k, v, True)
  delta = (dout.float() * want_out.float()).sum(-1)
  want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                                True)
  want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, True)
  scale = fa._scale(D)
  s = fa._scores(q, k, True)
  lost = torch.zeros(S, dtype=torch.bool, device=q.device)
  lost[16:32] = True                            # one 16-wide tile
  p = torch.exp(s - lse[..., None])
  dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
  ds = p * (dp - delta[..., None])
  rnd = lambda x: x.to(dtype).float()  # noqa: E731  (the working type)

  def forward(scores, round_p):
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    pv = rnd(e) if round_p else e
    return (torch.einsum("bhqk,bhkd->bhqd", pv, v.float())
            / e.sum(-1, keepdim=True)).to(dtype)

  def grad_kv(weights, x):
    return torch.einsum("bhqk,bhqd->bhkd", weights, x.float())

  rows_lost = lost[:, None]
  faults = {   # name: (faulty output, faultless output, must be caught)
      "out, KV tile lost": (forward(s.masked_fill(lost, fa.NEG_INF), True),
                            want_out, True),
      "out, p not rounded": (forward(s, False), want_out, False),
      "dv, p not rounded": (grad_kv(p, dout).to(dtype), want_dv,
                            True),
      "dv, Q tile lost": (grad_kv(rnd(p.masked_fill(rows_lost, 0)), dout)
                          .to(dtype), want_dv, True),
      "dk, dS not rounded": ((grad_kv(ds, q) * scale).to(dtype),
                             want_dk, True),
      "dk, Q tile lost": ((grad_kv(rnd(ds.masked_fill(rows_lost, 0)), q)
                           * scale).to(dtype), want_dk, True),
      "dq, dS not rounded": ((torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
                              * scale).to(dtype), want_dq, True),
      "dq, KV tile lost": ((torch.einsum("bhqk,bhkd->bhqd",
                                         rnd(ds.masked_fill(lost, 0)),
                                         k.float()) * scale)
                           .to(dtype), want_dq, True),
  }
  missed = []
  for name, (got, want, must_catch) in faults.items():
    limit = limits["fwd" if name.startswith("out") else "grad"]
    rel_l2, max_rel = normalized_errors(got, want)
    caught = rel_l2 > limit["rel_l2"] or max_rel > limit["max_rel"]
    log(f"   {dtype_name} fault {name:20s}: rel_l2 {rel_l2:.2e}, max_rel "
        f"{max_rel:.2e} -> {'caught' if caught else 'not caught'}")
    if must_catch and not caught:
      missed.append(name)
  assert not missed, f"the {dtype_name} limits miss {missed}"


def flash_lse_autograd(torch, fa):
  """``flash_attention_lse`` with an lse cotangent through autograd (the
  kernels) against plain autograd over the full score matrix, fp32 on
  the card, at the JAX test's tolerance (rtol 2e-4, atol 2e-5)."""
  r = np.random.RandomState(9)
  B, S, H, D = 2, 128, 2, 32
  leaves = [torch.from_numpy(r.randn(B, S, H, D).astype(np.float32)).cuda()
            .requires_grad_(True) for _ in range(3)]

  def plain(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v)
    return o, lse.transpose(1, 2)

  grads = []
  for attn in (fa.flash_attention_lse, plain):
    o, lse = attn(*leaves)
    loss = torch.sum(o ** 2) + torch.sum(torch.sin(lse))
    grads.append(torch.autograd.grad(loss, leaves))
  worst = 0.0
  for name, got, want in zip("qkv", *grads):
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5,
                               msg=lambda m: f"d{name}: {m}")
    worst = max(worst, (got - want).abs().max().item())
  log(f"   flash_attention_lse + lse cotangent, fp32 autograd vs plain "
      f"autograd: max|diff| {worst:.2e} (rtol 2e-4, atol 2e-5)")


def flash_bounds(B, H, S, D, itemsize):
  """(least ms, "bytes" | "operations") of the causal forward, dK/dV and
  dQ at this shape: each input read once and each output written once
  over the HBM rate, against the causal products' operations (4, 8 and
  6 x B*H*S*S*D/2) over the bf16 tensor-core peak."""
  row = B * H * S * D * itemsize
  rows = B * H * S * 4                          # one fp32 [B, H, S]
  work = {"fwd": (4 * row + rows, 4),           # q, k, v, o; lse
          "dkv": (6 * row + 2 * rows, 8),       # q, k, v, dO, dk, dv
          "dq": (5 * row + 2 * rows, 6)}        # q, k, v, dO, dq
  out = {}
  for name, (nbytes, units) in work.items():
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = units * B * H * S * S * D / 2 / PEAK_OPS_PER_S["bfloat16"] * 1e3
    out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")
  return out


def host_us(torch, fn, args, calls=200):
  """Host time of one call, in microseconds: ``calls`` calls enqueued
  back to back (the device runs behind, so the host never waits on
  it), then one synchronize outside the window."""
  fn(*args)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(calls):
    fn(*args)
  elapsed = time.perf_counter() - t0
  torch.cuda.synchronize()
  return elapsed / calls * 1e6


def flash_timing(torch, fa):
  """Kernel, plain-version and library times at the training shape, bf16
  causal.  The library yardsticks (never called by the port) are
  ``scaled_dot_product_attention(is_causal=True)``'s forward for the
  forward kernel and its backward alone for each backward kernel: one
  ``autograd.grad`` with ``retain_graph=True`` on a graph built once, so
  the forward stays outside the timed window.  Also each wrapper's host
  time per call: the forward wrapper encodes 3 TMA tensor maps per call,
  dK/dV and dQ 4 each."""
  sdpa = torch.nn.functional.scaled_dot_product_attention
  shape = FLASH_BENCH_SHAPE
  sets, graphs = [], []
  for i in range(2):                  # two copies: each call finds L2 cold
    q, k, v, dout = flash_case(torch, torch.bfloat16, 200 + i, **shape)
    out, lse = fa.flash_fwd_cuda(q, k, v, True)
    delta = (dout.float() * out.float()).sum(-1)
    sets.append((q, k, v, dout, lse, delta))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    graphs.append((sdpa(*leaves, is_causal=True), leaves, dout))

  def sdpa_bwd(out, leaves, dout):
    return torch.autograd.grad(out, leaves, dout, retain_graph=True)

  fwd_args = [(q, k, v, True) for q, k, v, *_ in sets]
  bwd_args = [(*a, True) for a in sets]
  library_bwd = time_ms(torch, sdpa_bwd, graphs, reps=5)
  bounds = flash_bounds(itemsize=2, **shape)
  rows = {
      "fwd": dict(kernel_ms=time_ms(torch, fa.flash_fwd_cuda, fwd_args),
                  plain_ms=time_ms(torch, fa.flash_fwd_reference, fwd_args,
                                   reps=3),
                  library_ms=time_ms(
                      torch, lambda q, k, v, c: sdpa(q, k, v, is_causal=c),
                      fwd_args, reps=5)),
      "dkv": dict(kernel_ms=time_ms(torch, fa.flash_bwd_dkv_cuda, bwd_args),
                  plain_ms=time_ms(torch, fa.flash_bwd_dkv_reference,
                                   bwd_args, reps=3),
                  library_ms=library_bwd),
      "dq": dict(kernel_ms=time_ms(torch, fa.flash_bwd_dq_cuda, bwd_args),
                 plain_ms=time_ms(torch, fa.flash_bwd_dq_reference, bwd_args,
                                  reps=3),
                 library_ms=library_bwd),
  }
  wrappers = {"fwd": (fa.flash_fwd_cuda, fwd_args[0]),
              "dkv": (fa.flash_bwd_dkv_cuda, bwd_args[0]),
              "dq": (fa.flash_bwd_dq_cuda, bwd_args[0])}
  for name, row in rows.items():
    row["bound_ms"], row["bound_by"] = bounds[name]
    row["host_us"] = host_us(torch, *wrappers[name])
    log(f"   {name:4s} B=16 H=16 S=1024 D=64 bf16 causal: "
        + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in row.items()))
  pair = rows["dkv"]["kernel_ms"] + rows["dq"]["kernel_ms"]
  log(f"   backward pair dK/dV + dQ {pair:.4f} ms against SDPA's backward "
      f"alone {library_bwd:.4f} ms ({pair / library_bwd:.2f}x); forward "
      f"{rows['fwd']['kernel_ms']:.4f} ms against SDPA's forward "
      f"{rows['fwd']['library_ms']:.4f} ms "
      f"({rows['fwd']['kernel_ms'] / rows['fwd']['library_ms']:.2f}x)")
  return rows


def train_fp32_flash_vs_dense(torch, fa, bench):
  """GPT-350M widths at ``TRAIN_FP32_LAYERS`` layers, fp32 without TF32:
  ``TRAIN_FP32_STEPS`` AdamW steps with ``attn_impl="pallas_flash"`` (the
  kernels) against the same steps with ``attn_impl="xla"`` (dense
  attention), from the same seeded weights and batch.  The per-step
  losses agree to rtol 1e-4 (the two attentions sum in other orders);
  under ``dots_flash`` each step launches the forward kernel once per
  layer, as it does dK/dV and dQ."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  losses = {}
  for attn in ("pallas_flash", "xla"):
    cfg = bench.bench_config(torch.device("cuda"),
                             num_layers=TRAIN_FP32_LAYERS,
                             dtype=torch.float32, attn_impl=attn)[0]
    state, step, batch, rng, _ = bench.build_training(cfg, TRAIN_FP32_BATCH,
                                                      "cuda")
    fa.reset_counts()
    losses[attn] = []
    for _ in range(TRAIN_FP32_STEPS):
      state, metrics = step(state, batch, rng)
      losses[attn].append(metrics["loss"].item())
    counts = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
              fa.flash_bwd_dq_cuda.launches)
    plain = (fa.flash_fwd_reference.calls, fa.flash_bwd_dkv_reference.calls,
             fa.flash_bwd_dq_reference.calls)
    want = (TRAIN_FP32_LAYERS * TRAIN_FP32_STEPS if attn == "pallas_flash"
            else 0,) * 3
    assert counts == want and plain == (0, 0, 0), (attn, counts, plain)
    log(f"   {attn:12s} losses {[f'{x:.6f}' for x in losses[attn]]}; "
        f"flash launches fwd/dkv/dq {counts}")
    del state, step
  assert all(np.isfinite(losses["pallas_flash"]))
  np.testing.assert_allclose(losses["pallas_flash"], losses["xla"],
                             rtol=1e-4)
  log(f"   flash vs dense per-step loss, max rel diff "
      f"{max(abs(a - b) / abs(b) for a, b in zip(*losses.values())):.2e} "
      f"(rtol 1e-4)")


def train_bf16_bench(torch, fa, bench):
  """The training main path: ``bench.measure()`` at full width, bf16,
  with every flash count set to 0 just before it and read just after."""
  fa.reset_counts()
  record = bench.measure("cuda")
  torch.cuda.synchronize()
  launches = {"fwd": fa.flash_fwd_cuda.launches,
              "dkv": fa.flash_bwd_dkv_cuda.launches,
              "dq": fa.flash_bwd_dq_cuda.launches}
  plain = (fa.flash_fwd_reference.calls, fa.flash_bwd_dkv_reference.calls,
           fa.flash_bwd_dq_reference.calls)
  d = record["detail"]
  steps = d["steps_run"]
  layers = bench.GPT_350M["num_layers"]
  log(f"   {json.dumps(record)}")
  log(f"   tokens/s {d['tokens_per_sec_per_chip']}, step {d['step_time_ms']} "
      f"ms, MFU {record['value']} of {d['peak_flops_denominator']:.3g} "
      f"FLOP/s, peak memory {d['peak_hbm_gb']} GiB, batch "
      f"{d['batch_size']}, loss {d['loss']}")
  log(f"   flash launches {launches} over {steps} steps x {layers} layers; "
      f"plain-version calls {plain}")
  assert record["metric"] == "gpt350m_train_mfu" and record["value"] > 0
  assert np.isfinite(d["loss"])
  assert all(n == layers * steps for n in launches.values()), launches
  assert plain == (0, 0, 0), plain
  return record, launches


def train_step_breakdown(torch, bench, batch_size):
  """``TRAIN_PROFILE_STEPS`` bf16 training steps at full width, at the
  batch size phase 10 measured, under ``torch.profiler``: host wall and
  device busy time per step, and device time by kernel (the flash
  kernels' share)."""
  from torch.profiler import ProfilerActivity, profile
  cfg = bench.bench_config(torch.device("cuda"))[0]
  state, step, batch, rng, _ = bench.build_training(cfg, batch_size, "cuda")
  for _ in range(2):
    state, _ = step(state, batch, rng)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(TRAIN_PROFILE_STEPS):
      state, _ = step(state, batch, rng)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
  n = TRAIN_PROFILE_STEPS
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
  # Every build of each kernel: flash_*_wgmma_kernel (bf16) as well as
  # the CUDA-core flash_*_kernel.
  flash = {tag: sum(us for name, (_, us) in kernels.items() if tag in name)
           for tag in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
  assert all(us > 0 for us in flash.values()), flash
  log(f"   {n} steps, profiler on: host wall {wall_us / n / 1e3:.3f} "
      f"ms/step, device busy {busy_us / n / 1e3:.3f} ms/step, idle share "
      f"{1 - busy_us / wall_us:.3f}; kernel launches "
      f"{sum(c for c, _ in kernels.values()) / n:.1f}/step; flash "
      + ", ".join(f"{tag} {us / n / 1e3:.3f} ms/step" for tag, us
                  in flash.items())
      + f" ({sum(flash.values()) / device_us:.3f} of device time)")
  log(f"   {'device ms/step':>14s} {'share':>6s} {'calls/step':>10s}  kernel")
  for name, (calls, us) in sorted(kernels.items(),
                                  key=lambda kv: -kv[1][1])[:15]:
    log(f"   {us / n / 1e3:14.4f} {us / device_us:6.3f} {calls / n:10.1f}  "
        f"{name[:100]}")


# ------------------------------------------- phase 14: contiguous engine


def slot_engine(torch, model, params, **kw):
  """The contiguous-slot engine with the default serving config: only
  the geometry of the other phases is passed (8 slots, chunk 128), not
  the layout."""
  from easyparallellibrary_tpu_torch.serving import ContinuousBatchingEngine
  eng = ContinuousBatchingEngine(model, params, num_slots=NUM_SLOTS,
                                 prefill_chunk=PREFILL_CHUNK, **kw)
  assert not eng.paged and eng._cursors is not None
  return eng


def contiguous_serving(torch, params, pa, refs):
  """Phase 14: the contiguous-slot engine at GPT-350M width.  Its cache
  is 2 x 24 x 8 x 1152 x 16 x 64 elements (0.91 GB in bf16, 1.81 GB in
  fp32).  An fp32 run against ``generate(use_cache=False)`` (phase 4's
  prompts and references); a bf16 run under phase 5's staggered load
  (tokens/s, TTFT, ITL, the bf16 gap rule against phase 5's references);
  an n-gram run (phase 12's prompts and references) and a short
  self-draft run (its first 8 prompts at once; the acceptance floor).
  No run may launch the paged-attention kernel: the slot layout's
  attention is dense, as in the JAX package.  Then a ``torch.profiler``
  window of the bf16 engine's steps."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
  from easyparallellibrary_tpu_torch.serving import (
      DraftModelDrafter, NgramDrafter, Request, kv_cache)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  for dtype_name in ("float32", "bfloat16"):
    cfg = GPTConfig(**GPT_350M, dtype=getattr(torch, dtype_name))
    model = GPT(cfg)
    gb = kv_cache.cache_bytes(cfg, NUM_SLOTS, PREFILL_CHUNK) / 1e9
    stats = ServingStats()
    eng = slot_engine(torch, model, params, stats=stats)
    pa.reset_counts()
    t0 = time.monotonic()
    if dtype_name == "float32":
      prompts = make_prompts(1, NUM_SLOTS, cfg.vocab_size)
      for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
      out = eng.run()
    else:
      prompts = make_prompts(2, 16, cfg.vocab_size)
      out = drive_waves(eng, Request, prompts)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    assert pa.paged_attention_cuda.launches == 0
    assert pa.paged_attention_reference.calls == 0
    assert sorted(out) == list(range(len(prompts)))
    s = stats.summary()
    log(f"   contiguous {dtype_name}: cache {gb:.2f} GB, "
        f"{len(prompts)} requests, {eng.steps} steps, {wall:.2f} s wall; "
        f"tokens/s {s['tokens_per_s']:.1f}, TTFT p50 "
        f"{s['ttft_p50_s'] * 1e3:.1f} ms p99 {s['ttft_p99_s'] * 1e3:.1f} ms, "
        f"ITL p50 {s['itl_p50_s'] * 1e3:.2f} ms; paged-attention launches 0")
    if dtype_name == "float32":
      greedy_vs_generate(torch, model, eng.params, prompts, out,
                         lambda top1: 1e-3, "contiguous fp32",
                         refs["float32"])
    else:
      greedy_vs_generate(torch, model, eng.params, prompts, out,
                         bf16_gap_limit, "contiguous bf16", refs["bfloat16"])
      bf16_eng = eng
    del eng
  cfg = bf16_eng.model.cfg
  model = bf16_eng.model
  prompts = repeating_prompts(4, 16, cfg.vocab_size)
  for label in ("ngram", "self_draft"):
    stats = ServingStats()
    if label == "ngram":
      eng = slot_engine(torch, model, params, stats=stats,
                        drafter=NgramDrafter(k=SPEC_K))
      pa.reset_counts()
      out = drive_waves(eng, Request, prompts)
      subset = prompts
    else:
      eng = slot_engine(torch, model, params, stats=stats,
                        drafter=DraftModelDrafter(model, params, k=SPEC_K))
      pa.reset_counts()
      subset = prompts[:NUM_SLOTS]
      for i, p in enumerate(subset):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
      out = eng.run()
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches == 0
    assert eng.drafter_failures == 0
    s = stats.summary()
    log(f"   contiguous {label}: {len(subset)} requests, {eng.steps} steps; "
        f"tokens/s {s['tokens_per_s']:.1f}, drafted "
        f"{s['drafted_tokens']:.0f}, accepted {s['accepted_tokens']:.0f}, "
        f"acceptance {s['acceptance_rate']:.4f}")
    greedy_vs_generate(torch, model, eng.params, subset, out,
                       bf16_gap_limit, f"contiguous {label}",
                       refs["spec"])
    assert s["drafted_tokens"] > 0
    if label == "self_draft":
      assert eng.drafter.rollout_steps > 0
      assert s["acceptance_rate"] >= SELF_DRAFT_ACCEPTANCE_FLOOR, s
    del eng
  step_breakdown(torch, bf16_eng, paged=False)


# ------------------------------------------- phase 15: serving resilience


def resilience_prompts(seed, vocab):
  """8 requests of a 128-token shared head (8 blocks) and a 32-256-token
  suffix: with the prefix cache on, requests 1-7 map the head's blocks
  from request 0."""
  r = np.random.RandomState(seed)
  head = r.randint(0, vocab, (128,))
  return [np.concatenate([head, r.randint(0, vocab, (n,))]).astype(np.int32)
          for n in r.randint(32, 257, NUM_SLOTS)]


def resilience_run(torch, model, params, layout, prompts, resilient,
                   fault=()):
  """One bf16 run of ``prompts`` (request 0 two steps ahead, then the
  rest), with a ``NaNLogitsInjector`` over the step calls in ``fault``.
  Returns the engine, the streams, host ms per step, and a snapshot
  taken right after the poisoned step: the caches and what the check of
  the zeroed rows needs."""
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.chaos import NaNLogitsInjector
  kw = (dict(paged=True, block_size=BLOCK_SIZE, prefix_cache=True)
        if layout == "paged" else dict(paged=False))
  eng = ContinuousBatchingEngine(model, params, num_slots=NUM_SLOTS,
                                 prefill_chunk=PREFILL_CHUNK,
                                 resilience=resilient, **kw)
  inj = NaNLogitsInjector(eng, bad_calls=fault) if fault else None
  eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=32))
  out = {}
  for _ in range(2):
    for fin in eng.step():
      out[fin.uid] = fin.tokens
  for i in range(1, len(prompts)):
    eng.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=32))
  snap = None
  t0 = time.monotonic()
  steps0 = eng.steps
  while eng.has_work:
    before = None
    if inj is not None and snap is None and inj.calls == fault[0]:
      before = {"active": dict(eng.scheduler.active),
                "blocks": ({s: eng.scheduler.slot_blocks(s)
                            for s in eng.scheduler.active}
                           if layout == "paged" else None),
                "kv": {n: {leaf: t.clone() for leaf, t in l["attn"].items()}
                       for n, l in eng._kv.items()} if layout == "paged"
                else None}
    for fin in eng.step():
      out[fin.uid] = fin.tokens
    if before is not None and inj.poisoned:
      snap = dict(before, cursors=(None if eng._cursors is None
                                   else eng._cursors.cpu().numpy()))
      check_sanitized(torch, eng, layout, snap)
  torch.cuda.synchronize()
  ms = (time.monotonic() - t0) / max(eng.steps - steps0, 1) * 1e3
  assert inj is None or (inj.poisoned == list(fault)
                         and snap is not None), inj.poisoned
  return eng, out, ms


def check_sanitized(torch, eng, layout, snap):
  """Right after the poisoned step, read back on the card: every cache
  row is finite; contiguous: each retried slot's rows from its cursor
  up are exactly zero; paged: the null block is zero, each bad slot's
  blocks are zero from the committed watermark up, and blocks wholly
  below it (the shared head) are bit-identical to before the step."""
  bad = [s for s in snap["active"]]
  for name, layer in eng._kv.items():
    for leaf, t in layer["attn"].items():
      assert bool(torch.isfinite(t).all()), f"{name}/{leaf} not finite"
      if layout == "contiguous":
        for slot in bad:
          assert not t[slot, int(snap["cursors"][slot]):].any(), slot
        continue
      assert not t[0].any(), "the null block was not zeroed"
      old = snap["kv"][name][leaf]
      for slot in bad:
        state = snap["active"][slot]
        mark = (state.prompt_pos if state.prefilling else
                len(state.req.prompt) + len(state.generated) - 1)
        for j, blk in enumerate(snap["blocks"][slot]):
          lo = max(0, mark - j * BLOCK_SIZE)
          if lo >= BLOCK_SIZE:
            assert torch.equal(t[blk], old[blk]), (slot, j)
          else:
            assert not t[blk, lo:].any(), (slot, j)


def serving_resilience(torch, params, pa):
  """Phase 15: serving resilience at GPT-350M width in bf16, on the paged
  engine with the prefix cache on and on the contiguous engine.  Per
  layout: fault-free runs in turns (plain, resilient, resilient, plain),
  the resilient streams token-equal to the plain ones, the two sides'
  median host ms per step giving the guard's cost; a transient fault
  (``TRANSIENT_FAULT``: retried in place, streams equal to the
  fault-free run's) and a persistent one
  (``PERSISTENT_FAULT``: requeued, the committed prefix replayed; the
  replay's prefill rounds where decode did, so its streams are held to
  the fault-free run by the bf16 gap rule), with the counters; the
  poisoned rows read back as zero right after the bad step."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  cfg = GPTConfig(**GPT_350M, dtype=torch.bfloat16)
  model = GPT(cfg)
  prompts = resilience_prompts(6, cfg.vocab_size)
  for layout in ("paged", "contiguous"):
    ms = {False: [], True: []}
    for resilient in (False, True, True, False):
      eng, out, step_ms = resilience_run(torch, model, params, layout,
                                         prompts, resilient)
      ms[resilient].append(step_ms)
      if resilient:
        guard_eng, guarded = eng, out
      else:
        base_eng, base = eng, out
    assert sorted(base) == sorted(guarded) == list(range(len(prompts)))
    for i in base:
      np.testing.assert_array_equal(guarded[i], base[i], f"{layout} {i}")
    assert guard_eng._bad_policy.bad_steps == 0
    if layout == "paged":
      assert guard_eng.scheduler.prefix_hits > 0
    log(f"   {layout}: fault-free resilient runs token-equal to the plain "
        f"ones ({len(prompts)} streams, {guard_eng.steps} steps); host "
        f"ms/step in turns: plain {ms[False][0]:.2f}, guarded "
        f"{ms[True][0]:.2f}, {ms[True][1]:.2f}, plain {ms[False][1]:.2f} "
        f"(medians {statistics.median(ms[False]):.2f} plain, "
        f"{statistics.median(ms[True]):.2f} guarded)")
    refs = {i: base[i] for i in base}
    for label, fault in (("transient", TRANSIENT_FAULT),
                         ("persistent", PERSISTENT_FAULT)):
      eng, out, _ = resilience_run(torch, model, params, layout, prompts,
                                   True, fault)
      counters = eng._bad_policy.counters()
      assert counters["bad_steps"] == len(fault), counters
      assert counters["failed_requests"] == 0, counters
      if label == "transient":
        assert counters["requeues"] == 0, counters
        for i in base:
          np.testing.assert_array_equal(out[i], base[i],
                                        f"{layout} {label} {i}")
        equal = len(base)
      else:
        assert counters["requeues"] > 0, counters
        equal = greedy_vs_generate(torch, model, eng.params, prompts,
                                   [out[i] for i in range(len(prompts))],
                                   bf16_gap_limit, f"{layout} {label}",
                                   refs, "the fault-free run's")
      assert all(eng.finished[i].finish_reason == "length" for i in base)
      log(f"   {layout} {label} fault at calls {list(fault)}: counters "
          f"{counters}; {equal}/{len(base)} streams equal the fault-free "
          f"run; poisoned rows zero on the card right after the bad step")
    del base_eng, guard_eng, eng


# ------------------------------------------ phase 16: amp O1 and fp16


def fp16_flash_parity(torch, fa):
  """The fp16 flash builds against their plain versions at phase 7's
  shapes, causal and not, by normalized error against
  ``FLASH_FP16_LIMIT``; then the limits' sensitivity.  Returns the max
  abs error and the largest normalized errors per kernel."""
  errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
  rel = {kernel: (0.0, 0.0) for kernel in errs}
  for seed, (label, shape) in enumerate(FLASH_SHAPES):
    for causal in (True, False):
      q, k, v, dout = flash_case(torch, torch.float16, seed, **shape)
      out, lse = fa.flash_fwd(q, k, v, causal)
      want_out, want_lse = fa.flash_fwd_reference(q, k, v, causal)
      delta = (dout.float() * want_out.float()).sum(-1)
      dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal)
      dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal)
      want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, want_lse,
                                                    delta, causal)
      want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                          causal)
      torch.cuda.synchronize()
      case = f"{label} fp16 causal={causal}"
      torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-6,
                                 msg=lambda m: f"{case} lse: {m}")
      readings = []
      for kernel, name, got, want in (("fwd", "out", out, want_out),
                                      ("dkv", "dk", dk, want_dk),
                                      ("dkv", "dv", dv, want_dv),
                                      ("dq", "dq", dq, want_dq)):
        assert got.dtype == torch.float16, case
        assert bool(torch.isfinite(got).all()), f"{case} {name}"
        err = (got.float() - want.float()).abs().max().item()
        rel_l2, max_rel = normalized_errors(got, want)
        limit = FLASH_FP16_LIMIT["fwd" if kernel == "fwd" else "grad"]
        assert rel_l2 <= limit["rel_l2"] and max_rel <= limit["max_rel"], (
            f"{case} {name}: normalized errors {rel_l2:.3e}, {max_rel:.3e} "
            f"over {limit}")
        errs[kernel] = max(errs[kernel], err)
        rel[kernel] = (max(rel[kernel][0], rel_l2),
                       max(rel[kernel][1], max_rel))
        readings.append(f"{name} {err:.2e} ({rel_l2:.2e}, {max_rel:.2e})")
      log(f"   {label:14s} float16  causal={causal!s:5s} max|kernel - plain|"
          f" (rel_l2, max_rel): " + ", ".join(readings))
  log(f"   fp16 limits (rel_l2, max_rel): {FLASH_FP16_LIMIT}")
  flash_check_sensitivity(torch, fa, "float16")
  return errs, rel


def fp16_paged_parity(torch, pa):
  """The fp16 warp build against its plain version at ``engine_step``
  (head dims 64 and 128: fp16 never takes the tiled build) and at the
  scheduler's ``spec_step`` and ``rollout_step``, by normalized error
  against ``PAGED_FP16_LIMIT``; then faults the limit must catch (a lost
  block of K/V rows, p rounded to bf16 instead of fp16).  Returns the max
  abs error and the largest normalized errors."""
  cases = [("engine_step", engine_step_case(torch, torch.float16, 31)[0]),
           ("engine_step_hd128", engine_step_case(torch, torch.float16, 32,
                                                  H=8, hd=128)[0])]
  for kind in ("spec_step", "rollout_step"):
    for args, _, _ in scheduled_step_case(torch, torch.float16, 33, kind):
      cases.append((kind, args))
  err, rel = 0.0, (0.0, 0.0)
  for label, args in cases:
    before = (pa.paged_attention_warp_cuda.launches,
              pa.paged_attention_tiled_cuda.launches)
    got = pa.paged_attention(*args)
    want = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert (pa.paged_attention_warp_cuda.launches,
            pa.paged_attention_tiled_cuda.launches) == (before[0] + 1,
                                                        before[1]), label
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    e = (got.float() - want.float()).abs().max().item()
    r = normalized_errors(got, want)
    assert r[0] <= PAGED_FP16_LIMIT["rel_l2"] and (
        r[1] <= PAGED_FP16_LIMIT["max_rel"]), (label, r)
    err, rel = max(err, e), (max(rel[0], r[0]), max(rel[1], r[1]))
    log(f"   {label:18s} float16 warp max|kernel - plain| {e:.3e}, "
        f"rel_l2 {r[0]:.2e}, max_rel {r[1]:.2e}")
  q, kp, vp, tables, positions = cases[0][1]
  want = pa.paged_attention_reference(q, kp, vp, tables, positions)
  lost = kp.clone()
  lost[tables[0, 0].long()] = 0                   # slot 0's first block
  faults = {"a K block lost": pa.paged_attention_reference(
                q, lost, vp, tables, positions),
            "p rounded to bf16": paged_bf16_rounded_p(torch, q, kp, vp,
                                                      tables, positions)}
  for name, faulty in faults.items():
    r = normalized_errors(faulty, want)
    caught = (r[0] > PAGED_FP16_LIMIT["rel_l2"]
              or r[1] > PAGED_FP16_LIMIT["max_rel"])
    log(f"   fp16 paged fault {name:18s}: rel_l2 {r[0]:.2e}, max_rel "
        f"{r[1]:.2e} -> {'caught' if caught else 'not caught'}")
    assert caught, f"PAGED_FP16_LIMIT misses '{name}'"
  log(f"   fp16 paged limit (rel_l2, max_rel): {PAGED_FP16_LIMIT}")
  return err, rel


def paged_bf16_rounded_p(torch, q, kp, vp, tables, positions):
  """The plain version with p rounded to bf16 (a wrong build's
  rounding) instead of fp16."""
  T, H, hd = q.shape
  L = tables.shape[1] * kp.shape[1]
  kk = kp[tables.long()].reshape(T, L, H, hd).float()
  vv = vp[tables.long()].reshape(T, L, H, hd).float()
  logits = torch.einsum("thd,tlhd->thl", q.float(), kk) / np.sqrt(hd)
  valid = (torch.arange(L, device=q.device)[None, None, :]
           <= positions.long()[:, None, None])
  logits = torch.where(valid, logits, torch.tensor(-1e9, device=q.device))
  probs = torch.softmax(logits, -1).to(torch.bfloat16).float()
  return torch.einsum("thl,tlhd->thd", probs, vv).to(q.dtype)


def fp16_timing(torch, fa, pa):
  """Each fp16 kernel beside its plain version, its bound and the
  library yardstick: the flash kernels at the training shape (B=16 H=16
  S=1024 D=64, causal; SDPA's fp16 forward, and its backward alone),
  the warp paged build at ``engine_step`` and ``spec_step`` (gather +
  SDPA in fp16).  The bound counts fp16 bytes and the fp16 peak rate."""
  sdpa = torch.nn.functional.scaled_dot_product_attention
  shape = FLASH_BENCH_SHAPE
  sets, graphs = [], []
  for i in range(2):
    q, k, v, dout = flash_case(torch, torch.float16, 300 + i, **shape)
    out, lse = fa.flash_fwd_cuda(q, k, v, True)
    delta = (dout.float() * out.float()).sum(-1)
    sets.append((q, k, v, dout, lse, delta))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    graphs.append((sdpa(*leaves, is_causal=True), leaves, dout))

  def sdpa_bwd(out, leaves, dout):
    return torch.autograd.grad(out, leaves, dout, retain_graph=True)

  fwd_args = [(q, k, v, True) for q, k, v, *_ in sets]
  bwd_args = [(*a, True) for a in sets]
  library_bwd = time_ms(torch, sdpa_bwd, graphs, reps=5)
  bounds = flash_bounds(itemsize=2, **shape)
  rows = {
      "fwd": dict(kernel_ms=time_ms(torch, fa.flash_fwd_cuda, fwd_args),
                  plain_ms=time_ms(torch, fa.flash_fwd_reference, fwd_args,
                                   reps=3),
                  library_ms=time_ms(
                      torch, lambda q, k, v, c: sdpa(q, k, v, is_causal=c),
                      fwd_args, reps=5)),
      "dkv": dict(kernel_ms=time_ms(torch, fa.flash_bwd_dkv_cuda, bwd_args),
                  plain_ms=time_ms(torch, fa.flash_bwd_dkv_reference,
                                   bwd_args, reps=3),
                  library_ms=library_bwd),
      "dq": dict(kernel_ms=time_ms(torch, fa.flash_bwd_dq_cuda, bwd_args),
                 plain_ms=time_ms(torch, fa.flash_bwd_dq_reference, bwd_args,
                                  reps=3),
                 library_ms=library_bwd),
  }
  for name, row in rows.items():
    row["bound_ms"], row["bound_by"] = bounds[name]
    log(f"   fp16 {name:4s} B=16 H=16 S=1024 D=64 causal: "
        + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in row.items()))
  paged = {}
  for label in ("engine_step", "spec_step"):
    if label == "engine_step":
      sets_p = [engine_step_case(torch, torch.float16, 400 + i)[0]
                for i in range(4)]
    else:
      sets_p = [args for i in range(4) for args, _, _ in
                scheduled_step_case(torch, torch.float16, 400 + i, label)]
    bound, bound_by = paged_bound(torch, *[sets_p[0][i] for i in (0, 1, 3,
                                                                    4)])
    lib = lambda *a: library_paged_attention(torch, *a)  # noqa: E731
    row = dict(kernel_ms=time_ms(torch, pa.paged_attention_cuda, sets_p),
               plain_ms=time_ms(torch, pa.paged_attention_reference, sets_p,
                                reps=3),
               library_ms=time_ms(torch, lib, sets_p, reps=3),
               bound_ms=bound, bound_by=bound_by)
    log(f"   fp16 paged warp {label:12s}: "
        + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in row.items()))
    paged[label] = row
  return rows, paged


def amp_training(torch, fa, bench):
  """The bench's training step with an fp32 GPTConfig under
  ``amp.level=O1`` (bf16) against the explicit-bf16 config, full width,
  ``O1_STEPS`` steps at batch 8 from the same weights and batch: equal
  losses (O1 is that compute dtype and nothing else).  Then O1 with
  ``compute_dtype=fp16`` at ``O1_FP16_LAYERS`` layers: finite losses,
  and each fp16 flash kernel launched layers x steps times (counts set
  to 0 just before).  Returns the fp16 run's launch counts."""
  from easyparallellibrary_tpu_torch.config import Config
  from easyparallellibrary_tpu_torch.env import Env
  o1 = {"amp.level": "O1", "amp.compute_dtype": "bf16"}
  losses = {}
  for label, dtype, config in (("O1 over fp32", torch.float32, o1),
                               ("explicit bf16", torch.bfloat16, {})):
    cfg = bench.bench_config(torch.device("cuda"), dtype=dtype)[0]
    state, step, batch, rng, _ = bench.build_training(
        cfg, 8, "cuda", config=Config(config))
    losses[label] = []
    for _ in range(O1_STEPS):
      state, metrics = step(state, batch, rng)
      losses[label].append(metrics["loss"].item())
    log(f"   {label:14s} losses {losses[label]}")
    del state, step
    torch.cuda.empty_cache()
  assert losses["O1 over fp32"] == losses["explicit bf16"], losses
  assert all(np.isfinite(losses["O1 over fp32"]))
  cfg = bench.bench_config(torch.device("cuda"), num_layers=O1_FP16_LAYERS,
                           dtype=torch.float32)[0]
  state, step, batch, rng, _ = bench.build_training(
      cfg, O1_FP16_BATCH, "cuda",
      config=Config({"amp.level": "O1", "amp.compute_dtype": "fp16"}))
  fa.reset_counts()
  fp16_losses = []
  for _ in range(O1_STEPS):
    state, metrics = step(state, batch, rng)
    fp16_losses.append(metrics["loss"].item())
  torch.cuda.synchronize()
  launches = {"fwd": fa.flash_fwd_cuda.launches,
              "dkv": fa.flash_bwd_dkv_cuda.launches,
              "dq": fa.flash_bwd_dq_cuda.launches}
  plain = (fa.flash_fwd_reference.calls, fa.flash_bwd_dkv_reference.calls,
           fa.flash_bwd_dq_reference.calls)
  assert all(np.isfinite(fp16_losses)), fp16_losses
  assert all(n == O1_FP16_LAYERS * O1_STEPS for n in launches.values()), (
      launches)
  assert plain == (0, 0, 0), plain
  log(f"   O1 fp16, {O1_FP16_LAYERS} layers, batch {O1_FP16_BATCH}: losses "
      f"{fp16_losses}; fp16 flash launches {launches} = {O1_FP16_LAYERS} "
      f"layers x {O1_STEPS} steps")
  del state, step
  torch.cuda.empty_cache()
  Env.get().reset()               # build_training installed the O1 config
  return launches


def fp16_serving(torch, params, pa):
  """A short O1-fp16 paged serving run at GPT-350M width: the model
  config in fp16 (the pools follow the model config's dtype, as in the
  JAX package) under ``amp.level=O1`` fp16, 8 requests; the fp16 warp
  build launched layers x steps times (the tiled build and the plain
  version never), streams against ``generate(use_cache=False)`` by the
  gap rule at fp16's spacing.  Returns the warp build's launches."""
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.config import Config
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  Env.get().reset(Config({"amp.level": "O1", "amp.compute_dtype": "fp16"}))
  try:
    cfg = GPTConfig(**GPT_350M, dtype=torch.float16)
    model = GPT(cfg)
    eng = ContinuousBatchingEngine(model, params, paged=True,
                                   num_slots=NUM_SLOTS,
                                   prefill_chunk=PREFILL_CHUNK,
                                   block_size=BLOCK_SIZE)
    assert eng.compute_dtype == torch.float16
    prompts = make_prompts(7, NUM_SLOTS, cfg.vocab_size)
    pa.reset_counts()
    for i, p in enumerate(prompts):
      eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
    out = eng.run()
    torch.cuda.synchronize()
    launches = pa.paged_attention_warp_cuda.launches
    assert launches == cfg.num_layers * eng.steps > 0, (launches, eng.steps)
    assert pa.paged_attention_tiled_cuda.launches == 0
    assert pa.paged_attention_reference.calls == 0
    log(f"   O1 fp16 paged serving: {len(prompts)} requests, {eng.steps} "
        f"steps; fp16 warp-build launches {launches} = {cfg.num_layers} x "
        f"{eng.steps}")
    greedy_vs_generate(torch, model, eng.params, prompts, out,
                       lambda top1: bf16_gap_limit(top1, 2.0 ** -10),
                       "O1 fp16 paged")
  finally:
    Env.get().reset()
  return launches


def kernel_record(torch_name, build, source, replaces, launches, err, row,
                  rel, limit, dtype="bf16"):
  return {"name": torch_name, "route": "cuda", "build": build,
          "source": source,
          "replaces": replaces, "launches": launches, "max_abs_err": err,
          "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
          "library_ms": row["library_ms"], "host_us": row.get("host_us"),
          f"{dtype}_rel_l2_err": rel[0], f"{dtype}_max_rel_err": rel[1],
          f"{dtype}_rel_l2_limit": limit["rel_l2"],
          f"{dtype}_max_rel_limit": limit["max_rel"]}


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
  from easyparallellibrary_tpu_torch import bench
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
  from easyparallellibrary_tpu_torch.models.gpt import GPTConfig
  from easyparallellibrary_tpu_torch.weights import init_params

  # ``--phases 1,2,7`` runs only those phases (a quicker check of one
  # path) and prints no result lines; with no arguments every phase runs.
  only = None
  if len(sys.argv) == 3 and sys.argv[1] == "--phases":
    only = {int(x) for x in sys.argv[2].split(",")}
  want = lambda n: only is None or n in only  # noqa: E731

  t_start = time.monotonic()
  log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
      f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
  with Phase("1. build kernels"):
    build_kernels()
  if want(2):
    with Phase("2. kernel vs plain version"):
      errs = kernel_parity(torch, pa)
  if want(3):
    with Phase("3. kernel timing"):
      times = kernel_timing(torch, pa)
  serving = (4, 5, 6, 12, 13, 14, 15, 16)
  # Reference streams of generate(use_cache=False), by prompt set, shared
  # between the paged phases and phase 14, which serves the same prompts.
  refs = {"float32": {}, "bfloat16": {}, "spec": {}}
  if any(map(want, serving)):
    with Phase("init GPT-350M weights (numpy, seed 0)"):
      params = init_params(GPTConfig(**GPT_350M), seed=0, device="cuda")
  if want(4):
    with Phase("4. GPT-350M fp32: engine vs generate(use_cache=False)"):
      warp_launches = engine_fp32_vs_generate(torch, params, pa,
                                              refs["float32"])
  if want(5) or want(6):
    with Phase("5. GPT-350M bf16: serving staggered requests"):
      launches, eng = engine_bf16_serving(torch, params, pa,
                                          refs["bfloat16"])
    with Phase("6. GPT-350M bf16: where the engine step's time goes"):
      step_breakdown(torch, eng)
    del eng
  if want(12):
    with Phase("12. GPT-350M bf16: speculative serving (n-gram, then "
               "self-draft)"):
      spec = speculative_serving(torch, params, pa, refs["spec"])
  if want(13):
    with Phase("13. GPT-350M bf16: prefix caching (shared system prompt, "
               "second turns)"):
      prefix = prefix_cache_serving(torch, params, pa)
  if want(14):
    with Phase("14. GPT-350M: the contiguous-slot engine (default config)"):
      contiguous_serving(torch, params, pa, refs)
  if want(15):
    with Phase("15. GPT-350M bf16: serving resilience (paged with the "
               "prefix cache, contiguous)"):
      serving_resilience(torch, params, pa)
  if want(16):
    with Phase("16a. fp16 builds vs plain versions"):
      fp16_flash_errs, fp16_flash_rel = fp16_flash_parity(torch, fa)
      fp16_paged_err, fp16_paged_rel = fp16_paged_parity(torch, pa)
    with Phase("16b. fp16 kernel timing"):
      fp16_flash_times, fp16_paged_times = fp16_timing(torch, fa, pa)
    with Phase("16c. amp O1 training (bench's step) and O1-fp16 serving"):
      fp16_flash_launches = amp_training(torch, fa, bench)
      fp16_warp_launches = fp16_serving(torch, params, pa)
  del refs
  if any(map(want, serving)):
    del params
  # An engine is freed by the cycle collector (its scheduler holds bound
  # methods of it): collect before the training phases, so that phase
  # 10's peak memory counts training alone.
  gc.collect()
  torch.cuda.empty_cache()
  if want(7):
    with Phase("7. flash kernels vs plain versions"):
      flash_errs, flash_rel = flash_parity(torch, fa)
      flash_check_sensitivity(torch, fa)
      flash_lse_autograd(torch, fa)
  if want(8):
    with Phase("8. flash kernel timing"):
      flash_times = flash_timing(torch, fa)
  if want(9):
    with Phase("9. GPT-350M widths, 4 layers, fp32: flash vs dense "
               "training"):
      train_fp32_flash_vs_dense(torch, fa, bench)
  if want(10) or want(11):
    with Phase("10. GPT-350M bf16 training (easyparallellibrary_tpu_torch."
               "bench)"):
      record, flash_launches = train_bf16_bench(torch, fa, bench)
    with Phase("11. GPT-350M bf16: where the training step's time goes"):
      train_step_breakdown(torch, bench, record["detail"]["batch_size"])
  log(f"total {time.monotonic() - t_start:.1f} s")
  if only is not None:
    return 0

  flash_src = "easyparallellibrary_tpu_torch/kernels/csrc/flash_attention.cu"
  flash_py = "easyparallellibrary_tpu/kernels/flash_attention.py"
  flash_records = [
      kernel_record("flash_attention_fwd", "flash_fwd_wgmma_kernel<64>",
                    flash_src, f"{flash_py}:89 and :241",
                    flash_launches["fwd"], flash_errs["fwd"],
                    flash_times["fwd"], flash_rel["fwd"],
                    FLASH_BF16_LIMIT["fwd"]),
      kernel_record("flash_attention_bwd_dkv",
                    "flash_bwd_dkv_wgmma_kernel<64>", flash_src,
                    f"{flash_py}:133 and :363", flash_launches["dkv"],
                    flash_errs["dkv"], flash_times["dkv"],
                    flash_rel["dkv"], FLASH_BF16_LIMIT["grad"]),
      kernel_record("flash_attention_bwd_dq", "flash_bwd_dq_wgmma_kernel<64>",
                    flash_src, f"{flash_py}:172 and :404",
                    flash_launches["dq"], flash_errs["dq"],
                    flash_times["dq"], flash_rel["dq"],
                    FLASH_BF16_LIMIT["grad"]),
  ]
  paged_src = "easyparallellibrary_tpu_torch/kernels/csrc/paged_attention.cu"
  paged_replaces = "easyparallellibrary_tpu/kernels/paged_attention.py:119"

  def paged_record(name, build, launches, dtype_name):
    row = times[(dtype_name, "engine_step")]
    return {"name": name, "route": "cuda", "build": build,
            "source": paged_src, "replaces": paged_replaces,
            "launches": launches, "max_abs_err": errs[dtype_name],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "dtype": dtype_name,
            "shape": "engine_step",
            "spec_step": times[(dtype_name, "spec_step")],
            "random_tables": times[(dtype_name, "random_tables")]}

  fp16_flash = [
      kernel_record(name, build, flash_src, replaces,
                    fp16_flash_launches[k], fp16_flash_errs[k],
                    fp16_flash_times[k], fp16_flash_rel[k],
                    FLASH_FP16_LIMIT["fwd" if k == "fwd" else "grad"],
                    dtype="fp16")
      for name, k, build, replaces in (
          ("flash_attention_fwd_fp16", "fwd", "flash_fwd_kernel<__half, 4>",
           f"{flash_py}:89 and :241"),
          ("flash_attention_bwd_dkv_fp16", "dkv",
           "flash_bwd_dkv_kernel<__half, 4, 4>", f"{flash_py}:133 and :363"),
          ("flash_attention_bwd_dq_fp16", "dq",
           "flash_bwd_dq_kernel<__half, 4, 4>", f"{flash_py}:172 and :404"))]
  row = fp16_paged_times["engine_step"]
  fp16_paged = {
      "name": "paged_attention_warp_fp16", "route": "cuda",
      "build": "paged_attention_kernel<__half, 1>", "source": paged_src,
      "replaces": paged_replaces, "launches": fp16_warp_launches,
      "max_abs_err": fp16_paged_err, "ms": row["kernel_ms"],
      "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
      "bound_by": row["bound_by"], "library_ms": row["library_ms"],
      "dtype": "float16", "shape": "engine_step",
      "spec_step": fp16_paged_times["spec_step"],
      "fp16_rel_l2_err": fp16_paged_rel[0],
      "fp16_max_rel_err": fp16_paged_rel[1],
      "fp16_rel_l2_limit": PAGED_FP16_LIMIT["rel_l2"],
      "fp16_max_rel_limit": PAGED_FP16_LIMIT["max_rel"]}
  print(json.dumps({"kernels": [
      dict(paged_record("paged_attention_tiled",
                        "paged_attention_tiled_kernel<64>", launches,
                        "bfloat16"),
           launches_speculative=spec, launches_prefix_cache={
               k: v["launches"] for k, v in prefix.items()}),
      paged_record("paged_attention_warp", "paged_attention_kernel<float, 1>",
                   warp_launches, "float32"),
  ] + flash_records + fp16_flash + [fp16_paged]}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
