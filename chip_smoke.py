#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and
``nvcc``.  It drives the port's two main paths at the full width of
GPT-350M (``easyparallellibrary_tpu_torch``) — the paged
continuous-batching engine (plain, speculative, with the prefix cache),
and the training step of ``bench.py`` — and holds every CUDA kernel of
those paths against its plain PyTorch version.  The serving phases run
6 of GPT-350M's 24 layers (``SERVE_LAYERS``; widths kept), training
phase 10 all 24:

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
16. amp O1 and the fp16 builds: ``flash_route`` for every dtype and
    head dim (fp16's forward, dK/dV and dQ on the wgmma builds at head
    dims 64 and 128) and ``paged_route`` for every pair of types and
    head dim; the fp16 flash kernels against their plain versions at
    phase 7's shapes and the fp16 paged kernel (the slot-tiled build at
    head dims 64 and 128, the warp build at 32) at ``engine_step``,
    ``spec_step`` and ``rollout_step`` (normalized-error limits, their
    sensitivity to faults), each timed beside its plain version, its
    bound and SDPA in fp16, the flash kernels also beside their bf16
    builds in turns, the tiled paged build beside the warp build it
    replaced; the bench's training step (12 layers)
    with an fp32 GPTConfig under ``amp.level=O1`` against the
    explicit-bf16 config (equal losses); O1-fp16 training at 4 layers
    (fp16 flash launches), then at bench.py's full width (24 layers,
    16 x 1024) under the dynamic loss scale: step ms, MFU, peak memory,
    finite losses, 24 launches of each flash kernel a step, no plain
    version; a short O1-fp16 paged serving run through the fp16 tiled
    build; the mixed case (fp16 q over bf16 pools, amp O1 in fp16 over a
    bf16 model config: the tiled build's tf32 instantiation at head dims
    64 and 128, the mixed warp build at 32) against its plain version at
    ``engine_step``, ``spec_step`` and ``rollout_step``
    (``PAGED_MIXED_LIMIT`` and its sensitivity), timed beside its plain
    version, the mixed warp build, its bound and gather + SDPA in fp32,
    and a short O1-fp16 paged serving run over a bf16 config through it;
17. serving observability, GPT-350M bf16: phase 5's load through the
    paged engine (n-gram drafter, prefix cache) with the tracer, the SLO
    monitor, the device introspector and a JSONL registry sink on,
    against off, in ABBA turns: streams token-equal, host ms per step
    and synchronising calls per run (held equal); the trace validated
    with 16 complete request lifecycles and rendered by the report CLI;
    a ``serving/*`` record per step; the HBM gauges, the cost card and
    the compile sentinel; an ITL rule breach's diagnostic bundle, and a
    watchdog breach arming a ``torch.profiler`` trace of the next step
    that names the paged kernel; a short traced contiguous run;
18. the training runtime around the step, bf16 at ``bench.py``'s
    configuration cut to 6 of its 24 layers (``RT_LAYERS``): token
    records written and read back by the native
    ``RecordReader`` through ``DevicePrefetcher`` into ``fit(
    build_train_step(...))`` with the anomaly sentinel on — (a) 10 steps
    with a ~1.3 GB checkpoint every 10 (tokens/s, MFU, save seconds, the
    flash launches against 6 x steps); (b) a fresh state resuming at
    step 10 (restore seconds, restored state bit-equal to the live one,
    steps 11-20 against the uninterrupted run); (c) a two-step NaN
    window under ``set_sync_debug_mode("error")`` left bit-identical,
    then a persistent fault rolled back with the learning rate halved;
    (d) one step with ``pipeline.num_micro_batch=2`` and with
    ``optimizer.num_apply_group=4`` (params bit-equal to one group);
    (e) dropout 0.1 (finite losses, the masks' drop rate within 3
    sigma); (f) ``DraftModelDrafter.from_checkpoint`` serving 8 requests
    self-draft on the paged engine, its paged launches counted; (g) host
    offload (``offload.level = "v0"``) at the same configuration against
    no offload: the moments pinned on the host, the losses loss for
    loss and the final params and moments bit-equal, peak HBM and step
    ms both ways, the flash launches, a native
    save/restore of the offloaded state bit-equal; (h) that 1.3 GB
    state through ``torch.distributed.checkpoint``
    (``save_checkpoint_orbax``), restored bit-equal, its seconds beside
    the native saver's;
19. the replicated fleet, GPT-350M bf16, paged (8 slots, chunk 128,
    block 16) under phase 5's staggered load: (a) a ``Router`` with one
    in-process replica token-equal to the bare engine (the kernel
    libraries unchanged, tiled launches SERVE_LAYERS x engine steps); (b) two
    in-process replicas with a ``ReplicaKiller`` mid-decode, in bf16
    (streams held to the gap rule) and fp32; (c) two process replicas
    spawned from ``testing.factories.gpt_350m`` on the card: a SIGKILL
    of one mid-decode (nothing lost, the pid reaped, its card memory
    back), ``rejoin(0, force=True)`` respawning it, ``drain(1,
    timeout_s=0)`` through the evacuate RPC, no child left after
    ``close()``; (d) tokens/s, TTFT, ITL and host ms a sweep for 1 and 2
    process replicas (one ABBA round of windows, medians and the spread
    between windows) and 2 in-process ones on the one card, with the
    children's launches summed from their beats; (e) traced children
    (4 layers): their spans harvested, a failed-over request one flow
    across the parent and both children, the trace validated.

Every phase raises on failure.  The second-to-last line of the output is
the ``{"kernels": [...]}`` record, the last one
``{"ok": true, "device": {...}}``.  Without a GPU, or outside a checkout
of the repository, it exits with code 2 and prints no result.
``python3 chip_smoke.py --phases 2,3`` runs the build and the listed
phases only (5 and 6, 10 and 11 run together) and prints no result
lines.  ``--phases 20`` runs the latest slice's:

20. GPT-350M bf16, the self-healing fleet: (a) a paged engine with the
    n-gram drafter and the autotuner under an overload burst, through
    spec_trim, budget_tight and slot_cap and back (actuations, host ms a
    step at each level, the tiled kernel against its plain version at a
    real step planned at each level, non-shed streams by the gap rule,
    no kernel library loaded); (b) the golden chaos-heal episode
    (``tests/golden/sim_chaos_heal.json``) driven through a real fleet
    of in-process replicas at GPT-350M's widths and 6 of its layers
    (``HEAL_LAYERS``, as (c)) as recorded, its actuation sequence
    and counters equal to the file's, then replayed by the simulator;
    (c) blue/green rollouts to a checkpoint of ``init_params(seed=1)``:
    in process under load (zero lost, each stream against its own
    version's weights), one forced into a canary breach and rolled back
    (blue streams against a never-rolled run), one process blue child to
    one green child restoring the checkpoint; (d) two process replicas,
    sweep against reactor in ABBA rounds, then one child SIGSTOPped
    under the reactor; (e) phase 5's requests as concurrent SSE clients
    of the front door on 127.0.0.1 through an in-process reactor fleet:
    streams against direct submits, client TTFT beside the router's, a
    disconnect freeing its slot, ``traceparent`` echoed.

``--phases 21`` runs the tensor-parallel mesh, two ranks started by
``utils.launcher.spawn`` sharing the one card (each rank's program is
in ``testing/tp_workers.py``; every group has a deadline and the phase a
wall limit):

21. (a) whether NCCL takes two ranks on the card (it refuses two ranks
    on one device), and the backend the phase then names (gloo over
    CUDA tensors unless NCCL took them); every collective on CUDA
    tensors against numpy; K2 (engine_step) and K1 (B=16, S=1024,
    D=64) at the per-rank H = 8 against their plain versions, timed
    beside them, their bounds and the library yardsticks; (b) GPT-350M
    bf16 on the paged engine at tp = 2 under phase 5's load, with the
    n-gram drafter and with the prefix cache: streams against the tp = 1
    engine's by the gap rule, the tiled kernel's launches SERVE_LAYERS x steps on
    each rank, tokens/s, TTFT p50 and host ms a step beside tp = 1's;
    (c) bench.py's training step at 6 of its layers at tp = 2, 2
    steps: losses against tp = 1 within one bf16 spacing, each rank's
    flash launches 6 x steps per kernel, peak memory and step ms; (d) explicit DP = 2 with
    8 MB fusion buckets and ZeRO-1 at DP = 2 (4 layers) against one
    process, ZeRO-1's moment bytes half of DP's; (e) a row-parallel
    Dense through the overlap ring against ``overlap="off"``.  Every
    number of phase 21 is two processes time-sharing one card: a
    correctness check, not a scaling number.

``--phases 22`` runs the pipeline, two stage ranks sharing the card over
gloo (in the whole run, the rank group phase 21 starts; each rank's
program is ``testing/pp_workers.chip_pipeline``):

22. bench.py's GPT-350M bf16 step (flash attention, remat ``dots_flash``,
    AdamW(3e-4, wd 0.01), batch 16 x 1024) cut into S = 2 stages of
    M = 4 micro-batches, through ``make_gpt_train_step``: ``smap`` GPipe,
    ``smap`` 1F1B, ``smap`` interleaved 1F1B (K = 2) and the ``vmap``
    layout's PreferBackwardOptimizer, each 1 warm and 3 timed steps.  On
    each rank: the losses within 2^-12 relative (a sixteenth of one bf16
    spacing) of the one-process step's (the same batch and
    ``init_params`` weights), K1's launches
    equal to the schedule's formula and the plain versions' calls 0,
    step ms, peak memory, the bytes staged through the host a step, the
    bubble fraction, the 1F1B run's profiled step's device busy and idle
    share; and
    K1's forward and dK/dV at the stage's shape against their plain
    versions.  Two processes time-sharing one card:
    a correctness check, not a scaling number.

``--phases 23`` runs MoE, sequence parallelism and ZeRO under the
pipeline (in the whole run 23b and 23c ride phase 21's rank group;
each rank's program is in ``testing/sp_workers.py``):

23. (a) BASELINE.md row 5's GPT-MoE (12 layers at GPT-350M's widths, 8
    experts every 2nd block, top-1, capacity factor 1.25, the einsum
    path; bf16, remat ``dots_flash``, ``loss_chunk`` 256) at 8 x 1024 on
    one card through ``bench.build_training``, 1 warm and 3 timed
    steps: losses, the aux loss, step ms, tokens/s, MFU, peak, the
    tokens dropped at step 1 (the routers concentrate at random init),
    K1 launches 12 a kernel a step; (b) the same weights and batch as
    ``moe_impl="a2a"`` on ``expert:2`` (4 sequences a rank), 2 steps:
    losses within 2^-8 of (a)'s, the expert moments a rank half of
    (a)'s; (c) GPT-350M (24 layers) at ``max_seq_len`` 4096, batch 2,
    ``seq_parallel`` on ``seq:2`` with the zigzag ring, the contiguous
    ring and Ulysses, 2 steps each: losses within 2^-8 of one process's
    ``pallas_flash`` run, K1's launches a rank equal to
    ``sequence.ring_attention.launches_per_layer`` (1 a layer for
    Ulysses) with the plain versions never called, peak and bytes
    staged through the host a step; (d) ZeRO v1 and v0 under the smap
    1F1B pipeline on four ranks (stage 2 x data 2) of their own,
    GPT-350M widths at 4 layers, 8 x 1024, M = 2, 2 steps: losses within
    2^-12 of the same pipeline without ZeRO, moments a rank half, K1's
    launches the schedule's formula.

``--phases 24`` runs BERT and ResNet, the models of BASELINE.md rows 1-3
(in the whole run 24c and 24e ride phase 21's rank group; each rank's
program is ``testing/bert_workers.chip_phase24``):

24. (a) BERT-Large MLM at ``benchmarks/single_chip_models.py``'s shape
    (8 x 512, bf16, whole-block remat, ``attn_impl="pallas_flash"``: K1
    without the mask) through ``epl.init`` -> ``replicate`` ->
    ``create_sharded_train_state`` -> ``parallelize(
    make_bert_train_step)``, 1 warm and 5 timed AdamW steps: step ms,
    tokens/s, MFU (the benchmark's FLOPs a token), peak, K1's launches
    equal to 2L forwards, L dK/dV and L dQ a step; at 4 layers in fp32,
    the flash loss and gradients against dense attention; one step of
    ``BertForQuestionAnswering``; (b) the three kernels without the mask
    at B=8 H=16 S=512 D=64 bf16 against their plain versions
    (``FLASH_BF16_LIMIT``), timed beside the plain versions, SDPA with
    ``is_causal=False`` and the bounds of full attention; (c) BASELINE
    row 2: (a)'s model, weights and batch in S = 2 stages of M = 4 under
    the smap 1F1B on two ranks, 3 steps: losses within 2^-12 of (a)'s
    first three, K1's launches the schedule's formula, step ms and peak
    a rank; (d) ResNet-50 at 64 x 224 x 224, bf16: group norm through
    ``make_train_step``, 1 warm and 5 steps (images/s, step ms, MFU by
    the benchmark's count, peak), and batch norm through
    ``MutableTrainState`` / ``make_mutable_train_step``, 3 steps (the
    running statistics move and stay finite); (e) BASELINE row 3:
    ResNet-50 with a 131072-class head built under ``split(2)`` on two
    model ranks, 32 images, 2 steps: losses within 2^-12 of one process.
    Phase 24's own wall is held under 150 s.

``--phases 25`` runs the tooling (in the whole run 25f rides phase 21's
rank group):

25. (a) ``profiler.profile_step`` over bench.py's GPT-350M bf16 step (24
    layers, 16 x 1024, flash attention, remat ``dots_flash``,
    ``loss_chunk`` 256): its FLOPs equal to the same step's count with
    the flash dispatch routed to the plain versions on the card and with
    plain attention (``attn_impl="xla"``), within 5% above
    ``gpt_flops_per_token`` x tokens; its memory report beside the
    allocator's peak and phase 10's; K1's launches two steps x 24; the
    caller's parameters bit-equal; (b) ``FlopsProfiler`` and
    ``MemoryProfiler`` over 6 steps, the MFU line beside
    ``StepProfiler``'s; (c) the perf gate with the reference twins on the
    card: 0 violations against the port's budget (generated on the CPU),
    K2 launched by the paged twin, each twin's measured peak within the
    CPU card's static bound, a planted regression refused; (d) the
    evidence writer into a temporary log, stamped with the card's name
    and power limit; (e) ``examples.train_gpt`` at GPT-350M widths, 4
    layers, 3 steps, its K1 launches; ``runtime.offload.offload_to_host(
    state, "all")`` at bench.py's configuration cut to 4 layers against
    no offload, 2 steps each: losses and parameters bit-equal, the memory
    held between steps and the second step's peak both lower; (f) ``profiler.flops.
    collective_op_sizes`` of a row-parallel Dense (bf16, 1024 x 4096 ->
    1024) on two ranks: one all-reduce of the analytic bytes;
26. checkpoints of a sharded training state, in phase 21's rank group
    (``testing.ckpt_workers.train_resume``): GPT-350M widths at 4 layers,
    bf16 over fp32 parameters, K1, AdamW, 8 x 1024 from
    ``init_params(seed=0)`` — (a) TP = 2, (b) ZeRO v1 at ``data:2``, (c)
    the smap 1F1B pipeline at ``stage:2`` (2 layers a stage): ``fit``
    checkpoints at step 3 (each leaf gathered by its layout, only rank 0
    writing) and goes on to step 6; a fresh state restores its blocks
    (parameters and moments bit-equal to the saving run's) and resumes
    to step 6 bit-equal to it; every checkpoint at the one-process
    logical layout; K1's launches at their formula, no plain call; save
    and restore seconds, bytes gathered through the host, the leader's
    host memory, each step's wall; 26a's checkpoint reloaded at tp = 1 in
    this process, its loss on a held batch within 2^-8 of the TP ranks';
    (d) the paged engine at tp = 1 serving 8 staggered greedy requests
    from it, the streams against ``generate(use_cache=False)`` by the
    gap rule, K2's tiled launches at layers x steps, none warp or plain.

``--phases 27`` runs K1's tile builds and the block table (in the whole
run phases 8 and 10 already take the committed table's builds):

27. (a) each kernel's builds in the library against
    ``flash_attention.WGMMA_BUILDS``, each build's registers, spill bytes
    and shared memory as the loaded binary reports them, and every build
    of the forward, dK/dV and dQ, bf16 and fp16, D 64 and 128, causal and
    not, at bench.py's rows (batch cut to 2), a ragged length and a key
    length past the query length against the plain versions
    (``FLASH_BF16_LIMIT``, ``FLASH_FP16_LIMIT``), ``by_tile`` counting
    the build launched; (b) ``kernels.flash_autotune``'s sweep (nothing
    written) at bench.py's shape (B 16, H 16, S 1024, D 64) and at S 8192,
    D 128: each candidate's causal forward + backward beside SDPA's, each
    build of each kernel alone; (c) bench.py's GPT-350M step (24 layers,
    16 x 1024) with the committed block table against the default build:
    every K1 launch on its arm's build (``by_tile``), the losses of 3
    steps from the same weights within one bf16 spacing, step ms and MFU
    in ABBA chains.

``--phases 28`` runs K3, the LayerNorm kernels (in the whole run too):

28. (a) the forward and backward kernels against the plain version at
    the benchmark's rows, ``[65536, 1024]`` bf16 (y, dx, dgamma and
    dbeta by the tolerances of ``tests/test_torch_layer_norm.py``, and
    normalized errors); (b) each kernel's ms (CUDA events), the bytes
    bound (x and y, or x, dy and dx, once over 3.35 TB/s), the plain
    version's ms (the formula, and autograd's backward of it alone),
    ``F.layer_norm``'s forward and backward as the library yardstick,
    and each wrapper's host time per call; (c) bench.py's GPT-350M bf16
    step (``dots_flash``) cut to 4 layers, 2 steps: K3's launches at
    their count (two LayerNorms a block, twice forward with the
    recompute, and ``ln_f``), no plain call on the card.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the peak rates the
# bound uses for each operand type (fp32 without tensor cores, bf16 and
# fp16 dense tensor cores, tf32: the mixed paged build's products).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
                  "tfloat32": 495e12}

GPT_350M = dict(vocab_size=32768, num_layers=24, num_heads=16, d_model=1024,
                d_ff=4096, max_seq_len=1024)
# The serving phases (4-6, 12-17, 19-20, 21b) run GPT-350M's widths at 6
# of its 24 layers (the script's time: a slow host read the whole script
# at 1251 s at 24 layers, and at 1320.7 s at 12 once phase 27 was added):
# the first 6 blocks of the seed-0 draw (``depth_cut``) are the 6-layer
# draw's, bit for bit, so the process children, the TP ranks and the
# references share weights.
SERVE_LAYERS = 6
GPT_SERVE = dict(GPT_350M, num_layers=SERVE_LAYERS)
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
# fp16: the same rule.  Set when every fp16 kernel ran on the CUDA
# cores, from the largest readings over phase 7's shapes on an NVIDIA
# H100 80GB HBM3 at 700 W: out 2.8e-4 / 7.0e-4; the gradients 0 (that
# backward summed in the order of the plain version's fp32 products).
# The forward limits are 3.5 / 2.9 times its readings; the gradient
# limits catch every fault flash_check_sensitivity must catch, at 0.6 /
# 0.4 of the smallest such reading (tests/test_torch_gpu.py holds its
# shapes to them).  The wgmma builds at head dims 64 and 128 sum in
# another order, so their gradients read above 0, inside these limits.
FLASH_FP16_LIMIT = {"fwd": dict(rel_l2=1e-3, max_rel=2e-3),
                    "grad": dict(rel_l2=2e-4, max_rel=2e-3)}
# The fp16 warp paged build against its plain version (p rounded after
# a running max there, after the full softmax in the plain version):
# 1.8 / 2.1 times the largest readings (5.6e-4 / 9.4e-4, at rollout_step;
# NVIDIA H100 80GB HBM3, 700 W), and below p rounded to bf16 (1.26e-3).
PAGED_FP16_LIMIT = dict(rel_l2=1e-3, max_rel=2e-3)
# The mixed build (fp16 q over bf16 pools, fp32 out) against its plain
# version: the same rounding of p to fp16 as the fp16 build, so the same
# limit; mixed_paged_parity checks that it catches a lost K block and p
# rounded to bf16.
PAGED_MIXED_LIMIT = dict(rel_l2=1e-3, max_rel=2e-3)
# The training shape (batch cut to 2), the JAX tests' shapes, a ragged
# length whose last tile of each head runs past S (B*H > 1), and the
# wgmma kernels' second head dim.
FLASH_SHAPES = [("training_b2", dict(B=2, H=16, S=1024, D=64)),
                ("jax_qkv", dict(B=2, H=2, S=128, D=32)),
                ("jax_multiblock", dict(B=2, H=2, S=256, D=32)),
                ("ragged_s200", dict(B=2, H=3, S=200, D=64)),
                ("d128", dict(B=2, H=4, S=384, D=128))]
FLASH_BENCH_SHAPE = dict(B=16, H=16, S=1024, D=64)
# Phase 28: the benchmark cells' LayerNorm rows (64 x 1024 tokens, d_model
# 1024) and the GPT step's cut.
LN_BENCH_SHAPE = (65536, 1024)
LN_STEP_LAYERS, LN_STEP_BATCH, LN_STEP_STEPS = 4, 8, 2
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
# 16c's O1-fp16 run at bench.py's full width (24 layers, 16 x 1024,
# dots_flash, loss_chunk 256) under the dynamic loss scale: one warm-up
# step, then O1_FULL_STEPS timed ones.
O1_FULL_BATCH, O1_FULL_STEPS = 16, 3
# 16c's O1-over-fp32 against explicit bf16: 12 of the 24 layers (the
# script's time).
O1_LAYERS = 12
# Phase 18: batch, records, fit's steps before and after the resume, the
# sentinel's window, dropout, and the resumed losses' tolerance (kept
# only where the card's products are not deterministic run to run).
RT_BATCH, RT_RECORDS, RT_STEPS, RT_RESUME_STEPS = 16, 1024, 10, 20
RT_MAX_BAD, RT_DROPOUT, RT_RESUME_RTOL = 4, 0.1, 1e-3
# Phases 18-18h run bench.py's widths at 6 of its 24 layers (the
# script's time; a checkpoint of that state is about 1.3 GB).
RT_LAYERS = 6


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


def paged_bound(torch, q, kp, tables, positions, out_itemsize=None,
                ops_type=None):
  """(least ms, "bytes" | "operations") for one paged-attention call on
  these inputs: the K/V rows it must read (each distinct pool row once,
  in the pools' type), q, the live table entries, positions and the
  output (``out_itemsize`` bytes a value, by default q's), over the HBM
  rate; ~4 operations per attended K/V element over the peak rate of
  ``ops_type`` (a ``PEAK_OPS_PER_S`` key, by default q's type)."""
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
  out_itemsize = itemsize if out_itemsize is None else out_itemsize
  nbytes = (2 * distinct * H * hd * kp.element_size()
            + q.numel() * (itemsize + out_itemsize)
            + 4 * int((last // bs + 1).sum()) + 4 * T)
  ops = 4 * int((last + 1).sum()) * H * hd
  dtype = ops_type or str(q.dtype).replace("torch.", "")
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
        tiled = pa.takes_tiles(dtype, dtype, args[0].shape[2])
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
      if pa.takes_tiles(dtype, dtype, sets[0][0].shape[2]):
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
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.float32)
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
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
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
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
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
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
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


def _device_events(torch, prof):
  """``(name, start_us, end_us)`` of every event a profile ran on the
  card: kernels, copies and sets, without the ``record_function``
  ranges the program's spans mirror onto the device's timeline (a range
  covers the gaps between its kernels)."""
  return [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.time_range.end > e.time_range.start
          and not getattr(e, "is_user_annotation", False)]


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
  for name, start, end in _device_events(torch, prof):
    intervals.append((start, end))
    calls, us = kernels.get(name, (0, 0.0))
    kernels[name] = (calls + 1, us + end - start)
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


def flash_bounds(B, H, S, D, itemsize, causal=True):
  """(least ms, "bytes" | "operations") of the forward, dK/dV and dQ at
  this shape: each input read once and each output written once over the
  HBM rate, against the products' operations over the bf16 tensor-core
  peak: 4, 8 and 6 x B*H*S*S*D/2 causal (the half of the scores at or
  below the diagonal), twice that for full attention."""
  row = B * H * S * D * itemsize
  rows = B * H * S * 4                          # one fp32 [B, H, S]
  work = {"fwd": (4 * row + rows, 4),           # q, k, v, o; lse
          "dkv": (6 * row + 2 * rows, 8),       # q, k, v, dO, dk, dv
          "dq": (5 * row + 2 * rows, 6)}        # q, k, v, dO, dq
  pairs = B * H * S * S * (0.5 if causal else 1.0)
  out = {}
  for name, (nbytes, units) in work.items():
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = units * pairs * D / PEAK_OPS_PER_S["bfloat16"] * 1e3
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


def flash_timing(torch, fa, shape=FLASH_BENCH_SHAPE, causal=True):
  """Kernel, plain-version and library times at ``shape`` (the training
  shape by default), bf16, ``causal`` or full.  The library yardsticks
  (never called by the port) are ``scaled_dot_product_attention(
  is_causal=causal)``'s forward for the forward kernel and its backward
  alone for each backward kernel: one ``autograd.grad`` with
  ``retain_graph=True`` on a graph built once, so the forward stays
  outside the timed window.  Also each wrapper's host time per call: the
  forward wrapper encodes 3 TMA tensor maps per call, dK/dV and dQ 4
  each."""
  sdpa = torch.nn.functional.scaled_dot_product_attention
  sets, graphs = [], []
  for i in range(2):                  # two copies: each call finds L2 cold
    q, k, v, dout = flash_case(torch, torch.bfloat16, 200 + i, **shape)
    out, lse = fa.flash_fwd_cuda(q, k, v, causal)
    delta = (dout.float() * out.float()).sum(-1)
    sets.append((q, k, v, dout, lse, delta))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    graphs.append((sdpa(*leaves, is_causal=causal), leaves, dout))

  def sdpa_bwd(out, leaves, dout):
    return torch.autograd.grad(out, leaves, dout, retain_graph=True)

  fwd_args = [(q, k, v, causal) for q, k, v, *_ in sets]
  bwd_args = [(*a, causal) for a in sets]
  library_bwd = time_ms(torch, sdpa_bwd, graphs, reps=5)
  bounds = flash_bounds(itemsize=2, causal=causal, **shape)
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
    log(f"   {name:4s} "
        + " ".join(f"{k}={v}" for k, v in shape.items())
        + f" bf16 {'causal' if causal else 'full'}: "
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
  builds = {k: fa.flash_tile(k, bench.GPT_350M["max_seq_len"], 64,
                              torch.bfloat16) for k in launches}
  by_tile = _flash_by_tile(fa)
  log(f"   flash launches {launches} over {steps} steps x {layers} layers, "
      f"by (tile, stages) {by_tile} (the block table's builds {builds}); "
      f"plain-version calls {plain}")
  assert record["metric"] == "gpt350m_train_mfu" and record["value"] > 0
  assert np.isfinite(d["loss"])
  assert all(n == layers * steps for n in launches.values()), launches
  assert by_tile == {k: {builds[k]: launches[k]} for k in launches}, by_tile
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
  for name, start, end in _device_events(torch, prof):
    intervals.append((start, end))
    calls, us = kernels.get(name, (0, 0.0))
    kernels[name] = (calls + 1, us + end - start)
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
    cfg = GPTConfig(**GPT_SERVE, dtype=getattr(torch, dtype_name))
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
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
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


def flash_routes(torch, fa):
  """The build each flash kernel takes, by dtype and head dim, as the
  library's own dispatch gates report it (``flash_route``), against
  this slice's plan: the wgmma builds for bf16 and fp16 at head dims 64
  and 128 (all three kernels); the CUDA cores for fp32 and at every
  other head dim.  Returns the fp16 routes at head dim 64, by kernel."""
  got, want = {}, {}
  for dtype_name in ("float32", "bfloat16", "float16"):
    dtype = getattr(torch, dtype_name)
    for D in (32, 64, 128, 256):
      for kernel in ("fwd", "dkv", "dq"):
        tensor_cores = D in (64, 128) and dtype_name != "float32"
        want[dtype_name, D, kernel] = ("wgmma" if tensor_cores
                                       else "cuda_cores")
        got[dtype_name, D, kernel] = fa.flash_route(kernel, dtype, D)
  for dtype_name in ("float32", "bfloat16", "float16"):
    log(f"   flash_route {dtype_name:8s}: " + "; ".join(
        f"D={D} " + " ".join(f"{k} {got[dtype_name, D, k]}"
                             for k in ("fwd", "dkv", "dq"))
        for D in (32, 64, 128, 256)))
  assert got == want, {k: (got[k], want[k]) for k in got if got[k] != want[k]}
  return {k: got["float16", 64, k] for k in ("fwd", "dkv", "dq")}


def paged_routes(torch, pa):
  """The build each paged-attention call takes, by (query, pool) types
  and head dim, as the library's own gate reports it (``paged_route``),
  against the dispatcher's rule (``takes_tiles``): the tiled build for
  bf16 / bf16, fp16 / fp16 and fp16 / bf16 at head dims 64 and 128, a
  warp build for every other pair the kernels take."""
  names = {torch.float32: "fp32", torch.bfloat16: "bf16",
           torch.float16: "fp16"}
  pairs = [(t, t) for t in names] + [pa.MIXED_DTYPES,
                                     (torch.bfloat16, torch.float32),
                                     (torch.float16, torch.float32)]
  got, want = {}, {}
  for q_dtype, kv_dtype in pairs:
    for hd in (32, 64, 128, 256):
      key = (names[q_dtype], names[kv_dtype], hd)
      got[key] = pa.paged_route(q_dtype, kv_dtype, hd)
      want[key] = ("tiled" if pa.takes_tiles(q_dtype, kv_dtype, hd)
                   else "warp")
  for q_dtype, kv_dtype in pairs:
    log(f"   paged_route {names[q_dtype]} q / {names[kv_dtype]} pools: "
        + "; ".join(f"hd={hd} {got[names[q_dtype], names[kv_dtype], hd]}"
                    for hd in (32, 64, 128, 256)))
  assert got == want, {k: (got[k], want[k]) for k in got if got[k] != want[k]}


def paged_counts(pa):
  """Every paged build's launch count: the tiled build's by pair of
  types, its total, the warp build's and the mixed warp build's."""
  return dict(pa.paged_attention_tiled_cuda.by_build,
              tiled=pa.paged_attention_tiled_cuda.launches,
              warp=pa.paged_attention_warp_cuda.launches,
              mixed=pa.paged_attention_mixed_cuda.launches)


def paged_build_of(pa, q, kp):
  """The build the dispatcher's rule gives a call (``paged_counts``'s
  key)."""
  if pa.takes_tiles(q.dtype, kp.dtype, q.shape[-1]):
    return pa.TILED_BUILDS[q.dtype, kp.dtype]
  return "mixed" if q.dtype != kp.dtype else "warp"


def paged_launched(pa, before, build):
  """Asserts that exactly one launch, of ``build``, was counted since
  ``before``."""
  want = dict(before)
  want[build] += 1
  if build in pa.TILED_BUILDS.values():
    want["tiled"] += 1
  got = paged_counts(pa)
  assert got == want, (build, before, got)


def fp16_flash_parity(torch, fa):
  """The fp16 flash builds against their plain versions at phase 7's
  shapes, causal and not, by normalized error against
  ``FLASH_FP16_LIMIT`` (the forward, dK/dV and dQ on the wgmma builds at
  head dims 64 and 128, head dim 32 on the CUDA cores, each case's route
  printed beside it); then the limits' sensitivity.
  Returns the max abs error and the largest normalized errors per
  kernel."""
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
      routes = "/".join(fa.flash_route(k, torch.float16, shape["D"])
                        for k in ("fwd", "dkv", "dq"))
      log(f"   {label:14s} float16  causal={causal!s:5s} ({routes}) "
          f"max|kernel - plain| (rel_l2, max_rel): " + ", ".join(readings))
  log(f"   fp16 limits (rel_l2, max_rel): {FLASH_FP16_LIMIT}")
  flash_check_sensitivity(torch, fa, "float16")
  return errs, rel


def paged_parity_cases(torch, dtype, seed):
  """Paged-attention calls in ``dtype`` (q and pools; the mixed case
  rounds them after), each with the tile plan the engine would give it:
  ``engine_step`` at head dims 64 and 128, the scheduler's ``spec_step``
  and ``rollout_step`` (hd 64), and ``engine_step`` at head dim 32 (H =
  32), which the tiled build does not take."""
  cases = []
  for label, geo, at in (("engine_step", {}, seed),
                         ("engine_step_hd128", dict(H=8, hd=128), seed + 1),
                         ("engine_step_hd32", dict(H=32, hd=32), seed + 3)):
    args, runs = engine_step_case(torch, dtype, at, **geo)
    cases.append((label, args, runs, None))
  for kind in ("spec_step", "rollout_step"):
    for args, plan_pos, runs in scheduled_step_case(torch, dtype, seed + 2,
                                                    kind):
      cases.append((kind, args, runs, plan_pos))
  return cases


def fp16_paged_parity(torch, pa):
  """fp16 paged attention against its plain version at
  ``paged_parity_cases``: the tiled build at head dims 64 and 128 (over
  the engine's tile plan), the warp build at 32, each call counted on
  its build alone; by normalized error against ``PAGED_FP16_LIMIT``;
  then faults the limit must catch (a lost block of K/V rows, p rounded
  to bf16 instead of fp16).  Returns the max abs error and the largest
  normalized errors of the tiled build, and of the warp build."""
  cases = paged_parity_cases(torch, torch.float16, 31)
  err, rel = {}, {}
  for label, args, runs, plan_pos in cases:
    build = paged_build_of(pa, args[0], args[1])
    tiles = (paged_tiles(pa, args, runs, plan_pos) if build != "warp"
             else None)
    before = paged_counts(pa)
    got = pa.paged_attention(*args, tiles)
    want = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    paged_launched(pa, before, build)
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    e = (got.float() - want.float()).abs().max().item()
    r = normalized_errors(got, want)
    assert r[0] <= PAGED_FP16_LIMIT["rel_l2"] and (
        r[1] <= PAGED_FP16_LIMIT["max_rel"]), (label, r)
    key = "warp" if build == "warp" else "tiled"
    e0, r0 = err.get(key, 0.0), rel.get(key, (0.0, 0.0))
    err[key], rel[key] = max(e0, e), (max(r0[0], r[0]), max(r0[1], r[1]))
    log(f"   {label:18s} float16 {build:5s} max|kernel - plain| {e:.3e}, "
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
  and beside them the same kernels in bf16 on the same values, timed in
  turns (fp16, bf16, bf16, fp16); the tiled paged build at
  ``engine_step`` and ``spec_step`` over tiles planned before the timed
  window (gather + SDPA in fp16), in turns with the warp build it
  replaced (tiled, warp, tiled).  The bound counts fp16 bytes and the
  fp16 peak rate."""
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
  # The same kernels in bf16 on the same values, in turns with fp16.
  kernels = {"fwd": (fa.flash_fwd_cuda, fwd_args),
             "dkv": (fa.flash_bwd_dkv_cuda, bwd_args),
             "dq": (fa.flash_bwd_dq_cuda, bwd_args)}
  for name, (fn, args) in kernels.items():
    as_bf16 = [tuple(x.to(torch.bfloat16) if torch.is_tensor(x)
                     and x.dtype == torch.float16 else x for x in a)
               for a in args]
    turns = [time_ms(torch, fn, args), time_ms(torch, fn, as_bf16),
             time_ms(torch, fn, as_bf16), time_ms(torch, fn, args)]
    rows[name]["kernel_ms_turns"] = turns[0], turns[3]
    rows[name]["bf16_kernel_ms"] = (turns[1] + turns[2]) / 2
  for name, row in rows.items():
    row["bound_ms"], row["bound_by"] = bounds[name]
    log(f"   fp16 {name:4s} B=16 H=16 S=1024 D=64 causal: "
        + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in row.items() if k != "kernel_ms_turns")
        + f"; in turns fp16 {row['kernel_ms_turns'][0]:.4f} / "
        f"{row['kernel_ms_turns'][1]:.4f}, fp16 / bf16 "
        f"{row['kernel_ms'] / row['bf16_kernel_ms']:.2f}x")
  paged = {label: paged_timing_row(torch, pa, torch.float16, label,
                                   pa.paged_attention_warp_cuda)
           for label in ("engine_step", "spec_step")}
  return rows, paged


def paged_timing_row(torch, pa, dtype, label, warp_build, mixed=False):
  """One paged-attention timing row in ``dtype`` (fp16 q over bf16 pools
  when ``mixed``) at ``engine_step`` or ``spec_step``, four draws, tiles
  planned before the timed window: the dispatcher's (tiled) build in
  turns with ``warp_build`` (tiled, warp, tiled), the plain version,
  gather + SDPA (in fp32, the promoted type, when ``mixed``) and the
  bound."""
  seed = 500 if mixed else 400
  if label == "engine_step":
    cases = [engine_step_case(torch, dtype, seed + i) for i in range(4)]
  else:
    cases = [(args, runs) for i in range(4) for args, _, runs in
             scheduled_step_case(torch, dtype, seed + i, label)]
  if mixed:
    cases = [(mixed_case(torch, args), runs) for args, runs in cases]
  sets = [args for args, _ in cases]
  tiled_sets = [(*args, paged_tiles(pa, args, runs)) for args, runs in cases]
  assert all(paged_build_of(pa, a[0], a[1]) != "warp" for a in sets)
  bound, bound_by = paged_bound(
      torch, *[sets[0][i] for i in (0, 1, 3, 4)],
      out_itemsize=4 if mixed else None,
      ops_type="tfloat32" if mixed else None)
  lib_sets = ([tuple(x.float() if x.is_floating_point() else x for x in a)
               for a in sets] if mixed else sets)
  lib = lambda *a: library_paged_attention(torch, *a)  # noqa: E731
  row = dict(kernel_ms=time_ms(torch, pa.paged_attention_cuda, tiled_sets),
             warp_build_ms=time_ms(torch, warp_build, sets),
             kernel_ms_again=time_ms(torch, pa.paged_attention_cuda,
                                     tiled_sets),
             plain_ms=time_ms(torch, pa.paged_attention_reference, sets,
                              reps=3),
             library_ms=time_ms(torch, lib, lib_sets, reps=3),
             bound_ms=bound, bound_by=bound_by)
  log(f"   {'mixed' if mixed else 'fp16'} paged tiled {label:12s}: "
      + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                  for k, v in row.items()))
  return row


def amp_training(torch, fa, bench):
  """The bench's training step with an fp32 GPTConfig under
  ``amp.level=O1`` (bf16) against the explicit-bf16 config, full width
  at ``O1_LAYERS`` layers, ``O1_STEPS`` steps at batch 8 from the same
  weights and batch: equal
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
    cfg = bench.bench_config(torch.device("cuda"), dtype=dtype,
                             num_layers=O1_LAYERS)[0]
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


def o1_fp16_full_width(torch, fa, bench, params):
  """The O1-fp16 training path at bench.py's full width: its GPTConfig
  (24 layers, ``pallas_flash``, ``dots_flash``, ``loss_chunk`` 256) in
  fp32 under ``amp.level=O1`` fp16 with the dynamic loss scale, through
  the guarded step (``runtime.trainer``: scaled backward, unscale,
  ``found_inf`` into fused AdamW), batch ``O1_FULL_BATCH`` x 1024, on a
  copy of phase 1's ``init_params(seed=0)`` weights.  One warm-up step,
  then ``O1_FULL_STEPS`` timed with the host clock between
  synchronizes; every flash count is set to 0 just before the warm-up
  and read after the last step.  Its peak memory is counted above what
  the earlier phases left resident (as phase 10 measures training
  alone), beside the process's peak.  Holds: finite losses, every
  step's gradients finite, each kernel launched 24 times a step, no
  plain version called.  Returns the launch counts and the step's
  numbers."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.config import Config
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.models.gpt import (
      GPT, gpt_flops_per_token, gpt_loss)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel import (
      create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.runtime.trainer import (
      build_train_step, create_train_state)
  from easyparallellibrary_tpu_torch.utils import prng
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = bench.bench_config(torch.device("cuda"), dtype=torch.float32)[0]
  layers, seq = cfg.num_layers, cfg.max_seq_len
  gc.collect()
  torch.cuda.synchronize()
  resident = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  try:
    epl.init(Config({"amp.level": "O1", "amp.compute_dtype": "fp16",
                     "amp.loss_scale": "dynamic"}), device="cuda")
    with epl.replicate(1):
      model = GPT(cfg)
    mesh = epl.current_plan().build_mesh()
    weights = {k: v.clone() for k, v in params.items()}
    state, sh = create_sharded_train_state(
        lambda: create_train_state(model, weights,
                                   adamw(3e-4, weight_decay=0.01)), mesh)
    step = parallelize(build_train_step(
        lambda p, b, r: gpt_loss(model, p, b, r)), mesh, sh)
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (O1_FULL_BATCH, seq + 1))
    batch, rng = {"ids": torch.from_numpy(ids)}, prng.prng_key(0)
    fa.reset_counts()
    state, metrics = step(state, batch, rng)
    records = [metrics]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(O1_FULL_STEPS):
      state, metrics = step(state, batch, rng)
      records.append(metrics)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / O1_FULL_STEPS
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dkv": fa.flash_bwd_dkv_cuda.launches,
                "dq": fa.flash_bwd_dq_cuda.launches}
    plain = (fa.flash_fwd_reference.calls, fa.flash_bwd_dkv_reference.calls,
             fa.flash_bwd_dq_reference.calls)
    losses = [m["loss"].item() for m in records]
    finite = [m["grads_finite"].item() for m in records]
    scales = [m["loss_scale"].item() for m in records]
    peak = torch.cuda.max_memory_allocated()
  finally:
    Env.get().reset()
  steps = 1 + O1_FULL_STEPS
  tokens = O1_FULL_BATCH * seq
  mfu = gpt_flops_per_token(cfg, seq) * tokens / step_s / PEAK_OPS_PER_S[
      "float16"]
  log(f"   O1 fp16, {layers} layers, {O1_FULL_BATCH} x {seq}, dynamic loss "
      f"scale: step {step_s * 1e3:.2f} ms ({O1_FULL_STEPS} steps after 1 "
      f"warm-up), tokens/s {tokens / step_s:.1f}, MFU {mfu:.4f} of "
      f"{PEAK_OPS_PER_S['float16']:.3g} FLOP/s, peak memory "
      f"{(peak - resident) / 2 ** 30:.2f} GiB above the "
      f"{resident / 2 ** 30:.2f} GiB resident before it (process peak "
      f"{peak / 2 ** 30:.2f}); losses {losses}, gradients finite {finite}, "
      f"loss scale {scales}")
  log(f"   fp16 flash launches {launches} over {steps} steps x {layers} "
      f"layers; plain-version calls {plain}")
  assert all(np.isfinite(losses)), losses
  assert all(f == 1.0 for f in finite), finite
  assert all(n == layers * steps for n in launches.values()), launches
  assert plain == (0, 0, 0), plain
  del state, step, weights
  torch.cuda.empty_cache()
  return launches, dict(step_ms=step_s * 1e3, mfu=mfu,
                        peak_gib=(peak - resident) / 2 ** 30,
                        resident_gib=resident / 2 ** 30, losses=losses,
                        loss_scale=scales)


def fp16_serving(torch, params, pa):
  """A short O1-fp16 paged serving run at GPT-350M width: the model
  config in fp16 (the pools follow the model config's dtype, as in the
  JAX package) under ``amp.level=O1`` fp16, 8 requests; the tiled
  build's fp16 instantiation launched layers x steps times (the warp
  builds and the plain version never), streams against
  ``generate(use_cache=False)`` by the gap rule at fp16's spacing.
  Returns the tiled fp16 build's launches."""
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.config import Config
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  Env.get().reset(Config({"amp.level": "O1", "amp.compute_dtype": "fp16"}))
  try:
    cfg = GPTConfig(**GPT_SERVE, dtype=torch.float16)
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
    launches = pa.paged_attention_tiled_cuda.by_build["fp16"]
    assert launches == cfg.num_layers * eng.steps > 0, (launches, eng.steps)
    assert paged_counts(pa) == dict(
        paged_counts(pa), tiled=launches, fp16=launches, warp=0, mixed=0,
        bf16=0, fp16_bf16=0), paged_counts(pa)
    assert pa.paged_attention_reference.calls == 0
    log(f"   O1 fp16 paged serving: {len(prompts)} requests, {eng.steps} "
        f"steps; fp16 tiled-build launches {launches} = {cfg.num_layers} x "
        f"{eng.steps}, warp builds 0, plain version 0")
    greedy_vs_generate(torch, model, eng.params, prompts, out,
                       lambda top1: bf16_gap_limit(top1, 2.0 ** -10),
                       "O1 fp16 paged")
  finally:
    Env.get().reset()
  return launches


def mixed_case(torch, args):
  """A paged-attention case as the mixed build takes it: q in fp16 over
  bf16 pools (amp O1 in fp16 over a bf16 model config)."""
  q, kp, vp, tables, positions = args
  return (q.half(), kp.bfloat16(), vp.bfloat16(), tables, positions)


def mixed_paged_parity(torch, pa):
  """fp16 q over bf16 pools (fp32 out) against its plain version at
  ``paged_parity_cases`` (drawn in fp32, rounded to the two types): the
  tiled build's mixed instantiation at head dims 64 and 128 (over the
  engine's tile plan), the mixed warp build at 32, each call counted on
  its build alone; by normalized error against ``PAGED_MIXED_LIMIT``;
  then faults the limit must catch (a lost block of K rows, p rounded
  to bf16 instead of the query's fp16).  Returns the max abs error and
  the largest normalized errors of the tiled build, and of the warp
  build."""
  err, rel = {}, {}
  cases = [(label, mixed_case(torch, args), runs, plan_pos)
           for label, args, runs, plan_pos in
           paged_parity_cases(torch, torch.float32, 41)]
  for label, args, runs, plan_pos in cases:
    build = paged_build_of(pa, args[0], args[1])
    tiles = (paged_tiles(pa, args, runs, plan_pos) if build != "mixed"
             else None)
    before = paged_counts(pa)
    got = pa.paged_attention(*args, tiles)
    want = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    paged_launched(pa, before, build)
    assert got.dtype == want.dtype == torch.float32, label
    assert bool(torch.isfinite(got).all()), label
    e = (got - want).abs().max().item()
    r = normalized_errors(got, want)
    assert r[0] <= PAGED_MIXED_LIMIT["rel_l2"] and (
        r[1] <= PAGED_MIXED_LIMIT["max_rel"]), (label, r)
    key = "warp" if build == "mixed" else "tiled"
    e0, r0 = err.get(key, 0.0), rel.get(key, (0.0, 0.0))
    err[key], rel[key] = max(e0, e), (max(r0[0], r[0]), max(r0[1], r[1]))
    log(f"   {label:18s} fp16 q / bf16 pools, {build} build: max|kernel - "
        f"plain| {e:.3e}, rel_l2 {r[0]:.2e}, max_rel {r[1]:.2e}")
  q, kp, vp, tables, positions = cases[0][1]
  want = pa.paged_attention_reference(q, kp, vp, tables, positions)
  lost = kp.clone()
  lost[tables[0, 0].long()] = 0                   # slot 0's first block
  faults = {"a K block lost": pa.paged_attention_reference(
                q, lost, vp, tables, positions),
            "p rounded to bf16": paged_bf16_rounded_p(
                torch, q, kp, vp, tables, positions).float()}
  for name, faulty in faults.items():
    r = normalized_errors(faulty, want)
    caught = (r[0] > PAGED_MIXED_LIMIT["rel_l2"]
              or r[1] > PAGED_MIXED_LIMIT["max_rel"])
    log(f"   mixed paged fault {name:18s}: rel_l2 {r[0]:.2e}, max_rel "
        f"{r[1]:.2e} -> {'caught' if caught else 'not caught'}")
    assert caught, f"PAGED_MIXED_LIMIT misses '{name}'"
  log(f"   mixed paged limit (rel_l2, max_rel): {PAGED_MIXED_LIMIT}")
  return err, rel


def mixed_timing(torch, pa):
  """The tiled build's mixed instantiation beside the mixed warp build
  it replaced, its plain version, its bound (fp16 q and bf16 K/V read,
  fp32 written; tf32 products) and gather + SDPA in fp32, the promoted
  type, at ``engine_step`` and ``spec_step`` (``paged_timing_row``)."""
  return {label: paged_timing_row(torch, pa, torch.float32, label,
                                  pa.paged_attention_mixed_cuda, mixed=True)
          for label in ("engine_step", "spec_step")}


def mixed_serving(torch, params, pa):
  """A short O1-fp16 paged serving run over a bf16 model config at
  GPT-350M width, 8 requests: the pools stay bf16 (the model config's),
  the queries are fp16, so every attention call is the tiled build's
  mixed instantiation (counts set to 0 just before: layers x steps
  launches; the warp builds and the plain version never); streams
  against ``generate(use_cache=False)`` under the same config, by the
  gap rule at bf16's spacing (the pools round K/V to bf16, the reference
  keeps them in fp16).  Returns the tiled mixed build's launches."""
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.config import Config
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  Env.get().reset(Config({"amp.level": "O1", "amp.compute_dtype": "fp16"}))
  try:
    cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
    model = GPT(cfg)
    eng = ContinuousBatchingEngine(model, params, paged=True,
                                   num_slots=NUM_SLOTS,
                                   prefill_chunk=PREFILL_CHUNK,
                                   block_size=BLOCK_SIZE)
    assert eng.compute_dtype == torch.float16
    assert eng._kv["block_0"]["attn"]["cached_key"].dtype == torch.bfloat16
    prompts = make_prompts(8, NUM_SLOTS, cfg.vocab_size)
    pa.reset_counts()
    for i, p in enumerate(prompts):
      eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
    out = eng.run()
    torch.cuda.synchronize()
    launches = pa.paged_attention_tiled_cuda.by_build["fp16_bf16"]
    assert launches == cfg.num_layers * eng.steps > 0, (launches, eng.steps)
    assert pa.paged_attention_cuda.launches == launches
    assert paged_counts(pa) == dict(
        paged_counts(pa), tiled=launches, fp16_bf16=launches, warp=0,
        mixed=0, bf16=0, fp16=0), paged_counts(pa)
    assert pa.paged_attention_reference.calls == 0
    log(f"   O1 fp16 over bf16 pools, paged serving: {len(prompts)} "
        f"requests, {eng.steps} steps; tiled mixed-build launches "
        f"{launches} = {cfg.num_layers} x {eng.steps}, warp builds 0, plain "
        f"version 0")
    greedy_vs_generate(torch, model, eng.params, prompts, out,
                       bf16_gap_limit, "O1 fp16 over bf16 paged")
  finally:
    Env.get().reset()
  return launches


# --------------------------------------- phase 17: serving observability


OBS_DIR = ROOT / "chiprun_out" / "chip_smoke_observability"
OBS_RING = 1 << 20          # events: no wrap over phase 5's load
SYNC_WARNING = "synchroniz"  # torch.cuda.set_sync_debug_mode's warnings


def obs_config(tmp, serving=None, **slo):
  """Observability fully on: the tracer, the SLO monitor (events and
  diagnostic bundles under ``tmp``) and the device introspector;
  ``serving`` adds ``serving.*`` knobs."""
  from easyparallellibrary_tpu_torch.config import Config
  return Config({"serving": serving or {}, "observability": {
      "enabled": True, "ring_capacity": OBS_RING,
      "slo": dict({"enabled": True,
                   "events_path": str(tmp / "slo_events.jsonl"),
                   "capture_dir": str(tmp / "bundles"),
                   "capture_min_interval_s": 0.0}, **slo),
      "device": {"enabled": True}}})


def reset_observability():
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.observability import device, slo, trace
  for mod in (trace, slo, device):
    mod.reset()
  Env.get().reset()


def obs_run(torch, model, params, prompts, traced, tmp, tag):
  """Phase 5's staggered load through a paged engine with the n-gram
  drafter and the prefix cache, observability fully on (a registry with
  a JSONL sink) or off, under ``torch.cuda.set_sync_debug_mode("warn")``
  with its synchronising calls counted.  Returns the engine, its
  streams, host ms per step, the sync count and the JSONL path."""
  import warnings
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.observability.registry import (
      MetricRegistry)
  from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, NgramDrafter, Request)
  from easyparallellibrary_tpu_torch.utils.metrics_writer import (
      MetricsWriter)
  reset_observability()
  registry = metrics = None
  if traced:
    Env.get().reset(obs_config(tmp))
    metrics = tmp / f"metrics_{tag}.jsonl"
    registry = MetricRegistry(MetricsWriter(str(metrics)))
  eng = ContinuousBatchingEngine(
      model, params, paged=True, num_slots=NUM_SLOTS,
      prefill_chunk=PREFILL_CHUNK, block_size=BLOCK_SIZE,
      prefix_cache=True, drafter=NgramDrafter(k=SPEC_K),
      stats=ServingStats(), registry=registry)
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      t0 = time.monotonic()
      out = drive_waves(eng, Request, prompts)
      torch.cuda.synchronize()
      ms = (time.monotonic() - t0) / eng.steps * 1e3
    finally:
      torch.cuda.set_sync_debug_mode("default")
  syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
  if registry is not None:
    registry.close()
  # The step's own time (draft, device step and fetch, commit: the
  # ``step_time_s`` samples), beside the whole host ms per step.
  step_ms = eng.stats.busy_time_s / eng.steps * 1e3
  return eng, out, (ms, step_ms), syncs, metrics


def check_lifecycles(events, uids):
  """Every uid has a submit and a first-token instant and exactly one
  request span, holding at least one prefill span and one decode or
  speculate span on its slot's track."""
  from easyparallellibrary_tpu_torch.observability import report
  spans, unmatched = report.pair_spans(events)
  assert unmatched == 0, unmatched
  for uid in map(str, uids):
    kinds = [e["name"] for e in events if e["ph"] == "i"
             and (e.get("args") or {}).get("uid") == uid]
    assert kinds.count("serving/submit") == 1, (uid, kinds)
    assert kinds.count("serving/first_token") == 1, (uid, kinds)
    (req,) = [sp for sp in spans if sp["cat"] == "serving.request"
              and sp["args"].get("uid") == uid]
    inner = {sp["name"] for sp in spans
             if (sp["pid"], sp["tid"]) == (req["pid"], req["tid"])
             and req["ts"] <= sp["ts"]
             and sp["ts"] + sp["dur"] <= req["ts"] + req["dur"]}
    assert "prefill" in inner and inner & {"decode", "speculate"}, (
        uid, inner)


def observability_serving(torch, params, pa):
  """Phase 17: the paged engine (n-gram drafter, prefix cache) at
  GPT-350M width in bf16 under phase 5's staggered load, observability
  fully on against off.  Returns the readings for the log."""
  import shutil
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.observability import (
      device as device_lib, trace as trace_lib)
  shutil.rmtree(OBS_DIR, ignore_errors=True)
  OBS_DIR.mkdir(parents=True)
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
  model = GPT(cfg)
  prompts = make_prompts(2, 16, cfg.vocab_size)
  # Host ms per step and synchronising calls in two rounds of ABBA
  # turns (untraced, traced, traced, untraced; then the other way
  # round) after an untraced warm-up run (the process's first run of
  # this load makes one more synchronising call and runs slower); the
  # first traced run is the one checked.
  runs = {False: [], True: []}
  for turn, traced in enumerate((None, False, True, True, False,
                                 True, False, False, True)):
    tmp = OBS_DIR / f"turn{turn}"
    tmp.mkdir()
    if traced is None:
      obs_run(torch, model, params, prompts, False, tmp, "warm-up")
      continue
    if traced and not runs[True]:
      pa.reset_counts()
    eng, out, ms, syncs, metrics = obs_run(torch, model, params, prompts,
                                           traced, tmp, f"turn{turn}")
    if traced and not runs[True]:
      launches = pa.paged_attention_tiled_cuda.launches
      assert launches == cfg.num_layers * eng.steps, (launches, eng.steps)
      assert pa.paged_attention_reference.calls == 0
      main = dict(eng=eng, out=out, tmp=tmp, metrics=metrics,
                  tracer=trace_lib.get_tracer(),
                  intro=device_lib.get_introspector(),
                  latest=eng.registry.latest())
    runs[traced].append(dict(out=out, ms=ms[0], step_ms=ms[1], syncs=syncs,
                             steps=eng.steps))
  base = runs[False][0]
  for run in runs[True] + runs[False][1:]:
    assert run["steps"] == base["steps"], (run["steps"], base["steps"])
    for i in range(len(prompts)):
      np.testing.assert_array_equal(run["out"][i], base["out"][i],
                                    f"stream {i}")
  ms = {k: [r["ms"] for r in v] for k, v in runs.items()}
  step_ms = {k: [r["step_ms"] for r in v] for k, v in runs.items()}
  syncs = {k: [r["syncs"] for r in v] for k, v in runs.items()}
  log(f"   streams of all eight runs token-equal ({len(prompts)} requests, "
      f"{base['steps']} steps each)")
  for label, vals in (("host ms/step", ms), ("step_time_s ms", step_ms)):
    log(f"   {label} in turns (U T T U T U U T): untraced "
        + ", ".join(f"{v:.2f}" for v in vals[False]) + "; traced "
        + ", ".join(f"{v:.2f}" for v in vals[True])
        + f" (medians {statistics.median(vals[False]):.2f} untraced, "
        f"{statistics.median(vals[True]):.2f} traced)")
  log(f"   synchronising calls per run: untraced {syncs[False]}, traced "
      f"{syncs[True]} ({syncs[False][0] / base['steps']:.2f} a step)")
  assert len(set(syncs[False] + syncs[True])) == 1, syncs
  eng, tmp = main["eng"], main["tmp"]
  tracer = main["tracer"]
  path = tracer.export(str(tmp / "trace.json"))
  events = trace_lib.validate_trace(path)
  check_lifecycles(events, range(len(prompts)))
  log(f"   trace: {os.path.getsize(path)} bytes, {len(events)} events, "
      f"ring dropped {tracer.dropped}; validate_trace passes; 16 complete "
      f"request lifecycles")
  assert tracer.dropped == 0
  report = subprocess.run(
      [sys.executable, "-m", "easyparallellibrary_tpu_torch.observability."
       "report", path], capture_output=True, text=True, timeout=300,
      check=True, cwd=str(ROOT)).stdout
  assert "serving/device_step" in report and "speculate" in report, report
  log("   report CLI:\n" + "\n".join(
      "     " + line for line in report.splitlines()[:14]))
  with open(main["metrics"]) as f:
    records = [json.loads(line) for line in f]
  per_step = [r["step"] for r in records if "serving/step_time_s" in r]
  assert per_step == list(range(1, eng.steps + 1)), per_step[:5]
  gauges = {k.rsplit("/", 1)[-1]: v for k, v in main["latest"].items()
            if k.startswith("observability/device/")}
  card = main["intro"].card("serving/fused_step")
  param_bytes = sum(p.numel() * p.element_size()
                    for p in eng.params.values())
  pool_bytes = sum(x.numel() * x.element_size() for x in eng._kv_leaves())
  log(f"   HBM gauges: {gauges}")
  log(f"   cost card: {card.summary()}")
  assert 0 < gauges["hbm_frac"] < 1, gauges
  assert gauges["hbm_bytes_in_use"] >= param_bytes + pool_bytes, gauges
  assert card.donation_requested and card.donation_verified
  assert card.argument_bytes == param_bytes + pool_bytes
  assert eng._compile_sentinel.recompiles == 0
  itl_p50 = eng.stats.summary()["itl_p50_s"]
  slo_checks(torch, model, params, prompts, itl_p50)
  contiguous_traced(torch, params)
  reset_observability()
  return dict(ms=ms, step_ms=step_ms, syncs=syncs,
              trace_bytes=os.path.getsize(path),
              events=len(events), gauges=gauges, card=card.summary())


def slo_checks(torch, model, params, prompts, itl_p50):
  """An ITL rule set at half the measured ITL p50 breaches at the run's
  rollup, and its diagnostic bundle holds the engine's context and the
  device gauges.  A hanging step (``HangingStepInjector``, 1.0 s against
  a 0.5 s watchdog deadline) is a breach attributed to this engine's
  twin: with ``slo.capture_xla`` its bundle holds a ``torch.profiler``
  trace of the next step, whose CUDA kernels include the paged kernel."""
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.observability import slo as slo_lib
  from easyparallellibrary_tpu_torch.observability.registry import (
      MetricRegistry)
  from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.chaos import HangingStepInjector
  tmp = OBS_DIR / "slo"
  tmp.mkdir()
  reset_observability()
  Env.get().reset(obs_config(tmp, serving={"resilience": {
      "enabled": True, "step_timeout_s": 0.5}}, capture_xla=True))
  monitor = slo_lib.install(slo_lib.SLOMonitor(
      [slo_lib.SLORule("itl_p50", "itl_p50_s", "<=", itl_p50 / 2)],
      events_path=str(tmp / "slo_events.jsonl"),
      capture=slo_lib.DiagnosticCapture(str(tmp / "bundles"),
                                        min_interval_s=0.0)))
  eng = ContinuousBatchingEngine(
      model, params, paged=True, num_slots=NUM_SLOTS,
      prefill_chunk=PREFILL_CHUNK, block_size=BLOCK_SIZE,
      stats=ServingStats(), registry=MetricRegistry())
  inj = HangingStepInjector(eng, hang_calls=(4,), hang_s=1.0)
  for i, p in enumerate(prompts[:NUM_SLOTS]):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
  eng.run()
  eng.close()
  assert inj.hangs == 1
  by_rule = {e["rule"]: e for e in monitor.events if e["event"] == "breach"}
  assert {"itl_p50", "watchdog_timeout"} <= set(by_rule), monitor.events
  with open(os.path.join(by_rule["itl_p50"]["bundle"], "state.json")) as f:
    state = json.load(f)
  assert state["serving"]["engine_steps"] == eng.steps, state["serving"]
  assert state["device"]["hbm"]["hbm_source"] == "memory_stats", state
  hang = by_rule["watchdog_timeout"]
  assert hang["twin"] == eng._twin_label
  prof_path = os.path.join(hang["bundle"], "device", "device_trace.json")
  with open(prof_path) as f:
    kernels = {e["name"] for e in json.load(f)["traceEvents"]
               if e.get("cat") == "kernel"}
  paged = sorted(k for k in kernels if "paged_attention" in k)
  assert paged, sorted(kernels)[:20]
  log(f"   SLO: itl_p50 rule at {itl_p50 / 2 * 1e3:.2f} ms breached "
      f"(value {by_rule['itl_p50']['value'] * 1e3:.2f} ms); its bundle "
      f"holds the engine's context and HBM gauges; the watchdog breach "
      f"(twin {hang['twin']}) armed a torch.profiler trace of the next "
      f"step ({os.path.getsize(prof_path)} bytes, {len(kernels)} CUDA "
      f"kernel names, paged: {paged[0][:60]})")
  os.remove(prof_path)          # bulky; the check above is its record


def contiguous_traced(torch, params):
  """A short traced run of the contiguous engine (8 requests): the trace
  validates and every slot's request lifecycle is complete."""
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.observability import trace as trace_lib
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  tmp = OBS_DIR / "contiguous"
  tmp.mkdir()
  reset_observability()
  Env.get().reset(obs_config(tmp))
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
  eng = ContinuousBatchingEngine(GPT(cfg), params, paged=False,
                                 num_slots=NUM_SLOTS,
                                 prefill_chunk=PREFILL_CHUNK)
  prompts = make_prompts(9, NUM_SLOTS, cfg.vocab_size)
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
  eng.run()
  events = trace_lib.validate_trace(
      trace_lib.get_tracer().export(str(tmp / "trace.json")))
  check_lifecycles(events, range(len(prompts)))
  log(f"   contiguous engine traced: {eng.steps} steps, {len(events)} "
      f"events, validate_trace passes, {len(prompts)} complete request "
      f"lifecycles")


# --------------------------------------- phase 18: the training runtime


def _record_batches(reader, batch_size):
  """Token records (int32, seq + 1 each) -> ``{"ids", "weight"}``
  batches; ``weight`` is a per-sequence loss weight (ones; the phase's
  loss multiplies by its mean), the float leaf a NaN fault poisons."""
  rows = []
  for rec in reader:
    rows.append(np.frombuffer(rec, np.int32))
    if len(rows) == batch_size:
      yield {"ids": np.stack(rows),
             "weight": np.ones(batch_size, np.float32)}
      rows = []


def _poison(torch, batch):
  """A device batch with its loss weight NaN (``chaos.nan_batch`` on the
  float leaf; the token ids stay)."""
  return dict(batch, weight=torch.full_like(batch["weight"], float("nan")))


def _snapshot(torch, state):
  """Parameters, both moments and every per-parameter step, cloned."""
  out = {}
  for name, p in state.params.items():
    st = state.opt_state.state.get(p, {})
    out[name] = [p.detach().clone()] + [
        st[k].detach().clone() for k in ("exp_avg", "exp_avg_sq", "step")
        if k in st]
  return out


def _same(torch, a, b):
  """Whether two snapshots are bit-identical, leaf by leaf."""
  return a.keys() == b.keys() and all(
      len(a[n]) == len(b[n]) and all(torch.equal(x, y)
                                     for x, y in zip(a[n], b[n]))
      for n in a)


class _Timed:
  """Wrap a module function: count its calls and their seconds."""

  def __init__(self, module, name):
    self.module, self.name = module, name
    self.fn = getattr(module, name)
    self.seconds, self.args = [], []
    setattr(module, name, self)

  def __call__(self, *args, **kw):
    t0 = time.monotonic()
    out = self.fn(*args, **kw)
    self.seconds.append(time.monotonic() - t0)
    self.args.append(kw.get("step", kw.get("after_step")))
    return out

  def undo(self):
    setattr(self.module, self.name, self.fn)


class _NoSync:
  """``torch.cuda.set_sync_debug_mode("error")`` over the body: any host
  sync in it raises (nothing on the CPU)."""

  def __init__(self, torch, device):
    self.torch, self.on = torch, torch.device(device).type == "cuda"

  def __enter__(self):
    if self.on:
      self.torch.cuda.set_sync_debug_mode("error")

  def __exit__(self, *exc):
    if self.on:
      self.torch.cuda.set_sync_debug_mode(0)
    return False


def training_runtime(torch, fa, pa, bench, device="cuda", widths=None,
                     batch_size=None, records=None):
  """Phase 18: ``fit()`` around ``bench.py``'s configuration (bf16 over
  fp32, flash, ``dots_flash``, ``loss_chunk`` 256, batch 16 x 1024) at
  full width, fed from token records by ``RecordReader(use_native=True)``
  and ``DevicePrefetcher``, with the anomaly sentinel on
  (``resilience.max_bad_steps``): (a) 10 steps with a checkpoint every
  10; (b) a fresh state resuming at step 10 over the same dir, held to
  the uninterrupted run; (c) a two-step NaN window skipped bit for bit
  with no host sync, then a persistent fault rolled back; (d) gradient
  accumulation and the grouped apply; (e) dropout; (f) serving from the
  checkpoint.  The loss is ``gpt_loss`` times the batch's ``weight``
  leaf (1.0; NaN where a fault is injected).  Returns the flash launch
  counts of (a)."""
  import shutil
  import tempfile
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.io import (
      DevicePrefetcher, RecordReader, write_records)
  from easyparallellibrary_tpu_torch.models.gpt import (
      GPT, GPTConfig, gpt_flops_per_token, gpt_loss)
  from easyparallellibrary_tpu_torch.ops.adamw import (
      adam_weight_decay_optimizer)
  from easyparallellibrary_tpu_torch.parallel import (
      create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.profiler.profiler import StepProfiler
  from easyparallellibrary_tpu_torch.runtime import saver
  from easyparallellibrary_tpu_torch.runtime.loop import fit
  from easyparallellibrary_tpu_torch.runtime.trainer import (
      build_train_step, create_train_state)
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, DraftModelDrafter, Request)
  from easyparallellibrary_tpu_torch.testing.chaos import NaNInjector
  from easyparallellibrary_tpu_torch.utils import prng
  from easyparallellibrary_tpu_torch.weights import init_params

  widths = widths or GPT_350M
  B, S, L = batch_size or RT_BATCH, widths["max_seq_len"], \
      widths["num_layers"]
  n_records = records or RT_RECORDS
  cfg = bench.bench_config(torch.device(device), **widths)[0]
  on_gpu = torch.device(device).type == "cuda"

  def sync():
    if on_gpu:
      torch.cuda.synchronize()

  tmp = tempfile.mkdtemp(prefix="epl_phase18_")
  ckpt = os.path.join(tmp, "ckpt")
  config = epl.Config({"resilience": {"max_bad_steps": RT_MAX_BAD,
                                      "keep_last": 1,
                                      "rollback_lr_backoff": 0.5}})
  epl.init(config, device=device)
  with epl.replicate(1):
    model = GPT(cfg)
  mesh = epl.current_plan().build_mesh()
  tx = adam_weight_decay_optimizer(3e-4)
  params0 = init_params(cfg, seed=0, device=device)

  def loss_fn(p, batch, rng):
    loss, aux = gpt_loss(model, p, batch, rng)
    return loss * batch["weight"].mean(), aux

  def new_state():
    state, sh = create_sharded_train_state(
        lambda: create_train_state(model, params0, tx), mesh)
    return state, sh

  # Records: int32 token ids of S + 1 per record, n_records of them in
  # two files.
  r = np.random.RandomState(18)
  files = []
  for i in range(2):
    path = os.path.join(tmp, f"tokens_{i}.rec")
    write_records(path, [r.randint(0, cfg.vocab_size, S + 1)
                         .astype(np.int32).tobytes()
                         for _ in range(n_records // 2)], use_native=True)
    files.append(path)
  starts = []

  def data(start_step=0):
    starts.append(start_step)
    reader = RecordReader(files, use_native=True,
                          skip_records=(start_step * B) % n_records)
    assert reader._native
    return DevicePrefetcher(_record_batches(reader, B), mesh)

  losses = {}

  def recorded(step_fn, key):
    def run(state, batch, rng):
      state, metrics = step_fn(state, batch, rng)
      losses.setdefault(key, []).append(metrics["loss"].detach())
      return state, metrics
    return run

  saves = _Timed(saver, "save_checkpoint")
  restores = _Timed(saver, "restore_train_state")
  try:
    # (a) fit from records, checkpoints every 10 steps.
    state, sh = new_state()
    step = parallelize(build_train_step(loss_fn), mesh, sh)
    prof = StepProfiler(flops_per_step=gpt_flops_per_token(cfg, S) * B * S,
                        tokens_per_step=B * S, warmup=2)
    fa.reset_counts()
    t0 = time.monotonic()
    state, metrics = fit(recorded(step, "a"), state, data,
                         num_steps=RT_STEPS, checkpoint_dir=ckpt,
                         checkpoint_every=10, log_every=0, profiler=prof,
                         device=device)
    sync()
    wall = time.monotonic() - t0
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dkv": fa.flash_bwd_dkv_cuda.launches,
                "dq": fa.flash_bwd_dq_cuda.launches}
    plain = (fa.flash_fwd_reference.calls, fa.flash_bwd_dkv_reference.calls,
             fa.flash_bwd_dq_reference.calls)
    assert int(state.step) == RT_STEPS
    if on_gpu:
      assert all(n == L * RT_STEPS for n in launches.values()), launches
      assert plain == (0, 0, 0), plain
    la = torch.stack(losses["a"]).float().cpu().numpy()
    assert np.isfinite(la).all(), la
    summary = prof.summary()
    med = statistics.median(prof.times)
    flops = gpt_flops_per_token(cfg, S) * B * S
    from easyparallellibrary_tpu_torch.profiler.flops import estimate_mfu
    mfu = (f"{summary['mfu']:.4f}", f"{estimate_mfu(flops, med):.4f}") \
        if on_gpu else ("not measured",) * 2
    log(f"   (a) {RT_STEPS} steps in {wall:.2f} s wall; StepProfiler mean "
        f"(the checkpointing steps included): step "
        f"{summary['step_time_s'] * 1e3:.1f} ms, tokens/s "
        f"{summary['tokens_per_sec']:.1f}, MFU {mfu[0]}; median step "
        f"{med * 1e3:.1f} ms, tokens/s {B * S / med:.1f}, MFU {mfu[1]}")
    log(f"   (a) loss {la[0]:.4f} -> {la[-1]:.4f}; flash launches "
        f"{launches} = {L} layers x {RT_STEPS} steps; plain-version calls "
        f"{plain}; records read natively from {len(files)} files, "
        f"prefetcher depth {epl.Env.get().config.io.prefetch}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(ckpt) for f in fs
                     if f.endswith(".npz"))
    log(f"   (a) saves at steps {saves.args}: "
        + ", ".join(f"{s:.2f} s" for s in saves.seconds)
        + f" for {ckpt_bytes / 1e9:.3f} GB (params + mu + nu, fp32; "
        f"{ckpt_bytes / 1e9 / saves.seconds[-1]:.2f} GB/s; "
        f"{saver._IO_WORKERS} IO threads, {os.cpu_count()} host cores)")
    assert saves.args == list(range(10, RT_STEPS + 1, 10)), saves.args
    assert saver.latest_step(ckpt) == RT_STEPS
    assert sorted(os.listdir(ckpt)) == ["metrics.jsonl",
                                        f"step_{RT_STEPS:08d}"]

    # (b) resume: a fresh state over the same dir restores step
    # RT_STEPS, the data factory is told start_step=RT_STEPS; the steps
    # up to RT_RESUME_STEPS against the live state continuing
    # uninterrupted.
    live = _snapshot(torch, state)
    fresh, sh_b = new_state()
    checked = []

    def first_call_check(step_fn):
      def run(st, batch, rng):
        if not checked:
          checked.append(_same(torch, _snapshot(torch, st), live))
        return step_fn(st, batch, rng)
      return run

    del starts[:]
    step_b = parallelize(build_train_step(loss_fn), mesh, sh_b)
    fresh, _ = fit(recorded(first_call_check(step_b), "b"), fresh, data,
                   num_steps=RT_RESUME_STEPS, checkpoint_dir=ckpt,
                   checkpoint_every=10, log_every=0, device=device)
    assert checked == [True], checked
    assert starts[0] == RT_STEPS, starts
    assert int(fresh.step) == RT_RESUME_STEPS
    restore_s = restores.seconds[-1]
    state, _ = fit(recorded(step, "uninterrupted"), state, data,
                   num_steps=RT_RESUME_STEPS, log_every=0, device=device)
    lb = torch.stack(losses["b"]).float().cpu().numpy()
    lu = torch.stack(losses["uninterrupted"]).float().cpu().numpy()
    equal = np.array_equal(lb, lu)
    diff = float(np.max(np.abs(lb - lu)))
    log(f"   (b) restore of step {RT_STEPS}: {restore_s:.2f} s "
        f"({ckpt_bytes / 1e9 / restore_s:.2f} GB/s, checksums included); "
        f"restored params, moments and steps bit-equal to the live state: "
        f"{checked[0]}; data factory start_step {starts[0]}")
    log(f"   (b) steps {RT_STEPS + 1}-{RT_RESUME_STEPS} resumed against "
        f"uninterrupted: equal loss for loss {equal}, max |diff| "
        f"{diff:.3e} (limit {RT_RESUME_RTOL} relative)")
    np.testing.assert_allclose(lb, lu, rtol=RT_RESUME_RTOL)
    assert _same(torch, _snapshot(torch, fresh), _snapshot(torch, state)) \
        or not equal
    del fresh, live
    gc.collect()

    # (c) the sentinel: a two-step NaN window through the guarded step
    # under sync-debug "error" (a host sync raises), then a clean step,
    # then a persistent fault inside fit, rolled back.
    it = data(0)
    batches = [next(it) for _ in range(3)]
    del it
    poisoned = [_poison(torch, b) for b in batches[:2]]
    keys = [prng.host_fold_in(prng.prng_key(0), i) for i in range(3)]
    sync()
    before = _snapshot(torch, state)
    step_before = torch.as_tensor(state.step).clone()
    bad_before = int(state.sentinel.bad_total)
    with _NoSync(torch, device):
      for b, k in zip(poisoned, keys):
        state, skipped = step(state, b, k)
    window_noop = _same(torch, _snapshot(torch, state), before) and \
        torch.equal(torch.as_tensor(state.step), step_before)
    counts = (int(skipped["bad_steps"]), int(skipped["bad_steps_total"]),
              float(skipped["update_skipped"]))
    with _NoSync(torch, device):
      state, clean = step(state, batches[2], keys[2])
    moved = not _same(torch, _snapshot(torch, state), before)
    log(f"   (c) 2 NaN steps then 1 clean step "
        + ("under set_sync_debug_mode('error'): no host sync"
           if on_gpu else "(the sync check needs the card)")
        + f"; the NaN window left "
        f"params, both moments, every parameter's step and "
        f"TrainState.step bit-identical: {window_noop}; bad_steps "
        f"{counts[0]} then {int(clean['bad_steps'])}, bad_steps_total "
        f"{bad_before} -> {int(clean['bad_steps_total'])}, TrainState.step "
        f"{int(step_before)} -> {int(state.step)}, the clean step moved "
        f"the state: {moved}")
    assert window_noop and moved
    assert counts == (2, bad_before + 2, 1.0), counts
    assert int(clean["bad_steps"]) == 0
    assert int(state.step) == int(step_before) + 1
    del before

    # Persistent fault: the max_bad_steps steps ending at a window
    # boundary are poisoned on their first draw; fit rolls back to the
    # newest checkpoint with the learning rate halved and replays clean.
    n_restores = len(restores.seconds)
    base = int(state.step)
    total0 = int(state.sentinel.bad_total)
    assert saver.latest_step(ckpt) == RT_RESUME_STEPS
    end = next(e for e in range(base + RT_MAX_BAD, base + 3 * RT_MAX_BAD)
               if (e + 1) % RT_MAX_BAD == 0)
    bad = tuple(range(end - RT_MAX_BAD + 1, end + 1))
    inj = NaNInjector(lambda s: next(iter(data(s))), bad_steps=bad,
                      num_steps=base + 10,
                      poison=lambda b: _poison(torch, b))
    prof_c = StepProfiler(warmup=0)
    lr0 = [g["lr"] for g in state.opt_state.param_groups]
    state, metrics = fit(step, state, inj, num_steps=base + 10,
                         checkpoint_dir=ckpt, log_every=0, profiler=prof_c,
                         device=device)
    rolled = restores.args[n_restores:]
    lr1 = [g["lr"] for g in state.opt_state.param_groups]
    log(f"   (c) persistent fault at steps {list(bad)}: poisoned "
        f"{inj.poisoned}; restore calls {rolled} (start of fit, then the "
        f"rollback to step {RT_RESUME_STEPS}: "
        f"{restores.seconds[-1]:.2f} s); bad steps counted "
        f"{prof_c.bad_steps - total0}; lr {lr0[0]:g} -> {lr1[0]:g}; "
        f"TrainState.step {int(state.step)}, last loss "
        f"{float(metrics['loss']):.4f}")
    assert inj.poisoned == list(bad), inj.poisoned
    assert rolled == [base, None], rolled
    assert prof_c.bad_steps == total0 + RT_MAX_BAD, prof_c.bad_steps
    assert all(b == a * 0.5 for a, b in zip(lr0, lr1)), (lr0, lr1)
    assert int(state.step) == base + 10
    assert np.isfinite(float(metrics["loss"]))

    # (d) accumulation and the grouped apply, one step each from the
    # same start on the same batch.
    batch = batches[0]
    key = keys[0]
    result = {}
    for label, overrides in (("plain", {}),
                             ("micro_batch_2", {"pipeline.num_micro_batch":
                                                2}),
                             ("apply_group_4", {"optimizer.num_apply_group":
                                                4})):
      c = epl.Config({"resilience.max_bad_steps": RT_MAX_BAD, **overrides})
      st, shd = create_sharded_train_state(
          lambda: create_train_state(model, params0, tx, config=c), mesh)
      stp = parallelize(build_train_step(loss_fn, config=c), mesh, shd)
      st, m = stp(st, batch, key)
      result[label] = (float(m["loss"]),
                       {n: p.detach().clone() for n, p in st.params.items()}
                       if label != "micro_batch_2" else None)
      del st, stp
    grouped_equal = all(torch.equal(result["plain"][1][n],
                                    result["apply_group_4"][1][n])
                        for n in result["plain"][1])
    lp, lg = result["plain"][0], result["micro_batch_2"][0]
    log(f"   (d) one step: loss {lp:.6f} plain, {lg:.6f} with "
        f"pipeline.num_micro_batch=2 (rel diff {abs(lg - lp) / lp:.2e}); "
        f"optimizer.num_apply_group=4 params bit-equal to one group: "
        f"{grouped_equal}")
    assert grouped_equal
    assert abs(lg - lp) / lp < 1e-2
    del result
    gc.collect()

    # (e) dropout 0.1: two steps, and the masks' drop rate.
    import dataclasses
    dcfg = dataclasses.replace(cfg, dropout_rate=RT_DROPOUT)
    dmodel = GPT(dcfg)
    st, shd = create_sharded_train_state(
        lambda: create_train_state(dmodel, params0, tx), mesh)

    def dloss(p, b, rng):
      loss, aux = gpt_loss(dmodel, p, b, rng)
      return loss * b["weight"].mean(), aux

    stp = parallelize(build_train_step(dloss), mesh, shd)
    dl = []
    for i in range(2):
      st, m = stp(st, batches[i], keys[i])
      dl.append(float(m["loss"]))
    keep = prng.keep_mask(keys[0], (B, S, cfg.d_model), RT_DROPOUT, device)
    n = keep.numel()
    rate = 1.0 - float(keep.float().mean())
    sigma = (RT_DROPOUT * (1 - RT_DROPOUT) / n) ** 0.5
    log(f"   (e) dropout {RT_DROPOUT}: losses {dl[0]:.4f}, {dl[1]:.4f} "
        f"(plain step {lp:.4f}); drop rate of one [{B}, {S}, "
        f"{cfg.d_model}] mask {rate:.6f}, |rate - {RT_DROPOUT}| = "
        f"{abs(rate - RT_DROPOUT) / sigma:.2f} sigma (limit 3)")
    assert all(np.isfinite(dl)) and dl[0] != lp
    assert abs(rate - RT_DROPOUT) < 3 * sigma
    del st, stp, keep, state, step, batches, poisoned
    gc.collect()
    if on_gpu:
      torch.cuda.empty_cache()

    # (f) serve from the checkpoint: a self-draft paged run of 8
    # requests through DraftModelDrafter.from_checkpoint.
    scfg = GPTConfig(**widths, dtype=torch.bfloat16)
    smodel = GPT(scfg)
    t0 = time.monotonic()
    drafter = DraftModelDrafter.from_checkpoint(ckpt, smodel, k=SPEC_K,
                                                device=device)
    load_s = time.monotonic() - t0
    target, rstep = saver.restore_params(ckpt, device=device)
    assert rstep == RT_RESUME_STEPS
    assert all(torch.equal(target[n].float(), drafter.params[n].float())
               for n in target)
    eng = ContinuousBatchingEngine(smodel, target, paged=True,
                                   device=device, num_slots=NUM_SLOTS,
                                   prefill_chunk=PREFILL_CHUNK,
                                   block_size=BLOCK_SIZE, drafter=drafter)
    prompts = [p[:S // 4] for p in make_prompts(18, 8, scfg.vocab_size)]
    pa.reset_counts()
    for i, p in enumerate(prompts):
      eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
    out = eng.run()
    sync()
    paged = pa.paged_attention_cuda.launches
    assert sorted(out) == list(range(8))
    for i, p in enumerate(prompts):
      assert out[i].shape == (len(p) + 16,)
      assert eng.finished[i].finish_reason == "length"
    assert (paged > 0 and pa.paged_attention_reference.calls == 0) \
        or not on_gpu
    assert eng.drafter_failures == 0
    log(f"   (f) from_checkpoint (step {rstep}) {load_s:.2f} s; 8 requests "
        f"served self-draft in {eng.steps} steps, drafter rollout steps "
        f"{drafter.rollout_steps}; paged_attention launches {paged} "
        f"(tiled {pa.paged_attention_tiled_cuda.launches}), plain-version "
        f"calls 0")
    del eng, drafter, target
  finally:
    saves.undo()
    restores.undo()
    shutil.rmtree(tmp, ignore_errors=True)
  log(f"   removed {tmp}")
  return launches, paged


# ----------------------------- phases 18g-18h: host offload and DCP


OFFLOAD_WARMUP, OFFLOAD_STEPS = 2, 6


def _state_fingerprint(torch, state):
  """``{(name, leaf): (sum, position-weighted sum)}`` of the bits of
  every parameter and both AdamW moments, summed as int64 on the card
  (wrapping, so independent of the order of the sum): equal
  fingerprints of two runs mean their states agree bit for bit, up to a
  collision no stray moment stream would hit."""
  opt = state.opt_state
  out = {}
  for name, p in state.params.items():
    for leaf, t in (("param", p), ("exp_avg", opt.state[p]["exp_avg"]),
                    ("exp_avg_sq", opt.state[p]["exp_avg_sq"])):
      bits = t.detach().to("cuda").contiguous().view(
          {2: torch.int16, 4: torch.int32}[t.element_size()])
      bits = bits.reshape(-1).to(torch.int64)
      w = torch.arange(bits.numel(), device="cuda") % 65521 + 1
      out[(name, leaf)] = (int(bits.sum()), int((bits * w).sum()))
      del bits, w
  return out


def offload_training(torch, fa, bench):
  """Phase 18g: ``bench.py``'s configuration at RT_LAYERS layers (bf16
  over fp32 params, batch 16 x 1024) through ``bench.build_training``
  without and
  with ``offload.level = "v0"``: the moments pinned on the host, the
  losses loss for loss and the final params and moments bit-equal
  (fingerprints of their bits), the peak HBM (``max_memory_allocated`` from
  before the state is built) and the median step ms both ways, the
  flash launches of the offloaded run (layers x steps), and a native
  save/restore of the offloaded state bit-equal.  Returns the offloaded
  state, its flash launches and the native save and restore seconds."""
  import tempfile
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.runtime import saver
  from easyparallellibrary_tpu_torch.runtime.offload import (
      HostOffloadOptimizer)
  cfg = bench.bench_config(torch.device("cuda"), num_layers=RT_LAYERS)[0]
  B, L = RT_BATCH, cfg.num_layers
  runs = {}
  for level in ("", "v0"):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, batch, rng, _ = bench.build_training(
        cfg, B, "cuda", config=epl.Config({"offload.level": level}))
    assert isinstance(state.opt_state, HostOffloadOptimizer) == bool(level)
    fa.reset_counts()
    losses, times = [], []
    for i in range(OFFLOAD_WARMUP + OFFLOAD_STEPS):
      torch.cuda.synchronize()
      t0 = time.monotonic()
      state, m = step(state, batch, rng)
      torch.cuda.synchronize()
      times.append(time.monotonic() - t0)
      losses.append(m["loss"].detach())
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dkv": fa.flash_bwd_dkv_cuda.launches,
                "dq": fa.flash_bwd_dq_cuda.launches}
    n = OFFLOAD_WARMUP + OFFLOAD_STEPS
    assert all(v == L * n for v in launches.values()), launches
    assert (fa.flash_fwd_reference.calls, fa.flash_bwd_dkv_reference.calls,
            fa.flash_bwd_dq_reference.calls) == (0, 0, 0)
    runs[level] = dict(
        losses=torch.stack(losses).float().cpu().numpy(),
        ms=statistics.median(times[OFFLOAD_WARMUP:]) * 1e3,
        peak=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
        fingerprint=_state_fingerprint(torch, state))
    if level:
      break
    del state, step, batch
  plain, off = runs[""], runs["v0"]
  opt = state.opt_state
  moments = [opt.state[p][k] for p in state.params.values()
             for k in ("exp_avg", "exp_avg_sq")]
  pinned = all(t.device.type == "cpu" and t.is_pinned() for t in moments)
  mbytes = sum(t.numel() * t.element_size() for t in moments) / 1e9
  equal = np.array_equal(plain["losses"], off["losses"])
  differ = [k for k, v in plain["fingerprint"].items()
            if off["fingerprint"][k] != v]
  log(f"   (18g) moments {mbytes:.3f} GB in pinned host memory: {pinned}; "
      f"{opt.num_buckets} buckets through two device buffers of "
      f"{opt.bucket_bytes / 1e6:.1f} MB")
  log(f"   (18g) {OFFLOAD_WARMUP + OFFLOAD_STEPS} steps: losses equal loss "
      f"for loss {equal} (max |diff| "
      f"{float(np.max(np.abs(plain['losses'] - off['losses']))):.3e}); "
      f"median step {plain['ms']:.1f} ms without offload, "
      f"{off['ms']:.1f} ms with ({off['ms'] - plain['ms']:+.1f} ms); peak "
      f"HBM {plain['peak']:.3f} GB without, {off['peak']:.3f} GB with "
      f"({off['peak'] - plain['peak']:+.3f} GB); flash launches "
      f"{off['launches']} = {L} layers x {OFFLOAD_WARMUP + OFFLOAD_STEPS} "
      f"steps")
  log(f"   (18g) after {OFFLOAD_WARMUP + OFFLOAD_STEPS} steps, params and "
      f"both moments bit-equal to the run without offload: "
      f"{len(plain['fingerprint']) - len(differ)}/"
      f"{len(plain['fingerprint'])} leaves"
      + (f" (differ: {differ[:6]})" if differ else ""))
  assert pinned
  assert equal, (plain["losses"], off["losses"])
  assert not differ, differ
  assert off["peak"] < plain["peak"]
  # Native save and restore of the offloaded state, bit-equal.
  tmp = tempfile.mkdtemp(prefix="epl_phase18g_")
  try:
    want = {n: [p.detach().cpu().clone()] + [
        opt.state[p][k].clone() for k in ("exp_avg", "exp_avg_sq")]
        for n, p in state.params.items()}
    t0 = time.monotonic()
    saver.save_checkpoint(tmp, saver.state_tree(state), step=8)
    save_s = time.monotonic() - t0
    with torch.no_grad():
      for p in state.params.values():
        p.zero_()
        opt.state[p]["exp_avg"].zero_()
        opt.state[p]["exp_avg_sq"].zero_()
    t0 = time.monotonic()
    state, rstep = saver.restore_train_state(tmp, state)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    same = rstep == 8 and all(
        torch.equal(p.detach().cpu(), want[n][0])
        and torch.equal(opt.state[p]["exp_avg"], want[n][1])
        and torch.equal(opt.state[p]["exp_avg_sq"], want[n][2])
        and opt.state[p]["exp_avg"].is_pinned()
        for n, p in state.params.items())
    gbytes = sum(os.path.getsize(os.path.join(dp, f))
                 for dp, _, fs in os.walk(tmp) for f in fs) / 1e9
    log(f"   (18g) native save of the offloaded state {save_s:.2f} s, "
        f"restore {restore_s:.2f} s ({gbytes:.3f} GB); restored params "
        f"and moments bit-equal, moments still pinned: {same}")
    assert same
  finally:
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
  return state, off["launches"], save_s, restore_s


def dcp_checkpoint(torch, state, native_s):
  """Phase 18h: the offloaded state's whole tree (params, both moments,
  the count: 1.3 GB at RT_LAYERS) through ``save_checkpoint_orbax`` /
  ``restore_checkpoint_orbax`` (``torch.distributed.checkpoint``, one
  process, no process group), restored bit-equal, its seconds beside the
  native saver's."""
  import shutil
  import tempfile
  from easyparallellibrary_tpu_torch.runtime import saver
  tmp = tempfile.mkdtemp(prefix="epl_phase18h_")
  try:
    tree = saver.state_tree(state)
    t0 = time.monotonic()
    saver.save_checkpoint_orbax(tmp, tree, step=8)
    save_s = time.monotonic() - t0
    t0 = time.monotonic()
    got = saver.restore_checkpoint_orbax(tmp, 8, target=tree)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    want = dict(saver._sorted_leaves(tree))
    back = dict(saver._sorted_leaves(got))
    same = want.keys() == back.keys() and all(
        back[k].dtype == v.dtype and torch.equal(back[k], v)
        for k, v in want.items())
    gbytes = sum(os.path.getsize(os.path.join(dp, f))
                 for dp, _, fs in os.walk(tmp) for f in fs) / 1e9
    log(f"   (18h) DCP save {save_s:.2f} s, restore {restore_s:.2f} s of "
        f"{gbytes:.3f} GB ({len(want)} leaves; native saver: save "
        f"{native_s[0]:.2f} s, restore {native_s[1]:.2f} s); every leaf "
        f"bit-equal: {same}")
    leaves = sum(v.numel() * v.element_size() for v in want.values()) / 1e9
    assert same and gbytes >= leaves, (same, gbytes, leaves)
    return save_s, restore_s
  finally:
    shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------- phase 19: the fleet


FLEET_FACTORY = "easyparallellibrary_tpu_torch.testing.factories:gpt_350m"
FLEET_KILL_CALL = 6          # ReplicaKiller: step calls after prefill began
FLEET_FP32_REQUESTS, FLEET_FP32_NEW = 8, 16
FLEET_TRACE_LAYERS = 4       # 19e: depth cut for the traced children
# 19d: ABBA rounds of 1 and 2 process replicas (one, so that phase 22
# fits the script's time).
FLEET_ROUNDS = 1


class FleetMeter:
  """User-facing numbers of one router run, read at the router: tokens/s
  over the run's wall time, TTFT (submit to the first streamed token)
  and ITL (gaps between a request's streamed tokens), host ms per sweep
  (``Router.step``), from the router's ``on_tokens`` fanout."""

  def __init__(self, router):
    self.router = router
    self.submitted, self.first, self.last = {}, {}, {}
    self.itl, self.tokens, self.sweeps = [], 0, []
    router.on_tokens.append(self._on_tokens)

  def _on_tokens(self, uid, toks):
    now = time.monotonic()
    if uid not in self.first:
      self.first[uid] = now
    elif uid in self.last and toks:
      self.itl.append((now - self.last[uid]) / len(toks))
    self.last[uid] = now
    self.tokens += len(toks)

  def drive(self, request_cls, prompts, max_new=32):
    """Phase 5's staggered waves through the router, each sweep timed."""
    router = self.router
    step = router.step

    def timed_step():
      t0 = time.monotonic()
      out = step()
      self.sweeps.append(time.monotonic() - t0)
      return out

    router.step = timed_step
    orig_submit = router.submit

    def submit(req):
      self.submitted[req.uid] = time.monotonic()
      return orig_submit(req)

    router.submit = submit
    t0 = time.monotonic()
    try:
      out = drive_waves(router, request_cls, prompts, max_new=max_new)
    finally:
      router.step, router.submit = step, orig_submit
    self.wall = time.monotonic() - t0
    return out

  def drive_timed(self, request_cls, prompts, step, wave_s, max_new=32):
    """Phase 5's waves (8, 4, 4 requests) at wall offsets 0, ``wave_s``
    and ``2 * wave_s``, whatever ``step`` is (a sweep, or a reactor
    cycle of several steps per replica), then ``step`` until the fleet
    drains.  Returns ``{index: tokens}``."""
    router, out = self.router, {}
    waves = [(0, 8), (8, 12), (12, 16)]
    t0 = time.monotonic()
    w = 0
    while w < len(waves) or router.has_work:
      while w < len(waves) and time.monotonic() - t0 >= w * wave_s:
        for i in range(*waves[w]):
          self.submitted[i] = time.monotonic()
          router.submit(request_cls(uid=i, prompt=prompts[i],
                                    max_new_tokens=max_new))
        w += 1
      if not router.has_work:
        time.sleep(0.001)
        continue
      t = time.monotonic()
      for fin in step():
        out[fin.uid] = fin.tokens
      self.sweeps.append(time.monotonic() - t)
    self.wall = time.monotonic() - t0
    return out

  def summary(self):
    ttft = sorted(self.first[u] - self.submitted[u] for u in self.first
                  if u in self.submitted)
    pct = lambda xs, q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
    return {"tokens_per_s": self.tokens / self.wall,
            "ttft_p50_ms": pct(ttft, 0.5) * 1e3,
            "ttft_p99_ms": pct(ttft, 0.99) * 1e3,
            "itl_p50_ms": pct(sorted(self.itl), 0.5) * 1e3,
            "sweep_ms": statistics.median(self.sweeps) * 1e3,
            "sweeps": len(self.sweeps), "wall_s": self.wall}


def _fmt_fleet(s):
  return (f"tokens/s {s['tokens_per_s']:.1f}, TTFT p50 "
          f"{s['ttft_p50_ms']:.1f} ms p99 {s['ttft_p99_ms']:.1f} ms, ITL "
          f"p50 {s['itl_p50_ms']:.2f} ms, {s['sweeps']:g} sweeps, host "
          f"{s['sweep_ms']:.2f} ms a sweep (median)")


def _count_syncs(torch, fn):
  import warnings
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      out = fn()
      torch.cuda.synchronize()
    finally:
      torch.cuda.set_sync_debug_mode("default")
  return out, sum(SYNC_WARNING in str(w.message) for w in caught)


def _finished_once(router, n):
  assert sorted(router.finished) == list(range(n)), sorted(router.finished)
  for i in range(n):
    assert router.finished[i].finish_reason == "length", i


def _gone(pid):
  try:
    os.kill(pid, 0)
  except ProcessLookupError:
    return True
  return False


def fleet_serving(torch, params, pa):
  """Phase 19: the replicated fleet at GPT-350M width (paged, 8 slots,
  chunk 128, block 16) under phase 5's staggered load.  Returns the
  tiled build's launches over the process fleet's main-path run (summed
  from the children's beats) and over the in-process kill run."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.kernels import _build
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.observability import trace as trace_lib
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request, Router)
  from easyparallellibrary_tpu_torch.testing import chaos
  geometry = dict(paged=True, num_slots=NUM_SLOTS,
                  prefill_chunk=PREFILL_CHUNK, block_size=BLOCK_SIZE)
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
  model = GPT(cfg)
  prompts = make_prompts(2, 16, cfg.vocab_size)
  n = len(prompts)
  epl.init()
  launches = {}

  # (a) N=1 in process against the bare engine.
  bare = ContinuousBatchingEngine(model, params, **geometry)
  ref = drive_waves(bare, Request, prompts)
  bare_params = bare.params
  del bare
  libs = _build.loaded_count()
  router = Router(model, params, num_replicas=1, **geometry)
  pa.reset_counts()
  out = drive_waves(router, Request, prompts)
  torch.cuda.synchronize()
  steps = router.replicas[0].engine.steps
  a_launches = pa.paged_attention_tiled_cuda.launches
  equal = sum(np.array_equal(out[i], ref[i]) for i in range(n))
  log(f"   (19a) Router(N=1, inproc) against the bare engine: {equal}/{n} "
      f"streams token-equal; tiled launches {a_launches} = "
      f"{cfg.num_layers} layers x {steps} engine steps; kernel libraries "
      f"{libs} -> {_build.loaded_count()}")
  assert equal == n and a_launches == cfg.num_layers * steps > 0
  assert pa.paged_attention_reference.calls == 0
  assert _build.loaded_count() == libs
  _finished_once(router, n)
  del router

  # (b) two in-process replicas, one killed mid-decode: bf16 (held to the
  # gap rule where a replayed prefill rounds otherwise), then fp32.
  router = Router(model, params, num_replicas=2, **geometry)
  killer = chaos.ReplicaKiller(router.replicas[0].engine,
                               kill_calls=(FLEET_KILL_CALL,))
  pa.reset_counts()
  out = drive_waves(router, Request, prompts)
  torch.cuda.synchronize()
  launches["inproc"] = pa.paged_attention_tiled_cuda.launches
  assert killer.kills == 1 and router.failovers == 1
  _finished_once(router, n)
  log(f"   (19b) bf16, 2 inproc replicas, replica 0 killed at step call "
      f"{FLEET_KILL_CALL}: failovers {router.failovers}, migrated "
      f"{router.migrated_requests}, lost 0; tiled launches "
      f"{launches['inproc']}")
  greedy_vs_generate(torch, model, bare_params, prompts, out,
                     bf16_gap_limit, "19b bf16 failover",
                     refs=dict(ref), ref_name="the bare engine")
  del router, killer
  cfg32 = GPTConfig(**GPT_SERVE, dtype=torch.float32)
  model32 = GPT(cfg32)
  p32 = prompts[:FLEET_FP32_REQUESTS]
  runs32 = []
  for kill in (False, True):
    router = Router(model32, params, num_replicas=2, **geometry)
    if kill:
      chaos.ReplicaKiller(router.replicas[0].engine,
                          kill_calls=(FLEET_KILL_CALL,))
    for i, p in enumerate(p32):
      router.submit(Request(uid=i, prompt=p, max_new_tokens=FLEET_FP32_NEW))
    runs32.append(router.run())
    assert router.failovers == int(kill)
    _finished_once(router, len(p32))
    del router
  equal32 = greedy_vs_generate(torch, model32, params, p32, runs32[1],
                               lambda top1: 1e-3, "19b fp32 failover",
                               refs=dict(runs32[0]),
                               ref_name="the fault-free fleet")
  gc.collect()
  torch.cuda.empty_cache()

  # (c) two process replicas from the GPT-350M factory on the card.
  # Breaker hold-outs longer than the phase: a dead child is respawned
  # by the explicit rejoin below, never by a probe mid-run.
  router_conf = {"transport": "process", "spawn_timeout_s": 600.0,
                 "rpc_timeout_s": 300.0, "suspect_after": 1800.0,
                 "down_after": 3600.0}
  conf = epl.Config({"serving": {"router": router_conf}})
  epl.init(conf)
  factory = {"fn": FLEET_FACTORY, "kwargs": {"num_layers": SERVE_LAYERS}}
  t0 = time.monotonic()
  fleet = Router(num_replicas=2, config=conf, factory=factory,
                 device="cuda", **geometry)
  spawn_s = [rep.last_spawn_s for rep in fleet.replicas]
  names = {rep.device_name for rep in fleet.replicas}
  log(f"   (19c) 2 process replicas up in {time.monotonic() - t0:.1f} s "
      f"(cold spawns {', '.join(f'{s:.1f}' for s in spawn_s)} s; pids "
      f"{[r.child_pid for r in fleet.replicas]}; children on {names})")
  assert names == {torch.cuda.get_device_name(0)}
  results = {}
  try:
    # Warm-up (each child's first steps), then the numbers of (d).
    warm = [p[:64] for p in make_prompts(19, 4, cfg.vocab_size)]
    for i, p in enumerate(warm):
      fleet.submit(Request(uid=f"warm{i}", prompt=p, max_new_tokens=4))
    fleet.run()
    inj = {rep.index: rep for rep in fleet.replicas}

    def measured(rt):
      meter = FleetMeter(rt)
      out = meter.drive(Request, prompts)
      return out, meter.summary()

    one = Router(replicas=[inj[0]], config=conf)
    # 1 and 2 process replicas in ABBA turns, FLEET_ROUNDS rounds: the
    # spread between windows of one configuration inside this call sits
    # beside the ratio.  The first window of each counts the syncs; the
    # first 2-process window counts the children's launches.
    windows = {"process_1": [], "process_2": []}
    for turn in range(4 * FLEET_ROUNDS):
      key = "process_1" if turn % 4 in (0, 3) else "process_2"
      rt = one if key == "process_1" else fleet
      if turn == 0:
        (out1, s), syncs1 = _count_syncs(torch, lambda: measured(rt))
      elif turn == 1:
        for r in (0, 1):
          inj[r].reset_launch_counts()
        pa.reset_counts()
        (out2, s), syncs2 = _count_syncs(torch, lambda: measured(rt))
        launches["process"] = sum(rep.kernel_launches.get(
            "paged_attention_tiled", 0) for rep in fleet.replicas)
        plain_children = sum(rep.kernel_launches.get(
            "paged_attention_plain", 0) for rep in fleet.replicas)
        assert launches["process"] > 0 and plain_children == 0
        # The parent launched none.
        assert pa.paged_attention_cuda.launches == 0
      else:
        _, s = measured(rt)
      windows[key].append(s)
    del one
    for key, ws in windows.items():
      results[key] = {k: statistics.median(w[k] for w in ws)
                      for k in ws[0]}
    round_ratios = [
        sum(w["tokens_per_s"] for w in windows["process_2"][2 * r:2 * r + 2])
        / sum(w["tokens_per_s"] for w in windows["process_1"][2 * r:2 * r + 2])
        for r in range(FLEET_ROUNDS)]
    for label, o in (("1 process replica", out1),
                     ("2 process replicas", out2)):
      greedy_vs_generate(torch, model, bare_params, prompts, o,
                         bf16_gap_limit, f"19d {label}",
                         refs=dict(ref), ref_name="the bare engine")
    # 2 in-process replicas on the same card, warmed the same way.
    inproc = Router(model, params, num_replicas=2, transport="inproc",
                    **geometry)
    for i, p in enumerate(warm):
      inproc.submit(Request(uid=f"warm{i}", prompt=p, max_new_tokens=4))
    inproc.run()
    (outi, results["inproc_2"]), syncs_i = _count_syncs(
        torch, lambda: measured(inproc))
    del inproc
    gc.collect()
    torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    for key, label, syncs in (
        ("process_1", "1 process replica", syncs1),
        ("process_2", "2 process replicas", syncs2),
        ("inproc_2", "2 in-process replicas", syncs_i)):
      tps = [f"{w['tokens_per_s']:.1f}" for w in windows.get(key, ())]
      spread = (f" (median of {len(tps)} windows; tokens/s "
                f"{', '.join(tps)})" if tps else "")
      log(f"   (19d) {label} ({smi}): {_fmt_fleet(results[key])}{spread}; "
          f"synchronising calls in this process {syncs}"
          + (" (the first counted run)" if key == "process_1" else ""))
    log(f"   (19d) 2 process replicas against 1: tokens/s x "
        f"{results['process_2']['tokens_per_s'] / results['process_1']['tokens_per_s']:.3f}"
        f" (medians; per ABBA round "
        f"{', '.join(f'{r:.3f}' for r in round_ratios)}, spread "
        f"{min(round_ratios):.3f}-{max(round_ratios):.3f})"
        f"; 2 process against 2 in-process: x "
        f"{results['process_2']['tokens_per_s'] / results['inproc_2']['tokens_per_s']:.3f}"
        f"; children's tiled launches over the 2-process run "
        f"{launches['process']} (summed from their beats)")
    # The parent of process replicas touches no CUDA: none after the
    # first counted run (whose count includes the mode's own first use).
    assert syncs2 == 0, syncs2

    # The SIGKILL mid-decode.
    for i, p in enumerate(prompts):
      fleet.submit(Request(uid=100 + i, prompt=p, max_new_tokens=32))
    for _ in range(FLEET_KILL_CALL):
      fleet.step()
    victim = fleet.replicas[0]
    assert victim.has_work
    survivor_libs = fleet.replicas[1].compile_count
    free_before = torch.cuda.mem_get_info()[0]
    vpid = chaos.ProcessKiller(victim).kill()
    out = {}
    for fin in fleet.step():
      out[fin.uid] = fin.tokens
    signal_seen = victim.exit_signal
    out.update(fleet.run())
    free_after = torch.cuda.mem_get_info()[0]
    lost = [100 + i for i in range(n) if 100 + i not in fleet.finished]
    log(f"   (19c) SIGKILL of pid {vpid} mid-decode: failovers "
        f"{fleet.failovers}, migrated {fleet.migrated_requests}, lost "
        f"{len(lost)}; exit signal {signal_seen}; pid gone "
        f"{_gone(vpid)}; card memory free {free_before / 1e9:.2f} -> "
        f"{free_after / 1e9:.2f} GB; survivor's kernel libraries "
        f"{survivor_libs} -> {fleet.replicas[1].compile_count}")
    assert not lost and fleet.failovers == 1
    assert signal_seen == 9 and _gone(vpid)
    assert free_after - free_before > 0.5e9
    assert fleet.replicas[1].compile_count == survivor_libs
    greedy_vs_generate(torch, model, bare_params, prompts,
                       {i: out[100 + i] for i in range(n)}, bf16_gap_limit,
                       "19c SIGKILL failover", refs=dict(ref),
                       ref_name="the bare engine")
    assert fleet.rejoin(0, force=True)
    log(f"   (19c) rejoin(0, force=True): respawned pid "
        f"{fleet.replicas[0].child_pid} (was {vpid}) in "
        f"{fleet.replicas[0].last_spawn_s:.1f} s; restarts "
        f"{fleet.replicas[0].child_restarts}")
    assert fleet.replicas[0].child_pid != vpid and fleet.replicas[0].alive
    for i, p in enumerate(prompts):
      fleet.submit(Request(uid=200 + i, prompt=p, max_new_tokens=32))
    for _ in range(3):
      fleet.step()
    on_one = [u for u, r in fleet.placement.items() if r == 1]
    migrated0 = fleet.migrated_requests
    fleet.drain(1, timeout_s=0.0)
    fleet.step()
    moved = fleet.migrated_requests - migrated0
    fleet.run()
    log(f"   (19c) drain(1, timeout_s=0): {moved} request(s) migrated "
        f"through the evacuate RPC, replica 1 alive "
        f"{fleet.replicas[1].alive} and {fleet.state(1)}")
    assert moved == len(on_one) > 0 and fleet.replicas[1].alive
    assert all(200 + i in fleet.finished for i in range(n))
    pids = [rep.child_pid for rep in fleet.replicas] + [vpid]
  finally:
    fleet.close()
  assert all(_gone(pid) for pid in pids), pids
  log(f"   (19c) close(): child pids {pids} all gone")

  # (e) observability on, traced children (depth cut).
  conf = epl.Config({"serving": {"router": router_conf},
                     "observability": {"enabled": True}})
  reset_observability()
  epl.init(conf)
  tracer = trace_lib.ensure_configured(conf)
  traced = Router(num_replicas=2, config=conf, factory={
      "fn": FLEET_FACTORY, "kwargs": {"num_layers": FLEET_TRACE_LAYERS}},
      device="cuda", **geometry)
  tpids = [rep.child_pid for rep in traced.replicas]
  try:
    for i, p in enumerate(prompts[:8]):
      traced.submit(Request(uid=i, prompt=p, max_new_tokens=16))
    for _ in range(4):
      traced.step()
    chaos.ProcessKiller(traced.replicas[0]).kill()
    traced.run()
    traced.harvest_traces()
    harvested = traced.router_counters()["trace_events_harvested"]
  finally:
    traced.close()
  OBS_DIR.mkdir(parents=True, exist_ok=True)
  path = str(OBS_DIR / "fleet_trace.json")
  tracer.export(path)
  events = trace_lib.validate_trace(path)
  flows = {}
  for ev in events:
    if ev.get("ph") in ("s", "t", "f"):
      flows.setdefault(ev["id"], []).append(ev)
  parent = {e["pid"] for e in events if e.get("ph") != "M"} - set(tpids)
  spanning = [f for f, evs in flows.items()
              if parent | set(tpids) <= {e["pid"] for e in evs}]
  log(f"   (19e) traced fleet ({FLEET_TRACE_LAYERS} layers): "
      f"{int(harvested)} child events harvested, {len(events)} events "
      f"validated, {len(spanning)} failed-over flow(s) crossing the parent "
      f"and both children; trace {path}")
  assert harvested > 0 and spanning
  for f in spanning:
    assert flows[f][0]["ph"] == "s" and flows[f][-1]["ph"] == "f"
  reset_observability()
  return launches


# ------------------------------------------- phase 20: the self-healing fleet

# (a) the autotuner: a burst past a queue limit of 4 with the n-gram
# drafter, hold windows of 4 steps, a burn rule that breaches on sheds.
HEAL_WAVES, HEAL_WAVE_SIZE, HEAL_NEW, HEAL_LIGHT_MAX = 4, 10, 16, 40
HEAL_CONF = {
    "serving": {"resilience": {"enabled": True, "queue_limit": 4},
                "autotune": {"enabled": True, "hold_steps": 4}},
    "observability": {"slo": {
        "enabled": True, "shed_objective": 0.5, "fast_window": 2,
        "slow_window": 3, "fast_burn": 1.0, "slow_burn": 1.0}}}
# (c) rollouts: requests (16: 8 before begin(), the rest from the canary
# on) and new tokens, the canary's hold (seconds on the router's wall
# clock).
ROLL_REQUESTS, ROLL_NEW, ROLL_HOLD_S = 16, 16, 1.0
# (b) and (c) run GPT-350M's widths at 6 of its 24 layers (the script's
# time): the first 6 blocks of the seed-0 draw are the 6-layer draw's,
# bit for bit, so the in-process replicas, the process children and the
# references share their weights.
HEAL_LAYERS = 6


def depth_cut(params, layers: int):
  """The weights of the first ``layers`` blocks of a GPT (and the rest)."""
  return {k: v for k, v in params.items()
          if not k.startswith("block_") or int(k.split(".")[0][6:]) < layers}
# (d) ABBA rounds of sweep and reactor windows, phase 5's three waves
# REACTOR_WAVE_S apart on the wall clock (about three sweeps: a reactor
# cycle runs several steps, so waves paced in calls would differ); the
# wire deadline that condemns the SIGSTOPped child.
# 20d: one ABBA round of sweep and reactor windows (the script's time).
REACTOR_ROUNDS, REACTOR_WAVE_S, STALL_RPC_TIMEOUT_S = 1, 0.075, 5.0


def _actuation_log(monitor):
  return [f"{e.get('actuator')}:{e.get('to_level', e.get('action'))}"
          f"@{e.get('step')}" for e in monitor.events
          if e.get("event") == "actuation"]


def _versioned_gap_rule(torch, model, weights, prompts, out, versions,
                        cache, label):
  """``greedy_vs_generate`` per checkpoint version: each stream against
  ``generate(use_cache=False)`` of the weights it was admitted under
  (references kept in ``cache`` by (version, uid) for a later run)."""
  for ver in sorted(set(versions[u] for u in out)):
    uids = sorted(u for u in out if versions[u] == ver)
    local = {k: cache[(ver, u)] for k, u in enumerate(uids)
             if (ver, u) in cache}
    greedy_vs_generate(torch, model, weights[ver], [prompts[u] for u in uids],
                       {k: out[u] for k, u in enumerate(uids)},
                       bf16_gap_limit, f"{label} v{ver}", refs=local)
    for k, u in enumerate(uids):
      cache[(ver, u)] = local[k]


def _k2_at_plan(torch, pa, eng, plan, seed):
  """The tiled kernel against its plain version on one real step the
  engine planned: the plan's tables, positions and tiles (its draft runs
  included) over the engine's layer-0 pools, random q.  Returns max
  |kernel - plain|."""
  pool = eng._kv["block_0"]["attn"]
  kp, vp = pool["cached_key"], pool["cached_value"]
  tables = torch.from_numpy(plan.block_tables[plan.slot_ids]).cuda()
  positions = torch.from_numpy(plan.positions).cuda()
  g = torch.Generator(device="cuda").manual_seed(seed)
  q = torch.randn((len(plan.positions), kp.shape[2], kp.shape[3]),
                  generator=g, device="cuda", dtype=kp.dtype)
  runs = pa.tile_runs_from_plan(plan.base_idx, plan.num_valid,
                                len(plan.positions), plan.draft_base,
                                plan.draft_cap)
  tiles = pa.plan_tiles(runs, plan.positions, tables.shape[1], kp.shape[1],
                        q.shape[1], q.device)
  before = pa.paged_attention_tiled_cuda.launches
  got = pa.paged_attention(q, kp, vp, tables, positions, tiles)
  want = pa.paged_attention_reference(q, kp, vp, tables, positions)
  torch.cuda.synchronize()
  assert pa.paged_attention_tiled_cuda.launches == before + 1
  assert bool(torch.isfinite(got).all())
  tol = TOLERANCE["bfloat16"]
  torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
  return (got.float() - want.float()).abs().max().item()


def heal_autotune(torch, params, pa):
  """(a) A paged engine with the n-gram drafter and the autotuner under
  an overload burst: spec_trim, budget_tight, slot_cap and back.
  Returns the tiled build's launches over the run."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.kernels import _build
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.observability import slo as slo_lib
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, NgramDrafter, Request)
  from easyparallellibrary_tpu_torch.serving.autotune import TUNE_LEVELS
  reset_observability()
  conf = epl.Config(HEAL_CONF)
  epl.init(conf)
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
  model = GPT(cfg)
  eng = ContinuousBatchingEngine(
      model, params, paged=True, num_slots=NUM_SLOTS,
      prefill_chunk=PREFILL_CHUNK, block_size=BLOCK_SIZE,
      drafter=NgramDrafter(k=SPEC_K), config=conf)
  prompts = repeating_prompts(20, HEAL_WAVES * HEAL_WAVE_SIZE
                              + HEAL_LIGHT_MAX, cfg.vocab_size)
  eng.submit(Request(uid="warm", prompt=prompts[0][:64], max_new_tokens=4))
  eng.run()
  libs = _build.loaded_count()
  tuner = eng._autotuner
  plans, host, max_cap = {}, {}, {}
  plan_step = eng.scheduler.plan_step

  def capture():
    # Each level's fullest plan (most draft positions, then tokens),
    # copied as planned; the largest draft cap seen at each level.
    plan = plan_step()
    if plan is not None:
      level = tuner.level
      max_cap[level] = max(max_cap.get(level, 0), int(plan.draft_cap.max()))
      best = plans.get(level)
      key = (int(plan.draft_cap.sum()), plan.scheduled_tokens)
      if best is None or key > best[0]:
        plans[level] = (key, dataclasses.replace(plan, **{
            f.name: np.copy(getattr(plan, f.name))
            for f in dataclasses.fields(plan)
            if isinstance(getattr(plan, f.name), np.ndarray)}))
    return plan

  eng.scheduler.plan_step = capture
  out, shed = {}, []

  def step():
    t0 = time.monotonic()
    fins = eng.step()
    dt = time.monotonic() - t0
    host.setdefault(tuner.level, []).append(dt)
    for fin in fins:
      out[fin.uid] = fin

  pa.reset_counts()
  steps0 = eng.steps
  uid = 0
  for _ in range(HEAL_WAVES):
    for _ in range(HEAL_WAVE_SIZE):
      if not eng.submit(Request(uid=uid, prompt=prompts[uid],
                                max_new_tokens=HEAL_NEW)):
        shed.append(uid)
      uid += 1
    for _ in range(3):
      step()
  while eng.has_work:
    step()
  light = 0
  while tuner.level > 0 or light == 0:
    assert light < HEAL_LIGHT_MAX, f"the ladder stayed at {tuner.level}"
    eng.submit(Request(uid=uid, prompt=prompts[uid],
                       max_new_tokens=HEAL_NEW))
    uid += 1
    light += 1
    while eng.has_work:
      step()
  torch.cuda.synchronize()
  steps = eng.steps - steps0
  launches = pa.paged_attention_tiled_cuda.launches
  eng.scheduler.plan_step = plan_step
  monitor = slo_lib.get_monitor()
  levels = sorted(host)
  log(f"   (20a) {uid} requests ({len(shed)} shed at submit, queue limit "
      f"4), {steps} engine steps; actuations "
      f"{_actuation_log(monitor)}")
  for level in levels:
    ms = sorted(host[level])
    log(f"   (20a) {TUNE_LEVELS[level]:12s} {len(ms):4d} steps, host ms a "
        f"step p50 {statistics.median(ms) * 1e3:.2f}, max "
        f"{ms[-1] * 1e3:.2f}")
  assert levels == [0, 1, 2, 3] and tuner.level == 0, levels
  assert eng._compile_sentinel.recompiles == 0
  assert _build.loaded_count() == libs
  assert launches > 0 and pa.paged_attention_reference.calls == 0
  assert pa.paged_attention_warp_cuda.launches == 0
  log(f"   (20a) tiled launches {launches} over the run (= "
      f"{cfg.num_layers} layers x the steps that planned work); kernel "
      f"libraries {libs} -> {_build.loaded_count()}; compile sentinel "
      f"silent")
  for level in levels:
    (drafts, tokens), plan = plans[level]
    err = _k2_at_plan(torch, pa, eng, plan, seed=level)
    log(f"   (20a) K2 at a {TUNE_LEVELS[level]} step ({tokens} tokens, "
        f"{plan.active_slots} slots, draft caps max "
        f"{int(plan.draft_cap.max())}, {drafts} draft positions): "
        f"max|kernel - plain| = {err:.3e} (rtol = atol = "
        f"{TOLERANCE['bfloat16']:g})")
  log(f"   (20a) largest draft cap planned at each level "
      f"{[max_cap[lv] for lv in levels]} (k = {SPEC_K})")
  assert max_cap[1] <= SPEC_K // 2 and max_cap[2] == max_cap[3] == 0
  served = sorted(u for u, f in out.items() if f.finish_reason == "length")
  assert sorted(out) == sorted(set(range(uid)) - set(shed))
  greedy_vs_generate(torch, model, eng.params, [prompts[u] for u in served],
                     {k: out[u].tokens for k, u in enumerate(served)},
                     bf16_gap_limit, "20a non-shed")
  del eng
  reset_observability()
  return launches


def heal_golden(torch, params):
  """(b) The golden chaos-heal episode driven through a real fleet of
  in-process GPT-350M replicas on the card, as recorded (contiguous
  layout, 4 slots, chunk 4, the recorded arrivals and fixed dt,
  ``sync_spawn``); then the port's simulator replays the same file."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.observability import slo as slo_lib
  from easyparallellibrary_tpu_torch.observability.registry import (
      MetricRegistry)
  from easyparallellibrary_tpu_torch.serving import Router
  from easyparallellibrary_tpu_torch.sim import replay
  from easyparallellibrary_tpu_torch.sim.arrivals import Workload
  from easyparallellibrary_tpu_torch.sim.engine import SimClock
  from easyparallellibrary_tpu_torch.sim.fleet import (
      actuation_sequence, drive_episode, warm_fleet)
  golden = replay.load_golden()
  want = golden["counters"]
  reset_observability()
  config = epl.Config(golden["config"])
  epl.init(config)
  model = GPT(GPTConfig(**dict(GPT_350M, num_layers=HEAL_LAYERS),
                        dtype=torch.bfloat16))
  params = depth_cut(params, HEAL_LAYERS)
  clock = SimClock()
  router = Router(model, params, num_replicas=golden["num_replicas"],
                  config=config, registry=MetricRegistry(), clock=clock,
                  num_slots=golden["num_slots"],
                  prefill_chunk=golden["chunk"])
  prompt = np.asarray(golden["prompt"], np.int32)
  n = len(golden["arrivals"])
  t0 = time.monotonic()
  warm_fleet(router, clock, prompt, golden["warm_max_new"])
  loop = drive_episode(
      router, clock, Workload(times=list(golden["arrivals"]),
                              prompts=[prompt] * n,
                              max_new=[golden["max_new"]] * n),
      fixed_dt=golden["fixed_dt"], idle_dt=golden["idle_dt"],
      settle_steps=golden["settle_steps"])
  torch.cuda.synchronize()
  real_s = time.monotonic() - t0
  monitor = slo_lib.get_monitor()
  seq = actuation_sequence()
  got = {"requests": n,
         "shed": sum(router.finished[u].finish_reason == "shed"
                     for u in range(n)),
         "busy_sweeps": loop["busy_sweeps"],
         "idle_jumps": loop["idle_jumps"],
         "replicas_peak": loop["replicas_peak"],
         "breaches": monitor.breaches, "recoveries": monitor.recoveries,
         "actuations": monitor.actuations}
  first = next((i for i, (a, b) in enumerate(zip(seq, golden["sequence"]))
                if a != b), None)
  log(f"   (20b) real fleet of GPT-350M replicas on the card: "
      f"{len(seq)} actuations ({'equal to' if seq == golden['sequence'] else 'DIFFERENT from'}"
      f" the golden file's {len(golden['sequence'])}"
      + (f"; first difference at {first}: {seq[first]} vs "
         f"{golden['sequence'][first]}" if first is not None else "")
      + f"); counters {got}; wall {real_s:.2f} s")
  assert seq == golden["sequence"]
  assert got == want, (got, want)
  router.close()
  del router
  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.monotonic()
  sim = replay.replay(golden)
  sim_s = time.monotonic() - t0
  log(f"   (20b) the port's simulator on the same file: sequence equal "
      f"{sim['sequence'] == golden['sequence']}, shed {sim['shed']}, "
      f"busy sweeps {sim['busy_sweeps']}, breaches {sim['breaches']}, "
      f"recoveries {sim['recoveries']}, peak {sim['replicas_peak']}; wall "
      f"{sim_s:.2f} s against the real fleet's {real_s:.2f} s")
  assert sim["sequence"] == golden["sequence"]
  for key in ("shed", "busy_sweeps", "breaches", "recoveries",
              "replicas_peak"):
    assert sim[key] == want[key], key
  reset_observability()


def _drive_rollout(router, request_cls, prompts, versions, *, begin=None,
                   breach=None):
  """Eight submits and a sweep, then ``begin()`` (when given), sweeps
  while the greens spawn (blue serving), one submit a sweep from the
  canary on until the rollout is idle again, the rest, and the fleet
  drained.  ``breach`` fires once the canary has carried traffic.
  Returns ``{uid: tokens}``; ``versions`` gets each request's version at
  admission."""
  ctr = [0]

  def submit_one():
    uid = ctr[0]
    if uid >= len(prompts):
      return
    ctr[0] += 1
    assert router.submit(request_cls(uid=uid, prompt=prompts[uid],
                                     max_new_tokens=ROLL_NEW))
    versions[uid] = router._replica_version(router.placement[uid])

  for _ in range(8):
    submit_one()
  router.step()
  if begin is not None:
    begin()
    deadline = time.monotonic() + 900.0
    fired = False
    while router.rollout.active:
      assert time.monotonic() < deadline, router.rollout.state
      if router.rollout.state != "spawning":
        submit_one()
      router.step()
      if not router.has_work:
        time.sleep(0.001)       # idle: leave the spawner thread the GIL
      if (breach is not None and not fired
          and router.rollout.state == "canary"
          and any(v == 1 for v in versions.values())):
        breach()
        fired = True
  while ctr[0] < len(prompts):
    submit_one()
  router.run()
  return {u: f.tokens for u, f in router.finished.items()}


def heal_rollout(torch, params, pa):
  """(c) Blue/green rollouts: in process (a full rollout under load, then
  one forced into a canary breach), then one process blue child to one
  green child restoring the checkpoint.  Returns the tiled launches of
  the in-process rollout run and the children's."""
  import shutil
  import tempfile
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.observability import slo as slo_lib
  from easyparallellibrary_tpu_torch.runtime import saver
  from easyparallellibrary_tpu_torch.serving import Request, Router
  from easyparallellibrary_tpu_torch.weights import init_params
  geometry = dict(paged=True, num_slots=NUM_SLOTS,
                  prefill_chunk=PREFILL_CHUNK, block_size=BLOCK_SIZE)
  widths = dict(GPT_350M, num_layers=HEAL_LAYERS)
  cfg = GPTConfig(**widths, dtype=torch.bfloat16)
  model = GPT(cfg)
  params = depth_cut(params, HEAL_LAYERS)
  prompts = make_prompts(3, ROLL_REQUESTS, cfg.vocab_size)
  green = init_params(GPTConfig(**widths), seed=1, device="cuda")
  weights = {0: params, 1: green}
  tmp = tempfile.mkdtemp(prefix="epl_phase20_")
  launches = {}
  cache = {}
  try:
    reset_observability()
    rollout = {"enabled": True, "canary_frac": 0.5,
               "canary_hold_s": ROLL_HOLD_S, "min_replicas": 2,
               "spawn_timeout_s": 600.0, "drain_timeout_s": 600.0}
    conf = epl.Config({"serving": {"rollout": rollout}})
    epl.init(conf)
    t0 = time.monotonic()
    saver.save_checkpoint(tmp, saver.params_tree(green), step=1)
    log(f"   (20c) green checkpoint (init_params(seed=1), fp32) written in "
        f"{time.monotonic() - t0:.2f} s")
    router = Router(model, params, num_replicas=2, config=conf, **geometry)
    ctl = router.rollout
    marks = {}

    def begin():
      t = time.monotonic()
      ctl.begin(tmp)
      marks["begin_ms"] = (time.monotonic() - t) * 1e3
      marks["t0"] = time.monotonic()

    versions = {}
    pa.reset_counts()
    out = _drive_rollout(router, Request, prompts, versions, begin=begin)
    torch.cuda.synchronize()
    launches["rollout"] = pa.paged_attention_tiled_cuda.launches
    per_ver = {v: sum(1 for u in versions if versions[u] == v)
               for v in (0, 1)}
    log(f"   (20c) in-process rollout 2 blue -> 2 green: begin() (checksum "
        f"chain and geometry, green spawns queued) {marks['begin_ms']:.1f} "
        f"ms; begin to retired {time.monotonic() - marks['t0']:.1f} s; "
        f"requests by version {per_ver}; lost "
        f"{len(prompts) - len(out)}; states {router.states()}; counters "
        f"{ctl.counters()}; tiled launches {launches['rollout']}")
    assert sorted(out) == list(range(len(prompts)))
    assert all(router.finished[u].finish_reason == "length" for u in out)
    assert per_ver[0] > 0 and per_ver[1] > 0
    assert router._fleet_version == 1 and ctl.completed == 1
    assert launches["rollout"] > 0
    assert pa.paged_attention_reference.calls == 0
    _versioned_gap_rule(torch, model, weights, prompts, out, versions,
                        cache, "20c rollout")
    router.close()
    del router, ctl
    gc.collect()

    # A second rollout forced into a canary breach, against a never-rolled
    # run of the same load.
    slo = {"enabled": True, "ttft_p99_s": 0.5}
    rollout_hold = dict(rollout, canary_hold_s=900.0)
    base_versions, rolled_versions = {}, {}
    runs = []
    for roll in (False, True):
      reset_observability()
      conf = epl.Config({"serving": {"rollout": rollout_hold},
                         "observability": {"slo": slo}})
      epl.init(conf)
      router = Router(model, params, num_replicas=2, config=conf,
                      **geometry)

      def breach():
        slo_lib.get_monitor().observe(router.steps,
                                      {"serving/fleet/v1/ttft_p99_s": 99.0})

      runs.append(_drive_rollout(
          router, Request, prompts,
          rolled_versions if roll else base_versions,
          begin=(lambda: router.rollout.begin(tmp)) if roll else None,
          breach=breach if roll else None))
      if roll:
        counters = router.rollout.counters()
        states = router.states()
        assert counters["rollout_rollbacks"] == 1.0
        assert router._fleet_version == 0
      router.close()
      del router
      gc.collect()
    base, rolled = runs
    blue = [u for u in rolled if rolled_versions[u] == 0]
    canary = [u for u in rolled if rolled_versions[u] == 1]
    equal = sum(np.array_equal(rolled[u], base[u]) for u in blue)
    log(f"   (20c) canary breach: rolled back ({counters}); states "
        f"{states}; {len(canary)} canary request(s) completed on green in "
        f"place; blue streams equal to the never-rolled run: {equal}/"
        f"{len(blue)}")
    assert canary and sorted(rolled) == list(range(len(prompts)))
    greedy_vs_generate(torch, model, params, [prompts[u] for u in blue],
                       {k: rolled[u] for k, u in enumerate(blue)},
                       bf16_gap_limit, "20c blue after rollback",
                       refs={k: base[u] for k, u in enumerate(blue)},
                       ref_name="the never-rolled run")
    _versioned_gap_rule(torch, model, weights, prompts, rolled,
                        rolled_versions, cache, "20c rollback")

    # The process transport: one blue child to one green child that
    # restores the checkpoint itself.
    reset_observability()
    conf = epl.Config({"serving": {
        "router": {"transport": "process", "spawn_timeout_s": 600.0,
                   "rpc_timeout_s": 300.0, "suspect_after": 1800.0,
                   "down_after": 3600.0},
        "rollout": dict(rollout, min_replicas=1)}})
    epl.init(conf)
    fleet = Router(num_replicas=1, config=conf,
                   factory={"fn": FLEET_FACTORY,
                            "kwargs": {"num_layers": HEAL_LAYERS}},
                   device="cuda", **geometry)
    pids = []
    try:
      blue_spawn = fleet.replicas[0].last_spawn_s
      fleet.replicas[0].reset_launch_counts()
      versions = {}
      out = _drive_rollout(fleet, Request, prompts, versions,
                           begin=lambda: fleet.rollout.begin(tmp))
      green_rep = fleet.replicas[1]
      child = [rep.kernel_launches.get("paged_attention_tiled", 0)
               for rep in fleet.replicas]
      launches["rollout_children"] = sum(child)
      per_ver = {v: sum(1 for u in versions if versions[u] == v)
                 for v in (0, 1)}
      log(f"   (20c) process rollout 1 blue child -> 1 green child: cold "
          f"spawns {blue_spawn:.1f} s (blue), {green_rep.last_spawn_s:.1f} "
          f"s (green, restoring the checkpoint in the child); requests by "
          f"version {per_ver}; lost {len(prompts) - len(out)}; children's "
          f"tiled launches {child} (from their beats); states "
          f"{fleet.states()}")
      assert sorted(out) == list(range(len(prompts)))
      assert per_ver[0] > 0 and per_ver[1] > 0 and all(child)
      assert fleet._fleet_version == 1
      _versioned_gap_rule(torch, model, weights, prompts, out, versions,
                          cache, "20c process rollout")
      pids = [rep.child_pid for rep in fleet.replicas]
    finally:
      fleet.close()
    assert all(_gone(p) for p in pids), pids
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
    reset_observability()
  del green
  gc.collect()
  torch.cuda.empty_cache()
  return launches


def heal_reactor(torch, params, pa, refs):
  """(d) Two process replicas, sweep against reactor in ABBA rounds;
  then one child SIGSTOPped under the reactor.  Returns the children's
  tiled launches over the first reactor window."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import Request, Router
  from easyparallellibrary_tpu_torch.testing import chaos
  geometry = dict(paged=True, num_slots=NUM_SLOTS,
                  prefill_chunk=PREFILL_CHUNK, block_size=BLOCK_SIZE)
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
  model = GPT(cfg)
  prompts = make_prompts(2, 16, cfg.vocab_size)
  reset_observability()
  conf = epl.Config({"serving": {"router": {
      "transport": "process", "reactor": True, "spawn_timeout_s": 600.0,
      "rpc_timeout_s": STALL_RPC_TIMEOUT_S, "suspect_after": 1800.0,
      "down_after": 3600.0}}})
  epl.init(conf)
  fleet = Router(num_replicas=2, config=conf,
                 factory={"fn": FLEET_FACTORY,
                          "kwargs": {"num_layers": SERVE_LAYERS}},
                 device="cuda", **geometry)
  reactor = fleet.reactor()
  launches = 0
  pids = [rep.child_pid for rep in fleet.replicas]
  try:
    warm = [p[:64] for p in make_prompts(19, 4, cfg.vocab_size)]
    for i, p in enumerate(warm):
      fleet.submit(Request(uid=f"warm{i}", prompt=p, max_new_tokens=4))
    fleet.run()
    windows = {"sweep": [], "reactor": []}
    outs = {}
    for turn in range(4 * REACTOR_ROUNDS):
      # ABBA: the reactor's windows drive the fleet by its cycles, the
      # sweep's by Router.step, under the same arrival times.
      key = "sweep" if turn % 4 in (0, 3) else "reactor"
      if turn == 1:
        for rep in fleet.replicas:
          rep.reset_launch_counts()
      meter = FleetMeter(fleet)
      try:
        out = meter.drive_timed(
            Request, prompts,
            reactor.cycle if key == "reactor" else fleet.step,
            REACTOR_WAVE_S)
      finally:
        fleet.on_tokens.remove(meter._on_tokens)
      if turn == 1:
        launches = sum(rep.kernel_launches.get("paged_attention_tiled", 0)
                       for rep in fleet.replicas)
      outs.setdefault(key, out)
      windows[key].append(meter.summary())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    med = {}
    for key, ws in windows.items():
      med[key] = {k: statistics.median(w[k] for w in ws) for k in ws[0]}
      tps = ", ".join(f"{w['tokens_per_s']:.1f}" for w in ws)
      log(f"   (20d) 2 process replicas, {key} ({smi}): "
          f"{_fmt_fleet(med[key])} (median of {len(ws)} windows; tokens/s "
          f"{tps})")
    log(f"   (20d) reactor cycles {reactor.cycles}, steps dispatched "
        f"{reactor.dispatched}, selector waits {reactor.wire_waits}")
    ratios = [
        sum(w["tokens_per_s"] for w in windows["reactor"][2 * r:2 * r + 2])
        / sum(w["tokens_per_s"] for w in windows["sweep"][2 * r:2 * r + 2])
        for r in range(REACTOR_ROUNDS)]
    log(f"   (20d) reactor against sweep: tokens/s x "
        f"{med['reactor']['tokens_per_s'] / med['sweep']['tokens_per_s']:.3f}"
        f" (per ABBA round {', '.join(f'{r:.3f}' for r in ratios)}); TTFT "
        f"p50 {med['reactor']['ttft_p50_ms']:.1f} against "
        f"{med['sweep']['ttft_p50_ms']:.1f} ms, ITL p50 "
        f"{med['reactor']['itl_p50_ms']:.2f} against "
        f"{med['sweep']['itl_p50_ms']:.2f} ms; children's tiled launches "
        f"over the first reactor window {launches}")
    assert launches > 0
    for key, out in outs.items():
      greedy_vs_generate(torch, model, params, prompts, out, bf16_gap_limit,
                         f"20d {key}", refs=refs)

    # SIGSTOP one child with work in flight, under the reactor.
    for i, p in enumerate(prompts):
      assert fleet.submit(Request(uid=100 + i, prompt=p, max_new_tokens=32))
    collects = {0: 0, 1: 0}
    collect_one = fleet._collect_one

    def counting(i, now):
      collects[i] += 1
      return collect_one(i, now)

    fleet._collect_one = counting
    reactor.cycle()
    victim = fleet.replicas[0]
    assert victim.has_work
    chaos.ProcessStaller(victim).stall()
    t0 = time.monotonic()
    before = dict(collects)
    while fleet.failovers == 0:
      assert time.monotonic() - t0 < 10 * STALL_RPC_TIMEOUT_S
      reactor.cycle()
    stall_s = time.monotonic() - t0
    during = collects[1] - before[1]
    fleet.run()
    lost = [i for i in range(len(prompts)) if 100 + i not in fleet.finished]
    log(f"   (20d) SIGSTOP of pid {victim.child_pid} under the reactor: "
        f"condemned after {stall_s:.1f} s (wire deadline "
        f"{STALL_RPC_TIMEOUT_S:g} s); the other child ran {during} steps "
        f"meanwhile; failovers {fleet.failovers}, migrated "
        f"{fleet.migrated_requests}, lost {len(lost)}")
    assert not lost and during > 0 and fleet.states()[0] == "down"
    assert all(fleet.finished[100 + i].finish_reason == "length"
               for i in range(len(prompts)))
    greedy_vs_generate(torch, model, params, prompts,
                       {i: fleet.finished[100 + i].tokens
                        for i in range(len(prompts))}, bf16_gap_limit,
                       "20d SIGSTOP failover", refs=refs)
    del fleet._collect_one
  finally:
    fleet.close()
  assert all(_gone(p) for p in pids), pids
  reset_observability()
  return launches


def _sse_clients(fd_lib, door, prompts, tag):
  """Phase 5's 16 requests as concurrent SSE clients (8, then 4 after
  0.15 s, then 4 after 0.3 s), each on its own thread.  Returns
  ``(results, first, wall)``: ``{i: (tokens, done)}``, the client's
  time to its first token event, the batch's wall time."""
  import threading
  results, errors, first = {}, {}, {}

  def client(i, p, delay):
    time.sleep(delay)
    t0 = time.monotonic()
    toks = []
    try:
      for event, data in fd_lib.stream_generate(
          door.address, {"uid": f"{tag}{i}", "prompt": [int(t) for t in p],
                         "max_new_tokens": 32}, timeout=600.0):
        if event == "token":
          first.setdefault(i, time.monotonic() - t0)
          toks.extend(data["tokens"])
        else:
          results[i] = (toks, data)
    except Exception as e:  # noqa: BLE001 — reported by the assert
      errors[i] = e

  delays = [0.0] * 8 + [0.15] * 4 + [0.3] * 4
  t0 = time.monotonic()
  threads = [threading.Thread(target=client, args=(i, p, delays[i]),
                              daemon=True) for i, p in enumerate(prompts)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=600.0)
  assert not errors, errors
  assert sorted(results) == list(range(len(prompts)))
  return results, first, time.monotonic() - t0


def heal_frontdoor(torch, params, pa):
  """(e) Phase 5's 16 requests as concurrent SSE clients on 127.0.0.1
  through an in-process reactor fleet of two replicas (then once more
  with the front door driving the sweep, for the TTFT it adds).
  Returns the tiled launches over the reactor clients' run."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import Request, Router
  from easyparallellibrary_tpu_torch.serving import frontdoor as fd_lib
  from easyparallellibrary_tpu_torch.serving.frontdoor.client import _post
  from easyparallellibrary_tpu_torch.testing import chaos
  geometry = dict(paged=True, num_slots=NUM_SLOTS,
                  prefill_chunk=PREFILL_CHUNK, block_size=BLOCK_SIZE)
  cfg = GPTConfig(**GPT_SERVE, dtype=torch.bfloat16)
  model = GPT(cfg)
  prompts = make_prompts(2, 16, cfg.vocab_size)
  reset_observability()
  conf = epl.Config({"serving": {"router": {"reactor": True},
                                 "frontdoor": {"keepalive_s": 0.2}}})
  epl.init(conf)
  router = Router(model, params, num_replicas=2, config=conf, **geometry)
  for i, p in enumerate(prompts):
    router.submit(Request(uid=f"direct{i}", prompt=p, max_new_tokens=32))
  direct = router.run()
  direct = {i: direct[f"direct{i}"] for i in range(len(prompts))}
  # TTFT at the router (its submit to the first streamed token, both on
  # the front door's driver thread) beside the client's.
  at_router, router_first = {}, {}
  submit = router.submit

  def timed_submit(req):
    at_router[req.uid] = time.monotonic()
    return submit(req)

  router.submit = timed_submit
  router.on_tokens.append(
      lambda uid, toks: router_first.setdefault(uid, time.monotonic()))
  header = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
  with fd_lib.FrontDoor(router) as door:
    assert door.address[0] == "127.0.0.1"
    for rep in router.replicas:
      rep.stats.reset()
    pa.reset_counts()
    results, first, wall = _sse_clients(fd_lib, door, prompts, "c")
    torch.cuda.synchronize()
    launches = pa.paged_attention_tiled_cuda.launches
    fleet_ttft = statistics.median(
        router_first[f"c{i}"] - at_router[f"c{i}"] for i in results)
    client_ttft = statistics.median(first.values())
    log(f"   (20e) {len(prompts)} SSE clients on {door.url} through the "
        f"reactor: {wall:.2f} s wall; TTFT p50 client-observed "
        f"{client_ttft * 1e3:.1f} ms, at the router {fleet_ttft * 1e3:.1f} "
        f"ms (its submit to the first committed token), the engines' "
        f"{router.fleet_summary()['ttft_p50_s'] * 1e3:.1f} ms "
        f"(ServingStats); {door.streamed_events} token events; tiled "
        f"launches {launches}")
    assert launches > 0 and pa.paged_attention_reference.calls == 0
    for i, (toks, done) in results.items():
      assert done["finish_reason"] == "length" and not done["truncated"]
      assert all(type(t) is int for t in toks)
    greedy_vs_generate(
        torch, model, params, prompts,
        {i: np.asarray([int(t) for t in prompts[i]] + results[i][0])
         for i in results}, bf16_gap_limit, "20e SSE streams",
        refs=dict(direct), ref_name="direct submits to the same fleet")
    # A client that vanishes mid-stream frees its slot.
    gone = chaos.DisconnectingClient(
        door.address, {"uid": "gone",
                       "prompt": [int(t) for t in prompts[0][:64]],
                       "max_new_tokens": 256}, after_events=2, rst=True,
        timeout_s=120.0)
    gone.start()
    gone.join(timeout=120.0)
    deadline = time.monotonic() + 60.0
    while getattr(router.finished.get("gone"), "finish_reason",
                  None) != "cancelled":
      assert time.monotonic() < deadline, "the disconnect was not cancelled"
      time.sleep(0.02)
    while router.has_work:
      assert time.monotonic() < deadline
      time.sleep(0.02)
    active = sum(rep.num_active for rep in router.replicas)
    resp = _post(door.address, {"uid": "tp", "prompt": [1, 2, 3],
                                "max_new_tokens": 2}, {"traceparent": header},
                 timeout=120.0)
    echoed = resp.getheader("traceparent")
    resp.read()
    resp.close()
    log(f"   (20e) disconnect after {gone.events_seen} events: "
        f"{router.finished['gone'].finish_reason} at "
        f"{router.finished['gone'].new_tokens} tokens, active slots "
        f"{active}, disconnect cancels {door.disconnect_cancels}; "
        f"traceparent echoed {echoed == header}")
    assert gone.dropped and active == 0 and door.disconnect_cancels == 1
    assert echoed == header
  sweep_conf = epl.Config({"serving": {"router": {"reactor": False}}})
  for rep in router.replicas:
    rep.stats.reset()
  with fd_lib.FrontDoor(router, config=sweep_conf) as door:
    swept, swept_first, swept_wall = _sse_clients(fd_lib, door, prompts,
                                                  "s")
  log(f"   (20e) the same clients, the front door driving the sweep: "
      f"{swept_wall:.2f} s wall; TTFT p50 client-observed "
      f"{statistics.median(swept_first.values()) * 1e3:.1f} ms, at the "
      f"router "
      f"{statistics.median(router_first[f's{i}'] - at_router[f's{i}'] for i in swept) * 1e3:.1f}"
      f" ms, the engines' "
      f"{router.fleet_summary()['ttft_p50_s'] * 1e3:.1f} ms")
  router.submit = submit
  router.close()
  reset_observability()
  return launches


def self_healing_fleet(torch, params, pa, refs):
  """Phase 20: the self-healing fleet at GPT-350M width.  Returns the
  tiled build's launches by part."""
  launches = {}
  t0 = time.monotonic()
  launches["self_heal"] = heal_autotune(torch, params, pa)
  log(f"   (20a) {time.monotonic() - t0:.1f} s")
  t0 = time.monotonic()
  heal_golden(torch, params)
  log(f"   (20b) {time.monotonic() - t0:.1f} s")
  t0 = time.monotonic()
  launches.update(heal_rollout(torch, params, pa))
  log(f"   (20c) {time.monotonic() - t0:.1f} s")
  t0 = time.monotonic()
  launches["reactor_children"] = heal_reactor(torch, params, pa, refs)
  log(f"   (20d) {time.monotonic() - t0:.1f} s")
  t0 = time.monotonic()
  launches["frontdoor"] = heal_frontdoor(torch, params, pa)
  log(f"   (20e) {time.monotonic() - t0:.1f} s")
  return launches


# ------------------------------------------------ 21. tensor-parallel mesh

TP = 2                       # ranks of the model axis (phase 21)
# Each spawned group's deadline, and phase 21's wall limit: a hung
# collective fails the phase instead of the script's time limit.
TP_SPAWN_DEADLINE_S, TP_PHASE_WALL_S = 600, 900
# 21c: 2 steps (a step over gloo is ~10 s a rank): the first loss holds
# the TP forward, the second the TP backward and one AdamW update.
TP_TRAIN_BATCH, TP_TRAIN_STEPS = 16, 2
# ... at the serving phases' depth (the script's time; the serving
# weights' blocks).
TP_TRAIN_LAYERS = SERVE_LAYERS
# bf16 losses of two runs whose sums are taken in another order (the
# row-parallel all-reduces, the vocab-parallel normaliser, a per-rank
# batch): one bf16 spacing, 2^-8, relative.
TP_LOSS_RTOL = 2.0 ** -8
# 21a's collectives: each rank holds two rows of X; the rings multiply
# by W.
TP_COLLECTIVE_X = np.arange(4 * 6, dtype=np.float32).reshape(4, 6) + 1.0
TP_COLLECTIVE_W = np.arange(6 * 3, dtype=np.float32).reshape(6, 3) / 7
# Phase 21d: GPT-350M widths cut to 4 layers, 8 sequences, 3 steps.
DP_LAYERS, DP_BATCH, DP_STEPS = 4, 8, 3
# The overlap ring against the fused all-reduce, bf16, by normalized
# error: the output and the input gradient add the same two partial
# products as the all-reduce (one bf16 spacing, 2^-8); the weight
# gradient's two row-block products are each rounded to bf16 before
# they add, where the fused product rounds once (four spacings, 2^-6).
RING_BF16_LIMIT = {"y": 2.0 ** -8, "dx": 2.0 ** -8, "dw": 2.0 ** -6}


def tp_backend(torch):
  """21a: whether NCCL takes two ranks on this machine (on one card it is
  expected to refuse), and the backend phase 21 then names: NCCL if it
  did, else gloo over CUDA tensors (the port stages them through host
  memory).  No quiet switch: the outcome is printed.  A probe whose ranks
  abort (a native error outside Python) counts as a refusal and is printed
  as one."""
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import WorkerError, spawn
  try:
    probe = spawn(tp_workers.nccl_probe, TP, (), timeout_s=180)
  except WorkerError as e:
    probe = [f"ranks aborted: {str(e).splitlines()[0][:200]}"]
  ok = all(r.startswith("ok") for r in probe)
  backend = "nccl" if ok else "gloo"
  log(f"   NCCL with {TP} ranks on {torch.cuda.device_count()} card(s): "
      f"{'accepted' if ok else 'refused'} ({probe[0]}); phase 21 runs "
      f"backend={backend}")
  return backend, probe[0]


def tp_numpy_collectives(x, w):
  """What each collective of ``tp_workers.chip_tp_suite`` gives rank r
  of ``TP`` (rows of ``x`` split over the ranks), in numpy."""
  blocks = np.split(x, TP)
  out = []
  for r in range(TP):
    s = sum(blocks)
    rec = {"all_reduce_sum": s, "all_reduce_max": np.max(blocks, 0),
           "all_reduce_min": np.min(blocks, 0),
           "all_reduce_mean": s / TP, "all_reduce_prod": np.prod(blocks, 0),
           "all_gather": x, "reduce_scatter": TP * blocks[r],
           "broadcast": blocks[1],
           "reduce": s if r == 1 else np.zeros_like(s),
           "ring_shift": blocks[(r - 1) % TP],
           "all_to_all": np.split(x, TP, axis=1)[r],
           "all_gather_matmul_ring": x @ w,
           "matmul_reduce_scatter_ring": np.split(
               sum(b @ w for b in blocks), TP)[r]}
    out.append(rec)
  return out


def tp_check_collectives_and_ring(torch, ranks, backend, dense):
  """21a: every collective on CUDA tensors over ``backend`` against numpy
  (SUM of integer-valued floats exact, the rest rtol 1e-6); 21e: the
  row-parallel Dense through the overlap ring against ``overlap="off"``
  (``RING_BF16_LIMIT``)."""
  x, w = TP_COLLECTIVE_X, TP_COLLECTIVE_W
  want = tp_numpy_collectives(x, w)
  exact = {"all_reduce_sum", "all_gather", "reduce_scatter", "broadcast",
           "reduce", "ring_shift", "all_to_all", "all_reduce_max",
           "all_reduce_min"}
  for r in range(TP):
    for op, expect in want[r].items():
      got = ranks[r]["collectives"][op].reshape(expect.shape)
      if op in exact:
        np.testing.assert_array_equal(got, expect, err_msg=f"{op} rank {r}")
      else:
        np.testing.assert_allclose(got, expect, rtol=1e-6,
                                   err_msg=f"{op} rank {r}")
  log(f"   21a. {len(want[0])} collectives on CUDA tensors over {backend} "
      f"equal numpy on both ranks (SUM exact, the rest rtol 1e-6)")
  worst = {}
  for r in range(TP):
    on, off = ranks[r]["ring"]["on"], ranks[r]["ring"]["off"]
    for key in ("y", "dx", "dw"):
      rel = normalized_errors(torch.from_numpy(on[key]),
                              torch.from_numpy(off[key]))
      worst[key] = max(worst.get(key, (0.0, 0.0)), rel)
      assert max(rel) <= RING_BF16_LIMIT[key], (key, r, rel)
  log(f"   21e. row-parallel Dense {dense['rows']}x{dense['d_in']} -> "
      f"{dense['d_out']} bf16, overlap ring against overlap=off "
      f"(rel_l2, max_rel): " + ", ".join(f"{k} ({v[0]:.2e}, {v[1]:.2e})"
                                        for k, v in worst.items())
      + f" (limits {RING_BF16_LIMIT}); ms a call on rank 0: ring "
      f"{ranks[0]['ring']['on']['ms']:.2f}, fused "
      f"{ranks[0]['ring']['off']['ms']:.2f} (two ranks on one card, "
      f"{backend})")
  return {"ring_rel": worst, "ring_ms": ranks[0]["ring"]["on"]["ms"],
          "fused_ms": ranks[0]["ring"]["off"]["ms"]}


def tp_kernels_at_rank_shapes(torch, pa, fa):
  """K2 and K1 at the per-rank shapes the TP paths launch (H / tp = 8
  heads): the tiled paged build at ``engine_step`` and the three flash
  kernels at B=16, H=8, S=1024, D=64, bf16 causal, each against its
  plain version and timed beside it, its bound and the library
  yardstick."""
  H = GPT_350M["num_heads"] // TP
  cases = [engine_step_case(torch, torch.bfloat16, 300 + i, H=H)
           for i in range(4)]
  sets = [args for args, _ in cases]
  kernel_sets = [(*args, paged_tiles(pa, args, runs))
                 for args, runs in cases]
  want = pa.paged_attention_reference(*sets[0])
  got = pa.paged_attention_cuda(*kernel_sets[0])
  torch.cuda.synchronize()
  paged_err = (got.float() - want.float()).abs().max().item()
  torch.testing.assert_close(got.float(), want.float(),
                             rtol=TOLERANCE["bfloat16"],
                             atol=TOLERANCE["bfloat16"])
  bound, bound_by = paged_bound(torch, *[sets[0][i] for i in (0, 1, 3, 4)])
  lib = lambda *a: library_paged_attention(torch, *a)  # noqa: E731
  paged = dict(kernel_ms=time_ms(torch, pa.paged_attention_cuda,
                                 kernel_sets),
               plain_ms=time_ms(torch, pa.paged_attention_reference, sets,
                                reps=3),
               library_ms=time_ms(torch, lib, sets, reps=3),
               bound_ms=bound, bound_by=bound_by, max_abs_err=paged_err)
  log(f"   K2 tiled build at engine_step, H={H} hd=64 bf16: "
      + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                  for k, v in paged.items()))
  shape = dict(B=FLASH_BENCH_SHAPE["B"], H=H, S=FLASH_BENCH_SHAPE["S"],
               D=FLASH_BENCH_SHAPE["D"])
  sdpa = torch.nn.functional.scaled_dot_product_attention
  sets, graphs = [], []
  for i in range(2):
    q, k, v, dout = flash_case(torch, torch.bfloat16, 400 + i, **shape)
    out, lse = fa.flash_fwd_cuda(q, k, v, True)
    delta = (dout.float() * out.float()).sum(-1)
    sets.append((q, k, v, dout, lse, delta))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    graphs.append((sdpa(*leaves, is_causal=True), leaves, dout))
  q, k, v, dout, lse, delta = sets[0]
  want_out, want_lse = fa.flash_fwd_reference(q, k, v, True)
  got = {"fwd": (fa.flash_fwd_cuda(q, k, v, True)[0], want_out)}
  dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, dout, want_lse, delta, True)
  wdk, wdv = fa.flash_bwd_dkv_reference(q, k, v, dout, want_lse, delta,
                                        True)
  got["dkv"] = (torch.cat([dk, dv]), torch.cat([wdk, wdv]))
  got["dq"] = (fa.flash_bwd_dq_cuda(q, k, v, dout, want_lse, delta, True),
               fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                         True))
  torch.cuda.synchronize()
  bounds = flash_bounds(itemsize=2, **shape)

  def sdpa_bwd(out, leaves, dout):
    return torch.autograd.grad(out, leaves, dout, retain_graph=True)

  fwd_args = [(q, k, v, True) for q, k, v, *_ in sets]
  bwd_args = [(*a, True) for a in sets]
  library_bwd = time_ms(torch, sdpa_bwd, graphs, reps=5)
  fns = {"fwd": (fa.flash_fwd_cuda, fa.flash_fwd_reference, fwd_args),
         "dkv": (fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_reference,
                 bwd_args),
         "dq": (fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_reference, bwd_args)}
  flash = {}
  for name, (g, w) in got.items():
    rel = normalized_errors(g, w)
    limit = FLASH_BF16_LIMIT["fwd" if name == "fwd" else "grad"]
    assert rel[0] <= limit["rel_l2"] and rel[1] <= limit["max_rel"], (
        name, rel, limit)
    kernel, plain, args = fns[name]
    flash[name] = dict(
        kernel_ms=time_ms(torch, kernel, args),
        plain_ms=time_ms(torch, plain, args, reps=3),
        library_ms=(time_ms(torch, lambda q, k, v, c: sdpa(
            q, k, v, is_causal=c), fwd_args, reps=5)
                    if name == "fwd" else library_bwd),
        bound_ms=bounds[name][0], bound_by=bounds[name][1],
        max_abs_err=(g.float() - w.float()).abs().max().item(),
        rel_l2=rel[0], max_rel=rel[1])
    log(f"   K1 {name:4s} B=16 H={H} S=1024 D=64 bf16 causal: "
        + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in flash[name].items()))
  return paged, flash


def tp_serving_runs(V):
  """21b's three loads: phase 5's (plain), repeating spans (the n-gram
  drafter) and a shared 256-token system prompt (the prefix cache)."""
  r = np.random.RandomState(5)
  system = r.randint(0, V, (256,)).astype(np.int32)
  shared = [np.concatenate([system, r.randint(0, V, (n,))]).astype(np.int32)
            for n in r.randint(32, 257, 16)]
  waves = [(0, 8), (8, 12), (12, 16)]
  return {"plain": (make_prompts(2, 16, V), waves, 3, 0, False),
          "ngram": (repeating_prompts(7, 16, V), waves, 3, SPEC_K, False),
          "prefix_cache": (shared, [(0, 1), (1, 16)], 2, 0, True)}


def tp1_serving(torch, params, pa, runs, engine_kwargs):
  """The tp = 1 engine on each of 21b's loads, in this process."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, NgramDrafter)
  from easyparallellibrary_tpu_torch.testing import tp_workers
  model = GPT(GPTConfig(**GPT_SERVE, dtype=torch.bfloat16))
  one = {}
  for name, (prompts, wv, between, k, prefix) in runs.items():
    eng = ContinuousBatchingEngine(
        model, params, paged=True, prefix_cache=prefix, stats=ServingStats(),
        drafter=NgramDrafter(k=k) if k else None, **engine_kwargs)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = tp_workers.lead_waves(eng, prompts, wv, between)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    one[name] = dict(streams=out, stats=eng.stats.summary(), steps=eng.steps,
                     host_ms_per_step=wall / eng.steps * 1e3,
                     params=eng.params)
    del eng
  return model, one


def tp_check_serving(torch, model, one, ranks, runs, backend):
  """21b: each TP = 2 run's streams against the tp = 1 engine's by the
  bf16 gap rule; the tiled kernel's launches on each rank SERVE_LAYERS x engine
  steps (counts set to 0 just before each run); tokens/s, TTFT p50 and
  host ms a step beside tp = 1's.  Returns the launches by run and
  rank."""
  L = SERVE_LAYERS
  launches = {}
  for name, (prompts, *_rest) in runs.items():
    lead = ranks[0]["serving"][name]
    for rank in range(TP):
      rec = ranks[rank]["serving"][name]
      assert rec["steps"] == lead["steps"] > 0, (name, rank, rec["steps"])
      assert rec["tiled_launches"] == L * rec["steps"], (name, rank)
      assert rec["all_launches"] == rec["tiled_launches"], (name, rank)
      assert rec["plain_calls"] == 0, (name, rank)
      assert rec["kv_heads"] == GPT_350M["num_heads"] // TP
    launches[name] = [ranks[rank]["serving"][name]["tiled_launches"]
                      for rank in range(TP)]
    s1, s2 = one[name]["stats"], lead["stats"]
    log(f"   21b. {name}: tp=2 {lead['steps']} steps, tokens/s "
        f"{s2['tokens_per_s']:.1f}, TTFT p50 {s2['ttft_p50_s'] * 1e3:.1f} ms, "
        f"host ms a step {lead['host_ms_per_step']:.2f}; tp=1 "
        f"{one[name]['steps']} steps, tokens/s {s1['tokens_per_s']:.1f}, "
        f"TTFT p50 {s1['ttft_p50_s'] * 1e3:.1f} ms, host ms a step "
        f"{one[name]['host_ms_per_step']:.2f} (two ranks time-share one "
        f"card over {backend}: a correctness check, not a scaling number)")
    log(f"   21b. {name}: tiled launches per rank {launches[name]} = {L} "
        f"layers x {lead['steps']} steps; plain-version calls 0"
        + (f"; prefix hits {lead['prefix_hits']}" if name == "prefix_cache"
           else "") + (f"; drafted {lead['drafted']}" if name == "ngram"
                       else ""))
    if name == "prefix_cache":
      assert lead["prefix_hits"] > 0
    if name == "ngram":
      assert lead["drafted"] > 0
    greedy_vs_generate(torch, model, one[name]["params"], prompts,
                       lead["streams"], bf16_gap_limit, f"tp=2 {name}",
                       refs=dict(one[name]["streams"]),
                       ref_name="the tp = 1 engine")
  return launches


def tp_check_training(ranks, one, backend):
  """21c: ``bench.py``'s step at TP_TRAIN_LAYERS layers, tp = 2 against
  tp = 1: the losses within ``TP_LOSS_RTOL``, each rank's flash launches
  layers x steps per kernel, its peak memory and step ms."""
  L = TP_TRAIN_LAYERS
  recs = [r["training"] for r in ranks]
  for rank, rec in enumerate(recs):
    np.testing.assert_allclose(rec["losses"], one["losses"],
                               rtol=TP_LOSS_RTOL, err_msg=f"rank {rank}")
    assert all(np.isfinite(rec["losses"]))
    assert rec["heads_per_rank"] == GPT_350M["num_heads"] // TP
    assert all(n == L * TP_TRAIN_STEPS for n in rec["launches"].values()), (
        rank, rec["launches"])
    assert rec["plain_calls"] == 0
  gap = max(abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"],
                                                one["losses"]))
  log(f"   21c. tp=1 losses {[round(x, 5) for x in one['losses']]}; tp=2 "
      f"{[round(x, 5) for x in recs[0]['losses']]} (largest relative gap "
      f"{gap:.2e}, limit {TP_LOSS_RTOL:.2e})")
  for rank, rec in enumerate(recs):
    log(f"   21c. tp=2 rank {rank}: flash launches {rec['launches']} = {L} "
        f"layers x {TP_TRAIN_STEPS} steps; peak {rec['peak_gib']:.2f} GiB; "
        f"step ms {[round(x, 1) for x in rec['step_ms']]}")
  log(f"   21c. tp=1: peak {one['peak_gib']:.2f} GiB; step ms "
      f"{[round(x, 1) for x in one['step_ms']]} (tp=2: two ranks "
      f"time-share one card over {backend})")
  return [rec["launches"] for rec in recs]


def tp_check_data_parallel(ranks, one, backend):
  """21d: explicit DP = 2 with 8 MB fusion buckets and ZeRO-1 at DP = 2
  against one process within ``TP_LOSS_RTOL``; ZeRO-1's per-rank moment
  bytes half of DP's."""
  for rank in range(TP):
    dp, zero = ranks[rank]["explicit"], ranks[rank]["zero1"]
    for label, rec in (("explicit DP", dp), ("ZeRO-1", zero)):
      np.testing.assert_allclose(rec["losses"], one["losses"],
                                 rtol=TP_LOSS_RTOL,
                                 err_msg=f"{label} rank {rank}")
    assert zero["moment_bytes"] * 2 == dp["moment_bytes"], (
        zero["moment_bytes"], dp["moment_bytes"])
  dp, zero = ranks[0]["explicit"], ranks[0]["zero1"]
  log(f"   21d. one process {[round(x, 5) for x in one['losses']]}; "
      f"explicit DP=2 {[round(x, 5) for x in dp['losses']]}; ZeRO-1 DP=2 "
      f"{[round(x, 5) for x in zero['losses']]} (rtol {TP_LOSS_RTOL:.2e})")
  log(f"   21d. moment bytes per rank: DP {dp['moment_bytes'] / 2**20:.1f} "
      f"MiB, ZeRO-1 {zero['moment_bytes'] / 2**20:.1f} MiB; step ms rank "
      f"0: one process {[round(x, 1) for x in one['step_ms']]}, DP "
      f"{[round(x, 1) for x in dp['step_ms']]}, ZeRO-1 "
      f"{[round(x, 1) for x in zero['step_ms']]} ({backend}, two ranks on "
      f"one card)")


def tensor_parallel_mesh(torch, pa, fa, params, pipeline=False, p23=None,
                         p24=None, p26_root=None):
  """Phase 21 (module docstring): the backend probe; K1 and K2 at the
  per-rank shapes; the tp = 1 references in this process; then every TP
  = 2, DP = 2 and ZeRO-1 run in one group of two ranks
  (``testing.tp_workers.chip_tp_suite``), each rank started once; with
  ``pipeline``, phase 22's runs in the same group after them (the
  reference made here, the checks by ``pipeline_phase``); with ``p23``
  (``phase23_parent``'s), phase 23b and 23c's runs after those; with
  ``p24`` (``phase24_parent``'s), phase 24c and 24e's; with ``p26_root``
  (a directory for its checkpoints), phase 26's last.  Returns what the
  kernels line carries."""
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  t0 = time.monotonic()
  with Phase("21a. backend probe"):
    backend, probe = tp_backend(torch)
  with Phase("21 K1 and K2 at the per-rank shapes (H = 8)"):
    paged, flash = tp_kernels_at_rank_shapes(torch, pa, fa)
  V = GPT_350M["vocab_size"]
  runs = tp_serving_runs(V)
  engine_kwargs = dict(num_slots=NUM_SLOTS, prefill_chunk=PREFILL_CHUNK,
                       block_size=BLOCK_SIZE)
  train_cfg = dict(GPT_350M, num_layers=TP_TRAIN_LAYERS, dtype="bfloat16",
                   remat=True, remat_policy="dots_flash",
                   attn_impl="pallas_flash", loss_chunk=256)
  batch = np.random.RandomState(0).randint(
      0, V, (TP_TRAIN_BATCH, GPT_350M["max_seq_len"] + 1))
  dp_cfg = dict(train_cfg, num_layers=DP_LAYERS)
  r = np.random.RandomState(1)
  dp_batches = [r.randint(0, V, (DP_BATCH, GPT_350M["max_seq_len"] + 1))
                for _ in range(DP_STEPS)]
  with Phase("21 the tp = 1 references (serving, training, one process)"):
    model, one_serving = tp1_serving(
        torch, depth_cut(params, SERVE_LAYERS), pa, runs, engine_kwargs)
    mesh = tp_workers.setup("", device="cuda")
    one_training = tp_workers.train_steps(mesh, train_cfg, params, batch,
                                          TP_TRAIN_STEPS)
    one_dp = tp_workers.dp_steps(mesh, "implicit", dp_cfg, dp_batches)
  gc.collect()
  torch.cuda.empty_cache()
  pp = None
  if pipeline:
    with Phase("22 the one-process reference (in phase 21's group)"):
      t_pp = time.monotonic()
      pp = pipeline_spec(torch, params, batch)
      pp_ref_s = time.monotonic() - t_pp
  dense = dict(rows=TP_TRAIN_BATCH * 1024, d_in=4096, d_out=1024, seed=3)
  spec = {"collectives": (TP_COLLECTIVE_X, dense),
          "row_dense": ROW_DENSE_SIZES,
          "serving": (dict(GPT_350M, dtype="bfloat16"), 0, runs,
                      engine_kwargs, SERVE_LAYERS),
          "training": (train_cfg, batch, TP_TRAIN_STEPS),
          "dp": (dp_cfg, dp_batches,
                 {"communication.fusion_threshold_mb": 8})}
  if pp is not None:
    spec["pipeline"] = pp[1]
  if p23 is not None:
    spec.update(p23["spec"])
  if p24 is not None:
    spec["p24"] = p24["spec"]
  p26 = None
  if p26_root is not None:
    spec["p26"] = p26 = phase26_spec(p26_root, backend)
  with Phase(f"21 TP = 2 serving and training, DP = 2, ZeRO-1 and the "
             f"ring" + (", then 22's pipeline runs" if pp else "")
             + (", then 23b and 23c" if p23 else "")
             + (", then 24c and 24e" if p24 else "")
             + (", then 26a-c" if p26 else "")
             + ": two ranks, one group"):
    ranks = spawn(tp_workers.chip_tp_suite, TP, (backend, spec),
                  timeout_s=TP_SPAWN_DEADLINE_S)
  ring = tp_check_collectives_and_ring(torch, ranks, backend, dense)
  serving = tp_check_serving(torch, model, one_serving, ranks, runs, backend)
  training = tp_check_training(ranks, one_training, backend)
  tp_check_data_parallel(ranks, one_dp, backend)
  wall = time.monotonic() - t0
  pp_launches = None
  if pp is not None:
    pp_wall = pp_ref_s + max(r["pipeline"]["wall_s"] for r in ranks)
    wall -= pp_wall
    with Phase("22. the pipeline (S = 2, M = 4) on phase 21's ranks"):
      pp_launches = pipeline_phase(torch, fa, params, (ranks, pp[0]),
                                   backend)
    log(f"   22. wall {pp_wall:.1f} s (reference {pp_ref_s:.1f} s, the "
        f"slower rank's runs {pp_wall - pp_ref_s:.1f} s)")
    assert pp_wall < PP_PHASE_WALL_S, f"phase 22 took {pp_wall:.0f} s"
  p23_launches = None
  if p23 is not None:
    group_s = max(r["p23_wall_s"] for r in ranks)
    wall -= group_s
    with Phase("23b, 23c on phase 21's ranks: checks"):
      p23_launches = phase23_checks(ranks, p23)
    log(f"   23b, 23c. wall {group_s:.1f} s on the slower rank")
    p23["group_wall_s"] = group_s
  p24_launches = None
  if p24 is not None:
    group_s = max(r["p24"]["wall_s"] for r in ranks)
    wall -= group_s
    t_check = time.monotonic()
    with Phase("24c, 24e on phase 21's ranks: checks"):
      p24_launches = phase24_checks(ranks, p24)
    p24["group_wall_s"] = group_s + time.monotonic() - t_check
    log(f"   24c, 24e. wall {group_s:.1f} s on the slower rank")
  p26_out = None
  if p26 is not None:
    wall -= max(r["p26"]["wall_s"] for r in ranks)
    with Phase("26. sharded checkpoints on phase 21's ranks: checks, the "
               "tp = 1 reload, 26d serving"):
      p26_out = phase26_finish(torch, pa, ranks, p26, backend)
  assert wall < TP_PHASE_WALL_S, f"phase 21 took {wall:.0f} s"
  return dict(backend=backend, nccl_probe=probe, ring=ring, paged=paged,
              flash=flash, serving=serving, training=training,
              pipeline=pp_launches, p23=p23_launches, p24=p24_launches,
              p26=p26_out,
              row_dense_collectives=[r["row_dense_collectives"]
                                     for r in ranks])


# ------------------------------------------------------ 22. the pipeline

PP = 2                       # stage ranks (phase 22)
PP_M, PP_STEPS = 4, 4        # micro-batches; 1 warm + 3 timed steps
PP_PHASE_WALL_S = 400
# The pipeline's losses against one process's: sound runs read 1.7e-5 to
# 3.1e-5 relative over 4 steps (the micro-batch sums in another order);
# 2^-12 leaves 8x room and sits 16x inside one bf16 spacing (2^-8), so a
# stage that learns wrongly shows by the third step.
PP_LOSS_RTOL = 2.0 ** -12
# (name, pipeline.engine, pipeline.strategy, pipeline_interleave)
PP_RUNS = [("smap_gpipe", "smap", "PreferForward", 1),
           ("smap_1f1b", "smap", "PreferBackward", 1),
           ("smap_interleaved", "smap", "PreferBackward", 2),
           ("vmap_1f1b_grouped", "", "PreferBackwardOptimizer", 1)]
# The run that takes one more step under torch.profiler (a profiled
# window costs ~10 s a run in this script's time).
PP_PROFILED = "smap_1f1b"
PP_DISPATCH = {"smap_gpipe": ["smap", "gpipe", None],
               "smap_1f1b": ["smap", "1f1b", None],
               "smap_interleaved": ["smap", "interleaved", None],
               "vmap_1f1b_grouped": ["vmap", "1f1b", PP]}


def pipeline_spec(torch, params, batch):
  """22: the one-process step's losses (the reference) in this process,
  and the ranks' spec.  The pipeline takes no ``loss_chunk`` (the JAX
  package refuses it with stages), so neither does the reference."""
  from easyparallellibrary_tpu_torch.testing import tp_workers
  cfg = dict(GPT_350M, dtype="bfloat16", remat=True,
             remat_policy="dots_flash", attn_impl="pallas_flash")
  mesh = tp_workers.setup("", device="cuda")
  one = tp_workers.train_steps(mesh, cfg, params, batch, PP_STEPS)
  gc.collect()
  torch.cuda.empty_cache()
  log(f"   22. one process: losses {[round(x, 5) for x in one['losses']]}, "
      f"step ms {[round(x, 1) for x in one['step_ms']]}, peak "
      f"{one['peak_gib']:.2f} GiB, flash launches {one['launches']}")
  return one, {"cfg": cfg, "seed": 0, "batch": batch, "M": PP_M,
               "steps": PP_STEPS, "runs": PP_RUNS, "profile": PP_PROFILED}


def pipeline_checks(torch, ranks, one, backend):
  """22: every run on both ranks against the one-process losses
  (``PP_LOSS_RTOL``; every run's gap is printed before any is held),
  K1's launches against the schedule's formula, the plain versions'
  calls 0, the dispatch; K1 at the stage's shape within
  ``FLASH_BF16_LIMIT``.  Returns K1's launches by run and rank."""
  L = GPT_350M["num_layers"]
  launches, held = {}, []
  for rank in range(PP):
    rec = ranks[rank]["pipeline"]
    for k, limit in (("fwd", FLASH_BF16_LIMIT["fwd"]),
                     ("dkv", FLASH_BF16_LIMIT["grad"])):
      rel = rec["kernels"][k]
      assert rel[0] <= limit["rel_l2"] and rel[1] <= limit["max_rel"], (
          rank, k, rel, limit)
    log(f"   22. rank {rank}: K1 at the stage's shape (B={16 // PP_M} "
        f"H=16 S=1024 D=64 bf16 causal) against the plain version "
        f"(rel_l2, max_rel): fwd {rec['kernels']['fwd']}, dkv "
        f"{rec['kernels']['dkv']}; rank wall {rec['wall_s']:.1f} s")
  for name, *_ in PP_RUNS:
    launches[name] = []
    for rank in range(PP):
      run = ranks[rank]["pipeline"]["runs"][name]
      held.append((f"{name} rank {rank}", run["losses"]))
      assert run["launches"] == run["formula"], (name, rank, run)
      assert run["plain_calls"] == 0, (name, rank)
      assert list(run["dispatch"]) == PP_DISPATCH[name], (name, run)
      launches[name].append(run["launches"])
      gap = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                    one["losses"]))
      log(f"   22. {name} rank {rank}: losses "
          f"{[round(x, 5) for x in run['losses']]} (largest relative gap "
          f"{gap:.2e}, limit {PP_LOSS_RTOL:.2e}); step ms "
          f"{[round(x, 1) for x in run['step_ms']]} (warm "
          f"{run['warm_ms']:.1f}); peak {run['peak_gib']:.2f} GiB; K1 "
          f"launches {run['launches']} = formula over {PP_STEPS} steps "
          f"({L // PP} layers x {PP_M} micro-batches"
          + (", forwards doubled by stage remat" if run["launches"]["fwd"]
             > run["launches"]["dkv"] else "")
          + f"); staged through the host {run['staged_bytes_per_step'] / 2**20:.1f}"
          f" MiB a step, of it hops {run['hop_bytes_per_step'] / 2**20:.1f} "
          f"MiB; {run['ticks']} ticks; bubble_fraction({PP}, {PP_M}) = "
          f"{run['bubble_fraction']:.3f} ({backend}, two ranks on one card)")
      prof = run.get("profiled")
      if prof is None:
        continue
      assert prof["device_busy_ms"] > 0, (name, rank, prof)
      log(f"   22. {name} rank {rank}, one more step under torch.profiler: "
          f"host wall {prof['wall_ms']:.1f} ms, this rank's device busy "
          f"{prof['device_busy_ms']:.1f} ms (of it copies "
          f"{prof['copy_ms']:.1f}), idle share "
          f"{1 - prof['device_busy_ms'] / prof['wall_ms']:.3f}")
  for what, losses in held:
    np.testing.assert_allclose(losses, one["losses"], rtol=PP_LOSS_RTOL,
                               err_msg=what)
  return launches


def pipeline_phase(torch, fa, params, ranks=None, backend=None):
  """Phase 22 alone (``--phases 22``: its own group of two ranks), or
  the checks of the pipeline runs phase 21's group made."""
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  t0 = time.monotonic()
  if ranks is None:
    backend = "gloo"
    batch = np.random.RandomState(0).randint(
        0, GPT_350M["vocab_size"], (TP_TRAIN_BATCH,
                                    GPT_350M["max_seq_len"] + 1))
    with Phase("22 the one-process reference"):
      one, spec = pipeline_spec(torch, params, batch)
    with Phase("22 the pipeline runs: two stage ranks, one group"):
      ranks = spawn(tp_workers.chip_tp_suite, PP, (backend, {
          "pipeline": spec}), timeout_s=TP_SPAWN_DEADLINE_S)
  else:
    ranks, one = ranks
  launches = pipeline_checks(torch, ranks, one, backend)
  wall = time.monotonic() - t0
  assert wall < PP_PHASE_WALL_S, f"phase 22 took {wall:.0f} s"
  return launches



# ---------------------------- 23. MoE, sequence parallelism, ZeRO + pipe

# BASELINE.md row 5 (benchmarks/single_chip_models.py's GPT-MoE): 12
# layers at GPT-350M widths, 8 experts in every 2nd block, top-1,
# capacity factor 1.25, the einsum path on one card.
MOE_CFG = dict(GPT_350M, num_layers=12, num_experts=8, moe_every=2,
               moe_top_k=1, capacity_factor=1.25, moe_impl="einsum",
               dtype="bfloat16", remat=True, remat_policy="dots_flash",
               attn_impl="pallas_flash", loss_chunk=256)
MOE_BATCH, MOE_STEPS, MOE_A2A_STEPS = 8, 4, 2    # 23a: 1 warm + 3 timed
# GPT-350M (bench.py's widths and 24 layers) at 4096 tokens, batch 2.
SEQ_CFG = dict(GPT_350M, max_seq_len=4096, dtype="bfloat16", remat=True,
               remat_policy="dots_flash", loss_chunk=256)
SEQ_BATCH, SEQ_STEPS, SEQ_WPE_SEED = 2, 2, 23
SEQ_RUNS = [("ring_zigzag", "ring", "zigzag"),
            ("ring_contiguous", "ring", "contiguous"),
            ("ulysses", "ulysses", "zigzag")]
# GPT-350M widths at 4 layers, 8 x 1024, two stages of M = 2, 2 steps.
PZ_CFG = dict(GPT_350M, num_layers=4, dtype="bfloat16", remat=True,
              remat_policy="dots_flash", attn_impl="pallas_flash")
PZ_BATCH, PZ_M, PZ_STEPS, PZ_WORLD = 8, 2, 2, 4
# The a2a losses against one card: within one bf16 spacing (2^-8
# relative); ZeRO against the same pipeline without it: 2^-12, phase
# 22's rule; the sequence-parallel losses against one process: 2^-13
# (sound runs read <= 2.55e-5; a ring backward that keeps dK / dV on the
# computing rank reads 2.6e-4 for the contiguous layout, 9.8e-4 zigzag).
A2A_LOSS_RTOL, PZ_LOSS_RTOL, SEQ_LOSS_RTOL = 2.0 ** -8, 2.0 ** -12, 2.0 ** -13
# 23b's forward against the one-card einsum run on each rank's rows
# alone (the same routing, the same tokens): every MoE block's drops
# equal, its outputs within 2^-10 normalized L2 and the cross-entropy
# within 2^-16 (sound runs read 0 and 4.5e-9; an a2a that skips the
# return exchange reads outputs off by 0.25-1.19).
A2A_OUT_RTOL, A2A_CE_RTOL = 2.0 ** -10, 2.0 ** -16
P23_WALL_S = 400


def moe_one_card(torch, fa, bench, moe_params):
  """23a: the GPT-MoE through ``bench.build_training`` (``epl.init`` ->
  ``parallelize(make_train_step(gpt_loss))``) from ``moe_params``
  (``init_params(seed 0)``), MOE_STEPS steps on its batch: losses, the
  aux loss, ms, tokens/s, MFU, peak, the tokens dropped at step 1 (the
  dispatch masks'; at random init the routers concentrate and drop a
  large share, in the JAX package too:
  tests/test_torch_moe.py::test_router_at_init_concentrates_in_both_packages),
  K1's launches (12 a kernel a step) with the plain versions never
  called.  Then 23b's per-source reference: one forward from
  ``moe_params`` on each a2a rank's rows alone
  (``sp_workers.moe_forward_probe``), whose capacity is that rank's
  per-source one.  Returns the record, the batch and the reference."""
  from easyparallellibrary_tpu_torch.models.gpt import (
      GPTConfig, gpt_flops_per_token)
  from easyparallellibrary_tpu_torch.testing import sp_workers
  from easyparallellibrary_tpu_torch.runtime.zero import moment_bytes
  cfg = GPTConfig(**dict(MOE_CFG, dtype=torch.bfloat16))
  torch.backends.cuda.matmul.allow_tf32 = False
  state, step, batch, _, mesh = bench.build_training(
      cfg, MOE_BATCH, "cuda", seed=0, params=moe_params)
  dev = mesh.device
  moe = [m for m in state.apply_fn.modules() if hasattr(m, "last_dropped")]
  torch.cuda.synchronize(dev)
  torch.cuda.reset_peak_memory_stats(dev)
  fa.reset_counts()
  losses, aux, ms, dropped = [], [], [], None
  for i in range(MOE_STEPS):
    t0 = time.perf_counter()
    state, m = step(state, batch, None)
    losses.append(float(m["loss"]))
    aux.append(float(m["moe_aux_loss"]))
    torch.cuda.synchronize(dev)
    ms.append((time.perf_counter() - t0) * 1e3)
    if i == 0:
      dropped = int(sum(int(x.last_dropped) for x in moe))
  launches = {"fwd": fa.flash_fwd_cuda.launches,
              "dkv": fa.flash_bwd_dkv_cuda.launches,
              "dq": fa.flash_bwd_dq_cuda.launches}
  plain = (fa.flash_fwd_reference.calls + fa.flash_bwd_dkv_reference.calls
           + fa.flash_bwd_dq_reference.calls)
  tokens = MOE_BATCH * cfg.max_seq_len
  step_s = statistics.median(ms[1:]) / 1e3
  ex = {id(p) for n, p in state.params.items()
        if n.endswith(("moe.wi", "moe.wo"))}
  ex_bytes = sum(v.numel() * v.element_size()
                 for p, st in state.opt_state.state.items() if id(p) in ex
                 for v in st.values() if torch.is_tensor(v) and v.dim())
  rec = {"losses": losses, "moe_aux_loss": aux, "warm_ms": ms[0],
         "step_ms": ms[1:], "tokens_per_s": tokens / step_s,
         "mfu": gpt_flops_per_token(cfg) * tokens / step_s
         / PEAK_OPS_PER_S["bfloat16"],
         "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
         "dropped_step1": dropped, "launches": launches, "plain_calls": plain,
         "params": sum(p.numel() for p in state.params.values()),
         "moment_bytes": moment_bytes(state.opt_state),
         "expert_moment_bytes": ex_bytes}
  log(f"   23a. GPT-MoE one card: losses {[round(x, 5) for x in losses]}, "
      f"aux {[round(x, 4) for x in aux]}, step ms "
      f"{[round(x, 1) for x in ms]}, {rec['tokens_per_s']:.0f} tokens/s, "
      f"MFU {rec['mfu']:.4f}, peak {rec['peak_gib']:.2f} GiB, dropped "
      f"{dropped}, K1 {launches}, {rec['params'] / 1e6:.1f}M params")
  per_step = cfg.num_layers * MOE_STEPS
  assert launches == {"fwd": per_step, "dkv": per_step, "dq": per_step}, \
      launches
  assert plain == 0, plain
  assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
  ids = batch["ids"].numpy()
  rows = MOE_BATCH // TP
  reference = [sp_workers.moe_forward_probe(
      state.apply_fn, moe_params,
      torch.from_numpy(ids[e * rows:(e + 1) * rows]).to(dev))
               for e in range(TP)]
  del state, step, batch, moe
  gc.collect()
  torch.cuda.empty_cache()
  return rec, ids, reference


def seq_reference(torch, params):
  """23c's one-process reference: ``attn_impl="pallas_flash"`` at
  SEQ_CFG from the GPT-350M draw ``params`` with the longer position
  table, SEQ_STEPS steps.  Returns its record and the ranks' spec."""
  from easyparallellibrary_tpu_torch.testing import sp_workers, tp_workers
  batch = np.random.RandomState(SEQ_WPE_SEED).randint(
      0, GPT_350M["vocab_size"], (SEQ_BATCH, SEQ_CFG["max_seq_len"] + 1))
  long = sp_workers.long_context_params(params, SEQ_CFG["max_seq_len"],
                                        SEQ_WPE_SEED)
  mesh = tp_workers.setup("", device="cuda")
  one = tp_workers.train_steps(mesh, dict(SEQ_CFG, attn_impl="pallas_flash"),
                               long, batch, SEQ_STEPS)
  del long
  gc.collect()
  torch.cuda.empty_cache()
  log(f"   23c. one process: losses {[round(x, 5) for x in one['losses']]}, "
      f"step ms {[round(x, 1) for x in one['step_ms']]}, peak "
      f"{one['peak_gib']:.2f} GiB, K1 {one['launches']}")
  return one, {"cfg": SEQ_CFG, "seed": 0, "wpe_seed": SEQ_WPE_SEED,
               "batch": batch, "steps": SEQ_STEPS, "runs": SEQ_RUNS}


def phase23_parent(torch, fa, bench, params, moe_params):
  """23a and 23c's reference in this process; the specs of 23b and 23c
  for the ranks."""
  t0 = time.monotonic()
  with Phase("23a. GPT-MoE (BASELINE row 5) on one card"):
    moe, ids, reference = moe_one_card(torch, fa, bench, moe_params)
  with Phase("23c the one-process reference (4096 tokens)"):
    seq_one, seq_spec = seq_reference(torch, params)
  with Phase("23b the GPT-MoE weights to a file for the ranks"):
    # The ranks load 23a's draw (seconds) instead of drawing it again.
    fd, path = tempfile.mkstemp(prefix="epl_phase23_moe_", suffix=".pt")
    os.close(fd)
    torch.save({k: v.cpu() for k, v in moe_params.items()}, path)
    fd, ref_path = tempfile.mkstemp(prefix="epl_phase23_ref_", suffix=".pt")
    os.close(fd)
    torch.save(reference, ref_path)
  moe_spec = {"cfg": MOE_CFG, "weights": path, "batch": ids,
              "steps": MOE_A2A_STEPS, "reference": ref_path}
  return {"moe": moe, "seq": seq_one, "wall_s": time.monotonic() - t0,
          "spec": {"moe": moe_spec, "sequence": seq_spec}}


def phase23_checks(ranks, p23):
  """23b and 23c on the ranks against 23a and the one-process
  reference.  Returns K1's launches by run."""
  os.remove(p23["spec"]["moe"]["weights"])
  os.remove(p23["spec"]["moe"]["reference"])
  moe = p23["moe"]
  launches = {"moe_one_card": moe["launches"]}
  # Every rank's numbers are printed before any is held.
  for r in ranks:
    c = r["moe"]["per_source"]
    log(f"   23b. a2a rank {r['moe']['coords']['expert']} against one card "
        f"on its rows: MoE outputs rel L2 {c['out_rel_l2']}, max abs "
        f"{c['out_max_abs']}, dropped {c['dropped']} (one card "
        f"{c['dropped_ref']}), CE {c['ce']} (one card {c['ce_ref']}, "
        f"rel {c['ce_rel']:.3e})")
  for r in ranks:
    got = r["moe"]
    log(f"   23b. a2a rank {r['moe']['coords']['expert']}: losses "
        f"{[round(x, 5) for x in got['losses']]}, step ms "
        f"{[round(x, 1) for x in got['step_ms']]}, peak "
        f"{got['peak_gib']:.2f} GiB, dropped {got['dropped_step1']}, "
        f"staged {got['staged_bytes_per_step'] / 2**20:.1f} MiB a step, "
        f"expert moments {got['expert_moment_bytes'] / 2**20:.1f} MiB "
        f"(one card {moe['expert_moment_bytes'] / 2**20:.1f} MiB), K1 "
        f"{got['launches']}, loss rel to one card "
        f"{[f'{abs(a - b) / abs(b):.3e}' for a, b in zip(got['losses'],
                                                          moe['losses'])]}")
  for r in ranks:
    c = r["moe"]["per_source"]
    assert c["dropped"] == c["dropped_ref"], c
    assert max(c["out_rel_l2"]) <= A2A_OUT_RTOL, c
    assert c["ce_rel"] <= A2A_CE_RTOL, c
    got = r["moe"]
    for a, b in zip(got["losses"], moe["losses"]):
      assert abs(a - b) <= A2A_LOSS_RTOL * abs(b), (got["losses"],
                                                   moe["losses"])
    assert got["expert_moment_bytes"] * 2 == moe["expert_moment_bytes"]
    assert got["plain_calls"] == 0
  launches["moe_a2a"] = [r["moe"]["launches"] for r in ranks]
  one = p23["seq"]
  launches["sequence"] = {}
  # Every run's gap is printed before any is held.
  for name, _, _ in SEQ_RUNS:
    for r in ranks:
      got = r["sequence"]["runs"][name]
      i = r["sequence"]["coords"]["seq"]
      gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  one["losses"])]
      log(f"   23c. {name} rank {i}: losses "
          f"{[round(x, 5) for x in got['losses']]} (one process "
          f"{[round(x, 5) for x in one['losses']]}, rel "
          f"{[f'{g:.3e}' for g in gaps]}), step ms "
          f"{[round(x, 1) for x in got['step_ms']]}, peak "
          f"{got['peak_gib']:.2f} GiB, staged "
          f"{got['staged_bytes_per_step'] / 2**20:.1f} MiB a step, K1 "
          f"{got['launches']} (formula {got['formula']} a kernel)")
  for name, _, _ in SEQ_RUNS:
    launches["sequence"][name] = []
    for r in ranks:
      got = r["sequence"]["runs"][name]
      for a, b in zip(got["losses"], one["losses"]):
        assert abs(a - b) <= SEQ_LOSS_RTOL * abs(b), (name, got["losses"],
                                                     one["losses"])
      assert all(v == got["formula"] for v in got["launches"].values()), \
          (name, got["launches"], got["formula"])
      assert got["plain_calls"] == 0
      launches["sequence"][name].append(got["launches"])
  return launches


def pipeline_zero_phase(torch):
  """23d: ZeRO v1 and v0 under the smap 1F1B pipeline on four ranks
  (stage 2 x data 2) in a group of their own, against the same pipeline
  without ZeRO."""
  from easyparallellibrary_tpu_torch.testing import sp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  batch = np.random.RandomState(4).randint(
      0, GPT_350M["vocab_size"], (PZ_BATCH, GPT_350M["max_seq_len"] + 1))
  spec = {"cfg": PZ_CFG, "seed": 0, "batch": batch, "M": PZ_M,
          "steps": PZ_STEPS}
  ranks = spawn(sp_workers.chip_pipeline_zero, PZ_WORLD, ("gloo", spec),
                timeout_s=TP_SPAWN_DEADLINE_S)
  launches = {}
  for r in ranks:
    c = r["coords"]
    runs = r["runs"]
    base = runs["none"]
    for level in ("none", "v1", "v0"):
      got = runs[level]
      log(f"   23d. {level} stage {c['stage']} data {c['data']}: losses "
          f"{[round(x, 6) for x in got['losses']]}, step ms "
          f"{[round(x, 1) for x in got['step_ms']]}, peak "
          f"{got['peak_gib']:.2f} GiB, moments "
          f"{got['moment_bytes'] / 2**20:.1f} MiB "
          f"({got['moment_bytes'] / base['moment_bytes']:.4f} of none), "
          f"staged {got['staged_bytes_per_step'] / 2**20:.1f} MiB a step, "
          f"K1 {got['launches']}")
      for a, b in zip(got["losses"], base["losses"]):
        assert abs(a - b) <= PZ_LOSS_RTOL * abs(b), (level, got["losses"],
                                                    base["losses"])
      assert got["launches"] == got["formula"], (got["launches"],
                                                 got["formula"])
      assert got["plain_calls"] == 0
      if level != "none":
        share = got["moment_bytes"] / base["moment_bytes"]
        assert 0.49 <= share <= 0.51, (level, share)
      launches.setdefault(level, []).append(got["launches"])
  return launches


def phase23_alone(torch, fa, bench, params, moe_params):
  """``--phases 23``: 23a and 23c's reference here, 23b and 23c in a
  group of two ranks of their own, 23d in its group of four."""
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  t0 = time.monotonic()
  p23 = phase23_parent(torch, fa, bench, params, moe_params)
  with Phase("23b, 23c: the a2a MoE and the sequence-parallel runs, two "
             "ranks"):
    ranks = spawn(tp_workers.chip_tp_suite, TP, ("gloo", p23["spec"]),
                  timeout_s=TP_SPAWN_DEADLINE_S)
  launches = phase23_checks(ranks, p23)
  with Phase("23d. ZeRO v1 and v0 under the smap pipeline, four ranks"):
    launches["pipeline_zero"] = pipeline_zero_phase(torch)
  wall = time.monotonic() - t0
  log(f"   23. wall {wall:.1f} s")
  return launches


# --------------------------------------------------- 24. BERT and ResNet

# BASELINE.md rows 1-3 (benchmarks/single_chip_models.py:104-118): BERT-
# Large at its benchmark shape, 8 x 512, bf16, whole-block remat, flash
# attention (non-causal K1); ResNet-50 at 64 x 224 x 224, 1000 classes.
BERT_CFG = dict(vocab_size=30528, num_layers=24, num_heads=16, d_model=1024,
                d_ff=4096, max_seq_len=512, dtype="bfloat16", remat=True,
                attn_impl="pallas_flash")
# 1 warm-up and 5 timed steps; 76 of 512 tokens masked in every row
# (15%, a fixed count: 24c's micro-batches then hold equal counts);
# AdamW(1e-4, wd 0.01), seeds.
BERT_BATCH, BERT_STEPS, BERT_MASKED, BERT_LR = 8, 5, 76, 1e-4
BERT_SEED, BERT_DATA_SEED = 0, 24
BERT_FP32_LAYERS, BERT_GRAD_LIMIT = 4, 1e-4
# 24b: K1 without the mask at BERT-Large's attention shape.
BERT_FLASH_SHAPE = dict(B=8, H=16, S=512, D=64)
# 24c: two stage ranks, M = 4 (BASELINE row 2), 3 steps, against 24a's
# first 3 (the same weights, batch and optimizer), phase 22's rule.
BERT_PP_M, BERT_PP_STEPS = 4, 3
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS, RESNET_BN_STEPS = 64, 224, 5, 3
RESNET_LR = 1e-3
# 24e: BASELINE row 3, ResNet-50 with a 131072-class head under
# split(2), 32 images, 2 steps, against one process.  AdamW at 1e-4:
# Adam's first step moves each weight by ~lr in its gradient's sign, so
# a near-zero trunk gradient whose sign the bf16 rounding of the head's
# input gradient flips (two partial sums against one) moves by 2 lr; at
# 1e-3 step 2's loss read 2.9e-4 relative from one process (NVIDIA H100
# 80GB HBM3, 700 W), past 2^-12.
SPLIT_CLASSES, SPLIT_BATCH, SPLIT_STEPS, SPLIT_SEED = 131072, 32, 2, 25
SPLIT_LR = 1e-4
P24_LOSS_RTOL = 2.0 ** -12
P24_WALL_S = 150


def bert_config(torch, **over):
  from easyparallellibrary_tpu_torch.models.bert import BertConfig
  kw = dict(BERT_CFG, **over)
  return BertConfig(**dict(kw, dtype=getattr(torch, kw["dtype"])
                           if isinstance(kw["dtype"], str) else kw["dtype"]))


def resnet_cfg(torch, **over):
  from easyparallellibrary_tpu_torch.models.resnet import resnet50_config
  return resnet50_config(**dict(dict(dtype=torch.bfloat16), **over))


def launch_counts(fa):
  return ({"fwd": fa.flash_fwd_cuda.launches,
           "dkv": fa.flash_bwd_dkv_cuda.launches,
           "dq": fa.flash_bwd_dq_cuda.launches},
          fa.flash_fwd_reference.calls + fa.flash_bwd_dkv_reference.calls
          + fa.flash_bwd_dq_reference.calls)


def bert_one_card(torch, fa, params, smi):
  """24a: BERT-Large MLM through ``epl.init`` -> ``replicate`` ->
  ``create_sharded_train_state`` -> ``parallelize(make_bert_train_step)``
  from ``params`` (``init_params(BERT_SEED)``): 1 + BERT_STEPS AdamW
  steps, step ms, tokens/s, MFU (the benchmark's FLOPs a token over
  ``peak_flops_per_chip``), peak memory; K1's launches over every step
  (counts set to 0 just before) against full remat's 2L forwards, L
  dK/dV and L dQ a step."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.bert import (
      Bert, bert_flops_per_token, make_bert_train_step)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.profiler.flops import peak_flops_per_chip
  from easyparallellibrary_tpu_torch.testing.bert_workers import mlm_batch
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = bert_config(torch)
  epl.init(device="cuda")
  with epl.replicate(1):
    model = Bert(cfg)
  mesh = epl.current_plan().build_mesh()
  dev = mesh.device
  state, sh = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=params,
                                tx=adamw(BERT_LR, weight_decay=0.01)), mesh)
  step = make_bert_train_step(model)
  assert step.dispatch == ("autodiff", None, None), step.dispatch
  run = parallelize(step, mesh, sh)
  batch = mlm_batch(cfg.vocab_size, BERT_BATCH, cfg.max_seq_len,
                    BERT_MASKED, BERT_DATA_SEED)
  torch.cuda.synchronize(dev)
  torch.cuda.reset_peak_memory_stats(dev)
  fa.reset_counts()
  losses, ms = [], []
  for _ in range(1 + BERT_STEPS):
    t0 = time.perf_counter()
    state, m = run(state, batch, None)
    losses.append(float(m["loss"]))
    torch.cuda.synchronize(dev)
    ms.append((time.perf_counter() - t0) * 1e3)
  launches, plain = launch_counts(fa)
  n, L = 1 + BERT_STEPS, cfg.num_layers
  tokens = BERT_BATCH * cfg.max_seq_len
  step_s = statistics.median(ms[1:]) / 1e3
  rec = {"losses": losses, "warm_ms": ms[0], "step_ms": ms[1:],
         "tokens_per_s": tokens / step_s,
         "mfu": bert_flops_per_token(cfg) * tokens / step_s
         / peak_flops_per_chip(dev),
         "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
         "launches": launches, "formula": {"fwd": 2 * L * n, "dkv": L * n,
                                           "dq": L * n}}
  log(f"   24a. BERT-Large MLM, 8 x 512 bf16, remat, flash (non-causal): "
      f"losses {[round(x, 5) for x in losses]}, step ms "
      f"{[round(x, 1) for x in ms]} (median {step_s * 1e3:.1f}), "
      f"{rec['tokens_per_s']:.0f} tokens/s, MFU {rec['mfu']:.4f}, peak "
      f"{rec['peak_gib']:.2f} GiB; K1 {launches} over {n} steps = 2L / L / "
      f"L a step (L = {L}); plain calls {plain} ({smi})")
  assert launches == rec["formula"], (launches, rec["formula"])
  assert plain == 0
  assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
  del state, run, step
  return rec


def bert_fp32_flash_vs_dense(torch, fa, params, smi):
  """24a: BERT-Large widths at BERT_FP32_LAYERS layers, fp32 without
  TF32, one gradient of ``bert_mlm_loss`` at 8 x 512 with
  ``attn_impl="pallas_flash"`` (the fp32 kernels, causal=False) against
  ``"xla"`` (dense): the loss within 1e-5 relative and every gradient
  within BERT_GRAD_LIMIT by normalized error (phase 9's check for GPT).
  Then one AdamW step of ``BertForQuestionAnswering`` (the same trunk
  in bf16 and an fp32 span head): its loss finite."""
  from easyparallellibrary_tpu_torch.models.bert import (
      Bert, BertForQuestionAnswering, bert_mlm_loss, bert_qa_loss)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, make_train_step)
  from easyparallellibrary_tpu_torch.testing.bert_workers import mlm_batch
  torch.backends.cuda.matmul.allow_tf32 = False
  trunk = {k: v for k, v in params.items()
           if not k.startswith("block_")
           or int(k.split(".")[0][6:]) < BERT_FP32_LAYERS}
  batch = {k: torch.from_numpy(v).cuda() for k, v in mlm_batch(
      BERT_CFG["vocab_size"], BERT_BATCH, 512, BERT_MASKED,
      BERT_DATA_SEED).items()}
  runs = {}
  for attn in ("pallas_flash", "xla"):
    cfg = bert_config(torch, num_layers=BERT_FP32_LAYERS,
                      dtype=torch.float32, attn_impl=attn)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in trunk.items()}
    fa.reset_counts()
    loss, _ = bert_mlm_loss(Bert(cfg), leaves, batch)
    loss.backward()
    launches, plain = launch_counts(fa)
    L = BERT_FP32_LAYERS
    assert launches == ({"fwd": 2 * L, "dkv": L, "dq": L}
                        if attn == "pallas_flash" else
                        {"fwd": 0, "dkv": 0, "dq": 0}), (attn, launches)
    assert plain == 0
    runs[attn] = (loss.item(), {k: v.grad for k, v in leaves.items()})
  (lf, gf), (lx, gx) = runs["pallas_flash"], runs["xla"]
  worst = max(((gf[k] - gx[k]).norm() / gx[k].norm()).item() for k in gx)
  log(f"   24a. {BERT_FP32_LAYERS} layers fp32, flash vs dense: loss "
      f"{lf:.7f} / {lx:.7f} (rel {abs(lf - lx) / abs(lx):.2e}), gradients' "
      f"largest normalized error {worst:.2e} (limit {BERT_GRAD_LIMIT}) "
      f"({smi})")
  assert abs(lf - lx) <= 1e-5 * abs(lx) and worst <= BERT_GRAD_LIMIT
  del runs, gf, gx
  qa_cfg = bert_config(torch, num_layers=BERT_FP32_LAYERS)
  model = BertForQuestionAnswering(qa_cfg)
  r = np.random.RandomState(BERT_DATA_SEED)
  qa = {f"bert.{k}": v for k, v in trunk.items()}
  qa["qa_outputs.weight"] = torch.from_numpy(
      r.randn(2, 1024).astype(np.float32) / 32.0).cuda()
  qa["qa_outputs.bias"] = torch.zeros(2, device="cuda")
  state = TrainState.create(apply_fn=model, params=qa,
                            tx=adamw(BERT_LR, weight_decay=0.01))
  step = make_train_step(lambda p, b, rng: bert_qa_loss(model, p, b))
  qb = {"ids": batch["ids"],
        "start_positions": torch.from_numpy(r.randint(0, 512, (8,))).cuda(),
        "end_positions": torch.from_numpy(r.randint(0, 512, (8,))).cuda()}
  fa.reset_counts()
  state, m = step(state, qb, None)
  launches, plain = launch_counts(fa)
  loss = float(m["loss"])
  log(f"   24a. BertForQuestionAnswering ({BERT_FP32_LAYERS} layers bf16, "
      f"fp32 qa_outputs), one AdamW step: loss {loss:.5f}, K1 {launches}")
  assert np.isfinite(loss) and plain == 0 and launches["fwd"] > 0


def bert_flash_kernels(torch, fa, smi):
  """24b: K1 without the mask at BERT_FLASH_SHAPE, bf16: each kernel
  against its plain version within FLASH_BF16_LIMIT; kernel, plain and
  SDPA(is_causal=False) times, and the bounds of full attention."""
  q, k, v, dout = flash_case(torch, torch.bfloat16, 24, **BERT_FLASH_SHAPE)
  out, lse = fa.flash_fwd(q, k, v, False)
  want_out, want_lse = fa.flash_fwd_reference(q, k, v, False)
  delta = (dout.float() * want_out.float()).sum(-1)
  dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, False)
  dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, False)
  want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, want_lse,
                                                delta, False)
  want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta, False)
  torch.cuda.synchronize()
  torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-6)
  rel, errs = {}, {}
  for kernel, name, got, want in (("fwd", "out", out, want_out),
                                  ("dkv", "dk", dk, want_dk),
                                  ("dkv", "dv", dv, want_dv),
                                  ("dq", "dq", dq, want_dq)):
    limit = FLASH_BF16_LIMIT["fwd" if kernel == "fwd" else "grad"]
    r = normalized_errors(got, want)
    assert r[0] <= limit["rel_l2"] and r[1] <= limit["max_rel"], (name, r)
    prev = rel.get(kernel, (0.0, 0.0))
    rel[kernel] = (max(prev[0], r[0]), max(prev[1], r[1]))
    errs[kernel] = max(errs.get(kernel, 0.0),
                       (got.float() - want.float()).abs().max().item())
  log(f"   24b. K1 full (non-causal) at B=8 H=16 S=512 D=64 bf16 vs plain "
      f"(rel_l2, max_rel): {rel}; limits {FLASH_BF16_LIMIT} ({smi})")
  rows = flash_timing(torch, fa, shape=BERT_FLASH_SHAPE, causal=False)
  return {k: dict(rows[k], rel=rel[k], max_abs_err=errs[k]) for k in rows}


def resnet_one_card(torch, smi):
  """24d: ResNet-50 (GroupNorm) through ``parallelize(make_train_step)``
  with the benchmark's cross-entropy, 1 + RESNET_STEPS AdamW steps at
  64 x 224 x 224: images/s, step ms, MFU (the benchmark's count), peak;
  then BatchNorm through ``MutableTrainState`` /
  ``make_mutable_train_step``, RESNET_BN_STEPS steps: the running
  statistics move and stay finite."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.resnet import (
      ResNet, resnet_flops_per_image)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.ops.losses import (
      distributed_sparse_softmax_cross_entropy_with_logits as ce)
  from easyparallellibrary_tpu_torch.parallel.api import (
      MutableTrainState, TrainState, create_sharded_train_state,
      make_mutable_train_step, make_train_step, parallelize)
  from easyparallellibrary_tpu_torch.profiler.flops import peak_flops_per_chip
  from easyparallellibrary_tpu_torch.testing.bert_workers import images
  from easyparallellibrary_tpu_torch.weights import (
      init_model_state, init_params)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  x, y = images(RESNET_BATCH, RESNET_IMAGE, 1000, 1)
  batch = {"x": x, "y": y}
  out = {}
  for norm in ("group", "batch"):
    cfg = resnet_cfg(torch, norm=norm)
    epl.init(device="cuda")
    with epl.replicate(1):
      model = ResNet(cfg)
    mesh = epl.current_plan().build_mesh()
    dev = mesh.device
    params = init_params(cfg, seed=0, device=dev)
    tx = adamw(RESNET_LR, weight_decay=0.01)
    if norm == "group":
      state, sh = create_sharded_train_state(
          lambda: TrainState.create(apply_fn=model, params=params, tx=tx),
          mesh)

      def loss_fn(p, b, rng):
        logits = torch.func.functional_call(model, p, (b["x"],))
        return ce(b["y"], logits).mean(), {}

      run = parallelize(make_train_step(loss_fn), mesh, sh)
      steps = 1 + RESNET_STEPS
    else:
      stats0 = init_model_state(cfg, device=dev)
      state, sh = create_sharded_train_state(
          lambda: MutableTrainState.create(apply_fn=model, params=params,
                                           tx=tx, model_state=stats0), mesh)

      def loss_fn(p, ms, b, rng):
        logits, new = torch.func.functional_call(
            model, {**p, **ms}, (b["x"],), {"train": True, "mutable": True})
        return ce(b["y"], logits).mean(), ({}, new)

      run = parallelize(make_mutable_train_step(loss_fn), mesh, sh)
      steps = RESNET_BN_STEPS
    del params
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    for _ in range(steps):
      t0 = time.perf_counter()
      state, m = run(state, batch, None)
      losses.append(float(m["loss"]))
      torch.cuda.synchronize(dev)
      ms.append((time.perf_counter() - t0) * 1e3)
    step_s = statistics.median(ms[1:]) / 1e3
    rec = {"losses": losses, "warm_ms": ms[0], "step_ms": ms[1:],
           "images_per_s": RESNET_BATCH / step_s,
           "mfu": resnet_flops_per_image(cfg, RESNET_IMAGE) * RESNET_BATCH
           / step_s / peak_flops_per_chip(dev),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    assert all(np.isfinite(losses)), losses
    extra = ""
    if norm == "batch":
      moved = max((state.model_state[k] - stats0[k]).abs().max().item()
                  for k in stats0)
      finite = all(bool(torch.isfinite(v).all())
                   for v in state.model_state.values())
      rec["stats_moved"] = moved
      extra = (f"; running statistics moved by up to {moved:.4f}, finite "
               f"{finite}")
      assert finite and moved > 0
    log(f"   24d. ResNet-50 {norm} norm, 64 x 224 x 224 bf16: losses "
        f"{[round(v, 5) for v in losses]}, step ms "
        f"{[round(v, 1) for v in ms]}, {rec['images_per_s']:.1f} images/s, "
        f"MFU {rec['mfu']:.4f}, peak {rec['peak_gib']:.2f} GiB{extra} "
        f"({smi})")
    out[norm] = rec
    del state, run
    gc.collect()
    torch.cuda.empty_cache()
  return out


def split_reference(torch, params, smi):
  """24e's one-process reference: ResNet-50 with SPLIT_CLASSES classes
  (no split), SPLIT_STEPS AdamW steps on SPLIT_BATCH images through
  ``parallelize(make_train_step)`` with the distributed cross-entropy."""
  from easyparallellibrary_tpu_torch.testing import bert_workers, tp_workers
  mesh = tp_workers.setup("", device="cuda")
  x, y = bert_workers.images(SPLIT_BATCH, RESNET_IMAGE, SPLIT_CLASSES,
                             SPLIT_SEED)
  cfg = dict(stage_sizes=(3, 4, 6, 3), num_classes=SPLIT_CLASSES,
             dtype="bfloat16")
  one = bert_workers.resnet_split_head(0, 1, cfg, params, x, y,
                                       steps=SPLIT_STEPS, lr=SPLIT_LR,
                                       device="cuda")
  log(f"   24e. one process: losses {[round(v, 6) for v in one['losses']]}, "
      f"step ms {[round(v, 1) for v in one['step_ms']]}, peak "
      f"{one['peak_gib']:.2f} GiB ({smi})")
  return one, cfg


def phase24_parent(torch, fa, bert_params, split_params, smi):
  """24a, 24b, 24d and 24e's reference in this process; the weights of
  24c and 24e to files for the ranks; their spec."""
  t0 = time.monotonic()
  with Phase("24a. BERT-Large MLM (BASELINE row 2's model) on one card"):
    bert = bert_one_card(torch, fa, bert_params, smi)
    bert_fp32_flash_vs_dense(torch, fa, bert_params, smi)
  gc.collect()
  torch.cuda.empty_cache()
  with Phase("24b. K1 without the mask at BERT's shape"):
    flash = bert_flash_kernels(torch, fa, smi)
  with Phase("24d. ResNet-50 on one card (BASELINE row 1's model)"):
    resnet = resnet_one_card(torch, smi)
  with Phase("24e the one-process reference (131072 classes)"):
    split_one, split_cfg = split_reference(torch, split_params, smi)
  gc.collect()
  torch.cuda.empty_cache()
  paths = []
  for tree in (bert_params, split_params):
    fd, path = tempfile.mkstemp(prefix="epl_phase24_", suffix=".pt")
    os.close(fd)
    torch.save({k: v.cpu() for k, v in tree.items()}, path)
    paths.append(path)
  spec = {"bert": {"cfg": BERT_CFG, "weights": paths[0], "M": BERT_PP_M,
                   "steps": BERT_PP_STEPS, "lr": BERT_LR,
                   "batch": (BERT_BATCH, 512, BERT_MASKED, BERT_DATA_SEED)},
          "resnet": {"cfg": split_cfg, "weights": paths[1],
                     "batch": SPLIT_BATCH, "image": RESNET_IMAGE,
                     "seed": SPLIT_SEED, "steps": SPLIT_STEPS,
                     "lr": SPLIT_LR}}
  return {"bert": bert, "flash": flash, "resnet": resnet,
          "split": split_one, "spec": spec, "smi": smi,
          "wall_s": time.monotonic() - t0}


def phase24_checks(ranks, p24):
  """24c and 24e on the ranks against 24a's first steps and the
  one-process reference: every rank's numbers are printed before any is
  held.  Returns K1's launches on each rank."""
  for path in (p24["spec"]["bert"]["weights"],
               p24["spec"]["resnet"]["weights"]):
    os.remove(path)
  one = p24["bert"]["losses"][:BERT_PP_STEPS]
  split_one = p24["split"]["losses"]
  smi = p24["smi"]
  for r in ranks:
    got, c = r["p24"]["bert"], r["p24"]["bert"]["coords"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], one)]
    log(f"   24c. BERT-Large smap 1F1B, stage rank {c['stage']}: losses "
        f"{[round(v, 5) for v in got['losses']]} (one card {[round(v, 5) for v in one]}, rel "
        f"{[f'{g:.2e}' for g in gaps]}, limit {P24_LOSS_RTOL:.2e}), step ms "
        f"{[round(v, 1) for v in got['step_ms']]}, peak "
        f"{got['peak_gib']:.2f} GiB, staged "
        f"{got['staged_bytes_per_step'] / 2**20:.1f} MiB a step, K1 "
        f"{got['launches']} (formula {got['formula']}: 12 layers x M = 4 "
        f"x {BERT_PP_STEPS} steps, forwards doubled by stage remat) ({smi})")
    sp = r["p24"]["resnet"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(sp["losses"], split_one)]
    log(f"   24e. ResNet-50 131072-class head under split(2), model rank "
        f"{sp['coords']['model']} ({sp['head_rows']} head rows): losses "
        f"{[round(v, 6) for v in sp['losses']]} (one process "
        f"{[round(v, 6) for v in split_one]}, rel {[f'{g:.2e}' for g in gaps]}),"
        f" step ms {[round(v, 1) for v in sp['step_ms']]}, peak "
        f"{sp['peak_gib']:.2f} GiB ({smi})")
  launches = []
  for r in ranks:
    got = r["p24"]["bert"]
    for a, b in zip(got["losses"], one):
      assert abs(a - b) <= P24_LOSS_RTOL * abs(b), (got["losses"], one)
    assert got["launches"] == got["formula"], (got["launches"],
                                               got["formula"])
    assert got["plain_calls"] == 0
    assert tuple(got["dispatch"]) == ("smap", "1f1b", None), got["dispatch"]
    sp = r["p24"]["resnet"]
    assert sp["head_rows"] * TP == SPLIT_CLASSES
    for a, b in zip(sp["losses"], split_one):
      assert abs(a - b) <= P24_LOSS_RTOL * abs(b), (sp["losses"], split_one)
    launches.append(got["launches"])
  return launches


def phase24_alone(torch, fa, bert_params, split_params, smi):
  """``--phases 24``: the parent's part here, 24c and 24e in a group of
  two ranks of their own."""
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  p24 = phase24_parent(torch, fa, bert_params, split_params, smi)
  del bert_params, split_params
  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.monotonic()
  with Phase("24c, 24e: the BERT pipeline and the split head, two ranks"):
    ranks = spawn(tp_workers.chip_tp_suite, TP, ("gloo", {"p24": p24[
        "spec"]}), timeout_s=TP_SPAWN_DEADLINE_S)
  p24["launches"] = phase24_checks(ranks, p24)
  p24["group_wall_s"] = time.monotonic() - t0
  return p24


# ------------------------------------------------------------ 25. tooling

# 25a/25b's step: bench.py's GPT-350M bf16 step at its largest batch.
TOOL_BATCH = 16
# 25b: steps of the FlopsProfiler / MemoryProfiler / StepProfiler window
# (a FlopsProfiler line every 5 steps after the first).
TOOL_STEPS, TOOL_LINE_EVERY, TOOL_MEM_EVERY = 6, 5, 2
# 25e: the example's depth and steps, and the offload step's depth.
TOOL_EXAMPLE_LAYERS, TOOL_EXAMPLE_STEPS, TOOL_EXAMPLE_BATCH = 4, 3, 8
OFFLOAD_ALL_LAYERS = 4
# Phase 25's own wall limit (the whole script runs under a time
# limit).
P25_WALL_S = 90
# 25f: the row-parallel Dense whose collectives are counted (bf16).
ROW_DENSE_SIZES = dict(rows=1024, d_in=4096, d_out=1024)


def flash_counts(fa):
  return {"fwd": fa.flash_fwd_cuda.launches,
          "dkv": fa.flash_bwd_dkv_cuda.launches,
          "dq": fa.flash_bwd_dq_cuda.launches}


def _params_snapshot(torch, state):
  return {k: v.detach().clone() for k, v in state.params.items()}


def tool_profile_step(torch, fa, bench, phase10_peak_gib, params=None):
  """25a: ``profile_step`` over bench.py's step at full width; its FLOPs
  against the same step's count with the plain versions (the flash
  dispatch routed to them on the card) and with plain attention
  (``attn_impl="xla"``, whose products ``FlopCounterMode`` counts
  itself), and against ``gpt_flops_per_token``; its memory beside the
  allocator's peak and phase 10's; K1's launches; the caller's state
  bit-equal."""
  from easyparallellibrary_tpu_torch.models.gpt import gpt_flops_per_token
  from easyparallellibrary_tpu_torch.profiler import flops as flops_lib
  from easyparallellibrary_tpu_torch.profiler.profiler import profile_step
  dev = torch.device("cuda")
  cfg = bench.bench_config(dev)[0]
  if params is not None:
    params = {k: v.to(dev) for k, v in params.items()}
  state, step, batch, rng, _ = bench.build_training(cfg, TOOL_BATCH, "cuda",
                                                    params=params)
  del params
  tokens = TOOL_BATCH * cfg.max_seq_len
  before = _params_snapshot(torch, state)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  fa.reset_counts()
  t0 = time.monotonic()
  report = profile_step(step, state, batch, rng, tokens_per_step=tokens)
  torch.cuda.synchronize()
  prof_s = time.monotonic() - t0
  launches = flash_counts(fa)
  plain_calls = (fa.flash_fwd_reference.calls
                 + fa.flash_bwd_dkv_reference.calls
                 + fa.flash_bwd_dq_reference.calls)
  peak = torch.cuda.max_memory_allocated()
  same = all(torch.equal(v, before[k]) for k, v in state.params.items())
  del before
  # The same step with the flash dispatch routed to the plain versions,
  # on the card.
  route = fa._route
  fa._route = lambda q, cuda_fn, plain_fn, *args: plain_fn(*args)
  try:
    plain = flops_lib.compiled_cost(step, state, batch, rng)["flops"]
  finally:
    fa._route = route
  params = {k: v.detach() for k, v in state.params.items()}
  xla_cfg = dataclasses.replace(cfg, attn_impl="xla")
  xstate, xstep, *_ = bench.build_training(xla_cfg, TOOL_BATCH, "cuda",
                                           params=params)
  xla = flops_lib.compiled_cost(xstep, xstate, batch, rng)["flops"]
  del xstate, xstep, params
  formula = gpt_flops_per_token(cfg, cfg.max_seq_len) * tokens
  flops = report["cost_flops"]
  gib = 2.0 ** 30
  log(f"   profile_step ({prof_s:.1f} s, two runs on copies): "
      f"{json.dumps(report)}")
  log(f"   flops: kernels {flops:.6g}, plain versions {plain:.6g}, plain "
      f"attention {xla:.6g}, gpt_flops_per_token x tokens {formula:.6g} "
      f"(count / formula {flops / formula:.6f})")
  log(f"   memory: temp {report['temp_size_in_bytes'] / gib:.2f} GiB + "
      f"arguments {report['argument_size_in_bytes'] / gib:.2f} GiB = "
      f"total {report['total_bytes'] / gib:.2f} GiB; allocator peak over "
      f"the call {peak / gib:.2f} GiB (the caller's state and a copy "
      f"included); phase 10's peak {phase10_peak_gib} GiB; generated "
      f"code {report['generated_code_size_in_bytes'] / 2**20:.2f} MiB")
  log(f"   K1 launches {launches} (two steps x {cfg.num_layers} layers); "
      f"plain calls {plain_calls}; caller's parameters bit-equal: {same}")
  assert flops == plain == xla, (flops, plain, xla)
  assert 1.0 <= flops / formula <= 1.05, flops / formula
  assert all(n == 2 * cfg.num_layers for n in launches.values()), launches
  assert plain_calls == 0 and same
  assert state.step == 0 and not state.opt_state.state
  return dict(report=report, launches=launches, formula=formula,
              state=state, step=step, batch=batch, rng=rng, cfg=cfg)


def tool_profilers(torch, fa, ctx, tmp):
  """25b: ``FlopsProfiler`` (with 25a's count) and ``MemoryProfiler``
  over ``TOOL_STEPS`` steps, the MFU line beside ``StepProfiler``'s."""
  from easyparallellibrary_tpu_torch.profiler import (
      FlopsProfiler, MemoryProfiler, StepProfiler)
  state, step, batch, rng = (ctx[k] for k in ("state", "step", "batch",
                                              "rng"))
  tokens = TOOL_BATCH * ctx["cfg"].max_seq_len
  fp = FlopsProfiler(flops_per_step=ctx["report"]["cost_flops"],
                     every_n_steps=TOOL_LINE_EVERY)
  mp = MemoryProfiler(every_n_steps=TOOL_MEM_EVERY,
                      csv_path=os.path.join(tmp, "memory.csv"))
  sp = StepProfiler(flops_per_step=ctx["formula"], tokens_per_step=tokens,
                    warmup=1)
  fa.reset_counts()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  lines = []
  for _ in range(TOOL_STEPS):
    state, m = step(state, batch, rng)
    torch.cuda.synchronize()
    line = fp.step()
    if line:
      lines.append(line)
    mp.step()
    sp.tick()
  mp.dump_csv()
  mp.dump_png(os.path.join(tmp, "memory.png"))
  launches = flash_counts(fa)
  summary = sp.summary()
  log(f"   FlopsProfiler: {lines}")
  log(f"   StepProfiler: {summary}")
  log(f"   MemoryProfiler: {len(mp.records)} records, peak "
      f"{mp.peak_bytes() / 2**30:.2f} GiB, CSV "
      f"{os.path.getsize(os.path.join(tmp, 'memory.csv'))} bytes; K1 "
      f"launches {launches}; loss {float(m['loss']):.4f}")
  assert len(lines) == 1 and 0 < lines[0]["mfu"] < 1, lines
  assert 0 < summary["mfu"] < 1
  assert len(mp.records) == TOOL_STEPS // TOOL_MEM_EVERY
  assert mp.peak_bytes() > 0
  assert all(n == TOOL_STEPS * ctx["cfg"].num_layers
             for n in launches.values()), launches
  return dict(flops_line=lines[0], step_profiler=summary,
              launches=launches)


def tool_perfgate(torch, pa):
  """25c: the port's perf gate on the card: the reference twins built on
  the card (the paged twin through K2), 0 violations, each twin's
  measured peak within the CPU card's static bound, and planted
  regressions refused."""
  from easyparallellibrary_tpu_torch.observability import perfgate
  budget = perfgate.load_budget()
  pa.reset_counts()
  t0 = time.monotonic()
  cards = perfgate.collect_cards(device="cuda")
  torch.cuda.synchronize()
  k2 = pa.paged_attention_cuda.launches
  violations = perfgate.run_gate(cards=cards)
  planted = {k: dict(v, flops=2 * v["flops"], compile_count=2.0)
             for k, v in cards.items()}
  refused = perfgate.run_gate(cards=planted)
  bounds = {}
  for label, card in cards.items():
    cpu_bound = budget["cost_cards"][label]["peak_hbm_bytes"]["max"] / 1.25
    bounds[label] = (card["peak_hbm_bytes"], cpu_bound)
  log(f"   gate on the card ({time.monotonic() - t0:.1f} s): "
      f"{len(violations)} violation(s) {violations}; K2 launches {k2}")
  for label, (got, bound) in bounds.items():
    log(f"   {label}: compile_count {cards[label]['compile_count']:g}, "
        f"flops {cards[label]['flops']:g}, peak {got:g} B against the CPU "
        f"card's static bound {bound:g} B ({got / bound:.3f})")
  log(f"   planted regression (flops x2, a second compile): "
      f"{len(refused)} violation(s)")
  assert violations == [], violations
  assert k2 > 0
  assert all(got <= bound for got, bound in bounds.values()), bounds
  assert len(refused) == 2 * len(cards), refused
  return k2


def tool_evidence(torch, smi, ctx, profilers, tmp):
  """25d: the evidence writer into a temporary log, the record stamped
  with the card's name and power limit, read back and valid."""
  from easyparallellibrary_tpu_torch.utils import bench_evidence as ev
  path = os.path.join(tmp, "BENCH_EVIDENCE.json")
  name, _, limit = smi.splitlines()[0].partition(",")
  line = profilers["flops_line"]
  rec = ev.append_record(dict(
      metric="chip_smoke_gpt350m_step", value=line["mfu"], unit="mfu",
      flops_per_step=ctx["report"]["cost_flops"],
      step_time_s=line["step_time_s"],
      **ev.run_context(device_kind=torch.cuda.get_device_name(),
                       power_limit=limit.strip(), backend="cuda")),
      path=path)
  back = ev.latest_record("chip_smoke_gpt350m_step", path)
  log(f"   record: {json.dumps(back)}")
  assert back == rec and ev.validate_record(back) == []
  assert back["device_kind"] == torch.cuda.get_device_name() == name.strip()
  assert back["power_limit"] == limit.strip() and back["power_limit"]


def tool_example(torch, fa):
  """25e: ``examples.train_gpt`` on the card at GPT-350M widths, 4
  layers, 3 steps; K1's launches."""
  from easyparallellibrary_tpu_torch.examples import train_gpt
  fa.reset_counts()
  t0 = time.monotonic()
  out = train_gpt.main([
      "--layers", str(TOOL_EXAMPLE_LAYERS), "--d-model", "1024",
      "--heads", "16", "--vocab", "32768", "--seq-len", "1024",
      "--batch", str(TOOL_EXAMPLE_BATCH), "--steps",
      str(TOOL_EXAMPLE_STEPS)])
  torch.cuda.synchronize()
  launches = flash_counts(fa)
  log(f"   train_gpt ({time.monotonic() - t0:.1f} s): losses "
      f"{out['losses']}, {out['profile']}; K1 launches {launches}")
  assert all(np.isfinite(out["losses"]))
  assert all(n == TOOL_EXAMPLE_LAYERS * TOOL_EXAMPLE_STEPS
             for n in launches.values()), launches
  return launches


def tool_offload(torch, fa, bench):
  """25e: ``offload_to_host(state, "all")`` at bench.py's configuration
  cut to ``OFFLOAD_ALL_LAYERS`` layers (the blocks' parameters and every
  moment pinned on the host, streamed around each block's forward and
  remat recompute, the update through two buffers) against the same
  state without offload, 2 steps each: losses and parameters bit-equal;
  the second step's peak, the memory held between steps, and its ms."""
  from easyparallellibrary_tpu_torch.runtime.offload import offload_to_host
  cfg = bench.bench_config(torch.device("cuda"),
                           num_layers=OFFLOAD_ALL_LAYERS)[0]
  runs = {}
  for name in ("plain", "all"):
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state, step, batch, rng, _ = bench.build_training(cfg, TOOL_BATCH,
                                                      "cuda")
    if name == "all":
      state = offload_to_host(state, "all")
    losses = []
    state, m = step(state, batch, rng)
    losses.append(m["loss"].item())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch, rng)
    losses.append(m["loss"].item())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    runs[name] = dict(
        losses=losses, ms=ms, held_gib=held / 2**30,
        peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
        launches=flash_counts(fa),
        params={k: v.detach().cpu() for k, v in state.params.items()})
    del state, step
  plain, off = runs["plain"], runs["all"]
  same = all(torch.equal(v, off["params"][k])
             for k, v in plain["params"].items())
  for name, r in runs.items():
    log(f"   {name}: losses {r['losses']}, held between steps "
        f"{r['held_gib']:.3f} GiB, step 2 peak {r['peak_gib']:.3f} GiB, "
        f"{r['ms']:.1f} ms, K1 {r['launches']}")
  log(f"   offload('all') saves {plain['held_gib'] - off['held_gib']:.3f} "
      f"GiB held and {plain['peak_gib'] - off['peak_gib']:.3f} GiB of the "
      f"step's peak; parameters bit-equal: {same}")
  assert plain["losses"] == off["losses"] and same
  assert off["held_gib"] < plain["held_gib"]
  assert off["peak_gib"] < plain["peak_gib"]
  assert all(n == OFFLOAD_ALL_LAYERS for n in off["launches"].values())
  return off["launches"]


def tool_collectives_check(ranks):
  """25f: each rank's collectives of the row-parallel Dense
  (``tp_workers.row_dense_collectives``) against the analytic bytes (one
  all-reduce of the bf16 [rows, d_out] output)."""
  want = ROW_DENSE_SIZES["rows"] * ROW_DENSE_SIZES["d_out"] * 2
  for got in ranks:
    log(f"   rank collectives {got['sizes']}, collective_bytes "
        f"{got['bytes']:g} (analytic {want})")
    assert got["sizes"] == [("all_reduce", float(want))], got
    assert got["bytes"] == want


def tool_collectives_alone(torch):
  """25f without phase 21's group: two gloo ranks of their own."""
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  ranks = spawn(tp_workers.row_dense_collective_sizes, 2,
                (ROW_DENSE_SIZES["rows"], ROW_DENSE_SIZES["d_in"],
                 ROW_DENSE_SIZES["d_out"], "cuda", "gloo", "bfloat16"),
                timeout_s=TP_SPAWN_DEADLINE_S)
  tool_collectives_check(ranks)


def tooling_phase(torch, fa, pa, bench, smi, phase10_peak_gib, tp=None,
                  params=None):
  """Phase 25 (module docstring): 25a-25e here, 25f from phase 21's
  rank group (or a group of its own).  Returns what the kernels line
  carries."""
  t0 = time.monotonic()
  with tempfile.TemporaryDirectory() as tmp:
    with Phase("25a. profile_step over bench.py's GPT-350M step"):
      ctx = tool_profile_step(torch, fa, bench, phase10_peak_gib, params)
    with Phase("25b. FlopsProfiler and MemoryProfiler over 6 steps"):
      profilers = tool_profilers(torch, fa, ctx, tmp)
    del ctx["state"], ctx["step"]
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("25c. the perf gate on the card"):
      k2 = tool_perfgate(torch, pa)
    with Phase("25d. the evidence writer"):
      tool_evidence(torch, smi, ctx, profilers, tmp)
    with Phase("25e. examples.train_gpt on the card, and "
               "offload_to_host('all')"):
      example = tool_example(torch, fa)
      offload = tool_offload(torch, fa, bench)
  with Phase("25f. collective_bytes of a row-parallel Dense on two ranks"):
    if tp is not None:
      tool_collectives_check(tp["row_dense_collectives"])
    else:
      tool_collectives_alone(torch)
  wall = time.monotonic() - t0
  log(f"   25. wall {wall:.1f} s")
  assert wall < P25_WALL_S, f"phase 25 took {wall:.0f} s"
  return dict(profile_step=ctx["launches"],
              profilers=profilers["launches"], example=example,
              offload_all=offload, perfgate_k2=k2,
              flops=ctx["report"]["cost_flops"])


# ------------------------------------------- 26. sharded checkpoints

# GPT-350M widths cut to 4 layers (the script's time), bench.py's bf16
# step over fp32 parameters (flash, remat ``dots_flash``, loss_chunk 256)
# and AdamW(3e-4), 8 x 1024 a step: 6 steps, the checkpoint at step 3.
P26_CFG = dict(GPT_350M, num_layers=4, dtype="bfloat16", remat=True,
               remat_policy="dots_flash", attn_impl="pallas_flash",
               loss_chunk=256)
P26_BATCH, P26_STEPS, P26_SPLIT, P26_M, P26_LR = 8, 6, 3, 2, 3e-4
P26_RUNS = {  # sub-phase: (mesh, Config entries, GPT config overrides)
    "26a": ("model:2", None, {}),
    "26b": ("data:2", {"zero.level": "v1"}, {}),
    "26c": ("stage:2", {"pipeline.engine": "smap",
                        "pipeline.strategy": "PreferBackward"},
            {"pipeline_stages": 2, "num_micro_batch": P26_M}),
}
# 26a's checkpoint restored at tp = 1 in one process: its loss on a held
# batch within one bf16 spacing (2^-8, relative) of the TP ranks'.
P26_RELOAD_RTOL = 2.0 ** -8
P26_REQUESTS = 8
P26_WALL_S = 400


def phase26_spec(root, backend):
  """Phase 26's rank runs (``ckpt_workers.train_resume`` a sub-phase,
  each from ``init_params(seed 0)``) and its held batch."""
  r = np.random.RandomState(26)
  shape = (P26_BATCH, GPT_350M["max_seq_len"] + 1)
  batches = [r.randint(0, GPT_350M["vocab_size"], shape)
             for _ in range(P26_STEPS)]
  held = np.random.RandomState(27).randint(0, GPT_350M["vocab_size"], shape)
  runs = [(mesh, dict(P26_CFG, **over), 0, batches, os.path.join(root, name),
           P26_SPLIT, config, P26_LR, held if name == "26a" else None,
           "cuda", backend)
          for name, (mesh, config, over) in P26_RUNS.items()]
  return {"root": root, "runs": runs, "held": held}


def p26_logical_index(torch):
  """``{path: shape}`` of a ``fit`` checkpoint of P26_CFG's model as one
  process holds it (the JAX layout's logical shapes)."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.runtime import saver
  from easyparallellibrary_tpu_torch.testing.tp_workers import gpt_config
  model = GPT(gpt_config(P26_CFG), device="meta")
  tree = saver.params_tree(dict(model.named_parameters()))
  out = {"opt_state/0/count": []}
  for path, leaf in tree.items():
    for prefix in ("params/", "opt_state/0/mu/", "opt_state/0/nu/"):
      out[prefix + path] = list(leaf.shape)
  return out


def phase26_checks(torch, ranks, spec, backend):
  """26a-c on the ranks: each resume bit-equal (the restored blocks, the
  steps after it, the final state), K1's launches at their formula and
  no plain call, every checkpoint's leaves at the logical layout; the
  save and restore seconds, bytes gathered, the leader's host memory
  and each step's wall.  Returns K1's launches by sub-phase and rank."""
  want = p26_logical_index(torch)
  launches = {}
  for i, name in enumerate(P26_RUNS):
    recs = [r["p26"]["runs"][i] for r in ranks]
    for rank, rec in enumerate(recs):
      assert rec["rstep"] == P26_SPLIT, (name, rank, rec["rstep"])
      assert rec["restored_differ"] == [], (name, rank,
                                            rec["restored_differ"])
      assert rec["final_differ"] == [], (name, rank, rec["final_differ"])
      assert rec["resumed"] == rec["straight"][P26_SPLIT:], (name, rank)
      assert all(np.isfinite(rec["straight"])), (name, rank)
      assert rec["launches"] == rec["formula"], (name, rank, rec["launches"])
      assert not any(rec["plain_calls"].values()), (name, rec["plain_calls"])
      save = rec["save"]
      log(f"   {name} rank {rank}: losses "
          f"{[round(x, 5) for x in rec['straight']]}, resumed "
          f"{[round(x, 5) for x in rec['resumed']]} (bit-equal); step ms "
          f"{[round(x, 1) for x in rec['straight_ms']]} then "
          f"{[round(x, 1) for x in rec['resumed_ms']]}; K1 {rec['launches']}"
          f" = formula {rec['formula']}")
      log(f"   {name} rank {rank}: save {save['seconds']:.2f} s, gathered "
          f"{save['gathered_bytes'] / 2**20:.1f} MiB through the host, "
          f"shard arrays held at most {save['host_peak_bytes'] / 2**20:.1f}"
          f" MiB, resident peak +{save['rss_peak_bytes'] / 2**20:.1f} MiB; "
          f"restore {rec['restore_s']:.2f} s")
    index = recs[0]["index"]
    if name == "26c":
      stacked = {p: s for p, s in index.items() if "/pipeline/" in p}
      assert stacked and all(s[0] == 2 for s in stacked.values()), stacked
      count = lambda d: sum(int(np.prod(s)) for p, s in d.items()
                            if p.startswith("params/"))  # noqa: E731
      assert count(index) == count(want), (count(index), count(want))
    else:
      assert index == want, sorted(set(index) ^ set(want))[:4]
    launches[name] = [rec["launches"] for rec in recs]
  log(f"   26. every checkpoint at the logical layout ({len(want)} leaves; "
      f"26c's stacked [2, ...]); {backend}, two ranks on one card")
  return launches


def p26_reload_and_serve(torch, pa, spec, tp_loss):
  """26a's checkpoint in this process at tp = 1: its loss on the held
  batch against the TP ranks' (``P26_RELOAD_RTOL``), then 26d: the paged
  engine serving P26_REQUESTS staggered greedy requests from it, the
  streams against ``generate(use_cache=False)`` by the gap rule, K2's
  tiled launches at layers x steps, none warp or plain."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, gpt_loss
  from easyparallellibrary_tpu_torch.runtime import saver
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.tp_workers import gpt_config
  root = os.path.join(spec["root"], "26a")
  t0 = time.monotonic()
  params, step = saver.restore_params(root, device="cuda")
  torch.cuda.synchronize()
  load_s = time.monotonic() - t0
  assert step == P26_SPLIT
  model = GPT(gpt_config(P26_CFG))
  with torch.no_grad():
    loss, _ = gpt_loss(model, params, {"ids": torch.from_numpy(
        spec["held"]).cuda()}, None)
  loss = float(loss)
  gap = abs(loss - tp_loss) / abs(tp_loss)
  log(f"   26a. tp = 1 reload ({load_s:.2f} s): held-batch loss {loss:.6f} "
      f"against the TP ranks' {tp_loss:.6f} (relative {gap:.2e}, limit "
      f"{P26_RELOAD_RTOL:.2e})")
  assert gap <= P26_RELOAD_RTOL, (loss, tp_loss)
  serve_model = GPT(gpt_config(dict(GPT_350M, num_layers=4,
                                    dtype="bfloat16")))
  eng = ContinuousBatchingEngine(serve_model, params, paged=True,
                                 num_slots=NUM_SLOTS,
                                 prefill_chunk=PREFILL_CHUNK,
                                 block_size=BLOCK_SIZE)
  prompts = make_prompts(26, P26_REQUESTS, GPT_350M["vocab_size"])
  pa.reset_counts()
  out = {}
  for i, p in enumerate(prompts):
    if i == P26_REQUESTS // 2:
      for _ in range(3):
        for fin in eng.step():
          out[fin.uid] = fin.tokens
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
  out.update(eng.run())
  torch.cuda.synchronize()
  launches = pa.paged_attention_tiled_cuda.launches
  layers = serve_model.cfg.num_layers
  assert launches == layers * eng.steps > 0, (launches, eng.steps)
  assert pa.paged_attention_warp_cuda.launches == 0
  assert pa.paged_attention_reference.calls == 0
  assert sorted(out) == list(range(P26_REQUESTS))
  log(f"   26d. {P26_REQUESTS} staggered requests from 26a's checkpoint: "
      f"{eng.steps} engine steps, tiled launches {launches} = {layers} "
      f"layers x {eng.steps} steps, warp 0, plain 0")
  greedy_vs_generate(torch, serve_model, eng.params, prompts, out,
                     bf16_gap_limit, "26d")
  eng.close()
  return launches


def phase26_alone(torch, pa):
  """``--phases 26`` without phase 21: two gloo ranks of their own."""
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  root = tempfile.mkdtemp(prefix="epl_phase26_")
  try:
    spec = phase26_spec(root, "gloo")
    ranks = spawn(tp_workers.chip_tp_suite, TP, ("gloo", {"p26": spec}),
                  timeout_s=TP_SPAWN_DEADLINE_S)
    return phase26_finish(torch, pa, ranks, spec, "gloo")
  finally:
    shutil.rmtree(root, ignore_errors=True)


def phase26_finish(torch, pa, ranks, spec, backend):
  """The parent's half of phase 26, after the ranks ran 26a-c."""
  t0 = time.monotonic()
  launches = phase26_checks(torch, ranks, spec, backend)
  tp_loss = ranks[0]["p26"]["runs"][0]["held_loss"]
  serving = p26_reload_and_serve(torch, pa, spec, tp_loss)
  wall = max(r["p26"]["wall_s"] for r in ranks) + time.monotonic() - t0
  log(f"   26. wall {wall:.1f} s (the ranks' runs "
      f"{max(r['p26']['wall_s'] for r in ranks):.1f} s)")
  assert wall < P26_WALL_S, f"phase 26 took {wall:.0f} s"
  return {"flash": launches, "paged": serving}


# Phase 27: K1's tile builds and the block table.  27a holds every build
# at the GPU tests' kind of shapes (bench.py's rows at batch 2, a ragged
# length, a key length past the query length); 27b sweeps bench.py's
# shape and one long one; 27c runs bench.py's step (24 layers, 16 x 1024)
# with the committed table and with the default build, P27_CHAINS chains
# of P27_CHAIN_STEPS steps each in ABBA turns, after P27_LOSS_STEPS steps
# of each from the same weights whose losses agree to one bf16 spacing
# (the arms sum the same products in other orders).
P27_SHAPES = [("bench_b2", dict(B=2, H=16, S=1024, Skv=1024)),
              ("ragged_s200", dict(B=2, H=3, S=200, Skv=200)),
              ("skv_192_s_128", dict(B=1, H=2, S=128, Skv=192))]
P27_SWEEP = [(1024, 64, 16, 16), (8192, 128, 1, 16)]
P27_BATCH, P27_LOSS_STEPS, P27_CHAINS, P27_CHAIN_STEPS = 16, 3, 4, 5
P27_LOSS_RTOL = 2.0 ** -8
P27_WALL_S = 150


def _flash_case_kv(torch, dtype, seed, B, H, S, Skv, D):
  """q, dout ``[B, H, S, D]`` and k, v ``[B, H, Skv, D]`` from a seed."""
  r = np.random.RandomState(seed)
  return [torch.from_numpy(r.randn(B, H, n, D).astype(np.float32)).to(
      "cuda", dtype) for n in (S, Skv, Skv, S)]


def tile_builds_parity(torch, fa):
  """27a: each kernel's builds in the library equal ``WGMMA_BUILDS``;
  each build's registers, spill bytes and shared memory from the loaded
  binary (none may spill but dK/dV's one build at D = 128); every build
  of every kernel, bf16 and fp16, D 64 and 128, causal and not, at
  ``P27_SHAPES`` against the plain versions (``FLASH_BF16_LIMIT`` /
  ``FLASH_FP16_LIMIT``), ``by_tile`` counting the build launched.  Returns ``{(dtype, D, kernel, build):
  info}`` and the largest normalized errors by kernel and dtype."""
  torch.backends.cuda.matmul.allow_tf32 = False
  wrappers = {"fwd": fa.flash_fwd_cuda, "dkv": fa.flash_bwd_dkv_cuda,
              "dq": fa.flash_bwd_dq_cuda}
  infos, worst = {}, {}
  for dtype_name in ("bfloat16", "float16"):
    dtype = getattr(torch, dtype_name)
    for D in (64, 128):
      for kernel in wrappers:
        builds = fa.flash_builds(kernel, dtype, D)
        assert builds == fa.kernel_builds(kernel, dtype, D), (
            kernel, dtype_name, D, builds)
        for build in builds:
          info = fa.flash_build_info(kernel, dtype, D, *build)
          infos[dtype_name, D, kernel, build] = info
          log(f"   {kernel:3s} {dtype_name:8s} D={D:3d} tile {build[0]:3d} "
              f"stages {build[1]}: {info['registers']} registers, "
              f"{info['local_bytes']} local (spill) bytes, "
              f"{info['smem_bytes']} B shared memory")
  # dK/dV's one build at D = 128 has spilled since it was written (two
  # 64-register accumulators under the 168 registers a 288-thread CTA may
  # take); no other build may.
  spilled = {k: v for k, v in infos.items() if v["local_bytes"]
             and k[1:3] != (128, "dkv")}
  assert not spilled, f"builds that spill: {spilled}"
  for dtype_name in ("bfloat16", "float16"):
    dtype = getattr(torch, dtype_name)
    limits = FLASH_BF16_LIMIT if dtype_name == "bfloat16" else FLASH_FP16_LIMIT
    for D in (64, 128):
      for seed, (label, shape) in enumerate(P27_SHAPES):
        for causal in (True, False):
          q, k, v, dout = _flash_case_kv(torch, dtype, 300 + seed, D=D,
                                         **shape)
          want_out, want_lse = fa.flash_fwd_reference(q, k, v, causal)
          delta = (dout.float() * want_out.float()).sum(-1)
          want_dk, want_dv = fa.flash_bwd_dkv_reference(
              q, k, v, dout, want_lse, delta, causal)
          want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse,
                                              delta, causal)
          readings = []
          for kernel, fn in wrappers.items():
            for build in fa.kernel_builds(kernel, dtype, D):
              before = dict(fn.by_tile)
              if kernel == "fwd":
                out, lse = fn(q, k, v, causal, build=build)
                got = [("out", out, want_out)]
              elif kernel == "dkv":
                dk, dv = fn(q, k, v, dout, want_lse, delta, causal,
                            build=build)
                got = [("dk", dk, want_dk), ("dv", dv, want_dv)]
              else:
                dq = fn(q, k, v, dout, want_lse, delta, causal, build=build)
                got = [("dq", dq, want_dq)]
              torch.cuda.synchronize()
              before[build] = before.get(build, 0) + 1
              assert fn.by_tile == before, (kernel, build, fn.by_tile)
              if kernel == "fwd":
                torch.testing.assert_close(lse, want_lse, rtol=2e-5,
                                           atol=2e-6)
              limit = limits["fwd" if kernel == "fwd" else "grad"]
              for name, x, want in got:
                assert x.dtype == dtype and bool(torch.isfinite(x).all())
                rel_l2, max_rel = normalized_errors(x, want)
                case = (f"{label} {dtype_name} D={D} causal={causal} "
                        f"{name} build {build}")
                assert (rel_l2 <= limit["rel_l2"]
                        and max_rel <= limit["max_rel"]), (
                            f"{case}: {rel_l2:.3e}, {max_rel:.3e} over "
                            f"{limit}")
                key = (kernel, dtype_name)
                old = worst.get(key, (0.0, 0.0))
                worst[key] = (max(old[0], rel_l2), max(old[1], max_rel))
                readings.append(f"{name}@{build[0]}x{build[1]} {rel_l2:.1e}")
          log(f"   {label:13s} {dtype_name:8s} D={D:3d} causal={causal!s:5s}"
              f" rel_l2: " + ", ".join(readings))
  log("   largest (rel_l2, max_rel) by kernel and dtype: " + ", ".join(
      f"{k[0]} {k[1]} ({v[0]:.2e}, {v[1]:.2e})" for k, v in worst.items()))
  return infos, worst


def tile_sweep(torch):
  """27b: ``flash_autotune.sweep`` at ``P27_SWEEP`` (nothing written):
  each candidate's causal forward + backward beside SDPA's, each build
  of each kernel alone, each kernel's bound at the shape."""
  from easyparallellibrary_tpu_torch.kernels import flash_autotune
  rows = flash_autotune.sweep(P27_SWEEP)
  for row in rows:
    row["bound_ms"] = {k: v[0] for k, v in flash_bounds(
        row["batch"], row["heads"], row["S"], row["D"], 2).items()}
    log(f"   S={row['S']} D={row['D']} B={row['batch']}: bounds (ms) "
        f"{row['bound_ms']}, their sum {sum(row['bound_ms'].values()):.4f}")
    log(f"   S={row['S']} D={row['D']} B={row['batch']}: fwd+bwd ms "
        + ", ".join(f"{c} {t:.4f}" for c, t in row["times_ms"].items())
        + f"; SDPA {row['sdpa_ms']:.4f}; best {row['best']} "
        f"({row['gain_vs_default']:.3f}x the default {row['default']})")
    for kernel, times in row["kernel_ms"].items():
      log(f"     {kernel:3s} alone: " + ", ".join(
          f"{b} {t:.4f}" for b, t in times.items()))
  return rows


def _flash_by_tile(fa):
  return {"fwd": dict(fa.flash_fwd_cuda.by_tile),
          "dkv": dict(fa.flash_bwd_dkv_cuda.by_tile),
          "dq": dict(fa.flash_bwd_dq_cuda.by_tile)}


def table_step(torch, fa, bench):
  """27c: bench.py's GPT-350M step (24 layers, ``pallas_flash``,
  ``dots_flash``, bf16 over fp32 weights, 16 x 1024) with the committed
  block table against the default build: two states from one draw of
  ``init_params(seed=0)``; ``P27_LOSS_STEPS`` steps of each, every K1
  launch on its arm's build (``by_tile``) and the losses within
  ``P27_LOSS_RTOL``; then step ms and MFU in ABBA chains.  Without an
  entry for the shape in the table, one more step under a set entry
  shows ``by_tile`` following it."""
  from easyparallellibrary_tpu_torch.models.gpt import gpt_flops_per_token
  from easyparallellibrary_tpu_torch.weights import init_params
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = bench.bench_config(torch.device("cuda"))[0]
  layers, S, D = cfg.num_layers, cfg.max_seq_len, cfg.d_model // cfg.num_heads
  key = (S, D, 2)
  device = torch.cuda.get_device_name()
  wants, depths = fa._read_block_table(fa._BLOCK_TABLE_PATH, device)
  entry = (wants.get(key), depths.get(key))
  table = {k: fa.flash_tile(k, S, D, torch.bfloat16) for k in
           ("fwd", "dkv", "dq")}
  if entry[0]:
    assert table == {k: fa.tile_for_want(k, D, torch.bfloat16, *entry)
                     for k in table}, (table, entry)
  else:
    assert all(b == fa.DEFAULT_BUILD for b in table.values()), table
  log(f"   committed table ({device}): entry {entry} for {key}; the "
      f"kernels' builds {table}")
  params = init_params(cfg, seed=0, device="cuda")
  arms = {}
  for arm in ("table", "default"):
    weights = {k: v.clone() for k, v in params.items()}
    arms[arm] = bench.build_training(cfg, P27_BATCH, "cuda", params=weights)
  del params

  def use(arm):
    if arm == "table" and entry[0]:
      fa.set_block_want(*key, *entry)
    else:
      fa.set_block_want(*key, 0)

  losses, by_tile = {}, {}
  try:
    for arm, (state, step, batch, rng, _) in arms.items():
      use(arm)
      fa.reset_counts()
      losses[arm] = []
      for _ in range(P27_LOSS_STEPS):
        state, metrics = step(state, batch, rng)
        losses[arm].append(metrics["loss"].item())
      arms[arm] = (state, step, batch, rng)
      by_tile[arm] = _flash_by_tile(fa)
      want = table if arm == "table" else {k: fa.DEFAULT_BUILD
                                           for k in table}
      n = layers * P27_LOSS_STEPS
      assert by_tile[arm] == {k: {want[k]: n} for k in want}, (arm,
                                                                by_tile[arm])
      log(f"   {arm:7s} losses {losses[arm]}; K1 launches by (tile, "
          f"stages): {by_tile[arm]}")
    np.testing.assert_allclose(losses["table"], losses["default"],
                               rtol=P27_LOSS_RTOL)
    times = {"table": [], "default": []}
    for i in range(P27_CHAINS):
      for arm in (("table", "default") if i % 2 == 0
                  else ("default", "table")):
        use(arm)
        state, step, batch, rng = arms[arm]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(P27_CHAIN_STEPS):
          state, metrics = step(state, batch, rng)
        torch.cuda.synchronize()
        times[arm].append((time.perf_counter() - t0) / P27_CHAIN_STEPS)
        arms[arm] = (state, step, batch, rng)
    forced = None
    if not entry[0]:
      fa.set_block_want(*key, 128, 3)
      forced = {k: fa.tile_for_want(k, D, torch.bfloat16, 128, 3)
                for k in table}
      state, step, batch, rng = arms["table"]
      fa.reset_counts()
      step(state, batch, rng)
      torch.cuda.synchronize()
      got = _flash_by_tile(fa)
      assert got == {k: {forced[k]: layers} for k in forced}, got
      log(f"   a set entry (want 128, 3 stages): K1 launches {got}")
  finally:
    use("table")
  del arms
  gc.collect()
  torch.cuda.empty_cache()
  flops = gpt_flops_per_token(cfg, S) * P27_BATCH * S
  out = {}
  for arm, ts in times.items():
    step_s = min(ts)
    out[arm] = dict(step_ms=step_s * 1e3, mfu=flops / step_s /
                    PEAK_OPS_PER_S["bfloat16"],
                    chains_ms=[t * 1e3 for t in ts], losses=losses[arm],
                    by_tile={k: {f"{b[0]}x{b[1]}": n for b, n in v.items()}
                             for k, v in by_tile[arm].items()})
    log(f"   {arm:7s} step {out[arm]['step_ms']:.2f} ms (best of "
        f"{P27_CHAINS} chains of {P27_CHAIN_STEPS}; chains "
        f"{[round(t * 1e3, 2) for t in ts]}), MFU {out[arm]['mfu']:.4f}")
  log(f"   table / default step: "
      f"{out['table']['step_ms'] / out['default']['step_ms']:.4f}")
  out["entry"], out["forced"] = entry, forced
  return out


def tile_phase(torch, fa, bench):
  t0 = time.monotonic()
  with Phase("27a. K1's tile builds against their plain versions"):
    infos, worst = tile_builds_parity(torch, fa)
  with Phase("27b. the block sweep at bench.py's shape and S 8192, D 128"):
    rows = tile_sweep(torch)
  with Phase("27c. bench.py's GPT-350M step with the committed block table "
             "against the default build"):
    step = table_step(torch, fa, bench)
  wall = time.monotonic() - t0
  log(f"   27. wall {wall:.1f} s")
  assert wall < P27_WALL_S, f"phase 27 took {wall:.0f} s"
  return dict(infos=infos, worst=worst, rows=rows, step=step)


def layer_norm_phase(torch, bench):
  """Phase 28: K3 against its plain version and its times at the
  benchmark's rows, then its launches on a GPT step."""
  from easyparallellibrary_tpu_torch.kernels import layer_norm as ln
  import torch.nn.functional as F
  R, d = LN_BENCH_SHAPE
  eps = 1e-6
  r = np.random.RandomState(28)
  dev = torch.device("cuda")

  def draw(shape, scale=1.0, shift=0.0):
    return torch.from_numpy((shift + scale * r.randn(*shape)).astype(
        np.float32)).to(dev)

  x = draw((R, d), shift=0.5).to(torch.bfloat16)
  dy = draw((R, d)).to(torch.bfloat16)
  w, b = draw((d,), 0.5, 1.0), draw((d,), 0.5)
  with Phase("28a. K3 vs its plain version at [65536, 1024] bf16"):
    ln.reset_counts()
    y = ln.layer_norm_fwd_cuda(x, w, b, eps, torch.bfloat16)
    grads = ln.layer_norm_bwd_cuda(x, w, dy, eps)
    torch.cuda.synchronize()
    want_y = ln.layer_norm_reference(x, w, b, eps, torch.bfloat16)
    want = ln.layer_norm_bwd_reference(x, w, b, dy, eps)
    # tests/test_torch_layer_norm.py's tolerances: one bf16 ulp (2^-7)
    # and 4e-5 for outputs, 1e-4 for the fp32 column sums.
    torch.testing.assert_close(y.float(), want_y.float(), rtol=2.0 ** -7,
                               atol=4e-5)
    torch.testing.assert_close(grads[0].float(), want[0].float(),
                               rtol=2.0 ** -7, atol=4e-5)
    for got, ref in zip(grads[1:], want[1:]):
      torch.testing.assert_close(got, ref, rtol=1e-4,
                                 atol=1e-4 * ref.abs().max().item())
    errs = {name: normalized_errors(g, h) for name, g, h in zip(
        ("y", "dx", "dgamma", "dbeta"), (y,) + tuple(grads),
        (want_y,) + tuple(want))}
    for name, (rel, mx) in errs.items():
      log(f"   {name:6s} rel l2 {rel:.3e}, max rel {mx:.3e}")
    again = ln.layer_norm_bwd_cuda(x, w, dy, eps)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    log("   dx, dgamma, dbeta bit-equal on a second run")
    del y, grads, again, want_y, want

  with Phase("28b. K3 timing at [65536, 1024] bf16"):
    n = R * d
    bound = {"fwd": (4 * n + 8 * d) / HBM_BYTES_PER_S * 1e3,
             "bwd": (6 * n + 12 * d) / HBM_BYTES_PER_S * 1e3}
    args = [(x, w, b, dy), (x.clone(), w, b, dy.clone())]
    xs = [a[0].clone().requires_grad_() for a in args]
    ws = [(w.clone().requires_grad_(), b.clone().requires_grad_())
          for _ in args]
    plain_graph = [ln._formula(xi, wi, bi, eps, torch.bfloat16)
                   for xi, (wi, bi) in zip(xs, ws)]
    wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
    lib_graph = [F.layer_norm(xi, (d,), wl, bl, eps) for xi in xs]
    times = {
        "fwd": time_ms(torch, lambda x_, w_, b_, _: ln.layer_norm_fwd_cuda(
            x_, w_, b_, eps, torch.bfloat16), args),
        "bwd": time_ms(torch, lambda x_, w_, _, dy_: ln.layer_norm_bwd_cuda(
            x_, w_, dy_, eps), args),
        "plain_fwd": time_ms(torch, lambda x_, w_, b_, _: ln._formula(
            x_, w_, b_, eps, torch.bfloat16), args),
        "plain_bwd": time_ms(torch, lambda yi, xi, wb, dy_:
                             torch.autograd.grad(yi, (xi,) + wb, dy_,
                                                 retain_graph=True),
                             [(yi, xi, wb, a[3]) for yi, xi, wb, a in
                              zip(plain_graph, xs, ws, args)]),
        "library_fwd": time_ms(torch, lambda x_, *_: F.layer_norm(
            x_, (d,), wl, bl, eps), args),
        "library_bwd": time_ms(torch, lambda yi, xi, dy_:
                               torch.autograd.grad(yi, (xi,), dy_,
                                                   retain_graph=True),
                               [(yi, xi, a[3]) for yi, xi, a in
                                zip(lib_graph, xs, args)]),
    }
    del plain_graph, lib_graph, xs, ws
    small = draw((8, d)).to(torch.bfloat16)
    host = {"fwd": host_us(torch, lambda: ln.layer_norm_fwd_cuda(
        small, w, b, eps, torch.bfloat16), ()),
            "bwd": host_us(torch, lambda: ln.layer_norm_bwd_cuda(
                small, w, small, eps), ())}
    for k in ("fwd", "bwd"):
      log(f"   {k}: kernel {times[k]:.4f} ms, bound {bound[k]:.4f} ms "
          f"(bytes; {100 * bound[k] / times[k]:.1f}% of it), plain "
          f"{times['plain_' + k]:.4f} ms, F.layer_norm "
          f"{times['library_' + k]:.4f} ms, host {host[k]:.1f} us a call")
    del x, dy

  with Phase("28c. K3 on bench.py's GPT-350M bf16 step, 4 layers"):
    cfg = bench.bench_config(dev, num_layers=LN_STEP_LAYERS)[0]
    state, step, batch, rng, _ = bench.build_training(cfg, LN_STEP_BATCH,
                                                      "cuda")
    ln.reset_counts()
    for _ in range(LN_STEP_STEPS):
      state, metrics = step(state, batch, rng)
    torch.cuda.synchronize()
    launches = {"fwd": ln.layer_norm_fwd_cuda.launches,
                "bwd": ln.layer_norm_bwd_cuda.launches}
    plain = (ln.layer_norm_reference.calls, ln.layer_norm_bwd_reference.calls)
    want_launches = {"fwd": LN_STEP_STEPS * (4 * LN_STEP_LAYERS + 1),
                     "bwd": LN_STEP_STEPS * (2 * LN_STEP_LAYERS + 1)}
    log(f"   K3 launches {launches} over {LN_STEP_STEPS} steps "
        f"(want {want_launches}); plain calls {plain}; loss "
        f"{metrics['loss'].item():.4f}")
    assert launches == want_launches and plain == (0, 0), (launches, plain)
    assert np.isfinite(metrics["loss"].item())
    del state, step
  return dict(errs=errs, times=times, bound=bound, host_us=host,
              launches=launches)


def kernel_record(torch_name, build, source, replaces, launches, err, row,
                  rel, limit, dtype="bf16", **extra):
  return {**extra, "name": torch_name, "route": "cuda", "build": build,
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
  serving = (4, 5, 6, 12, 13, 14, 15, 16, 17, 19, 20, 21, 22, 23)
  smi = ""
  # The serving phases' GPT-350M weights are drawn (numpy, one core)
  # while nvcc builds the kernels.
  draw = any(map(want, serving))
  with Phase("1. build kernels" + ("; meanwhile init GPT-350M weights "
                                   "(numpy, seed 0)" if draw else "")):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
      built = pool.submit(build_kernels)
      if draw:
        t0 = time.monotonic()
        params = init_params(GPTConfig(**GPT_350M), seed=0, device="cuda")
        log(f"   GPT-350M weights drawn in {time.monotonic() - t0:.1f} s")
      if want(23):
        t0 = time.monotonic()
        moe_params = init_params(GPTConfig(**dict(
            MOE_CFG, dtype=torch.bfloat16)), seed=0, device="cuda")
        log(f"   GPT-MoE weights drawn in {time.monotonic() - t0:.1f} s")
      if want(24):
        t0 = time.monotonic()
        bert_params = init_params(bert_config(torch), seed=BERT_SEED,
                                  device="cuda")
        split_params = init_params(resnet_cfg(
            torch, num_classes=SPLIT_CLASSES), seed=0, device="cuda")
        log(f"   BERT-Large and ResNet-50 (131072 classes) weights drawn "
            f"in {time.monotonic() - t0:.1f} s")
      smi = built.result()
  if draw:
    serve = depth_cut(params, SERVE_LAYERS)
  if want(2):
    with Phase("2. kernel vs plain version"):
      errs = kernel_parity(torch, pa)
  if want(3):
    with Phase("3. kernel timing"):
      times = kernel_timing(torch, pa)
  # Reference streams of generate(use_cache=False), by prompt set, shared
  # between the paged phases and phase 14, which serves the same prompts.
  refs = {"float32": {}, "bfloat16": {}, "spec": {}}
  if want(4):
    with Phase("4. GPT-350M fp32: engine vs generate(use_cache=False)"):
      warp_launches = engine_fp32_vs_generate(torch, serve, pa,
                                              refs["float32"])
  if want(5) or want(6):
    with Phase("5. GPT-350M bf16: serving staggered requests"):
      launches, eng = engine_bf16_serving(torch, serve, pa,
                                          refs["bfloat16"])
    with Phase("6. GPT-350M bf16: where the engine step's time goes"):
      step_breakdown(torch, eng)
    del eng
  if want(12):
    with Phase("12. GPT-350M bf16: speculative serving (n-gram, then "
               "self-draft)"):
      spec = speculative_serving(torch, serve, pa, refs["spec"])
  if want(13):
    with Phase("13. GPT-350M bf16: prefix caching (shared system prompt, "
               "second turns)"):
      prefix = prefix_cache_serving(torch, serve, pa)
  if want(14):
    with Phase("14. GPT-350M: the contiguous-slot engine (default config)"):
      contiguous_serving(torch, serve, pa, refs)
  if want(15):
    with Phase("15. GPT-350M bf16: serving resilience (paged with the "
               "prefix cache, contiguous)"):
      serving_resilience(torch, serve, pa)
  if want(16):
    with Phase("16a. fp16 builds vs plain versions"):
      fp16_routes = flash_routes(torch, fa)
      paged_routes(torch, pa)
      fp16_flash_errs, fp16_flash_rel = fp16_flash_parity(torch, fa)
      fp16_paged_err, fp16_paged_rel = fp16_paged_parity(torch, pa)
    with Phase("16b. fp16 kernel timing"):
      fp16_flash_times, fp16_paged_times = fp16_timing(torch, fa, pa)
    with Phase("16c. amp O1 training (bench's step) and O1-fp16 serving"):
      fp16_flash_launches_4l = amp_training(torch, fa, bench)
      fp16_flash_launches, o1_full = o1_fp16_full_width(torch, fa, bench,
                                                        params)
      fp16_tiled_launches = fp16_serving(torch, serve, pa)
    with Phase("16d. fp16 q over bf16 pools (the tiled build's mixed "
               "instantiation): parity, timing, O1-fp16 serving over a bf16 "
               "config"):
      mixed_err, mixed_rel = mixed_paged_parity(torch, pa)
      mixed_times = mixed_timing(torch, pa)
      mixed_launches = mixed_serving(torch, serve, pa)
  if want(17):
    with Phase("17. GPT-350M bf16: serving observability (traced against "
               "untraced, device truth, SLO, contiguous)"):
      observability_serving(torch, serve, pa)
  if want(19):
    with Phase("19. GPT-350M bf16: the replicated fleet (router, in-process "
               "and process replicas, SIGKILL failover, drain, traces)"):
      fleet_launches = fleet_serving(torch, serve, pa)
  if want(20):
    with Phase("20. GPT-350M bf16: the self-healing fleet (autotuner, "
               "golden episode, rollout, reactor, front door)"):
      heal_launches = self_healing_fleet(torch, serve, pa,
                                         refs["bfloat16"])
  del refs
  p24 = None
  if want(21) and want(24):
    gc.collect()
    torch.cuda.empty_cache()
    p24 = phase24_parent(torch, fa, bert_params, split_params, smi)
    del bert_params, split_params
  p23 = None
  if want(21) and want(23):
    gc.collect()
    torch.cuda.empty_cache()
    t23 = time.monotonic()
    p23 = phase23_parent(torch, fa, bench, params, moe_params)
    del moe_params
  p26 = None
  if want(21):
    gc.collect()
    torch.cuda.empty_cache()
    p26_root = tempfile.mkdtemp(prefix="epl_phase26_") if want(26) else None
    with Phase("21. the tensor-parallel mesh on torch.distributed (TP = 2 "
               "serving and training, DP, ZeRO-1, the overlap ring)"
               + ("; 22. the pipeline in the same rank group" if want(22)
                  else "")
               + ("; 23b, 23c in the same rank group" if p23 else "")
               + ("; 26. sharded checkpoints in the same rank group"
                  if p26_root else "")):
      try:
        tp = tensor_parallel_mesh(torch, pa, fa, params, pipeline=want(22),
                                  p23=p23, p24=p24, p26_root=p26_root)
      finally:
        if p26_root:
          shutil.rmtree(p26_root, ignore_errors=True)
    p26 = tp["p26"]
    if p23 is not None:
      with Phase("23d. ZeRO v1 and v0 under the smap pipeline, four ranks"):
        t0 = time.monotonic()
        tp["p23"]["pipeline_zero"] = pipeline_zero_phase(torch)
        pz_s = time.monotonic() - t0
      log(f"   23. wall {p23['wall_s'] + p23['group_wall_s'] + pz_s:.1f} s "
          f"(23a and the reference {p23['wall_s']:.1f} s, 23b and 23c on "
          f"phase 21's ranks {p23['group_wall_s']:.1f} s, 23d {pz_s:.1f} s)")
      assert time.monotonic() - t23 < TP_PHASE_WALL_S + P23_WALL_S
  elif want(22):
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("22. the pipeline on torch.distributed (S = 2 stage ranks)"):
      pipeline_phase(torch, fa, params)
  if want(23) and not want(21):
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("23. MoE, sequence parallelism and ZeRO under the pipeline"):
      phase23_alone(torch, fa, bench, params, moe_params)
    del moe_params
  if want(26) and not want(21):
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("26. checkpoints of a sharded training state (TP, ZeRO-1, "
               "smap 1F1B) and serving from one, two ranks"):
      p26 = phase26_alone(torch, pa)
  if want(24) and not want(21):
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("24. BERT and ResNet"):
      p24 = phase24_alone(torch, fa, bert_params, split_params, smi)
    del bert_params, split_params
  if p24 is not None:
    p24_wall = p24["wall_s"] + p24["group_wall_s"]
    log(f"   24. wall {p24_wall:.1f} s (24a, 24b, 24d and 24e's reference "
        f"{p24['wall_s']:.1f} s, 24c and 24e on the ranks "
        f"{p24['group_wall_s']:.1f} s) ({smi})")
    assert p24_wall < P24_WALL_S, f"phase 24 took {p24_wall:.0f} s"
  tool_params = None
  if any(map(want, serving)):
    if want(25):
      # Phase 25a's step takes the serving draw's weights (bench.py's
      # seed-0 draw), kept on the host meanwhile.
      tool_params = {k: v.cpu() for k, v in params.items()}
    del params, serve
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
  if want(18):
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("18. GPT-350M bf16: fit() with checkpoints, resume, sentinel "
               "and rollback"):
      fit_launches, ckpt_paged = training_runtime(
          torch, fa, pa, bench, widths=dict(GPT_350M, num_layers=RT_LAYERS))
  if want(18) or want(19):
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("18g. GPT-350M bf16: host offload at bench.py's "
               "configuration"):
      off_state, offload_launches, *native_s = offload_training(
          torch, fa, bench)
    with Phase("18h. the DCP checkpoint path (torch.distributed."
               "checkpoint)"):
      dcp_checkpoint(torch, off_state, native_s)
    del off_state
  if want(25):
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("25. the tooling: profile_step, the profilers, the perf gate, "
               "the evidence writer, the examples, collective_bytes"):
      tool = tooling_phase(
          torch, fa, pa, bench, smi,
          record["detail"]["peak_hbm_gb"] if want(10) else "(not run)",
          tp if want(21) else None, tool_params)
    del tool_params
  if want(27):
    gc.collect()
    torch.cuda.empty_cache()
    p27 = tile_phase(torch, fa, bench)
  if want(28):
    gc.collect()
    torch.cuda.empty_cache()
    p28 = layer_norm_phase(torch, bench)
  log(f"total {time.monotonic() - t_start:.1f} s")
  if only is not None:
    return 0

  flash_src = "easyparallellibrary_tpu_torch/kernels/csrc/flash_attention.cu"
  flash_py = "easyparallellibrary_tpu/kernels/flash_attention.py"
  def tp_flash(k):
    # Phase 21c's launches on each rank and the per-rank shape's record;
    # phase 22's launches on each stage rank, by run; phase 23's by run
    # (23a one card, 23b and 23c each rank, 23d each rank by ZeRO level);
    # phase 24's (24a's BERT-Large on one card, 24c's each stage rank)
    # and 24b's record of the kernel without the mask at BERT's shape.
    p23 = tp["p23"]
    return dict(launches_tp2=[rank[k] for rank in tp["training"]],
                tp2_b16_h8=tp["flash"][k],
                launches_pipeline={name: [rank[k] for rank in ranks]
                                   for name, ranks in tp["pipeline"].items()},
                launches_moe=p23["moe_one_card"][k],
                launches_moe_a2a=[r[k] for r in p23["moe_a2a"]],
                launches_sequence={name: [r[k] for r in ranks] for name, ranks
                                   in p23["sequence"].items()},
                launches_pipeline_zero={
                    lvl: [r[k] for r in ranks]
                    for lvl, ranks in p23["pipeline_zero"].items()},
                launches_bert=p24["bert"]["launches"][k],
                launches_bert_pipeline=[rank[k] for rank in tp["p24"]],
                bert_full_b8_h16_s512=p24["flash"][k],
                launches_profile_step=tool["profile_step"][k],
                launches_profilers=tool["profilers"][k],
                launches_example=tool["example"][k],
                launches_offload_all=tool["offload_all"][k],
                launches_sharded_checkpoint={
                    name: [rank[k] for rank in ranks]
                    for name, ranks in p26["flash"].items()},
                launches_block_table_step={
                    arm: p27["step"][arm]["by_tile"][k]
                    for arm in ("table", "default")},
                block_table_step={arm: {m: p27["step"][arm][m] for m in
                                        ("step_ms", "mfu")}
                                   for arm in ("table", "default")})

  # The builds bench.py's shape takes (the block table's) and, by kernel,
  # each build's ms alone at that shape (27b), registers and spills (27a).
  bench_builds = {k: fa.flash_tile(k, FLASH_BENCH_SHAPE["S"], 64,
                                   torch.bfloat16) for k in flash_errs}

  def build_name(kernel, dtype_name):
    tile, stages = bench_builds[kernel]
    base = {"fwd": "flash_fwd", "dkv": "flash_bwd_dkv",
            "dq": "flash_bwd_dq"}[kernel]
    return (f"{base}_wgmma_kernel<{dtype_name}, 64, {tile}, {stages}>")

  bench_row = next(r for r in p27["rows"]
                   if (r["S"], r["D"]) == (FLASH_BENCH_SHAPE["S"], 64))

  def tile_builds(kernel):
    return {f"{b[0]}x{b[1]}": dict(
        ms=bench_row["kernel_ms"][kernel].get(f"{b[0]}x{b[1]}"),
        **p27["infos"]["bfloat16", 64, kernel, b])
        for b in fa.WGMMA_BUILDS[kernel, 64]}

  flash_records = [
      kernel_record("flash_attention_fwd", build_name("fwd", "__nv_bfloat16"),
                    flash_src, f"{flash_py}:89 and :241",
                    flash_launches["fwd"], flash_errs["fwd"],
                    flash_times["fwd"], flash_rel["fwd"],
                    FLASH_BF16_LIMIT["fwd"],
                    launches_fit=fit_launches["fwd"],
                    launches_offload=offload_launches["fwd"],
                    tile_builds=tile_builds("fwd"), **tp_flash("fwd")),
      kernel_record("flash_attention_bwd_dkv",
                    build_name("dkv", "__nv_bfloat16"),
                    flash_src,
                    f"{flash_py}:133 and :363", flash_launches["dkv"],
                    flash_errs["dkv"], flash_times["dkv"],
                    flash_rel["dkv"], FLASH_BF16_LIMIT["grad"],
                    launches_fit=fit_launches["dkv"],
                    launches_offload=offload_launches["dkv"],
                    tile_builds=tile_builds("dkv"), **tp_flash("dkv")),
      kernel_record("flash_attention_bwd_dq",
                    build_name("dq", "__nv_bfloat16"), flash_src,
                    f"{flash_py}:172 and :404",
                    flash_launches["dq"], flash_errs["dq"],
                    flash_times["dq"], flash_rel["dq"],
                    FLASH_BF16_LIMIT["grad"],
                    launches_fit=fit_launches["dq"],
                    launches_offload=offload_launches["dq"],
                    tile_builds=tile_builds("dq"), **tp_flash("dq")),
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

  # The fp16 rows' launches are the full-width O1-fp16 run's (16c).
  fp16_flash = [
      kernel_record(name, build, flash_src, replaces,
                    fp16_flash_launches[k], fp16_flash_errs[k],
                    fp16_flash_times[k], fp16_flash_rel[k],
                    FLASH_FP16_LIMIT["fwd" if k == "fwd" else "grad"],
                    dtype="fp16", build_route=fp16_routes[k],
                    bf16_ms_same_phase=fp16_flash_times[k]["bf16_kernel_ms"],
                    launches_o1_4_layers=fp16_flash_launches_4l[k],
                    o1_fp16_step=o1_full)
      for name, k, build, replaces in (
          ("flash_attention_fwd_fp16", "fwd", build_name("fwd", "__half"),
           f"{flash_py}:89 and :241"),
          ("flash_attention_bwd_dkv_fp16", "dkv",
           build_name("dkv", "__half"), f"{flash_py}:133 and :363"),
          ("flash_attention_bwd_dq_fp16", "dq", build_name("dq", "__half"),
           f"{flash_py}:172 and :404"))]

  def tiled_16bit_record(name, build, launches, times, err, rel, limit,
                         dtype, tag, warp_build, warp_err, warp_rel):
    # The tiled build at engine_step (hd 64), the warp build it replaced
    # timed beside it and still held at hd 32 (16a / 16d).
    row = times["engine_step"]
    return {"name": name, "route": "cuda", "build": build,
            "source": paged_src, "replaces": paged_replaces,
            "launches": launches, "max_abs_err": err, "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "dtype": dtype, "shape": "engine_step",
            "warp_build": warp_build, "warp_build_ms": row["warp_build_ms"],
            "kernel_ms_again": row["kernel_ms_again"],
            "spec_step": times["spec_step"],
            f"{tag}_rel_l2_err": rel[0], f"{tag}_max_rel_err": rel[1],
            f"{tag}_rel_l2_limit": limit["rel_l2"],
            f"{tag}_max_rel_limit": limit["max_rel"],
            "warp_build_hd32_max_abs_err": warp_err,
            "warp_build_hd32_rel_err": warp_rel}

  fp16_paged = tiled_16bit_record(
      "paged_attention_tiled_fp16",
      "paged_attention_tiled_kernel<__half, __half, __half, 64>",
      fp16_tiled_launches, fp16_paged_times, fp16_paged_err["tiled"],
      fp16_paged_rel["tiled"], PAGED_FP16_LIMIT, "float16", "fp16",
      "paged_attention_kernel<__half, __half, __half, 1>",
      fp16_paged_err["warp"], fp16_paged_rel["warp"])
  mixed_paged = tiled_16bit_record(
      "paged_attention_tiled_fp16_bf16",
      "paged_attention_tiled_kernel<__half, __nv_bfloat16, float, 64>",
      mixed_launches, mixed_times, mixed_err["tiled"], mixed_rel["tiled"],
      PAGED_MIXED_LIMIT, "float16 q, bfloat16 pools", "mixed",
      "paged_attention_kernel<__half, __nv_bfloat16, float, 1>",
      mixed_err["warp"], mixed_rel["warp"])
  print(json.dumps({"kernels": [
      dict(paged_record("paged_attention_tiled",
                        "paged_attention_tiled_kernel<__nv_bfloat16, "
                        "__nv_bfloat16, __nv_bfloat16, 64>", launches,
                        "bfloat16"),
           launches_speculative=spec, launches_prefix_cache={
               k: v["launches"] for k, v in prefix.items()},
           launches_from_checkpoint=ckpt_paged,
           launches_fleet=fleet_launches,
           launches_self_heal=heal_launches["self_heal"],
           launches_rollout=heal_launches["rollout"],
           launches_rollout_children=heal_launches["rollout_children"],
           launches_reactor_children=heal_launches["reactor_children"],
           launches_frontdoor=heal_launches["frontdoor"],
           launches_tp2=tp["serving"], tp2_engine_step_h8=tp["paged"],
           tp_backend=tp["backend"], launches_perfgate=tool["perfgate_k2"],
           launches_checkpoint_serving=p26["paged"]),
      paged_record("paged_attention_warp",
                   "paged_attention_kernel<float, float, float, 1>",
                   warp_launches, "float32"),
  ] + flash_records + fp16_flash + [fp16_paged, mixed_paged] + [
      {"name": f"layer_norm_{k}", "route": "cuda",
       "build": f"layer_norm_{k}_kernel<__nv_bfloat16, __nv_bfloat16>",
       "source": "easyparallellibrary_tpu_torch/kernels/csrc/layer_norm.cu",
       "replaces": "none (the eager LayerNorm formula)",
       "launches": p28["launches"][k], "ms": p28["times"][k],
       "plain_ms": p28["times"][f"plain_{k}"],
       "bound_ms": p28["bound"][k], "bound_by": "bytes",
       "library_ms": p28["times"][f"library_{k}"],
       "host_us": p28["host_us"][k], "shape": list(LN_BENCH_SHAPE),
       "rel_errs": {n: p28["errs"][n] for n in (
           ("y",) if k == "fwd" else ("dx", "dgamma", "dbeta"))}}
      for k in ("fwd", "bwd")]}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
