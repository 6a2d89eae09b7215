"""Megatron-interleaved 1F1B (port of
``easyparallellibrary_tpu/parallel/pipeline_interleaved.py``).

Virtual pipeline stages: each of the S ranks holds K non-adjacent model
chunks (rank d owns virtual stages d, d + S, ..., d + (K-1)S), so the
waves cross a rank K times per micro-batch and the ramp shrinks from
2(S-1) ticks of K-chunk work (plain 1F1B) to 2(S-1) + (K-1)S ticks of
one-chunk work.  The schedule is a table in the JAX package already: a
host-side list scheduler (:func:`build_interleaved_schedule`, kept as
the JAX package has it) walks Megatron's virtual-micro-batch order
under the engine's dataflow rules (one forward and one backward slot a
rank a tick, a hop arriving the next tick, the emit's cotangent usable
the same tick), validates the result, and emits per-tick tables.  The
port hands its forward and backward rows to the per-rank executor
(``parallel/pipeline.py``); every virtual-stage boundary is one hop on
the ring (stage v lives on rank v mod S), so interleaving changes only
the table.  Each chunk is a parameter subtree of its own
(``pipeline_{k}``), as in the JAX model's parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from easyparallellibrary_tpu_torch.parallel.pipeline import (
    PipeSchedule, Pipeline, make_ticks)


@dataclasses.dataclass(frozen=True)
class InterleavedSchedule:
  """Static tick tables, all shaped [T, S] (or [T])."""
  S: int
  K: int
  M: int
  T: int
  W: int                     # buffer depth (slots per chunk)
  f_valid: np.ndarray        # device runs a fwd sub-tick
  f_chunk: np.ndarray
  f_mb: np.ndarray
  b_valid: np.ndarray
  b_chunk: np.ndarray
  b_mb: np.ndarray
  rf_valid: np.ndarray       # arriving fwd payload must be buffered
  rf_chunk: np.ndarray
  rf_slot: np.ndarray
  rb_valid: np.ndarray       # arriving bwd cotangent must be buffered
  rb_chunk: np.ndarray
  rb_slot: np.ndarray
  emit_valid: np.ndarray     # [T] last virtual stage leaves the pipe
  emit_mb: np.ndarray        # [T]
  # TICK-GLOBAL micro-batch indices for the collective feed.  feed_fn /
  # its VJP may contain stage collectives (the vocab-sharded embedding's
  # psum), so every device must evaluate them for the SAME micro-batch
  # each tick — device 0 is the only consumer, so the tables follow its
  # chunk-0 schedule (the same reason emit_mb is tick-global).
  feed_mb: np.ndarray        # [T]
  fb_mb: np.ndarray          # [T]
  busy_slots: int            # occupied (device, direction) slots
  total_slots: int           # 2 * T * S


def build_interleaved_schedule(S: int, K: int, M: int
                               ) -> InterleavedSchedule:
  """List-schedule Megatron's interleaved order onto engine ticks.

  Greedy ASAP per tick: each device advances its next forward op when
  the producer's output has arrived (ring hop: produced at t' is
  consumable at t'+1) and the 1F1B pacing window allows
  (fwds_done < warmup + bwds_done + 1, bounding in-flight micro-batches
  per device at warmup+1); each device advances its next backward op
  when the consumer-side cotangent is available (emit cotangent: same
  tick as the final-stage forward).  Deadlock-free by construction for
  the Megatron order; the result is re-validated against the dependency
  rules before use.
  """
  if S < 2:
    raise ValueError("interleaved pipeline needs at least 2 stages")
  if K < 1:
    raise ValueError("interleave factor must be >= 1")
  total = M * K
  V = S * K

  def forder(dev):
    ops = []
    for g in range(0, M, S):
      n = min(S, M - g)
      for j in range(K):
        ops.extend((j * S + dev, m) for m in range(g, g + n))
    return ops

  def border(dev):
    ops = []
    for g in range(0, M, S):
      n = min(S, M - g)
      for j in reversed(range(K)):
        ops.extend((j * S + dev, m) for m in range(g, g + n))
    return ops

  warm = [min((S - d - 1) * 2 + (K - 1) * S, total) for d in range(S)]
  f_ops = [forder(d) for d in range(S)]
  b_ops = [border(d) for d in range(S)]
  f_done, b_done = {}, {}
  fi, bi = [0] * S, [0] * S
  rows_f, rows_b = [], []
  t = 0
  while any(fi[d] < total or bi[d] < total for d in range(S)):
    if t > 4 * (total + 2 * V) + 16:
      raise RuntimeError(
          f"interleaved schedule failed to converge (S={S}, K={K}, "
          f"M={M}) — scheduler bug")
    row_f, row_b = [None] * S, [None] * S
    for d in range(S):
      if fi[d] < total and fi[d] < warm[d] + bi[d] + 1:
        v, m = f_ops[d][fi[d]]
        if v == 0 or f_done.get((v - 1, m), 1 << 30) + 1 <= t:
          row_f[d] = (v, m)
          f_done[(v, m)] = t
          fi[d] += 1
    for d in range(S):
      if bi[d] < total:
        v, m = b_ops[d][bi[d]]
        ok = (f_done.get((v, m), 1 << 30) <= t if v == V - 1
              else b_done.get((v + 1, m), 1 << 30) + 1 <= t)
        if ok:
          row_b[d] = (v, m)
          b_done[(v, m)] = t
          bi[d] += 1
    rows_f.append(row_f)
    rows_b.append(row_b)
    t += 1
  T = t

  # Buffer depth: peak in-flight micro-batches per (device, chunk).
  # Slots are keyed mb % W; FIFO order per chunk makes that collision-free
  # as long as W covers the in-flight window.
  peak = 1
  cnt = {}
  events = sorted(
      [(tt, 0, (v % S, v // S)) for (v, m), tt in f_done.items()] +
      [(tt, 1, (v % S, v // S)) for (v, m), tt in b_done.items()],
      key=lambda e: (e[0], e[1]))
  for _, typ, key in events:
    cnt[key] = cnt.get(key, 0) + (1 if typ == 0 else -1)
    peak = max(peak, cnt[key])
  W = min(M, peak + 1)

  def tables(rows, fill):
    valid = np.zeros((T, S), np.bool_)
    chunk = np.full((T, S), fill, np.int32)
    mb = np.full((T, S), fill, np.int32)
    for tt, row in enumerate(rows):
      for d, x in enumerate(row):
        if x is not None:
          v, m = x
          valid[tt, d] = True
          chunk[tt, d] = v // S
          mb[tt, d] = m
    return valid, chunk, mb

  f_valid, f_chunk, f_mb = tables(rows_f, 0)
  b_valid, b_chunk, b_mb = tables(rows_b, 0)

  # Receive-side tables: what the ring delivers at tick t is what the
  # neighbor produced at t-1.  Forward: device d receives from d-1 (mod
  # S); the payload of virtual stage v is consumed by v+1, which lives on
  # device d with chunk v//S (+1 on the ring wrap).  The final virtual
  # stage's output goes to emit, not the ring.
  rf_valid = np.zeros((T, S), np.bool_)
  rf_chunk = np.zeros((T, S), np.int32)
  rf_slot = np.zeros((T, S), np.int32)
  rb_valid = np.zeros((T, S), np.bool_)
  rb_chunk = np.zeros((T, S), np.int32)
  rb_slot = np.zeros((T, S), np.int32)
  emit_valid = np.zeros((T,), np.bool_)
  emit_mb = np.zeros((T,), np.int32)
  for tt in range(T):
    for d in range(S):
      dp = (d - 1) % S
      if tt > 0 and f_valid[tt - 1, dp]:
        v = int(f_chunk[tt - 1, dp]) * S + dp
        if v + 1 < V:
          assert (v + 1) % S == d
          rf_valid[tt, d] = True
          rf_chunk[tt, d] = (v + 1) // S
          rf_slot[tt, d] = f_mb[tt - 1, dp] % W
      dn = (d + 1) % S
      if tt > 0 and b_valid[tt - 1, dn]:
        v = int(b_chunk[tt - 1, dn]) * S + dn
        if v - 1 >= 0:
          assert (v - 1) % S == d
          rb_valid[tt, d] = True
          rb_chunk[tt, d] = (v - 1) // S
          rb_slot[tt, d] = b_mb[tt - 1, dn] % W
    if f_valid[tt, S - 1] and f_chunk[tt, S - 1] == K - 1:
      emit_valid[tt] = True
      emit_mb[tt] = f_mb[tt, S - 1]
  feed_mb = np.zeros((T,), np.int32)
  fb_mb = np.zeros((T,), np.int32)
  for tt in range(T):
    if f_valid[tt, 0] and f_chunk[tt, 0] == 0:
      feed_mb[tt] = f_mb[tt, 0]
    if b_valid[tt, 0] and b_chunk[tt, 0] == 0:
      fb_mb[tt] = b_mb[tt, 0]

  # Re-validate the tables against the dependency rules (the engine
  # replays exactly these): every consumed value must have been produced
  # and delivered in time.
  for (v, m), tt in f_done.items():
    if v > 0:
      assert f_done[(v - 1, m)] + 1 <= tt, (v, m)
  for (v, m), tt in b_done.items():
    if v == V - 1:
      assert f_done[(v, m)] <= tt, (v, m)
    else:
      assert b_done[(v + 1, m)] + 1 <= tt, (v, m)
  assert len(f_done) == V * M and len(b_done) == V * M

  busy = int(f_valid.sum() + b_valid.sum())
  return InterleavedSchedule(
      S=S, K=K, M=M, T=T, W=W,
      f_valid=f_valid, f_chunk=f_chunk, f_mb=f_mb,
      b_valid=b_valid, b_chunk=b_chunk, b_mb=b_mb,
      rf_valid=rf_valid, rf_chunk=rf_chunk, rf_slot=rf_slot,
      rb_valid=rb_valid, rb_chunk=rb_chunk, rb_slot=rb_slot,
      emit_valid=emit_valid, emit_mb=emit_mb,
      feed_mb=feed_mb, fb_mb=fb_mb,
      busy_slots=busy, total_slots=2 * T * S)


def interleaved_pipe_schedule(S: int, K: int, M: int) -> PipeSchedule:
  """The executor's table of :func:`build_interleaved_schedule`, with
  stage remat."""
  sched = build_interleaved_schedule(S, K, M)

  def rows(valid, chunk, mb):
    return [[(int(chunk[t, d]), int(mb[t, d])) if valid[t, d] else None
             for d in range(S)] for t in range(sched.T)]

  return PipeSchedule(
      "interleaved", S, K, M,
      make_ticks(S, K, rows(sched.f_valid, sched.f_chunk, sched.f_mb),
                 rows(sched.b_valid, sched.b_chunk, sched.b_mb)),
      remat_stage=True)


def make_smap_interleaved_grad_fn(feed_fn: Callable, stage_fn: Callable,
                                  emit_fn: Callable, num_stages: int,
                                  interleave: int, num_micro_batch: int, *,
                                  act_shape: Sequence[int],
                                  act_dtype: torch.dtype, device,
                                  mesh=None) -> Callable:
  """Interleaved-1F1B gradient function with stage-resident boundary
  layers (``pipeline_smap``'s contracts; ``stage_fn(chunk, x, m)`` takes
  this rank's local chunk index).  Returns ``grad_fn(mbs,
  loss_scale=None) -> loss`` (the executor)."""
  return Pipeline(interleaved_pipe_schedule(num_stages, interleave,
                                            num_micro_batch),
                  feed_fn, stage_fn, emit_fn, act_shape=act_shape,
                  act_dtype=act_dtype, device=device,
                  collective_boundary=True, mesh=mesh)
