"""Drafters: cheap token proposers for speculative decoding (port of
``easyparallellibrary_tpu/serving/speculative/drafter.py``).

* :class:`NgramDrafter`: prompt-lookup decoding, proposing the
  continuation of the most recent earlier occurrence of the request's
  own trailing n-gram.  Host work only, no weights.
* :class:`DraftModelDrafter`: a small GPT (the target's vocabulary, any
  depth or width) rolled greedily ``k`` tokens ahead per slot, against a
  cache of its own in the engine's layout: a slot cache whose cursors
  follow the engine's, or paged pools that the engine's block tables
  address.

Both propose deterministically (a point-mass proposal), for which the
verifier's rejection sampling keeps the target distribution exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.serving._capabilities import (
    check_draft_compatible)


def ngram_propose(history: np.ndarray, k: int, ngram_max: int,
                  ngram_min: int) -> np.ndarray:
  """Prompt-lookup proposal: up to ``k`` continuation tokens of the most
  recent earlier occurrence of ``history``'s trailing n-gram, longest
  n-gram first (``ngram_max`` down to ``ngram_min``).  Empty when
  nothing matches."""
  history = np.asarray(history).reshape(-1)
  L = len(history)
  for n in range(min(ngram_max, L - 1), ngram_min - 1, -1):
    suffix = history[L - n:]
    # Windows over history[:-1]: every match has a continuation token,
    # and the suffix's own occurrence is excluded.
    windows = np.lib.stride_tricks.sliding_window_view(history[:L - 1], n)
    hits = np.nonzero((windows == suffix).all(axis=1))[0]
    if hits.size:
      start = int(hits[-1]) + n
      return history[start:start + k].astype(np.int32)
  return np.zeros((0,), np.int32)


class Drafter:
  """The interface the engine drives (serving/engine.py).

  ``k`` is the most drafts per slot per step.  Each engine iteration
  calls ``propose(plan, histories)`` before the device step (the plan's
  draft positions are still empty), then ``observe_commit(cursors)``
  after it, with the contiguous engine's rolled-back cursors (None on
  the paged engine, whose next positions are the rollback).
  """

  k: int = 0

  def bind(self, engine) -> None:
    """Called once from the engine's constructor; drafters with device
    state allocate against the engine's geometry here."""

  def propose(self, plan, histories: Dict[int, np.ndarray]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``(draft_tokens [N, k] int32, num_draft [N] int32)`` for the step
    ``plan`` (``num_draft[s] <= plan.draft_cap[s]``); ``histories`` maps
    each slot with a draft reservation to its committed tokens."""
    raise NotImplementedError

  def observe_commit(self, new_cursors) -> None:
    """Engine hook after verification."""

  def observe_skip(self, plan) -> None:
    """Engine hook for a step run without drafting (speculation switched
    off): a drafter with a mirror cache may only lose acceptance."""


class NgramDrafter(Drafter):
  """Model-free prompt-lookup drafter (:func:`ngram_propose` per slot);
  ``lookback`` bounds the history scanned per step (0 = unbounded)."""

  def __init__(self, k: int = 4, ngram_max: int = 4, ngram_min: int = 1,
               lookback: int = 512):
    if not 1 <= ngram_min <= ngram_max:
      raise ValueError(f"need 1 <= ngram_min <= ngram_max; got "
                       f"ngram_min={ngram_min}, ngram_max={ngram_max}")
    if lookback < 0:
      raise ValueError(f"lookback must be >= 0 (0 = unbounded): "
                       f"{lookback}")
    self.k = int(k)
    self.ngram_max = int(ngram_max)
    self.ngram_min = int(ngram_min)
    self.lookback = int(lookback)

  def propose(self, plan, histories):
    N = plan.draft_cap.shape[0]
    toks = np.zeros((N, self.k), np.int32)
    counts = np.zeros((N,), np.int32)
    with trace_lib.get_tracer().span("ngram_propose", cat="serving",
                                     track="serving"):
      for slot, hist in histories.items():
        cap = int(plan.draft_cap[slot])
        if cap <= 0:
          continue
        if self.lookback:
          hist = hist[-self.lookback:]
        cont = ngram_propose(hist, min(cap, self.k), self.ngram_max,
                             self.ngram_min)
        counts[slot] = len(cont)
        toks[slot, :len(cont)] = cont
    return toks, counts


class DraftModelDrafter(Drafter):
  """Greedy draft-model drafter with a cache of its own.

  ``model`` / ``params`` are a GPT sharing the target's vocabulary
  (checked at bind).

  On the contiguous engine the draft model keeps a slot cache of the
  engine's geometry.  Each step mirrors the step plan's ``[num_slots,
  C]`` block through it (prefill chunks keep the cache in lockstep, each
  decode slot's last token seeds its rollout), then, when any slot
  drafts, rolls ``k - 1`` one-token steps and a write-only feed of the
  last draft.  Its cursors are the engine's: ``observe_commit`` adopts
  the engine's rolled-back vector, which is the draft side's rollback.

  On the paged engine the pools are allocated at the target's
  ``max_seq_len`` and the engine's pool size, and addressed through the
  engine's block tables: block indices depend only on positions, which
  are the same on both sides, so one host allocation serves both
  caches.  Each engine step first mirrors the step's flat batch through
  the draft model (prefill chunks keep the pools in lockstep, each
  decode slot's last token seeds its rollout), then, when any slot has a
  draft reservation, runs ``k - 1`` one-token-per-slot rollouts and a
  write-only feed of the last draft (with every draft accepted, the
  next step attends its K/V).  ``rollout_steps`` counts the steps that
  rolled out.
  """

  def __init__(self, model, params, k: int = 4, mesh=None):
    # A tensor-parallel draft model on ``mesh`` (its params whole or this
    # rank's shard): every rank of the engine's model group runs its
    # rollouts in lockstep (serving/engine.py).
    self.mesh = mesh
    self.k = int(k)
    self.model = model
    self.params = params
    self._kv = None
    self._cursors = None
    self._paged = False
    self.rollout_steps = 0

  @classmethod
  def from_checkpoint(cls, directory: str, model, *, k: int = 4,
                      target=None, shardings=None, mesh=None, device=None):
    """Restore draft params from the newest valid checkpoint under
    ``directory`` (``runtime.saver.restore_params``: a ``fit``
    checkpoint or a bare params tree, written by either package) and
    wrap them as a drafter.  The embedding's vocabulary is checked
    against ``model.cfg`` from the index alone, before any shard is
    read.  ``target`` (default: ``model``'s own parameters, shapes and
    dtypes) selects and shapes the leaves; they land on ``device``
    (default the GPU).  With ``shardings`` (``parallel.api.param_specs``
    of a tensor-parallel ``model``) each leaf is this rank's block of the
    stored logical leaf; with only ``mesh``, the whole parameters load and
    this rank keeps its slice at :meth:`bind`."""
    from easyparallellibrary_tpu_torch.runtime import saver
    leaves, _ = saver.peek_leaf_shapes(directory)
    for path, shape in leaves.items():
      name = path[len("params/"):] if path.startswith("params/") else path
      if name == "wte/embedding" and shape and \
          shape[0] != model.cfg.vocab_size:
        raise ValueError(
            f"draft checkpoint {directory!r} holds a vocab-{shape[0]} "
            f"embedding but the draft config says vocab_size="
            f"{model.cfg.vocab_size}; speculative verification needs the "
            f"target's vocabulary — restore a checkpoint trained on the "
            f"same tokenizer")
    if target is None:
      target = dict(model.named_parameters())
      if mesh is not None and shardings is None:
        # The checkpoint holds the whole parameters; this rank keeps its
        # slice at bind().
        from easyparallellibrary_tpu_torch.models.gpt import GPT
        target = dict(GPT(dataclasses.replace(
            model.cfg, tensor_parallel=False)).named_parameters())
    params, _ = saver.restore_params(directory, target=target,
                                     device=device, shardings=shardings)
    return cls(model, params, k=k, mesh=mesh)

  def bind(self, engine):
    from easyparallellibrary_tpu_torch.runtime.amp import (
        resolve_model_dtypes)
    from easyparallellibrary_tpu_torch.serving import kv_cache as kv_lib
    from easyparallellibrary_tpu_torch.weights import (
        cast_for_compute, local_params)
    check_draft_compatible(engine.model.cfg, self.model.cfg)
    if self.mesh is not None and self.mesh is not engine.mesh:
      raise ValueError("a draft model's mesh must be its engine's mesh")
    self.params = local_params(self.model, self.params, self.mesh)
    self.device = engine.device
    self.num_slots = engine.num_slots
    self.chunk = engine.chunk
    self.token_budget = engine.token_budget
    self._paged = bool(engine.paged)
    cfg = self.model.cfg
    # The dtype the draft model computes in (amp O1 resolves it from the
    # ambient config, as for the engine's model); its caches stay in
    # cfg.dtype.
    self.compute_dtype = resolve_model_dtypes(cfg).dtype
    self.params = cast_for_compute(
        {n: p.to(self.device) for n, p in self.params.items()},
        self.compute_dtype)
    if not self._paged:
      self._kv, self._cursors = kv_lib.allocate_kv_cache(
          cfg, engine.num_slots, engine.chunk, self.device)
      return
    # The engine's tables are target max_seq_len / block_size wide; only
    # the draft's head geometry shapes the pools.
    mirror_cfg = dataclasses.replace(
        cfg, max_seq_len=engine.model.cfg.max_seq_len)
    self._kv = kv_lib.allocate_paged_kv_cache(
        mirror_cfg, engine.num_blocks, engine.block_size, self.device)

  def _tensor(self, array) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

  @torch.inference_mode()
  def propose(self, plan, histories):
    if self._kv is None:
      raise RuntimeError("DraftModelDrafter.propose before bind(): the "
                         "engine binds drafters in its constructor")
    with trace_lib.get_tracer().span("draft_model_forward", cat="serving",
                                     track="serving"):
      if not self._paged:
        return self._propose_slots(plan)
      return self._propose_paged(plan)

  def _propose_slots(self, plan):
    """The contiguous layout: mirror the step's ``[N, C]`` block at the
    engine's cursors (reset slots from 0), then roll out one token per
    slot at each slot's own next position."""
    from easyparallellibrary_tpu_torch.models.gpt import slot_step_logits
    N, C, K = self.num_slots, self.chunk, self.k
    model, params = self.model, self.params
    num_valid = self._tensor(plan.num_valid)
    cursors = torch.where(self._tensor(plan.reset),
                          torch.zeros_like(self._cursors), self._cursors)
    logits, self._kv = slot_step_logits(
        model, params, self._kv, self._tensor(plan.tokens), cursors)
    counts = np.minimum(plan.draft_cap, K).astype(np.int32)
    if not counts.any():
      return np.zeros((N, K), np.int32), counts
    self.rollout_steps += 1
    rows = torch.arange(N, device=self.device)
    toks = [torch.argmax(
        logits[rows, torch.clamp(num_valid.long() - 1, 0, C - 1)], dim=-1)]
    cur = cursors + num_valid
    for j in range(1, K + 1):
      # The K-th call only writes the last draft's K/V: with every draft
      # accepted, the next step attends it.
      lg, self._kv = slot_step_logits(model, params, self._kv,
                                      toks[-1][:, None], cur)
      if j < K:
        toks.append(torch.argmax(lg[:, 0], dim=-1))
      cur = cur + 1
    # The drafter's one device-to-host fetch.
    return (torch.stack(toks, dim=1).to(torch.int32).cpu().numpy(),
            counts)

  def _propose_paged(self, plan):
    from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
    from easyparallellibrary_tpu_torch.models.gpt import paged_step_logits
    N, T, K = self.num_slots, self.token_budget, self.k
    model, params = self.model, self.params
    pool = self._kv["block_0"]["attn"]["cached_key"]
    MB = plan.block_tables.shape[1]
    # The engine's question (ContinuousBatchingEngine._score): the query
    # is in the compute dtype, which under amp O1 need not be the pool's.
    tiled = pa.needs_tiles(pool, self.compute_dtype)
    tables = self._tensor(plan.block_tables)
    # The mirror: the engine's flat batch as planned (its draft
    # positions reserved and still invalid), over the same tiles.
    tiles = {}
    if tiled:
      tiles["tiles"] = pa.plan_tiles(
          pa.tile_runs_from_plan(plan.base_idx, plan.num_valid, T,
                                 plan.draft_base, plan.draft_cap),
          plan.positions, MB, pool.shape[1], pool.shape[2], self.device)
    logits, self._kv = paged_step_logits(
        model, params, self._kv, self._tensor(plan.tokens),
        self._tensor(plan.slot_ids), self._tensor(plan.positions),
        self._tensor(plan.valid), tables, **tiles)
    counts = np.minimum(plan.draft_cap, K).astype(np.int32)
    if not counts.any():
      return np.zeros((N, K), np.int32), counts
    self.rollout_steps += 1
    last_idx = np.clip(plan.base_idx + plan.num_valid - 1, 0, T - 1)
    toks = [torch.argmax(logits.index_select(
        0, self._tensor(last_idx).long()), dim=-1)]
    # Rollout j feeds token s of slot s at position pos0[s] + j - 1.  One
    # tile plan, from the last feed's positions, serves every call: the
    # kernel bounds each row by its own position, and a split whose
    # keys all lie past it adds nothing to the combine.
    pos0 = plan.positions[last_idx].astype(np.int64) + 1
    rollout_pos = self._tensor(
        (pos0[None, :] + np.arange(K)[:, None]).astype(np.int32))
    if tiled:
      tiles["tiles"] = pa.plan_tiles(
          pa.one_row_runs(N), pos0 + K - 1, MB, pool.shape[1],
          pool.shape[2], self.device)
    sid = torch.arange(N, dtype=torch.int32, device=self.device)
    drafting = self._tensor(plan.draft_cap > 0)
    for j in range(1, K + 1):
      lg, self._kv = paged_step_logits(
          model, params, self._kv, toks[-1], sid, rollout_pos[j - 1],
          drafting, tables, **tiles)
      if j < K:
        toks.append(torch.argmax(lg, dim=-1))
    # The drafter's one device-to-host fetch.
    return (torch.stack(toks, dim=1).to(torch.int32).cpu().numpy(),
            counts)

  def observe_commit(self, new_cursors) -> None:
    # The cursors count committed tokens resident in either cache, so
    # adopting the engine's rolled-back vector is the draft side's
    # rollback (None on the paged engine).
    if not self._paged:
      self._cursors = new_cursors
