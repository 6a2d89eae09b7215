"""Paged continuous-batching inference engine (port of
``easyparallellibrary_tpu/serving/engine.py``, paged mode).

One device step per iteration fuses the prefill chunks of newly admitted
requests and the one-token decodes of every other active slot into a
single ``[token_budget]`` flat batch against the paged KV pool
(``models.gpt.paged_step_logits``); each token is tagged with its slot
and absolute position, and attends through its slot's block table — on
the GPU with the hand-written CUDA kernel
(``kernels/csrc/paged_attention.cu``), whose bf16 build takes the step's
query tiles, planned here once per step from the scheduler's plan.  The
step's input shapes never change: joins, leaves and block-table
reshuffles are data.

:class:`FCFSScheduler` owns all host-side variability (admission,
budgets, preemption, retirement); this module owns the device step.
Sampling runs per slot (:func:`sample_token_slots`) with each request's
counter key folded by its token index, so a request's samples do not
depend on which slot or iteration serves it.  PyTorch runs eagerly, so
the step is written out directly (the JAX package jits it) and the pool
is written in place (the JAX package donates it).  The step makes one
designated device-to-host fetch: the sampled tokens.

Speculative decoding (``speculative=True``, ``drafter=``, or
``serving.speculative.*``; serving/speculative/) rides the same step:
the scheduler reserves each decode slot's draft run on leftover flat
positions, the drafter fills it, the one model call scores it, and
``verify_tokens`` commits each slot's accepted drafts plus one
correction or bonus token.  Prefix caching (``prefix_cache=True``;
serving/prefix_cache.py) is the scheduler's: warm admissions map shared
blocks and prefill only the tail.

Exactness contract: greedy engine output equals ``generate()`` per
request, including requests admitted mid-flight, slots and blocks reused
after retirement, requests preempted on pool exhaustion, speculative
steps and warm admissions.

Not ported (each raises, ROADMAP.md Queue 1): the contiguous slot engine
(``paged=False``), a device mesh, serving resilience, and the metric
registry.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch._not_ported import (
    CONTIGUOUS_ENGINE, FLEET, RESILIENCE, TENSOR_PARALLEL, TRACING,
    not_ported)
from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.kernels import paged_attention as pa_lib
from easyparallellibrary_tpu_torch.serving import kv_cache as kv_lib
from easyparallellibrary_tpu_torch.serving._capabilities import (
    check_draft_fits_chunk, check_servable)
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FCFSScheduler, FinishedRequest, Request)
from easyparallellibrary_tpu_torch.utils import prng
from easyparallellibrary_tpu_torch.utils.device import resolve_device
from easyparallellibrary_tpu_torch.utils.logging import get_logger
from easyparallellibrary_tpu_torch.weights import cast_for_compute


def filtered_logits(logits, temperature, top_k, top_p):
  """Per-row temperature / top-k / top-p filtering with per-row
  parameters (same filter semantics and order as ``sample_logits``).

  ``logits`` [M, V]; ``temperature``/``top_p`` f32 [M]; ``top_k`` int
  [M] (0 disables).  Returns the scaled, filtered logits (filtered
  entries at -1e30)."""
  V = logits.shape[-1]
  neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
  t = torch.where(temperature > 0, temperature,
                  torch.ones_like(temperature))[:, None]
  scaled = logits / t.to(logits.dtype)
  # top-k: threshold at the k-th largest value (ties at it survive).
  sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
  kth = torch.gather(sorted_desc, 1,
                     torch.clamp(top_k.long() - 1, 0, V - 1)[:, None])
  k_off = (top_k[:, None] <= 0) | (top_k[:, None] >= V)
  scaled = torch.where((scaled >= kth) | k_off, scaled, neg)
  # top-p over the survivors: keep entries whose preceding mass is < p.
  sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
  probs = torch.softmax(sorted_desc.float(), dim=-1)
  cum = torch.cumsum(probs, dim=-1)
  keep_sorted = (cum - probs) < top_p[:, None]
  inf = torch.tensor(float("inf"), dtype=scaled.dtype, device=scaled.device)
  thresh = torch.where(keep_sorted, sorted_desc, inf).min(
      dim=-1, keepdim=True).values
  p_on = top_p[:, None] < 1.0
  return torch.where(p_on & (scaled < thresh), neg, scaled)


def sample_token_slots(logits, keys, temperature, top_k, top_p):
  """Per-slot sampling with per-slot parameters; ``temperature<=0`` is
  greedy (the first maximum).  ``logits`` [N, V]; ``keys`` int64
  [N, 2] counter keys (already folded with each slot's token index).
  Returns int64 [N] token ids."""
  greedy = torch.argmax(logits, dim=-1)
  sampled = prng.categorical(keys, filtered_logits(logits, temperature,
                                                   top_k, top_p))
  return torch.where(temperature <= 0, greedy, sampled)


class ContinuousBatchingEngine:
  """Paged continuous-batching decode engine for a (non-pipelined) GPT.

  ``model`` is a ``models.gpt.GPT`` and ``params`` its state dict
  (``weights.init_params`` / ``weights.from_jax_params``); the engine
  keeps a copy cast to the compute dtype, and the KV pool, on
  ``device`` (default ``"cuda"``; ``"cpu"`` must be asked for).  Knobs
  default from the port's ``Config`` ``serving.*`` group.

      eng = ContinuousBatchingEngine(model, params, paged=True)
      eng.submit(Request(uid="a", prompt=ids, max_new_tokens=32))
      outputs = eng.run()          # {uid: prompt+generated np.int32}
      eng.finished["a"].finish_reason

  ``drafter_failures`` counts the steps whose drafter raised (each ran
  without drafts).
  """

  def __init__(self, model, params, *, device=None, mesh=None,
               num_slots: Optional[int] = None,
               prefill_chunk: Optional[int] = None,
               prefill_token_budget: Optional[int] = None,
               max_batch: Optional[int] = None,
               stop_token: Optional[int] = None,
               drafter=None, speculative: Optional[bool] = None,
               draft_model=None, draft_params=None,
               resilience: Optional[bool] = None,
               paged: Optional[bool] = None,
               block_size: Optional[int] = None,
               num_blocks: Optional[int] = None,
               token_budget: Optional[int] = None,
               prefix_cache: Optional[bool] = None,
               stats=None, registry=None, config=None):
    cfg = model.cfg
    root_config = config if config is not None else Env.get().config
    conf = root_config.serving
    check_servable(cfg)
    if mesh is not None:
      raise not_ported("a device mesh", TENSOR_PARALLEL)
    if not (paged if paged is not None else conf.paged.enabled):
      raise not_ported("the contiguous slot engine (paged=False)",
                       CONTIGUOUS_ENGINE)
    if resilience or (resilience is None and conf.resilience.enabled):
      raise not_ported("serving resilience", RESILIENCE)
    if registry is not None:
      raise not_ported("the metric registry", TRACING)
    if conf.autotune.enabled:
      raise not_ported("the serving autotuner", FLEET)
    if root_config.observability.enabled:
      raise not_ported("serving observability", TRACING)
    self.device = resolve_device(device)
    self.model = model
    self.params = cast_for_compute(
        {k: v.to(self.device) for k, v in params.items()}, cfg.dtype)
    self.num_slots = num_slots if num_slots is not None else conf.num_slots
    self.chunk = (prefill_chunk if prefill_chunk is not None
                  else conf.prefill_chunk)
    if self.chunk > cfg.max_seq_len:
      raise ValueError(f"prefill_chunk {self.chunk} exceeds max_seq_len "
                       f"{cfg.max_seq_len}")
    budget = (prefill_token_budget if prefill_token_budget is not None
              else conf.prefill_token_budget)
    if 0 < budget < self.chunk:
      raise ValueError(
          f"prefill_token_budget {budget} below prefill_chunk "
          f"{self.chunk}: no admission could ever afford its first chunk")
    pconf = conf.paged
    self.block_size = (block_size if block_size is not None
                       else pconf.block_size)
    kv_lib.blocks_per_slot(cfg, self.block_size)
    self.num_blocks = (num_blocks if num_blocks is not None
                       else pconf.num_blocks)
    if self.num_blocks <= 0:
      self.num_blocks = kv_lib.default_num_blocks(cfg, self.num_slots,
                                                  self.block_size)
    self.token_budget = (token_budget if token_budget is not None
                         else pconf.token_budget)
    if self.token_budget <= 0:
      # Auto: every decode slot's guaranteed token plus two prefill
      # chunks of admission headroom per step.
      self.token_budget = self.num_slots + 2 * self.chunk
    pc_conf = conf.prefix_cache
    self.prefix_caching = (prefix_cache if prefix_cache is not None
                           else pc_conf.enabled)
    self.drafter = self._resolve_drafter(conf, drafter, speculative,
                                         draft_model, draft_params)
    self.drafter_failures = 0
    self.scheduler = FCFSScheduler(
        num_slots=self.num_slots, prefill_chunk=self.chunk,
        max_seq_len=cfg.max_seq_len, prefill_token_budget=budget,
        max_batch=max_batch if max_batch is not None else conf.max_batch,
        stop_token=stop_token if stop_token is not None
        else conf.stop_token,
        spec_k=self.drafter.k if self.drafter is not None else 0,
        block_size=self.block_size, num_blocks=self.num_blocks,
        token_budget=self.token_budget, prefix_cache=self.prefix_caching,
        prefix_session_ttl_s=pc_conf.session_ttl_s,
        prefix_max_cached_blocks=pc_conf.max_cached_blocks)
    self.stats = stats
    self.finished: Dict[Any, FinishedRequest] = {}
    self._finished_limit = conf.finished_limit
    self.scheduler.on_finish.append(self._record_finished)
    if self.stats is not None:
      stats_obj = self.stats
      self.scheduler.on_admit.append(stats_obj.note_admitted)
      self.scheduler.on_first_token.append(stats_obj.note_first_token)
      self.scheduler.on_finish.append(
          lambda fin: stats_obj.note_finished(fin.uid, fin.new_tokens,
                                              fin.finish_reason))
    self._kv = kv_lib.allocate_paged_kv_cache(
        cfg, self.num_blocks, self.block_size, self.device)
    if self.drafter is not None:
      self.drafter.bind(self)
    self._steps = 0
    get_logger().info(
        "serving engine: %d slots x chunk %d (paged: %d x %d-token blocks, "
        "token budget %d, %.1f MB, %s), prefill budget %s, max batch %d",
        self.num_slots, self.chunk, self.num_blocks, self.block_size,
        self.token_budget,
        kv_lib.paged_cache_bytes(cfg, self.num_blocks, self.block_size)
        / 1e6, self.device, budget or "uncapped", self.scheduler.max_batch)

  def _resolve_drafter(self, conf, drafter, speculative, draft_model,
                       draft_params):
    """``speculative=False`` wins over everything; otherwise an explicit
    ``drafter`` wins, and ``serving.speculative.*`` decides the rest
    (``speculative=True`` overrides its ``enabled``).  A drafter must
    fit the chunk (k + 1 <= prefill_chunk)."""
    from easyparallellibrary_tpu_torch.serving.speculative import (
        DraftModelDrafter, NgramDrafter)
    if speculative is False:
      return None
    spec = conf.speculative
    if drafter is None and (spec.enabled or speculative):
      if spec.kind == "ngram":
        drafter = NgramDrafter(k=spec.k, ngram_max=spec.ngram_max,
                               ngram_min=spec.ngram_min)
      else:  # "draft_model" (config validation rejects anything else)
        if draft_model is None or draft_params is None:
          raise ValueError(
              "serving.speculative.kind='draft_model' needs the drafter's "
              "weights: pass draft_model=/draft_params= or a drafter= "
              "instance")
        drafter = DraftModelDrafter(draft_model, draft_params, k=spec.k)
    if drafter is not None:
      check_draft_fits_chunk(drafter.k, self.chunk)
    return drafter

  # ----------------------------------------------------------- device step

  def _tensor(self, array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

  def _score(self, plan) -> torch.Tensor:
    """Run the plan's flat batch through the model (writing its K/V into
    the pool); returns the logits ``[T, V]``."""
    from easyparallellibrary_tpu_torch.models.gpt import paged_step_logits
    # The attention kernel's tiled build takes the step's query tiles,
    # which the plan already knows: planned here once for every layer.
    pool = self._kv["block_0"]["attn"]["cached_key"]
    tiles = {}
    if pa_lib.needs_tiles(pool):
      runs = pa_lib.tile_runs_from_plan(
          plan.base_idx, plan.num_valid, self.token_budget,
          plan.draft_base, plan.draft_cap)
      tiles["tiles"] = pa_lib.plan_tiles(
          runs, plan.positions, plan.block_tables.shape[1], pool.shape[1],
          pool.shape[2], self.device)
    logits, self._kv = paged_step_logits(
        self.model, self.params, self._kv, self._tensor(plan.tokens),
        self._tensor(plan.slot_ids), self._tensor(plan.positions),
        self._tensor(plan.valid), self._tensor(plan.block_tables), **tiles)
    return logits

  @torch.inference_mode()
  def _device_step(self, plan) -> np.ndarray:
    """The fused step: score the flat batch, gather each slot's last
    scheduled row, sample.  Returns the sampled tokens ``[N]`` on the
    host — the step's one designated device-to-host fetch."""
    T = self.token_budget
    logits = self._score(plan)
    # Each slot's next-token logits sit at its last scheduled flat
    # position; idle slots read row 0, which the scheduler never reads.
    last_idx = np.clip(plan.base_idx + plan.num_valid - 1, 0, T - 1)
    last = logits.index_select(0, self._tensor(last_idx).long())
    step_keys = prng.fold_in(self._tensor(plan.keys.astype(np.int64)),
                             self._tensor(plan.tok_index))
    nxt = sample_token_slots(
        last.float(), step_keys, self._tensor(plan.temperature),
        self._tensor(plan.top_k), self._tensor(plan.top_p))
    return nxt.cpu().numpy()

  @torch.inference_mode()
  def _spec_device_step(self, plan, num_draft: np.ndarray):
    """The speculative step: score the flat batch (drafts included),
    gather each slot's K+1 target rows by flat index (row 0 at its last
    real token, rows 1..K at its draft positions), verify.  Returns
    ``(committed [N, K+1], n_committed [N])`` from one device-to-host
    fetch.  Rejected drafts' K/V lie past the committed count; the next
    feed overwrites them."""
    from easyparallellibrary_tpu_torch.serving.speculative.verify import (
        verify_tokens)
    T, K = self.token_budget, self.drafter.k
    logits = self._score(plan)
    base_last = np.clip(plan.base_idx + plan.num_valid - 1, 0, T - 1)
    j = np.arange(K + 1)[None]
    idx = np.concatenate(
        [base_last[:, None], plan.draft_base[:, None] + j[:, :K]], axis=1)
    # Rows past a slot's draft count read its own last row; the verifier
    # masks them.
    idx = np.clip(np.where(j <= num_draft[:, None], idx,
                           base_last[:, None]), 0, T - 1)
    dpos = np.clip(plan.draft_base[:, None] + j[:, :K], 0, T - 1)
    N = idx.shape[0]
    tgt = logits.index_select(0, self._tensor(idx.reshape(-1)).long())
    committed, n_committed, _ = verify_tokens(
        tgt.reshape(N, K + 1, -1).float(), self._tensor(plan.tokens[dpos]),
        self._tensor(num_draft), self._tensor(plan.keys.astype(np.int64)),
        self._tensor(plan.tok_index), self._tensor(plan.temperature),
        self._tensor(plan.top_k), self._tensor(plan.top_p))
    out = torch.cat([committed, n_committed[:, None]], dim=1).cpu().numpy()
    return out[:, :K + 1], out[:, K + 1]

  def _propose_drafts(self, plan) -> np.ndarray:
    """Run the drafter for one step and write its drafts into the plan's
    reserved positions (flipping exactly those live).  A drafter that
    raises degrades to zero drafts for the step (verification would
    reject garbage anyway) and is counted in ``drafter_failures``.
    Returns ``num_draft [N]``."""
    N = plan.draft_cap.shape[0]
    if not self.scheduler.spec_enabled:
      self.drafter.observe_skip(plan)
      return np.zeros((N,), np.int32)
    try:
      histories = self.scheduler.slot_histories(plan)
      draft_tokens, num_draft = self.drafter.propose(plan, histories)
      num_draft = np.clip(np.asarray(num_draft, np.int32), 0,
                          plan.draft_cap)
      for slot in np.nonzero(num_draft)[0]:
        nd, b = int(num_draft[slot]), int(plan.draft_base[slot])
        plan.tokens[b:b + nd] = draft_tokens[slot, :nd]
        plan.valid[b:b + nd] = True
    except Exception as e:  # noqa: BLE001 — any drafter fault degrades
      self.drafter_failures += 1
      if self.drafter_failures == 1:
        get_logger().warning(
            "drafter %s failed (%s: %s); serving continues without drafts "
            "this step (logged once; counted in drafter_failures)",
            type(self.drafter).__name__, type(e).__name__, e)
      # Drafts written before the failure stay out of the step.
      for slot in np.nonzero(plan.draft_cap)[0]:
        b = int(plan.draft_base[slot])
        plan.valid[b:b + int(plan.draft_cap[slot])] = False
      return np.zeros((N,), np.int32)
    return num_draft

  # ------------------------------------------------------------ host loop

  def _record_finished(self, fin: FinishedRequest) -> None:
    """Record a resolution, evicting oldest-first past
    ``serving.finished_limit`` (0 = unbounded)."""
    self.finished.pop(fin.uid, None)
    self.finished[fin.uid] = fin
    if self._finished_limit > 0:
      while len(self.finished) > self._finished_limit:
        self.finished.pop(next(iter(self.finished)))

  def submit(self, request: Request) -> bool:
    """Validate and enqueue ``request``.  Always True: admission control
    (shedding) belongs to serving resilience, which is not ported."""
    prompt = self.scheduler.validate(request)
    if self.stats is not None:
      self.stats.note_submitted(request.uid)
    self.scheduler.submit(request, _prompt=prompt)
    return True

  def cancel(self, uid: Any) -> bool:
    """Retire ``uid`` wherever it is; the record lands in
    ``self.finished`` at once and in the next ``step()``'s return."""
    return self.scheduler.cancel(uid)

  @property
  def has_work(self) -> bool:
    return self.scheduler.has_work

  @property
  def steps(self) -> int:
    """Device steps run so far (iterations whose plan was not None)."""
    return self._steps

  def step(self) -> List[FinishedRequest]:
    """One engine iteration: plan -> [draft ->] device step -> commit.
    Returns the requests that retired this iteration (empty when idle),
    expiries and cancellations included."""
    plan = self.scheduler.plan_step()
    if plan is None:
      return self.scheduler.take_finished()
    t0 = time.monotonic()
    drafted = accepted = 0
    if self.drafter is not None:
      # Propose before the plan's draft positions fill: the draft
      # model's mirror needs the plan the target sees.
      num_draft = self._propose_drafts(plan)
      committed, n_committed = self._spec_device_step(plan, num_draft)
      finished = self.scheduler.commit(committed, n_committed)
      self.drafter.observe_commit(None)
      drafted = int(num_draft.sum())
      accepted = int((n_committed[num_draft > 0] - 1).sum())
    else:
      finished = self.scheduler.commit(self._device_step(plan))
    self._steps += 1
    dt = time.monotonic() - t0
    if self.stats is not None:
      self.stats.note_step(
          active_slots=plan.active_slots, num_slots=self.num_slots,
          prefill_tokens=plan.prefill_tokens,
          decode_tokens=plan.decode_tokens, step_time_s=dt,
          drafted_tokens=drafted, accepted_tokens=accepted)
      self.stats.note_blocks(self.scheduler.kv_blocks_free,
                             self.scheduler.kv_blocks_used,
                             self.scheduler.kv_fragmentation,
                             self.scheduler.preemptions,
                             self.scheduler.proactive_preemptions)
      if self.prefix_caching:
        self.stats.note_prefix(self.scheduler.prefix_hits,
                               self.scheduler.prefix_misses,
                               self.scheduler.prefix_blocks_reused,
                               self.scheduler.prefix_evictions,
                               self.scheduler.prefix_cached_blocks)
    return finished

  def run(self, max_steps: Optional[int] = None) -> Dict[Any, np.ndarray]:
    """Drive until the queue drains (or ``max_steps``); returns
    ``{uid: prompt+generated}`` for every request finished during the
    call."""
    out: Dict[Any, np.ndarray] = {}
    steps = 0
    while self.has_work and (max_steps is None or steps < max_steps):
      for fin in self.step():
        out[fin.uid] = fin.tokens
      steps += 1
    return out
