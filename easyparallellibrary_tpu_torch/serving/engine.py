"""Paged continuous-batching inference engine (port of
``easyparallellibrary_tpu/serving/engine.py``, paged mode).

One device step per iteration fuses the prefill chunks of newly admitted
requests and the one-token decodes of every other active slot into a
single ``[token_budget]`` flat batch against the paged KV pool
(``models.gpt.paged_step_logits``); each token is tagged with its slot
and absolute position, and attends through its slot's block table — on
the GPU with the hand-written CUDA kernel
(``kernels/csrc/paged_attention.cu``).  The step's input shapes never
change: joins, leaves and block-table reshuffles are data.

:class:`FCFSScheduler` owns all host-side variability (admission,
budgets, preemption, retirement); this module owns the device step.
Sampling runs per slot (:func:`sample_token_slots`) with each request's
counter key folded by its token index, so a request's samples do not
depend on which slot or iteration serves it.  PyTorch runs eagerly, so
the step is written out directly (the JAX package jits it) and the pool
is written in place (the JAX package donates it).  The step makes one
designated device-to-host fetch: the sampled tokens.

Exactness contract: greedy engine output equals ``generate()`` per
request, including requests admitted mid-flight, slots and blocks reused
after retirement, and requests preempted on pool exhaustion.

Not ported (each raises, ROADMAP.md Queue 1): the contiguous slot engine
(``paged=False``), a device mesh, speculative decoding, serving
resilience, the prefix cache, and the metric registry.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch._not_ported import (
    CONTIGUOUS_ENGINE, FLEET, PREFIX_CACHE, RESILIENCE, SPECULATIVE,
    TENSOR_PARALLEL, TRACING, not_ported)
from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.serving import kv_cache as kv_lib
from easyparallellibrary_tpu_torch.serving._capabilities import (
    check_servable)
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
  """

  def __init__(self, model, params, *, device=None, mesh=None,
               num_slots: Optional[int] = None,
               prefill_chunk: Optional[int] = None,
               prefill_token_budget: Optional[int] = None,
               max_batch: Optional[int] = None,
               stop_token: Optional[int] = None,
               drafter=None, speculative: Optional[bool] = None,
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
    if drafter is not None or speculative or (
        speculative is None and conf.speculative.enabled):
      raise not_ported("speculative decoding", SPECULATIVE)
    if resilience or (resilience is None and conf.resilience.enabled):
      raise not_ported("serving resilience", RESILIENCE)
    if prefix_cache or (prefix_cache is None and
                        conf.prefix_cache.enabled):
      raise not_ported("prefix caching", PREFIX_CACHE)
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
    self.scheduler = FCFSScheduler(
        num_slots=self.num_slots, prefill_chunk=self.chunk,
        max_seq_len=cfg.max_seq_len, prefill_token_budget=budget,
        max_batch=max_batch if max_batch is not None else conf.max_batch,
        stop_token=stop_token if stop_token is not None
        else conf.stop_token,
        block_size=self.block_size, num_blocks=self.num_blocks,
        token_budget=self.token_budget)
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
    self._steps = 0
    get_logger().info(
        "serving engine: %d slots x chunk %d (paged: %d x %d-token blocks, "
        "token budget %d, %.1f MB, %s), prefill budget %s, max batch %d",
        self.num_slots, self.chunk, self.num_blocks, self.block_size,
        self.token_budget,
        kv_lib.paged_cache_bytes(cfg, self.num_blocks, self.block_size)
        / 1e6, self.device, budget or "uncapped", self.scheduler.max_batch)

  # ----------------------------------------------------------- device step

  def _tensor(self, array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

  @torch.inference_mode()
  def _device_step(self, plan) -> np.ndarray:
    """The fused step: score the flat batch, gather each slot's last
    scheduled row, sample.  Returns the sampled tokens ``[N]`` on the
    host — the step's one designated device-to-host fetch."""
    from easyparallellibrary_tpu_torch.models.gpt import paged_step_logits
    T = self.token_budget
    last_idx = (plan.base_idx + plan.num_valid - 1).astype(np.int32)
    logits, self._kv = paged_step_logits(
        self.model, self.params, self._kv, self._tensor(plan.tokens),
        self._tensor(plan.slot_ids), self._tensor(plan.positions),
        self._tensor(plan.valid), self._tensor(plan.block_tables))
    # Each slot's next-token logits sit at its last scheduled flat
    # position; idle slots read row 0, which the scheduler never reads.
    last = logits.index_select(
        0, torch.clamp(self._tensor(last_idx).long(), 0, T - 1))
    step_keys = prng.fold_in(self._tensor(plan.keys.astype(np.int64)),
                             self._tensor(plan.tok_index))
    nxt = sample_token_slots(
        last.float(), step_keys, self._tensor(plan.temperature),
        self._tensor(plan.top_k), self._tensor(plan.top_p))
    return nxt.cpu().numpy()

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
    """One engine iteration: plan -> device step -> commit.  Returns the
    requests that retired this iteration (empty when idle), expiries and
    cancellations included."""
    plan = self.scheduler.plan_step()
    if plan is None:
      return self.scheduler.take_finished()
    t0 = time.monotonic()
    nxt = self._device_step(plan)
    finished = self.scheduler.commit(nxt)
    self._steps += 1
    dt = time.monotonic() - t0
    if self.stats is not None:
      self.stats.note_step(
          active_slots=plan.active_slots, num_slots=self.num_slots,
          prefill_tokens=plan.prefill_tokens,
          decode_tokens=plan.decode_tokens, step_time_s=dt)
      self.stats.note_blocks(self.scheduler.kv_blocks_free,
                             self.scheduler.kv_blocks_used,
                             self.scheduler.kv_fragmentation,
                             self.scheduler.preemptions,
                             self.scheduler.proactive_preemptions)
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
