"""Host-side request scheduling for the continuous-batching engine on
both cache layouts (port of
``easyparallellibrary_tpu/serving/scheduler.py``).

Iteration-level (continuous) batching as in Orca (OSDI'22): the
scheduler re-forms the working set every engine step, so requests join
the moment a slot frees and leave the moment they finish.  All host-side
variability lives here; the device step only ever sees fixed shapes.

* Admission: latency-class requests first, then FCFS, gated by free
  slots, the concurrent-batch cap (``max_batch``) and the per-step
  prefill-token budget; a latency-class arrival that finds no capacity
  evicts the youngest throughput-class slot.
* Slot planning (``block_size=0``, the contiguous engine): one
  :class:`StepPlan` of ``[num_slots, chunk]`` tokens per step; a
  decoding slot feeds its last token, a prefilling slot its next prompt
  chunk under the prefill-token budget, and a fresh or replaying slot
  zeroes its cursor (``reset``).  Its drafts ride the decode slot's
  unused chunk columns (``draft_cap``).
* Token-flat planning (paged, :meth:`FCFSScheduler._plan_flat`): every
  decoding slot gets one guaranteed token, then prefill chunks fill the rest of
  the ``token_budget`` flat batch.  Each grant first ensures its K/V
  blocks; a dry pool preempts the youngest lowest-priority slot, which
  returns to the front of the queue and replays its committed prefix on
  readmission (bit-exact: same K/V, same token-index RNG fold).
* Speculative drafts (paged): leftover flat budget is reserved for each decode
  slot's draft run (pass 3); a dry pool shrinks the reservation and
  never preempts.  ``commit`` takes ``[N, K+1]`` tokens with a per-slot
  count and checks the stop token and ``max_new_tokens`` per token.
* Prefix cache (``prefix_cache=True``, serving/prefix_cache.py): warm
  admission maps matched blocks by reference and starts prefill past
  them; completed blocks register at commit watermarks and at
  retirement; cached blocks are evicted before any preemption.
* Resilience: ``commit(slot_ok=...)`` skips a slot whose step was judged
  bad, so the next plan re-feeds the same work (the retry);
  ``requeue_slot`` sends a request back to the front of the queue with
  its committed prefix, ``retire_slot`` fails it, and
  ``budget_override`` clamps the prefill budget while the degradation
  ladder says so.
* Retirement: ``max_new_tokens``, stop token, deadlines / TTFT budgets,
  cancellation.  Each request samples from its own counter stream (a key
  from ``seed``/``uid`` folded with the token index), so its samples do
  not depend on the slot or iteration that serves it.
* Tracing (observability/trace.py): each request's lifecycle is one span
  on its slot's track (``<track_prefix>/slot <i>``), opened at admission
  and closed at retirement, requeue or preemption; instants mark submit,
  first token, requeue and queue-side retirement; one Perfetto flow per
  request (``Request.flow_id``, minted at submit) runs from submit
  through every admission to its end.
* Migration: :meth:`FCFSScheduler.snapshot_requests` /
  :meth:`restore_request` / :meth:`evacuate` move queued and in-flight
  requests between replicas as JSON-serializable snapshots (the JAX
  package's wire shape, ``Request.snapshot`` v2); a restored request
  replays prompt + committed prefix through chunked prefill, so its
  stream resumes where it stopped.  ``checkpoint_version`` scopes the
  prefix tree and refuses a snapshot pinned to other weights.
* Autotuner clamps (serving/autotune.py): ``tune_budget``,
  ``tune_slot_cap`` and ``tune_spec_k`` move between steps and steer
  admission and planning only.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import zlib
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.serving._capabilities import (
    check_request_fields)
from easyparallellibrary_tpu_torch.serving.kv_cache import (
    BlockAllocator, SlotAllocator)
from easyparallellibrary_tpu_torch.serving.prefix_cache import PrefixCache
from easyparallellibrary_tpu_torch.utils.logging import get_logger
from easyparallellibrary_tpu_torch.utils.prng import prng_key


def _slot_track(slot: int, prefix: str = "serving") -> str:
  """Perfetto track name for one KV-cache slot: every request this slot
  serves renders its lifecycle span here."""
  return f"{prefix}/slot {slot}"


# Flow-context ids (Perfetto flow events): one id per request lifetime,
# minted at the first submit the request reaches.  Process-unique is all
# a trace needs; minting is unconditional (a plain int), so enabling the
# tracer mid-run never sees id-less requests.
_FLOW_IDS = itertools.count(1)


def next_flow_id() -> int:
  return next(_FLOW_IDS)


# Request.snapshot() wire-format version, the JAX package's: v2 added
# ``checkpoint_version``; a v1 snapshot (or one without "v") reads with
# it None ("any version").  Snapshots cross process boundaries (the
# process transport, its crash journal), so an unknown version raises.
SNAPSHOT_VERSION = 2


def _request_key(req: "Request") -> np.ndarray:
  """The request's private sampling key: deterministic in ``seed`` (or
  crc32 of ``uid``, stable across processes), laid out like the JAX
  package's ``PRNGKey(seed)``."""
  seed = req.seed if req.seed is not None else zlib.crc32(
      str(req.uid).encode())
  return prng_key(seed)


@dataclasses.dataclass
class Request:
  """One generation request (fields as in the JAX package).

  ``prompt`` is a non-empty 1-D int32 token array.  ``temperature<=0``
  is greedy; ``top_k``/``top_p`` as ``sample_logits``.  ``stop_token <
  0`` disables stop-token retirement; a hit stop token is included in
  the output.  ``seed`` starts the request's sampling stream (default: a
  hash of ``uid``).  ``deadline_s`` / ``ttft_budget_s`` (0 = off) retire
  the request with reason ``"deadline"``; ``priority`` is
  ``"throughput"`` (FCFS) or ``"latency"`` (admitted first).
  ``speculative=False`` opts the request out of drafting (it keeps the
  non-speculative sample stream bit for bit).  ``flow_id`` is the
  request's trace-context id (minted at submit when None);
  ``checkpoint_version`` pins the request to the weights it started
  decoding under (stamped by the router at dispatch, carried through
  snapshots): a scheduler serving other weights refuses to restore it.
  """
  uid: Any
  prompt: np.ndarray
  max_new_tokens: int
  temperature: float = 0.0
  top_k: int = 0
  top_p: float = 1.0
  stop_token: int = -1
  seed: Optional[int] = None
  speculative: Optional[bool] = None
  deadline_s: float = 0.0
  ttft_budget_s: float = 0.0
  priority: str = "throughput"
  flow_id: Optional[int] = None
  checkpoint_version: Optional[int] = None

  def snapshot(self) -> Dict[str, Any]:
    """The request spec as a JSON-serializable dict, key for key and
    type for type the JAX package's v2 wire shape.  The sampler needs no
    field of its own: its key derives from ``seed``/``uid`` and folds by
    committed token index."""
    return {
        "v": SNAPSHOT_VERSION,
        "uid": self.uid,
        "prompt": [int(t) for t in np.asarray(self.prompt).reshape(-1)],
        "max_new_tokens": int(self.max_new_tokens),
        "temperature": float(self.temperature),
        "top_k": int(self.top_k),
        "top_p": float(self.top_p),
        "stop_token": int(self.stop_token),
        "seed": None if self.seed is None else int(self.seed),
        "speculative": self.speculative,
        "deadline_s": float(self.deadline_s),
        "ttft_budget_s": float(self.ttft_budget_s),
        "priority": self.priority,
        "flow_id": None if self.flow_id is None else int(self.flow_id),
        "checkpoint_version": (None if self.checkpoint_version is None
                               else int(self.checkpoint_version)),
    }

  @classmethod
  def restore(cls, snap: Dict[str, Any]) -> "Request":
    """Inverse of :meth:`snapshot` (survives a JSON round trip); reads
    v1 and v2, raises on any other version."""
    snap = dict(snap)
    version = snap.pop("v", 1)
    if not 1 <= version <= SNAPSHOT_VERSION:
      raise ValueError(
          f"unsupported request snapshot version {version!r}: this build "
          f"reads v1..v{SNAPSHOT_VERSION}")
    snap.setdefault("checkpoint_version", None)
    snap["prompt"] = np.asarray(snap["prompt"], np.int32)
    return cls(**snap)


@dataclasses.dataclass
class FinishedRequest:
  uid: Any
  tokens: np.ndarray          # prompt + generated (stop token included)
  new_tokens: int
  finish_reason: str          # serving._capabilities.FINISH_REASONS


@dataclasses.dataclass
class StepPlan:
  """Host arrays for one fused step over the slot cache (all ``[N]`` or
  ``[N, C]``, ``N = num_slots``, ``C = prefill_chunk``)."""
  tokens: np.ndarray          # int32 [N, C] token chunk per slot
  num_valid: np.ndarray       # int32 [N]   live tokens in the chunk
  reset: np.ndarray           # bool  [N]   zero the cursor (fresh slot)
  keys: np.ndarray            # uint32 [N, 2]
  tok_index: np.ndarray       # int32 [N]   tokens generated so far
  temperature: np.ndarray     # f32   [N]
  top_k: np.ndarray           # int32 [N]
  top_p: np.ndarray           # f32   [N]
  draft_cap: np.ndarray       # int32 [N]   max speculative drafts
  prefilling: np.ndarray      # bool  [N]   this step's grant is prompt
  prefill_tokens: int
  decode_tokens: int
  active_slots: int


@dataclasses.dataclass
class PagedStepPlan:
  """Host arrays for one token-flat step over the paged cache.  Flat
  arrays are ``[T]`` (``T = token_budget``), one entry per scheduled
  position tagged with its slot and absolute position; per-slot arrays
  are ``[N]``.  ``num_valid`` counts a slot's real tokens this step (its
  prefill grant, or 1 for decode), never its draft reservation: slot
  ``s``'s ``draft_cap[s]`` draft positions start at flat index
  ``draft_base[s]``, carry slot ``s`` and positions after its decode
  token, and stay invalid until the drafter fills them."""
  tokens: np.ndarray          # int32 [T]  flat token batch
  slot_ids: np.ndarray        # int32 [T]  owning slot per position
  positions: np.ndarray       # int32 [T]  absolute position per token
  valid: np.ndarray           # bool  [T]  live entry
  block_tables: np.ndarray    # int32 [N, MB] per-slot block tables
  base_idx: np.ndarray        # int32 [N]  slot's first flat index
  draft_base: np.ndarray      # int32 [N]  slot's first draft flat index
  num_valid: np.ndarray       # int32 [N]  real tokens scheduled
  draft_cap: np.ndarray       # int32 [N]  reserved draft positions
  prefilling: np.ndarray      # bool  [N]
  keys: np.ndarray            # uint32 [N, 2]
  tok_index: np.ndarray       # int32 [N]
  temperature: np.ndarray     # f32   [N]
  top_k: np.ndarray           # int32 [N]
  top_p: np.ndarray           # f32   [N]
  prefill_tokens: int
  decode_tokens: int
  scheduled_tokens: int       # live flat positions (diagnostics)
  active_slots: int


class _SlotState:
  """Host mirror of one occupied slot.  ``prefix`` is what chunked
  prefill feeds: the prompt, or prompt + committed tokens for a request
  replaying after preemption."""

  __slots__ = ("req", "slot", "prompt_pos", "generated", "key", "prefix",
               "submitted_at", "admitted_at", "first_token_at",
               "first_token_emitted", "requeues", "bad_streak",
               "admit_seq", "reg_blocks")

  def __init__(self, req: Request, slot: int, submitted_at: float,
               now: float, carried: Optional["_SlotState"] = None,
               admit_seq: int = 0):
    self.req = req
    self.slot = slot
    self.prompt_pos = 0
    self.submitted_at = submitted_at
    self.admitted_at = now
    self.bad_streak = 0          # consecutive bad-step hits
    # Monotonic admission sequence: a slot may only preempt strictly
    # younger same-priority slots, so two starving slots never preempt
    # each other in a cycle.
    self.admit_seq = admit_seq
    # Leading blocks already registered in (or mapped from) the prefix
    # cache: the registration watermark.
    self.reg_blocks = 0
    if carried is not None:
      self.generated: List[int] = carried.generated
      self.key = carried.key
      self.first_token_at = carried.first_token_at
      self.first_token_emitted = carried.first_token_emitted
      self.requeues = carried.requeues
      self.prefix = np.concatenate(
          [req.prompt, np.asarray(self.generated, np.int32)])
    else:
      self.generated = []
      self.key = _request_key(req)
      self.first_token_at: Optional[float] = None
      self.first_token_emitted = False
      self.requeues = 0
      self.prefix = req.prompt

  @property
  def prefilling(self) -> bool:
    return self.prompt_pos < len(self.prefix)


class _Pending:
  """Queue entry, optionally carrying a preempted request's slot state."""

  __slots__ = ("req", "submitted_at", "carried")

  def __init__(self, req: Request, submitted_at: float,
               carried: Optional[_SlotState] = None):
    self.req = req
    self.submitted_at = submitted_at
    self.carried = carried

  @property
  def prefix_len(self) -> int:
    if self.carried is not None:
      return len(self.req.prompt) + len(self.carried.generated)
    return len(self.req.prompt)

  @property
  def uid(self):
    return self.req.uid

  @property
  def prompt(self):
    return self.req.prompt

  @property
  def priority(self) -> str:
    return self.req.priority


class FCFSScheduler:
  """First-come-first-served continuous-batching scheduler over either
  cache layout: the contiguous slots (``block_size=0``) or the paged
  pool (``block_size > 0``).

  ``plan_step()`` expires dead requests, admits new ones and builds the
  next :class:`StepPlan` or :class:`PagedStepPlan`;
  ``commit(next_tokens[, num_committed][, slot_ok])`` folds the step's
  committed tokens back and returns the requests that retired.
  ``spec_k`` (0 = no drafter) caps each decode slot's draft
  reservation; ``prefix_cache`` turns on the radix tree of
  serving/prefix_cache.py with its TTL and block budget.  The
  ``on_admit`` / ``on_first_token`` / ``on_finish`` / ``on_tokens`` hooks
  are lists of subscribers.  ``clock`` is injectable for deterministic
  deadline tests.  ``track_prefix`` names the slots' Perfetto tracks.
  ``checkpoint_version`` is the version of the weights served (0 before
  any rollout): it salts the prefix tree's keys and gates
  :meth:`restore_request`.
  """

  def __init__(self, num_slots: int, prefill_chunk: int,
               max_seq_len: int, prefill_token_budget: int = 0,
               max_batch: int = 0, stop_token: int = -1,
               spec_k: int = 0, clock: Callable[[], float] = time.monotonic,
               block_size: int = 0, num_blocks: int = 0,
               token_budget: int = 0, track_prefix: str = "serving",
               prefix_cache: bool = False,
               prefix_session_ttl_s: float = 0.0,
               prefix_max_cached_blocks: int = 0,
               checkpoint_version: int = 0):
    if spec_k < 0:
      raise ValueError(f"spec_k must be >= 0: {spec_k}")
    if prefill_chunk < 1:
      raise ValueError(f"prefill_chunk must be >= 1: {prefill_chunk}")
    if prefill_token_budget < 0 or max_batch < 0:
      raise ValueError("prefill_token_budget and max_batch must be >= 0")
    self.num_slots = num_slots
    self.chunk = prefill_chunk
    self.max_seq_len = max_seq_len
    self.track_prefix = track_prefix
    self.checkpoint_version = int(checkpoint_version)
    self.preemptions = 0
    self.proactive_preemptions = 0
    self._slot_blocks: Dict[int, List[int]] = {}
    # Paged mode (block_size > 0): token-flat plans over a block-table
    # cache; pool exhaustion preempts.
    self.paged = block_size > 0
    if self.paged:
      if max_seq_len % block_size:
        raise ValueError(f"block_size {block_size} must divide "
                         f"max_seq_len {max_seq_len}")
      if token_budget < 1:
        raise ValueError(f"token_budget must be >= 1 in paged mode: "
                         f"{token_budget}")
      eff_batch = min(num_slots, max_batch if max_batch > 0 else num_slots)
      if token_budget < eff_batch:
        raise ValueError(
            f"token_budget {token_budget} below the concurrent-batch cap "
            f"{eff_batch}: a step could not hand every decoding slot its "
            f"one guaranteed token")
      self.block_size = block_size
      self.token_budget = token_budget
      self._mb = max_seq_len // block_size
      self.block_allocator = BlockAllocator(num_blocks, block_size)
      self._tables = np.zeros((num_slots, self._mb), np.int32)
      self.prefix_cache = (
          PrefixCache(self.block_allocator, block_size,
                      session_ttl_s=prefix_session_ttl_s,
                      max_cached_blocks=prefix_max_cached_blocks,
                      clock=clock, version=self.checkpoint_version)
          if prefix_cache else None)
    else:
      if prefix_cache:
        raise ValueError(
            "prefix caching shares KV at block granularity and therefore "
            "requires the paged cache: enable serving.paged (block_size "
            "> 0) alongside serving.prefix_cache")
      self.block_size = 0
      self.token_budget = 0
      self.block_allocator = None
      self.prefix_cache = None
    self._admit_seq = 0
    # Max drafts per decode slot per step (0 = no drafter); switching
    # ``spec_enabled`` off (the degradation ladder) plans no drafts,
    # Request.speculative=False opts one request out.
    self.spec_k = spec_k
    self.spec_enabled = True
    self.prefill_token_budget = prefill_token_budget
    # The degradation ladder's clamp (engine resilience): when > 0 the
    # per-step budget is min(budget or inf, override).
    self.budget_override = 0
    # The autotuner's clamps (serving/autotune.py), plan data only:
    # tune_budget (> 0) joins the budget min above, tune_slot_cap (> 0)
    # caps concurrency below max_batch, tune_spec_k (>= 0) caps each
    # slot's drafts below spec_k.  A separate gate from spec_enabled.
    self.tune_budget = 0
    self.tune_slot_cap = 0
    self.tune_spec_k = -1
    self.max_batch = max_batch if max_batch > 0 else num_slots
    self.default_stop_token = stop_token
    self.clock = clock
    self.allocator = SlotAllocator(num_slots)
    self.pending: Deque[_Pending] = deque()
    # Counts of queued latency-class entries and of queued / active
    # requests with a deadline, so the common case stays O(1) per step.
    self._latency_pending = 0
    self._deadline_pending = 0
    self._deadline_active = 0
    self.active: Dict[int, _SlotState] = {}   # slot -> state
    self._admit_order: List[int] = []         # slots, admission order
    self._plan = None
    self._finished_buffer: List[FinishedRequest] = []
    self.on_admit: List[Callable[[Any], None]] = []
    self.on_first_token: List[Callable[[Any], None]] = []
    self.on_finish: List[Callable[[FinishedRequest], None]] = []
    self.on_tokens: List[Callable[[Any, List[int]], None]] = []

  def _effective_budget(self) -> int:
    """The prefill-token budget in force: ``prefill_token_budget``
    clamped by ``budget_override`` and ``tune_budget`` (0 = uncapped in
    each)."""
    budget = self.prefill_token_budget
    if self.budget_override > 0 and (
        budget == 0 or self.budget_override < budget):
      budget = self.budget_override
    if self.tune_budget > 0 and (budget == 0 or self.tune_budget < budget):
      budget = self.tune_budget
    return budget

  @property
  def effective_max_batch(self) -> int:
    """Concurrency cap after the autotuner's slot-cap clamp (admission
    reads this; ``max_batch`` stays the configured baseline)."""
    if self.tune_slot_cap > 0:
      return min(self.max_batch, self.tune_slot_cap)
    return self.max_batch

  @property
  def effective_spec_k(self) -> int:
    """Per-slot draft cap after the autotuner's speculation clamp
    (``spec_enabled`` gates drafting separately, at planning)."""
    if self.tune_spec_k >= 0:
      return min(self.spec_k, self.tune_spec_k)
    return self.spec_k

  # ---------------------------------------------------------------- queue

  def validate(self, req: Request) -> np.ndarray:
    """Raise on a malformed request (as ``generate()`` would); returns
    the normalized prompt."""
    prompt = np.asarray(req.prompt, np.int32).reshape(-1)
    if prompt.size == 0:
      raise ValueError("request needs a non-empty prompt (at least a BOS "
                       "token) — same contract as generate()")
    if req.max_new_tokens < 1:
      raise ValueError(f"max_new_tokens must be >= 1: {req.max_new_tokens}")
    total = prompt.size + req.max_new_tokens
    if total > self.max_seq_len:
      raise ValueError(f"prompt + new tokens ({total}) exceeds "
                       f"max_seq_len {self.max_seq_len}")
    if not 0.0 < req.top_p <= 1.0:
      raise ValueError(f"top_p must be in (0, 1]: {req.top_p}")
    if req.top_k < 0:
      raise ValueError(f"top_k must be >= 0: {req.top_k}")
    check_request_fields(req)
    return prompt

  def submit(self, req: Request, _prompt: Optional[np.ndarray] = None):
    """Validate and enqueue (FCFS)."""
    prompt = self.validate(req) if _prompt is None else _prompt
    req = dataclasses.replace(req, prompt=prompt)
    if req.stop_token < 0 and self.default_stop_token >= 0:
      req = dataclasses.replace(req, stop_token=self.default_stop_token)
    # Flow-context id: minted here unless an upstream caller already did
    # (its id wins: the flow must span the whole dispatch arc).
    minted = req.flow_id is None
    if minted:
      req = dataclasses.replace(req, flow_id=next_flow_id())
    self.pending.append(_Pending(req, self.clock()))
    self._latency_pending += req.priority == "latency"
    self._deadline_pending += self._has_deadline(req)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:  # args dicts are not free; skip them when off
      tracer.instant(
          "serving/submit", cat="serving", track="serving/requests",
          args={"uid": str(req.uid), "prompt_tokens": int(prompt.size),
                "max_new_tokens": int(req.max_new_tokens)})
      # The minter starts the flow; an upstream-minted flow already has
      # its "s", and this submit is one step of its arc.
      tracer.flow("s" if minted else "t", req.flow_id,
                  track="serving/requests", args={"uid": str(req.uid)})

  @property
  def has_work(self) -> bool:
    return bool(self.pending or self.active)

  @property
  def num_active(self) -> int:
    return len(self.active)

  @property
  def queue_depth(self) -> int:
    return len(self.pending)

  def take_finished(self) -> List[FinishedRequest]:
    """Drain retirements accumulated since the last call."""
    out, self._finished_buffer = self._finished_buffer, []
    return out

  # ------------------------------------------------------ lifecycle ctl

  def _finish_unadmitted(self, entry: _Pending, reason: str):
    generated = (entry.carried.generated if entry.carried is not None
                 else [])
    fin = FinishedRequest(
        uid=entry.req.uid,
        tokens=np.concatenate(
            [entry.req.prompt, np.asarray(generated, np.int32)]),
        new_tokens=len(generated),
        finish_reason=reason)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          f"serving/{reason}", cat="serving", track="serving/requests",
          args={"uid": str(entry.req.uid), "where": "queue"})
      if entry.req.flow_id is not None:
        # Queue-side retirement terminates the flow too: every started
        # flow must reach an "f" (validate_trace).
        tracer.flow("f", entry.req.flow_id, track="serving/requests",
                    args={"uid": str(entry.req.uid), "reason": reason})
    self._finished_buffer.append(fin)
    for fn in self.on_finish:
      fn(fin)
    return fin

  @staticmethod
  def _has_deadline(req: Request) -> bool:
    return req.deadline_s > 0 or req.ttft_budget_s > 0

  def _expired(self, req: Request, submitted_at: float, now: float,
               first_token: bool) -> bool:
    waited = now - submitted_at
    if req.deadline_s > 0 and waited >= req.deadline_s:
      return True
    return (req.ttft_budget_s > 0 and not first_token
            and waited >= req.ttft_budget_s)

  def expire(self, now: Optional[float] = None) -> int:
    """Retire every queued or active request whose deadline / TTFT
    budget has passed (reason ``"deadline"``); returns how many."""
    now = self.clock() if now is None else now
    expired = 0
    if self.pending and self._deadline_pending:
      keep: Deque[_Pending] = deque()
      for entry in self.pending:
        first = (entry.carried.first_token_emitted
                 if entry.carried is not None else False)
        if self._expired(entry.req, entry.submitted_at, now, first):
          self._latency_pending -= entry.req.priority == "latency"
          self._deadline_pending -= 1
          self._finish_unadmitted(entry, "deadline")
          expired += 1
        else:
          keep.append(entry)
      self.pending = keep
    if not self._deadline_active:
      return expired
    for slot in list(self._admit_order):
      state = self.active.get(slot)
      if state is None:
        continue
      if self._expired(state.req, state.submitted_at, now,
                       state.first_token_emitted):
        self._retire(state, "deadline")
        expired += 1
    return expired

  def cancel(self, uid: Any) -> bool:
    """Retire ``uid`` wherever it is (reason ``"cancelled"``); False
    when it is unknown or already finished."""
    for i, entry in enumerate(self.pending):
      if entry.req.uid == uid:
        del self.pending[i]
        self._latency_pending -= entry.req.priority == "latency"
        self._deadline_pending -= self._has_deadline(entry.req)
        self._finish_unadmitted(entry, "cancelled")
        return True
    for state in list(self.active.values()):
      if state.req.uid == uid:
        self._retire(state, "cancelled")
        return True
    return False

  def requeue_slot(self, slot: int, reason: str = "bad_step"
                   ) -> Optional[Any]:
    """Evict ``slot``'s request back to the front of the queue with its
    committed prefix intact: the bad-step quarantine and the preemption
    path (``reason`` ``"bad_step"`` or ``"preempted"``, for the log).
    Returns the uid, or None for an empty slot."""
    state = self.active.get(slot)
    if state is None:
      return None
    del self.active[slot]
    self._admit_order.remove(slot)
    self.allocator.free(slot)
    self._release_blocks(slot)
    self._deadline_active -= self._has_deadline(state.req)
    state.requeues += 1
    state.bad_streak = 0
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      track = _slot_track(slot, self.track_prefix)
      if state.req.flow_id is not None:
        # Flow step inside the closing span, so the arc anchors on this
        # occupancy before it jumps to the request's next slot.
        tracer.flow("t", state.req.flow_id, track=track,
                    args={"uid": str(state.req.uid), "reason": reason})
      tracer.end(
          f"request {state.req.uid}", cat="serving.request", track=track,
          args={"finish_reason": "requeued",
                "new_tokens": int(len(state.generated))})
      tracer.instant(
          "serving/requeue", cat="serving", track="serving/requests",
          args={"uid": str(state.req.uid), "slot": int(slot),
                "reason": reason,
                "committed_prefix": int(len(state.req.prompt)
                                        + len(state.generated))})
    get_logger().debug("requeued uid %r from slot %d (%s) with %d "
                       "committed tokens", state.req.uid, slot, reason,
                       len(state.req.prompt) + len(state.generated))
    self.pending.appendleft(
        _Pending(state.req, state.submitted_at, carried=state))
    self._latency_pending += state.req.priority == "latency"
    self._deadline_pending += self._has_deadline(state.req)
    return state.req.uid

  def retire_slot(self, slot: int, reason: str
                  ) -> Optional[FinishedRequest]:
    """Force-retire an active slot with an explicit finish reason (the
    engine's quarantine-overflow path: reason ``"failed"``)."""
    state = self.active.get(slot)
    if state is None:
      return None
    return self._retire(state, reason)

  # ---------------------------------------------------- migration

  @staticmethod
  def _snapshot_state(req: Request, generated: List[int], requeues: int,
                      first_token_emitted: bool,
                      submitted_at: float) -> Dict[str, Any]:
    return {
        "request": req.snapshot(),
        "generated": [int(t) for t in generated],
        "requeues": int(requeues),
        "first_token_emitted": bool(first_token_emitted),
        "submitted_at": float(submitted_at),
    }

  def _live(self):
    """``(request, carried-or-active state, submitted_at)`` of every live
    request in service order: active slots by admission, then the
    queue."""
    for slot in self._admit_order:
      s = self.active[slot]
      yield s.req, s, s.submitted_at
    for entry in self.pending:
      yield entry.req, entry.carried, entry.submitted_at

  def snapshot_requests(self) -> List[Dict[str, Any]]:
    """Snapshots of every in-flight and queued request, in service
    order: the request spec plus its committed tokens, requeue count,
    first-token flag and submit time — all a replay on another
    scheduler over the same weights needs.  Read-only."""
    return [self._snapshot_state(
        req, st.generated if st is not None else [],
        st.requeues if st is not None else 0,
        st.first_token_emitted if st is not None else False, at)
            for req, st, at in self._live()]

  def progress(self) -> List[Any]:
    """``[(uid, generated_token_list)]`` of every live request in service
    order: the committed-token watermarks a transport worker reports to
    the parent's crash journal."""
    return [(req.uid, st.generated if st is not None else [])
            for req, st, _ in self._live()]

  def restore_request(self, snap: Dict[str, Any],
                      front: bool = False) -> Any:
    """Queue a snapshotted request; on admission it replays prompt +
    committed prefix through chunked prefill and resumes its stream.
    ``front=True`` keeps a migrated request's place in line (failover
    restores in reverse snapshot order).  A snapshot pinned to another
    checkpoint version is refused.  Returns the uid."""
    pinned = snap["request"].get("checkpoint_version")
    if pinned is not None and int(pinned) != self.checkpoint_version:
      raise ValueError(
          f"cross-version restore refused: request "
          f"{snap['request'].get('uid')!r} is pinned to checkpoint "
          f"version {int(pinned)} but this replica serves version "
          f"{self.checkpoint_version}: a prefix replay under other "
          f"weights would fork its stream")
    req = Request.restore(snap["request"])
    req = dataclasses.replace(req, prompt=self.validate(req))
    restored_flow = req.flow_id is not None
    if not restored_flow:  # a snapshot without a flow starts one here
      req = dataclasses.replace(req, flow_id=next_flow_id())
    submitted_at = float(snap["submitted_at"])
    generated = [int(t) for t in snap.get("generated", ())]
    carried = None
    if generated or snap.get("requeues") or snap.get("first_token_emitted"):
      # The state a requeue would have carried; the slot is a
      # placeholder and the key re-derives from seed/uid.
      carried = _SlotState(req, -1, submitted_at, self.clock())
      carried.generated = generated
      carried.requeues = int(snap.get("requeues", 0))
      carried.first_token_emitted = bool(snap.get("first_token_emitted"))
      carried.prefix = np.concatenate(
          [req.prompt, np.asarray(generated, np.int32)])
    entry = _Pending(req, submitted_at, carried=carried)
    if front:
      self.pending.appendleft(entry)
    else:
      self.pending.append(entry)
    self._latency_pending += req.priority == "latency"
    self._deadline_pending += self._has_deadline(req)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(
          "serving/restore", cat="serving", track="serving/requests",
          args={"uid": str(req.uid),
                "committed_prefix": int(len(req.prompt) + len(generated))})
      tracer.flow("t" if restored_flow else "s", req.flow_id,
                  track="serving/requests",
                  args={"uid": str(req.uid), "reason": "restored"})
    return req.uid

  def evacuate(self) -> List[Dict[str, Any]]:
    """Snapshot every queued and in-flight request, then remove them
    without finish records (they finish elsewhere).  Slots and blocks
    are released as a requeue releases them; each active request's span
    ends with reason ``"migrated"``.  Call between steps only."""
    snaps = self.snapshot_requests()
    tracer = trace_lib.get_tracer()
    for slot in list(self._admit_order):
      state = self.active.pop(slot)
      self._admit_order.remove(slot)
      self.allocator.free(slot)
      self._release_blocks(slot)
      self._deadline_active -= self._has_deadline(state.req)
      if tracer.enabled:
        track = _slot_track(slot, self.track_prefix)
        if state.req.flow_id is not None:
          tracer.flow("t", state.req.flow_id, track=track,
                      args={"uid": str(state.req.uid),
                            "reason": "migrated"})
        tracer.end(
            f"request {state.req.uid}", cat="serving.request", track=track,
            args={"finish_reason": "migrated",
                  "new_tokens": int(len(state.generated))})
    self.pending.clear()
    self._latency_pending = 0
    self._deadline_pending = 0
    self._plan = None
    return snaps

  # ---------------------------------------------------------------- admit

  def _next_pending_index(self) -> int:
    """The oldest latency-class entry if any is queued, else the head."""
    if self._latency_pending == 0:
      return 0
    for i, entry in enumerate(self.pending):
      if entry.req.priority == "latency":
        return i
    return 0

  def _admit(self) -> None:
    """Admit pending requests while slots, the batch cap and the prefill
    budget allow — latency class first, then FCFS.  Each admission is
    charged its first chunk, so a step never admits more prefill than it
    can schedule."""
    budget_cap = self._effective_budget()
    batch_cap = self.effective_max_batch
    budget_left = budget_cap
    if budget_left > 0:
      budget_left -= sum(
          min(self.chunk, len(s.prefix) - s.prompt_pos)
          for s in self.active.values() if s.prefilling)
    while self.pending:
      idx = self._next_pending_index()
      entry = self.pending[idx]
      first_chunk = min(self.chunk, entry.prefix_len)
      if budget_cap > 0 and budget_left < first_chunk:
        break
      if self.allocator.num_free == 0 or len(self.active) >= batch_cap:
        # Capacity-blocked: a latency-class arrival evicts the youngest
        # throughput slot holding blocks now, instead of queueing.
        if not (self.paged and self._latency_pending
                and entry.req.priority == "latency"):
          break
        if self._preempt_for_latency_admission() is None:
          break
        idx = self._next_pending_index()
        entry = self.pending[idx]
      budget_left -= first_chunk
      del self.pending[idx]
      self._latency_pending -= entry.req.priority == "latency"
      self._deadline_pending -= self._has_deadline(entry.req)
      req = entry.req
      slot = self.allocator.alloc()
      self._admit_seq += 1
      state = _SlotState(req, slot, entry.submitted_at, self.clock(),
                         carried=entry.carried, admit_seq=self._admit_seq)
      self.active[slot] = state
      self._deadline_active += self._has_deadline(req)
      self._admit_order.append(slot)
      # Warm admission: matched blocks map into the table by reference
      # (each already carries one fresh reference from match()) and the
      # prompt cursor jumps past them.  The match stops before the last
      # prefix token, so the slot still runs at least one prefill step.
      reused = 0
      if self.prefix_cache is not None:
        matched = self.prefix_cache.match(state.prefix)
        if matched:
          blocks = self._slot_blocks.setdefault(slot, [])
          for blk in matched:
            self._tables[slot, len(blocks)] = blk
            blocks.append(blk)
          reused = len(matched)
          state.prompt_pos = reused * self.block_size
          state.reg_blocks = reused
      # The request's lifecycle span opens on its slot's track and stays
      # open until retirement: every per-step span the engine records
      # for this slot nests inside it.
      tracer = trace_lib.get_tracer()
      if tracer.enabled:
        track = _slot_track(slot, self.track_prefix)
        args = {"uid": str(req.uid),
                "prompt_tokens": int(len(req.prompt)),
                "max_new_tokens": int(req.max_new_tokens)}
        if reused:
          args["prefix_blocks_reused"] = int(reused)
        if state.requeues:
          args["requeues"] = int(state.requeues)
        tracer.begin(f"request {req.uid}", cat="serving.request",
                     track=track, args=args)
        if req.flow_id is not None:
          # Flow step just inside the fresh span: the arc lands on this
          # slot's track for this occupancy.
          tracer.flow("t", req.flow_id, track=track,
                      args={"uid": str(req.uid)})
      if state.requeues == 0:
        for fn in self.on_admit:
          fn(req.uid)

  # -------------------------------------------------- paged block planning

  def _resident_tokens(self, state: _SlotState) -> int:
    """Tokens whose K/V are resident in the slot's blocks: the fed
    prefix while prefilling; after it, the decode input's position."""
    if state.prefilling:
      return state.prompt_pos
    return len(state.req.prompt) + len(state.generated) - 1

  def slot_blocks(self, slot: int) -> List[int]:
    return list(self._slot_blocks.get(slot, ()))

  @property
  def kv_blocks_free(self) -> int:
    return self.block_allocator.num_free if self.paged else 0

  @property
  def kv_blocks_used(self) -> int:
    return self.block_allocator.num_used if self.paged else 0

  @property
  def kv_fragmentation(self) -> float:
    if not self.paged:
      return 0.0
    used_tokens = sum(self._resident_tokens(s)
                      for s in self.active.values())
    return self.block_allocator.fragmentation(used_tokens)

  def _release_blocks(self, slot: int) -> None:
    if not self.paged:
      return
    for blk in self._slot_blocks.pop(slot, ()):
      self.block_allocator.decref(blk)
    self._tables[slot] = 0

  # --------------------------------------------------- prefix-cache interop

  @property
  def prefix_hits(self) -> int:
    return self.prefix_cache.hits if self.prefix_cache is not None else 0

  @property
  def prefix_misses(self) -> int:
    return self.prefix_cache.misses if self.prefix_cache is not None else 0

  @property
  def prefix_blocks_reused(self) -> int:
    return (self.prefix_cache.blocks_reused
            if self.prefix_cache is not None else 0)

  @property
  def prefix_evictions(self) -> int:
    return (self.prefix_cache.evictions
            if self.prefix_cache is not None else 0)

  @property
  def prefix_cached_blocks(self) -> int:
    return (self.prefix_cache.num_cached_blocks
            if self.prefix_cache is not None else 0)

  def invalidate_cached_blocks(self, blocks) -> int:
    """Purge ``blocks`` from the prefix cache; no-op without one."""
    if self.prefix_cache is None:
      return 0
    return self.prefix_cache.invalidate_blocks(blocks)

  def _register_cached(self, state: _SlotState) -> None:
    """Register ``state``'s newly completed full blocks in the prefix
    tree, at commit watermarks and at retirement.  Only blocks below
    the resident-K/V watermark register, so a tree entry always holds
    committed K/V; the partial tail block stays private to the slot."""
    blocks = self._slot_blocks.get(state.slot)
    n = 0 if blocks is None else min(
        self._resident_tokens(state) // self.block_size, len(blocks))
    if n <= state.reg_blocks:
      return
    if state.prefilling:
      tokens = state.prefix  # covers [0, prompt_pos): exactly what fed
    else:
      tokens = np.concatenate(
          [state.req.prompt, np.asarray(state.generated, np.int32)])
    self.prefix_cache.register(tokens, n, blocks)
    state.reg_blocks = n

  def _preemption_victim(self, req_rank, excluded: set) -> Optional[int]:
    """Lowest priority class first, then the youngest admission; a
    victim must rank strictly below the requester, must not be in
    ``excluded`` (the requester, or slots already scheduled in the plan
    being built), and must hold blocks."""
    best = None
    best_rank = None
    for slot, state in self.active.items():
      if slot in excluded or not self._slot_blocks.get(slot):
        continue
      rank = (state.req.priority == "latency", -state.admit_seq)
      if rank >= req_rank:
        continue
      if best is None or rank < best_rank:
        best, best_rank = slot, rank
    return best

  def _preempt_for_blocks(self, requester: int,
                          scheduled: set) -> Optional[int]:
    """Page out one victim to refill the pool; returns it or None."""
    req_state = self.active.get(requester)
    if req_state is None:
      return None
    req_rank = (req_state.req.priority == "latency", -req_state.admit_seq)
    best = self._preemption_victim(req_rank, scheduled | {requester})
    if best is None:
      return None
    self.preemptions += 1
    get_logger().warning(
        "KV block pool exhausted: preempting slot %d (uid %r) to refill "
        "it; the request replays its committed prefix on readmission",
        best, self.active[best].req.uid)
    self.requeue_slot(best, reason="preempted")
    return best

  def _preempt_for_latency_admission(self) -> Optional[int]:
    """Evict the youngest throughput-class slot holding blocks so a
    latency-class arrival is admitted now."""
    req_rank = (True, -(self._admit_seq + 1))
    best = self._preemption_victim(req_rank, set())
    if best is None:
      return None
    self.proactive_preemptions += 1
    get_logger().info(
        "proactive preemption: evicting throughput slot %d (uid %r) to "
        "admit a latency-class request", best, self.active[best].req.uid)
    self.requeue_slot(best, reason="preempted")
    return best

  def _ensure_blocks(self, slot: int, num_tokens: int, scheduled: set,
                     preempt: bool = True) -> int:
    """Grow ``slot``'s block list to cover ``num_tokens`` positions.  A
    dry pool first gives up cached-but-unmapped prefix blocks, then
    preempts a victim (unless ``preempt=False``: draft headroom never
    evicts a request's committed K/V).  Returns the positions actually
    covered (a short allocation starves the slot for a step)."""
    blocks = self._slot_blocks.setdefault(slot, [])
    need = min((num_tokens + self.block_size - 1) // self.block_size,
               self._mb)
    while len(blocks) < need:
      blk = self.block_allocator.alloc()
      if blk is None:
        if (self.prefix_cache is not None
            and self.prefix_cache.evict_for_space(need - len(blocks)) > 0):
          continue
        if not preempt or self._preempt_for_blocks(slot, scheduled) is None:
          break
        continue
      self._tables[slot, len(blocks)] = blk
      blocks.append(blk)
    return min(len(blocks) * self.block_size, self.max_seq_len)

  def _plan_flat(self) -> Optional[PagedStepPlan]:
    """Token-budget planning: (1) every decoding slot gets its one
    guaranteed token, (2) prefill chunks stream in while the flat budget
    and the prefill-token budget allow, (3) leftover budget is reserved
    for speculative drafts.  Block coverage is ensured per grant; a
    still-short allocation shrinks the grant."""
    if not self.active:
      self._plan = None
      return None
    T, N, MB = self.token_budget, self.num_slots, self._mb
    plan = PagedStepPlan(
        tokens=np.zeros((T,), np.int32),
        slot_ids=np.zeros((T,), np.int32),
        positions=np.zeros((T,), np.int32),
        valid=np.zeros((T,), bool),
        block_tables=np.zeros((N, MB), np.int32),
        base_idx=np.zeros((N,), np.int32),
        draft_base=np.zeros((N,), np.int32),
        num_valid=np.zeros((N,), np.int32),
        draft_cap=np.zeros((N,), np.int32),
        prefilling=np.zeros((N,), bool),
        keys=np.zeros((N, 2), np.uint32),
        tok_index=np.zeros((N,), np.int32),
        temperature=np.zeros((N,), np.float32),
        top_k=np.zeros((N,), np.int32),
        top_p=np.ones((N,), np.float32),
        prefill_tokens=0, decode_tokens=0, scheduled_tokens=0,
        active_slots=len(self.active))
    budget = self._effective_budget()
    pos = 0
    scheduled: set = set()
    # Pass 1: decode slots — one guaranteed token each.
    for slot in list(self._admit_order):
      state = self.active.get(slot)
      if state is None or state.prefilling:
        continue
      dec_pos = self._resident_tokens(state)
      if self._ensure_blocks(slot, dec_pos + 1, scheduled) < dec_pos + 1:
        continue  # pool exhausted with no eligible victim: starve a step
      state = self.active.get(slot)
      if state is None:
        continue
      plan.base_idx[slot] = pos
      plan.tokens[pos] = state.generated[-1]
      plan.slot_ids[pos] = slot
      plan.positions[pos] = dec_pos
      plan.valid[pos] = True
      plan.num_valid[slot] = 1
      plan.decode_tokens += 1
      pos += 1
      scheduled.add(slot)
    # Pass 2: prefill chunks under both budgets.
    for slot in list(self._admit_order):
      state = self.active.get(slot)
      if state is None or not state.prefilling or pos >= T:
        continue
      remaining = len(state.prefix) - state.prompt_pos
      grant = min(self.chunk, remaining, T - pos)
      if budget > 0:
        grant = min(grant, max(budget - plan.prefill_tokens, 0))
      if grant <= 0:
        continue
      covered = self._ensure_blocks(slot, state.prompt_pos + grant,
                                    scheduled)
      grant = min(grant, covered - state.prompt_pos)
      state = self.active.get(slot)
      if state is None or grant <= 0:
        continue
      chunk = state.prefix[state.prompt_pos:state.prompt_pos + grant]
      plan.base_idx[slot] = pos
      plan.tokens[pos:pos + grant] = chunk
      plan.slot_ids[pos:pos + grant] = slot
      plan.positions[pos:pos + grant] = np.arange(
          state.prompt_pos, state.prompt_pos + grant)
      plan.valid[pos:pos + grant] = True
      plan.num_valid[slot] = grant
      plan.prefilling[slot] = True
      plan.prefill_tokens += grant
      pos += grant
      scheduled.add(slot)
    # Pass 3: speculative draft reservations ride the leftover budget.
    spec_k = self.effective_spec_k if self.spec_enabled else 0
    for slot in list(self._admit_order) if spec_k > 0 else ():
      state = self.active.get(slot)
      if (state is None or state.prefilling or plan.num_valid[slot] != 1
          or pos >= T or state.req.speculative is False):
        continue
      remaining = state.req.max_new_tokens - len(state.generated)
      cap = max(0, min(spec_k, remaining - 1, T - pos))
      if cap <= 0:
        continue
      dec_pos = int(plan.positions[plan.base_idx[slot]])
      # Optional work: a dry pool shrinks the cap, never preempts.
      covered = self._ensure_blocks(slot, dec_pos + 1 + cap, scheduled,
                                    preempt=False)
      cap = max(0, min(cap, covered - 1 - dec_pos))
      if cap <= 0 or self.active.get(slot) is None:
        continue
      plan.draft_base[slot] = pos
      plan.slot_ids[pos:pos + cap] = slot
      plan.positions[pos:pos + cap] = np.arange(dec_pos + 1,
                                                dec_pos + 1 + cap)
      # valid stays False: the engine flips the positions the drafter
      # fills.
      plan.draft_cap[slot] = cap
      pos += cap
    # Per-slot sampling state for every slot with scheduled work.
    for slot in self._admit_order:
      state = self.active.get(slot)
      if state is None or plan.num_valid[slot] == 0:
        continue
      req = state.req
      plan.keys[slot] = state.key
      plan.tok_index[slot] = len(state.generated)
      plan.temperature[slot] = req.temperature
      plan.top_k[slot] = req.top_k
      plan.top_p[slot] = req.top_p
    plan.scheduled_tokens = pos
    plan.block_tables = self._tables.copy()
    if pos == 0:
      self._plan = None
      return None
    self._plan = plan
    return plan

  def plan_step(self):
    """Expire dead requests, admit, then build the next plan (a
    :class:`StepPlan` or, paged, a :class:`PagedStepPlan`), or None when
    there is no device work.  Decode slots always get their one token;
    prefill chunks are granted in admission order until the per-step
    budget runs out, and a starved prefill slot carries ``num_valid=0``
    and resumes next step."""
    self.expire()
    if self.prefix_cache is not None:
      # Session TTL sweep before admission, so an expired session never
      # satisfies this iteration's matches.
      self.prefix_cache.expire()
    self._admit()
    if self.paged:
      return self._plan_flat()
    if not self.active:
      self._plan = None
      return None
    N, C = self.num_slots, self.chunk
    plan = StepPlan(
        tokens=np.zeros((N, C), np.int32),
        num_valid=np.zeros((N,), np.int32),
        reset=np.zeros((N,), bool),
        keys=np.zeros((N, 2), np.uint32),
        tok_index=np.zeros((N,), np.int32),
        temperature=np.zeros((N,), np.float32),
        top_k=np.zeros((N,), np.int32),
        top_p=np.ones((N,), np.float32),
        draft_cap=np.zeros((N,), np.int32),
        prefilling=np.zeros((N,), bool),
        prefill_tokens=0, decode_tokens=0,
        active_slots=len(self.active))
    budget = self._effective_budget()
    spec_k = self.effective_spec_k
    for slot in self._admit_order:
      state = self.active.get(slot)
      if state is None:
        continue
      req = state.req
      plan.keys[slot] = state.key
      plan.tok_index[slot] = len(state.generated)
      plan.temperature[slot] = req.temperature
      plan.top_k[slot] = req.top_k
      plan.top_p[slot] = req.top_p
      # Nothing fed yet (a fresh slot, or a requeued request starting its
      # replay): the step zeroes the cursor before its writes.
      plan.reset[slot] = state.prompt_pos == 0
      if state.prefilling:
        remaining = len(state.prefix) - state.prompt_pos
        grant = min(C, remaining)
        if budget > 0:
          grant = min(grant, max(budget - plan.prefill_tokens, 0))
        if grant == 0:
          continue  # budget-starved this step; resumes next step
        plan.tokens[slot, :grant] = state.prefix[
            state.prompt_pos:state.prompt_pos + grant]
        plan.num_valid[slot] = grant
        plan.prefilling[slot] = True
        plan.prefill_tokens += grant
      else:
        plan.tokens[slot, 0] = state.generated[-1]
        plan.num_valid[slot] = 1
        plan.decode_tokens += 1
        if (spec_k > 0 and self.spec_enabled
            and req.speculative is not False):
          # At most remaining - 1 drafts can commit beside the step's
          # guaranteed token.
          remaining = req.max_new_tokens - len(state.generated)
          plan.draft_cap[slot] = max(0, min(spec_k, remaining - 1))
    self._plan = plan
    return plan

  def slot_histories(self, plan) -> Dict[int, np.ndarray]:
    """Committed tokens (prompt + generated) of every slot with a draft
    reservation in ``plan``: the context drafters propose from."""
    out: Dict[int, np.ndarray] = {}
    for slot, state in self.active.items():
      if plan.draft_cap[slot] > 0:
        out[slot] = np.concatenate(
            [state.req.prompt, np.asarray(state.generated, np.int32)])
    return out

  # --------------------------------------------------------------- commit

  def _emit_tokens(self, uid: Any, fresh: List[int]) -> None:
    for fn in self.on_tokens:
      fn(uid, fresh)

  def _retire(self, state: _SlotState, reason: str) -> FinishedRequest:
    slot = state.slot
    del self.active[slot]
    self._admit_order.remove(slot)
    self.allocator.free(slot)
    # Session persistence: register the completed blocks before the slot
    # lets go of them, so a follow-up turn admits warm.  A quarantined
    # ("failed") request's device state is untrusted and never shared.
    if self.prefix_cache is not None and reason != "failed":
      self._register_cached(state)
    self._release_blocks(slot)
    self._deadline_active -= self._has_deadline(state.req)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      track = _slot_track(slot, self.track_prefix)
      if state.req.flow_id is not None:
        tracer.flow("f", state.req.flow_id, track=track,
                    args={"uid": str(state.req.uid), "reason": reason})
      tracer.end(
          f"request {state.req.uid}", cat="serving.request", track=track,
          args={"finish_reason": reason,
                "new_tokens": int(len(state.generated))})
    fin = FinishedRequest(
        uid=state.req.uid,
        tokens=np.concatenate(
            [state.req.prompt, np.asarray(state.generated, np.int32)]),
        new_tokens=len(state.generated),
        finish_reason=reason)
    self._finished_buffer.append(fin)
    for fn in self.on_finish:
      fn(fin)
    return fin

  def commit(self, next_tokens: np.ndarray,
             num_committed: Optional[np.ndarray] = None,
             slot_ok: Optional[np.ndarray] = None
             ) -> List[FinishedRequest]:
    """Fold one step's committed tokens back into request state; returns
    this iteration's retirements (plus any plan-time expiries and
    cancellations).  ``next_tokens`` is ``[N]`` (one sampled token per
    slot) or ``[N, K+1]`` with ``num_committed [N]`` (speculative
    verification: accepted drafts plus the correction or bonus token).
    A slot's tokens count only once its prompt is fully fed.  The stop
    token and ``max_new_tokens`` are checked per token in commit order,
    so a stop token inside an accepted draft retires the request there
    and drops the rest.  ``slot_ok`` (bool ``[N]``, engine resilience)
    marks the slots whose step was judged bad: those are skipped whole
    (no prefix advance, no token), so the next plan re-feeds the same
    work."""
    if self._plan is None:
      raise RuntimeError("commit() without a preceding plan_step()")
    plan, self._plan = self._plan, None
    tokens = np.asarray(next_tokens)
    if tokens.ndim == 1:
      tokens = tokens[:, None]
    if num_committed is None:
      num_committed = np.ones((tokens.shape[0],), np.int32)
    now = self.clock()
    for slot in list(self._admit_order):
      state = self.active.get(slot)
      if state is None or plan.num_valid[slot] == 0:
        continue
      if slot_ok is not None and not slot_ok[slot]:
        continue  # bad step: state untouched, the next plan retries it
      req = state.req
      if state.prefilling:
        state.prompt_pos += int(plan.num_valid[slot])
        if state.prefilling:
          # More prompt to feed; the sample is discarded, but the chunk
          # may have completed full blocks a concurrent admission can
          # already share.
          if self.prefix_cache is not None:
            self._register_cached(state)
          continue
        if not state.first_token_emitted:
          state.first_token_emitted = True
          state.first_token_at = now
          tracer = trace_lib.get_tracer()
          if tracer.enabled:
            tracer.instant(
                "serving/first_token", cat="serving",
                track=_slot_track(slot, self.track_prefix),
                args={"uid": str(req.uid)})
          for fn in self.on_first_token:
            fn(req.uid)
        # A replaying request commits this sample too: the last prefix
        # position's logits are the distribution for new token number
        # len(generated), with the same token-index fold.
      fresh: List[int] = []
      reason = None
      for j in range(int(num_committed[slot])):
        tok = int(tokens[slot, j])
        state.generated.append(tok)
        fresh.append(tok)
        if req.stop_token >= 0 and tok == req.stop_token:
          reason = "stop_token"
        elif len(state.generated) >= req.max_new_tokens:
          reason = "length"
        if reason is not None:
          break
      if fresh and self.on_tokens:
        self._emit_tokens(req.uid, fresh)
      if reason is not None:
        self._retire(state, reason)
      elif self.prefix_cache is not None:
        # Decode watermark: committed tokens may have completed a block.
        self._register_cached(state)
    return self.take_finished()
