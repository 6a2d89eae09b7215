"""Host-side span tracer with Chrome-trace-event / Perfetto JSON export
(port of ``easyparallellibrary_tpu/observability/trace.py``).

The reference's observability story is TF summaries plus RunMetadata
FULL_TRACE capture (epl/parallel/hooks.py:593-664); this repo had
outgrown that with four disjoint half-instruments (StepProfiler,
FlopsProfiler, ServingStats, two metric sinks) none of which could
answer "where did this request's latency go".  The tracer is the one
event substrate they all share:

* **spans** — paired B/E duration events, via the :meth:`Tracer.span`
  context manager (host phases: data-next, step dispatch, checkpoint
  stage/commit) or :meth:`Tracer.span_at` with explicit timestamps
  (per-slot serving timelines, where one fused device step covers many
  requests and the per-slot spans share its start/end);
* **instants** — point events (request submit, first token, sentinel
  escalation, watchdog timeout);
* **counter tracks** — numeric series (active slots, accepted draft
  tokens) Perfetto renders as graphs;
* **flow events** — ``s``/``t``/``f`` phase triplets sharing one
  ``id``, which Perfetto renders as arrows BETWEEN tracks.  The serving
  stack threads one flow per request (``Request.flow_id``, minted at
  router/scheduler submit) through dispatch → admission → every
  migration → retirement, so a request that fails over between replicas
  renders as a single connected arc across the replica tracks instead
  of disconnected span fragments (docs/observability.md "Reading a
  failover trace").

Design constraints, in order:

1. **Zero device syncs on the hot path.**  Nothing here touches a
   tensor; timestamps come from ``time.perf_counter_ns`` and every
   argument recorded is already a host value, so a traced serving step
   makes exactly the synchronising calls an untraced one makes.
2. **Bounded memory.**  Events live in a ring buffer
   (``observability.ring_capacity``); a long run keeps the most recent
   window — exactly the window a post-mortem needs ("what happened
   between step 400 and the rollback at 412").
3. **Cheap when off.**  A disabled tracer's ``span()`` returns a
   module-level null context manager: one check that no
   ``torch.profiler`` runs, one attribute read and no allocation, so
   instrumentation can stay unconditionally in hot loops.
4. **Leader-only export.**  Every process records (cheap), only
   process 0 (the ``torch.distributed`` rank, 0 without a process
   group) writes the JSON — the metrics writers' rule
   (epl/parallel/hooks.py:542).

**Distributed tracing** (docs/observability.md "Distributed
tracing"): a process-isolated replica records into its OWN ring; the
parent harvests it over the wire in bounded increments
(:meth:`Tracer.drain_wire` child-side, :meth:`Tracer.ingest_remote`
parent-side) and rebases the child's timestamps into its timebase with
a handshake-estimated clock offset (midpoint of send/recv
``perf_counter_ns`` pairs).  The merged export tags each process's
events with its OS pid, emits per-pid process/track metadata, and
keeps every pid's timeline monotonic after shifting — so one Perfetto
file shows the whole fleet and a request flow arcs across process
boundaries.

The export is standard Chrome trace-event JSON: load it at
``ui.perfetto.dev`` or ``chrome://tracing``.  Device-side timelines come
from ``torch.profiler``: while a profiler runs, every context-manager
span (:meth:`Tracer.span`) also opens a
``torch.autograd.profiler.record_function`` of its name, whether or not
the tracer is enabled, so the program's spans sit in the profiler's own
event stream, on its clock, around the kernels they launch.
:meth:`Tracer.device_trace` brackets such a capture and writes it as a
Chrome trace; the ring's own export stays on the tracer's clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch._C._autograd import _profiler_enabled

from easyparallellibrary_tpu_torch.utils.device import process_index
from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Event tuples in the ring: (ph, name, cat, ts_us, tid, args_or_None).
# Dicts are only built at export — the hot path appends one tuple.
_Event = Tuple[str, str, str, float, int, Optional[Dict[str, Any]]]

# Wire event shape for cross-process harvest (JSON-friendly lists):
# [ph, name, cat, ts_us, track_name, args_or_None].  Track NAMES cross
# the wire — tids are tracer-local and get re-assigned per remote pid
# on ingest, so two processes' "serving/slot0" tracks never collide.
_ENC = {"separators": (",", ":"), "default": str}


class _NullSpan:
  """No-op context manager returned by ``span()`` when it records
  nothing and no profiler runs."""
  __slots__ = ()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False


_NULL_SPAN = _NullSpan()


class _Span:
  """Live span handle: records B on entry and E on exit (always, even on
  exceptions, so an error escaping a phase still closes its span) when
  ``tracer`` is given, and holds a ``record_function`` of the same name
  open when ``mirror`` is set (a ``torch.profiler`` capture runs)."""
  __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_range")

  def __init__(self, tracer: Optional["Tracer"], name: str, cat: str,
               tid: int, args: Optional[Dict[str, Any]] = None,
               mirror: bool = False):
    self._tracer = tracer
    self._name = name
    self._cat = cat
    self._tid = tid
    self._args = args
    self._range = torch.autograd.profiler.record_function(name) \
        if mirror else None

  def __enter__(self):
    t = self._tracer
    if t is not None:
      t._append("B", self._name, self._cat, t.now_us(), self._tid,
                self._args)
    if self._range is not None:
      self._range.__enter__()
    return self

  def __exit__(self, *exc):
    if self._range is not None:
      self._range.__exit__(*exc)
    t = self._tracer
    if t is not None:
      t._append("E", self._name, self._cat, t.now_us(), self._tid, None)
    return False


class Tracer:
  """Ring-buffered host-side span tracer (module docstring).

  ``sample_rate`` in (0, 1] drives deterministic sampling of the
  per-step train-loop phases: fit() makes ONE decision per step with
  :meth:`sample_tick` and gates all of that step's phase spans on it
  (the ``record=`` argument, and :meth:`sampled` for the phases inside
  the train step, :func:`step_span`), so a sampled step keeps its FULL
  phase set — including phases only some steps reach (host sync on log
  boundaries) — and a long run can keep per-step phases at, say, 1%
  without losing the request-lifecycle and checkpoint events that are
  always recorded.
  """

  def __init__(self, *, enabled: bool = True, ring_capacity: int = 65536,
               sample_rate: float = 1.0, trace_path: str = ""):
    if ring_capacity < 1:
      raise ValueError(f"ring_capacity must be >= 1: {ring_capacity}")
    if not 0.0 < sample_rate <= 1.0:
      raise ValueError(f"sample_rate must be in (0, 1]: {sample_rate}")
    self.enabled = enabled
    self.ring_capacity = ring_capacity
    self.sample_rate = sample_rate
    self.trace_path = trace_path
    self._events: "deque[_Event]" = deque(maxlen=ring_capacity)
    self._tracks: Dict[str, int] = {"main": 0}
    # The watchdog monitor thread records instants while the main
    # thread records spans, so track registration (two unsynchronized
    # first-uses could claim the same tid) and the append/eviction
    # accounting (`+=` is not GIL-atomic) share one lock.  Event rates
    # are per-step-scale, not per-token, so the cost is noise; the
    # cached track() path stays a lock-free dict read.
    self._lock = threading.Lock()
    self._t0_ns = time.perf_counter_ns()
    self._sample_accs: Dict[str, float] = {}
    # The current step's sampling decision, read by the spans inside the
    # train step (step_span); True outside fit(): every step records.
    self.step_record = True
    # Eviction accounting off the hot path: one int increment per
    # append; `dropped` is derived at read time.
    self._n_appended = 0
    # Harvest accounting: events consumed by drain_wire() are delivered,
    # not dropped.
    self._n_drained = 0
    # Harvested remote rings, keyed by the remote OS pid.  Each store
    # holds its own ring (bounded like the local one), its own track
    # table (track names -> per-pid tids), the display label, and the
    # last rebased timestamp (per-process monotonic clamp: a re-sampled
    # clock offset may move backwards; the merged timeline must not).
    self._remote: Dict[int, Dict[str, Any]] = {}

  # ------------------------------------------------------------- recording

  def now_us(self) -> float:
    """Microseconds since tracer creation (host monotonic clock)."""
    return (time.perf_counter_ns() - self._t0_ns) / 1e3

  def at_us(self, t_ns: int) -> float:
    """A raw ``time.perf_counter_ns`` reading in this tracer's µs
    timebase (clock-offset estimation uses send/recv timestamps taken
    OUTSIDE the tracer)."""
    return (t_ns - self._t0_ns) / 1e3

  def track(self, name: Optional[str]) -> int:
    """tid for a named track (registered on first use; exported as a
    thread-name metadata event so Perfetto labels the row)."""
    if not name:
      return 0
    tid = self._tracks.get(name)
    if tid is None:
      with self._lock:
        tid = self._tracks.get(name)
        if tid is None:
          tid = len(self._tracks)
          self._tracks[name] = tid
    return tid

  @property
  def pending(self) -> int:
    """Events currently buffered in the local ring (the harvest loop's
    'drained dry' signal)."""
    return len(self._events)

  @property
  def dropped(self) -> int:
    """Events evicted by the ring so far (for the export note).
    Events consumed by :meth:`drain_wire` were delivered, not lost."""
    return self._n_appended - self._n_drained - len(self._events)

  def _append(self, ph: str, name: str, cat: str, ts: float, tid: int,
              args: Optional[Dict[str, Any]]):
    with self._lock:
      self._n_appended += 1
      self._events.append((ph, name, cat, ts, tid, args))

  def sample_tick(self, key: str = "") -> bool:
    """Advance the deterministic sampling accumulator for ``key`` and
    return whether this tick records.  fit() calls this once per step
    and gates all of that step's phase spans on the result (``record=``),
    so sampled steps keep their full phase set even for phases a given
    step only sometimes reaches (host sync on log boundaries)."""
    if not self.enabled:
      return False
    if self.sample_rate >= 1.0:
      return True
    acc = self._sample_accs.get(key, 0.0) + self.sample_rate
    if acc < 1.0:
      self._sample_accs[key] = acc
      return False
    self._sample_accs[key] = acc - 1.0
    return True

  @contextlib.contextmanager
  def sampled(self, record: bool):
    """Hold a step's sampling decision (:meth:`sample_tick`) while the
    step runs, for the spans inside it (:func:`step_span`)."""
    before, self.step_record = self.step_record, record
    try:
      yield
    finally:
      self.step_record = before

  def span(self, name: str, cat: str = "", track: Optional[str] = None,
           args: Optional[Dict[str, Any]] = None, record: bool = True):
    """Context manager recording a B/E pair around the body when the
    tracer is enabled and ``record`` holds (``record=False``: for call
    sites that made a per-step sampling decision with
    :meth:`sample_tick` up front).  While a ``torch.profiler`` capture
    runs, the body also runs inside a ``record_function`` of ``name``,
    recorded or not; otherwise a span that records nothing is the
    shared null span."""
    mirror = _profiler_enabled()
    if not self.enabled or not record:
      return _Span(None, name, cat, 0, mirror=True) if mirror else _NULL_SPAN
    return _Span(self, name, cat, self.track(track), args, mirror)

  def span_at(self, name: str, t0_us: float, t1_us: float, cat: str = "",
              track: Optional[str] = None,
              args: Optional[Dict[str, Any]] = None):
    """Record a completed span with explicit timestamps — for work whose
    duration is known only after the fact (one fused device step covers
    every serving slot; each slot's span shares its bounds)."""
    if not self.enabled:
      return
    tid = self.track(track) if track else 0
    with self._lock:
      append = self._events.append
      append(("B", name, cat, t0_us, tid, args))
      append(("E", name, cat, t1_us if t1_us >= t0_us else t0_us, tid,
              None))
      self._n_appended += 2

  def begin(self, name: str, cat: str = "", track: Optional[str] = None,
            args: Optional[Dict[str, Any]] = None):
    """Open a long-lived span explicitly (request lifecycle: opened at
    admission, closed at retirement many engine steps later)."""
    if self.enabled:
      self._append("B", name, cat, self.now_us(), self.track(track), args)

  def end(self, name: str, cat: str = "", track: Optional[str] = None,
          args: Optional[Dict[str, Any]] = None):
    """Close a span opened with :meth:`begin` (args merge with the B's
    in trace viewers — retirement reason rides the E)."""
    if self.enabled:
      self._append("E", name, cat, self.now_us(), self.track(track), args)

  def instant(self, name: str, cat: str = "", track: Optional[str] = None,
              args: Optional[Dict[str, Any]] = None):
    if self.enabled:
      self._append("i", name, cat, self.now_us(), self.track(track), args)

  def counter(self, name: str, value: Union[int, float], cat: str = ""):
    """One sample of a numeric counter track (Perfetto draws a graph)."""
    if self.enabled:
      self._append("C", name, cat, self.now_us(), 0, {"value": value})

  def flow(self, phase: str, flow_id: int,
           name: str = "serving/request_flow", cat: str = "serving",
           track: Optional[str] = None, ts: Optional[float] = None,
           args: Optional[Dict[str, Any]] = None):
    """Record one Perfetto flow event: ``phase`` is ``"s"`` (start),
    ``"t"`` (step) or ``"f"`` (finish).  All events of one flow share
    ``flow_id`` (and should share ``name``/``cat`` — viewers match
    flows by category + id); each binds to the enclosing slice on its
    track at ``ts``, and the viewer draws arrows start → steps →
    finish.  The schema contract (:func:`validate_trace`): every
    started flow must be finished, and steps/finishes must follow a
    start."""
    if not self.enabled:
      return
    if phase not in ("s", "t", "f"):
      raise ValueError(f"flow phase must be 's', 't' or 'f': {phase!r}")
    a = dict(args) if args else {}
    a["id"] = int(flow_id)
    self._append(phase, name, cat, self.now_us() if ts is None else ts,
                 self.track(track), a)

  @contextlib.contextmanager
  def device_trace(self, log_dir: str, name: str = "device_trace"):
    """Run a ``torch.profiler`` capture (CPU activities, and CUDA
    activities where a card is present) and write it to
    ``<log_dir>/device_trace.json`` (Chrome trace format).  The
    program's context-manager spans opened inside it are in that file,
    as ``record_function`` ranges on the profiler's clock around the
    kernels they launch.  The ring gets one span ``name`` over the
    capture, on the tracer's clock, when the tracer is enabled.  Yields
    the profiler.  The profiler synchronises the card and adds host work
    while it is active: arm it for one step, not for a run."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
      activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = self.now_us()
    prof = profile(activities=activities)
    prof.__enter__()
    try:
      yield prof
    finally:
      prof.__exit__(None, None, None)
      path = os.path.join(log_dir, "device_trace.json")
      prof.export_chrome_trace(path)
      self.span_at(name, t0, self.now_us(), cat="device",
                   args={"log_dir": os.path.abspath(log_dir)})
      get_logger().info("device trace written to %s", path)

  # ------------------------------------------- cross-process harvest --

  def drain_wire(self, max_bytes: Optional[int] = None
                 ) -> Dict[str, Any]:
    """Consume the OLDEST ring events into a wire-ready chunk of at
    most ~``max_bytes`` encoded bytes (``None`` = drain everything).
    Called in a worker's serve loop so the parent can harvest the ring
    incrementally; the byte bound keeps one sweep from ever stalling
    dispatch, and whatever does not fit simply rides a later sweep.
    Returns ``{"events": [[ph, name, cat, ts_us, track, args], ...],
    "now_us": <child clock>, "dropped": <ring evictions so far>}``.
    Drained events are delivered, not dropped — :attr:`dropped` only
    counts ring evictions."""
    out: List[List[Any]] = []
    size = 0
    with self._lock:
      rev = {tid: name for name, tid in self._tracks.items()}
      while self._events:
        ph, name, cat, ts, tid, args = self._events[0]
        wire = [ph, name, cat, ts, rev.get(tid, f"track{tid}"), args]
        enc = len(json.dumps(wire, **_ENC))
        if out and max_bytes is not None and size + enc > max_bytes:
          break
        self._events.popleft()
        self._n_drained += 1
        out.append(wire)
        size += enc
        if max_bytes is not None and size >= max_bytes:
          break
    return {"events": out, "now_us": self.now_us(),
            "dropped": self.dropped}

  def ingest_remote(self, pid: int, events: List[List[Any]], *,
                    offset_us: float, label: str = "") -> int:
    """Merge a harvested chunk from a remote process into this tracer.

    ``pid`` is the remote OS pid (the merged export's process key),
    ``offset_us`` the current clock-offset estimate such that
    ``parent_ts ≈ child_ts + offset_us``.  Rebased timestamps are
    clamped per-pid monotonic: the offset is re-estimated over time and
    may step backwards, but a process's own clock never does, so the
    merged timeline must not either.  Remote rings are bounded like the
    local one.  Returns the number of events ingested."""
    if not events:
      return 0
    n = 0
    with self._lock:
      store = self._remote.get(pid)
      if store is None:
        store = {"label": label or f"pid {pid}",
                 "tracks": {},
                 "events": deque(maxlen=self.ring_capacity),
                 "appended": 0,
                 "last_ts": None}
        self._remote[pid] = store
      elif label:
        store["label"] = label
      tracks = store["tracks"]
      for wire in events:
        try:
          ph, name, cat, ts, track, args = wire
        except (TypeError, ValueError):
          continue  # malformed wire event: drop, never poison the ring
        tid = tracks.get(track)
        if tid is None:
          tid = len(tracks)
          tracks[track] = tid
        ts = float(ts) + offset_us
        last = store["last_ts"]
        if last is not None and ts < last:
          ts = last
        store["last_ts"] = ts
        store["events"].append((ph, name, cat, ts, tid, args))
        store["appended"] += 1
        n += 1
    return n

  def close_remote(self, pid: int, reason: str = "lost") -> int:
    """Close every span a remote process left OPEN — a SIGKILLed child
    dies mid-request, so its harvested ring ends in dangling ``B``
    events that would fail schema validation and render as unbounded
    slices.  Synthesizes ``E`` events at the pid's last rebased
    timestamp (LIFO per track, tagged ``{"finish_reason": reason}``),
    so the merged trace shows the victim's work ENDING at death.
    Idempotent; returns the number of spans closed."""
    with self._lock:
      store = self._remote.get(pid)
      if store is None or store["last_ts"] is None:
        return 0
      open_spans: Dict[int, List[Tuple[str, str]]] = {}
      for ph, name, cat, _ts, tid, _args in store["events"]:
        if ph == "B":
          open_spans.setdefault(tid, []).append((name, cat))
        elif ph == "E":
          stack = open_spans.get(tid)
          if stack and stack[-1][0] == name:
            stack.pop()
      n = 0
      for tid, stack in open_spans.items():
        while stack:
          name, cat = stack.pop()
          store["events"].append(
              ("E", name, cat, store["last_ts"], tid,
               {"finish_reason": reason}))
          store["appended"] += 1
          n += 1
      return n

  def remote_summary(self) -> Dict[int, Dict[str, Any]]:
    """Per remote pid: display label, events currently buffered, and
    events evicted from the remote ring (diagnostics + tests)."""
    with self._lock:
      return {pid: {"label": s["label"], "events": len(s["events"]),
                    "dropped": s["appended"] - len(s["events"])}
              for pid, s in self._remote.items()}

  # --------------------------------------------------------------- export

  def events(self) -> List[Dict[str, Any]]:
    """Chrome-trace-event dicts: per-process metadata first (process
    and thread names for the local pid and every harvested remote pid),
    then ALL processes' events merged and sorted by timestamp (spans
    recorded retroactively via :meth:`span_at` land in buffer order,
    not time order; the stable sort restores B-before-E at equal
    timestamps, and each pid's stream is already monotonic so the
    merge preserves per-pid order)."""
    pid = process_index()
    with self._lock:  # a concurrent append must not mutate mid-snapshot
      events = list(self._events)
      tracks = sorted(self._tracks.items(), key=lambda kv: kv[1])
      remote = [(rpid, s["label"],
                 sorted(s["tracks"].items(), key=lambda kv: kv[1]),
                 list(s["events"]))
                for rpid, s in sorted(self._remote.items())]
    out: List[Dict[str, Any]] = []
    for name, tid in tracks:
      out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                  "args": {"name": name}})
      out.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                  "tid": tid, "args": {"sort_index": tid}})
    for rpid, label, rtracks, _revents in remote:
      out.append({"ph": "M", "name": "process_name", "pid": rpid,
                  "tid": 0, "args": {"name": label}})
      for name, tid in rtracks:
        out.append({"ph": "M", "name": "thread_name", "pid": rpid,
                    "tid": tid, "args": {"name": name}})
        out.append({"ph": "M", "name": "thread_sort_index", "pid": rpid,
                    "tid": tid, "args": {"sort_index": tid}})
    merged = [(e, pid) for e in events]
    for rpid, _label, _rtracks, revents in remote:
      merged.extend((e, rpid) for e in revents)
    for (ph, name, cat, ts, tid, args), epid in sorted(
        merged, key=lambda e: e[0][3]):
      ev: Dict[str, Any] = {"ph": ph, "name": name, "ts": ts,
                            "pid": epid, "tid": tid}
      if cat:
        ev["cat"] = cat
      if ph == "i":
        ev["s"] = "t"
      if ph in ("s", "t", "f") and args is not None and "id" in args:
        # Flow events carry their id top-level (Chrome trace format) and
        # bind to the ENCLOSING slice ("bp": "e") so the arrow anchors
        # on the request span the flow event was recorded inside.
        args = dict(args)
        ev["id"] = args.pop("id")
        ev["bp"] = "e"
        if not args:
          args = None
      if args is not None:
        ev["args"] = args
      out.append(ev)
    return out

  def export(self, path: Optional[str] = None) -> Optional[str]:
    """Write the trace JSON (leader only; non-leaders no-op and return
    None).  Load the file at ``ui.perfetto.dev``."""
    path = path or self.trace_path
    if not path:
      raise ValueError("no trace path: pass export(path) or set "
                       "observability.trace_path")
    if process_index() != 0:
      return None
    doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
    if self.dropped:
      doc["otherData"] = {
          "dropped_events": self.dropped,
          "note": "ring buffer evicted oldest events; raise "
                  "observability.ring_capacity for a longer window"}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
      json.dump(doc, f)
    os.replace(tmp, path)
    get_logger().info(
        "trace: %d events -> %s (open at ui.perfetto.dev)",
        len(self._events), path)
    return path

  def clear(self):
    with self._lock:
      self._events.clear()
      self._n_appended = 0
      self._n_drained = 0
      self._remote.clear()


# ------------------------------------------------------- global tracer --

# One ambient tracer, like logging: instrumentation sites call
# get_tracer() and stay cheap when it is disabled.  `install()` pins an
# explicit tracer (wins over config); `ensure_configured()` auto-builds
# from the active observability.* config and rebuilds/removes the
# auto-built one when the config changes.
_DISABLED = Tracer(enabled=False, ring_capacity=1)
_tracer: Optional[Tracer] = None
_auto_sig: Optional[Tuple] = None


def get_tracer() -> Tracer:
  """The ambient tracer (never None; a disabled singleton when nothing
  is configured)."""
  return _tracer if _tracer is not None else _DISABLED


def step_span(name: str):
  """A span of one of the train step's phases (``train/forward``,
  ``train/backward``, ``train/optimizer``, ``train/remat``,
  ``train/flash_delta``) on the ambient tracer's ``train`` track: in the
  ring when the tracer is enabled and the step is sampled
  (:meth:`Tracer.sampled`), in a running ``torch.profiler`` capture
  either way."""
  tracer = get_tracer()
  return tracer.span(name, cat="train", track="train",
                     record=tracer.step_record)


def install(tracer: Optional[Tracer]) -> Optional[Tracer]:
  """Pin `tracer` as the ambient tracer (None = uninstall).  An
  explicitly installed tracer wins over config auto-configuration."""
  global _tracer, _auto_sig
  _tracer = tracer
  _auto_sig = None
  return tracer


def reset():
  """Drop any ambient tracer (tests; Env resets do not reach here)."""
  install(None)


def ensure_configured(config=None) -> Tracer:
  """Reconcile the ambient tracer with ``config.observability`` (the
  active Env's config when None): enable/rebuild it when the config asks
  for tracing, drop an auto-built tracer when it no longer does.  An
  explicitly :func:`install`-ed tracer is left alone.  Called by
  ``fit()`` and the serving engine at entry, so setting
  ``observability.enabled`` is all a run needs.

  Only the AMBIENT Env config may tear down or rebuild an existing
  auto-built tracer (both discard the ring).  A component constructed
  with its own explicit config — an engine built mid-fit with serving
  knobs whose observability group is default-off — can enable tracing
  when none exists, but must not silently drop the run's recorded
  events or stop the instrumentation every other site records into."""
  global _tracer, _auto_sig
  if _tracer is not None and _auto_sig is None:
    return _tracer  # explicit install wins
  from easyparallellibrary_tpu_torch.env import Env
  if config is None:
    config = Env.get().config
    ambient = True
  else:
    ambient = config is Env.get().config
  obs = config.observability
  if not obs.enabled:
    if _auto_sig is not None and ambient:
      _tracer = None
      _auto_sig = None
    return get_tracer()
  sig = (obs.ring_capacity, obs.sample_rate, obs.trace_path)
  if _tracer is None:
    _tracer = Tracer(enabled=True, ring_capacity=obs.ring_capacity,
                     sample_rate=obs.sample_rate,
                     trace_path=obs.trace_path)
    _auto_sig = sig
  elif _auto_sig != sig and ambient:
    _tracer = Tracer(enabled=True, ring_capacity=obs.ring_capacity,
                     sample_rate=obs.sample_rate,
                     trace_path=obs.trace_path)
    _auto_sig = sig
  return _tracer


# ----------------------------------------------------- schema validation --

_REQUIRED_KEYS = ("ph", "name", "pid", "tid")


def validate_trace(trace: Union[str, Dict[str, Any], List[Dict[str, Any]]]
                   ) -> List[Dict[str, Any]]:
  """Schema-validate a Chrome-trace JSON export; returns the event list
  or raises ``ValueError`` naming every problem.

  Checks: top-level shape, required keys per event, monotonically
  non-decreasing ``ts`` PER PID (a merged multi-process trace
  interleaves processes whose clocks are only offset-aligned; each
  process's own rebased timeline must still be monotonic), unique
  thread-name metadata per (pid, tid) — a merge bug that emits a pid's
  track table twice corrupts Perfetto's row labels — strict B/E
  pairing per (pid, tid) — every E closes the innermost open B of the
  same name, nothing left open — and the flow schema: every
  ``s``/``t``/``f`` flow event carries an ``id``, steps and finishes
  follow a start of the same id AND bind to it by category (viewers
  match flows by cat + id, so a cross-process arc only connects when
  both sides agree), no second start while a flow is open, and every
  started flow TERMINATES with an ``f`` (a failed-over request must
  reach retirement somewhere — a dangling flow is a lost request).
  (``make trace-demo`` / ``make trace-fleet`` quick tests run this
  over real emitted traces.)
  """
  if isinstance(trace, str):
    with open(trace) as f:
      trace = json.load(f)
  if isinstance(trace, dict):
    if "traceEvents" not in trace:
      raise ValueError("trace JSON object lacks the 'traceEvents' key")
    events = trace["traceEvents"]
  else:
    events = trace
  if not isinstance(events, list):
    raise ValueError(f"traceEvents must be a list; got {type(events)}")
  problems: List[str] = []
  last_ts: Dict[Any, float] = {}
  stacks: Dict[Tuple[Any, Any], List[str]] = {}
  named_tracks: set = set()
  # Open flows: id -> (index of the "s" event, its category).
  flows: Dict[Any, Tuple[int, Any]] = {}
  for i, ev in enumerate(events):
    if not isinstance(ev, dict):
      problems.append(f"event {i}: not an object")
      continue
    missing = [k for k in _REQUIRED_KEYS if k not in ev]
    if missing:
      problems.append(f"event {i}: missing {missing}")
      continue
    ph = ev["ph"]
    pid = ev["pid"]
    if ph == "M":
      if ev["name"] == "thread_name":
        key = (pid, ev["tid"])
        if key in named_tracks:
          problems.append(f"event {i}: duplicate thread_name metadata "
                          f"for pid/tid {key}")
        named_tracks.add(key)
      continue  # metadata events carry no timestamp
    if "ts" not in ev:
      problems.append(f"event {i} ({ph} {ev['name']!r}): missing 'ts'")
      continue
    ts = ev["ts"]
    prev = last_ts.get(pid)
    if prev is not None and ts < prev:
      problems.append(
          f"event {i} ({ph} {ev['name']!r}): ts {ts} < previous {prev} "
          f"on pid {pid} (not monotonic)")
    last_ts[pid] = ts
    if ph in ("s", "t", "f"):
      if "id" not in ev:
        problems.append(f"event {i} ({ph} {ev['name']!r}): flow event "
                        f"missing 'id'")
        continue
      fid = ev["id"]
      if ph == "s":
        if fid in flows:
          problems.append(
              f"event {i}: flow {fid!r} started again while still open "
              f"(previous start at event {flows[fid][0]})")
        flows[fid] = (i, ev.get("cat"))
      elif fid not in flows:
        problems.append(f"event {i}: flow {ph!r} phase for {fid!r} with "
                        f"no open flow start")
      else:
        start_cat = flows[fid][1]
        if ev.get("cat") != start_cat:
          problems.append(
              f"event {i}: flow {ph!r} for {fid!r} on pid {pid} has cat "
              f"{ev.get('cat')!r} but the flow started with "
              f"{start_cat!r} (flows bind by cat + id)")
        if ph == "f":
          del flows[fid]
      continue
    key = (ev["pid"], ev["tid"])
    stack = stacks.setdefault(key, [])
    if ph == "B":
      stack.append(ev["name"])
    elif ph == "E":
      if not stack:
        problems.append(f"event {i}: E {ev['name']!r} with no open B "
                        f"on pid/tid {key}")
      elif stack[-1] != ev["name"]:
        problems.append(
            f"event {i}: E {ev['name']!r} does not close the innermost "
            f"open B {stack[-1]!r} on pid/tid {key}")
        stack.pop()
      else:
        stack.pop()
  for key, stack in stacks.items():
    if stack:
      problems.append(f"unclosed span(s) {stack} on pid/tid {key}")
  for fid, (start_i, _cat) in flows.items():
    problems.append(f"flow {fid!r} (started at event {start_i}) never "
                    f"terminated with an 'f' phase")
  if problems:
    raise ValueError("invalid trace:\n  " + "\n  ".join(problems))
  return events
