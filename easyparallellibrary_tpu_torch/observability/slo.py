"""Host-side SLO monitoring, compile sentinel, and anomaly-triggered
deep capture (port of ``easyparallellibrary_tpu/observability/slo.py``)
— the layer that turns the tracer's timelines from something humans
read into signals the system acts on.

Three connected pieces, all pure host policy (no torch import at all;
unit-testable with fake clocks like serving/resilience.py):

* :class:`SLOMonitor` — consumes the registry's namespaced records
  (``serving/fleet/*``, ``serving/replica<i>/*``, ``serving/*``,
  ``train/*``) and evaluates declarative rules against them:
  :class:`SLORule` threshold rules (TTFT/ITL percentile targets, replica
  availability) and :class:`BurnRateRule` error-budget burn over
  fast/slow record windows (shed rate, in the multi-window SRE shape —
  a short spike and a slow leak both fire, a momentary blip does not).
  Every breach/recovery is emitted three ways at once: a
  machine-readable line in ``slo_events.jsonl`` (the artifact
  ``report.py --follow`` and future autotuners tail), a ``slo/breach``
  trace instant + ``slo/breaches`` counter track on the ambient tracer,
  and the :meth:`SLOMonitor.add_listener` callbacks (the hook the
  router's health machine and autotuners subscribe to).  The monitor IS
  a registry sink (``write``/``flush``/``close``), so attaching it via
  :meth:`MetricRegistry.add_sink_once` makes every producer's records
  flow through with zero new plumbing.
* :class:`CompileSentinel` — a watermark over a count that must stop
  growing after warmup, checked every step.  In the JAX package the
  count is a jitted step's compiled-program cache (a recompile is a
  multi-second stall mid-serving); the port's serving engine watches the
  number of loaded CUDA kernel libraries (``kernels/_build.py``
  ``loaded_count()``), because the same stall on a GPU is a kernel
  library built or loaded for the first time mid-run.  Growth past the
  warmup watermark is detected the step it happens, attributed to the
  step's input signature, and raised as a first-class SLO breach +
  trace instant.
* :class:`DiagnosticCapture` — on SLO breach, watchdog fire, or
  recompile, atomically dump a bounded diagnostic bundle (the tracer
  ring's tail, the registry's ``latest()`` snapshot, a
  scheduler/allocator state summary from the engine's context
  providers) into a quarantine-style timestamped directory — staged as
  ``<bundle>.tmp`` then renamed, the saver's crash-consistency
  discipline — rate-limited and retention-bounded so a flapping fleet
  cannot fill the disk.

Ambient wiring mirrors the tracer (observability/trace.py): components
call :func:`ensure_configured` at entry and the ``observability.slo.*``
config group decides everything; :func:`install` pins an explicit
monitor for tests.  Knob table: docs/observability.md "SLO monitoring".

Monitoring must never change what it monitors: evaluation is dict/float
arithmetic on values that are ALREADY host scalars — tensors in a
record are skipped, never floated (floating one would reintroduce the
per-step host sync the registry exists to avoid) — and nothing here
touches the device step, so the streams, the plans and the step's
synchronising calls are the same with the whole layer enabled
(tests/test_torch_observability.py, tests/test_torch_slo.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Tuple

from easyparallellibrary_tpu_torch.utils import vclock
from easyparallellibrary_tpu_torch.utils.logging import get_logger

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}

# Only values that are already host scalars are evaluated; anything
# array-like (a tensor passing through the registry raw) is skipped —
# evaluating it would force the host sync the sinks defer.
_SCALARS = (int, float)


def _is_scalar(v: Any) -> bool:
  if isinstance(v, bool):
    return False
  if isinstance(v, _SCALARS):
    return True
  # numpy scalars quack like floats without being tensors; a shaped
  # array and any torch tensor (0-d included: it may live on the card)
  # is never evaluated.
  return hasattr(v, "dtype") and getattr(v, "shape", None) == () and \
      not type(v).__module__.startswith("torch")


@dataclasses.dataclass
class SLORule:
  """One threshold SLO: healthy while ``value <op> target`` holds for
  the matched metric.

  ``metric`` is either a full registry key (``serving/fleet/ttft_p99_s``
  — exact match) or a bare metric name (``ttft_p99_s`` — matches ANY
  key whose last path segment equals it: the fleet rollup, every
  ``serving/replica<i>/*`` record and a bare engine's ``serving/*``
  record all evaluate under one rule, each tracked as its own breach
  stream).  ``for_records`` requires that many CONSECUTIVE violating
  observations of one key before the breach fires (debounce for noisy
  percentiles)."""
  name: str
  metric: str
  op: str = "<="
  target: float = 0.0
  for_records: int = 1

  def __post_init__(self):
    if self.op not in _OPS:
      raise ValueError(f"SLORule op must be one of {sorted(_OPS)}: "
                       f"{self.op!r}")
    if self.for_records < 1:
      raise ValueError(f"for_records must be >= 1: {self.for_records}")

  def healthy(self, value: float) -> bool:
    return _OPS[self.op](value, self.target)


@dataclasses.dataclass
class BurnRateRule:
  """Error-budget burn over fast/slow record windows (multi-window
  burn-rate alerting).

  ``bad`` and ``good`` name CUMULATIVE counters (suffix-matched like
  :class:`SLORule.metric`, both under the same key prefix);
  ``objective`` is the promised good fraction (0.99 = at most 1% of
  events may be bad).  Each observation appends the counter pair; the
  burn rate over a window of N records is::

      burn = (Δbad / (Δbad + Δgood)) / (1 - objective)

  i.e. how many times faster than "exactly exhausting the budget" the
  budget is being spent.  A breach fires only when BOTH the fast window
  (catches a spike) and the slow window (proves it is sustained) exceed
  their thresholds — the standard shape that alerts fast on real
  incidents without paging on one bad record."""
  name: str
  bad: str
  good: str
  objective: float = 0.99
  fast_window: int = 5
  slow_window: int = 20
  fast_burn: float = 10.0
  slow_burn: float = 2.0

  def __post_init__(self):
    if not 0.0 <= self.objective < 1.0:
      raise ValueError(f"objective must be in [0, 1): {self.objective}")
    if not 1 <= self.fast_window <= self.slow_window:
      raise ValueError(
          f"need 1 <= fast_window <= slow_window; got "
          f"{self.fast_window}, {self.slow_window}")
    if self.fast_burn <= 0 or self.slow_burn <= 0:
      raise ValueError("burn thresholds must be > 0")

  def burn(self, history: Deque[Tuple[float, float]], window: int
           ) -> Optional[float]:
    """Burn rate over the last ``window`` record intervals, or None when
    the window has not FILLED yet or saw no traffic (no verdict — a
    partial slow window would collapse onto the fast one and let a
    single startup blip page, defeating the both-windows debounce; an
    idle fleet is not healthy OR unhealthy, it is silent)."""
    if len(history) < window + 1:
      return None
    lo = history[len(history) - 1 - window]
    hi = history[-1]
    d_bad = hi[0] - lo[0]
    d_total = d_bad + (hi[1] - lo[1])
    if d_total <= 0:
      return None
    return (d_bad / d_total) / max(1.0 - self.objective, 1e-9)


def _match_keys(metric: str, record: Mapping[str, Any]) -> List[str]:
  """Keys of ``record`` the rule's metric selector matches: exact key
  when the selector contains a ``/``, else any key whose last path
  segment equals it."""
  if "/" in metric:
    return [metric] if metric in record else []
  return [k for k in record if k.rsplit("/", 1)[-1] == metric]


class DiagnosticCapture:
  """Bounded, rate-limited diagnostic-bundle writer (module docstring).

  A bundle is a timestamped directory under ``out_dir``::

      bundle_<unix>_<seq>_<reason>/
        meta.json       # reason, step, wall time, trigger payload
        trace.json      # the tracer ring's tail (last `ring_tail`
                        #   events + track metadata; Perfetto-loadable,
                        #   but truncated spans are expected — it is a
                        #   flight recording, not a validated export)
        registry.json   # MetricRegistry.latest() snapshot (JSON-safe)
        state.json      # engine/scheduler context-provider summaries

  Staged as ``<bundle>.tmp`` then atomically renamed (the saver's
  crash-consistency rule), so a bundle that exists is complete.
  ``min_interval_s`` rate-limits writes and ``limit`` bounds retained
  bundles (oldest deleted first) — a flapping fleet breaching every
  sweep costs one bundle per interval and bounded disk, never a full
  volume.  Thread-safe: the watchdog's monitor thread captures
  concurrently with the host loop."""

  def __init__(self, out_dir: str, limit: int = 8,
               min_interval_s: float = 30.0, ring_tail: int = 2048,
               clock: Callable[[], float] = vclock.monotonic):
    if limit < 1:
      raise ValueError(f"limit must be >= 1: {limit}")
    if min_interval_s < 0 or ring_tail < 1:
      raise ValueError("min_interval_s must be >= 0 and ring_tail >= 1")
    self.out_dir = out_dir
    self.limit = limit
    self.min_interval_s = min_interval_s
    self.ring_tail = ring_tail
    self.clock = clock
    self.captures = 0
    self.suppressed = 0
    self._last: Optional[float] = None
    self._seq = 0
    self._lock = threading.Lock()

  @staticmethod
  def _json_safe(value: Any) -> Any:
    if value is None or isinstance(value, (bool, int, float, str)):
      return value
    if isinstance(value, Mapping):
      return {str(k): DiagnosticCapture._json_safe(v)
              for k, v in value.items()}
    if isinstance(value, (list, tuple)):
      return [DiagnosticCapture._json_safe(v) for v in value]
    try:
      if getattr(value, "shape", None) == ():
        return float(value)  # host/np scalar; rare path, sync is fine
      if hasattr(value, "shape"):
        return {"shape": list(value.shape),
                "dtype": str(getattr(value, "dtype", "?"))}
    except Exception:  # noqa: BLE001 — diagnostics must not raise
      pass
    return repr(value)[:200]

  def capture(self, reason: str, step: Optional[int] = None,
              payload: Optional[Dict[str, Any]] = None,
              context: Optional[Dict[str, Any]] = None,
              tracer=None, registry=None) -> Optional[str]:
    """Write one bundle; returns its path, or None when rate-limited.
    Never raises — a broken disk must not take the serving loop down
    with it (the capture is the diagnosis, not the patient)."""
    with self._lock:
      now = self.clock()
      if self._last is not None and now - self._last < self.min_interval_s:
        self.suppressed += 1
        return None
      self._last = now
      self._seq += 1
      seq = self._seq
    try:
      return self._write(reason, seq, step, payload, context, tracer,
                         registry)
    except Exception as e:  # noqa: BLE001
      get_logger().warning(
          "diagnostic capture for %r failed (%s: %s); serving continues",
          reason, type(e).__name__, e)
      return None

  def _write(self, reason, seq, step, payload, context, tracer,
             registry) -> str:
    slug = re.sub(r"[^A-Za-z0-9_-]+", "_", reason)[:48] or "anomaly"
    name = f"bundle_{int(vclock.wall())}_{seq:04d}_{slug}"
    final = os.path.join(self.out_dir, name)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    def dump(fname, obj):
      with open(os.path.join(tmp, fname), "w") as f:
        json.dump(self._json_safe(obj), f, indent=1)

    dump("meta.json", {
        "reason": reason, "step": step, "time": vclock.wall(),
        "payload": payload or {}})
    if tracer is not None and getattr(tracer, "enabled", False):
      events = tracer.events()
      meta = [e for e in events if e.get("ph") == "M"]
      tail = [e for e in events if e.get("ph") != "M"][-self.ring_tail:]
      with open(os.path.join(tmp, "trace.json"), "w") as f:
        json.dump({"traceEvents": meta + tail,
                   "otherData": {"note": "ring tail at capture time; "
                                         "truncated spans expected"}},
                  f)
    if registry is not None:
      dump("registry.json", registry.latest())
    if context:
      dump("state.json", context)
    os.replace(tmp, final)
    self.captures += 1
    self._enforce_retention()
    get_logger().warning("diagnostic bundle captured: %s (reason %s)",
                         final, reason)
    return final

  def _enforce_retention(self):
    try:
      bundles = sorted(
          d for d in os.listdir(self.out_dir)
          if d.startswith("bundle_") and not d.endswith(".tmp"))
    except OSError:
      return
    for stale in bundles[:-self.limit] if len(bundles) > self.limit else []:
      shutil.rmtree(os.path.join(self.out_dir, stale),
                    ignore_errors=True)


class SLOMonitor:
  """Declarative SLO evaluation over registry records (module
  docstring).

  Usage::

      monitor = SLOMonitor([SLORule("ttft_p99", "ttft_p99_s",
                                    "<=", 0.5)],
                           events_path="slo_events.jsonl")
      registry.add_sink_once(monitor)   # records now flow through
      monitor.observe(step, {"serving/fleet/ttft_p99_s": 0.7})  # direct

  Breach state is per (rule, matched key): a fleet-level TTFT breach
  and a single replica's are separate streams with separate recovery.
  ``note_event`` injects first-class breaches that do not come from a
  record (the compile sentinel's recompile, the watchdog's hang).
  """

  def __init__(self, rules: Optional[List[Any]] = None,
               events_path: str = "",
               capture: Optional[DiagnosticCapture] = None,
               wall_clock: Callable[[], float] = vclock.wall,
               history_limit: int = 1024):
    self.rules = list(rules or ())
    names = [r.name for r in self.rules]
    if len(names) != len(set(names)):
      raise ValueError(f"duplicate SLO rule names: {sorted(names)}")
    self.events_path = events_path
    self.capture = capture
    self.wall_clock = wall_clock
    self.breaches = 0          # breach transitions + injected events
    self.recoveries = 0
    self.actuations = 0        # note_actuation records (actuator layer)
    self.listener_errors = 0   # raising listener callbacks, cumulative
    # (rule_name, key) -> {"breached": bool, "streak": int, "hist": deque}
    self._state: Dict[Tuple[str, str], Dict[str, Any]] = {}
    self.events: Deque[Dict[str, Any]] = deque(maxlen=history_limit)
    self._file = None
    self._listeners: List[Callable[[], Optional[Callable]]] = []
    self._context_providers: List[Callable[[], Optional[Callable]]] = []
    self._lock = threading.Lock()
    self._registry = None      # last attached registry, for bundles

  # ------------------------------------------------------------ wiring

  def attach(self, registry) -> None:
    """Route a registry's records through this monitor (idempotent) and
    remember it as the bundle snapshot source."""
    if registry is None:
      return
    registry.add_sink_once(self)
    self._registry = registry

  def add_listener(self, fn: Callable[[str, Dict[str, Any]], None],
                   weak: bool = False) -> None:
    """Subscribe ``fn(rule_name, payload)`` to every breach event.
    ``weak=True`` holds the bound method weakly (an engine subscribing
    must stay collectible — the monitor is ambient and outlives it).

    Listener failures are ISOLATED: a raising callback is caught,
    logged once per listener, counted (:attr:`listener_errors`, plus
    the ``slo/listener_errors`` counter track), and never breaks
    monitoring, the caller's step, or sibling listeners."""
    self._listeners.append({
        "ref": weakref.WeakMethod(fn) if weak else (lambda _f=fn: _f),
        "logged": False})

  def add_context_provider(self, fn: Callable[[], Dict[str, Any]],
                           weak: bool = True) -> None:
    """Register a state-summary callable merged into diagnostic bundles
    (the engine's scheduler/allocator summary).  Weak by default for
    the same lifetime reason as :meth:`add_listener`."""
    self._context_providers.append(
        weakref.WeakMethod(fn) if weak else (lambda _f=fn: _f))

  def _collect(self, refs) -> List[Callable]:
    alive, out = [], []
    for ref in refs:
      fn = ref()
      if fn is not None:
        alive.append(ref)
        out.append(fn)
    refs[:] = alive
    return out

  def status(self) -> Dict[str, str]:
    """Current per-stream state: ``{"rule@key": "breach"|"ok"}``."""
    return {f"{name}@{key}": ("breach" if st["breached"] else "ok")
            for (name, key), st in self._state.items()}

  def breached_streams(self, scope: Optional[str] = None
                       ) -> List[Tuple[str, str]]:
    """Currently-breached ``(rule_name, metric_key)`` streams — the
    live-pressure view actuators poll between steps (a breach EVENT
    fires only on the transition; sustained overload looks like a
    stream that stays breached, serving/autotune.py).

    ``scope`` restricts the view to streams whose metric key lives
    under that namespace prefix (``key == scope`` or starts with
    ``scope + "/"``) — how the rollout controller watches ONLY the
    canary's per-version streams (``serving/fleet/v<N>/...``) while the
    fleet-wide streams keep feeding the autoscaler."""
    out = [(name, key) for (name, key), st in self._state.items()
           if st["breached"]]
    if scope is not None:
      out = [(name, key) for name, key in out
             if key == scope or key.startswith(scope + "/")]
    return out

  def breached_stream_obs(self) -> Dict[Tuple[str, str], int]:
    """Observation counts for the currently-breached streams: how many
    records each has EVER evaluated.  Actuators distinguish a live
    sustained breach (records keep flowing, the count keeps growing —
    hold/escalate mitigation) from a stale wedged one (an idle
    engine's burn stream renders no verdict and the count freezes —
    release mitigation) by watching this grow, since neither case
    re-fires the transition event."""
    return {(name, key): st.get("obs", 0)
            for (name, key), st in self._state.items()
            if st["breached"]}

  # --------------------------------------------------------- evaluation

  def observe(self, step: int, record: Mapping[str, Any]) -> None:
    """Evaluate every rule against one namespaced record.  Cheap: a few
    string/float comparisons per rule; device arrays are skipped (see
    module docstring)."""
    for rule in self.rules:
      if isinstance(rule, BurnRateRule):
        self._observe_burn(rule, step, record)
      else:
        self._observe_threshold(rule, step, record)

  # Registry-sink surface: attaching the monitor via add_sink_once makes
  # every publisher's records flow through observe with no new plumbing.
  def write(self, step: int, record: Mapping[str, Any]) -> None:
    self.observe(step, record)

  def flush(self) -> None:
    with self._lock:
      if self._file is not None:
        self._file.flush()

  def close(self) -> None:
    with self._lock:
      if self._file is not None:
        self._file.close()
        self._file = None

  def _observe_threshold(self, rule: SLORule, step: int,
                         record: Mapping[str, Any]) -> None:
    for key in _match_keys(rule.metric, record):
      value = record[key]
      if not _is_scalar(value):
        continue
      value = float(value)
      st = self._state.setdefault(
          (rule.name, key), {"breached": False, "streak": 0, "obs": 0})
      st["obs"] = st.get("obs", 0) + 1
      if rule.healthy(value):
        st["streak"] = 0
        if st["breached"]:
          st["breached"] = False
          self.recoveries += 1
          self._emit("recover", rule.name, step, {
              "metric": key, "value": value, "target": rule.target,
              "op": rule.op})
        continue
      st["streak"] += 1
      if not st["breached"] and st["streak"] >= rule.for_records:
        st["breached"] = True
        self._breach(rule.name, step, {
            "metric": key, "value": value, "target": rule.target,
            "op": rule.op, "for_records": rule.for_records})

  def _observe_burn(self, rule: BurnRateRule, step: int,
                    record: Mapping[str, Any]) -> None:
    for bad_key in _match_keys(rule.bad, record):
      prefix = bad_key.rsplit("/", 1)[0] if "/" in bad_key else ""
      good_key = (f"{prefix}/{rule.good}" if prefix else rule.good) \
          if "/" not in rule.good else rule.good
      if good_key not in record:
        continue
      bad_v, good_v = record[bad_key], record[good_key]
      if not (_is_scalar(bad_v) and _is_scalar(good_v)):
        continue
      st = self._state.setdefault(
          (rule.name, bad_key),
          {"breached": False, "streak": 0, "obs": 0,
           "hist": deque(maxlen=rule.slow_window + 1)})
      st["obs"] = st.get("obs", 0) + 1
      st["hist"].append((float(bad_v), float(good_v)))
      fast = rule.burn(st["hist"], rule.fast_window)
      slow = rule.burn(st["hist"], rule.slow_window)
      if fast is None or slow is None:
        continue
      burning = fast >= rule.fast_burn and slow >= rule.slow_burn
      if burning and not st["breached"]:
        st["breached"] = True
        self._breach(rule.name, step, {
            "metric": bad_key, "fast_burn": fast, "slow_burn": slow,
            "fast_threshold": rule.fast_burn,
            "slow_threshold": rule.slow_burn,
            "objective": rule.objective})
      elif st["breached"] and fast < rule.fast_burn:
        # Recovery keys off the fast window alone: once the recent burn
        # is back under budget the incident is over — waiting for the
        # slow window to drain would hold the alert long after the fix.
        st["breached"] = False
        self.recoveries += 1
        self._emit("recover", rule.name, step, {
            "metric": bad_key, "fast_burn": fast, "slow_burn": slow})

  # ----------------------------------------------------------- emission

  def note_event(self, name: str, payload: Optional[Dict[str, Any]] = None,
                 step: Optional[int] = None,
                 context: Optional[Dict[str, Any]] = None) -> None:
    """Inject a first-class breach that does not come from a record —
    the compile sentinel's ``unexpected_recompile``, the watchdog's
    ``watchdog_timeout``.  Same three-way emission as a rule breach."""
    self._breach(name, step, dict(payload or {}), context=context)

  def note_actuation(self, name: str,
                     payload: Optional[Dict[str, Any]] = None,
                     step: Optional[int] = None) -> None:
    """Record one self-healing actuation (serving/autotune.py moved a
    knob, serving/autoscale.py resized the replica set) as an
    ``slo_events.jsonl`` line + ``slo/actuation`` trace instant — the
    stream ``report.py --follow`` renders so operators watch the loop
    close.  NOT a breach: no capture, no listener fan-out (an actuator
    reacting to its own actuation would be a feedback loop), and the
    breach counter is untouched."""
    self.actuations += 1
    self._emit("actuation", name, step, dict(payload or {}))

  def _breach(self, name: str, step: Optional[int],
              payload: Dict[str, Any],
              context: Optional[Dict[str, Any]] = None) -> None:
    self.breaches += 1
    # Capture FIRST so the one listener notification (and the jsonl
    # line) already carries the bundle path — notifying before and
    # again after would double-trigger any subscriber that acts per
    # callback (remediation hooks, autotuners).
    if self.capture is not None:
      ctx = dict(context or {})
      for fn in self._collect(self._context_providers):
        try:
          ctx.update(fn() or {})
        except Exception:  # noqa: BLE001
          pass
      from easyparallellibrary_tpu_torch.observability import trace as trace_lib
      bundle = self.capture.capture(
          name, step=step, payload=dict(payload), context=ctx,
          tracer=trace_lib.get_tracer(), registry=self._registry)
      if bundle is not None:
        payload["bundle"] = bundle
    self._emit("breach", name, step, payload)
    self._notify(name, payload)

  def _notify(self, name: str, payload: Dict[str, Any]) -> None:
    """Deliver one breach to every live listener, isolating failures:
    a raising subscriber is caught (the monitor, the engine step and
    every SIBLING listener proceed), logged ONCE per listener (a
    listener broken in a loop must not flood the log), and counted —
    :attr:`listener_errors` plus a ``slo/listener_errors`` counter
    track, so a silently-broken actuator is still visible."""
    alive = []
    errors_before = self.listener_errors
    for entry in self._listeners:
      fn = entry["ref"]()
      if fn is None:
        continue
      alive.append(entry)
      try:
        fn(name, dict(payload))
      except Exception as e:  # noqa: BLE001 — a bad subscriber must not
        self.listener_errors += 1                 # wedge the monitor
        if not entry["logged"]:
          entry["logged"] = True
          get_logger().warning(
              "SLO breach listener %r failed (%s: %s); listener kept, "
              "logged once — see the slo/listener_errors counter",
              getattr(fn, "__qualname__", fn), type(e).__name__, e)
    self._listeners[:] = alive
    if self.listener_errors != errors_before:
      from easyparallellibrary_tpu_torch.observability import trace as trace_lib
      tracer = trace_lib.get_tracer()
      if tracer.enabled:
        tracer.counter("slo/listener_errors", self.listener_errors)

  def _emit(self, event: str, name: str, step: Optional[int],
            payload: Dict[str, Any]) -> None:
    rec = {"time": self.wall_clock(), "event": event, "rule": name,
           "step": step, **payload}
    with self._lock:
      self.events.append(rec)
      if self.events_path:
        if self._file is None:
          parent = os.path.dirname(os.path.abspath(self.events_path))
          os.makedirs(parent, exist_ok=True)
          self._file = open(self.events_path, "a")
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
    from easyparallellibrary_tpu_torch.observability import trace as trace_lib
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.instant(f"slo/{event}", cat="slo", track="slo",
                     args={"rule": name, "step": step,
                           **{k: v for k, v in payload.items()
                              if isinstance(v, (int, float, str))}})
      if event == "breach":
        tracer.counter("slo/breaches", self.breaches)
    log = get_logger().warning if event == "breach" else get_logger().info
    log("SLO %s: %s %s", event, name,
        {k: v for k, v in payload.items() if k != "bundle"})


class CompileSentinel:
  """Watermark over one twin's compile count (module docstring).

  ``cache_size_fn`` returns the count that must stop growing after
  warmup, read through a thunk (the port's serving engine passes the
  number of loaded kernel libraries, ``kernels._build.loaded_count``).
  ``expected`` counts are warmup (the engine sets it from the count at
  the end of its first step, since earlier work in the process may have
  loaded libraries already, and a CPU engine loads none: so 0 is a valid
  warmup count here, where the JAX package's jit caches start at 1);
  any growth beyond max(watermark, expected)
  fires ``on_recompile(label, cache_size, new_compiles, signature)``
  with the signature the caller attributes the growth to.  The check is
  one host int compare per step — cheap enough to be always-on."""

  def __init__(self, label: str, cache_size_fn: Callable[[], int],
               expected: int = 1,
               on_recompile: Optional[List[Callable]] = None):
    if expected < 0:
      raise ValueError(f"expected must be >= 0: {expected}")
    self.label = label
    self.expected = expected
    self.on_recompile: List[Callable] = list(on_recompile or ())
    self.recompiles = 0
    self._cache_size_fn = cache_size_fn
    self._watermark = 0
    self._unreadable_logged = False

  def cache_size(self) -> Optional[int]:
    try:
      return int(self._cache_size_fn())
    except Exception as e:  # noqa: BLE001 — the count is a callback
      if not self._unreadable_logged:
        self._unreadable_logged = True
        get_logger().warning(
            "compile sentinel %s cannot read the compile count (%s: "
            "%s); recompile detection disabled for this twin",
            self.label, type(e).__name__, e)
      return None

  def check(self, signature_fn: Optional[Callable[[], Any]] = None
            ) -> int:
    """Observe the current cache size; returns how many NEW unexpected
    compiles happened since the last check (0 on the healthy path).
    ``signature_fn`` is only invoked when a recompile is detected, so
    attribution costs nothing per step."""
    size = self.cache_size()
    if size is None:
      return 0
    baseline = max(self._watermark, self.expected)
    self._watermark = max(self._watermark, size)
    extra = size - baseline
    if extra <= 0:
      return 0
    self.recompiles += extra
    signature = None
    if signature_fn is not None:
      try:
        signature = signature_fn()
      except Exception:  # noqa: BLE001
        signature = "<signature unavailable>"
    get_logger().error(
        "compile sentinel %s: %d unexpected recompile(s) detected "
        "(cache size %d, expected %d) — signature: %s",
        self.label, extra, size, self.expected, signature)
    for fn in self.on_recompile:
      try:
        fn(self.label, size, extra, signature)
      except Exception as e:  # noqa: BLE001
        get_logger().warning("compile-sentinel subscriber failed "
                             "(%s: %s)", type(e).__name__, e)
    return extra


class BreachPressure:
  """Liveness poll over a monitor's breached streams — the one place
  the subtle actuator invariant lives (serving/autotune.py and
  serving/autoscale.py both ride it): a breach EVENT fires only on the
  transition, so sustained overload looks like a stream that stays
  breached, and the only way to tell a LIVE sustained breach (keep
  mitigating) from a stale wedged one (an idle engine's burn stream
  renders no verdict — release mitigation) is whether the breached
  streams' record counts are still growing.

  ``match(rule_name, metric_key)`` selects the streams this probe
  cares about.  :meth:`poll` returns ``(pressured, fresh)``:
  ``pressured`` while any matching stream is breached, ``fresh`` when
  any individual stream's observation count GREW (or a new breached
  stream appeared) since the last poll — the caller refreshes its own
  staleness clock (engine steps, wall time) on ``fresh``.  Freshness
  is judged PER STREAM, never on an aggregate: one stream recovering
  shrinks a sum without a single new record on the wedged survivors,
  and must not read as life."""

  def __init__(self, monitor: Optional[SLOMonitor],
               match: Callable[[str, str], bool]):
    self.monitor = monitor
    self.match = match
    self._counts: Dict[Tuple[str, str], int] = {}

  def poll(self) -> Tuple[bool, bool]:
    if self.monitor is None:
      return False, False
    current = {sk: count for sk, count
               in self.monitor.breached_stream_obs().items()
               if self.match(*sk)}
    if not current:
      self._counts = {}
      return False, False
    fresh = any(count > self._counts.get(sk, -1)
                for sk, count in current.items())
    self._counts = current
    return True, fresh


# ------------------------------------------------------ ambient monitor --

_monitor: Optional[SLOMonitor] = None
_auto_sig: Optional[Tuple] = None


def get_monitor() -> Optional[SLOMonitor]:
  """The ambient SLO monitor, or None when monitoring is off."""
  return _monitor


def install(monitor: Optional[SLOMonitor]) -> Optional[SLOMonitor]:
  """Pin an explicit monitor (None = uninstall); wins over config."""
  global _monitor, _auto_sig
  _monitor = monitor
  _auto_sig = None
  return monitor


def reset():
  """Drop any ambient monitor (tests)."""
  old = _monitor
  install(None)
  if old is not None:
    old.close()


def rules_from_config(slo_conf) -> List[Any]:
  """The declarative rule set the ``observability.slo.*`` knobs
  describe (docs/observability.md "SLO monitoring"); every rule uses
  bare-name metric matching so fleet, per-replica and bare-engine
  records all evaluate."""
  rules: List[Any] = []
  if slo_conf.ttft_p99_s > 0:
    rules.append(SLORule("ttft_p99", "ttft_p99_s", "<=",
                         slo_conf.ttft_p99_s))
  if slo_conf.itl_p99_s > 0:
    rules.append(SLORule("itl_p99", "itl_p99_s", "<=",
                         slo_conf.itl_p99_s))
  if slo_conf.shed_objective > 0:
    rules.append(BurnRateRule(
        "shed_burn", bad="shed", good="finished_requests",
        objective=slo_conf.shed_objective,
        fast_window=slo_conf.fast_window,
        slow_window=slo_conf.slow_window,
        fast_burn=slo_conf.fast_burn, slow_burn=slo_conf.slow_burn))
  if slo_conf.replicas_down:
    # Fleet availability: any replica down is a breach window — the
    # serving/fleet/* rollup carries the per-state counts.
    rules.append(SLORule("replica_down", "replicas_down", "<=", 0.0))
  if slo_conf.hbm_frac > 0:
    # Device-memory headroom: the introspector's HBM gauges
    # (observability/device.py) publish hbm_frac only where torch.cuda
    # reports the card's memory, so the rule is inert on the CPU.
    rules.append(SLORule("hbm_high", "hbm_frac", "<=",
                         slo_conf.hbm_frac))
  return rules


def ensure_configured(config=None) -> Optional[SLOMonitor]:
  """Reconcile the ambient monitor with ``config.observability.slo``
  (the active Env's config when None) — the tracer's
  ``ensure_configured`` contract, including the rule that only the
  AMBIENT Env config may tear down or rebuild an auto-built monitor
  (rebuilding drops breach state and closes the events file; a
  component's explicit config can enable monitoring but never discard
  the run's)."""
  global _monitor, _auto_sig
  if _monitor is not None and _auto_sig is None:
    return _monitor  # explicit install wins
  from easyparallellibrary_tpu_torch.env import Env
  if config is None:
    config = Env.get().config
    ambient = True
  else:
    ambient = config is Env.get().config
  slo = config.observability.slo
  if not slo.enabled:
    if _auto_sig is not None and ambient:
      _monitor.close()
      _monitor = None
      _auto_sig = None
    return _monitor
  sig = (slo.events_path, slo.ttft_p99_s, slo.itl_p99_s,
         slo.shed_objective, slo.fast_window, slo.slow_window,
         slo.fast_burn, slo.slow_burn, slo.replicas_down, slo.hbm_frac,
         slo.capture_dir, slo.capture_limit, slo.capture_min_interval_s,
         slo.capture_ring_tail)
  if _monitor is not None and (_auto_sig == sig or not ambient):
    return _monitor
  if _monitor is not None:
    _monitor.close()
  capture = None
  if slo.capture_dir:
    capture = DiagnosticCapture(
        slo.capture_dir, limit=slo.capture_limit,
        min_interval_s=slo.capture_min_interval_s,
        ring_tail=slo.capture_ring_tail)
  _monitor = SLOMonitor(rules_from_config(slo),
                        events_path=slo.events_path, capture=capture)
  _auto_sig = sig
  get_logger().info(
      "SLO monitor: %d rule(s) [%s], events -> %s, deep capture %s",
      len(_monitor.rules),
      ", ".join(r.name for r in _monitor.rules),
      slo.events_path or "(memory only)",
      f"-> {slo.capture_dir}" if capture else "off")
  return _monitor
