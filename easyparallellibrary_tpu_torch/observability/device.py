"""Device-truth observability: twin cost cards, per-site measured
collective bytes, and HBM watermark gauges (port of
``easyparallellibrary_tpu/observability/device.py``).

The tracing/SLO stack (observability/trace.py, slo.py) sees the HOST
side of every step: spans bracket ``device_step``, counters track what
the scheduler planned.  This module is the measured half:

* :class:`CostCard` — one twin's device truth, captured ONCE after its
  first step.  The JAX package reads XLA's compiled-program analysis;
  PyTorch runs eagerly and has no compiled program to ask, so the
  serving engine fills the card from what it can count and measure:
  ``flops`` and ``bytes_accessed`` of the GPT forward at the step's
  token capacity (``profiler/flops.py``), ``argument_bytes`` (params
  plus the KV caches), ``peak_hbm_bytes`` (the arguments plus what the
  first step added at its peak, :class:`StepPeak`: by the allocator
  after ``torch.cuda.reset_peak_memory_stats`` on the card; on the CPU
  from ``torch.profiler``'s memory events, each allocation rounded up to
  the card allocator's 512-byte block, a bound of the card's reading
  where the kernels allocate no more than their plain versions), and ``donation_verified`` — whether the step
  wrote the KV caches in place, read off the caches' ``data_ptr()``
  before and after the step: the port's counterpart of XLA's
  ``alias_size_in_bytes > 0``.  :meth:`DeviceIntrospector.capture_twin`
  takes a callable that returns the card's fields and never raises.
* **Per-site measured collective bytes** — :meth:`register_site`,
  :meth:`record_site_bytes` and :func:`measured_collective_bytes` are
  the host APIs of the overlap planner.  :func:`profile_site_bytes`
  measures a site: it runs one call of the site's code under
  ``torch.profiler`` and counts the bytes handed to every collective
  the backend ran (its ``nccl:<op>`` / ``gloo:<op>`` events, elements
  times the site's dtype width), then records them for the site.
* **HBM watermark gauges** — :meth:`DeviceIntrospector.hbm_gauges`
  reads ``torch.cuda.memory_allocated`` (in use),
  ``max_memory_allocated`` (peak) and ``mem_get_info()[1]`` (the card's
  memory, the limit) for the current card, so ``hbm_frac`` feeds the
  ``observability.slo.hbm_frac`` rule; without a card it degrades to the
  cost cards' bound (``hbm_source = "cost_card"``), as the JAX package
  does where ``memory_stats()`` is None.  ``mem_get_info`` is a driver
  call, so the gauges are read on the engine's stats cadence, never
  every step.  Published under ``observability/device/*``, as Perfetto
  counter tracks, and into diagnostic bundles.

Ambient wiring mirrors the tracer/monitor contract
(:func:`ensure_configured` reconciles with ``observability.device.*``;
:func:`install` pins an explicit introspector for tests).  Capture is
defensive end to end: introspection describes the program, it must
never take the program down — every capture failure degrades to a
logged skip.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from easyparallellibrary_tpu_torch.utils.logging import get_logger


@dataclasses.dataclass
class SiteInfo:
  """One registered overlap site: the analytic signature the overlap
  policy saw, kept so a later measurement can be matched back to the
  site that will consume it."""
  site: str
  kind: str
  axis_n: int
  m: int
  k: int
  n_out: int
  dtype_bytes: int

  def expected_result_bytes(self) -> float:
    """Result-tensor bytes of this site's fused collective (the gathered
    ``[n m, k]`` input of an all-gather, the scattered ``[m / n, N]``
    block of a reduce-scatter); wire bytes are derived from it."""
    n = max(self.axis_n, 1)
    if self.kind == "all_gather_matmul":
      return float(n * self.m * self.k * self.dtype_bytes)
    if self.kind == "matmul_reduce_scatter":
      return float(self.m / n * self.n_out * self.dtype_bytes)
    return float(self.m / n * self.k * self.dtype_bytes)

  def wire_bytes_from_result(self, result_bytes: float) -> float:
    """Ring wire bytes implied by a fused result of ``result_bytes``: an
    all-gather moves (n - 1) / n of its gathered result past each rank, a
    reduce-scatter n - 1 copies of its scattered block."""
    n = max(self.axis_n, 1)
    if self.kind == "all_gather_matmul":
      return result_bytes * (n - 1) / n
    return result_bytes * (n - 1)


@dataclasses.dataclass
class CostCard:
  """Device truth for one twin, captured after its first step (module
  docstring).  The fields keep the JAX package's names so records and
  bundles read the same; ``temp_bytes``, ``alias_bytes`` and the
  collective fields stay 0 where the port has nothing to measure."""
  label: str                       # twin label (serving/fused_step, ...)
  flops: float = 0.0
  bytes_accessed: float = 0.0
  collective_wire_bytes: float = 0.0   # sum over collective ops
  collective_ops: int = 0
  site_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
  argument_bytes: float = 0.0
  output_bytes: float = 0.0
  temp_bytes: float = 0.0
  alias_bytes: float = 0.0
  generated_code_bytes: float = 0.0
  peak_hbm_bytes: float = 0.0
  donation_requested: bool = False
  donation_verified: bool = False
  compile_count: int = 0           # the twin's compile count at capture
  meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

  def metrics(self) -> Dict[str, float]:
    """Flat numeric view for the registry (host floats only; ``meta``
    numeric entries ride along)."""
    out = {
        "flops": self.flops,
        "bytes_accessed": self.bytes_accessed,
        "collective_wire_bytes": self.collective_wire_bytes,
        "collective_ops": float(self.collective_ops),
        "argument_bytes": self.argument_bytes,
        "output_bytes": self.output_bytes,
        "temp_bytes": self.temp_bytes,
        "alias_bytes": self.alias_bytes,
        "peak_hbm_bytes": self.peak_hbm_bytes,
        "donation_verified": float(self.donation_verified),
        "compile_count": float(self.compile_count),
    }
    for k, v in self.meta.items():
      if isinstance(v, (int, float)) and not isinstance(v, bool):
        out[k] = float(v)
    if self.meta.get("tokens_per_step"):
      out["flops_per_token"] = (
          self.flops / float(self.meta["tokens_per_step"]))
    return out

  def summary(self) -> Dict[str, Any]:
    d = self.metrics()
    d["label"] = self.label
    if self.site_bytes:
      d["site_bytes"] = dict(self.site_bytes)
    return d


class DeviceIntrospector:
  """Cost cards + the per-site measurement store + HBM gauges (module
  docstring).  Thread-safe: the stores are lock-guarded (a
  watchdog-triggered bundle may read the summary while the engine
  captures)."""

  def __init__(self, hbm_gauges: bool = True, site_feed: bool = True,
               cards_path: str = ""):
    self.hbm_gauges_enabled = hbm_gauges
    self.site_feed = site_feed
    self.cards_path = cards_path
    self.cards: Dict[str, CostCard] = {}
    self.captures = 0
    self.capture_failures = 0
    self._sites: Dict[str, SiteInfo] = {}
    self._measured: Dict[str, float] = {}
    self._lock = threading.Lock()
    self._fail_logged: set = set()

  # ------------------------------------------------------------- sites

  def register_site(self, site: str, *, kind: str, axis_n: int, m: int,
                    k: int, n_out: int, dtype_bytes: int) -> None:
    """Record one overlap site's analytic signature."""
    if not self.site_feed:
      return
    with self._lock:
      self._sites[site] = SiteInfo(site, kind, int(axis_n), int(m),
                                   int(k), int(n_out), int(dtype_bytes))

  def record_site_bytes(self, site: str, wire_bytes: float) -> None:
    """Store a measured per-step wire-byte figure for ``site`` — the
    value the overlap policy consumes in place of its analytic
    derivation."""
    with self._lock:
      self._measured[site] = float(wire_bytes)

  def measured_site_bytes(self, site: str) -> Optional[float]:
    with self._lock:
      return self._measured.get(site)

  def sites(self) -> Dict[str, SiteInfo]:
    with self._lock:
      return dict(self._sites)

  def measured(self) -> Dict[str, float]:
    with self._lock:
      return dict(self._measured)

  # ----------------------------------------------------------- capture

  def has_card(self, label: str) -> bool:
    with self._lock:
      return label in self.cards

  def card(self, label: str) -> Optional[CostCard]:
    with self._lock:
      return self.cards.get(label)

  def capture_twin(self, label: str,
                   collect: Callable[[], Mapping[str, Any]],
                   compile_count: Optional[int] = None,
                   meta: Optional[Mapping[str, Any]] = None
                   ) -> Optional[CostCard]:
    """Record one twin's :class:`CostCard` from ``collect()``, which
    returns the card's measured fields (``flops``, ``bytes_accessed``,
    ``argument_bytes``, ``peak_hbm_bytes``, ``donation_requested``,
    ``donation_verified``, ...).  Idempotent per label; never raises (a
    failed capture logs once per label and serving continues)."""
    with self._lock:
      if label in self.cards:
        return self.cards[label]
    try:
      card = CostCard(label=label, compile_count=int(compile_count or 0),
                      meta=dict(meta or {}), **dict(collect()))
    except Exception as e:  # noqa: BLE001 — introspection must not crash
      self.capture_failures += 1
      if label not in self._fail_logged:
        self._fail_logged.add(label)
        get_logger().warning(
            "device introspection of twin %s failed (%s: %s); cost card "
            "skipped (logged once)", label, type(e).__name__, e)
      return None
    with self._lock:
      self.cards[label] = card
      self.captures += 1
    self._emit(card)
    self._dump_cards()
    return card

  def _emit(self, card: CostCard) -> None:
    from easyparallellibrary_tpu_torch.observability import (
        trace as trace_lib)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      args = {k: v for k, v in card.summary().items()
              if isinstance(v, (int, float, str))}
      tracer.instant("device/cost_card", cat="device", track="device",
                     args=args)
      tracer.counter("device/twin_flops", card.flops)
      tracer.counter("device/twin_peak_hbm_bytes", card.peak_hbm_bytes)
    get_logger().info(
        "device cost card %s: %.3g flops, %.3g bytes accessed, "
        "%.3g peak HBM, donation %s",
        card.label, card.flops, card.bytes_accessed, card.peak_hbm_bytes,
        "verified" if card.donation_verified else
        ("NOT in place" if card.donation_requested else "not requested"))

  def _dump_cards(self) -> None:
    if not self.cards_path:
      return
    try:
      with self._lock:
        doc = {label: card.summary()
               for label, card in sorted(self.cards.items())}
        doc["sites"] = {s: dataclasses.asdict(i)
                        for s, i in sorted(self._sites.items())}
        doc["measured_site_bytes"] = dict(self._measured)
      tmp = self.cards_path + ".tmp"
      os.makedirs(os.path.dirname(os.path.abspath(self.cards_path)),
                  exist_ok=True)
      with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
      os.replace(tmp, self.cards_path)
    except OSError as e:
      get_logger().warning("device cost-card dump to %s failed: %s",
                           self.cards_path, e)

  # -------------------------------------------------------- HBM gauges

  def hbm_gauges(self) -> Dict[str, Any]:
    """Current HBM watermarks of the current card as host floats:
    ``torch.cuda``'s allocator counters (in use, peak) and the card's
    memory (``mem_get_info``, a driver call — read this on a cadence,
    not every step), with ``hbm_frac`` = in use / limit.  Without a card
    (or before this process touched one), the cost cards' bound with
    ``hbm_source = "cost_card"`` and no frac — a bound over no limit is
    not an occupancy."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
      dev = torch.cuda.current_device()
      in_use = float(torch.cuda.memory_allocated(dev))
      peak = float(torch.cuda.max_memory_allocated(dev))
      limit = float(torch.cuda.mem_get_info(dev)[1])
      out = {"hbm_bytes_in_use": in_use, "hbm_peak_bytes": peak,
             "hbm_bytes_limit": limit, "hbm_source": "memory_stats"}
      if limit > 0:
        out["hbm_frac"] = in_use / limit
      return out
    with self._lock:
      bound = max((c.peak_hbm_bytes for c in self.cards.values()),
                  default=0.0)
    if bound <= 0:
      return {}
    return {"hbm_bytes_in_use": bound, "hbm_peak_bytes": bound,
            "hbm_bytes_limit": 0.0, "hbm_source": "cost_card"}

  def publish_hbm(self, step: int, registry=None, monitor=None) -> None:
    """Publish the gauges under ``observability/device/*`` (registry
    when present — the SLO monitor rides it as a sink — else straight
    to the monitor) and as Perfetto counter tracks.  Host floats only;
    a gaugeless process publishes nothing."""
    if not self.hbm_gauges_enabled:
      return
    gauges = self.hbm_gauges()
    if not gauges:
      return
    from easyparallellibrary_tpu_torch.observability import (
        trace as trace_lib)
    from easyparallellibrary_tpu_torch.observability.registry import (
        DEVICE_NAMESPACE, MetricRegistry)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      tracer.counter("device/hbm_bytes_in_use",
                     gauges["hbm_bytes_in_use"])
      tracer.counter("device/hbm_peak_bytes", gauges["hbm_peak_bytes"])
    numeric = {k: v for k, v in gauges.items()
               if isinstance(v, (int, float))}
    if registry is not None:
      registry.publish(step, numeric, DEVICE_NAMESPACE)
    elif monitor is not None:
      monitor.observe(step,
                      MetricRegistry.namespaced(DEVICE_NAMESPACE, numeric))

  # ----------------------------------------------------------- context

  def context(self) -> Dict[str, Any]:
    """Diagnostic-bundle summary (DiagnosticCapture context provider):
    every card plus the live gauges and the site measurement store."""
    with self._lock:
      cards = {label: card.summary()
               for label, card in sorted(self.cards.items())}
      measured = dict(self._measured)
    out: Dict[str, Any] = {"cost_cards": cards}
    if measured:
      out["measured_site_bytes"] = measured
    gauges = self.hbm_gauges()
    if gauges:
      out["hbm"] = gauges
    if self.capture_failures:
      out["capture_failures"] = self.capture_failures
    return out


# --------------------------------------------------- ambient introspector


_introspector: Optional[DeviceIntrospector] = None
_auto_sig: Optional[Tuple] = None


def get_introspector() -> Optional[DeviceIntrospector]:
  """The ambient introspector, or None when device observability is
  off."""
  return _introspector


def install(intro: Optional[DeviceIntrospector]
            ) -> Optional[DeviceIntrospector]:
  """Pin an explicit introspector (None = uninstall); wins over
  config."""
  global _introspector, _auto_sig
  _introspector = intro
  _auto_sig = None
  return intro


def reset():
  """Drop any ambient introspector (tests)."""
  install(None)


def ensure_configured(config=None) -> Optional[DeviceIntrospector]:
  """Reconcile the ambient introspector with
  ``config.observability.device`` — the tracer/monitor contract:
  explicit :func:`install` wins, and only the AMBIENT Env config may
  tear down or rebuild an auto-built instance (rebuilding drops the
  cards and the site measurement store)."""
  global _introspector, _auto_sig
  if _introspector is not None and _auto_sig is None:
    return _introspector  # explicit install wins
  from easyparallellibrary_tpu_torch.env import Env
  if config is None:
    config = Env.get().config
    ambient = True
  else:
    ambient = config is Env.get().config
  dev = config.observability.device
  if not dev.enabled:
    if _auto_sig is not None and ambient:
      _introspector = None
      _auto_sig = None
    return _introspector
  sig = (dev.hbm_gauges, dev.site_feed, dev.cards_path)
  if _introspector is not None and (_auto_sig == sig or not ambient):
    return _introspector
  _introspector = DeviceIntrospector(
      hbm_gauges=dev.hbm_gauges, site_feed=dev.site_feed,
      cards_path=dev.cards_path)
  _auto_sig = sig
  get_logger().info(
      "device introspector: hbm gauges %s, site feed %s, cards -> %s",
      "on" if dev.hbm_gauges else "off",
      "on" if dev.site_feed else "off", dev.cards_path or "(memory only)")
  return _introspector


# Module-level conveniences for the overlap policy (cheap no-ops when
# device observability is off — the policy must not pay for plumbing).


def measured_collective_bytes(site: str) -> Optional[float]:
  """The measured per-step wire bytes for one overlap site, or None
  when device observability is off or the site is unmeasured (the
  analytic derivation stays the fallback)."""
  intro = _introspector
  if intro is None:
    return None
  return intro.measured_site_bytes(site)


def register_site(site: str, *, kind: str, axis_n: int, m: int, k: int,
                  n_out: int, dtype_bytes: int) -> None:
  """Register one overlap site's analytic signature with the ambient
  introspector (no-op when off)."""
  intro = _introspector
  if intro is not None:
    intro.register_site(site, kind=kind, axis_n=axis_n, m=m, k=k,
                        n_out=n_out, dtype_bytes=dtype_bytes)


# The card's caching allocator hands out blocks in multiples of 512
# bytes (``torch.cuda.memory_allocated`` counts them so).
ALLOCATOR_BLOCK = 512


def _blocks(nbytes: int) -> int:
  return -(-nbytes // ALLOCATOR_BLOCK) * ALLOCATOR_BLOCK


class StepPeak:
  """What one step adds, at its peak, to the memory in use when it
  starts: on the card the allocator's peak (``max_memory_allocated``
  after ``reset_peak_memory_stats``) less its bytes at the start; on the
  CPU the peak of ``torch.profiler``'s memory events over the step, each
  allocation rounded up to the card allocator's block, and a free
  counted only against an allocation of its size made in the step (what
  the allocator would hold on the card for the same allocations).
  ``start()`` before the step, ``stop()`` after it; ``added`` is None
  when nothing was measured (the CPU profiler was already running)."""

  def __init__(self, device):
    import torch
    self.device = torch.device(device)
    self.added: Optional[float] = None
    self._prof = None
    self._mem0 = 0

  def start(self) -> "StepPeak":
    import torch
    if self.device.type == "cuda":
      torch.cuda.reset_peak_memory_stats(self.device)
      self._mem0 = torch.cuda.memory_allocated(self.device)
      return self
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        profile_memory=True)
    try:
      prof.__enter__()
    except RuntimeError:   # another profiler holds the thread
      return self
    self._prof = prof
    return self

  def stop(self) -> Optional[float]:
    import torch
    if self.device.type == "cuda":
      if self.added is None:
        self.added = max(0.0, float(
            torch.cuda.max_memory_allocated(self.device) - self._mem0))
      return self.added
    if self._prof is None:
      return self.added
    prof, self._prof = self._prof, None
    prof.__exit__(None, None, None)
    live = peak = 0
    open_blocks: Dict[int, int] = {}
    for e in prof.profiler.kineto_results.events():
      if e.name() != "[memory]":
        continue
      n = _blocks(abs(e.nbytes()))
      if e.nbytes() > 0:
        open_blocks[n] = open_blocks.get(n, 0) + 1
        live += n
        peak = max(peak, live)
      elif open_blocks.get(n):
        open_blocks[n] -= 1
        live -= n
    self.added = float(peak)
    return self.added


def allocator_peak_bytes(device) -> float:
  """The allocator's peak allocated bytes on ``device`` since its last
  ``torch.cuda.reset_peak_memory_stats`` (0.0 off the card): the
  warmup-time read behind the serving and training cost cards."""
  import torch
  device = torch.device(device)
  if device.type != "cuda":
    return 0.0
  return float(torch.cuda.max_memory_allocated(device))


# Backend events of torch.distributed collectives in a profiler trace.
_COLLECTIVE_EVENT_PREFIXES = ("nccl:", "gloo:")


def collective_event_bytes(events, dtype_bytes: int) -> float:
  """The bytes handed to the backend's collectives in ``events`` (a
  ``torch.profiler`` event list): each ``nccl:*`` / ``gloo:*`` event's
  first input, elements times ``dtype_bytes``."""
  total = 0
  for e in events:
    if not e.name.startswith(_COLLECTIVE_EVENT_PREFIXES):
      continue
    shapes = [s for s in (e.input_shapes or []) if s]
    if shapes:
      n = 1
      for d in shapes[0]:
        n *= int(d)
      total += n * dtype_bytes
  return float(total)


def profile_site_bytes(site: str, fn: Callable[[], Any],
                       dtype_bytes: Optional[int] = None) -> float:
  """Run ``fn()`` (one step of the site's code) under ``torch.profiler``
  and return the bytes its collectives were handed
  (:func:`collective_event_bytes`); with the ambient introspector on,
  they become the site's measurement (``record_site_bytes``), which the
  overlap policy then takes over the analytic derivation.
  ``dtype_bytes`` defaults to the registered site's."""
  import torch
  intro = _introspector
  if dtype_bytes is None:
    info = intro.sites().get(site) if intro is not None else None
    if info is None:
      raise ValueError(f"site {site!r} is not registered; pass "
                       "dtype_bytes")
    dtype_bytes = info.dtype_bytes
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU],
      record_shapes=True) as prof:
    fn()
  wire = collective_event_bytes(prof.events(), dtype_bytes)
  if intro is not None:
    intro.record_site_bytes(site, wire)
  return wire
