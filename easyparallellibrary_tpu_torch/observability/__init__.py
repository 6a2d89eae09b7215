"""Unified tracing & telemetry (port of
``easyparallellibrary_tpu/observability/``; docs/observability.md).

One event substrate for the serving engine, all host code:

* :mod:`trace` — ring-buffered host-side span tracer with Chrome /
  Perfetto JSON export, ``torch.profiler`` capture attachment
  (``Tracer.device_trace``), and a cheap ambient ``get_tracer()``;
* :mod:`registry` — the namespaced metric schema (``train/*``,
  ``serving/*``, ``comm/*``, ``resilience/*``, ``observability/*``)
  feeding the ``MetricsWriter`` / ``TensorBoardWriter`` sinks
  (``utils/metrics_writer.py``);
* :mod:`report` — ``python -m easyparallellibrary_tpu_torch.observability
  .report <trace>`` latency-breakdown summaries, including per-request
  serving timelines (``--follow`` tails a live metrics JSONL);
* :mod:`slo` — declarative SLO rules over the registry records, the
  always-on compile sentinel, and anomaly-triggered diagnostic-bundle
  capture (``observability.slo.*``);
* :mod:`device` — device truth: twin cost cards captured after the
  first step, HBM watermark gauges from ``torch.cuda``, and the
  per-site collective-bytes store (``observability.device.*``).

Knobs: the ``observability.*`` config group (enabled / trace_path /
ring_capacity / sample_rate / metrics_jsonl / slo.* / device.*).  The
JAX package's ``perfgate`` is not ported (ROADMAP.md Queue 1, "Other
models and the tooling").
"""

from easyparallellibrary_tpu_torch.observability.device import (
    CostCard, DeviceIntrospector, get_introspector,
)
from easyparallellibrary_tpu_torch.observability.registry import (
    NAMESPACES, MetricRegistry, split_namespaces,
)
from easyparallellibrary_tpu_torch.observability.slo import (
    BurnRateRule, CompileSentinel, DiagnosticCapture, SLOMonitor,
    SLORule, get_monitor,
)
from easyparallellibrary_tpu_torch.observability.trace import (
    Tracer, ensure_configured, get_tracer, install, validate_trace,
)

__all__ = [
    "MetricRegistry", "NAMESPACES", "split_namespaces",
    "BurnRateRule", "CompileSentinel", "CostCard", "DeviceIntrospector",
    "DiagnosticCapture", "SLOMonitor", "SLORule", "get_introspector",
    "get_monitor", "Tracer", "ensure_configured", "get_tracer",
    "install", "validate_trace",
]
