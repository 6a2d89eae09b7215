"""Namespaced metric registry — one schema over every metric producer
(port of ``easyparallellibrary_tpu/observability/registry.py``).

Before this module, each producer shipped its own ad-hoc dict to
whatever sink it happened to hold: ``fit()`` wrote raw step metrics,
the serving engine wrote its own per-step record, ``StepProfiler`` /
``FlopsProfiler`` logged summaries, and resilience counters rode along
as bare keys.  Nothing downstream could tell ``loss`` from
``step_time_s`` from ``tokens_per_s`` without knowing who wrote the
line.

The registry fixes the schema, not the sinks: every metric is published
under one of four namespaces and lands in the existing
``MetricsWriter`` / ``TensorBoardWriter`` (or anything with the same
``write(step, metrics)`` / ``flush()`` / ``close()`` surface) as
``<namespace>/<name>`` keys:

====================  ====================================================
namespace             producers
====================  ====================================================
``train/*``           fit() step metrics, StepProfiler / FlopsProfiler
                      step-time / MFU summaries
``serving/*``         ContinuousBatchingEngine per-step records,
                      ServingStats rollups (tokens/s, TTFT, ITL,
                      occupancy, speculation counters)
``comm/*``            FlopsProfiler collective-traffic counters
                      (comm_gb_per_step, comm_share)
``resilience/*``      sentinel bad-step counters, IO retries, rollbacks,
                      watchdog timeouts
``observability/*``   the observability layer's own device-truth channel
                      (``observability/device/*``: compiled-twin cost
                      cards, HBM watermark gauges —
                      observability/device.py)
====================  ====================================================

Publishing is buffer-friendly: values pass through RAW (device tensors
included) — the sinks already defer the ``float()`` host sync to their
flush boundary, and the registry must not reintroduce a per-step sync.
Sub-namespaces are allowed (``serving/slot0/...``); only the root is
validated.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

NAMESPACES = ("train", "serving", "comm", "resilience", "observability")

# Well-known sub-namespaces, shared so producers (serving/router.py)
# and consumers (observability/report.py's rollup/--follow readers)
# never restate the literal — epl-lint's metric-schema rule validates
# every literal namespace at publish/namespaced() call sites against
# the roots above.
SERVING_NAMESPACE = "serving"
FLEET_NAMESPACE = "serving/fleet"
# Device-truth channel (observability/device.py): compiled-twin cost
# cards and HBM watermark gauges — what XLA/the runtime report, never
# host-planned quantities (those belong to the producer namespaces).
DEVICE_NAMESPACE = "observability/device"

# The key->namespace rule for producers that accumulate one flat mixed
# metrics dict (fit's step metrics, the profilers' summaries).  Shared
# here so the same key never lands under train/* in one record and
# resilience/* in another; a new counter is added to ONE set and every
# producer routes it identically.
RESILIENCE_KEYS = frozenset(
    ("bad_steps", "bad_steps_total", "update_skipped", "io_retries",
     "rollbacks"))
COMM_KEYS = frozenset(("comm_gb_per_step", "comm_share"))


def split_namespaces(metrics: Mapping[str, Any]
                     ) -> Dict[str, Dict[str, Any]]:
  """Partition a flat metrics dict by the shared key->namespace rule
  (keys not named in a special set are ``train/*``); feed the result to
  :meth:`MetricRegistry.publish_many`."""
  out: Dict[str, Dict[str, Any]] = {"train": {}, "comm": {},
                                    "resilience": {}}
  for k, v in metrics.items():
    if k in RESILIENCE_KEYS:
      out["resilience"][k] = v
    elif k in COMM_KEYS:
      out["comm"][k] = v
    else:
      out["train"][k] = v
  return out


class MetricRegistry:
  """Fan metrics from many producers into shared sinks under one
  namespaced schema.

  ``registry = MetricRegistry(MetricsWriter(path))`` then
  ``registry.publish(step, {"loss": ...}, "train")`` writes
  ``{"train/loss": ...}``.  :meth:`publish_many` merges several
  namespaces into ONE sink record (one JSONL line / one summary step),
  which is how ``fit()`` emits train + resilience metrics per step.
  """

  def __init__(self, *sinks):
    self._sinks: List[Any] = [s for s in sinks if s is not None]
    self._latest: Dict[str, Any] = {}

  def add_sink(self, sink):
    self._sinks.append(sink)
    return sink

  def add_sink_once(self, sink):
    """Idempotent :meth:`add_sink` — the SLO monitor attaches itself to
    whatever registry each serving component holds, and N replicas
    sharing one registry must not multiply every record N ways
    (observability/slo.py)."""
    if sink not in self._sinks:
      self._sinks.append(sink)
    return sink

  @staticmethod
  def namespaced(namespace: str, metrics: Mapping[str, Any]
                 ) -> Dict[str, Any]:
    """Validate `namespace` and prefix every key with it."""
    root = namespace.split("/", 1)[0]
    if root not in NAMESPACES:
      raise ValueError(
          f"unknown metric namespace {namespace!r}; the schema roots are "
          f"{list(NAMESPACES)} (docs/observability.md)")
    return {f"{namespace}/{k}": v for k, v in metrics.items()}

  def publish(self, step: int, metrics: Mapping[str, Any],
              namespace: str = "train"):
    """Publish one producer's metrics under `namespace`."""
    self.publish_many(step, {namespace: metrics})

  def publish_many(self, step: int,
                   by_namespace: Mapping[str, Mapping[str, Any]]):
    """Publish several namespaces as ONE record (empty ones skipped)."""
    record: Dict[str, Any] = {}
    for namespace, metrics in by_namespace.items():
      if metrics:
        record.update(self.namespaced(namespace, metrics))
    if not record:
      return
    self._latest.update(record)
    for sink in self._sinks:
      sink.write(int(step), record)

  def latest(self) -> Dict[str, Any]:
    """Snapshot of the most recently published value per key (raw —
    device values are not floated here)."""
    return dict(self._latest)

  def flush(self):
    for sink in self._sinks:
      sink.flush()

  def close(self):
    """Close the sinks (the registry owns its sinks' lifecycle when the
    caller hands them over at construction, as ``fit()`` does for the
    auto-built JSONL sink)."""
    for sink in self._sinks:
      sink.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
