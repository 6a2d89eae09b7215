"""Metric logging to durable files (port of
``easyparallellibrary_tpu/utils/metrics_writer.py``).

The reference re-points TF summaries at merged tensors so TensorBoard
sees global values (epl/parallel/hooks.py:593-664) and optionally reports
to the PAI platform (epl/utils/metric.py).  Here metrics are plain dicts
with two sinks sharing one interface (``write(step, metrics)``):

* :class:`MetricsWriter` — JSONL (universally parseable; the default).
* :class:`TensorBoardWriter` — TF event files a stock TensorBoard
  renders (the reference's summary integration, minus the graph-surgery
  re-pointing: metrics handed in are already merged global values from
  parallel/metrics.py).  Backed by tensorboardX when available; an
  optional dependency, gated at construction.

Both are leader-only (process 0: the ``torch.distributed`` rank, 0
without a process group) in multi-process runs, matching the
reference's first-constructor-writes rule (epl/parallel/hooks.py:542),
and both BUFFER raw (possibly CUDA-resident) values: the host sync the
``float()`` conversion forces happens only at flush boundaries, so
``flush_every=N`` keeps the loop's asynchronous launches intact between
flushes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from easyparallellibrary_tpu_torch.utils.device import process_index


def _coerce_metric(v: Any) -> Any:
  """Flush-time coercion of one buffered metric value.

  Scalars (python numbers, 0-d / 1-element tensors or numpy arrays)
  become ``float``.  Multi-element arrays fail ``float()`` — those get a
  compact ``{shape, dtype, mean}`` summary instead of a multi-kilobyte
  ``str()`` repr dumped into the JSONL (a [1024, 1024] grad-norm debug
  tensor is one line of metadata, not a megabyte of digits); a torch
  tensor is moved to the host here, at the flush, never inside a step.
  Anything else (strings, arbitrary objects) still falls back to
  ``str``.
  """
  try:
    return float(v)
  except (TypeError, ValueError):
    pass
  if getattr(v, "shape", None) is not None and \
      getattr(v, "dtype", None) is not None:
    try:
      host = _to_host(v)
      mean = float(np.mean(host.astype(np.float64))) \
          if host.size else None
    except (TypeError, ValueError):  # non-numeric dtype
      mean = None
    return {"shape": [int(d) for d in v.shape], "dtype": str(v.dtype),
            "mean": mean}
  return str(v)


def _to_host(v: Any) -> np.ndarray:
  """A numpy copy of an array-like: torch tensors go through
  ``detach().cpu()`` (and bf16, which numpy has no type for, through
  fp32)."""
  if type(v).__module__.startswith("torch"):
    v = v.detach().cpu()
    if str(v.dtype) == "torch.bfloat16":
      v = v.float()
    return v.numpy()
  return np.asarray(v)


class _LeaderSink:
  """Shared sink core: leader gating, buffering, flush cadence, and
  numeric-vs-text coercion.  Subclasses implement `_emit(step, wall_time,
  record)` plus IO flush/close."""

  def __init__(self, flush_every: int = 1):
    self.flush_every = max(1, flush_every)
    self._buf: List[Tuple[int, float, Dict[str, Any]]] = []
    self._active = process_index() == 0

  def write(self, step: int, metrics: Dict[str, Any]):
    if not self._active:
      return
    # Raw values (device arrays included) are buffered; conversion —
    # and the device sync it forces — waits for the flush boundary.
    self._buf.append((int(step), time.time(), dict(metrics)))
    if len(self._buf) >= self.flush_every:
      self.flush()

  def flush(self):
    if not self._active:
      return
    for step, wall, metrics in self._buf:
      record = {k: _coerce_metric(v) for k, v in metrics.items()}
      self._emit(step, wall, record)
    self._buf = []
    self._flush_io()

  def close(self):
    if self._active:
      self.flush()
      self._close_io()
      self._active = False

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

  # -- subclass hooks --
  def _emit(self, step: int, wall_time: float, record: Dict[str, Any]):
    raise NotImplementedError

  def _flush_io(self):
    pass

  def _close_io(self):
    pass


class MetricsWriter(_LeaderSink):
  """JSONL sink: one {"step", "time", **metrics} object per line."""

  def __init__(self, path: str, flush_every: int = 1):
    super().__init__(flush_every)
    self.path = path
    self._file = None
    if self._active:
      os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
      self._file = open(path, "a")

  def _emit(self, step, wall_time, record):
    self._file.write(json.dumps({"step": step, "time": wall_time,
                                 **record}) + "\n")

  def _flush_io(self):
    if self._file is not None:
      self._file.flush()

  def _close_io(self):
    if self._file is not None:
      self._file.close()
      self._file = None


class TensorBoardWriter(_LeaderSink):
  """TensorBoard event-file sink (same interface as MetricsWriter).

  Numeric metrics become scalar summaries; non-numeric values become
  text summaries.  Requires ``tensorboardX`` (an optional dependency;
  raises with guidance when absent so a configured sink never silently
  drops metrics).
  """

  def __init__(self, logdir: str, flush_every: int = 1):
    super().__init__(flush_every)
    self.logdir = logdir
    self._writer = None
    if self._active:
      try:
        from tensorboardX import SummaryWriter
      except ImportError as e:
        raise ImportError(
            "TensorBoardWriter needs the optional tensorboardX package; "
            "pip install tensorboardX, or use the JSONL MetricsWriter"
        ) from e
      os.makedirs(logdir, exist_ok=True)
      self._writer = SummaryWriter(logdir=logdir)

  def _emit(self, step, wall_time, record):
    for k, v in record.items():
      if isinstance(v, float):
        self._writer.add_scalar(k, v, step, walltime=wall_time)
      else:
        self._writer.add_text(k, str(v), step, walltime=wall_time)

  def _flush_io(self):
    if self._writer is not None:
      self._writer.flush()

  def _close_io(self):
    if self._writer is not None:
      self._writer.close()
      self._writer = None
