"""The repo's benchmark evidence log, ``BENCH_EVIDENCE.json`` (port of
``easyparallellibrary_tpu/utils/bench_evidence.py``, the same record
schema and file layout).

Each record is one measurement with its context (``metric``,
``device_kind``, ``provenance``: ``"hardware"``, or ``"sim"`` for a
number the simulator produced).  :func:`append_record` is the one door
a writer goes through: it validates the record against the schema
(:func:`validate_record`) and writes atomically, so the perf gate
(``observability/perfgate.py``), which refuses malformed records, never
meets one this process wrote.  A port record names its card through
:func:`run_context`: ``run_context(device_kind=torch.cuda.
get_device_name(), power_limit=...)``.  ``EPL_BENCH_EVIDENCE`` points
the log elsewhere (tests and ``chip_smoke.py`` write a temporary file,
never the repo's).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "BENCH_EVIDENCE.json")


def evidence_path() -> str:
  return os.environ.get("EPL_BENCH_EVIDENCE", _DEFAULT_PATH)


def run_context(sim: bool = False, **extra: Any) -> Dict[str, Any]:
  """The context block every evidence writer stamps: ``host_cores``
  and ``provenance`` (``"sim"`` for numbers of the cost-card simulator,
  ``"hardware"`` for measured ones; :func:`append_record` back-fills
  both for a writer that did not stamp them).  ``extra`` keys ride
  along (``device_kind=...``, ``power_limit=...``)."""
  ctx: Dict[str, Any] = {"host_cores": os.cpu_count() or 1,
                         "provenance": "sim" if sim else "hardware"}
  ctx.update(extra)
  return ctx


def load_records(path: Optional[str] = None) -> List[Dict[str, Any]]:
  """Every record of the log at ``path`` (default: the repo's), or []
  when it is missing or does not parse."""
  path = path or evidence_path()
  try:
    with open(path) as f:
      data = json.load(f)
  except (OSError, ValueError):
    return []
  return data.get("records", []) if isinstance(data, dict) else []


def _preserve_corrupt(path: str) -> None:
  """If ``path`` exists but does not parse, move it aside instead of
  letting a fresh write erase earlier (possibly recoverable) evidence."""
  if not os.path.exists(path):
    return
  try:
    with open(path) as f:
      json.load(f)
  except ValueError:
    os.replace(path, f"{path}.corrupt-{int(time.time())}")
  except OSError:
    pass


def append_record(record: Dict[str, Any],
                  path: Optional[str] = None) -> Dict[str, Any]:
  """Validate ``record`` (:func:`validate_record`), stamp its time and
  the context defaults, and append it with an atomic rename, so a crash
  mid-write cannot corrupt earlier evidence.  Raises ``ValueError``
  listing every schema error.  Returns the record as written."""
  path = path or evidence_path()
  _preserve_corrupt(path)
  records = load_records(path)
  record = dict(record)
  record.setdefault("unix_time", time.time())
  record.setdefault("utc", time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()))
  for key, val in run_context().items():
    record.setdefault(key, val)
  errors = validate_record(record)
  if errors:
    raise ValueError(
        f"malformed BENCH_EVIDENCE record for "
        f"{record.get('metric')!r}: " + "; ".join(errors)
        + " (schema: utils/bench_evidence.py validate_record)")
  records.append(record)
  tmp = path + ".tmp"
  with open(tmp, "w") as f:
    json.dump({"records": records}, f, indent=1)
  os.replace(tmp, path)
  return record


def latest_record(metric: str,
                  path: Optional[str] = None) -> Optional[Dict[str, Any]]:
  """Most recent record for ``metric`` (highest ``unix_time`` wins)."""
  matches = [r for r in load_records(path) if r.get("metric") == metric]
  if not matches:
    return None
  return max(matches, key=lambda r: r.get("unix_time", 0))


# --------------------------------------------------------- record schema

# Keys with fixed meaning; everything else in a record is metrics
# payload: name (``metric``), ts (``unix_time`` + ``utc``), context
# (``config`` + the backend tags) and metrics (a numeric ``value`` and/or
# payload keys).
_NAME_KEY = "metric"
_TS_KEYS = ("unix_time", "utc")
_CONTEXT_KEYS = ("config", "backend", "device", "device_kind",
                 "host_cores", "provenance")
_HEADLINE_KEYS = ("value", "unit")


def validate_record(rec: Any) -> List[str]:
  """Schema errors for one evidence record ([] = valid).

  Required: a non-empty string ``metric``, a numeric ``unix_time``, and
  a metrics payload — a numeric ``value`` or at least one key beyond
  the name / ts / context / headline sets.  ``config``, when present,
  must be an object; ``value``, when present, numeric or null (null is
  the honest "measurement unavailable")."""
  if not isinstance(rec, dict):
    return ["record is not a JSON object"]
  errs: List[str] = []
  name = rec.get(_NAME_KEY)
  if not isinstance(name, str) or not name:
    errs.append("missing/invalid 'metric' (the record's name)")
  ts = rec.get("unix_time")
  if not isinstance(ts, (int, float)) or isinstance(ts, bool):
    errs.append("missing/invalid 'unix_time' (the record's ts)")
  ctx = rec.get("config")
  if ctx is not None and not isinstance(ctx, dict):
    errs.append("'config' (the record's context) must be an object")
  value = rec.get("value")
  if value is not None and (isinstance(value, bool)
                            or not isinstance(value, (int, float))):
    errs.append("'value' must be numeric or null")
  reserved = set((_NAME_KEY,) + _TS_KEYS + _CONTEXT_KEYS + _HEADLINE_KEYS)
  has_payload = (isinstance(value, (int, float))
                 and not isinstance(value, bool)) or any(
      k not in reserved for k in rec)
  if not has_payload:
    errs.append("no metrics payload: need a numeric 'value' or at "
                "least one payload key")
  return errs
