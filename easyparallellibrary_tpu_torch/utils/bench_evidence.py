"""Reader of the repo's benchmark evidence log, ``BENCH_EVIDENCE.json``
(the port's copy of the reading half of
``easyparallellibrary_tpu/utils/bench_evidence.py``).

Each record is one measurement with its context (``metric``,
``device_kind``, ``provenance``: ``"hardware"``, or ``"sim"`` for a
number the simulator produced).  The simulator's cost model reads it
(sim/replica.py); the port writes no record.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "BENCH_EVIDENCE.json")


def evidence_path() -> str:
  return os.environ.get("EPL_BENCH_EVIDENCE", _DEFAULT_PATH)


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
