"""Metric merging (port of ``easyparallellibrary_tpu/parallel/metrics.py``).

Users register values under the ``GraphKeys`` merge collections
(``epl.add_to_collection``) and the train step folds them into its
metrics: MEAN keys average the value, SUM keys sum it, CONCAT keys keep
it (on one device the local value is the global one).  The
collective merge inside explicit ``shard_map`` regions waits with the
multi-device mesh (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from easyparallellibrary_tpu_torch.constants import GraphKeys
from easyparallellibrary_tpu_torch.env import Env


def _merge_one(key: str, value):
  if key in (GraphKeys.GLOBAL_MEAN_OBJECTS, GraphKeys.LOCAL_MEAN_OBJECTS):
    return torch.as_tensor(value).float().mean()
  if key in (GraphKeys.GLOBAL_SUM_OBJECTS, GraphKeys.LOCAL_SUM_OBJECTS):
    return torch.as_tensor(value).sum()
  return value  # concat keys: already the global concatenation


def collect_merged(clear: bool = True) -> Dict[str, Any]:
  """Merge every registered collection value into a metrics dict keyed
  ``<collection>_<i>``; call after the model ran."""
  env = Env.get()
  out: Dict[str, Any] = {}
  for key in GraphKeys.ALL_MERGE_KEYS:
    values = env.collections.get(key, [])
    for i, v in enumerate(values):
      out[f"{key}_{i}"] = _merge_one(key, v)
    if clear and key in env.collections:
      env.collections[key] = []
  return out
