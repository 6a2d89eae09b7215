"""Metric merging (port of ``easyparallellibrary_tpu/parallel/metrics.py``).

Users register values under the ``GraphKeys`` merge collections
(``epl.add_to_collection``) and the train step folds them into its
metrics: MEAN keys average the value, SUM keys sum it, CONCAT keys keep
it (on one device the local value is the global one).
:func:`merge_shard_metrics` is the collective merge of per-rank values
over a mesh axis (JAX's inside ``shard_map`` regions).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
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


def merge_shard_metrics(metrics: Dict[str, Any], how: str = "mean",
                        axis_name: str = constants.DATA_AXIS
                        ) -> Dict[str, Any]:
  """Merge per-rank metric values over ``axis_name``: ``mean`` and
  ``sum`` all-reduce, ``concat`` all-gathers along dim 0."""
  if how == "mean":
    f = lambda v: collectives.all_reduce(v, axis_name, op=collectives.MEAN)
  elif how == "sum":
    f = lambda v: collectives.all_reduce(v, axis_name, op=collectives.SUM)
  elif how == "concat":
    f = lambda v: collectives.all_gather(v, axis_name, axis=0)
  else:
    raise ValueError(f"unknown merge method {how!r}")
  return {k: f(torch.as_tensor(v)) for k, v in metrics.items()}
