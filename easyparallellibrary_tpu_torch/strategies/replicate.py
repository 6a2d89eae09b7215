"""`replicate` — the data-parallel / pipeline-stage primitive.

Analog of the reference's ``Replicate``/``replicate()``
(epl/strategies/replicate.py:24,39): code (model construction or
application) inside a ``replicate`` scope is data-parallel over the mesh's
``data`` axis; *consecutive distinct* ``replicate`` scopes become pipeline
stages (taskgraphs), exactly as in the reference where each new scope call
site starts a new taskgraph.

On TPU, "replication" means: batch sharded on the data axis, params
replicated across it (unless ZeRO shards optimizer state), gradient
all-reduce inserted automatically by GSPMD.
"""

from __future__ import annotations

from typing import Optional

from easyparallellibrary_tpu_torch.strategies.base import ParallelStrategy


class Replicate(ParallelStrategy):
  kind = "replicate"

  def __init__(self, device_count: Optional[int] = None, name: str = ""):
    super().__init__(device_count=1 if device_count is None else device_count,
                     name=name)


def replicate(device_count: Optional[int] = None, name: str = "") -> Replicate:
  """Open a data-parallel scope.

  ``device_count`` is the number of devices each model replica of this
  stage spans (reference semantics); with pipeline, the per-stage device
  count feeds the auto layout (replicas = total / Σ stage device_count,
  epl/cluster.py:150-159).
  """
  return Replicate(device_count=device_count, name=name)
