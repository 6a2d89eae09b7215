"""Pipeline schedule policies (port of
``easyparallellibrary_tpu/strategies/scheduler.py``).

The reference encodes a schedule as control edges between per-(stage,
micro-batch) op sets; the JAX package selects between two programs.
The port selects between action tables of its one per-rank executor
(``parallel/pipeline.py``):

* ``PreferForward``: GPipe, every micro-batch's forward before the
  backwards; all M micro-batches' activations live at the turn;
* ``PreferBackward``: 1F1B, each stage's backward of micro-batch k
  before its forward of k + S, with the stage recomputed in the
  backward (the reference frees and recomputes), so a stage holds at
  most ``min(M, 2S - 1)`` stage inputs; with ``pipeline_interleave``
  K > 1 the interleaved 1F1B table of ``parallel/pipeline_interleaved``;
* ``PreferBackwardOptimizer``: PreferBackward with the grouped optimizer
  apply (``runtime/optimizer_helper.py``).
"""

from __future__ import annotations

import dataclasses

from easyparallellibrary_tpu_torch import constants


@dataclasses.dataclass(frozen=True)
class Schedule:
  name: str
  remat_stage: bool
  grouped_apply: bool


_SCHEDULES = {
    constants.SCHEDULE_PREFER_FORWARD: Schedule(
        constants.SCHEDULE_PREFER_FORWARD, remat_stage=False,
        grouped_apply=False),
    constants.SCHEDULE_PREFER_BACKWARD: Schedule(
        constants.SCHEDULE_PREFER_BACKWARD, remat_stage=True,
        grouped_apply=False),
    constants.SCHEDULE_PREFER_BACKWARD_OPT: Schedule(
        constants.SCHEDULE_PREFER_BACKWARD_OPT, remat_stage=True,
        grouped_apply=True),
}


def get_scheduler(name: str) -> Schedule:
  """The schedule policy of ``name`` (``pipeline.strategy``)."""
  if name not in _SCHEDULES:
    raise ValueError(f"Unknown pipeline schedule {name!r}; "
                     f"one of {sorted(_SCHEDULES)}")
  return _SCHEDULES[name]
