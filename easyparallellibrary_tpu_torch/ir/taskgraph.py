"""Taskgraph — one strategy scope = one pipeline-stage unit.

Analog of the reference's ``Taskgraph`` (epl/ir/taskgraph.py:107).  The
reference taskgraph owns cloned TF ops per (phase, replica, micro-batch)
and computes entrance/exit op sets for the control-dep scheduler
(:155-400).  In the TPU-native design none of that graph surgery exists:
a taskgraph is a *plan node* — which strategy governs it, which mesh
devices back it, and which parameters (by pytree path prefix) belong to
it.  Stage boundaries are explicit in the model structure, so the ~250
lines of entrance/exit special-casing disappear (SURVEY §7 hard parts).
"""

from __future__ import annotations

from typing import List, Optional


class Taskgraph:
  def __init__(self, index: int, strategy):
    self.index = index
    self.strategy = strategy
    # Pytree path prefixes of parameters declared under this scope.
    self.param_prefixes: List[str] = []

  @property
  def kind(self) -> str:
    return self.strategy.kind

  @property
  def num_device_per_replica(self) -> int:
    """Reference: epl/ir/taskgraph.py:458-463 (from strategy.device_count)."""
    return self.strategy.device_count or 1

  def add_param_prefix(self, prefix: str):
    if prefix not in self.param_prefixes:
      self.param_prefixes.append(prefix)

  def __repr__(self):
    return (f"Taskgraph(index={self.index}, kind={self.kind!r}, "
            f"devices/replica={self.num_device_per_replica})")
