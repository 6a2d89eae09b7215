"""Strategy scope base class.

Analog of the reference's ``ParallelStrategy`` context-manager
(epl/strategies/parallel_strategy.py:28): entering pushes the strategy onto
the process-global :class:`StrategyContext`; the *defining call site* is the
scope's identity so that re-entering the same ``with`` statement (e.g. a
layer loop calling the model twice, or a module applied once per microbatch
under trace) reuses the same taskgraph rather than minting a new stage
(reference ``_get_stack`` :48-57).
"""

from __future__ import annotations

import traceback
from typing import Optional

from easyparallellibrary_tpu_torch.env import Env


class ParallelStrategy:
  """Context manager recording a parallelism annotation."""

  # Subclasses set this ("replicate" / "split").
  kind = "base"

  def __init__(self, device_count: Optional[int] = None, name: str = ""):
    if device_count is not None and device_count < 1:
      raise ValueError(f"device_count must be >= 1, got {device_count}")
    self.device_count = device_count
    self.name = name
    self.identity = self._call_site_identity()
    # Assigned by StrategyContext when first entered.
    self.index: Optional[int] = None
    self.taskgraph = None

  def _call_site_identity(self) -> str:
    """Identity = the source location of the defining `with` statement.

    Plays the role of the reference's call-stack-hash identity
    (epl/strategies/parallel_strategy.py:48-57) with one deliberate
    difference: only the innermost *user* frame is used, not the whole
    stack.  JAX traces the model function several times from different
    outer call paths (eval_shape for shapes, jit for init, jit for the
    train step), so a full-stack identity would mint a fresh pipeline
    stage per trace; the `with` line itself is stable across traces while
    still distinguishing sibling scopes and collapsing loop re-entries.
    """
    # Framework internals are skipped; easyparallellibrary_tpu_torch/models
    # is deliberately NOT skipped — bundled models open scopes and those
    # `with` lines are their identity.
    skip_markers = ("easyparallellibrary_tpu_torch/strategies",
                    "easyparallellibrary_tpu_torch/parallel",
                    "easyparallellibrary_tpu_torch/ir",
                    "easyparallellibrary_tpu_torch/ops",
                    "easyparallellibrary_tpu_torch/runtime",
                    "easyparallellibrary_tpu_torch/__init__",
                    "easyparallellibrary_tpu_torch/env",
                    "site-packages", "dist-packages", "<frozen",
                    "importlib", "/lib/python")
    last_user = None
    for frame in traceback.extract_stack():
      fname = frame.filename or ""
      if any(m in fname for m in skip_markers):
        continue
      last_user = f"{fname}:{frame.lineno}"
    site = last_user or "unknown"
    return f"{site}|{self.kind}|{self.name}|{self.device_count}"

  def __enter__(self):
    # add_context returns the canonical strategy for this call site, which
    # may be an earlier instance when the scope is re-entered — the `as`
    # binding must see the one that owns the taskgraph.
    return Env.get().strategy_context.add_context(self)

  def __exit__(self, exc_type, exc_value, tb):
    Env.get().strategy_context.remove_context(self)
    return False

  def __repr__(self):
    return (f"{type(self).__name__}(device_count={self.device_count}, "
            f"name={self.name!r}, index={self.index})")
