"""Process-global stack of active strategy scopes.

Analog of the reference's ``StrategyContext``
(epl/strategies/strategy_context.py:26): tracks the stack of entered
scopes, enforces the nesting rules (:34-54), assigns strategy indices
(:81-88), creates one :class:`Taskgraph` per distinct scope call site, and
manages the default strategy (:137-152).
"""

from __future__ import annotations

from typing import List, Optional

from easyparallellibrary_tpu_torch.ir.taskgraph import Taskgraph


class StrategyContext:
  def __init__(self):
    self.stack: List = []           # currently-entered scopes
    self.taskgraphs: List[Taskgraph] = []
    self.default_strategy = None
    self._identity_map = {}         # call-site identity -> strategy

  # -- scope entry/exit ----------------------------------------------------

  def add_context(self, strategy):
    self._check_nesting(strategy)
    if getattr(strategy, "is_nested", False):
      # Nested splits do not open a new taskgraph (reference: nested split
      # does not re-apply op replacement, epl/strategies/split.py:36-46).
      self.stack.append(strategy)
      return strategy
    canonical = self._canonicalize(strategy)
    self.stack.append(canonical)
    return canonical

  def remove_context(self, strategy):
    if not self.stack:
      raise RuntimeError("Strategy scope exited but context stack is empty")
    top = self.stack.pop()
    if top.identity != strategy.identity:
      raise RuntimeError(
          f"Strategy scopes exited out of order: popped {top}, "
          f"expected {strategy}")

  def _check_nesting(self, strategy):
    """Nesting rules (reference epl/strategies/strategy_context.py:34-54)."""
    if not self.stack:
      return
    outer = self.stack[-1]
    if outer.kind == "split":
      if strategy.kind == "split":
        # A re-entrant split is tolerated and marked nested so it does not
        # re-shard (reference epl/strategies/split.py:36-46).
        strategy.is_nested = True
        return
      raise ValueError("Nesting any strategy scope inside a 'split' scope "
                       "is not allowed")
    if outer.kind == strategy.kind:
      raise ValueError(
          f"Nesting a '{strategy.kind}' scope inside another "
          f"'{outer.kind}' scope is not allowed")
    if outer.kind == "replicate" and strategy.kind == "split":
      raise ValueError(
          "Nesting 'split' inside 'replicate' is not allowed; make them "
          "sibling scopes and set config cluster.colocate_split_and_replicate")

  def _canonicalize(self, strategy):
    """Reuse the strategy (and its taskgraph) for a repeated call site.

    Re-entering the same ``with`` statement — a loop over layers, or the
    model function traced again — must not mint a new pipeline stage
    (reference identity hash, epl/strategies/parallel_strategy.py:48-57).
    """
    existing = self._identity_map.get(strategy.identity)
    if existing is not None:
      return existing
    strategy.index = len(self.taskgraphs)
    tg = Taskgraph(index=strategy.index, strategy=strategy)
    strategy.taskgraph = tg
    self.taskgraphs.append(tg)
    self._identity_map[strategy.identity] = strategy
    return strategy

  # -- queries -------------------------------------------------------------

  @property
  def current(self):
    """Innermost active scope, or the default strategy."""
    if self.stack:
      return self.stack[-1]
    return self.default_strategy

  @property
  def identity(self) -> str:
    return "|".join(s.identity for s in self.stack)

  def set_default(self, strategy):
    """Reference: epl.set_default_strategy (epl/__init__.py:53-55)."""
    self.default_strategy = self._canonicalize(strategy) \
        if strategy is not None else None

  def reset(self):
    self.stack = []
    self.taskgraphs = []
    self.default_strategy = None
    self._identity_map = {}
