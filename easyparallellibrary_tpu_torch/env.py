"""Process-global environment singleton (port of ``easyparallellibrary_tpu/env.py``).

Owns the active :class:`Config`, the :class:`Cluster` (``epl.init``), the
strategy context recorded by ``replicate``/``split`` scopes, and the
metric-merge collections.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from easyparallellibrary_tpu_torch.config import Config


class Env:
  """Singleton context for one program."""

  _instance: Optional["Env"] = None

  def __init__(self):
    self.config: Config = Config()
    self.cluster = None            # set by epl.init()
    self.strategy_context = None   # set by init/reset
    self.collections: Dict[str, List[Any]] = {}
    self.parallel_information: Dict[str, Any] = {}
    self._reset_strategy_context()

  def _reset_strategy_context(self):
    # Imported lazily to avoid an import cycle (strategies import Env).
    from easyparallellibrary_tpu_torch.strategies.context import (
        StrategyContext)
    self.strategy_context = StrategyContext()

  @classmethod
  def get(cls) -> "Env":
    if cls._instance is None:
      cls._instance = Env()
    return cls._instance

  def reset(self, config: Optional[Config] = None):
    """Drop all recorded state."""
    self.config = config if config is not None else Config()
    self.cluster = None
    self.collections = {}
    self.parallel_information = {}
    self._reset_strategy_context()

  def init(self, config: Optional[Config] = None):
    self.reset(config)
    return self

  def add_to_collection(self, value, key: str):
    self.collections.setdefault(key, []).append(value)

  def get_collection(self, key: str) -> List[Any]:
    return list(self.collections.get(key, []))
