"""Process-global environment singleton (port of ``easyparallellibrary_tpu/env.py``).

Owns the active :class:`Config` and the metric-merge collections.  The
JAX package's Env also carries the device mesh and the strategy context
of ``replicate``/``split`` scopes; neither is part of the ported serving
slice, so both stay ``None`` here (ROADMAP.md Queue 1, "Runtime and
parallel strategies").
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from easyparallellibrary_tpu_torch.config import Config


class Env:
  """Singleton context for one program."""

  _instance: Optional["Env"] = None

  def __init__(self):
    self.config: Config = Config()
    self.cluster = None
    self.strategy_context = None
    self.collections: Dict[str, List[Any]] = {}
    self.parallel_information: Dict[str, Any] = {}

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

  def init(self, config: Optional[Config] = None):
    self.reset(config)
    return self

  def add_to_collection(self, value, key: str):
    self.collections.setdefault(key, []).append(value)

  def get_collection(self, key: str) -> List[Any]:
    return list(self.collections.get(key, []))
