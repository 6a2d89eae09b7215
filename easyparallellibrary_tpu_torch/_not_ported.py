"""One site for the "not ported yet" errors of the PyTorch package.

Every feature of the JAX package that the port has not reached raises
:class:`NotImplementedError` through :func:`not_ported`, naming the
ROADMAP.md Queue 1 item that will bring it, in the style of
``serving/_capabilities.py``.  Item 10 (pipeline, MoE and sequence
parallelism) and item 12's models (BERT, ResNet, ``MutableTrainState``)
are ported; what still raises is item 12's tooling (``profile_step``,
the memory and cost profilers, the perf gate, ``analysis/``), and names
item 12.
"""

from __future__ import annotations

OTHER_MODELS = "Other models and the tooling"


def not_ported(feature: str, item: str) -> NotImplementedError:
  return NotImplementedError(
      f"{feature} is not ported to easyparallellibrary_tpu_torch yet: "
      f"ROADMAP.md Queue 1, '{item}'")
