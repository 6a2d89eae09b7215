"""One site for the "not ported yet" errors of the PyTorch package.

Every feature of the JAX package that the port has not reached raises
:class:`NotImplementedError` through :func:`not_ported`, naming the
ROADMAP.md Queue 1 item that will bring it, in the style of
``serving/_capabilities.py``.  Item 10's pipeline half is ported; what
still raises under its title is MoE, sequence parallelism and ZeRO under
the pipeline (slice 13).
"""

from __future__ import annotations

PARALLEL_STRATEGIES = "Pipeline, MoE and sequence parallelism"
OTHER_MODELS = "Other models and the tooling"


def not_ported(feature: str, item: str) -> NotImplementedError:
  slice_ = " (slice 13)" if item == PARALLEL_STRATEGIES else ""
  return NotImplementedError(
      f"{feature} is not ported to easyparallellibrary_tpu_torch yet: "
      f"ROADMAP.md Queue 1, '{item}'{slice_}")
