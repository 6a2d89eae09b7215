"""One site for the "not ported yet" errors of the PyTorch package.

Every feature of the JAX package that the port has not reached raises
:class:`NotImplementedError` through :func:`not_ported`, naming the
ROADMAP.md Queue 1 item that will bring it, in the style of
``serving/_capabilities.py``.
"""

from __future__ import annotations

FLEET = "Router, fleet and request migration"
TENSOR_PARALLEL = "Tensor-parallel mesh"
TRACING = "Tracing and metric registry"
PARALLEL_STRATEGIES = "Pipeline, MoE and sequence parallelism"
RUNTIME = "Runtime around the step"


def not_ported(feature: str, item: str) -> NotImplementedError:
  return NotImplementedError(
      f"{feature} is not ported to easyparallellibrary_tpu_torch yet: "
      f"ROADMAP.md Queue 1, '{item}'")
