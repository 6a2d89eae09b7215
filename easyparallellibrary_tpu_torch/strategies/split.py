"""`split` — the tensor/expert-parallel primitive.

Analog of the reference's ``Split``/``split()``
(epl/strategies/split.py:24,49): layers built inside a ``split`` scope
shard their weights across the mesh's ``model`` axis.  The reference
swaps op implementations via hooks (epl/parallel/hooks.py:710-828); here
``ops.layers.Dense`` and ``ops.layers.Embedding`` with their default
``parallel="auto"`` consult the active scope when they are built (the
port builds layers eagerly; the JAX layers consult it at trace time):
column-parallel and vocab-parallel under a split, and with
``auto.tensor_split`` the scope's auto Dense layers alternate column and
row in the order they are built (:attr:`Split.auto_dense_built`).  The
other modules take explicit modes (GPT's ``tensor_parallel``).

``is_nested`` parity (epl/strategies/split.py:36-46): a split scope opened
while another split is active marks itself nested and does not re-shard:
its layers are split once over ``model``, and continue the outer scope's
column / row count.
"""

from __future__ import annotations

from typing import Optional

from easyparallellibrary_tpu_torch.strategies.base import ParallelStrategy


class Split(ParallelStrategy):
  kind = "split"

  def __init__(self, device_count: Optional[int] = None, name: str = ""):
    super().__init__(device_count=device_count, name=name)
    self.is_nested = False
    # Auto Dense layers built in the current entry of this scope (the
    # column / row alternation of ``auto.tensor_split``).
    self.auto_dense_built = 0

  def __enter__(self):
    scope = super().__enter__()
    if not scope.is_nested:
      scope.auto_dense_built = 0
    return scope


def split(device_count: Optional[int] = None, name: str = "") -> Split:
  """Open a tensor-parallel scope over `device_count` devices
  (None = whole model axis)."""
  return Split(device_count=device_count, name=name)
