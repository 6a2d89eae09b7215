"""`split` — the tensor/expert-parallel primitive.

Analog of the reference's ``Split``/``split()``
(epl/strategies/split.py:24,49): layers applied inside a ``split`` scope
shard their weights (and, for MoE, their experts) across ``device_count``
devices — the mesh's ``model`` axis here.  The reference swaps op
implementations via hooks (epl/parallel/hooks.py:710-828); in this
framework the distributed layers in :mod:`easyparallellibrary_tpu_torch.ops`
consult the ambient scope at trace time and apply GSPMD shardings +
collectives themselves — no monkey-patching.

``is_nested`` parity (epl/strategies/split.py:36-46): a split scope opened
while another split is active marks itself nested and does not re-shard.
"""

from __future__ import annotations

from typing import Optional

from easyparallellibrary_tpu_torch.strategies.base import ParallelStrategy


class Split(ParallelStrategy):
  kind = "split"

  def __init__(self, device_count: Optional[int] = None, name: str = ""):
    super().__init__(device_count=device_count, name=name)
    self.is_nested = False


def split(device_count: Optional[int] = None, name: str = "") -> Split:
  """Open a tensor-parallel scope over `device_count` devices
  (None = whole model axis)."""
  return Split(device_count=device_count, name=name)
