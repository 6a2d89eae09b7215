"""Hand-written CUDA kernels of the PyTorch port, each beside its plain
PyTorch version.  Built at first use (``_build``), never at import.

The exports are the JAX package's: ``flash_attention``,
``paged_attention``, ``paged_attention_reference`` and
``set_paged_attention_impl``.  The first two share their names with the
submodules that hold them, which the port's code imports as modules
(``from ...kernels import flash_attention as fa``; ``fa.reset_counts()``),
so each of those two submodules is made callable as its entry function:
``kernels.flash_attention(q, k, v, causal=False)`` runs the flash
attention op, and ``kernels.flash_attention.flash_fwd`` is still the
module's."""

import types

from easyparallellibrary_tpu_torch.kernels import flash_attention as _flash
from easyparallellibrary_tpu_torch.kernels import paged_attention as _paged
from easyparallellibrary_tpu_torch.kernels.paged_attention import (
    paged_attention_reference, set_paged_attention_impl)


class _EntryModule(types.ModuleType):
  """A module called as the function of its own name."""

  def __call__(self, *args, **kwargs):
    return getattr(self, self.__name__.rsplit(".", 1)[1])(*args, **kwargs)


for _module in (_flash, _paged):
  _module.__class__ = _EntryModule
flash_attention = _flash
paged_attention = _paged

__all__ = ["flash_attention", "paged_attention",
           "paged_attention_reference", "set_paged_attention_impl"]
