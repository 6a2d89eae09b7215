"""FLOP formulas of the port's kernels, for the cost count of
``profiler.flops.compiled_cost``.

The count runs a function under ``torch.utils.flop_counter.
FlopCounterMode`` and a dispatch mode that sums each op's operand and
result bytes.  A kernel launched through ctypes is invisible to both,
and a plain version's inner products are visible only on the CPU, so
without this module a step would count differently on the CPU and on
the card.  Every kernel entry therefore counts by formula, the same on
both devices, and the count never looks inside it:

* the custom ops (``epl_torch::flash_attention_fwd``,
  ``epl_torch::ring_flash_fwd``) are single ops to the modes; their
  formulas are registered with ``register_flop_formula``;
* the dispatchers called in the backward or by the serving step
  (``flash_bwd_dq``, ``flash_bwd_dkv``, ``paged_attention``) go through
  :func:`kernel_call`, which, while a count is open, runs the
  implementation with the dispatch modes off and books its formula and
  its operand and result bytes with the count.

The formulas count full products, two FLOPs a multiply-add, as the JAX
package's ``gpt_flops_per_token`` does: the forward ``4 B H S Skv D``
(QK^T and PV), dQ ``4 B H S Skv D`` (dO V^T and dS K), dK/dV ``4 B H S
Skv D`` (P^T dO and dS^T Q): the backward twice the forward.  A causal
mask halves no count, and no recompute inside a kernel is counted.
Paged attention counts ``4 T H L hd`` over the whole table width ``L``
that its plain version multiplies.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

# The open counts (profiler.flops._Count), innermost last.
_ACTIVE: List[Any] = []


def attention_flops(q_shape, k_shape) -> int:
  """``4 B H S Skv D``: QK^T and PV (or either backward kernel's two
  products) over kernel-layout shapes ``[B, H, S, D]``."""
  B, H, S, D = q_shape
  return 4 * B * H * S * k_shape[2] * D


def paged_flops(q_shape, tables_shape, block_size: int) -> int:
  """``4 T H L hd`` with ``L`` the table width times the block size."""
  T, H, hd = q_shape
  return 4 * T * H * tables_shape[1] * block_size * hd


def _nbytes(tree) -> int:
  if isinstance(tree, torch.Tensor):
    return tree.numel() * tree.element_size()
  if isinstance(tree, (tuple, list)):
    return sum(_nbytes(x) for x in tree)
  return 0


def kernel_call(name: str, flops: int, impl: Callable, *args):
  """``impl(*args)``; while a cost count is open, run with the dispatch
  modes off and book ``flops`` and the operand and result bytes under
  ``name``."""
  if not _ACTIVE:
    return impl(*args)
  from torch.utils._python_dispatch import _disable_current_modes
  with _disable_current_modes():
    out = impl(*args)
  for count in _ACTIVE:
    count.add_kernel(name, flops, _nbytes(args), _nbytes(out))
  return out
