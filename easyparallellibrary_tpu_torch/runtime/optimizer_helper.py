"""Grouped optimizer apply — bound the peak memory of the weight update
(port of ``easyparallellibrary_tpu/runtime/optimizer_helper.py``).

The parameters are split into ``optimizer.num_apply_group`` contiguous,
byte-balanced groups (``parallel.partitioner.partition_balance``) and
the optimizer steps once per group, serialized: a group's parameters
carry their gradients, every other parameter's ``.grad`` is hidden, so
torch's optimizer skips it.  For a per-parameter optimizer (AdamW) the
result is bit-identical to one step over every parameter; global-norm
optimizers must use one group.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from easyparallellibrary_tpu_torch.parallel.partitioner import (
    partition_balance)
from easyparallellibrary_tpu_torch.utils.pytree import leaf_bytes


def group_leaves(params: Dict[str, torch.Tensor],
                 num_groups: int) -> List[List[str]]:
  """Names of ``params`` in ``num_groups`` contiguous groups balanced by
  bytes (one name per group when there are no more names than groups)."""
  names = list(params)
  if num_groups >= len(names):
    return [[n] for n in names]
  ranges = partition_balance([float(leaf_bytes(params[n])) for n in names],
                             num_groups)
  return [names[s:e] for s, e in ranges]


def apply_grad_group(opt: torch.optim.Optimizer,
                     params: Dict[str, torch.Tensor],
                     num_apply_group: int,
                     found_inf: Optional[torch.Tensor] = None):
  """One optimizer step over ``params`` (their ``.grad``), applied in
  ``num_apply_group`` serialized groups.  ``found_inf`` (a fused
  optimizer's skip flag, a 0-d float32 tensor) rides every group's
  step."""
  if found_inf is not None:
    opt.found_inf = found_inf
  try:
    if num_apply_group <= 1:
      opt.step()
      return
    grads = {n: p.grad for n, p in params.items()}
    for group in group_leaves(params, num_apply_group):
      members = set(group)
      for n, p in params.items():
        p.grad = grads[n] if n in members else None
      opt.step()
    for n, p in params.items():
      p.grad = grads[n]
  finally:
    if found_inf is not None:
      opt.found_inf = None
