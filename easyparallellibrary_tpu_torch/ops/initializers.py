"""Glorot initializers over the full layer's fans (port of
``easyparallellibrary_tpu/ops/initializers.py``).

The reference needs them because each tensor-parallel shard is a smaller
variable of its own, whose shape would give the shard's fans instead of
the whole layer's.  The port's ranks hold shards too
(``ops/layers.py``), so a shard drawn on its rank passes the whole
layer's ``full_fan_in`` / ``full_fan_out``.  Without them the fans come
from the shape, as in the JAX helpers: fan-in ``prod(shape[:-1])`` (a
1-d shape: ``shape[0]``), fan-out ``shape[-1]``.

Each returned ``init(generator, shape, dtype=torch.float32, device=None)``
draws from an explicit ``torch.Generator`` (the JAX helpers take a PRNG
key); the values differ from JAX's, the distribution is the same.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _fans(shape: Sequence[int], full_fan_in: int, full_fan_out: int):
  shape = tuple(int(s) for s in shape)
  fan_in = full_fan_in or (math.prod(shape[:-1]) if len(shape) > 1
                           else shape[0])
  fan_out = full_fan_out or shape[-1]
  return fan_in, fan_out


def glorot_uniform_full_fan(full_fan_in: int = 0, full_fan_out: int = 0):
  """Glorot uniform on ``[-limit, limit]``, ``limit = sqrt(6 / (fan_in
  + fan_out))``, with the given full fans (0: from the shape)."""

  def init(generator: torch.Generator, shape, dtype=torch.float32,
           device=None):
    fan_in, fan_out = _fans(shape, full_fan_in, full_fan_out)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    out.uniform_(-limit, limit, generator=generator)
    return out.to(dtype)

  return init


def glorot_normal_full_fan(full_fan_in: int = 0, full_fan_out: int = 0):
  """Glorot normal, standard deviation ``sqrt(2 / (fan_in + fan_out))``,
  with the given full fans (0: from the shape)."""

  def init(generator: torch.Generator, shape, dtype=torch.float32,
           device=None):
    fan_in, fan_out = _fans(shape, full_fan_in, full_fan_out)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    out.normal_(0.0, std, generator=generator)
    return out.to(dtype)

  return init
