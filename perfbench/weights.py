"""Seeded weights, made on the device in one draw.

The whole parameter set is one float32 buffer filled by a single
``normal_`` from the seed's weight stream; each leaf is a view of it,
scaled or overwritten by its rule.  The same seed and the same leaves
give the same bits, so the reference redraws them after the window
instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch

from perfbench import traffic

Rule = Callable[[str, Tuple[int, ...]], Tuple[str, float]]


def transformer_rule(embeddings: Sequence[str], std: float) -> Rule:
  """Initialisers of the port's transformer families: ``normal(std)``
  for the named embedding tables, ones for a norm's weight, zeros for a
  bias, and ``normal(1 / sqrt(fan_in))`` for a Dense weight ``[out,
  in]`` (lecun normal without truncation)."""

  def rule(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    owner = name.rsplit(".", 2)[-2] if "." in name else name
    if name in embeddings:
      return "normal", std
    if name.endswith(".bias"):
      return "const", 0.0
    if owner.startswith("ln"):
      return "const", 1.0
    return "normal", 1.0 / math.sqrt(shape[-1])

  return rule


def make(shapes: Dict[str, Tuple[int, ...]], rule: Rule, seed: int,
         device) -> Dict[str, torch.Tensor]:
  """Float32 leaves of ``shapes`` (name -> shape, in order) on
  ``device``, drawn from ``seed``."""
  total = sum(math.prod(s) for s in shapes.values())
  flat = torch.empty(total, dtype=torch.float32, device=device)
  flat.normal_(generator=traffic.generator(seed, traffic.WEIGHTS, device))
  out, at = {}, 0
  for name, shape in shapes.items():
    n = math.prod(shape)
    leaf = flat[at:at + n].view(shape)
    at += n
    kind, value = rule(name, tuple(shape))
    if kind == "normal":
      leaf.mul_(value)
    else:
      leaf.fill_(value)
    out[name] = leaf
  return out
