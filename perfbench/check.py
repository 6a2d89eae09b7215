"""The comparison that decides ``correct``.

The timed program's first three steps (through the window's own call,
on three different batches) against the float32 reference's three steps
from the same weights and batches.  Three numbers, each against the
cell's limit (``perfbench/workloads/<cell>.json``, ``limits``):

* ``loss_gap``: the largest gap between the two losses of a step;
* ``grad_gap``: over the leaves, the largest gap between the norms of
  the first gradient, the program's taken from AdamW's first moment
  after one step (``m_1 = (1 - b1) g_1``);
* ``change_gap``: over the leaves, the largest gap between the norms of
  the parameters' change over the three steps.

A leaf that the architecture fuses from several tensors (``qkv``: the
query, key and value products, ``GROUPS`` of the family) counts as its
row blocks, one a tensor.  A leaf's norm gap is measured against the
reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's (a key bias under softmax) move under Adam by round-off
alone and are left out of ``change_gap``.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
ROUND_OFF = 1e-3


@dataclasses.dataclass
class Readings:
  """What a training run gives the check: each step's loss, the norm of
  every leaf's first gradient and of its change over the steps."""
  losses: List[float]
  grads: Dict[str, float]
  changes: Dict[str, float]


def part_norms(tensors: Dict[str, torch.Tensor], groups: Dict[str, int]
               ) -> Dict[str, torch.Tensor]:
  """Norms (device scalars) of each leaf, or of each of its row blocks
  where its owner (``block_0.qkv.weight``: ``qkv``) fuses
  ``groups[owner]`` tensors."""
  out = {}
  for name, t in tensors.items():
    owner = name.rsplit(".", 2)[-2] if "." in name else ""
    n = groups.get(owner, 1)
    if n == 1:
      out[name] = t.norm()
      continue
    for i, part in enumerate(t.chunk(n, dim=0)):
      out[f"{name}[{i}/{n}]"] = part.norm()
  return out


def first_gradient_norms(state, groups) -> Dict[str, torch.Tensor]:
  """Each leaf's first gradient as the optimizer got it, from AdamW's
  state after one step: ``exp_avg / (1 - b1)``."""
  opt = state.opt_state
  b1 = opt.param_groups[0]["betas"][0]
  out = {}
  for name, p in state.params.items():
    moment = opt.state.get(p, {}).get("exp_avg")
    first = torch.zeros_like(p) if moment is None else moment / (1 - b1)
    out.update(part_norms({name: first}, groups))
  return out


def change_norms(state, params0, groups) -> Dict[str, torch.Tensor]:
  out = {}
  for name, p in state.params.items():
    out.update(part_norms({name: p.detach() - params0[name]}, groups))
  return out


def to_host(norms: Dict[str, torch.Tensor]) -> Dict[str, float]:
  values = torch.stack([t.float() for t in norms.values()]).tolist()
  return dict(zip(norms, values))


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
  floor = statistics.median(ref[n] for n in leaves)
  return max(abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
             for n in leaves)


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
  """The three numbers of :data:`NUMBERS`."""
  if list(prog.grads) != list(ref.grads):
    raise ValueError("the program's leaves are not the reference's")
  median_grad = statistics.median(ref.grads.values())
  moving = [n for n, g in ref.grads.items() if g >= ROUND_OFF * median_grad]
  return {
      "loss_gap": max(abs(a - b) for a, b in zip(prog.losses, ref.losses)),
      "grad_gap": _leaf_gap(prog.grads, ref.grads, list(ref.grads)),
      "change_gap": _leaf_gap(prog.changes, ref.changes, moving),
  }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
  """True when every number is finite and within its limit; a number
  without a limit fails."""
  return all(limits.get(k) is not None and numbers[k] == numbers[k]
             and numbers[k] <= limits[k] for k in NUMBERS)
