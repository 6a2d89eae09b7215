"""Ulysses sequence parallelism: the head/sequence all-to-all (port of
``easyparallellibrary_tpu/sequence/ulysses.py``).

Every rank holds its slice of the tokens, ``[B, S/n, H, D]``.  An
all-to-all over the seq group gives each rank the whole sequence for
``H/n`` of the heads, attention runs there, and a second all-to-all
restores the token slices (``collectives.all_to_all``, whose backward is
the inverse exchange).  The JAX module writes the two re-shards as
sharding constraints (``ulysses_attention``'s einsum path) or
``shard_map`` entry specs (``_ulysses_flash``), or as all-to-alls in the
smap engine's region (``_ulysses_manual``); here all three are one
explicit path.  The attention in the middle is the flash kernels
(``sequence.ulysses_impl="flash"``, when they tile the whole sequence,
on a seq axis above 1 or in a stage program) or the plain full-sequence
product.  Requires ``num_heads`` divisible by the seq axis (the heads a
rank holds: ``H / tp`` under tensor parallelism).
"""

from __future__ import annotations

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_blockable)


def _dense_full_attention(q, k, v, causal: bool):
  """Full-sequence plain attention (``[B, S, H, D]`` -> same): products
  in the inputs' dtype, fp32 softmax."""
  S, D = q.shape[1], q.shape[3]
  scale = 1.0 / torch.sqrt(torch.tensor(float(D)))
  scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
  if causal:
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(-1e30, device=q.device))
  probs = torch.softmax(scores, dim=-1).to(q.dtype)
  return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def ulysses_attention(q, k, v, causal: bool = True, manual: bool = False):
  """``[B, S/n, H, D]`` token slices -> attention -> the same.
  ``manual``: the caller is a stage program of the ``smap`` engine."""
  from easyparallellibrary_tpu_torch.env import Env
  H, D = q.shape[2], q.shape[3]
  n = collectives.axis_size(constants.SEQ_AXIS)
  if n > 1 and H % n:
    raise ValueError(f"Ulysses requires num_heads ({H}) divisible by the "
                     f"seq axis size ({n})")
  # all-to-all #1: [B, s, H, D] -> [B, s*n, H/n, D]
  qh, kh, vh = (collectives.all_to_all(x, constants.SEQ_AXIS, split_axis=2,
                                       concat_axis=1) for x in (q, k, v))
  if ((n > 1 or manual)
      and Env.get().config.sequence.ulysses_impl == "flash"
      and flash_blockable(qh.shape[1], d=D, itemsize=q.element_size())):
    out = flash_attention(qh, kh, vh, causal=causal)
  else:
    # ulysses_impl="einsum", or a length the kernels cannot tile.
    out = _dense_full_attention(qh, kh, vh, causal)
  # all-to-all #2: back to the token slices.
  return collectives.all_to_all(out, constants.SEQ_AXIS, split_axis=1,
                                concat_axis=2)
