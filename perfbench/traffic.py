"""The one generator of training batches, driven by a mix file
(``perfbench/traffic/<mix>.json``).

Everything is drawn on the device from the run's seed with
``torch.Generator``s, one stream a purpose, so a seed gives the same
weights and batches on every run and every seed the same sizes.  A mix
gives:

* ``batch``, ``seq_len``: the rows of a step and their length;
* ``pool``: how many distinct batches are drawn and cycled through (the
  first three feed the checked steps, so at least 3);
* ``tokens``: ``{"dist": "zipf", "exponent": a}`` (rank r drawn with
  weight ``r ** -a``, the ranks given to ids by a seeded permutation
  drawn for each batch, so each batch has its own frequent tokens) or
  ``{"dist": "uniform"}``, over the configuration's ``token_vocab``;
* ``mlm`` (masked-LM mixes): BERT's recipe, ``min(max_predictions,
  max(1, round(seq_len * predict_share)))`` positions a row predicted,
  of them ``mask_share`` replaced by the mask id, ``random_share`` by a
  random token, the rest kept.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

# Streams of the seed.
WEIGHTS, BATCHES = 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
  """The seeded generator of ``stream`` on ``device``."""
  g = torch.Generator(device=device)
  g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
  return g


def tokens(g: torch.Generator, shape, vocab: int, spec: dict, device):
  """Token ids ``[shape]`` in ``[0, vocab)`` drawn as ``spec`` says."""
  dist = spec.get("dist", "uniform")
  if dist == "uniform":
    return torch.randint(0, vocab, tuple(shape), generator=g, device=device)
  if dist != "zipf":
    raise ValueError(f"unknown token distribution {dist!r}")
  ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
  cdf = torch.cumsum(ranks.pow(-float(spec["exponent"])), 0)
  cdf /= cdf[-1].clone()
  ids = torch.randperm(vocab, generator=g, device=device)
  u = torch.rand(math.prod(shape), generator=g, device=device,
                 dtype=torch.float64)
  rank = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
  return ids[rank].view(tuple(shape))


def predictions(seq_len: int, spec: dict) -> int:
  """Positions a row predicted under the ``mlm`` spec."""
  return min(int(spec["max_predictions"]),
             max(1, round(seq_len * float(spec["predict_share"]))))


def masked(g: torch.Generator, ids, spec: dict, vocab: int, mask_id: int,
           device) -> Dict[str, torch.Tensor]:
  """``{"ids", "labels", "mask"}`` of BERT's masked-LM recipe over
  ``ids [B, S]``: exactly :func:`predictions` positions a row."""
  B, S = ids.shape
  n = predictions(S, spec)
  pos = torch.rand(B, S, generator=g, device=device).argsort(dim=1)[:, :n]
  mask = torch.zeros(B, S, device=device).scatter_(1, pos, 1.0)
  r = torch.rand(B, S, generator=g, device=device)
  picked = mask > 0
  share = float(spec["mask_share"])
  to_mask = picked & (r < share)
  to_random = picked & (r >= share) & (r < share + float(spec["random_share"]))
  noise = torch.randint(0, vocab, (B, S), generator=g, device=device)
  inputs = torch.where(to_mask, torch.full_like(ids, mask_id), ids)
  inputs = torch.where(to_random, noise, inputs)
  return {"ids": inputs, "labels": ids, "mask": mask}


def batches(config: dict, mix: dict, seed: int, device) -> List[dict]:
  """The mix's pool of batches: ``{"ids": [B, S + 1]}`` for a causal LM
  (inputs and next-token targets), BERT's masked-LM triple for ``mlm``."""
  if mix["pool"] < 3:
    raise ValueError("a pool holds at least the three checked batches")
  g = generator(seed, BATCHES, device)
  B, S, vocab = mix["batch"], mix["seq_len"], config["token_vocab"]
  pool = []
  for _ in range(mix["pool"]):
    if mix["objective"] == "lm":
      pool.append({"ids": tokens(g, (B, S + 1), vocab, mix["tokens"],
                                 device)})
    elif mix["objective"] == "mlm":
      ids = tokens(g, (B, S), vocab, mix["tokens"], device)
      pool.append(masked(g, ids, mix["mlm"], vocab, config["mask_token_id"],
                         device))
    else:
      raise ValueError(f"unknown objective {mix['objective']!r}")
  return pool

