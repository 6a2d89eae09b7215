"""GPT in plain float32 PyTorch: learned positions, pre-norm blocks
(QKV and the output projection without biases, a biased tanh-GELU MLP),
a final LayerNorm and the head tied to the token table; the next-token
cross entropy averaged over every position.

Departures from GPT-3 as published, which the port shares: LayerNorm
epsilon 1e-6, dense attention in every layer (GPT-3 alternates dense and
locally banded sparse layers), no dropout."""

from __future__ import annotations

import torch.nn.functional as F

from perfbench.reference import common

NAMES = common.Names(ln1="ln1", qkv="attn.qkv", proj="attn.proj", ln2="ln2",
                     wi="mlp.wi", wo="mlp.wo")


def hidden(p, ids, config, mm):
  S = ids.shape[1]
  x = p["wte.weight"][ids] + p["wpe"][:S]
  x = common.blocks(x, p, config["num_layers"], NAMES, config["num_heads"],
                    True, mm)
  return common.layer_norm(x, p, "ln_f")


def loss_sum(p, batch, config, mm):
  """Summed next-token cross entropy of ``batch["ids"] [B, S + 1]``."""
  ids = batch["ids"]
  logits = mm(hidden(p, ids[:, :-1], config, mm), p["wte.weight"])
  return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         ids[:, 1:].reshape(-1), reduction="sum")


def count(batch, config):
  """Positions the loss averages over."""
  return batch["ids"][:, 1:].numel()


def train(params0, batches, config, mix, groups, precision="fp32",
          tokens_a_block=8192):
  mm = common.PRECISIONS[precision]
  rows = max(1, tokens_a_block // mix["seq_len"])
  return common.train(lambda p, b: loss_sum(p, b, config, mm),
                      lambda b: count(b, config), params0, batches,
                      config["optimizer"], rows, groups)
