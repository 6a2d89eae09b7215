"""BERT in plain float32 PyTorch, as the port builds it: token, position
and segment (all 0) embeddings under a LayerNorm, pre-norm encoder
blocks with every product biased and tanh GELU, a final LayerNorm, and
the masked-LM logits through the tied token table at the predicted
positions; the loss is the predicted positions' summed cross entropy
over their count.

Departures from BERT as published, which the port shares: pre-norm
blocks with a final LayerNorm (BERT is post-norm), LayerNorm epsilon
1e-6, tanh GELU, no MLM transform layer or output bias, no next-sentence
loss, no dropout."""

from __future__ import annotations

import torch.nn.functional as F

from perfbench.reference import common

NAMES = common.Names(ln1="ln1", qkv="qkv", proj="proj", ln2="ln2", wi="wi",
                     wo="wo")


def hidden(p, ids, config, mm):
  S = ids.shape[1]
  x = p["wte.weight"][ids] + p["wpe"][:S] + p["wse.weight"][0]
  x = common.layer_norm(x, p, "ln_emb")
  x = common.blocks(x, p, config["num_layers"], NAMES, config["num_heads"],
                    False, mm)
  return common.layer_norm(x, p, "ln_f")


def loss_sum(p, batch, config, mm):
  """Summed cross entropy of the predicted positions (``mask`` 1)."""
  h = hidden(p, batch["ids"], config, mm)
  picked = batch["mask"] > 0
  logits = mm(h[picked], p["wte.weight"])
  return F.cross_entropy(logits, batch["labels"][picked], reduction="sum")


def count(batch, config):
  """Predicted positions of the whole batch (at least 1)."""
  return max(float(batch["mask"].sum()), 1.0)


def train(params0, batches, config, mix, groups, precision="fp32",
          tokens_a_block=8192):
  mm = common.PRECISIONS[precision]
  rows = max(1, tokens_a_block // mix["seq_len"])
  return common.train(lambda p, b: loss_sum(p, b, config, mm),
                      lambda b: count(b, config), params0, batches,
                      config["optimizer"], rows, groups)
