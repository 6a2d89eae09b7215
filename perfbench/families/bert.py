"""BERT (encoder, masked-LM through the tied table) through the port:
its configuration, its train step, its seeded weights and its count of
FLOPs and attention operations."""

from __future__ import annotations

import dataclasses

from perfbench import roofline, traffic, weights
from perfbench.families.gpt import DTYPES
from perfbench.program import Program


# The leaves the architecture fuses from several tensors, by owner: QKV
# is one product whose rows are the query, key and value weights.
GROUPS = {"qkv": 3}

# The port's kernel libraries the train step launches (K1, under
# ``attn_impl`` "pallas_flash"); a run builds these and no others.
KERNELS = ("flash_attention",)


def port_config(config: dict):
  """The port's ``BertConfig`` of a configuration file."""
  from easyparallellibrary_tpu_torch.models.bert import BertConfig
  fields = {f.name for f in dataclasses.fields(BertConfig)}
  kw = {k: v for k, v in config.items() if k in fields}
  for key in ("dtype", "param_dtype"):
    if key in kw:
      kw[key] = DTYPES[kw[key]]
  return BertConfig(**kw)


def build(config: dict, device) -> Program:
  from easyparallellibrary_tpu_torch.models.bert import (
      Bert, make_bert_train_step)
  cfg = port_config(config)
  return Program(lambda: Bert(cfg), make_bert_train_step,
                 config["optimizer"], device)


def make_weights(shapes, config: dict, seed: int, device):
  return weights.make(shapes, weights.transformer_rule(
      ("wte.weight", "wpe", "wse.weight"), config["embedding_std"]), seed,
      device)


def tokens_per_step(config: dict, mix: dict) -> int:
  return mix["batch"] * mix["seq_len"]


def attention_ops(config: dict, mix: dict):
  """One unmasked attention a layer, forward and backward (full remat's
  second forward is not required work)."""
  a = roofline.Attention(
      B=mix["batch"], H=config["num_heads"], S=mix["seq_len"],
      D=config["d_model"] // config["num_heads"], causal=False,
      itemsize=DTYPES[config["dtype"]].itemsize)
  return [a] * config["num_layers"]


def flops_per_token(config: dict, mix: dict) -> float:
  """Required training FLOPs a token: the blocks' products, the tied
  head at the predicted positions only and over the vocabulary's own
  rows (not the rows that pad the table), and full attention."""
  D, L, S = config["d_model"], config["num_layers"], mix["seq_len"]
  head = 6.0 * D * config["token_vocab"] * traffic.predictions(
      S, mix["mlm"]) / S
  return (roofline.dense_flops_per_token(L, D, config["d_ff"]) + head
          + roofline.attention_flops_per_token(
              L, attention_ops(config, mix)[0]))
