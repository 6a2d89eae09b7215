"""GPT (decoder, causal LM, tied head) through the port: its
configuration, its train step, its seeded weights and its count of
FLOPs and attention operations."""

from __future__ import annotations

import dataclasses

import torch

from perfbench import roofline, weights
from perfbench.program import Program

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


# The leaves the architecture fuses from several tensors, by owner: QKV
# is one product whose rows are the query, key and value weights.
GROUPS = {"qkv": 3}

# The port's kernel libraries the train step launches (K1, under
# ``attn_impl`` "pallas_flash"); a run builds these and no others.
KERNELS = ("flash_attention",)


def port_config(config: dict):
  """The port's ``GPTConfig`` of a configuration file: every key that
  names a field, dtypes by name."""
  from easyparallellibrary_tpu_torch.models.gpt import GPTConfig
  fields = {f.name for f in dataclasses.fields(GPTConfig)}
  kw = {k: v for k, v in config.items() if k in fields}
  for key in ("dtype", "param_dtype"):
    if key in kw:
      kw[key] = DTYPES[kw[key]]
  return GPTConfig(**kw)


def build(config: dict, device) -> Program:
  from easyparallellibrary_tpu_torch.models.gpt import GPT, gpt_loss
  from easyparallellibrary_tpu_torch.parallel import make_train_step
  cfg = port_config(config)

  def make_step(model):
    return make_train_step(lambda p, b, r: gpt_loss(model, p, b, r))

  return Program(lambda: GPT(cfg), make_step, config["optimizer"], device)


def make_weights(shapes, config: dict, seed: int, device):
  return weights.make(shapes, weights.transformer_rule(
      ("wte.weight", "wpe"), config["embedding_std"]), seed, device)


def tokens_per_step(config: dict, mix: dict) -> int:
  return mix["batch"] * mix["seq_len"]


def attention_ops(config: dict, mix: dict):
  """The attention operations a step requires: one a layer, forward and
  backward (the recompute under remat is not required work)."""
  a = roofline.Attention(
      B=mix["batch"], H=config["num_heads"], S=mix["seq_len"],
      D=config["d_model"] // config["num_heads"], causal=True,
      itemsize=DTYPES[config["dtype"]].itemsize)
  return [a] * config["num_layers"]


def flops_per_token(config: dict, mix: dict) -> float:
  """Required training FLOPs a token: the blocks' products, the tied
  head over every position and the vocabulary's own rows (not the rows
  that pad the table), and causal attention's kept pairs."""
  D, L = config["d_model"], config["num_layers"]
  head = 6.0 * D * config["token_vocab"]
  return (roofline.dense_flops_per_token(L, D, config["d_ff"]) + head
          + roofline.attention_flops_per_token(
              L, attention_ops(config, mix)[0]))
