"""Tiny versions of the cells' configurations and mixes, for the CPU:
the same families, paths and comparisons at widths a test can hold, in
float32."""

import torch

CARD = "NVIDIA H100 80GB HBM3"
CPU = torch.device("cpu")

_WIDTHS = {"num_layers": 2, "d_model": 64, "num_heads": 4, "d_ff": 128,
           "vocab_size": 256, "token_vocab": 250, "max_seq_len": 64,
           "dtype": "float32"}

OVERRIDES = {
    "gpt": {"config": {**_WIDTHS, "loss_chunk": 16},
            "mix": {"batch": 4, "seq_len": 32}},
    "bert": {"config": {**_WIDTHS, "mask_token_id": 3},
             "mix": {"batch": 4, "seq_len": 32}},
}

CELLS = {"gpt3-medium.train.s1024": "gpt", "bert-large.train.s512": "bert"}


def spec(cell):
  """``(config, mix, overrides)`` of ``cell`` at the tiny size."""
  from perfbench import run
  _, config, mix = run.cell_spec(cell)
  over = OVERRIDES[config["family"]]
  return ({**config, **over["config"]}, {**mix, **over["mix"]}, over)
