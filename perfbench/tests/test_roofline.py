"""The yardstick's counts against hand counts, and each family's FLOPs
a token against a count of its reference's products."""

import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from perfbench import roofline, traffic


@pytest.mark.parametrize("causal,pairs", [(True, 10), (False, 16)])
def test_attention_counts_by_hand(causal, pairs):
  # One sequence of 4 queries, one head of 2, bf16: q, k, v and the
  # output are 16 bytes each, the log-sum-exp rows 16.
  a = roofline.Attention(B=1, H=1, S=4, D=2, causal=causal)
  assert a.pairs == pairs
  assert roofline.attention_forward(a) == (4 * 2 * pairs, 4 * 16 + 16)
  # dO, dQ, dK and dV besides: 8 tensors of 16 bytes and the lse rows.
  assert roofline.attention_backward(a) == (8 * 2 * pairs, 8 * 16 + 16)


def test_attention_scales_with_batch_and_heads():
  one = roofline.Attention(B=1, H=1, S=64, D=16, causal=True)
  many = roofline.Attention(B=3, H=5, S=64, D=16, causal=True)
  for cost in (roofline.attention_forward, roofline.attention_backward):
    assert [15 * x for x in cost(one)] == list(cost(many))


def test_least_time_is_the_larger_bound():
  assert roofline.least_seconds(989e12, 1.0, 989e12, 3.35e12) == 1.0
  assert roofline.least_seconds(1.0, 6.7e12, 989e12, 3.35e12) == 2.0


def test_peaks_are_the_h100_sxm_data_sheet():
  peak = roofline.peaks("NVIDIA H100 80GB HBM3")
  assert peak["flops"]["bfloat16"] == 989e12
  assert peak["bytes_per_s"] == 3.35e12
  with pytest.raises(ValueError):
    roofline.peaks("NVIDIA A100-SXM4-80GB")


def test_dense_count_is_six_times_the_products_parameters():
  assert roofline.dense_flops_per_token(2, 8, 32) == 6 * 2 * (
      4 * 64 + 2 * 256)


def _reference_forward_flops(cell):
  """The reference forward's counted FLOPs with a table of the
  vocabulary's own rows, the head's required work."""
  config, mix, _ = tiny.spec(cell)
  config = {**config, "vocab_size": config["token_vocab"]}
  fam = importlib.import_module(f"perfbench.families.{config['family']}")
  ref = importlib.import_module(f"perfbench.reference.{config['family']}")
  params = fam.make_weights(fam.build(config, tiny.CPU).shapes(), config, 7,
                            tiny.CPU)
  batch = traffic.batches(config, mix, 7, tiny.CPU)[0]
  with torch.no_grad(), FlopCounterMode(display=False) as counter:
    ref.loss_sum(params, batch, config, lambda x, w: x @ w.t())
  return fam, config, mix, counter.get_total_flops()


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_flops_per_token_counts_the_reference_products(cell):
  """Three times the reference forward's products, with attention's
  full score matrix (one query block here) replaced by the pairs its
  mask keeps, is the family's count."""
  fam, config, mix, counted = _reference_forward_flops(cell)
  a = fam.attention_ops(config, mix)[0]
  full = 4 * a.B * a.H * a.S * a.S * a.D * config["num_layers"]
  kept = roofline.attention_forward(a)[0] * config["num_layers"]
  tokens = mix["batch"] * mix["seq_len"]
  assert 3 * (counted - full + kept) == pytest.approx(
      fam.flops_per_token(config, mix) * tokens, rel=1e-12)
