"""The port's examples (``easyparallellibrary_tpu_torch/examples/``) at a
tiny width on the CPU: each ``main([...])`` runs with ``--device cpu``,
prints the JAX script's lines, and trains (the loss falls) or decodes.
``train_bert_pipeline`` runs its two stages on two gloo ranks.  A first
loss is ``log(vocab)`` within 5%: the cross-entropy of the near-uniform
logits of freshly drawn weights.
"""

import math

import numpy as np
import pytest
import torch

import easyparallellibrary_tpu_torch as tepl

torch.set_num_threads(1)

GPT_TINY = ["--device", "cpu", "--layers", "2", "--d-model", "32",
            "--heads", "4", "--vocab", "64", "--seq-len", "16"]


@pytest.fixture(autouse=True)
def _reset_port_env():
  yield
  tepl.Env.get().reset()


def test_train_gpt_runs_prints_and_learns(capsys, tmp_path):
  from easyparallellibrary_tpu_torch.examples import train_gpt
  out = train_gpt.main(GPT_TINY + ["--batch", "4", "--steps", "6",
                                   "--ckpt", str(tmp_path / "ck")])
  text = capsys.readouterr().out
  assert "mesh: {'stage': 1, 'data': 1, 'seq': 1, 'expert': 1, 'model': 1}" \
      in text
  assert "step 0: loss" in text and "step 5: loss" in text
  assert "profile: {" in text and "checkpoint saved to" in text
  losses = out["losses"]
  assert len(losses) == 6 and all(np.isfinite(losses))
  assert losses[-1] < losses[0]
  assert losses[0] == pytest.approx(math.log(64), rel=0.05)
  assert out["profile"]["tokens_per_sec"] > 0
  # The checkpoint decodes in generate_gpt, as the JAX scripts chain.
  from easyparallellibrary_tpu_torch.examples import generate_gpt
  got = generate_gpt.main(GPT_TINY + ["--max-new-tokens", "4",
                                      "--checkpoint-dir",
                                      str(tmp_path / "ck")])
  assert "restored checkpoint at step 6" in capsys.readouterr().out
  assert len(got["generated"]) == 4


def test_train_gpt_refuses_a_multi_rank_checkpoint():
  from easyparallellibrary_tpu_torch.examples import train_gpt
  with pytest.raises(SystemExit):
    train_gpt._rank_main(GPT_TINY + ["--tp", "2", "--ckpt", "/nonexistent"])
  assert train_gpt.world_size(train_gpt._parser().parse_args(
      ["--tp", "2", "--pp", "2", "--seq", "ring", "--seq-size", "2",
       "--experts", "8"])) == 16


def test_generate_gpt_streams_equal_through_the_paged_engine(capsys):
  """Greedy decoding by ``generate`` (KV cache) and by the paged serving
  engine give one stream."""
  from easyparallellibrary_tpu_torch.examples import generate_gpt
  flags = GPT_TINY[:-2] + ["--seq-len", "48", "--max-new-tokens", "8"]
  plain = generate_gpt.main(flags)
  paged = generate_gpt.main(flags + ["--paged"])
  assert plain == paged and len(plain["generated"]) == 8
  lines = capsys.readouterr().out
  assert lines.count("prompt:") == 2 and lines.count("generated:") == 2


def test_train_bert_pipeline_on_two_gloo_ranks():
  from easyparallellibrary_tpu_torch.examples import train_bert_pipeline
  out = train_bert_pipeline.main([
      "--device", "cpu", "--layers", "2", "--d-model", "32", "--heads", "4",
      "--vocab", "64", "--seq-len", "16", "--batch", "4", "--micro", "2",
      "--steps", "3"])
  assert out["mesh"]["stage"] == 2
  losses = out["losses"]
  assert len(losses) == 3 and all(np.isfinite(losses))
  assert losses[-1] < losses[0]
  assert losses[0] == pytest.approx(math.log(64), rel=0.05)


def test_train_resnet_dp_runs_and_learns(capsys):
  from easyparallellibrary_tpu_torch.examples import train_resnet_dp
  out = train_resnet_dp.main([
      "--device", "cpu", "--stage-sizes", "1,1", "--filters", "8",
      "--image-size", "16", "--classes", "10", "--batch", "4", "--steps",
      "3"])
  text = capsys.readouterr().out
  assert "step 2: loss" in text and " acc " in text
  assert out["losses"][-1] < out["losses"][0]
  assert all(0.0 <= a <= 1.0 for a in out["accuracy"])
