"""The PyTorch port on the card: each CUDA kernel against its plain
version, and the engine's greedy streams against ``generate``.

Marked ``gpu``; every test skips itself where no CUDA device is present.
This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from easyparallellibrary_tpu_torch.kernels import paged_attention as pa


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


def _case(device, dtype, seed, T, H, hd, NB, bs, MB):
  """The JAX package's ``_parity_case`` draw (tests/test_serving_paged.py)
  on ``device``."""
  r = np.random.RandomState(seed)
  floats = [torch.from_numpy(r.randn(*s).astype(np.float32)).to(device,
                                                                 dtype)
            for s in ((T, H, hd), (NB, bs, H, hd), (NB, bs, H, hd))]
  tables = torch.from_numpy(r.randint(0, NB, (T, MB)).astype(np.int32))
  positions = torch.from_numpy(r.randint(0, MB * bs, (T,)).astype(np.int32))
  return (*floats, tables.to(device), positions.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [
    dict(seed=1, T=16, H=8, hd=64, NB=17, bs=16, MB=8),
    dict(seed=2, T=5, H=3, hd=24, NB=9, bs=8, MB=4),
    dict(seed=4, T=7, H=2, hd=256, NB=9, bs=8, MB=4),
    dict(seed=5, T=3, H=1, hd=8, NB=5, bs=2, MB=3),
])
def test_paged_attention_kernel_matches_plain_version(cuda, dtype, tol,
                                                      shape):
  args = _case(cuda, dtype, **shape)
  launches = pa.paged_attention_cuda.launches
  got = pa.paged_attention(*args)
  torch.cuda.synchronize()
  assert pa.paged_attention_cuda.launches == launches + 1
  want = pa.paged_attention_reference(*args)
  torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_engine_greedy_streams_match_generate_on_the_card(cuda):
  from easyparallellibrary_tpu_torch.models.gpt import generate
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  torch.backends.cuda.matmul.allow_tf32 = False
  model, params = tiny_gpt(seed=3, device=cuda)
  r = np.random.RandomState(0)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32) for n in (5, 3, 9, 1)]
  eng = ContinuousBatchingEngine(model, params, num_slots=2,
                                 prefill_chunk=4, paged=True, block_size=4)
  launches = pa.paged_attention_cuda.launches
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
  out = eng.run()
  assert pa.paged_attention_cuda.launches - launches == 2 * eng.steps
  for i, p in enumerate(prompts):
    want = generate(model, params, torch.from_numpy(p[None]).long().to(cuda),
                    6)[0].cpu().numpy()
    np.testing.assert_array_equal(out[i], want, err_msg=f"req {i}")


def _flash_case(device, dtype, seed, B, H, S, Skv, D):
  """q, k, v, dout ``[B, H, S|Skv, D]`` from a numpy seed."""
  r = np.random.RandomState(seed)
  q, k, v, dout = [
      torch.from_numpy(r.randn(B, H, n, D).astype(np.float32)).to(device,
                                                                  dtype)
      for n in (S, Skv, Skv, S)]
  return q, k, v, dout


# fp32: the JAX tests' tolerances (rtol, atol).  bf16: chip_smoke.py's
# normalized limits (||got - want|| / ||want||, max|got - want| /
# max|want|), which say how they were set.
FLASH_FP32_TOL = dict(fwd=(2e-5, 2e-6), grad=(5e-4, 1e-5))
FLASH_BF16_LIMIT = dict(fwd=(5e-3, 1e-2), grad=(5e-4, 1e-2))


def _assert_flash_close(got, want, kind, name):
  if got.dtype == torch.float32:
    rtol, atol = FLASH_FP32_TOL[kind]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return
  diff, ref = got.float() - want.float(), want.float()
  rel_l2 = (diff.norm() / ref.norm()).item()
  max_rel = (diff.abs().max() / ref.abs().max()).item()
  limit = FLASH_BF16_LIMIT[kind]
  assert rel_l2 <= limit[0] and max_rel <= limit[1], (name, rel_l2, max_rel)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,H,S,Skv,D", [
    (2, 3, 200, 200, 8),
    (2, 2, 128, 128, 32),
    (2, 3, 200, 200, 64),
    (1, 2, 128, 192, 128),
    (1, 2, 96, 96, 256),
])
def test_flash_kernels_match_plain_versions(cuda, dtype, causal, B, H, S,
                                            Skv, D):
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v, dout = _flash_case(cuda, dtype, 7, B, H, S, Skv, D)
  launches = fa.flash_fwd_cuda.launches
  out, lse = fa.flash_fwd(q, k, v, causal)
  torch.cuda.synchronize()
  assert fa.flash_fwd_cuda.launches == launches + 1
  want_out, want_lse = fa.flash_fwd_reference(q, k, v, causal)
  assert out.dtype == dtype
  _assert_flash_close(out, want_out, "fwd", "out")
  torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-6)
  delta = (dout.float() * want_out.float()).sum(-1)
  dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal)
  dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal)
  torch.cuda.synchronize()
  want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, want_lse,
                                                delta, causal)
  want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                      causal)
  for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                          ("dv", dv, want_dv)):
    assert got.dtype == dtype
    _assert_flash_close(got, want, "grad", name)


@pytest.mark.gpu
def test_training_step_on_the_card_matches_the_cpu(cuda):
  """A tiny GPT with the flash kernels under ``dots_flash`` remat, fp32:
  two AdamW steps on the card launch each kernel once per layer per step
  and give the losses of the same steps on the CPU (plain versions)."""
  from easyparallellibrary_tpu_torch import bench
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = bench.bench_config(torch.device("cuda"), vocab_size=64,
                           num_layers=2, num_heads=4, d_model=64, d_ff=128,
                           max_seq_len=128, loss_chunk=32,
                           dtype=torch.float32)[0]
  losses = {}
  for device in ("cpu", "cuda"):
    state, step, batch, rng, _ = bench.build_training(cfg, 2, device)
    fa.reset_counts()
    losses[device] = []
    for _ in range(2):
      state, metrics = step(state, batch, rng)
      losses[device].append(metrics["loss"].item())
  assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
          fa.flash_bwd_dq_cuda.launches) == (4, 4, 4)
  assert (fa.flash_fwd_reference.calls, fa.flash_bwd_dkv_reference.calls,
          fa.flash_bwd_dq_reference.calls) == (0, 0, 0)
  np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


@pytest.mark.gpu
def test_bf16_training_step_flash_matches_dense_on_the_card(cuda):
  """bf16 at head dim 64, where the kernels take the tensor cores: three
  AdamW steps with the flash kernels against the same steps with dense
  attention.  Both round to bf16 in other places, so the losses agree
  to rtol 2e-4 (about 6 times the 3.5e-5 an H100 shows), not bit for
  bit."""
  from easyparallellibrary_tpu_torch import bench
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  losses = {}
  for attn in ("pallas_flash", "xla"):
    cfg = bench.bench_config(torch.device("cuda"), vocab_size=256,
                             num_layers=2, num_heads=2, d_model=128,
                             d_ff=256, max_seq_len=256, loss_chunk=64,
                             attn_impl=attn)[0]
    state, step, batch, rng, _ = bench.build_training(cfg, 2, cuda)
    fa.reset_counts()
    losses[attn] = []
    for _ in range(3):
      state, metrics = step(state, batch, rng)
      losses[attn].append(metrics["loss"].item())
    want = 6 if attn == "pallas_flash" else 0
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
            fa.flash_bwd_dq_cuda.launches) == (want,) * 3
  assert np.isfinite(losses["pallas_flash"]).all()
  np.testing.assert_allclose(losses["pallas_flash"], losses["xla"],
                             rtol=2e-4)
