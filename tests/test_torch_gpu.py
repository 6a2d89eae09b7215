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
