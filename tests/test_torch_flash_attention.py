"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port runs its plain PyTorch versions (the CUDA kernels'
oracle on the card) and the JAX package runs its Pallas kernels in
interpret mode, on the same numpy inputs.  Every case of
tests/test_flash_attention.py, at its tolerances: forward rtol 2e-5 /
atol 2e-6, grads rtol 5e-4 / atol 1e-5, the lse cotangent 2e-4 / 2e-5.
The port has one kernel per function, so the JAX streaming runs (forced
with ``_RESIDENT_MAX_BYTES = 1``) are held against the same port path.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyparallellibrary_tpu_torch.kernels import flash_attention as tfa

# The JAX package's kernels/__init__ re-exports the function under the
# module's name, so the module is imported by path.
jfa = importlib.import_module("easyparallellibrary_tpu.kernels.flash_attention")

# Small shapes: one intra-op thread leaves the cores to the suite's
# other worker processes.
torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def _qkv(B=2, S=128, H=2, D=32, seed=0):
  """tests/test_flash_attention.py's draw, as numpy."""
  r = np.random.RandomState(seed)
  return [r.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def _leaves(arrays):
  return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def _np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
  np.testing.assert_allclose(_np(got), _np(want), **tol)


def _jax_grads(attn, arrays):
  return jax.grad(lambda a, b, c: jnp.mean(attn(a, b, c) ** 2),
                  argnums=(0, 1, 2))(*map(jnp.asarray, arrays))


def _torch_grads(attn, arrays):
  leaves = _leaves(arrays)
  loss = torch.mean(attn(*leaves) ** 2)
  return torch.autograd.grad(loss, leaves)


@pytest.fixture
def streaming(monkeypatch):
  """The JAX package's long-sequence streaming kernels at test size."""
  monkeypatch.setattr(jfa, "_RESIDENT_MAX_BYTES", 1)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax(causal):
  arrays = _qkv()
  want = jfa.flash_attention(*map(jnp.asarray, arrays), causal=causal,
                             block_q=64, block_k=64)
  got = tfa.flash_attention(*map(torch.from_numpy, arrays), causal=causal,
                            block_q=64, block_k=64)
  _close(got, want, FWD_TOL)


def test_flash_multiblock_matches_jax():
  arrays = _qkv(S=256, seed=1)
  want = jfa.flash_attention(*map(jnp.asarray, arrays), causal=True,
                             block_q=64, block_k=128)
  got = tfa.flash_attention(*map(torch.from_numpy, arrays), causal=True,
                            block_q=64, block_k=128)
  _close(got, want, FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax(causal):
  arrays = _qkv(S=64, seed=2)
  want = _jax_grads(lambda a, b, c: jfa.flash_attention(
      a, b, c, causal=causal, block_q=32, block_k=32), arrays)
  got = _torch_grads(lambda a, b, c: tfa.flash_attention(
      a, b, c, causal=causal, block_q=32, block_k=32), arrays)
  for g, w in zip(got, want):
    _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_streaming_path(causal, streaming):
  arrays = _qkv(S=256, seed=4)
  want = jfa.flash_attention(*map(jnp.asarray, arrays), causal=causal,
                             block_q=64, block_k=64)
  got = tfa.flash_attention(*map(torch.from_numpy, arrays), causal=causal,
                            block_q=64, block_k=64)
  _close(got, want, FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax_streaming_path(causal, streaming):
  arrays = _qkv(S=128, seed=5)
  want = _jax_grads(lambda a, b, c: jfa.flash_attention(
      a, b, c, causal=causal, block_q=32, block_k=32), arrays)
  got = _torch_grads(lambda a, b, c: tfa.flash_attention(
      a, b, c, causal=causal, block_q=32, block_k=32), arrays)
  for g, w in zip(got, want):
    _close(g, w, GRAD_TOL)


def test_flash_uneven_blocks_grads_match_jax(streaming):
  arrays = _qkv(S=256, seed=6)
  want = _jax_grads(lambda a, b, c: jfa.flash_attention(
      a, b, c, causal=True, block_q=32, block_k=64), arrays)
  got = _torch_grads(lambda a, b, c: tfa.flash_attention(
      a, b, c, causal=True, block_q=32, block_k=64), arrays)
  for g, w in zip(got, want):
    _close(g, w, GRAD_TOL)


def test_flash_small_seq_single_block_matches_jax():
  arrays = _qkv(S=16, seed=3)
  want = jfa.flash_attention(*map(jnp.asarray, arrays), causal=True)
  got = tfa.flash_attention(*map(torch.from_numpy, arrays), causal=True)
  _close(got, want, FWD_TOL)


@pytest.mark.parametrize("blocks", [dict(block_q=64, block_k=64),
                                    dict(block_q=32, block_k=64),
                                    dict(block_q=96, block_k=40)])
def test_flash_indivisible_block_raises_like_jax(blocks):
  arrays = _qkv(S=96)
  with pytest.raises(ValueError):
    jfa.flash_attention(*map(jnp.asarray, arrays), **blocks)
  with pytest.raises(ValueError, match="must divide"):
    tfa.flash_attention(*map(torch.from_numpy, arrays), **blocks)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_jax(causal):
  arrays = _qkv(S=64, seed=7)
  o1, l1 = jfa.flash_attention_lse(*map(jnp.asarray, arrays),
                                   causal=causal)
  o2, l2 = tfa.flash_attention_lse(*map(torch.from_numpy, arrays),
                                   causal=causal)
  assert tuple(l2.shape) == l1.shape == (2, 64, 2)
  _close(o2, o1, FWD_TOL)
  _close(l2, l1, FWD_TOL)


def test_flash_lse_cotangent_grads_match_jax():
  arrays = _qkv(S=32, D=16, seed=9)

  def jax_loss(q, k, v):
    o, l = jfa.flash_attention_lse(q, k, v, causal=True)
    return jnp.sum(o ** 2) + jnp.sum(jnp.sin(l))

  want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
  leaves = _leaves(arrays)
  o, l = tfa.flash_attention_lse(*leaves, causal=True)
  got = torch.autograd.grad(torch.sum(o ** 2) + torch.sum(torch.sin(l)),
                            leaves)
  for g, w in zip(got, want):
    _close(g, w, dict(rtol=2e-4, atol=2e-5))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,Skv,bq,bk", [(64, 64, 32, 32),
                                         (64, 128, 32, 64)])
def test_bwd_kernels_with_caller_lse_delta_match_jax(causal, S, Skv, bq, bk):
  """Caller-supplied lse and delta (ring attention's global-LSE
  backward): the port's ``[B, H, S]`` rows against JAX's sublane-tiled
  ``[B, H, 8, S]`` of the same numbers."""
  r = np.random.RandomState(11)
  B, H, D = 2, 2, 16
  q, do = (r.randn(B, H, S, D).astype(np.float32) for _ in range(2))
  k, v = (r.randn(B, H, Skv, D).astype(np.float32) for _ in range(2))
  # A real lse of these scores, and a delta that is not rowsum(dO*O).
  _, lse = tfa.flash_fwd_reference(*map(torch.from_numpy, (q, k, v)),
                                   causal)
  lse = lse.numpy()
  delta = r.randn(B, H, S).astype(np.float32)
  want = jfa._bwd_kernels(
      *map(jnp.asarray, (q, k, v, do)), jfa._tile8(jnp.asarray(lse)),
      jfa._tile8(jnp.asarray(delta)), causal, bq, bk)
  got = tfa._bwd_kernels(*map(torch.from_numpy, (q, k, v, do, lse, delta)),
                         causal, bq, bk)
  for name, g, w in zip(("dq", "dk", "dv"), got, want):
    assert tuple(g.shape) == w.shape, name
    _close(g, w, GRAD_TOL)


def test_bwd_kernels_indivisible_block_raises():
  x = torch.zeros(1, 1, 48, 8)
  rows = torch.zeros(1, 1, 48)
  with pytest.raises(ValueError, match="must divide"):
    tfa._bwd_kernels(x, x, x, x, rows, rows, True, 32, 32)


@pytest.mark.parametrize("S,d,itemsize", [(1024, 64, 2), (4096, 64, 2),
                                          (16384, 64, 2), (515, 64, 2),
                                          (96, 32, 4), (16, 16, 4),
                                          (8192, 128, 4)])
def test_block_choice_matches_jax(S, d, itemsize):
  assert tfa._heuristic_want(S, d, itemsize) == jfa._heuristic_want(
      S, d, itemsize)
  assert tfa._default_block(S, d=d, itemsize=itemsize) == \
      jfa._default_block(S, d=d, itemsize=itemsize)
  assert tfa.flash_blockable(S, d=d, itemsize=itemsize) == \
      jfa.flash_blockable(S, d=d, itemsize=itemsize)


def test_plain_versions_count_calls_and_kernel_wrappers_refuse_cpu():
  q, k, v = map(torch.from_numpy, _qkv(S=16))
  tfa.reset_counts()
  out, lse = tfa.flash_attention_lse(q.requires_grad_(), k, v)
  out.sum().backward()
  assert (tfa.flash_fwd_reference.calls, tfa.flash_bwd_dkv_reference.calls,
          tfa.flash_bwd_dq_reference.calls) == (1, 1, 1)
  assert (tfa.flash_fwd_cuda.launches, tfa.flash_bwd_dkv_cuda.launches,
          tfa.flash_bwd_dq_cuda.launches) == (0, 0, 0)
  x = torch.zeros(1, 1, 16, 8)
  rows = torch.zeros(1, 1, 16)
  with pytest.raises(ValueError, match="CUDA tensors"):
    tfa.flash_fwd_cuda(x, x, x, True)
  with pytest.raises(ValueError, match="CUDA tensors"):
    tfa.flash_bwd_dkv_cuda(x, x, x, x, rows, rows, True)
  with pytest.raises(ValueError, match="CUDA tensors"):
    tfa.flash_bwd_dq_cuda(x, x, x, x, rows, rows, True)
  meta = torch.empty(1, 1, 16, 8, device="meta")
  with pytest.raises(ValueError, match="no implementation"):
    tfa.flash_fwd(meta, meta, meta, True)


def test_gpt_with_pallas_flash_matches_xla():
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.weights import init_params
  base = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32,
              d_ff=64, max_seq_len=32, dtype=torch.float32)
  flash_cfg = GPTConfig(**base, attn_impl="pallas_flash")
  params = init_params(flash_cfg, 0, device="cpu")
  ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 32)))
  with torch.no_grad():
    out_flash = torch.func.functional_call(GPT(flash_cfg), params, (ids,))
    out_xla = torch.func.functional_call(
        GPT(GPTConfig(**base, attn_impl="xla")), params, (ids,))
  _close(out_flash, out_xla, dict(rtol=2e-4, atol=2e-5))


def test_unknown_attn_impl_raises():
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.weights import init_params
  cfg = GPTConfig(vocab_size=64, num_layers=1, num_heads=2, d_model=16,
                  d_ff=32, max_seq_len=16, attn_impl="flash")
  with pytest.raises(ValueError, match="attn_impl"):
    torch.func.functional_call(GPT(cfg), init_params(cfg, device="cpu"),
                               (torch.zeros(1, 16, dtype=torch.long),))
