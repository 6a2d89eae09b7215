"""fp16 flash attention in the port against the JAX package's.

On the CPU the port runs its fp16 plain versions (the oracle the fp16
CUDA kernels are held against on the card) and the JAX package runs its
Pallas kernels in interpret mode in fp16, on the same numpy inputs: the
forward, the lse, and the gradients through the port's custom op against
``jax.grad``, causal and full, at the wgmma builds' head dims (64, 128)
and at a length that is no multiple of the kernels' 64-row tiles.  Then
an O1-fp16 AdamW trajectory with ``attn_impl="pallas_flash"`` under the
dynamic loss scale, against the JAX package's under the same config.

The frameworks round fp16 at other places (the score sums run in
another order, and ``p`` is rounded against another running max), so
the outputs are held by normalized error: ``||got - want|| / ||want||``
and ``max|got - want| / max|want|``.  The limits are about 4 times the
largest readings over these cases on the CPU (forward 3.8e-5 / 3.7e-4,
gradients 6.7e-5 / 6.7e-4; lse within 9.6e-7).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu.models import gpt as jgpt
from easyparallellibrary_tpu.parallel import api as japi
from easyparallellibrary_tpu.runtime import trainer as jtrainer
from easyparallellibrary_tpu_torch.kernels import flash_attention as tfa
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.parallel import api as tapi
from easyparallellibrary_tpu_torch.runtime import trainer as ttrainer
from easyparallellibrary_tpu_torch.weights import from_jax_params

# The JAX package's kernels/__init__ re-exports the function under the
# module's name, so the module is imported by path.
jfa = importlib.import_module("easyparallellibrary_tpu.kernels.flash_attention")

# Small shapes: one intra-op thread leaves the cores to the suite's
# other worker processes.
torch.set_num_threads(1)

FWD_LIMIT = dict(rel_l2=1.5e-4, max_rel=1.5e-3)
GRAD_LIMIT = dict(rel_l2=3e-4, max_rel=3e-3)
LSE_ATOL = 5e-6
# (S, D): the two wgmma head dims, and a ragged length.
SHAPES = [(128, 64), (128, 128), (200, 64)]


def _normalized(got, want):
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  d = got - want
  return (float(np.linalg.norm(d) / np.linalg.norm(want)),
          float(np.abs(d).max() / np.abs(want).max()))


def _within(name, got, want, limit):
  rel_l2, max_rel = _normalized(got, want)
  assert rel_l2 <= limit["rel_l2"] and max_rel <= limit["max_rel"], (
      f"{name}: normalized errors {rel_l2:.3e}, {max_rel:.3e} over {limit}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S,D", SHAPES, ids=[f"s{s}_d{d}" for s, d in SHAPES])
def test_fp16_flash_matches_jax_pallas(S, D, causal):
  """Forward, lse and the three gradients in fp16, [B, S, H, D] = [1, S,
  2, D], through ``flash_attention_lse`` and the custom op's backward
  (the plain versions here) against the JAX Pallas kernels."""
  r = np.random.RandomState(S + D)
  q, k, v = [r.randn(1, S, 2, D).astype(np.float16) for _ in range(3)]
  w = r.randn(1, S, 2, D).astype(np.float32)
  jout, jlse = jfa.flash_attention_lse(*map(jnp.asarray, (q, k, v)),
                                       causal=causal)
  tfa.reset_counts()
  tout, tlse = tfa.flash_attention_lse(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal)
  assert tout.dtype == torch.float16 and jout.dtype == jnp.float16
  assert tlse.dtype == torch.float32
  _within("out", tout.numpy(), jout, FWD_LIMIT)
  np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=0,
                             atol=LSE_ATOL)

  jgrads = jax.grad(
      lambda a, b, c: jnp.sum(jfa.flash_attention(a, b, c, causal=causal)
                              .astype(jnp.float32) * w),
      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
  leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
  loss = (tfa.flash_attention(*leaves, causal=causal).float()
          * torch.from_numpy(w)).sum()
  tgrads = torch.autograd.grad(loss, leaves)
  for name, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
    assert got.dtype == torch.float16 and want.dtype == jnp.float16, name
    _within(name, got.numpy(), want, GRAD_LIMIT)
  # The CPU path is the plain versions, never a kernel.
  assert (tfa.flash_fwd_reference.calls, tfa.flash_bwd_dkv_reference.calls,
          tfa.flash_bwd_dq_reference.calls) == (2, 1, 1)
  assert (tfa.flash_fwd_cuda.launches, tfa.flash_bwd_dkv_cuda.launches,
          tfa.flash_bwd_dq_cuda.launches) == (0, 0, 0)


def test_flash_route_refuses_an_unknown_kernel():
  """``flash_route`` names the kernels "fwd", "dkv" and "dq" and the
  dtypes the kernels take; anything else is refused before the library
  is looked at (which is built on the card's machine only)."""
  with pytest.raises(ValueError, match="kernel"):
    tfa.flash_route("bwd", torch.float16, 64)
  with pytest.raises(ValueError, match="dtype"):
    tfa.flash_route("fwd", torch.float64, 64)


# ------------------------------------------ O1-fp16 training trajectory --

O1_FP16 = {"amp.level": "O1", "amp.compute_dtype": "fp16",
           "amp.loss_scale": "dynamic"}
# Head dim 64 (the wgmma builds' on the card), 32 positions.
WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=128,
              d_ff=256, max_seq_len=32)


@pytest.fixture(autouse=True)
def _reset_envs():
  yield
  tepl.Env.get().reset()
  jepl.Env.get().reset()


def _jax_trajectory(ids, steps):
  jepl.init(jepl.Config(O1_FP16), devices=jax.devices()[:1])
  with jepl.replicate(1):
    model = jgpt.GPT(jgpt.GPTConfig(**WIDTHS, dtype=jnp.float32,
                                    attn_impl="pallas_flash"))
  mesh = jepl.current_plan().build_mesh()
  params0 = model.init(jax.random.PRNGKey(0),
                       jnp.asarray(ids[:, :-1]))["params"]
  tx = optax.adamw(3e-4, weight_decay=0.01)
  state, sh = japi.create_sharded_train_state(
      lambda: jtrainer.create_train_state(model.apply, params0, tx), mesh)
  step = japi.parallelize(jtrainer.build_train_step(
      lambda p, b, r: jgpt.gpt_loss(model, p, b, r)), mesh, sh)
  batch = {"ids": jnp.asarray(ids)}
  out = []
  for _ in range(steps):
    state, metrics = step(state, batch, jax.random.PRNGKey(0))
    out.append((float(metrics["loss"]), float(metrics["loss_scale"]),
                float(metrics["grads_finite"])))
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params0)), out


def _port_trajectory(params0, ids, steps):
  tepl.init(tepl.Config(O1_FP16), device="cpu")
  with tepl.replicate(1):
    model = tgpt.GPT(tgpt.GPTConfig(**WIDTHS, dtype=torch.float32,
                                    attn_impl="pallas_flash"))
  mesh = tepl.current_plan().build_mesh()
  tx = tadamw.adamw(3e-4, weight_decay=0.01)
  state, sh = tapi.create_sharded_train_state(
      lambda: ttrainer.create_train_state(
          model, from_jax_params(params0, device="cpu"), tx), mesh)
  step = tapi.parallelize(ttrainer.build_train_step(
      lambda p, b, r: tgpt.gpt_loss(model, p, b, r)), mesh, sh)
  batch = {"ids": torch.from_numpy(ids)}
  out = []
  tfa.reset_counts()
  for _ in range(steps):
    state, metrics = step(state, batch, None)
    out.append((metrics["loss"].item(), metrics["loss_scale"].item(),
                metrics["grads_finite"].item()))
  return out


def test_o1_fp16_flash_trajectory_under_dynamic_loss_scale_matches_jax():
  """4 AdamW steps of an fp32 GPTConfig under O1 fp16 with the dynamic
  loss scale, attention through the flash op (fp16 q, k, v): the losses
  within rtol 3e-3 of JAX's (fp16 rounds at other places in the two
  frameworks, as the O1-fp16 forward test in test_torch_amp.py states),
  the scale and the finite flags equal, each step's forward and backward
  through the plain versions once a layer."""
  steps = 4
  ids = np.random.RandomState(0).randint(0, 64, (4, 33))
  params0, want = _jax_trajectory(ids, steps)
  got = _port_trajectory(params0, ids, steps)
  np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                             rtol=3e-3)
  assert [g[1:] for g in got] == [w[1:] for w in want]
  assert all(g[2] == 1.0 for g in got)
  assert got[-1][0] < got[0][0]
  layers = WIDTHS["num_layers"]
  assert tfa.flash_bwd_dkv_reference.calls == layers * steps
  assert tfa.flash_bwd_dq_reference.calls == layers * steps
