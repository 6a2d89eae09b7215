"""The PyTorch port's GPT against the flax GPT on bridged parameters.

The JAX package's own initialised parameters are carried across with
``weights.from_jax_params``; inputs come from numpy seeds.  fp32 cases
hold the port to atol 1e-5 (the two frameworks sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from easyparallellibrary_tpu.models import gpt as jgpt
from easyparallellibrary_tpu.ops import layers as jlayers
from easyparallellibrary_tpu.serving import (
    allocate_paged_kv_cache as jax_allocate_paged)
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.ops import layers as tlayers
from easyparallellibrary_tpu_torch.weights import from_jax_params, init_params

# Tiny shapes: one intra-op thread is enough, and it leaves the cores
# to the test suite's other worker processes.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
ATOL = 1e-5


def _configs(dtype="float32"):
  return (jgpt.GPTConfig(**TINY, dtype=getattr(jnp, dtype)),
          tgpt.GPTConfig(**TINY, dtype=getattr(torch, dtype)))


def _numpy_tree(params):
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def _perturbed(tree, seed):
  """Replace every leaf with a seeded draw of its shape, so LayerNorm
  scales and biases are not their trivial ones/zeros."""
  r = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda a: (0.5 * r.randn(*a.shape)).astype(np.float32), tree)


def _run_torch(module, tree, *args, **kw):
  params = from_jax_params(tree, device="cpu")
  with torch.no_grad():
    return torch.func.functional_call(module, params, args, kw, strict=True)


def _gpt_pair(seed=0, dtype="float32"):
  jcfg, tcfg = _configs(dtype)
  jmodel = jgpt.GPT(jcfg)
  params = jmodel.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 4), jnp.int32))["params"]
  return jmodel, params, tgpt.GPT(tcfg), _numpy_tree(params)


@pytest.mark.parametrize("name", ["LayerNorm", "Dense", "MLP", "Block"])
def test_module_matches_flax(name):
  jcfg, tcfg = _configs()
  D = jcfg.d_model
  if name == "LayerNorm":
    jmod, tmod = jlayers.LayerNorm(dtype=jnp.float32), tlayers.LayerNorm(D)
  elif name == "Dense":
    jmod = jlayers.Dense(48, parallel="none", dtype=jnp.float32)
    tmod = tlayers.Dense(D, 48)
  elif name == "MLP":
    jmod, tmod = jgpt.MLP(jcfg), tgpt.MLP(tcfg)
  else:
    jmod, tmod = jgpt.Block(jcfg), tgpt.Block(tcfg)
  x = np.random.RandomState(1).randn(2, 5, D).astype(np.float32)
  tree = _perturbed(_numpy_tree(
      jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), seed=2)
  want = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x)))
  got = _run_torch(tmod.to_empty(device="cpu"), tree, torch.from_numpy(x))
  np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_full_forward_matches_flax_fp32():
  jmodel, params, tmodel, tree = _gpt_pair(seed=3)
  ids = np.random.RandomState(4).randint(0, 64, (2, 11)).astype(np.int32)
  want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
  got = _run_torch(tmodel, tree, torch.from_numpy(ids).long())
  np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_full_forward_matches_flax_bf16():
  """bf16 compute over fp32 params.  The frameworks round to bf16 at
  other places (XLA fuses elementwise chains, torch rounds each op, and
  the matmuls accumulate in other orders), so the logits agree to bf16
  resolution only: atol 2e-2."""
  jmodel, params, tmodel, tree = _gpt_pair(seed=5, dtype="bfloat16")
  ids = np.random.RandomState(6).randint(0, 64, (2, 9)).astype(np.int32)
  want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)),
                    np.float32)
  got = _run_torch(tmodel, tree, torch.from_numpy(ids).long())
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


def test_paged_step_logits_matches_jax():
  """One flat step: a decode token, a prefill chunk, a second slot's
  chunk and two padding tokens, against pools pre-filled with seeded
  K/V.  Logits and the written pools match."""
  jmodel, params, tmodel, tree = _gpt_pair(seed=7)
  jcfg, _ = _configs()
  NB, bs, MB = 25, 4, 8
  r = np.random.RandomState(8)
  kv = jax.tree_util.tree_map(
      lambda a: r.randn(*a.shape).astype(np.float32),
      jax.device_get(jax_allocate_paged(jcfg, NB, bs)))
  tables = np.zeros((3, MB), np.int32)
  tables[:, :4] = 1 + r.permutation(NB - 1)[:12].reshape(3, 4)
  tokens = r.randint(0, 64, (9,)).astype(np.int32)
  slot_ids = np.array([0, 1, 1, 1, 1, 2, 2, 0, 0], np.int32)
  positions = np.array([9, 0, 1, 2, 3, 5, 6, 0, 0], np.int32)
  valid = np.array([True] * 7 + [False] * 2)
  want_logits, want_kv = jgpt.paged_step_logits(
      jmodel, params, jax.tree_util.tree_map(jnp.asarray, kv),
      jnp.asarray(tokens), jnp.asarray(slot_ids),
      jnp.asarray(positions), jnp.asarray(valid), jnp.asarray(tables))
  tkv = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), kv)
  with torch.no_grad():
    got_logits, got_kv = tgpt.paged_step_logits(
        tmodel, from_jax_params(tree, device="cpu"), tkv,
        *[torch.from_numpy(a) for a in (tokens, slot_ids, positions, valid,
                                        tables)])
  np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                             atol=ATOL, rtol=0)
  for i in range(jcfg.num_layers):
    for leaf in ("cached_key", "cached_value"):
      np.testing.assert_allclose(
          got_kv[f"block_{i}"]["attn"][leaf].numpy(),
          np.asarray(want_kv[f"block_{i}"]["attn"][leaf]), atol=ATOL,
          rtol=0)


def test_from_jax_params_round_trip():
  """Every JAX leaf lands under the mapped name with the same values
  (Dense kernels transposed), and the names are exactly the port
  model's parameters."""
  _, _, tmodel, tree = _gpt_pair(seed=9)
  state = from_jax_params(tree, device="cpu")
  assert set(state) == {n for n, _ in tmodel.named_parameters()}
  leaves = jax.tree_util.tree_leaves_with_path(tree)
  assert len(leaves) == len(state)
  for path, arr in leaves:
    keys = [p.key for p in path]
    name = ".".join(keys[:-1] + (
        ["weight"] if keys[-1] in ("kernel", "embedding", "scale")
        else keys[-1:]))
    back = state[name].numpy()
    np.testing.assert_array_equal(back.T if keys[-1] == "kernel" else back,
                                  arr)


def test_init_params_shapes_and_statistics():
  """``init_params`` draws the JAX package's initialiser families: every
  parameter of the model, fp32, LayerNorms at ones/zeros, Dense kernels
  at variance 1/fan_in, embeddings at stddev 0.02; a seed repeats."""
  cfg = tgpt.GPTConfig(**{**TINY, "d_model": 64, "d_ff": 256})
  params = init_params(cfg, seed=0, device="cpu")
  shapes = {n: p.shape for n, p in tgpt.GPT(cfg).named_parameters()}
  assert {n: p.shape for n, p in params.items()} == shapes
  assert torch.equal(params["ln_f.weight"], torch.ones(64))
  assert torch.equal(params["block_0.mlp.wi.bias"], torch.zeros(256))
  wi = params["block_1.mlp.wi.weight"]
  assert abs(wi.var().item() * 64 - 1.0) < 0.1
  assert wi.abs().max().item() <= 2.0 / 0.87962566103423978 / 8 + 1e-6
  assert abs(params["wte.weight"].std().item() - 0.02) < 2e-3
  again = init_params(cfg, seed=0, device="cpu")
  assert all(torch.equal(params[n], again[n]) for n in params)
