"""amp O1 and the fp16 plain versions: the port against the JAX package.

The dtype policy, the loss-scale state machine, the finite checks and
``scaled_value_and_grad`` against ``easyparallellibrary_tpu.runtime.amp``
on the same inputs; the GPT forward and a few training steps under
``amp.level = "O1"`` against the flax GPT under the same config (JAX
parameters bridged with ``weights.from_jax_params``); the serving caches'
dtype under O1; and the fp16 plain versions of the attention kernels
against the fp32 ones.  Tolerances are stated at each test.
"""

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
from easyparallellibrary_tpu.runtime import amp as jamp
from easyparallellibrary_tpu.serving import kv_cache as jkv
from easyparallellibrary_tpu_torch.kernels import flash_attention as tfa
from easyparallellibrary_tpu_torch.kernels import paged_attention as tpa
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.parallel import api as tapi
from easyparallellibrary_tpu_torch.runtime import amp as tamp
from easyparallellibrary_tpu_torch.serving import (
    ContinuousBatchingEngine, Request)
from easyparallellibrary_tpu_torch.weights import from_jax_params

# Tiny shapes: one intra-op thread leaves the cores to the suite's other
# worker processes.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
AMP = {"": {}, "O1-bf16": {"amp.level": "O1", "amp.compute_dtype": "bf16"},
       "O1-fp16": {"amp.level": "O1", "amp.compute_dtype": "fp16"}}


@pytest.fixture(autouse=True)
def _reset_envs():
  yield
  tepl.Env.get().reset()
  jepl.Env.get().reset()


def _set_amp(name):
  """The same amp settings in both packages' ambient config."""
  jepl.Env.get().reset(jepl.Config(AMP[name]))
  tepl.Env.get().reset(tepl.Config(AMP[name]))


def _numpy_tree(params):
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def _dtype_name(dtype: torch.dtype) -> str:
  """``torch.float16`` -> ``"float16"``, numpy's name for the type."""
  return str(dtype).replace("torch.", "")


# ----------------------------------------------------- policy functions --


@pytest.mark.parametrize("name", sorted(AMP))
def test_policy_and_resolved_dtypes_match_jax(name):
  _set_amp(name)
  want = jamp.policy_from_config()
  got = tamp.policy_from_config()
  assert (got is None) == (want is None)
  if want is not None:
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
      assert _dtype_name(getattr(got, field)) == np.dtype(
          getattr(want, field)).name, field
  jcfg = jamp.resolve_model_dtypes(jgpt.GPTConfig(**TINY, dtype=jnp.float32))
  tcfg = tamp.resolve_model_dtypes(tgpt.GPTConfig(**TINY,
                                                  dtype=torch.float32))
  assert _dtype_name(tcfg.dtype) == np.dtype(jcfg.dtype).name
  assert _dtype_name(tcfg.param_dtype) == np.dtype(jcfg.param_dtype).name
  # An object without a dtype field passes through both.
  assert tamp.resolve_model_dtypes("cfg") == jamp.resolve_model_dtypes("cfg")


def test_policy_wrap_apply_casts_around_the_call():
  _set_amp("O1-fp16")
  policy = tamp.policy_from_config()
  seen = {}

  def fn(params, x, ids):
    seen.update(w=params["w"].dtype, x=x.dtype, ids=ids.dtype)
    return {"y": x * params["w"], "n": ids}

  out = policy.wrap_apply(fn)({"w": torch.ones(3)}, torch.ones(3),
                              torch.arange(3))
  assert seen == dict(w=torch.float16, x=torch.float16, ids=torch.int64)
  assert out["y"].dtype == torch.float32 and out["n"].dtype == torch.int64


@pytest.mark.parametrize("kind", ["dynamic_high", "dynamic_low", "fixed"])
def test_loss_scale_state_matches_jax(kind):
  """A finite / non-finite pattern that crosses the growth interval
  (3) three times: from 2^22 the third growth clips at 2^24, from 2.0
  the backoffs clip at 1.0.  Scale and counter equal JAX's at every
  step."""
  if kind == "fixed":
    want, got = jamp.fixed_loss_scale(128.0), tamp.fixed_loss_scale(128.0)
  else:
    init = 2.0 ** 22 if kind == "dynamic_high" else 2.0
    want = jamp.DynamicLossScale.create(init, growth_interval=3)
    got = tamp.DynamicLossScale.create(init, growth_interval=3)
  pattern = ([True] * 10 + [False] * 3 + [True] * 4 + [False]
             + [True] * 3)
  if kind == "dynamic_low":
    pattern = [False] * 3 + pattern
  seen = set()
  for step, finite in enumerate(pattern):
    want = want.update(jnp.asarray(finite))
    got = got.update(torch.tensor(finite))
    assert got.scale.dtype == torch.float32
    assert got.counter.dtype == torch.int32
    assert float(got.scale) == float(want.scale), step
    assert int(got.counter) == int(want.counter), step
    seen.add(float(got.scale))
  if kind == "dynamic_high":
    assert max(seen) == 2.0 ** 24
  elif kind == "dynamic_low":
    assert min(seen) == 1.0
  else:
    assert seen == {128.0}


def test_all_finite_and_nonfinite_report_match_jax():
  r = np.random.RandomState(0)
  tree = {"block_0": {"w": r.randn(3, 4).astype(np.float32),
                      "b": r.randn(4).astype(np.float32)},
          "ids": np.arange(5, dtype=np.int32),
          "wte": r.randn(6, 2).astype(np.float32)}
  bad = jax.tree_util.tree_map(np.copy, tree)
  bad["block_0"]["w"][1, 2] = np.inf
  bad["wte"][[0, 3], 1] = np.nan
  for t in (tree, bad):
    jt = jax.tree_util.tree_map(jnp.asarray, t)
    tt = jax.tree_util.tree_map(torch.from_numpy, t)
    assert bool(tamp.all_finite(tt)) == bool(jamp.all_finite(jt))
    assert tamp.nonfinite_report(tt) == jamp.nonfinite_report(jt)
  assert tamp.nonfinite_report(jax.tree_util.tree_map(
      torch.from_numpy, bad)) == {"block_0/w": 1, "wte": 2}
  assert bool(tamp.all_finite({"ids": torch.arange(3)}))


def test_scaled_value_and_grad_matches_jax_on_gpt_loss():
  """gpt_loss on TINY fp32 (dense attention) with a 2^10 loss scale:
  the unscaled loss within 1e-6 and the unscaled gradients within the
  fp32 tolerance of the port's gpt_loss test (rtol 1e-4, atol 1e-6) of
  JAX's ``scaled_value_and_grad``."""
  jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
  jmodel = jgpt.GPT(jcfg)
  ids = np.random.RandomState(1).randint(0, 64, (2, 17))
  params = jmodel.init(jax.random.PRNGKey(0),
                       jnp.asarray(ids[:, :-1]))["params"]
  (jloss, _), jgrads = jamp.scaled_value_and_grad(
      lambda p: jgpt.gpt_loss(jmodel, p, {"ids": jnp.asarray(ids)}),
      jnp.float32(1024.0))(params)
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  (tloss, _), tgrads = tamp.scaled_value_and_grad(
      lambda p: tgpt.gpt_loss(tmodel, p, {"ids": torch.from_numpy(ids)}),
      torch.tensor(1024.0))(from_jax_params(_numpy_tree(params),
                                            device="cpu"))
  np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
  want = from_jax_params(_numpy_tree(jgrads), device="cpu")
  assert tgrads.keys() == want.keys()
  for name, g in tgrads.items():
    np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                               atol=1e-6, err_msg=name)


def test_scaled_value_and_grad_keeps_inf_and_nan():
  """A gradient that overflows stays inf after unscaling, and a NaN
  stays NaN, as in JAX, so the finite check sees them."""
  x = np.array([1.0, np.inf, 2.0, np.nan], np.float32)
  w = np.ones(4, np.float32)
  _, jg = jamp.scaled_value_and_grad(
      lambda p: ((p["w"] * jnp.asarray(x)).sum(), {}),
      jnp.float32(8.0))({"w": jnp.asarray(w)})
  _, tg = tamp.scaled_value_and_grad(
      lambda p: ((p["w"] * torch.from_numpy(x)).sum(), {}),
      torch.tensor(8.0))({"w": torch.from_numpy(w)})
  np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
  assert np.isinf(tg["w"][1].item()) and np.isnan(tg["w"][3].item())
  assert not bool(tamp.all_finite(tg))


# --------------------------------------------------------- O1 in the GPT --


@pytest.mark.parametrize("name,dtype,atol", [
    ("O1-bf16", torch.bfloat16, 2e-2), ("O1-fp16", torch.float16, 3e-3)])
def test_gpt_forward_under_o1_matches_jax(name, dtype, atol):
  """An fp32 GPTConfig under amp O1 computes in the policy's dtype on
  both sides.  The frameworks round at other places (XLA fuses
  elementwise chains, torch rounds each op), so the logits agree to the
  compute dtype's resolution: atol 2e-2 in bf16 (as the explicit-bf16
  forward test), 3e-3 in fp16 (three more mantissa bits)."""
  _set_amp(name)
  jmodel = jgpt.GPT(jgpt.GPTConfig(**TINY, dtype=jnp.float32))
  params = jmodel.init(jax.random.PRNGKey(3),
                       jnp.zeros((1, 4), jnp.int32))["params"]
  ids = np.random.RandomState(4).randint(0, 64, (2, 11)).astype(np.int32)
  want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  with torch.no_grad():
    got = torch.func.functional_call(
        tmodel, from_jax_params(_numpy_tree(params), device="cpu"),
        (torch.from_numpy(ids).long(),))
  assert got.dtype == dtype and str(want.dtype) == str(dtype)[6:]
  np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                             atol=atol, rtol=0)


def _jax_o1_trajectory(ids, steps):
  jepl.init(jepl.Config(AMP["O1-bf16"]), devices=jax.devices()[:1])
  with jepl.replicate(1):
    model = jgpt.GPT(jgpt.GPTConfig(**TINY, dtype=jnp.float32))
  mesh = jepl.current_plan().build_mesh()
  batch = {"ids": jnp.asarray(ids)}
  tx = optax.adamw(3e-4, weight_decay=0.01)

  def init_fn(r):
    from flax.training import train_state
    return train_state.TrainState.create(
        apply_fn=model.apply,
        params=model.init(r, batch["ids"][:, :-1])["params"], tx=tx)

  state, shardings = japi.create_sharded_train_state(
      init_fn, mesh, jax.random.PRNGKey(0))
  params0 = _numpy_tree(state.params)
  step = japi.parallelize(
      japi.make_train_step(lambda p, b, r: jgpt.gpt_loss(model, p, b, r)),
      mesh, shardings)
  losses = []
  for _ in range(steps):
    state, metrics = step(state, batch, jax.random.PRNGKey(0))
    losses.append(float(metrics["loss"]))
  return params0, losses


def _torch_trajectory(config, dtype, params0, ids, steps):
  tepl.init(config, device="cpu")
  with tepl.replicate(1):
    model = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=dtype))
  mesh = tepl.current_plan().build_mesh()
  tx = tadamw.adamw(3e-4, weight_decay=0.01)

  def init_fn(_seed):
    return tapi.TrainState.create(
        apply_fn=model, params=from_jax_params(params0, device="cpu"), tx=tx)

  state, shardings = tapi.create_sharded_train_state(init_fn, mesh, 0)
  step = tapi.parallelize(
      tapi.make_train_step(lambda p, b, r: tgpt.gpt_loss(model, p, b, r)),
      mesh, shardings)
  losses = []
  for _ in range(steps):
    state, metrics = step(state, {"ids": torch.from_numpy(ids)}, None)
    losses.append(metrics["loss"].item())
  return losses


def test_train_steps_under_o1_bf16():
  """4 AdamW steps of an fp32 GPTConfig under O1 bf16: the port's losses
  equal those of its explicit-bf16 config bit for bit (O1 is that dtype
  and nothing else), and lie within bf16 resolution of JAX's under O1
  (rtol 2e-2: bf16 rounds at other places in the two frameworks, see
  the forward test)."""
  ids = np.random.RandomState(0).randint(0, 64, (4, 17))
  params0, want = _jax_o1_trajectory(ids, 4)
  got = _torch_trajectory(tepl.Config(AMP["O1-bf16"]), torch.float32,
                          params0, ids, 4)
  explicit = _torch_trajectory(tepl.Config(), torch.bfloat16, params0, ids,
                               4)
  assert got == explicit
  np.testing.assert_allclose(got, want, rtol=2e-2)
  assert got[-1] < got[0]


def test_serving_caches_stay_in_the_model_config_dtype_under_o1():
  """Under O1 the engine computes in the policy's dtype (its parameter
  copy is cast to it) while the slot cache keeps the model config's
  dtype, as the JAX package allocates it (kv_cache.allocate_kv_cache
  from the unresolved config), and the engine still serves."""
  _set_amp("O1-fp16")
  jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
  jcache, _ = jkv.allocate_kv_cache(jcfg, 2, 4)
  want = np.dtype(jcache["block_0"]["attn"]["cached_key"].dtype).name
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  model, params = tiny_gpt(device="cpu")
  eng = ContinuousBatchingEngine(model, params, device="cpu", num_slots=2,
                                 prefill_chunk=4)
  assert eng.compute_dtype == torch.float16
  assert eng.params["block_0.attn.qkv.weight"].dtype == torch.float16
  assert eng.params["block_0.ln1.weight"].dtype == torch.float32
  cache = eng._kv["block_0"]["attn"]["cached_key"]
  assert _dtype_name(cache.dtype) == want == "float32"
  eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                     max_new_tokens=4))
  out = eng.run()[0]
  assert out.shape == (9,) and (out >= 0).all() and (out < 64).all()


@pytest.mark.parametrize("seed", range(3))
def test_o1_fp16_paged_engine_over_bf16_config_equals_jax(seed):
  """amp O1 in fp16 over a bf16 GPTConfig on the paged engine: fp16
  queries over the bf16 pools, which on the card is the mixed CUDA build
  and here the plain version, promoting to fp32 as JAX's reference does.
  Greedy streams are token-equal to the JAX paged engine
  under the same config."""
  from easyparallellibrary_tpu.serving import (
      ContinuousBatchingEngine as JaxEngine, Request as JaxRequest)
  _set_amp("O1-fp16")
  jmodel = jgpt.GPT(jgpt.GPTConfig(**TINY, dtype=jnp.bfloat16))
  jparams = jmodel.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.bfloat16))
  tparams = from_jax_params(_numpy_tree(jparams), device="cpu")
  r = np.random.RandomState(seed)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32)
             for n in (5, 3, 9, 1, 6, 2)]
  knobs = dict(num_slots=3, prefill_chunk=8, paged=True, block_size=4)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **knobs)
  jeng = JaxEngine(jmodel, jparams, **knobs)
  assert eng.compute_dtype == torch.float16
  assert eng._kv["block_0"]["attn"]["cached_key"].dtype == torch.bfloat16
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
    jeng.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=8))
  got, want = eng.run(), jeng.run()
  for i in range(len(prompts)):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")


# ------------------------------------------------ fp16 plain versions --


def _normalized(got, want):
  d = got.float() - want.float()
  return ((d.norm() / want.float().norm()).item(),
          (d.abs().max() / want.float().abs().max()).item())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_fp16_plain_versions_match_fp32(causal):
  """fp16 inputs carry 11 significant bits, so the fp16 plain versions
  agree with the fp32 ones on the same values to about 2^-11 of the
  output scale: normalized error (||d|| / ||want||) within 2e-3."""
  r = np.random.RandomState(5)
  q, k, v, dout = [torch.from_numpy(r.randn(2, 3, 40, 16).astype(
      np.float32)).half() for _ in range(4)]
  q32, k32, v32, do32 = [x.float() for x in (q, k, v, dout)]
  out, lse = tfa.flash_fwd_reference(q, k, v, causal)
  want_out, want_lse = tfa.flash_fwd_reference(q32, k32, v32, causal)
  assert out.dtype == torch.float16 and lse.dtype == torch.float32
  assert _normalized(out, want_out)[0] < 2e-3
  torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
  delta = (do32 * want_out).sum(-1)
  got = tfa.flash_bwd_dkv_reference(q, k, v, dout, want_lse, delta, causal)
  got += (tfa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                     causal),)
  want = tfa.flash_bwd_dkv_reference(q32, k32, v32, do32, want_lse, delta,
                                     causal)
  want += (tfa.flash_bwd_dq_reference(q32, k32, v32, do32, want_lse, delta,
                                      causal),)
  for name, g, w in zip(("dk", "dv", "dq"), got, want):
    assert g.dtype == torch.float16, name
    assert _normalized(g, w)[0] < 2e-3, name


def test_paged_fp16_plain_version_matches_fp32_and_promotes():
  """The paged plain version in fp16 against fp32 on the same values
  (normalized error within 2e-3), and with an fp16 query over fp32 pools
  (amp O1 over an fp32 model config) in the promoted type: within 2e-3
  of the fp32 call, and returned in that type as ``jnp.einsum`` returns
  it (the model casts it back to the compute dtype)."""
  r = np.random.RandomState(6)
  T, H, hd, NB, bs, MB = 6, 2, 16, 7, 4, 3
  q, kp, vp = [torch.from_numpy(r.randn(*s).astype(np.float32)).half()
               for s in ((T, H, hd), (NB, bs, H, hd), (NB, bs, H, hd))]
  tables = torch.from_numpy(r.randint(0, NB, (T, MB)).astype(np.int32))
  pos = torch.from_numpy(r.randint(0, MB * bs, (T,)).astype(np.int32))
  want = tpa.paged_attention_reference(q.float(), kp.float(), vp.float(),
                                       tables, pos)
  got = tpa.paged_attention(q, kp, vp, tables, pos)
  assert got.dtype == torch.float16
  assert _normalized(got, want)[0] < 2e-3
  mixed = tpa.paged_attention(q, kp.float(), vp.float(), tables, pos)
  assert mixed.dtype == torch.float32
  assert _normalized(mixed, want)[0] < 2e-3
