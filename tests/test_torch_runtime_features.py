"""The port's runtime features against the JAX package's: gradient
accumulation, the grouped optimizer apply, gradient checkpointing, the
fp16 loss scale with the anomaly sentinel, dropout in training mode, the
step profiler and the helpers they share.

The model of ``tests/test_runtime_features.py`` (Dense(16) -> tanh ->
Dense(1) on [16, 8] inputs) with the JAX package's initialised
parameters on both sides.  Dropout masks come from different generators
in the two frameworks, so dropout is held by its statistics.
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
from easyparallellibrary_tpu import ops as jops
from easyparallellibrary_tpu.observability.registry import (
    split_namespaces as jsplit)
from easyparallellibrary_tpu.parallel.partitioner import (
    partition_balance as jbalance)
from easyparallellibrary_tpu.profiler.profiler import (
    StepProfiler as JProfiler)
from easyparallellibrary_tpu.runtime import gc as jgc
from easyparallellibrary_tpu.runtime import trainer as jtrainer
from easyparallellibrary_tpu.runtime.gradient_accumulation import (
    accumulate_gradients as jaccumulate)
from easyparallellibrary_tpu.testing import chaos as jchaos
from easyparallellibrary_tpu.utils import pytree as jpytree
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.observability.registry import (
    split_namespaces as tsplit)
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.ops.layers import Dense
from easyparallellibrary_tpu_torch.parallel.partitioner import (
    partition_balance as tbalance)
from easyparallellibrary_tpu_torch.profiler import profiler as tprofiler
from easyparallellibrary_tpu_torch.runtime import gc as tgc
from easyparallellibrary_tpu_torch.runtime import trainer as ttrainer
from easyparallellibrary_tpu_torch.runtime.gradient_accumulation import (
    accumulate_gradients, backward_fn, fold_rng)
from easyparallellibrary_tpu_torch.runtime.optimizer_helper import (
    apply_grad_group, group_leaves)
from easyparallellibrary_tpu_torch.testing import chaos
from easyparallellibrary_tpu_torch.utils import prng
from easyparallellibrary_tpu_torch.utils import pytree as tpytree
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_port_env():
  yield
  tepl.Env.get().reset()


class JNet(nn.Module):
  @nn.compact
  def __call__(self, x):
    return jops.Dense(1, parallel="none")(jnp.tanh(
        jops.Dense(16, parallel="none")(x)))


class TNet(torch.nn.Module):
  """JNet under flax's names (the outer Dense is built first)."""

  def __init__(self):
    super().__init__()
    self.add_module("Dense_0", Dense(16, 1, device="meta"))
    self.add_module("Dense_1", Dense(8, 16, device="meta"))

  def forward(self, x):
    return getattr(self, "Dense_0")(torch.tanh(getattr(self, "Dense_1")(x)))


def _data():
  r = np.random.RandomState(0)
  return {"x": r.randn(16, 8).astype(np.float32),
          "y": r.randn(16, 1).astype(np.float32)}


def _jparams():
  return JNet().init(jax.random.PRNGKey(0), jnp.zeros((16, 8)))["params"]


def _jloss(p, b, rng):
  return jnp.mean((JNet().apply({"params": p}, b["x"]) - b["y"]) ** 2), {}


_TNET = TNet()


def _tloss(p, b, rng):
  pred = torch.func.functional_call(_TNET, p, (torch.as_tensor(b["x"]),))
  return torch.mean((pred - torch.as_tensor(b["y"])) ** 2), {}


def _tparams():
  return {n: v.requires_grad_(True) for n, v in from_jax_params(
      jax.tree_util.tree_map(np.asarray, nn.meta.unbox(_jparams())),
      device="cpu").items()}


def _tgrads(params):
  return {n: p.grad.clone() for n, p in params.items()}


# ------------------------------------------------- gradient accumulation --


def test_gradient_accumulation_matches_full_batch_and_jax():
  batch = _data()
  params = _tparams()
  l_full, _ = backward_fn(_tloss)(params, batch, None)
  g_full = _tgrads(params)
  for p in params.values():
    p.grad = None
  l_ga, _ = accumulate_gradients(backward_fn(_tloss), 4)(params, batch, None)
  g_ga = _tgrads(params)
  np.testing.assert_allclose(float(l_full), float(l_ga), rtol=1e-6)
  for n in g_full:
    np.testing.assert_allclose(g_full[n].numpy(), g_ga[n].numpy(),
                               rtol=1e-5, atol=1e-7, err_msg=n)
  (jl, _), jg = jaccumulate(jax.value_and_grad(_jloss, has_aux=True), 4)(
      _jparams(), jax.tree_util.tree_map(jnp.asarray, batch), None)
  want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                nn.meta.unbox(jg)),
                         device="cpu")
  np.testing.assert_allclose(float(l_ga), float(jl), rtol=1e-6)
  for n in want:
    np.testing.assert_allclose(g_ga[n].numpy(), want[n].numpy(), rtol=1e-5,
                               atol=1e-7, err_msg=n)


def test_ga_aux_includes_every_micro_batch():
  batch = _data()

  def with_aux(p, b, rng):
    loss, _ = _tloss(p, b, rng)
    return loss, {"x_mean": torch.as_tensor(b["x"]).mean()}

  params = _tparams()
  _, aux_full = backward_fn(with_aux)(params, batch, None)
  _, aux_ga = accumulate_gradients(backward_fn(with_aux), 4)(params, batch,
                                                             None)

  def jwith_aux(p, b, rng):
    loss, _ = _jloss(p, b, rng)
    return loss, {"x_mean": jnp.mean(b["x"])}

  (_, jaux), _ = jaccumulate(jax.value_and_grad(jwith_aux, has_aux=True), 4)(
      _jparams(), jax.tree_util.tree_map(jnp.asarray, batch), None)
  np.testing.assert_allclose(float(aux_full["x_mean"]),
                             float(aux_ga["x_mean"]), rtol=1e-6)
  np.testing.assert_allclose(float(aux_ga["x_mean"]), float(jaux["x_mean"]),
                             rtol=1e-6)


def test_ga_rng_differs_per_micro_batch():
  """Micro-batch ``i`` sees ``rng`` folded with ``i``: the averaged draw
  is the mean of four distinct draws, not one draw four times."""
  rng = prng.prng_key(42)
  seen = []

  def grad_fn(p, b, key, weight=1.0):
    seen.append(np.asarray(key).tolist())
    noise = prng.uniform(torch.as_tensor(
        np.stack([prng.host_fold_in(key, j) for j in range(4)])
        .astype(np.int64)))
    return torch.zeros(()), {"noise": noise}

  _, aux = accumulate_gradients(grad_fn, 4)(None, {"x": np.zeros((8, 2))},
                                            rng)
  keys = [fold_rng(rng, i) for i in range(4)]
  assert seen == [k.tolist() for k in keys]
  assert len({tuple(k) for k in seen}) == 4
  draws = [prng.uniform(torch.as_tensor(np.stack(
      [prng.host_fold_in(k, j) for j in range(4)]).astype(np.int64)))
      for k in keys]
  np.testing.assert_allclose(aux["noise"].numpy(),
                             torch.stack(draws).mean(0).numpy(), rtol=1e-6)
  assert not np.allclose(aux["noise"].numpy(), draws[0].numpy())


def test_ga_config_driven_training_matches_full_batch_and_jax():
  batch = _data()

  def port_run(cfg):
    tepl.init(tepl.Config(cfg), device="cpu")
    state = ttrainer.create_train_state(_TNET, _tparams(),
                                        tadamw.adamw(1e-2, weight_decay=0))
    step = ttrainer.build_train_step(_tloss)
    losses = []
    for _ in range(5):
      state, m = step(state, batch, None)
      losses.append(float(m["loss"]))
    return losses

  def jax_run(cfg):
    jepl.init(jepl.Config(cfg))
    state = jtrainer.create_train_state(JNet().apply, _jparams(),
                                        optax.adam(1e-2))
    step = jtrainer.build_train_step(_jloss)
    losses = []
    for _ in range(5):
      state, m = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                      None)
      losses.append(float(m["loss"]))
    return losses

  ga = port_run({"pipeline.num_micro_batch": 4})
  np.testing.assert_allclose(ga, port_run({}), rtol=1e-5)
  np.testing.assert_allclose(ga, jax_run({"pipeline.num_micro_batch": 4}),
                             rtol=2e-5)


# ------------------------------------------------------ grouped apply --


@pytest.mark.parametrize("fused", [None, True], ids=["foreach", "fused"])
@pytest.mark.parametrize("groups", [2, 3, 4, 100])
def test_grouped_apply_is_bit_equal_to_one_group(groups, fused):
  batch = _data()
  results = []
  for n in (1, groups):
    params = _tparams()
    opt = tadamw.adam_weight_decay_optimizer(1e-2).init(params, fused=fused)
    for _ in range(2):
      for p in params.values():
        p.grad = None
      backward_fn(_tloss)(params, batch, None)
      apply_grad_group(opt, params, n)
    results.append({name: [p.detach().clone()] + [
        v.clone() for _, v in sorted(opt.state[p].items())]
        for name, p in params.items()})
  for name in results[0]:
    for a, b in zip(results[0][name], results[1][name]):
      assert torch.equal(a, b), (name, groups)


def test_grouping_follows_partition_balance_as_jax():
  for weights, parts in (([1, 1, 1, 1], 2), ([1, 2, 3, 4, 5, 6], 3),
                         ([10, 1, 1, 1, 1, 10], 3), ([5.0] * 7, 7),
                         ([1, 100, 1, 1, 1], 2)):
    assert tbalance(weights, parts) == jbalance(weights, parts)
  params = {f"w{i}": torch.zeros(4 * (i + 1)) for i in range(6)}
  groups = group_leaves(params, 3)
  assert [len(g) for g in groups] == [
      e - s for s, e in jbalance([16.0 * (i + 1) for i in range(6)], 3)]
  assert group_leaves(params, 10) == [[n] for n in params]


# ------------------------------------------------- gradient checkpoints --


@pytest.mark.parametrize("gc_type", ["collection", "auto", ""])
def test_gc_policies_grads_match_plain_and_jax(gc_type):
  tepl.init(tepl.Config({"gradient_checkpoint.type": gc_type,
                         "gradient_checkpoint.check_gradients": True}),
            device="cpu")
  jepl.init(jepl.Config({"gradient_checkpoint.type": gc_type}))
  r = np.random.RandomState(1)
  w, x = r.randn(8, 8).astype(np.float32), r.randn(4, 8).astype(np.float32)

  def tf(p):
    h = torch.tanh(torch.as_tensor(x) @ p["w"])
    h = tgc.mark_checkpoint(h)
    return (h @ p["w"]).pow(2).sum()

  def jf(p):
    h = jnp.tanh(jnp.asarray(x) @ p["w"])
    h = jgc.mark_checkpoint(h)
    return jnp.sum((h @ p["w"]) ** 2)

  tp = {"w": torch.from_numpy(w).requires_grad_(True)}
  got = tgc.gradients(tf)(tp)["w"]
  plain = torch.autograd.grad(tf(tp), [tp["w"]])[0]
  want = jgc.gradients(jf)({"w": jnp.asarray(w)})["w"]
  np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-6)


def test_gc_gradients_with_aux_and_the_collection_policy_saves_the_tag():
  """``has_aux`` returns (grads, aux); under the collection policy the
  tagged value is saved, so the recompute in the backward does not run
  the op that made it (counted by a custom-op-free hook: the function
  body's forward count)."""
  tepl.init(tepl.Config({"gradient_checkpoint.type": "collection"}),
            device="cpu")
  p = {"w": torch.randn(4, 4, requires_grad=True)}
  g, aux = tgc.gradients(lambda q: ((q["w"] * 2).sum(), {"n": 1}),
                         has_aux=True)(p)
  assert aux == {"n": 1}
  torch.testing.assert_close(g["w"], torch.full((4, 4), 2.0))
  x = torch.randn(3, requires_grad=True)
  y = tgc.mark_checkpoint(x * 3, "mine")
  assert torch.equal(y, x.detach() * 3)
  (gx,) = torch.autograd.grad(y.sum(), [x])
  torch.testing.assert_close(gx, torch.full((3,), 3.0))
  assert tgc.policy_for("") is None and tgc.policy_for("auto") is not None


def test_auto_checkpoint_segments_match_jax():
  for costs, n in (([1.0] * 16, 0), ([1, 1, 100, 1, 1, 1], 2), ([], 0),
                   ([3, 1, 4, 1, 5, 9, 2, 6], 3), ([1.0] * 5, 9)):
    assert tgc.auto_checkpoint_segments(costs, n) == \
        jgc.auto_checkpoint_segments(costs, n)
  segs = tgc.auto_checkpoint_segments([1.0] * 16)
  assert segs[0] == 0 and len(segs) == 4


# ------------------------------------------ loss scale with the sentinel --


def test_fp16_loss_scale_composes_with_the_sentinel_as_jax():
  """fp16 amp + sentinel: the dynamic scale keeps its own backoff, the
  sentinel counts; the metrics equal the JAX trainer's on the same
  clean / NaN / clean schedule."""
  cfg = {"amp": {"level": "O1", "compute_dtype": "fp16",
                 "loss_scale": "dynamic"},
         "resilience": {"sentinel": True}}
  jepl.init(jepl.Config(cfg))
  jstate = jtrainer.create_train_state(JNet().apply, _jparams(),
                                       optax.adam(1e-2))
  jstep = jax.jit(jtrainer.build_train_step(_jloss))
  tepl.init(tepl.Config(cfg), device="cpu")
  tstate = ttrainer.create_train_state(_TNET, _tparams(),
                                       tadamw.adamw(1e-2, weight_decay=0))
  assert tstate.sentinel is not None and tstate.loss_scale is not None
  tstep = ttrainer.build_train_step(_tloss)
  for b in (_data(), jchaos.nan_batch(_data()), _data()):
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b),
                       jax.random.PRNGKey(0))
    tstate, tm = tstep(tstate, chaos.nan_batch(b) if np.isnan(
        b["x"]).any() else b, None)
    for k in ("bad_steps", "bad_steps_total", "update_skipped",
              "grads_finite", "loss_scale"):
      assert float(tm[k]) == float(jm[k]), k
  assert int(tstate.step) == int(jstate.step) == 2
  assert all(torch.isfinite(p).all() for p in tstate.params.values())


def test_loss_scale_skip_on_overflow_is_a_true_noop():
  """An infinite loss under the dynamic scale: the scale halves, the step
  does not advance, the parameters and AdamW's moments (weight decay
  0.1) stay bit-identical."""
  tepl.init(tepl.Config({"amp.level": "O1", "amp.loss_scale": "dynamic"}),
            device="cpu")
  state = ttrainer.create_train_state(_TNET, _tparams(),
                                      tadamw.adamw(0.1, weight_decay=0.1))
  step = ttrainer.build_train_step(_tloss)
  state, _ = step(state, _data(), None)
  before = {n: [p.detach().clone()] + [v.clone() for _, v in sorted(
      state.opt_state.state[p].items())] for n, p in state.params.items()}
  s0, step0 = float(state.loss_scale.scale), int(state.step)

  def inf_loss(p, b, rng):
    return next(iter(p.values())).sum() * float("inf"), {}

  state, m = ttrainer.build_train_step(inf_loss)(state, _data(), None)
  assert float(m["grads_finite"]) == 0.0
  assert float(state.loss_scale.scale) == s0 / 2
  assert int(state.step) == step0
  for n, p in state.params.items():
    now = [p.detach()] + [v for _, v in sorted(
        state.opt_state.state[p].items())]
    assert all(torch.equal(a, b) for a, b in zip(now, before[n])), n


def test_guarded_step_refuses_an_unfused_optimizer():
  tepl.init(tepl.Config({"resilience.sentinel": True}), device="cpu")
  from easyparallellibrary_tpu_torch.parallel.api import TrainState
  from easyparallellibrary_tpu_torch.runtime import resilience
  state = resilience.attach_sentinel(TrainState.create(
      apply_fn=_TNET, params=_tparams(), tx=tadamw.adamw(1e-2)))
  with pytest.raises(ValueError, match="fused"):
    ttrainer.build_train_step(_tloss)(state, _data(), None)


# ------------------------------------------------------------ dropout --


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_statistics_match_jax(rate):
  """Over 2^20 elements the port's counter mask and flax's Dropout both
  drop within 3 sigma of ``rate`` and keep the mean (inputs scaled by
  1 / keep_prob); their drop rates agree within 6 sigma."""
  n = 1 << 20
  x = torch.ones(n)
  key = prng.prng_key(3)
  y = tgpt._dropout(x, key, rate)
  got_rate = float((y == 0).float().mean())
  jy = nn.Dropout(rate, deterministic=False).apply(
      {}, jnp.ones(n), rngs={"dropout": jax.random.PRNGKey(3)})
  want_rate = float(jnp.mean(jy == 0))
  sigma = (rate * (1 - rate) / n) ** 0.5
  assert abs(got_rate - rate) < 3 * sigma
  assert abs(want_rate - rate) < 3 * sigma
  assert abs(got_rate - want_rate) < 6 * sigma
  kept = y[y != 0]
  torch.testing.assert_close(kept, torch.full_like(kept, 1.0 / (1 - rate)))
  np.testing.assert_allclose(float(y.mean()), 1.0, atol=6 * sigma / (1 -
                                                                     rate))
  assert torch.equal(tgpt._dropout(x, key, rate), y)          # same key
  assert not torch.equal(tgpt._dropout(x, prng.prng_key(4), rate), y)


def test_dropout_in_gpt_loss_is_keyed_and_survives_remat():
  cfg = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=16, d_ff=32,
             max_seq_len=8, dtype=torch.float32, dropout_rate=0.1)
  from easyparallellibrary_tpu_torch.weights import init_params
  ids = {"ids": torch.from_numpy(
      np.random.RandomState(0).randint(0, 64, (2, 9)))}
  base = init_params(tgpt.GPTConfig(**cfg), 0, device="cpu")
  results = {}
  for remat in (False, True):
    model = tgpt.GPT(tgpt.GPTConfig(**cfg, remat=remat,
                                    remat_policy="dots"))
    params = {n: p.clone().requires_grad_(True) for n, p in base.items()}
    loss, _ = tgpt.gpt_loss(model, params, ids, prng.prng_key(1))
    loss.backward()
    results[remat] = (loss.item(),
                      {n: p.grad.clone() for n, p in params.items()})
  assert results[True][0] == results[False][0]
  for n, g in results[False][1].items():
    torch.testing.assert_close(results[True][1][n], g, rtol=1e-6, atol=1e-7)
  model = tgpt.GPT(tgpt.GPTConfig(**cfg))
  plain, _ = tgpt.gpt_loss(model, base, ids, None)           # no rng: off
  other, _ = tgpt.gpt_loss(model, base, ids, prng.prng_key(2))
  assert plain.item() != results[False][0] != other.item()
  with pytest.raises(ValueError, match="dropout_rng"):
    model(ids["ids"][:, :-1], deterministic=False)


# ------------------------------------------------ profiler and helpers --


def test_profile_step_is_not_ported():
  with pytest.raises(NotImplementedError,
                     match="'Other models and the tooling'"):
    tprofiler.profile_step(lambda: None)


def test_step_profiler_summary_and_namespaces_match_jax():
  t, j = tprofiler.StepProfiler(tokens_per_step=1024, warmup=1), \
      JProfiler(tokens_per_step=1024, warmup=1)
  for prof in (t, j):
    prof.times = [0.1, 0.3]
    prof.note_bad_step(2)
    prof.note_retry()
  assert t.summary() == j.summary()
  assert tsplit(t.summary()) == jsplit(j.summary())
  fresh = tprofiler.StepProfiler(warmup=2)
  for _ in range(4):
    fresh.tick()
  assert len(fresh.times) == 2


def test_pytree_helpers_match_jax():
  batch = {"x": np.arange(24, dtype=np.float32).reshape(8, 3),
           "y": np.arange(8, dtype=np.int32)}
  got = tpytree.split_micro_batches(
      {k: torch.from_numpy(v) for k, v in batch.items()}, 4)
  want = jpytree.split_micro_batches(batch, 4)
  for k in batch:
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
  with pytest.raises(ValueError, match="divisible"):
    tpytree.split_micro_batches(batch, 3)
  for leaf, tleaf in ((np.zeros((3, 5), np.float32), torch.zeros(3, 5)),
                      (np.zeros((2,), np.int32),
                       torch.zeros(2, dtype=torch.int32)),
                      (jnp.zeros((4, 4), jnp.bfloat16),
                       torch.zeros(4, 4, dtype=torch.bfloat16))):
    assert tpytree.leaf_bytes(tleaf) == jpytree.leaf_bytes(leaf)
    assert tpytree.leaf_bytes(leaf) == jpytree.leaf_bytes(leaf)


# ------------------------------------------------------- host offload --


def test_offload_fit_trajectory_matches_jax():
  """Host offload through ``fit`` against JAX ``fit``.  On the CPU host
  and device are one: ``offload.level = "v0"`` leaves the port's state
  as it is (``create_sharded_train_state`` does not wrap it), so the
  port's optimizer is then wrapped in ``HostOffloadOptimizer`` by hand,
  in buckets small enough for more than one.  Its 6-step loss
  trajectory equals JAX ``fit``'s at rtol 2e-5, and its final
  parameters at rtol 2e-5, atol 1e-7 (for entries near zero).  JAX's own
  v0 path does not run on the CPU (its pinned-host shardings fail in
  the jitted init: pinned here as the reference's behaviour), so JAX
  trains the same state without offload, which v0 must not change."""
  from easyparallellibrary_tpu.parallel import api as japi
  from easyparallellibrary_tpu.runtime import loop as jloop
  from easyparallellibrary_tpu_torch.parallel import api as tapi
  from easyparallellibrary_tpu_torch.runtime import loop as tloop
  from easyparallellibrary_tpu_torch.runtime import offload as toffload
  r = np.random.RandomState(3)
  batches = [{"x": r.randn(16, 8).astype(np.float32),
              "y": r.randn(16, 1).astype(np.float32)} for _ in range(6)]
  cfg = {"offload.level": "v0"}

  def recorded(step, losses):
    def wrapped(state, batch, rng):
      state, m = step(state, batch, rng)
      losses.append(m["loss"])
      return state, m
    return wrapped

  def jinit():
    return japi.TrainState.create(apply_fn=JNet().apply, params=_jparams(),
                                  tx=optax.adam(1e-2))

  jepl.init(jepl.Config(cfg))
  with pytest.raises(Exception, match="sharding"):
    japi.create_sharded_train_state(jinit, jepl.current_plan().build_mesh())
  jepl.init()
  jmesh = jepl.current_plan().build_mesh()
  jstate, jsh = japi.create_sharded_train_state(jinit, jmesh)
  jlosses = []
  jstate, _ = jloop.fit(
      recorded(japi.parallelize(japi.make_train_step(_jloss), jmesh, jsh),
               jlosses),
      jstate, [jax.tree_util.tree_map(jnp.asarray, b) for b in batches],
      num_steps=6, log_every=0)
  tepl.init(tepl.Config(cfg), device="cpu")
  tmesh = tepl.current_plan().build_mesh()
  tstate, tsh = tapi.create_sharded_train_state(
      lambda: tapi.TrainState.create(
          apply_fn=_TNET, params=_tparams(),
          tx=tadamw.adamw(1e-2, weight_decay=0.0)), tmesh)
  assert not isinstance(tstate.opt_state, toffload.HostOffloadOptimizer)
  tstate = tstate.replace(opt_state=toffload.HostOffloadOptimizer(
      tstate.opt_state, bucket_mb=0.0005))
  assert tstate.opt_state.num_buckets > 1
  tlosses = []
  tstate, _ = tloop.fit(
      recorded(tapi.parallelize(tapi.make_train_step(_tloss), tmesh, tsh),
               tlosses),
      tstate, batches, num_steps=6, log_every=0, device="cpu")
  assert isinstance(tstate.opt_state, toffload.HostOffloadOptimizer)
  assert int(tstate.step) == 6
  assert len(tlosses) == len(jlosses) == 6
  np.testing.assert_allclose([float(x) for x in tlosses],
                             [float(x) for x in jlosses], rtol=2e-5)
  want = from_jax_params(jax.tree_util.tree_map(
      np.asarray, nn.meta.unbox(jstate.params)), device="cpu")
  assert sorted(want) == sorted(tstate.params)
  for name, w in want.items():
    np.testing.assert_allclose(tstate.params[name].detach().numpy(),
                               w.numpy(), rtol=2e-5, atol=1e-7,
                               err_msg=name)
  with pytest.raises(ValueError, match="optimizer state only"):
    toffload.offload_to_host(tstate, what="params")


@pytest.mark.parametrize("bucket_mb", [0.0005, 0.001, 64.0],
                         ids=["largest-leaf", "two-leaves", "one-bucket"])
def test_host_offload_optimizer_is_bit_equal_to_no_offload(bucket_mb,
                                                           tmp_path):
  """``HostOffloadOptimizer`` streaming the moments through its two
  buffers (run on the CPU, where its copies are synchronous) against the
  same fused AdamW without it, through ``build_train_step`` with the
  sentinel (a NaN step skipped through ``found_inf``) and
  ``optimizer.num_apply_group = 2``: parameters, both moments and every
  step bit-equal after 5 steps; the saver's tree is the same, and a
  restore writes the moments into the host tensors in place."""
  from easyparallellibrary_tpu_torch.runtime import offload as toffload
  from easyparallellibrary_tpu_torch.runtime import saver as tsaver
  cfg = tepl.Config({"resilience.sentinel": True,
                     "optimizer.num_apply_group": 2})
  tepl.init(cfg, device="cpu")
  batch = _data()
  runs = []
  for offload in (False, True):
    state = ttrainer.create_train_state(
        _TNET, _tparams(), tadamw.adamw(1e-2, weight_decay=0.01),
        config=cfg)
    if offload:
      state = state.replace(opt_state=toffload.HostOffloadOptimizer(
          state.opt_state, bucket_mb=bucket_mb))
    step = ttrainer.build_train_step(_tloss, config=cfg)
    for i in range(5):
      state, m = step(state, chaos.nan_batch(batch) if i == 2 else batch,
                      None)
    runs.append(state)
  plain, off = runs
  assert (off.opt_state.num_buckets > 1) == (bucket_mb < 1)
  assert int(off.step) == int(plain.step) == 4
  for name in plain.params:
    p, q = plain.params[name], off.params[name]
    assert torch.equal(p, q), name
    for key in ("exp_avg", "exp_avg_sq", "step"):
      assert torch.equal(plain.opt_state.state[p][key],
                         off.opt_state.state[q][key]), (name, key)
  want, got = tsaver.state_tree(plain), tsaver.state_tree(off)
  for (pa, a), (pb, b) in zip(tpytree.tree_paths_and_leaves(want),
                              tpytree.tree_paths_and_leaves(got)):
    assert pa == pb and torch.equal(a, b), pa
  tsaver.save_checkpoint(str(tmp_path), want, step=4)
  hosts = {n: off.opt_state.state[p]["exp_avg"]
           for n, p in off.params.items()}
  for p in off.params.values():
    off.opt_state.state[p]["exp_avg"].zero_()
  off, rstep = tsaver.restore_train_state(str(tmp_path), off)
  assert rstep == 4
  for name, p in off.params.items():
    assert off.opt_state.state[p]["exp_avg"] is hosts[name]
    assert torch.equal(hosts[name],
                       plain.opt_state.state[plain.params[name]]["exp_avg"])
