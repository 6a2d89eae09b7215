"""Pipeline parallelism of the port (one stage a rank on a gloo ``stage``
axis) against the JAX package's pipeline engines on its 8-device CPU
mesh.

Each case runs the port's engine through ``make_gpt_train_step``'s
dispatch on ranks started by ``utils.launcher.spawn`` (every case of one
world size in one group, started once, with a deadline), and the JAX
engine of the same name in this process: ``make_gpt_smap_grad_fn`` for
``smap`` (GPipe, 1F1B, interleaved 1F1B), ``make_gpt_1f1b_grad_fn`` for
the ``vmap`` layout's 1F1B, and autodiff through the JAX ``Pipeline``
for its GPipe.  Both take the same numpy batch, and the port's weights
are the JAX package's own initialised pipelined tree, bridged
(``weights.from_jax_params``) and cut per rank (``weights.shard_params``).
Loss within 1e-5 relative; every gradient within 1e-4 by normalized
error (``||port - jax|| / ||jax||``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
from easyparallellibrary_tpu.models import GPT as JaxGPT
from easyparallellibrary_tpu.models import GPTConfig as JaxGPTConfig
from easyparallellibrary_tpu.models import gpt as jgpt
from easyparallellibrary_tpu.parallel import (
    TrainState, create_sharded_train_state, parallelize)
from easyparallellibrary_tpu_torch.testing import pp_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=16)
# Every group's deadline (seconds): a hung collective fails the tests
# instead of the run.
DEADLINE = 300
LOSS_RTOL, GRAD_LIMIT = 1e-5, 1e-4
LR = 1e-2

# name: (port mesh, world, engine, strategy, config overrides, M)
CASES = {
    "smap_gpipe": ("stage:2", 2, "smap", "PreferForward", {}, 4),
    "smap_1f1b": ("stage:2", 2, "smap", "PreferBackward", {}, 4),
    "smap_interleaved": ("stage:2", 2, "smap", "PreferBackward",
                         {"pipeline_interleave": 2}, 4),
    "smap_uneven": ("stage:2", 2, "smap", "PreferBackward",
                    {"num_layers": 5}, 4),
    "smap_untied": ("stage:2", 2, "smap", "PreferBackwardOptimizer",
                    {"tie_embeddings": False}, 4),
    "vmap_gpipe": ("stage:2", 2, "", "PreferForward", {}, 4),
    "vmap_1f1b": ("stage:2", 2, "", "PreferBackward", {}, 4),
    "vmap_uneven": ("stage:2", 2, "", "PreferBackwardOptimizer",
                    {"num_layers": 5}, 4),
    "vmap_interleaved": ("stage:2", 2, "", "PreferForward",
                         {"pipeline_interleave": 2}, 4),
    "smap_1f1b_s4": ("stage:4", 4, "smap", "PreferBackward", {}, 6),
    "smap_stage2_data2": ("stage:2,data:2", 4, "smap", "PreferBackward", {},
                          4),
    "vmap_stage2_data2": ("stage:2,data:2", 4, "", "PreferForward", {}, 4),
    "smap_stage2_model2": ("stage:2,model:2", 4, "smap", "PreferBackward",
                           {"tensor_parallel": True}, 4),
    "vmap_stage2_model2": ("stage:2,model:2", 4, "", "PreferBackward",
                           {"tensor_parallel": True}, 4),
}
TWO = [n for n, c in CASES.items() if c[1] == 2]
FOUR = [n for n, c in CASES.items() if c[1] == 4]
# 5 AdamW steps: (engine, strategy, overrides)
TRAIN = {"vmap_prefer_backward_optimizer": ("", "PreferBackwardOptimizer",
                                            {}),
         "smap_uneven_1f1b": ("smap", "PreferBackward", {"num_layers": 5})}


def _stages(mesh_shape):
  return int(dict(p.split(":") for p in mesh_shape.split(","))["stage"])


def _kwargs(name):
  mesh_shape, _, _, _, over, M = CASES[name]
  return dict(TINY, **over, pipeline_stages=_stages(mesh_shape),
              num_micro_batch=M)


def _ids(M, seed=0):
  return np.random.RandomState(seed).randint(0, 64, (4 * M, 17)).astype(
      np.int32)


def _port_tree(tree):
  return {k: v.numpy() for k, v in from_jax_params(
      jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree)),
      device="cpu").items()}


def _jax_mesh(mesh_shape, conf):
  """The JAX mesh of a case: ``build_mesh(stage=S[, model=2])`` on the 8
  CPU devices, or the exact ``stage:2,data:2`` spec on 4 of them."""
  if "data" in mesh_shape:
    jepl.init(jepl.Config({**conf, "cluster.mesh_shape": mesh_shape}),
              devices=jax.devices()[:4])
    return jepl.Env.get().cluster.build_mesh()
  env = jepl.init(jepl.Config(conf))
  return env.cluster.build_mesh(stage=_stages(mesh_shape),
                                model=2 if "model" in mesh_shape else 1)


def _jax_grads(name):
  """The JAX engine of the case's name: its loss and gradients, and the
  initialised parameters, in the port's layout."""
  mesh_shape, _, engine, strategy, _, M = CASES[name]
  mesh = _jax_mesh(mesh_shape, {"pipeline.engine": engine,
                                "pipeline.strategy": strategy})
  kw = _kwargs(name)
  model = JaxGPT(JaxGPTConfig(**kw, dtype=jnp.float32))
  ids = jnp.asarray(_ids(M))
  params = model.init(jax.random.PRNGKey(0), ids[:, :-1])["params"]
  if engine == "smap":
    fn = jgpt.make_gpt_smap_grad_fn(
        model, mesh, schedule="gpipe" if strategy == "PreferForward"
        else "1f1b")
    (loss, _), g = jax.jit(lambda p: fn(p, {"ids": ids}, None))(params)
  elif strategy != "PreferForward" and kw.get("pipeline_interleave", 1) == 1:
    fn = jgpt.make_gpt_1f1b_grad_fn(model)
    (loss, _), g = jax.jit(lambda p: fn(p, {"ids": ids}, None))(params)
  else:
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jgpt.gpt_loss(model, p, {"ids": ids})[0]))(params)
  return {"params": _port_tree(params), "loss": float(loss),
          "grads": _port_tree(g)}


def _jax_dispatch(engine, strategy, interleave, monkeypatch):
  """What the JAX ``make_gpt_train_step`` dispatches to, in the port's
  terms ``(engine, schedule, num_apply_group)``."""
  from easyparallellibrary_tpu.runtime import trainer
  seen = {}
  real_smap = jgpt.make_gpt_smap_grad_fn
  real_1f1b = jgpt.make_gpt_1f1b_grad_fn
  real_build = trainer.build_train_step

  def smap(model, mesh=None, schedule="1f1b"):
    seen["engine"] = ("smap", "interleaved" if schedule == "1f1b"
                      and interleave > 1 else schedule)
    return real_smap(model, mesh, schedule)

  def one_f_one_b(model):
    seen["engine"] = ("vmap", "1f1b")
    return real_1f1b(model)

  def build(*args, **kwargs):
    seen["groups"] = kwargs.get("num_apply_group")
    return real_build(*args, **kwargs)

  monkeypatch.setattr(jgpt, "make_gpt_smap_grad_fn", smap)
  monkeypatch.setattr(jgpt, "make_gpt_1f1b_grad_fn", one_f_one_b)
  monkeypatch.setattr(trainer, "build_train_step", build)
  env = jepl.init(jepl.Config({"pipeline.engine": engine,
                               "pipeline.strategy": strategy}))
  env.cluster.build_mesh(stage=2)
  jgpt.make_gpt_train_step(JaxGPT(JaxGPTConfig(
      **TINY, dtype=jnp.float32, pipeline_stages=2, num_micro_batch=4,
      pipeline_interleave=interleave)))
  return seen.get("engine", ("vmap", "gpipe")) + (seen["groups"],)


def _jax_train(engine, strategy, over, batches):
  """5 AdamW steps of JAX ``make_gpt_train_step`` on ``stage:2``: the
  initial parameters, the losses and the final parameters."""
  env = jepl.init(jepl.Config({"pipeline.engine": engine,
                               "pipeline.strategy": strategy}))
  mesh = env.cluster.build_mesh(stage=2)
  model = JaxGPT(JaxGPTConfig(**dict(TINY, **over), dtype=jnp.float32,
                              pipeline_stages=2, num_micro_batch=4))
  ids = jnp.asarray(batches[0])
  init = {}

  def init_fn(rng):
    params = model.init(rng, ids[:, :-1])["params"]
    return TrainState.create(apply_fn=model.apply, params=params,
                             tx=optax.adamw(LR, weight_decay=0.01))

  state, sh = create_sharded_train_state(init_fn, mesh,
                                         jax.random.PRNGKey(0))
  init["params"] = _port_tree(state.params)
  step = parallelize(jgpt.make_gpt_train_step(model), mesh, sh)
  losses = []
  for b in batches:
    state, m = step(state, {"ids": jnp.asarray(b)}, jax.random.PRNGKey(0))
    losses.append(float(m["loss"]))
  return init["params"], losses, _port_tree(state.params)


def _train_batches():
  r = np.random.RandomState(11)
  return [r.randint(0, 64, (16, 17)).astype(np.int32) for _ in range(5)]


@pytest.fixture(scope="module")
def refs():
  """Every JAX reference, computed once."""
  out = {name: _jax_grads(name) for name in CASES}
  batches = _train_batches()
  for name, (engine, strategy, over) in TRAIN.items():
    init, losses, final = _jax_train(engine, strategy, over, batches)
    out[name] = {"params": init, "losses": losses, "final": final,
                 "batches": batches}
  return out


def _grads_case(name, refs):
  mesh_shape, _, engine, strategy, _, M = CASES[name]
  return ("grads", (mesh_shape, engine, strategy, _kwargs(name),
                    refs[name]["params"], _ids(M)))


@pytest.fixture(scope="module")
def ranks2(refs):
  """Every two-rank case in one group: the gradient cases, the loss
  scale, dropout, the 5-step trajectories and the not-ported errors."""
  cases = [_grads_case(n, refs) for n in TWO]
  mesh_shape, _, engine, strategy, _, M = CASES["smap_1f1b"]
  cases.append(("grads", (mesh_shape, engine, strategy,
                          _kwargs("smap_1f1b"), refs["smap_1f1b"]["params"],
                          _ids(M), 128.0)))
  for strategy in ("PreferBackward", "PreferForward"):
    cases.append(("grads", ("stage:2", "smap", strategy,
                            dict(_kwargs("smap_1f1b"), dropout_rate=0.2),
                            refs["smap_1f1b"]["params"], _ids(4), None,
                            (0, 1), 2)))
  for name, (engine, strategy, over) in TRAIN.items():
    cases.append(("train", ("stage:2", engine, strategy,
                            dict(TINY, **over, pipeline_stages=2,
                                 num_micro_batch=4),
                            refs[name]["params"], refs[name]["batches"],
                            LR)))
  cases.append(("not_ported_errors", ()))
  ranks = spawn(pp_workers.suite, 2, (cases,), timeout_s=DEADLINE)
  names = TWO + ["loss_scale", "dropout_1f1b", "dropout_gpipe"] + \
      list(TRAIN) + ["not_ported"]
  return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def ranks4(refs):
  """Every four-rank case (S = 4, stage x data, stage x model) in one
  group."""
  ranks = spawn(pp_workers.suite, 4, ([_grads_case(n, refs) for n in FOUR],),
                timeout_s=DEADLINE)
  return {n: [r[i] for r in ranks] for i, n in enumerate(FOUR)}


def _rel(got, want):
  return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                1e-30))


def _check_grads(ranks, ref, kwargs):
  for r in ranks:
    np.testing.assert_allclose(r["loss"], ref["loss"], rtol=LOSS_RTOL)
  got = pp_workers.gather(ranks, kwargs)
  assert sorted(got) == sorted(ref["grads"])
  worst = {k: _rel(got[k], ref["grads"][k]) for k in got}
  bad = {k: v for k, v in worst.items() if v > GRAD_LIMIT}
  assert not bad, bad


@pytest.mark.parametrize("name", TWO)
def test_two_stage_engines_equal_jax(name, refs, ranks2):
  """GPipe, 1F1B, interleaved 1F1B (K = 2), uneven stages (5 layers over
  2) and untied heads on the ``smap`` layout, and the ``vmap`` layout's
  GPipe (also chained over K = 2 passes) and 1F1B, at S = 2, M = 4."""
  _check_grads(ranks2[name], refs[name], _kwargs(name))


@pytest.mark.parametrize("name", FOUR)
def test_four_rank_pipelines_equal_jax(name, refs, ranks4):
  """S = 4 (M = 6), pipeline x DP on ``stage:2,data:2`` and pipeline x
  TP on ``stage:2,model:2``, against the JAX engines on those meshes."""
  _check_grads(ranks4[name], refs[name], _kwargs(name))


@pytest.mark.quick
def test_smap_1f1b_equals_jax_quick(refs, ranks2):
  """The parity pin of slice 12: the port's 1F1B on the ``smap`` layout
  (stage-resident tied table, the sharded cross-entropy) at S = 2 equals
  JAX ``make_gpt_smap_grad_fn(schedule="1f1b")``."""
  _check_grads(ranks2["smap_1f1b"], refs["smap_1f1b"],
               _kwargs("smap_1f1b"))


@pytest.mark.parametrize("name", TWO)
def test_make_gpt_train_step_dispatches_as_jax(name, ranks2, monkeypatch):
  """``make_gpt_train_step`` picks the engine, the schedule and the
  apply groups the JAX dispatch picks for the same config."""
  _, _, engine, strategy, over, _ = CASES[name]
  want = _jax_dispatch(engine, strategy, over.get("pipeline_interleave", 1),
                       monkeypatch)
  for r in ranks2[name]:
    assert tuple(r["dispatch"]) == want


def test_loss_scale_seeds_the_backward(ranks2):
  """AMP: a loss scale of 128 seeds the engine's backward; the gradients
  it leaves are the unscaled ones times 128 (the train step unscales),
  the loss unchanged (JAX ``test_smap_1f1b_loss_scale_seeding``)."""
  for plain, scaled in zip(ranks2["smap_1f1b"], ranks2["loss_scale"]):
    assert scaled["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    for k, g in plain["grads"].items():
      np.testing.assert_allclose(scaled["grads"][k] / 128.0, g, rtol=1e-4,
                                 atol=1e-7, err_msg=k)


def test_dropout_masks_differ_by_key_and_recompute_is_consistent(ranks2):
  """With dropout, two keys give different losses and one key the same
  (JAX ``test_1f1b_dropout_uses_distinct_rngs``); 1F1B's recompute
  redraws the forward's masks, so its loss equals GPipe's (no
  recompute) on the same key; the gradients are finite."""
  one, gp = ranks2["dropout_1f1b"], ranks2["dropout_gpipe"]
  for r1, rg in zip(one, gp):
    assert r1["draws"][0] != r1["draws"][1]
    assert r1["loss"] != r1["draws"][0]
    np.testing.assert_allclose(r1["loss"], rg["loss"], rtol=1e-6)
    np.testing.assert_allclose(r1["draws"], rg["draws"], rtol=1e-6)
    assert all(np.isfinite(g).all() for g in r1["grads"].values())
  assert one[0]["loss"] == one[1]["loss"]


def test_dropout_keys_are_distinct_per_stage_and_micro_batch():
  """Each (micro-batch, virtual stage) of a pipelined step draws its
  dropout masks from its own key."""
  from easyparallellibrary_tpu_torch.models.gpt import (
      GPTConfig, stage_dropout_key)
  from easyparallellibrary_tpu_torch.utils import prng
  cfg = GPTConfig(**TINY, pipeline_stages=2, num_micro_batch=4,
                  pipeline_interleave=2)
  rng = prng.prng_key(3)
  keys = {tuple(stage_dropout_key(rng, cfg, m, k, s))
          for m in range(4) for k in range(2) for s in range(2)}
  assert len(keys) == 16


@pytest.mark.parametrize("name", list(TRAIN))
def test_five_adamw_steps_equal_jax(name, refs, ranks2):
  """Five AdamW(1e-2, wd 0.01) steps through ``create_sharded_train_state``
  / ``parallelize(make_gpt_train_step(model))``: the vmap layout's 1F1B
  with PreferBackwardOptimizer's apply in one group a stage, and the smap
  1F1B over uneven stages (its masked slot decays as JAX's does).  The
  losses within 1e-5 relative of JAX's, the final parameters within
  1e-4 by normalized error."""
  ref = refs[name]
  ranks = ranks2[name]
  for r in ranks:
    np.testing.assert_allclose(r["losses"], ref["losses"], rtol=LOSS_RTOL)
  kwargs = dict(TINY, **TRAIN[name][2], pipeline_stages=2, num_micro_batch=4)
  got = pp_workers.gather(ranks, kwargs, key="params")
  worst = {k: _rel(got[k], ref["final"][k]) for k in got}
  assert max(worst.values()) <= GRAD_LIMIT, worst
  assert ranks[0]["dispatch"][2] == (2 if name.startswith("vmap") else None)


def test_pipeline_debug_sequential_equals_jax():
  """One process holding every stage runs the chunks in layer order:
  the loss and gradients of ``gpt_loss`` on a pipelined config equal
  JAX's ``pipeline_debug_sequential`` ground truth (5 layers over 2
  stages: a masked slot)."""
  import easyparallellibrary_tpu_torch as tepl
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss
  kw = dict(TINY, num_layers=5, pipeline_stages=2, num_micro_batch=4)
  ids = _ids(4)
  jepl.init()
  model = JaxGPT(JaxGPTConfig(**kw, dtype=jnp.float32,
                              pipeline_debug_sequential=True))
  params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids[:, :-1]))[
      "params"]
  loss, g = jax.jit(jax.value_and_grad(
      lambda p: jgpt.gpt_loss(model, p, {"ids": jnp.asarray(ids)})[0]))(params)
  tepl.init(device="cpu")
  port = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in _port_tree(params).items()}
  tmodel = GPT(GPTConfig(**kw, dtype=torch.float32,
                         pipeline_debug_sequential=True))
  tloss, _ = gpt_loss(tmodel, port, {"ids": torch.from_numpy(ids)})
  tloss.backward()
  np.testing.assert_allclose(float(tloss.detach()), float(loss),
                             rtol=LOSS_RTOL)
  want = _port_tree(g)
  for k, p in port.items():
    assert _rel(p.grad.numpy(), want[k]) <= GRAD_LIMIT, k


def test_pipelined_generate_falls_back_to_full_forward():
  """``generate(use_cache=True)`` on a pipelined config takes JAX's
  fallback: a full forward per token, the same tokens as
  ``use_cache=False`` and as JAX's ``generate``."""
  import easyparallellibrary_tpu_torch as tepl
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig, generate
  kw = dict(TINY, pipeline_stages=2)
  jepl.init()
  model = JaxGPT(JaxGPTConfig(**kw, dtype=jnp.float32))
  prompt = _ids(1)[:2, :5]
  params = model.init(jax.random.PRNGKey(1), jnp.asarray(prompt))["params"]
  want = np.asarray(jgpt.generate(model, params, jnp.asarray(prompt), 6))
  tepl.init(device="cpu")
  tmodel = GPT(GPTConfig(**kw, dtype=torch.float32))
  port = {k: torch.from_numpy(v) for k, v in _port_tree(params).items()}
  got = generate(tmodel, port, torch.from_numpy(prompt).long(), 6)
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(
      generate(tmodel, port, torch.from_numpy(prompt).long(), 6,
               use_cache=False).numpy(), want)


def test_not_ported_compositions_raise_naming_the_item(ranks2):
  """ZeRO under the pipeline, MoE and a seq axis raise
  ``NotImplementedError`` naming ROADMAP Queue 1's item (slice 13)."""
  for r in ranks2["not_ported"]:
    for key in ("zero", "moe", "seq"):
      assert r[key], key
      assert r["item"] in r[key], (key, r[key])
