"""ZeRO and sequence parallelism under the port's pipeline engines (one
stage a rank on a gloo ``stage`` axis, with ``data``, ``seq`` and
``model`` axes beside it) against the JAX package on the CPU.

* ZeRO v1 on the ``smap`` engine and ZeRO v0 on the ``vmap`` layout
  (``stage:2,data:2``): 3 AdamW steps through ``make_gpt_train_step``,
  losses at 2e-5 relative (the JAX test's ``rtol``) against the JAX
  engine of the same name under the same ZeRO level, the optimizer
  moments of a rank half of those without ZeRO, and the refusal of an
  optimizer that clips by the global norm;
* the ring and Ulysses in the ``smap`` stage programs and the ring under
  the ``vmap`` layout (``stage:2,seq:2``), and pipeline x seq x TP
  (``stage:2,seq:2,model:2``): the loss at 1e-5 relative and every
  gradient at 1e-4 against the JAX pipelined GPT's sequential ground
  truth (``pipeline_debug_sequential``), which the JAX package's own
  engine tests hold its engines to;
* ZeRO x ring x smap (``stage:2,seq:2,data:2``): 3 AdamW steps, losses
  at 2e-5 relative against the JAX sequential ground truth's.

Each world size's cases run in one gloo group of
``utils.launcher.spawn``.
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
    TrainState, create_sharded_train_state, make_train_step, parallelize)
from easyparallellibrary_tpu_torch.testing import pp_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=16, pipeline_stages=2, num_micro_batch=2)
DEADLINE = 300
LOSS_RTOL, GRAD_LIMIT, TRAIN_RTOL = 1e-5, 1e-4, 2e-5
LR = 1e-2
SEQ = {"sequence.ring_impl": "flash", "sequence.ring_layout": "zigzag"}
# ZeRO runs: name -> (engine, strategy, zero level)
ZERO = {"smap_zero1": ("smap", "PreferBackward", "v1"),
        "vmap_zero0": ("", "PreferForward", "v0")}
# Gradient compositions: name -> (mesh, engine, strategy, overrides)
GRADS = {
    "smap_ring": ("stage:2,seq:2", "smap", "PreferBackward",
                  {"attn_impl": "ring", "seq_parallel": True}),
    "smap_ulysses": ("stage:2,seq:2", "smap", "PreferBackward",
                     {"attn_impl": "ulysses", "seq_parallel": True}),
    "vmap_ring": ("stage:2,seq:2", "", "PreferBackward",
                  {"attn_impl": "ring", "seq_parallel": True}),
    "smap_ring_tp": ("stage:2,seq:2,model:2", "smap", "PreferBackward",
                     {"attn_impl": "ring", "seq_parallel": True,
                      "tensor_parallel": True}),
}


def _batches(n=3):
  r = np.random.RandomState(7)
  return [r.randint(0, 64, (8, 17)).astype(np.int32) for _ in range(n)]


def _port(tree):
  return {k: v.numpy() for k, v in from_jax_params(
      jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree)),
      device="cpu").items()}


def _rel(got, want):
  return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                1e-30))


def _jax_engine_train(engine, strategy, level, batches):
  """3 AdamW steps of the JAX engine under ZeRO on ``stage:2,data:2``:
  the initial parameters and the losses."""
  jepl.init(jepl.Config({"pipeline.engine": engine,
                         "pipeline.strategy": strategy,
                         "zero.level": level,
                         "cluster.mesh_shape": "stage:2,data:2"}),
            devices=jax.devices()[:4])
  mesh = jepl.Env.get().cluster.build_mesh()
  model = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  ids = jnp.asarray(batches[0])

  def init_fn(rng):
    return TrainState.create(
        apply_fn=model.apply,
        params=model.init(rng, ids[:, :-1])["params"],
        tx=optax.adamw(LR, weight_decay=0.01))

  state, sh = create_sharded_train_state(init_fn, mesh,
                                         jax.random.PRNGKey(0),
                                         zero_level=level)
  init = _port(state.params)
  step = parallelize(jgpt.make_gpt_train_step(model), mesh, sh)
  losses = []
  for b in batches:
    state, m = step(state, {"ids": jnp.asarray(b)}, jax.random.PRNGKey(0))
    losses.append(float(m["loss"]))
  return init, losses


def _jax_sequential(over, batches=None):
  """The JAX pipelined GPT's sequential ground truth on one device:
  its parameters, the loss and gradients of ``batches[0]``, and, with
  ``batches``, the losses of 3 AdamW steps over them."""
  jepl.init(jepl.Config({}), devices=jax.devices()[:1])
  kw = dict(TINY, **{k: v for k, v in over.items()
                     if k not in ("attn_impl", "seq_parallel",
                                  "tensor_parallel")})
  model = JaxGPT(JaxGPTConfig(**kw, dtype=jnp.float32,
                              pipeline_debug_sequential=True,
                              tensor_parallel=over.get("tensor_parallel",
                                                       False)))
  batches = batches or _batches(1)
  ids = jnp.asarray(batches[0])
  params = model.init(jax.random.PRNGKey(2), ids[:, :-1])["params"]
  (loss, _), grads = jax.value_and_grad(
      lambda p: jgpt.gpt_loss(model, p, {"ids": ids}), has_aux=True)(params)
  out = {"params": _port(params), "ids": np.asarray(ids),
         "loss": float(loss), "grads": _port(grads)}
  if len(batches) > 1:
    mesh = jepl.Env.get().cluster.build_mesh()
    state, sh = create_sharded_train_state(
        lambda rng: TrainState.create(apply_fn=model.apply, params=params,
                                      tx=optax.adamw(LR, weight_decay=0.01)),
        mesh, jax.random.PRNGKey(0))
    step = parallelize(make_train_step(
        lambda p, b, r: jgpt.gpt_loss(model, p, b, r)), mesh, sh)
    losses = []
    for b in batches:
      state, m = step(state, {"ids": jnp.asarray(b)}, jax.random.PRNGKey(0))
      losses.append(float(m["loss"]))
    out["losses"] = losses
  return out


@pytest.fixture(scope="module")
def refs():
  batches = _batches()
  out = {name: _jax_engine_train(e, s, z, batches)
         for name, (e, s, z) in ZERO.items()}
  for name, (_, _, _, over) in GRADS.items():
    out[name] = _jax_sequential(over)
  out["zero_ring"] = _jax_sequential(GRADS["smap_ring"][3], batches)
  return out


def _cfg(over):
  return dict(TINY, **{k: v for k, v in over.items()
                       if k != "tensor_parallel"})


@pytest.fixture(scope="module")
def ranks(refs):
  """The four-rank cases in one group, the eight-rank ones in another."""
  batches = _batches()
  four, names4 = [], []
  for name, (engine, strategy, level) in ZERO.items():
    init = refs[name][0]
    for lvl in (level, ""):
      four.append(("train", ("stage:2,data:2", engine, strategy, TINY, init,
                             batches, LR, 0.01, "cpu", None,
                             {"zero.level": lvl})))
      names4.append(name if lvl else name + "_plain")
    four.append(("zero_refuses_coupled", ("stage:2,data:2", engine,
                                          strategy, level, TINY, init,
                                          batches[0])))
    names4.append(name + "_refuses")
  eight, names8 = [], []
  for name, (mesh, engine, strategy, over) in GRADS.items():
    r = refs[name]
    case = ("grads", (mesh, engine, strategy, _cfg(over), r["params"],
                      r["ids"], None, None, 0, SEQ))
    (eight if mesh.count(",") == 2 else four).append(case)
    (names8 if mesh.count(",") == 2 else names4).append(name)
  zr = refs["zero_ring"]
  eight.append(("train", ("stage:2,data:2,seq:2", "smap", "PreferBackward",
                          _cfg(GRADS["smap_ring"][3]), zr["params"],
                          batches, LR, 0.01, "cpu", None,
                          dict(SEQ, **{"zero.level": "v1"}))))
  names8.append("zero_ring")
  out = {}
  for world, cases, names in ((4, four, names4), (8, eight, names8)):
    got = spawn(pp_workers.suite, world, (cases,), timeout_s=DEADLINE)
    out.update({n: [r[i] for r in got] for i, n in enumerate(names)})
  return out


@pytest.mark.quick
@pytest.mark.parametrize("name", list(ZERO))
def test_zero_under_the_pipeline_matches_jax(name, refs, ranks):
  """Losses at 2e-5 relative to the JAX engine under the same ZeRO
  level, and the same as without ZeRO; every rank's AdamW moments are
  half of the unsharded ones (every leaf of this model has a dim the
  data axis divides besides its stage dim)."""
  _, want = refs[name]
  for r, plain in zip(ranks[name], ranks[name + "_plain"]):
    np.testing.assert_allclose(r["losses"], want, rtol=TRAIN_RTOL)
    np.testing.assert_allclose(r["losses"], plain["losses"], rtol=TRAIN_RTOL)
    assert r["moment_bytes"] * 2 == plain["moment_bytes"]
    assert r["dispatch"][0] == (ZERO[name][0] or "vmap")


@pytest.mark.parametrize("name", list(ZERO))
def test_zero_under_the_pipeline_refuses_a_coupled_optimizer(name, ranks):
  """An optimizer that clips by the global norm couples every position,
  so its owner slices would compute the clip over local slices only:
  the pipeline's ZeRO step refuses it on every rank, as the pure-DP
  ZeRO-1 step does (``runtime.zero._assert_elementwise_tx``)."""
  for msg in ranks[name + "_refuses"]:
    assert "requires an elementwise optimizer" in msg, msg


def test_zero_params_stay_replicated_over_data(ranks):
  """After the owners' updates are all-gathered, the data replicas of a
  stage hold the same parameters."""
  by_stage = {}
  for r in ranks["smap_zero1"]:
    by_stage.setdefault(r["coords"]["stage"], []).append(r["params"])
  for a, b in by_stage.values():
    for leaf in a:
      np.testing.assert_array_equal(a[leaf], b[leaf])


@pytest.mark.parametrize("name", list(GRADS))
def test_sequence_parallel_under_the_pipeline_matches_jax(name, refs,
                                                          ranks):
  """The loss at 1e-5 relative and every gradient (averaged over the seq
  axis, summed over the stage axis where the layout asks) at 1e-4
  against the JAX sequential ground truth."""
  want = refs[name]
  got = ranks[name]
  for r in got:
    np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOSS_RTOL)
  over = GRADS[name][3]
  whole = pp_workers.gather([r for r in got if r["coords"]["seq"] == 0],
                            _cfg(over))
  for leaf, g in whole.items():
    assert _rel(g, want["grads"][leaf]) < GRAD_LIMIT, leaf


def test_zero_ring_smap_trains_on_jax_trajectory(refs, ranks):
  """ZeRO v1 x ring x smap on ``stage:2,data:2,seq:2``: the seq mean and
  then the reduce-scatter over data give the losses of the JAX
  sequential ground truth at 2e-5 relative."""
  for r in ranks["zero_ring"]:
    np.testing.assert_allclose(r["losses"], refs["zero_ring"]["losses"],
                               rtol=TRAIN_RTOL)
