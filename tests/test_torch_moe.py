"""Mixture-of-experts of the port (``models/moe.py``, the MoE blocks of
``models/gpt.py``) against the JAX package's ``MoEMLP`` and GPT on its
CPU device mesh.

The routing masks are compared exactly (top-1 and top-2, with and
without drops, on one rank and with the batch split over ``data:2`` /
``seq:2`` and routed as one group); ``MoEMLP`` on an ``expert:2`` mesh
(the einsum path with tokens on every rank, the a2a path with the rows
split over the expert axis), on a ``model:2`` mesh (the experts' ``F``
dim split) and on ``data:2`` / ``seq:2`` with drops, output
at 1e-5 and every gradient at 1e-4 by normalized error, with the
load-balancing loss in the objective and alone (the router kernel's
gradient through the a2a path's ``pmean``); a GPT-MoE's ``gpt_loss``
over 5 AdamW steps at 1e-5 relative; the pipelined GPT-MoE on the smap
engine; the expert-weight initialiser's fan-in; and the serving
stack's refusal of an MoE model.  The port's ranks run in one gloo
group of ``utils.launcher.spawn`` (every two-rank case, started once).
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
from easyparallellibrary_tpu.models import moe as jmoe
from easyparallellibrary_tpu.parallel import (
    TrainState, create_sharded_train_state, parallelize)
from easyparallellibrary_tpu.serving import _capabilities as jcap
from easyparallellibrary_tpu_torch.models import moe as tmoe
from easyparallellibrary_tpu_torch.testing import pp_workers, sp_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=16, num_experts=4)
DEADLINE = 300
OUT_TOL, GRAD_LIMIT, LOSS_RTOL = 1e-5, 1e-4, 1e-5
AUX_W = 0.01
# name: (mesh spec, impl, top_k, capacity_factor, aux weight, dout scale)
LAYER = {
    "einsum_top1": ("expert:2", "einsum", 1, 1.25, AUX_W, 1.0),
    "einsum_top2_drops": ("expert:2", "einsum", 2, 0.5, AUX_W, 1.0),
    "a2a_top1": ("expert:2", "a2a", 1, 1.25, AUX_W, 1.0),
    "a2a_top2_drops": ("expert:2", "a2a", 2, 0.5, AUX_W, 1.0),
    "a2a_aux_only": ("expert:2", "a2a", 1, 1.25, 1.0, 0.0),
    "einsum_tp": ("model:2", "einsum", 2, 1.25, AUX_W, 1.0),
    # The batch split over data rows / seq tokens, routed as one group.
    "einsum_top2_drops_data": ("data:2", "einsum", 2, 0.5, AUX_W, 1.0),
    "einsum_top1_drops_seq": ("seq:2", "einsum", 1, 0.75, AUX_W, 1.0),
}
# Grouped routing masks: (mesh spec, top_k, capacity of 32 tokens).
GROUPED = {f"{spec}_top{k}": (spec, k, 5) for spec in ("data:2", "seq:2")
           for k in (1, 2)}


def _cfg(cf=1.25, **over):
  return dict(TINY, capacity_factor=cf, **over)


def _rel(got, want):
  return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                1e-30))


def _jax_mesh(spec):
  n = int(np.prod([int(p.split(":")[1]) for p in spec.split(",")]))
  jepl.init(jepl.Config({"cluster.mesh_shape": spec}),
            devices=jax.devices()[:n])
  return jepl.Env.get().cluster.build_mesh()


def _layer_inputs(seed=0):
  r = np.random.RandomState(seed)
  return (r.randn(4, 8, 32).astype(np.float32),
          r.randn(4, 8, 32).astype(np.float32))


def _jax_layer(name):
  """The JAX ``MoEMLP`` of a case on its mesh: its parameters, output,
  aux loss and the gradients of ``sum(out * dout) + w * aux``."""
  spec, impl, k, cf, w, ds = LAYER[name]
  _jax_mesh(spec)
  cfg = JaxGPTConfig(**_cfg(cf, tensor_parallel="model" in spec),
                     dtype=jnp.float32)
  layer = jmoe.MoEMLP(cfg, top_k=k, impl=impl)
  x, dout = _layer_inputs()
  dout = dout * ds
  params = nn.meta.unbox(layer.init(jax.random.PRNGKey(1),
                                    jnp.asarray(x))["params"])

  def f(p, xx):
    out, st = layer.apply({"params": p}, xx, mutable=["losses"])
    aux = sum(jnp.sum(a) for a in jax.tree_util.tree_leaves(st["losses"]))
    return jnp.sum(out * jnp.asarray(dout)) + w * aux, (out, aux)

  (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
      f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
  np_tree = jax.tree_util.tree_map(np.asarray, params)
  return {"params": np_tree, "x": x, "dout": dout, "out": np.asarray(out),
          "aux": float(aux), "dx": np.asarray(gx),
          "grads": jax.tree_util.tree_map(np.asarray, gp)}


def _jax_train(cfg_kwargs, batches, conf=None, mesh_spec=None):
  """5 AdamW steps of JAX ``make_gpt_train_step``: the initial
  parameters in the port's layout and the losses."""
  if mesh_spec:
    mesh = _jax_mesh(mesh_spec)
  else:
    mesh = jepl.init(jepl.Config(conf or {})).cluster.build_mesh()
  model = JaxGPT(JaxGPTConfig(**cfg_kwargs, dtype=jnp.float32))
  ids = jnp.asarray(batches[0])
  init = {}

  def init_fn(rng):
    params = model.init(rng, ids[:, :-1])["params"]
    return TrainState.create(apply_fn=model.apply, params=params,
                             tx=optax.adamw(1e-2, weight_decay=0.01))

  state, sh = create_sharded_train_state(init_fn, mesh,
                                         jax.random.PRNGKey(0))
  init["params"] = {k: v.numpy() for k, v in from_jax_params(
      jax.tree_util.tree_map(np.asarray, nn.meta.unbox(state.params)),
      device="cpu").items()}
  step = parallelize(jgpt.make_gpt_train_step(model), mesh, sh)
  losses, aux = [], []
  for b in batches:
    state, m = step(state, {"ids": jnp.asarray(b)}, jax.random.PRNGKey(0))
    losses.append(float(m["loss"]))
    aux.append(float(m["moe_aux_loss"]))
  return init["params"], losses, aux


def _batches(rows=8):
  r = np.random.RandomState(5)
  return [r.randint(0, 64, (rows, 17)).astype(np.int32) for _ in range(5)]


PIPE = dict(TINY, num_layers=4, pipeline_stages=2, num_micro_batch=2)


def _jax_pipe_grads():
  """The JAX smap 1F1B engine on a pipelined GPT-MoE on two devices
  (``stage:2``, no data axis: the JAX engine averages a data shard's
  aux losses over the data axis, where its GSPMD path and the port take
  the global routing fractions)."""
  jepl.init(jepl.Config({"pipeline.engine": "smap",
                         "pipeline.strategy": "PreferBackward",
                         "cluster.mesh_shape": "stage:2"}),
            devices=jax.devices()[:2])
  mesh = jepl.Env.get().cluster.build_mesh()
  model = JaxGPT(JaxGPTConfig(**PIPE, dtype=jnp.float32))
  ids = _batches()[0]
  params = model.init(jax.random.PRNGKey(0),
                      jnp.asarray(ids[:, :-1]))["params"]
  (loss, metrics), grads = jax.jit(
      lambda p: jgpt.make_gpt_smap_grad_fn(model, mesh)(
          p, {"ids": jnp.asarray(ids)}, None))(params)

  def port(tree):
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree)),
        device="cpu").items()}

  return {"params": port(params), "ids": ids, "loss": float(loss),
          "aux": float(metrics["moe_aux_loss"]), "grads": port(grads)}


@pytest.fixture(scope="module")
def refs():
  out = {name: _jax_layer(name) for name in LAYER}
  out["train"] = _jax_train(_cfg(), _batches())
  out["pipe"] = _jax_pipe_grads()
  return out


@pytest.fixture(scope="module")
def ranks2(refs):
  """Every two-rank case in one group."""
  cases = []
  for name, (spec, impl, k, cf, w, _) in LAYER.items():
    r = refs[name]
    cases.append(("moe_layer", (spec, _cfg(cf), impl, k, r["params"],
                                r["x"], r["dout"], w)))
  for name, (spec, k, cap) in GROUPED.items():
    cases.append(("dispatch", (spec, _grouped_probs(), k, cap)))
  p = refs["pipe"]
  cases.append(("grads", ("stage:2", "smap", "PreferBackward", PIPE,
                          p["params"], p["ids"])))
  ranks = spawn(sp_workers.suite, 2, (cases,), timeout_s=DEADLINE)
  names = list(LAYER) + list(GROUPED) + ["pipe"]
  return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


# ----------------------------------------------------------------- masks


def _grouped_probs():
  """Router probabilities of a ``[4, 8]`` batch over 4 experts."""
  logits = np.random.RandomState(11).randn(4, 8, 4).astype(np.float32)
  return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.quick
@pytest.mark.parametrize("top_k,capacity", [(1, 3), (1, 16), (2, 3),
                                            (2, 16)])
def test_dispatch_and_combine_masks_equal_jax_exactly(top_k, capacity):
  """Routing is discrete: the port's masks are JAX's, bit for bit, with
  drops (capacity 3 for 32 tokens) and without."""
  r = np.random.RandomState(top_k * 100 + capacity)
  logits = r.randn(32, 4).astype(np.float32)
  logits[3] = logits[5]                     # a tie: the first maximum
  probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
  want = [np.asarray(a) for a in jmoe._top_k_dispatch(
      probs, top_k, 4, capacity, jnp.float32)]
  got = [t.numpy() for t in tmoe._top_k_dispatch(
      torch.from_numpy(np.asarray(probs)), top_k, 4, capacity,
      torch.float32)]
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  if capacity == 3:
    assert want[0].sum() < top_k * 32       # this case drops tokens


@pytest.mark.parametrize("name", list(GROUPED))
def test_grouped_routing_masks_equal_jax_exactly(name, ranks2):
  """A batch split over data rows or seq tokens is routed as one group,
  as JAX's einsum path routes the global batch under GSPMD: the ranks'
  masks, put together, are JAX's on the whole batch bit for bit, drops
  included (capacity 5 for 32 tokens)."""
  _, k, cap = GROUPED[name]
  probs = _grouped_probs()
  want = [np.asarray(a) for a in jmoe._top_k_dispatch(
      jnp.asarray(probs.reshape(32, 4)), k, 4, cap, jnp.float32)]
  got = sp_workers.whole_masks(ranks2[name])
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.reshape(w.shape), w)
  assert want[0].sum() < k * 32             # this case drops tokens


# ------------------------------------------------------------ the layer


def _gather_layer(ranks, name):
  """The whole layer output, its input gradient and the parameter
  gradients from the ranks' slices."""
  spec, impl, *_ = LAYER[name]
  split = (impl == "a2a" and "expert" in spec) or "data" in spec
  dim = 1 if "seq" in spec else 0
  by = ("model" if "model" in spec else "expert" if "expert" in spec
        else "seq" if "seq" in spec else "data")
  ranks = sorted(ranks, key=lambda r: r["coords"][by])
  cat = (lambda key: np.concatenate([r[key] for r in ranks], axis=dim)) \
      if split or dim else (lambda key: ranks[0][key])
  grads = {"router_kernel": ranks[0]["grads"]["router_kernel"]}
  for leaf in ("wi", "wo"):
    if by == "model":
      grads[leaf] = np.concatenate([r["grads"][leaf] for r in ranks],
                                   axis=2 if leaf == "wi" else 1)
    elif by == "expert":
      grads[leaf] = np.concatenate([r["grads"][leaf] for r in ranks])
    else:
      grads[leaf] = ranks[0]["grads"][leaf]
  return cat("out"), cat("dx"), grads


@pytest.mark.parametrize("name", list(LAYER))
def test_moe_layer_matches_jax(name, refs, ranks2):
  """Output at 1e-5, the aux loss at 1e-5 relative, and the gradients
  of the router, the experts and the input at 1e-4; the replicated
  router gradient is the same on both ranks."""
  want = refs[name]
  out, dx, grads = _gather_layer(ranks2[name], name)
  np.testing.assert_allclose(out, want["out"], atol=OUT_TOL, rtol=0)
  for r in ranks2[name]:
    np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-5)
  if LAYER[name][5]:
    assert _rel(dx, want["dx"]) < GRAD_LIMIT
  for leaf, g in grads.items():
    assert _rel(g, want["grads"][leaf]) < GRAD_LIMIT, leaf
  a, b = (r["grads"]["router_kernel"] for r in ranks2[name])
  assert _rel(a, b) < 1e-6
  if name.endswith(("_data", "_seq")):
    assert sum(r["dropped"] for r in ranks2[name]) > 0   # it drops


def test_a2a_aux_router_gradient_is_jax_pmean_transpose(refs, ranks2):
  """With the objective the aux loss alone, the router kernel's gradient
  through the a2a path's pre-product ``pmean`` is JAX's: the mean over
  the expert axis with an identity backward, not a summed one (which
  would double it on two ranks)."""
  want = refs["a2a_aux_only"]["grads"]["router_kernel"]
  assert np.linalg.norm(want) > 0
  got = ranks2["a2a_aux_only"][0]["grads"]["router_kernel"]
  assert _rel(got, want) < GRAD_LIMIT
  assert _rel(2 * got, want) > 0.5


# ------------------------------------------------------------- the model


def test_gpt_moe_trains_on_jax_trajectory(refs):
  """A GPT-MoE (an MoE block every 2nd layer, 4 experts) over 5 AdamW
  steps through ``make_gpt_train_step``: the losses and the aux metric
  at 1e-5 relative to the JAX package's."""
  init, want, want_aux = refs["train"]
  got = pp_workers.train(0, 1, "", "", "PreferBackward", _cfg(), init,
                         _batches(), 1e-2)
  np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
  assert got["dispatch"][0] == "autodiff"


def test_gpt_moe_under_the_smap_pipeline_matches_jax(refs, ranks2):
  """The pipelined GPT-MoE on the smap 1F1B engine (``stage:2``): the
  loss (with ``moe_aux_weight`` times the stages' aux losses) at 1e-5
  relative and every gradient at 1e-4 against the JAX engine."""
  want = refs["pipe"]
  ranks = ranks2["pipe"]
  for r in ranks:
    np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOSS_RTOL)
    assert r["dispatch"][0] == "smap"
  got = pp_workers.gather(ranks, PIPE)
  for name, g in got.items():
    assert _rel(g, want["grads"][name]) < GRAD_LIMIT, name


def test_pipelined_moe_needs_even_stages():
  """MoE with an uneven stage plan raises (JAX ``GPT.__call__``)."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  with pytest.raises(ValueError, match="divide evenly"):
    GPT(GPTConfig(**dict(PIPE, num_layers=5)))


# ---------------------------------------------------------------- init


def test_expert_init_fan_in_matches_flax():
  """flax's ``lecun_normal`` counts an expert weight's leading ``E`` as
  receptive field: ``wi [E, D, F]`` has fan-in ``E * D`` and ``wo``
  ``E * F``.  ``init_params`` draws with that std, as ``MoEMLP.init``."""
  from easyparallellibrary_tpu_torch.models.gpt import GPTConfig
  from easyparallellibrary_tpu_torch.weights import init_params
  kw = dict(TINY, d_model=64, d_ff=256, num_experts=8, num_layers=2)
  jepl.init()
  layer = jmoe.MoEMLP(JaxGPTConfig(**kw, dtype=jnp.float32))
  jp = nn.meta.unbox(layer.init(jax.random.PRNGKey(3),
                                jnp.zeros((1, 4, 64)))["params"])
  tp = init_params(GPTConfig(**kw, dtype=torch.float32), seed=3,
                   device="cpu")
  E, D, F = 8, 64, 256
  for leaf, fan_in in (("wi", E * D), ("wo", E * F)):
    std = np.sqrt(1.0 / fan_in)
    jstd = float(np.std(np.asarray(jp[leaf])))
    tstd = float(tp[f"block_1.moe.{leaf}"].std())
    assert abs(jstd / std - 1) < 0.05, (leaf, jstd, std)
    assert abs(tstd / jstd - 1) < 0.05, (leaf, tstd, jstd)
  # The router is normal(0.02) in both (512 draws: a 10% band).
  for std in (float(tp["block_1.moe.router_kernel"].std()),
              float(np.std(np.asarray(jp["router_kernel"])))):
    np.testing.assert_allclose(std, 0.02, rtol=0.1)


# ------------------------------------------------------------- serving


def test_serving_rejects_moe_with_the_jax_message():
  """The engine (paged and contiguous slots) and the router refuse an
  MoE model with the JAX package's error type and message."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Router)
  from easyparallellibrary_tpu_torch.weights import init_params
  import easyparallellibrary_tpu_torch as tepl
  tepl.init(device="cpu")
  cfg = GPTConfig(**TINY, dtype=torch.float32)
  with pytest.raises(ValueError) as want:
    jcap.check_servable(JaxGPTConfig(**TINY, dtype=jnp.float32))
  params = init_params(cfg, device="cpu")
  for build in (
      lambda: ContinuousBatchingEngine(GPT(cfg), params, device="cpu",
                                       paged=True),
      lambda: ContinuousBatchingEngine(GPT(cfg), params, device="cpu"),
      lambda: Router(GPT(cfg), params, num_replicas=1, device="cpu")):
    with pytest.raises(ValueError) as got:
      build()
    assert str(got.value) == str(want.value)


def test_moe_weights_shard_and_round_trip():
  """``shard_params`` cuts the experts over ``expert`` and their ``F`` dim
  over ``model``; ``gather_experts`` and ``unshard_params`` put them
  back bit for bit; ``stack_stages`` / ``unstack_stages`` round-trip a
  GPT-MoE's blocks (each stage repeating the expert pattern)."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.weights import (
      gather_experts, init_params, shard_params, stack_stages,
      unshard_params, unstack_stages)
  import easyparallellibrary_tpu_torch as tepl
  tepl.init(device="cpu")
  cfg = GPTConfig(**dict(TINY, num_layers=4), dtype=torch.float32,
                  tensor_parallel=True)
  whole = init_params(cfg, seed=4, device="cpu")
  model = GPT(cfg)
  shards = [[shard_params(whole, model, tp=2, rank=m, expert=2,
                          expert_rank=e) for m in range(2)]
            for e in range(2)]
  assert shards[1][0]["block_1.moe.wi"].shape == (2, 32, 32)
  assert shards[0][1]["block_1.moe.wo"].shape == (2, 32, 32)
  per_model = [gather_experts([shards[e][m] for e in range(2)])
               for m in range(2)]
  back = unshard_params(per_model, cfg)
  for name, t in whole.items():
    assert torch.equal(back[name], t), name
  pipe = GPTConfig(**dict(TINY, num_layers=4, pipeline_stages=2),
                   dtype=torch.float32)
  stacked = stack_stages(init_params(GPTConfig(**dict(TINY, num_layers=4),
                                               dtype=torch.float32),
                                     seed=4, device="cpu"), pipe)
  assert stacked["pipeline.stages.stacked.block_1.moe.wi"].shape == (
      2, 4, 32, 64)
  for name, t in unstack_stages(stacked, pipe).items():
    assert torch.equal(t, whole[name]), name


def test_router_at_init_concentrates_in_both_packages():
  """At wide layers (here half GPT-350M's: d_model 512, d_ff 2048; on
  the card phase 23a at its full widths) a freshly initialised router
  sends most tokens to a few experts in both packages (the dense block
  before it adds every token the same mean of its GELU outputs), so
  capacity_factor 1.25 drops a large share of the choices at step 1: a
  property of the configuration, not of the port.  Each package from
  its own initialiser, 2 x 256 tokens: both drop over a fifth."""
  import math

  import easyparallellibrary_tpu_torch as tepl
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.weights import init_params
  kw = dict(vocab_size=64, num_layers=2, num_heads=8, d_model=512,
            d_ff=2048, max_seq_len=256, num_experts=8)
  ids = np.random.RandomState(0).randint(0, 64, (2, 256)).astype(np.int32)
  T = ids.size
  jepl.init()
  jm = JaxGPT(JaxGPTConfig(**kw, dtype=jnp.float32))
  params = nn.meta.unbox(jm.init(jax.random.PRNGKey(0),
                                 jnp.asarray(ids[:, :8]))["params"])
  _, st = jm.apply({"params": params}, jnp.asarray(ids),
                   capture_intermediates=True,
                   mutable=["intermediates", "losses"])
  x = st["intermediates"]["block_1"]["ln2"]["__call__"][0].reshape(T, -1)
  probs = jax.nn.softmax(x @ params["block_1"]["moe"]["router_kernel"], -1)
  d, _, a = jmoe._top_k_dispatch(probs, 1, 8, math.ceil(T / 8 * 1.25),
                                 jnp.float32)
  jax_dropped = int(a.sum() - d.sum())
  tepl.init(device="cpu")
  cfg = GPTConfig(**kw, dtype=torch.float32)
  model = GPT(cfg)
  with torch.no_grad():
    torch.func.functional_call(model, init_params(cfg, 0, device="cpu"),
                               (torch.from_numpy(ids).long(),))
  port_dropped = int(model.block_1.moe.last_dropped)
  assert jax_dropped > T / 5 and port_dropped > T / 5, (jax_dropped,
                                                        port_dropped)
