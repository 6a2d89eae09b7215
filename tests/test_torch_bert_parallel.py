"""BERT's engines and ResNet's data- and model-parallel paths on gloo
ranks, against the JAX package on its CPU mesh.

Every case runs on ranks started once by ``utils.launcher.spawn`` (the
two-rank cases in one group, the four-rank case in another, each with a
deadline) through ``testing.bert_workers``, from the JAX package's own
initialised parameters (bridged, each rank cutting its slice), and the
JAX function of the same name in this process:

* BERT at ``stage:2``: the ``vmap`` layout's GPipe (autodiff of
  ``bert_mlm_loss`` through the JAX ``Pipeline``), and the ``smap``
  engine's GPipe, 1F1B and interleaved 1F1B (``make_bert_smap_grad_fn``);
* BERT tensor-parallel at ``model:2``, and with ring and Ulysses
  attention at ``seq:2``;
* a sparse mask on ``data:2``, on ``seq:2`` and under the smap 1F1B
  with ring attention on ``stage:2,seq:2``: one shard of each
  micro-batch holds no masked token (a per-shard ratio would halve the
  loss);
* ZeRO v1 under the smap 1F1B at ``stage:2,data:2``, three Adam steps,
  with a micro-batch one of whose data shards has no masked token;
* ResNet's batch norm over ``data:2`` (the global batch's statistics)
  and its classifier head under ``split(2)`` over ``model:2``.

Losses within 1e-5 relative (ZeRO's trajectory 2e-5), gradients within
1e-4 by normalized error, batch statistics and logits within 1e-5.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
from easyparallellibrary_tpu.models import bert as jbert
from easyparallellibrary_tpu.models import resnet as jresnet
from easyparallellibrary_tpu.ops.losses import (
    distributed_sparse_softmax_cross_entropy_with_logits as jce)
from easyparallellibrary_tpu.parallel import (
    TrainState, create_sharded_train_state, parallelize)
from easyparallellibrary_tpu_torch.testing import bert_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=16)
DEADLINE = 300
LOSS_RTOL, GRAD_LIMIT, OUT_TOL = 1e-5, 1e-4, 1e-5
PIPE = dict(pipeline_stages=2, num_micro_batch=4)
RESNET = dict(stage_sizes=(1, 1), num_filters=8, num_classes=16,
              norm_groups=4)

# name: (port mesh, Config entries, model overrides, batch kind)
CASES = {
    "vmap_gpipe": ("stage:2", {"pipeline.engine": "",
                               "pipeline.strategy": "PreferForward"},
                   PIPE, "dense"),
    "smap_gpipe": ("stage:2", {"pipeline.engine": "smap",
                               "pipeline.strategy": "PreferForward"},
                   PIPE, "dense"),
    "smap_1f1b": ("stage:2", {"pipeline.engine": "smap",
                              "pipeline.strategy": "PreferBackward"},
                  PIPE, "dense"),
    "smap_interleaved": ("stage:2", {"pipeline.engine": "smap",
                                     "pipeline.strategy": "PreferBackward"},
                         dict(PIPE, pipeline_interleave=2, num_layers=4),
                         "dense"),
    "tp": ("model:2", {}, {"tensor_parallel": True}, "dense"),
    "ring_sparse": ("seq:2", {"sequence.ring_impl": "dense"},
                    {"attn_impl": "ring", "seq_parallel": True},
                    "first_tokens"),
    "ulysses": ("seq:2", {"sequence.ulysses_impl": "einsum"},
                {"attn_impl": "ulysses", "seq_parallel": True}, "dense"),
    "dp_sparse": ("data:2", {}, {}, "first_rows"),
    # The smap 1F1B with ring attention on stage 2 x seq 2, every micro-
    # batch's masked tokens in seq rank 0's half.
    "smap_ring_sparse": ("stage:2,seq:2", {
        "pipeline.engine": "smap", "pipeline.strategy": "PreferBackward",
        "sequence.ring_impl": "dense"},
        dict(PIPE, attn_impl="ring", seq_parallel=True), "first_tokens"),
}


def _world(name):
  return int(np.prod([int(p.split(":")[1])
                      for p in CASES[name][0].split(",")]))


TWO = [n for n in CASES if _world(n) == 2]
FOUR = [n for n in CASES if _world(n) == 4]


def _numpy_tree(tree):
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _port_tree(tree):
  return {k: v.numpy() for k, v in from_jax_params(
      _numpy_tree(tree), device="cpu").items()}


def _rel(got, want):
  return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batch(kind, B=16, S=8, seed=0):
  r = np.random.RandomState(seed)
  mask = (r.rand(B, S) < 0.3).astype(np.float32)
  if kind == "first_tokens":     # seq rank 1's tokens: no masked token
    mask[:, S // 2:] = 0.0
  elif kind == "first_rows":     # data rank 1's rows: no masked token
    mask[B // 2:] = 0.0
  return {"ids": r.randint(0, 64, (B, S)).astype(np.int32),
          "labels": r.randint(0, 64, (B, S)).astype(np.int32),
          "mask": mask}


def _per_shard_ratio_mean(ce, mask, axis):
  """The mean of the two shards' own ratios (over rows or tokens) of the
  per-token cross-entropy ``ce``: what a per-shard ratio would report."""
  parts = []
  for c, m in zip(np.split(ce, 2, axis), np.split(mask, 2, axis)):
    parts.append((c * m).sum() / max(m.sum(), 1.0))
  return float(np.mean(parts))


def _jax_mesh(mesh_shape, conf):
  """The port's mesh spec on as many of the CPU devices."""
  n = int(np.prod([int(p.split(":")[1]) for p in mesh_shape.split(",")]))
  jepl.init(jepl.Config({**conf, "cluster.mesh_shape": mesh_shape}),
            devices=jax.devices()[:n])
  return jepl.Env.get().cluster.build_mesh()


def _jax_model(name):
  mesh_shape, conf, over, _ = CASES[name]
  mesh = _jax_mesh(mesh_shape, conf)
  return mesh, jbert.Bert(jbert.BertConfig(**dict(TINY, **over),
                                           dtype=jnp.float32))


def _init_key(name):
  """Cases whose models share one parameter structure share one init:
  the plain encoder (TP, ring, Ulysses, DP), the two-stage stack (and
  its ring case), and the interleaved one."""
  over = CASES[name][2]
  if "pipeline_stages" not in over:
    return "plain"
  return "interleaved" if over.get("pipeline_interleave", 1) > 1 else "pipe"


def _jax_init(name, cache):
  """The JAX model's initial parameters (port layout) and the batch; the
  plain encoder is initialised as ``attn_impl="xla"`` on one device
  (the same tree)."""
  key = _init_key(name)
  if key not in cache:
    if key == "plain":
      jepl.init(devices=jax.devices()[:1])
      model = jbert.Bert(jbert.BertConfig(**TINY, dtype=jnp.float32))
    else:
      _, model = _jax_model(name if key == "interleaved" else "smap_1f1b")
    ids = jnp.asarray(_batch("dense")["ids"])
    params = jax.jit(lambda r: model.init(r, ids)["params"])(
        jax.random.PRNGKey(0))
    cache[key] = (_port_tree(params), params)
  port, params = cache[key]
  return {"params": port, "batch": _batch(CASES[name][3]), "jax": params}


def _jax_grads(name, init):
  """The JAX function of the case's name: its loss and gradients, and
  for a sparse mask what per-shard ratios would report."""
  mesh, model = _jax_model(name)
  conf, kind = CASES[name][1], CASES[name][3]
  jb = {k: jnp.asarray(v) for k, v in init["batch"].items()}
  params = init["jax"]
  if conf.get("pipeline.engine") == "smap":
    fn = jbert.make_bert_smap_grad_fn(
        model, mesh, schedule="gpipe" if "gpipe" in name else "1f1b")
    (loss, _), g = jax.jit(lambda p: fn(p, jb, None))(params)
  else:
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jbert.bert_mlm_loss(model, p, jb)[0]))(params)
  out = {"loss": float(loss), "grads": _port_tree(g)}
  if kind != "dense":
    ce = jax.jit(lambda p: jce(jb["labels"], model.apply(
        {"params": p}, jb["ids"])))(params)
    out["per_shard"] = _per_shard_ratio_mean(
        np.asarray(ce), init["batch"]["mask"],
        1 if kind == "first_tokens" else 0)
  return out


ZERO_CONF = {"pipeline.engine": "smap", "pipeline.strategy": "PreferBackward",
             "zero.level": "v1"}
ZERO_KW = dict(TINY, pipeline_stages=2, num_micro_batch=2)


def _zero_batch():
  """8 rows, M = 2, data 2: rows 0-1 and 6-7 carry two masked tokens
  each, rows 2-5 none.  Every micro-batch holds four masked tokens in
  the JAX grouping (rows 0-3, 4-7) and in the port's (each rank's m-th
  pair: rows 0-1 with 4-5, 2-3 with 6-7), so the mean of the per
  micro-batch ratios is the same, and in each grouping one data shard
  of a micro-batch has none."""
  r = np.random.RandomState(7)
  mask = np.zeros((8, 8), np.float32)
  for row in (0, 1, 6, 7):
    mask[row, r.choice(8, 2, replace=False)] = 1.0
  return {"ids": r.randint(0, 64, (8, 8)).astype(np.int32),
          "labels": r.randint(0, 64, (8, 8)).astype(np.int32),
          "mask": mask}


def _jax_zero_state():
  """The JAX ZeRO v1 state on ``stage:2,data:2`` (4 devices)."""
  mesh = _jax_mesh("stage:2,data:2", ZERO_CONF)
  model = jbert.Bert(jbert.BertConfig(**ZERO_KW, dtype=jnp.float32))
  ids = jnp.asarray(_zero_batch()["ids"])

  def init_fn(rng):
    return TrainState.create(apply_fn=model.apply,
                             params=model.init(rng, ids)["params"],
                             tx=optax.adam(1e-2))

  state, sh = create_sharded_train_state(init_fn, mesh, jax.random.PRNGKey(0))
  return mesh, model, state, sh


def _jax_zero(steps=3):
  """Three Adam steps of JAX ``make_bert_train_step`` under ZeRO v1 on
  ``stage:2,data:2``."""
  mesh, model, state, sh = _jax_zero_state()
  batch = {k: jnp.asarray(v) for k, v in _zero_batch().items()}
  step = parallelize(jbert.make_bert_train_step(model), mesh, sh)
  losses = []
  for i in range(steps):
    state, m = step(state, batch, jax.random.PRNGKey(i))
    losses.append(float(m["loss"]))
  return losses


def _resnet_data():
  r = np.random.RandomState(3)
  return (r.randn(8, 16, 16, 3).astype(np.float32), r.randint(0, 16, (8,)))


def _resnet_models():
  bn = jresnet.ResNet(jresnet.ResNetConfig(**RESNET, norm="batch",
                                           dtype=jnp.float32))
  gn = jresnet.ResNet(jresnet.ResNetConfig(**RESNET, dtype=jnp.float32))
  return bn, gn


def _split_env():
  jepl.init(devices=jax.devices()[:2])
  with jepl.split(2):
    pass
  jepl.Env.get().cluster.build_mesh(model=2)


def _resnet_init():
  x, _ = _resnet_data()
  bn, gn = _resnet_models()
  jepl.init(devices=jax.devices()[:1])
  v = jax.jit(lambda r: bn.init(r, jnp.asarray(x[:1]), train=False))(
      jax.random.PRNGKey(0))
  _split_env()

  def split_init(r):
    with jepl.split(2):
      return gn.init(r, jnp.asarray(x[:1]))["params"]

  params = jax.jit(split_init)(jax.random.PRNGKey(1))
  assert params["head"]["kernel"].names == (None, "model")
  return {"bn": v, "split": params}


def _resnet_refs(init):
  """JAX batch-norm ResNet on the global batch (train mode: new
  statistics, loss, gradients) and the ``split(2)`` head model on a
  ``model:2`` mesh (logits, the distributed CE, gradients)."""
  x, y = _resnet_data()
  bn, gn = _resnet_models()
  jepl.init(devices=jax.devices()[:1])
  v = init["bn"]

  def bn_loss(p):
    logits, new = bn.apply({"params": p, "batch_stats": v["batch_stats"]},
                           jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(y))), new

  (loss, new), g = jax.jit(jax.value_and_grad(bn_loss, has_aux=True))(
      v["params"])
  out = {"bn": {"loss": float(loss), "stats": _port_tree(new["batch_stats"]),
                "grads": _port_tree(g)}}
  _split_env()

  def head_loss(p):
    with jepl.split(2):
      logits = gn.apply({"params": p}, jnp.asarray(x))
    return jnp.mean(jce(jnp.asarray(y), logits)), logits

  (loss, logits), g = jax.jit(jax.value_and_grad(head_loss, has_aux=True))(
      init["split"])
  out["split"] = {"loss": float(loss), "logits": np.asarray(logits),
                  "grads": _port_tree(g)}
  return out


def _bert_kwargs(name):
  return dict(TINY, **CASES[name][2])


@pytest.fixture(scope="module")
def runs():
  """The JAX initial parameters first; then both rank groups start (in
  threads: the ranks are processes of their own) while this process
  computes the JAX references; then their results."""
  cache = {}
  inits = {name: _jax_init(name, cache) for name in CASES}
  zero0 = _port_tree(_jax_zero_state()[2].params)
  rinit = _resnet_init()
  x, y = _resnet_data()
  def grads_case(n):
    return ("bert_grads", (CASES[n][0], CASES[n][1], _bert_kwargs(n),
                           inits[n]["params"], inits[n]["batch"]))

  cases = [grads_case(n) for n in TWO]
  cases.append(("resnet_data_parallel", (
      dict(RESNET, norm="batch"), _port_tree(rinit["bn"]["params"]),
      _port_tree(rinit["bn"]["batch_stats"]), x, y)))
  cases.append(("resnet_split_head", (RESNET, _port_tree(rinit["split"]),
                                      x, y)))
  zero = ("bert_train", ("stage:2,data:2", ZERO_CONF, ZERO_KW, zero0,
                         [_zero_batch()] * 3, 1e-2))
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    two = pool.submit(spawn, bert_workers.suite, 2, (cases,),
                      timeout_s=DEADLINE)
    four = pool.submit(spawn, bert_workers.suite, 4,
                       ([grads_case(n) for n in FOUR] + [zero],),
                       timeout_s=DEADLINE)
    refs = {name: _jax_grads(name, inits[name]) for name in CASES}
    refs["zero"] = _jax_zero()
    refs["resnet"] = _resnet_refs(rinit)
    ranks = two.result()
    ranks4 = four.result()
  names = TWO + ["resnet_bn", "resnet_split"]
  by_case = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
  by_case.update({n: [r[i] for r in ranks4] for i, n in enumerate(FOUR)})
  return refs, by_case, [r[-1] for r in ranks4]


DISPATCH = {"vmap_gpipe": ("vmap", "gpipe", None),
            "smap_gpipe": ("smap", "gpipe", None),
            "smap_1f1b": ("smap", "1f1b", None),
            "smap_interleaved": ("smap", "interleaved", None),
            "smap_ring_sparse": ("smap", "1f1b", None)}


@pytest.mark.parametrize("name", list(CASES))
def test_bert_engines_equal_jax(name, runs):
  """Each engine's loss on every rank and the gathered gradients, against
  the JAX function of the same name; the sparse-mask cases are ones a
  per-shard ratio would get wrong."""
  refs, ranks2, _ = runs
  ref = refs[name]
  for r in ranks2[name]:
    np.testing.assert_allclose(r["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert tuple(r["dispatch"]) == DISPATCH.get(name, ("autodiff", None,
                                                       None))
  if "per_shard" in ref:
    assert abs(ref["per_shard"] - ref["loss"]) > 0.2 * ref["loss"], ref
  got = bert_workers.gather(ranks2[name], _bert_kwargs(name))
  assert sorted(got) == sorted(ref["grads"])
  worst = {k: _rel(got[k], ref["grads"][k]) for k in got}
  assert max(worst.values()) <= GRAD_LIMIT, worst


@pytest.mark.quick
def test_zero_v1_under_smap_with_a_sparse_shard_equals_jax(runs):
  """ZeRO v1 under the smap 1F1B on ``stage:2,data:2``: three Adam steps
  on a batch where a data shard of each micro-batch holds no masked
  token, every rank's losses within 2e-5 of the JAX engine's under the
  same level, each rank with half the moments of a replicated state."""
  refs, _, ranks4 = runs
  want = refs["zero"]
  for r in ranks4:
    np.testing.assert_allclose(r["losses"], want, rtol=2e-5)
    assert tuple(r["dispatch"]) == ("smap", "1f1b", None)
  assert want[-1] < want[0]


def test_resnet_batch_norm_over_data_equals_jax_global_batch(runs):
  """Two data ranks, four images each: the new running statistics equal
  JAX's over the eight (1e-5), the loss and the gradients too."""
  refs, ranks2, _ = runs
  ref = refs["resnet"]["bn"]
  for r in ranks2["resnet_bn"]:
    assert r["stats"].keys() == ref["stats"].keys()
    for k, v in ref["stats"].items():
      np.testing.assert_allclose(r["stats"][k], v, rtol=OUT_TOL,
                                 atol=OUT_TOL, err_msg=k)
    np.testing.assert_allclose(r["loss"], ref["loss"], rtol=LOSS_RTOL)
    for k, v in ref["grads"].items():
      assert _rel(r["grads"][k], v) <= GRAD_LIMIT, k


def test_resnet_split_head_equals_jax(runs):
  """``split(2)`` over ``model:2``: each rank holds half the classes of
  the head; the gathered logits, the distributed cross-entropy and the
  gradients (the head's halves put back together) equal JAX's."""
  refs, ranks2, _ = runs
  ref = refs["resnet"]["split"]
  ranks = sorted(ranks2["resnet_split"], key=lambda r: r["coords"]["model"])
  for r in ranks:
    np.testing.assert_allclose(r["logits"], ref["logits"], rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(r["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert r["grads"]["head.weight"].shape[0] == RESNET["num_classes"] // 2
  for k, v in ref["grads"].items():
    if k.startswith("head."):
      got = np.concatenate([r["grads"][k] for r in ranks], axis=0)
    else:
      got = ranks[0]["grads"][k]
      np.testing.assert_allclose(ranks[1]["grads"][k], got, rtol=1e-6,
                                 atol=1e-7)
    assert _rel(got, v) <= GRAD_LIMIT, k
