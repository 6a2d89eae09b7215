"""Tensor parallelism of the port (``tensor_parallel=True`` on a gloo
``model`` axis of two processes) against the JAX package's GSPMD
tensor parallelism on its 8-device CPU mesh.

The port runs in ranks started by ``utils.launcher.spawn`` (each test
its own group, with a deadline); JAX runs in this process.  Both take
the same numpy inputs, and the port's parameters are the JAX package's
own initialised ones, bridged (``weights.from_jax_params``) and cut per
rank (``weights.shard_params``).
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
from easyparallellibrary_tpu.models.gpt import gpt_loss as jax_gpt_loss
from easyparallellibrary_tpu.parallel import (
    TrainState, create_sharded_train_state)
from easyparallellibrary_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine, NgramDrafter as JaxNgram,
    Request as JaxRequest)
from easyparallellibrary_tpu.serving.speculative import (
    DraftModelDrafter as JaxDraftModelDrafter)
from easyparallellibrary_tpu_torch.testing import tp_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
# Every multi-rank call's deadline (seconds): a hung collective fails
# the test instead of the run.
DEADLINE = 120


def _numpy_tree(params):
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def _port_params(jparams):
  return {k: v.numpy() for k, v in
          from_jax_params(_numpy_tree(jparams), device="cpu").items()}


def _prompts(lengths, seed=0):
  r = np.random.RandomState(seed)
  return [r.randint(0, 64, (n,)).astype(np.int32) for n in lengths]


def _jax_tp_state(cfg_kwargs, seed=5, mesh_shape="data:4,model:2"):
  jepl.init(jepl.Config({"cluster.mesh_shape": mesh_shape}))
  mesh = jepl.Env.get().cluster.build_mesh()
  model = JaxGPT(JaxGPTConfig(**cfg_kwargs, dtype=jnp.float32,
                              tensor_parallel=True))

  def init_fn(rng):
    return TrainState.create(
        apply_fn=model.apply,
        params=model.init(rng, jnp.zeros((1, 4), jnp.int32))["params"],
        tx=optax.sgd(0.1))

  state, _ = create_sharded_train_state(init_fn, mesh,
                                        jax.random.PRNGKey(seed))
  return model, state.params, mesh


def _jax_streams(model, params, mesh, prompts, max_new, paged, drafter=None,
                 first_wave=2, **kw):
  eng = JaxEngine(model, params, mesh=mesh, drafter=drafter, paged=paged,
                  **kw)
  for i in range(first_wave):
    eng.submit(JaxRequest(uid=i, prompt=prompts[i],
                          max_new_tokens=max_new[i]))
  out = {}
  for fin in eng.step():
    out[fin.uid] = fin.tokens
  for i in range(first_wave, len(prompts)):
    eng.submit(JaxRequest(uid=i, prompt=prompts[i],
                          max_new_tokens=max_new[i]))
  out.update(eng.run())
  return out


def _assert_streams_equal(got, want):
  assert sorted(got) == sorted(want)
  for uid in want:
    np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                  err_msg=f"req {uid}")


@pytest.mark.quick
@pytest.mark.parametrize("layout", ["paged", "slot", "paged_ngram"])
def test_tp2_engine_staggered_streams_equal_jax(layout):
  """The setup of JAX ``test_paged_tp2_staggered_exact_vs_nonpaged_engine``
  (TINY, ``data:4,model:2``, 2 slots, chunk 4, blocks of 4, staggered
  admission): the port's TP=2 paged and slot engines, and the paged
  engine with ``NgramDrafter(k=2)``, give greedy streams token-equal to
  the JAX engine's on the same weights."""
  model, params, mesh = _jax_tp_state(TINY)
  prompts = _prompts((4, 7, 2, 5), seed=1)
  max_new = [5] * 4
  paged = layout != "slot"
  kw = dict(num_slots=2, prefill_chunk=4, block_size=4)
  want = _jax_streams(model, params, mesh, prompts, max_new, paged,
                      drafter=JaxNgram(k=2) if layout == "paged_ngram"
                      else None, **kw)
  ranks = spawn(tp_workers.tp_engine_streams, 2,
                ("model:2", TINY, _port_params(params), prompts, max_new,
                 dict(kw, paged=paged),
                 ("ngram", 2) if layout == "paged_ngram" else None),
                timeout_s=DEADLINE)
  _assert_streams_equal(ranks[0]["streams"], want)
  assert ranks[1]["follower_steps"] == ranks[0]["steps"]


UNEVEN = dict(TINY, vocab_size=65, d_ff=66)


def _cut(full, like):
  """A JAX-layout (possibly padded) tensor cut to the port's logical
  shape."""
  t = torch.from_numpy(np.asarray(full))
  for dim, size in enumerate(like.shape):
    t = t.narrow(dim, 0, size)
  return t.numpy()


@pytest.mark.parametrize("widths", ["even", "uneven"])
def test_tp2_gpt_logits_loss_and_grads_equal_jax(widths):
  """TINY GPT with ``tensor_parallel=True`` at tp = 2 (gloo) against JAX
  on ``data:4,model:2``: logits, the loss and the parameter gradients
  (plain and chunked tied CE, vocab-parallel) within 1e-5.  The uneven
  widths (vocab 65, d_ff 66 -> padded columns) go through the padded
  layers of both packages."""
  from easyparallellibrary_tpu_torch.models.gpt import GPTConfig
  from easyparallellibrary_tpu_torch.weights import unshard_params
  cfg_kwargs = TINY if widths == "even" else dict(TINY, vocab_size=65,
                                                 d_ff=65)
  model, params, mesh = _jax_tp_state(cfg_kwargs)
  ids = np.random.RandomState(2).randint(0, cfg_kwargs["vocab_size"],
                                         (4, 17)).astype(np.int32)
  port = _port_params(params)
  ranks = spawn(tp_workers.gpt_logits_and_loss, 2,
                ("model:2", cfg_kwargs, port, ids, (0, 8)),
                timeout_s=DEADLINE)
  want_logits = np.asarray(model.apply({"params": params}, ids[:, :-1]))
  for r in range(2):
    np.testing.assert_allclose(ranks[r][0], want_logits, rtol=1e-5,
                               atol=1e-5)
  tcfg = GPTConfig(**cfg_kwargs, dtype=torch.float32, tensor_parallel=True)
  for i, chunk in enumerate((0, 8)):
    jmodel = JaxGPT(JaxGPTConfig(**cfg_kwargs, dtype=jnp.float32,
                                 tensor_parallel=True, loss_chunk=chunk))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_gpt_loss(jmodel, p, {"ids": jnp.asarray(ids)}),
        has_aux=True)(params)
    jgrads = from_jax_params(_numpy_tree(jgrads), device="cpu")
    assert abs(ranks[0][1][i][0] - float(jloss)) < 1e-5
    assert ranks[0][1][i][0] == ranks[1][1][i][0]
    got = unshard_params([{k: torch.from_numpy(v) for k, v in
                           ranks[r][1][i][1].items()} for r in range(2)],
                         tcfg)
    for name, g in got.items():
      np.testing.assert_allclose(g.numpy(), _cut(jgrads[name], g),
                                 rtol=1e-5, atol=1e-5, err_msg=name)


def test_tp2_draft_model_with_prefix_cache_streams_equal_jax():
  """A tensor-parallel draft model (1 layer, width 16, k=4) on the TP=2
  paged engine with the prefix cache on, staggered requests with shared
  prefixes: token-equal to the JAX engine with its draft model on the
  same mesh; every rank runs the rollouts, prefix hits occur."""
  model, params, mesh = _jax_tp_state(TINY)
  dcfg = dict(TINY, num_layers=1, d_model=16, d_ff=32)
  dmodel, dparams, _ = (JaxGPT(JaxGPTConfig(**dcfg, dtype=jnp.float32,
                                            tensor_parallel=True)),
                        None, None)
  dstate, _ = create_sharded_train_state(
      lambda rng: TrainState.create(
          apply_fn=dmodel.apply,
          params=dmodel.init(rng, jnp.zeros((1, 4), jnp.int32))["params"],
          tx=optax.sgd(0.1)), mesh, jax.random.PRNGKey(9))
  shared = np.arange(1, 9, dtype=np.int32)
  prompts = [np.concatenate([shared, p]) for p in _prompts((3, 1, 6, 2),
                                                           seed=3)]
  max_new = [6, 7, 5, 4]
  kw = dict(num_slots=2, prefill_chunk=8, block_size=4, prefix_cache=True)
  want = _jax_streams(
      model, params, mesh, prompts, max_new, True,
      drafter=JaxDraftModelDrafter(dmodel, dstate.params, k=4, mesh=mesh),
      **kw)
  ranks = spawn(tp_workers.tp_engine_streams, 2,
                ("model:2", TINY, _port_params(params), prompts, max_new,
                 dict(kw, paged=True),
                 ("draft", dcfg, _port_params(dstate.params), 4, True)),
                timeout_s=DEADLINE)
  _assert_streams_equal(ranks[0]["streams"], want)
  assert ranks[0]["prefix_hits"] > 0


def test_engine_mesh_rules():
  """What the TP engine refuses: heads that do not divide the model axis
  (the JAX package replicates such a cache instead), and a mesh with a
  data axis above 1 (the router replicates engines)."""
  ranks = spawn(tp_workers.engine_mesh_errors, 2, (), timeout_s=DEADLINE)
  for r in range(2):
    assert "num_heads (3) divisible" in ranks[r]["heads"]
    assert "serving.router" in ranks[r]["data"]


# ------------------------------------------------------------- layers


@pytest.mark.parametrize("widths", ["even", "uneven"])
def test_tp2_layers_and_vocab_ce_equal_jax(widths):
  """``Dense(parallel="column"|"row")``, the vocab ``Embedding`` and the
  vocab-parallel CE (and its gradient) at tp = 2 against the JAX layers
  on ``data:4,model:2`` in fp32, within 1e-5; uneven widths (hidden 11,
  vocab 13) run the zero-padded layouts.  The bf16 CE keeps the fp32
  label gradient ``p - 1`` of a confident prediction, as JAX
  ``test_bf16_ce_label_grad_survives_confident_prediction``."""
  from easyparallellibrary_tpu import ops as jops
  sizes = dict(zip(("in", "hidden", "out", "vocab"),
                   (16, 12, 6, 14) if widths == "even" else (16, 11, 6, 13)))

  class Layers(nn.Module):
    @nn.compact
    def __call__(self, x, ids):
      h = jops.Dense(sizes["hidden"], parallel="column", name="col")(x)
      y = jops.Dense(sizes["out"], parallel="row", name="row")(nn.relu(h))
      emb = jops.Embedding(sizes["vocab"], sizes["in"], parallel="vocab",
                           name="emb")
      return h, y, emb(ids), emb.attend(x)

  jepl.init(jepl.Config({"cluster.mesh_shape": "data:4,model:2"}))
  jepl.Env.get().cluster.build_mesh()
  r = np.random.RandomState(4)
  x = r.randn(4, 16).astype(np.float32)
  ids = r.randint(0, sizes["vocab"], (4, 3)).astype(np.int32)
  labels = r.randint(0, sizes["vocab"], (4,)).astype(np.int32)
  layers = Layers()
  params = layers.init(jax.random.PRNGKey(0), x, ids)["params"]
  h, y, e, logits = layers.apply({"params": params}, x, ids)

  def objective(xx):
    return jnp.sum(layers.apply({"params": params}, xx, ids)[1]
                   * jnp.arange(y.size).reshape(y.shape))

  dx = jax.grad(objective)(jnp.asarray(x))
  ce_fn = jops.distributed_sparse_softmax_cross_entropy_with_logits
  ce = ce_fn(jnp.asarray(labels), logits)
  ce_grad = jax.grad(lambda lg: jnp.sum(ce_fn(jnp.asarray(labels), lg)))(
      logits)
  flat = {f"{a}/{b}": np.asarray(v) for a, sub in
          _numpy_tree(params).items() for b, v in sub.items()}
  ranks = spawn(tp_workers.dense_layers, 2, (flat, x, ids, labels, sizes),
                timeout_s=DEADLINE)
  want = {"column": h, "column_row": y, "row_replicated_in": y,
          "column_row_dx": dx, "embed": e, "attend": logits,
          "argmax": jnp.argmax(logits, -1), "ce": ce, "ce_grad": ce_grad}
  for rank in range(2):
    for key, w in want.items():
      np.testing.assert_allclose(ranks[rank][key], np.asarray(w),
                                 rtol=1e-5, atol=1e-5,
                                 err_msg=f"{key} rank {rank}")
  p = jax.nn.softmax(jnp.asarray([10.0, 0, 0, 0]))[0]
  got = float(ranks[0]["bf16_label_grad"])
  assert got != 0.0
  np.testing.assert_allclose(got, float(p - 1.0), rtol=0.02)


# ------------------------------------------------------------- training


def _jax_train_losses(cfg_kwargs, params, batches, lr, mesh_shape,
                      num_devices=8, tp=True):
  from easyparallellibrary_tpu.parallel import make_train_step, parallelize
  jepl.init(jepl.Config({"cluster.mesh_shape": mesh_shape}),
            devices=jax.devices()[:num_devices])
  mesh = jepl.Env.get().cluster.build_mesh()
  model = JaxGPT(JaxGPTConfig(**cfg_kwargs, dtype=jnp.float32,
                              tensor_parallel=tp, loss_chunk=8))
  tx = optax.adamw(lr, weight_decay=0.01)
  state, sh = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model.apply, params=params, tx=tx),
      mesh)
  step = parallelize(make_train_step(
      lambda p, b, r: jax_gpt_loss(model, p, b, r)), mesh, sh)
  losses = []
  for batch in batches:
    state, m = step(state, {"ids": jnp.asarray(batch)},
                    jax.random.PRNGKey(0))
    losses.append(float(m["loss"]))
  return losses


@pytest.mark.parametrize("mesh_shape,world", [("model:2", 2),
                                              ("data:2,model:2", 4)],
                         ids=["tp2", "dp2_tp2"])
def test_tp_training_trajectory_equals_jax_and_tp1(mesh_shape, world):
  """Five AdamW steps of TINY GPT (chunked tied CE, loss_chunk 8)
  through ``create_sharded_train_state`` / ``parallelize``: at tp = 2,
  and on a ``data:2,model:2`` hybrid at world 4, the loss trajectory
  equals JAX's TP ``parallelize`` step and the port's tp = 1 within
  rtol 1e-4, atol 1e-5 (``test_tp_matches_unsharded``'s tolerance)."""
  _, params, _ = _jax_tp_state(TINY, seed=7)
  r = np.random.RandomState(11)
  batches = [r.randint(0, 64, (4, 17)).astype(np.int32) for _ in range(5)]
  want = _jax_train_losses(TINY, params, batches, 1e-2, mesh_shape,
                           num_devices=world)
  port = _port_params(params)
  tp1 = tp_workers.gpt_train_losses(0, 1, "", dict(TINY, loss_chunk=8),
                                    port, batches, 1e-2)
  ranks = spawn(tp_workers.gpt_train_losses, world,
                (mesh_shape, dict(TINY, loss_chunk=8), port, batches, 1e-2),
                timeout_s=DEADLINE)
  for rank in range(world):
    np.testing.assert_allclose(ranks[rank]["losses"], want, rtol=1e-4,
                               atol=1e-5, err_msg=f"rank {rank}")
  np.testing.assert_allclose(ranks[0]["losses"], tp1["losses"], rtol=1e-4,
                             atol=1e-5)
  assert ranks[0]["specs"]["block_0.attn.qkv.weight"] == ("model", None)
  assert ranks[0]["specs"]["block_0.mlp.wo.weight"] == (None, "model")


def test_row_dense_overlap_ring_equals_overlap_off():
  """The row-parallel Dense through the overlap ring
  (``communication.overlap="on"``: matmul -> ring reduce-scatter ->
  all-gather) equals the fused all-reduce (``"off"``) in the output and
  both gradients, within 1e-6.  Held against ``"off"``: the JAX
  ``"on"`` path is a reference caveat (ROADMAP Queue 3)."""
  r = np.random.RandomState(5)
  x = r.randn(8, 12).astype(np.float32)
  w = r.randn(12, 6).astype(np.float32)
  b = r.randn(6).astype(np.float32)
  ranks = spawn(tp_workers.row_dense_overlap, 2, (x, w, b),
                timeout_s=DEADLINE)
  for rank in range(2):
    for key in ("y", "dx", "dw"):
      np.testing.assert_allclose(ranks[rank]["on"][key],
                                 ranks[rank]["off"][key], rtol=1e-6,
                                 atol=1e-6, err_msg=f"{key} rank {rank}")
  np.testing.assert_allclose(ranks[0]["off"]["y"], x @ w + b, rtol=1e-5,
                             atol=1e-5)


def test_multiprocess_resume_disagreement_raises(tmp_path):
  """``fit``'s multi-process resume check (``runtime/loop.py``): a rank
  whose restore fell back to an older checkpoint than the leader's
  refuses to train on diverged states; the leader's restore stands."""
  ranks = spawn(tp_workers.resume_disagreement, 2, (str(tmp_path),),
                timeout_s=DEADLINE)
  assert ranks[0] == ""
  assert "multi-process resume disagreement" in ranks[1]
  assert "leader restored step 3" in ranks[1]
  assert "restored 2" in ranks[1]


def test_row_dense_site_bytes_measured_by_the_profiler():
  """Per-site collective bytes from a ``torch.profiler`` count of the
  site's collectives (``observability.device.profile_site_bytes``):
  the row-parallel Dense's fused all-reduce hands ``rows * d_out * 4``
  bytes to gloo, recorded for ``layers/row_dense`` and read back by the
  overlap policy's ``measured_collective_bytes``."""
  ranks = spawn(tp_workers.row_dense_site_bytes, 2, (8, 16, 6),
                timeout_s=DEADLINE)
  for rank in range(2):
    assert ranks[rank]["registered"]
    assert ranks[rank]["wire"] == 8 * 6 * 4
    assert ranks[rank]["read_back"] == 8 * 6 * 4


def test_not_ported_names_no_done_item():
  """Items 9 (the tensor-parallel mesh) and 11 (the runtime around the
  step) are done: nothing raises with their names any more."""
  from easyparallellibrary_tpu_torch import _not_ported
  assert not hasattr(_not_ported, "TENSOR_PARALLEL")
  assert not hasattr(_not_ported, "RUNTIME")


# ------------------------------------------- single-process bookkeeping


class _Pool:
  """A stand-in with the cluster attribute the layouts read."""

  def __init__(self, n):
    self.num_devices = n


@pytest.mark.parametrize("n,requested", [
    (8, dict(model=2)), (8, dict(model=4, stage=1)), (4, dict(model=2)),
    (8, dict()), (6, dict(model=2)), (8, dict(model=2, data=4))])
def test_layouts_size_the_mesh_as_jax(n, requested):
  """``AutoLayout`` / ``AllLayout`` / ``SpecificLayout`` give the JAX
  layouts' axis sizes for the same device count and request."""
  from easyparallellibrary_tpu import cluster as jcluster
  from easyparallellibrary_tpu_torch import cluster as tcluster
  for jl, tl in ((jcluster.AutoLayout(), tcluster.AutoLayout()),
                 (jcluster.AllLayout(), tcluster.AllLayout())):
    assert tl.axis_sizes(_Pool(n), requested) == jl.axis_sizes(
        _Pool(n), requested)
  spec = f"data:{n // 2},model:2"
  assert (tcluster.SpecificLayout(spec).axis_sizes(_Pool(n), {})
          == jcluster.SpecificLayout(spec).axis_sizes(_Pool(n), {}))
  with pytest.raises(ValueError):
    tcluster.AutoLayout().axis_sizes(_Pool(n), dict(model=5))


def test_mesh_coordinates_and_groups_follow_the_jax_device_order():
  """Ranks lie row-major over (stage, data, seq, expert, model), model
  innermost, as the JAX mesh orders its devices: rank r's coordinates
  are those of device r in ``mesh.devices``, and each axis group holds
  the ranks along that axis."""
  from easyparallellibrary_tpu_torch import cluster as tcluster
  shape = {"stage": 1, "data": 2, "seq": 1, "expert": 1, "model": 2}
  jepl.init(jepl.Config({"cluster.mesh_shape": "data:2,model:2"}),
            devices=jax.devices()[:4])
  jmesh = jepl.Env.get().cluster.build_mesh()
  ids = np.vectorize(lambda d: d.id)(jmesh.devices)
  for rank in range(4):
    mesh = tcluster.Mesh(shape=shape, devices=(torch.device("cpu"),) * 4,
                         rank=rank)
    where = np.argwhere(ids == jax.devices()[rank].id)[0]
    assert tuple(mesh.coords.values()) == tuple(int(i) for i in where)
    assert mesh.group_ranks("model") == [rank - rank % 2, rank - rank % 2 + 1]
    assert mesh.group_ranks("data") == [rank % 2, rank % 2 + 2]


def test_kv_cache_shardings_split_heads_as_jax():
  """The cache leaf's spec is JAX ``kv_spec()`` (heads over ``model``)
  on a TP mesh, replicated without tensor parallelism; heads that do
  not divide the axis raise where JAX replicates (a listed
  difference)."""
  from easyparallellibrary_tpu.serving.kv_cache import kv_spec
  from easyparallellibrary_tpu_torch.cluster import Mesh
  from easyparallellibrary_tpu_torch.serving import kv_cache_shardings
  from easyparallellibrary_tpu_torch.testing.tp_workers import gpt_config
  mesh = Mesh(shape={"stage": 1, "data": 1, "seq": 1, "expert": 1,
                     "model": 2}, devices=(torch.device("cpu"),) * 2)
  kv, cursors = kv_cache_shardings(gpt_config(TINY, tensor_parallel=True),
                                   mesh)
  assert kv["block_1"]["attn"]["cached_key"] == tuple(kv_spec())
  assert cursors == ()
  kv, _ = kv_cache_shardings(gpt_config(TINY), mesh)
  assert kv["block_0"]["attn"]["cached_value"] == ()
  assert kv_cache_shardings(gpt_config(TINY), None) == (None, None)
  with pytest.raises(ValueError, match="replicates"):
    kv_cache_shardings(gpt_config(dict(TINY, num_heads=3, d_model=36),
                                  tensor_parallel=True), mesh)


def test_check_unpadded_vocab_is_the_jax_rule():
  from easyparallellibrary_tpu.parallel.pipeline_smap import (
      check_unpadded_vocab as jax_check)
  from easyparallellibrary_tpu_torch.cluster import Mesh
  from easyparallellibrary_tpu_torch.models.gpt import check_unpadded_vocab
  jepl.init(jepl.Config({"cluster.mesh_shape": "data:4,model:2"}))
  jmesh = jepl.Env.get().cluster.build_mesh()
  mesh = Mesh(shape={"stage": 1, "data": 4, "seq": 1, "expert": 1,
                     "model": 2}, devices=(torch.device("cpu"),) * 8)
  check_unpadded_vocab(64, mesh)
  jax_check(64, jmesh)
  with pytest.raises(ValueError, match="unpadded vocab") as got:
    check_unpadded_vocab(65, mesh)
  with pytest.raises(ValueError) as want:
    jax_check(65, jmesh)
  assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["all_gather_matmul", "matmul_reduce_scatter",
                                  "reduce_scatter"])
@pytest.mark.parametrize("m,k,n_out,axis,chunks,measured", [
    (64, 128, 256, 2, 0, None), (8192, 4096, 1024, 2, 0, None),
    (8192, 4096, 1024, 4, 2, None), (64, 64, 64, 8, 0, 5e8)])
def test_overlap_planner_decides_as_jax(kind, m, k, n_out, axis, chunks,
                                        measured):
  """``plan_collective_matmul`` and ``normalize_chunks`` are the JAX
  model unchanged: the same decision for the same constants (the port's
  defaults are the H100's, passed explicitly to both here)."""
  from easyparallellibrary_tpu.communicators.overlap import (
      normalize_chunks as jnorm)
  from easyparallellibrary_tpu.parallel.planner import (
      plan_collective_matmul as jplan)
  from easyparallellibrary_tpu_torch.communicators.overlap import (
      normalize_chunks)
  from easyparallellibrary_tpu_torch.parallel.planner import (
      DEFAULT_LINK_BYTES_PER_S, plan_collective_matmul)
  kw = dict(m=m, k=k, n_out=n_out, axis_size=axis, num_chunks=chunks,
            peak_flops=989e12, link_bytes_per_s=DEFAULT_LINK_BYTES_PER_S,
            measured_collective_bytes=measured)
  import dataclasses
  assert (dataclasses.astuple(plan_collective_matmul(kind, **kw))
          == dataclasses.astuple(jplan(kind, **kw)))
  for req in range(0, 10):
    assert normalize_chunks(req, axis) == jnorm(req, axis)
