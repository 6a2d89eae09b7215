"""The port's BERT against the JAX package's, on one process.

Same numpy inputs and the JAX package's own initialised parameters
(bridged with ``weights.from_jax_params``) on both sides, fp32: the MLM
logits, ``bert_mlm_loss`` and every gradient with ``attn_impl="xla"``
and ``"pallas_flash"`` (the port's flash runs its plain version on the
CPU, the JAX package's Pallas kernels run in interpret mode), whole-block
remat, the QA head, a pipelined model held whole by one process, a
5-step AdamW trajectory through the ``epl`` surface and
``make_bert_train_step``, the unknown-``attn_impl`` raise, and the
weights' layout both ways.  Outputs are held within 1e-5, gradients
within 1e-4 by normalized error (``||port - jax|| / ||jax||``).
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
from easyparallellibrary_tpu.models import bert as jbert
from easyparallellibrary_tpu.parallel import api as japi
from easyparallellibrary_tpu_torch.kernels import flash_attention as tfa
from easyparallellibrary_tpu_torch.models import bert as tbert
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.parallel import api as tapi
from easyparallellibrary_tpu_torch.runtime import saver as tsaver
from easyparallellibrary_tpu_torch.weights import (
    from_jax_params, init_params, stack_stages)

torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=16)
OUT_TOL, GRAD_LIMIT = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _reset_port_env():
  yield
  tepl.Env.get().reset()


def _numpy_tree(tree):
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _port(tree, grad=False):
  out = from_jax_params(_numpy_tree(tree), device="cpu")
  return {k: v.requires_grad_(True) for k, v in out.items()} if grad \
      else out


def _batch(B=2, S=16, V=64, seed=0, rate=0.3):
  r = np.random.RandomState(seed)
  return {"ids": r.randint(0, V, (B, S)).astype(np.int32),
          "labels": r.randint(0, V, (B, S)).astype(np.int32),
          "mask": (r.rand(B, S) < rate).astype(np.float32)}


def _rel(got, want):
  return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _hold_grads(got, want):
  """Normalized error within GRAD_LIMIT, plus 1e-7 rms absolute (a
  gradient that cancels to rounding noise, as the QA head's ``ln_f``
  bias under a softmax over positions, is held absolutely)."""
  assert got.keys() == want.keys()
  for name in want:
    g, w = got[name].numpy(), want[name].numpy()
    diff = float(np.linalg.norm(g - w))
    assert diff <= GRAD_LIMIT * np.linalg.norm(w) + 1e-7 * np.sqrt(w.size), \
        (name, diff, float(np.linalg.norm(w)))


def _jax_mlm(cfg_kwargs, batch, **extra):
  model = jbert.Bert(jbert.BertConfig(**cfg_kwargs, dtype=jnp.float32,
                                      **extra))
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  params = model.init(jax.random.PRNGKey(0), jb["ids"])["params"]
  logits = model.apply({"params": params}, jb["ids"])
  loss, grads = jax.value_and_grad(
      lambda p: jbert.bert_mlm_loss(model, p, jb)[0])(params)
  return params, np.asarray(logits), float(loss), grads


def _port_mlm(cfg_kwargs, params, batch, **extra):
  model = tbert.Bert(tbert.BertConfig(**cfg_kwargs, dtype=torch.float32,
                                      **extra))
  tp = _port(params, grad=True)
  tb = {k: torch.from_numpy(v) for k, v in batch.items()}
  logits = torch.func.functional_call(model, tp, (tb["ids"].long(),))
  loss, _ = tbert.bert_mlm_loss(model, tp, tb)
  loss.backward()
  return logits.detach().numpy(), loss.item(), {k: v.grad
                                                for k, v in tp.items()}


@pytest.mark.parametrize("attn", ["xla", "pallas_flash"])
def test_logits_loss_and_grads_match_jax(attn):
  batch = _batch()
  params, want_logits, want_loss, want_grads = _jax_mlm(
      TINY, batch, attn_impl=attn)
  logits, loss, grads = _port_mlm(TINY, params, batch, attn_impl=attn)
  np.testing.assert_allclose(logits, want_logits, rtol=OUT_TOL,
                             atol=OUT_TOL)
  np.testing.assert_allclose(loss, want_loss, rtol=OUT_TOL)
  _hold_grads(grads, from_jax_params(_numpy_tree(want_grads), device="cpu"))


def test_segments_and_remat_match_jax():
  """``type_ids`` through the segment table (the forward), and
  ``remat=True`` (whole-block checkpoints) with the flash path: the
  same numbers."""
  batch = _batch(seed=4)
  over = dict(attn_impl="pallas_flash", remat=True)
  params, _, want_loss, want_grads = _jax_mlm(TINY, batch, **over)
  _, loss, grads = _port_mlm(TINY, params, batch, **over)
  np.testing.assert_allclose(loss, want_loss, rtol=OUT_TOL)
  _hold_grads(grads, from_jax_params(_numpy_tree(want_grads), device="cpu"))
  types = (np.arange(16)[None] >= 8).repeat(2, 0).astype(np.int32)
  jm = jbert.Bert(jbert.BertConfig(**TINY, dtype=jnp.float32))
  want = jm.apply({"params": params}, jnp.asarray(batch["ids"]),
                  jnp.asarray(types))
  got = torch.func.functional_call(
      tbert.Bert(tbert.BertConfig(**TINY, dtype=torch.float32)),
      _port(params), (torch.from_numpy(batch["ids"]).long(),),
      {"type_ids": torch.from_numpy(types).long()})
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=OUT_TOL, atol=OUT_TOL)


def test_full_remat_runs_the_flash_forward_twice_a_layer():
  """One training step of ``remat=True``: 2L flash forwards (the
  recompute re-runs each), L dK/dV and L dQ: the count chip_smoke.py
  phase 24a holds the card's launches to."""
  cfg = tbert.BertConfig(**TINY, dtype=torch.float32,
                         attn_impl="pallas_flash", remat=True)
  model = tbert.Bert(cfg)
  params = init_params(cfg, seed=0, device="cpu")
  for p in params.values():
    p.requires_grad_(True)
  tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
  tfa.reset_counts()
  loss, _ = tbert.bert_mlm_loss(model, params, tb)
  loss.backward()
  L = TINY["num_layers"]
  assert (tfa.flash_fwd_reference.calls, tfa.flash_bwd_dkv_reference.calls,
          tfa.flash_bwd_dq_reference.calls) == (2 * L, L, L)


def test_sparse_mask_ratio_and_its_clamp_match_jax():
  """One masked token in the batch, and none: the ratio's denominator
  is the mask count clamped at 1."""
  for count in (1, 0):
    batch = _batch(seed=2)
    batch["mask"] = np.zeros_like(batch["mask"])
    if count:
      batch["mask"][1, 5] = 1.0
    params, _, want_loss, want_grads = _jax_mlm(TINY, batch)
    _, loss, grads = _port_mlm(TINY, params, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=OUT_TOL, atol=1e-7)
    if count:
      _hold_grads(grads, from_jax_params(_numpy_tree(want_grads),
                                         device="cpu"))
    else:
      assert all(float(g.abs().max()) == 0 for g in grads.values())


def test_qa_head_matches_jax():
  r = np.random.RandomState(5)
  ids = r.randint(0, 64, (2, 16)).astype(np.int32)
  batch = {"ids": ids, "start_positions": r.randint(0, 16, (2,)),
           "end_positions": r.randint(0, 16, (2,))}
  jmodel = jbert.BertForQuestionAnswering(jbert.BertConfig(
      **TINY, dtype=jnp.float32, attn_impl="pallas_flash"))
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  params = jmodel.init(jax.random.PRNGKey(0), jb["ids"])["params"]
  want_start, want_end = jmodel.apply({"params": params}, jb["ids"])
  want_loss, want_grads = jax.value_and_grad(
      lambda p: jbert.bert_qa_loss(jmodel, p, jb)[0])(params)
  model = tbert.BertForQuestionAnswering(tbert.BertConfig(
      **TINY, dtype=torch.float32, attn_impl="pallas_flash"))
  tp = _port(params, grad=True)
  assert set(tp) == {n for n, _ in model.named_parameters()}
  tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
  start, end = torch.func.functional_call(model, tp, (tb["ids"].long(),))
  assert start.dtype == end.dtype == torch.float32
  np.testing.assert_allclose(start.detach().numpy(), np.asarray(want_start),
                             rtol=OUT_TOL, atol=OUT_TOL)
  np.testing.assert_allclose(end.detach().numpy(), np.asarray(want_end),
                             rtol=OUT_TOL, atol=OUT_TOL)
  loss, _ = tbert.bert_qa_loss(model, tp, tb)
  loss.backward()
  np.testing.assert_allclose(loss.item(), float(want_loss), rtol=OUT_TOL)
  _hold_grads({k: v.grad for k, v in tp.items()},
              from_jax_params(_numpy_tree(want_grads), device="cpu"))


def test_pipelined_model_held_whole_runs_the_chunks_in_layer_order():
  """``pipeline_stages=2`` (and interleave 2) on one process: the
  stacked layout, the chunks in layer order, equal to the JAX
  ``pipeline_debug_sequential`` model on the same stacked tree."""
  base = dict(TINY, num_layers=4, pipeline_stages=2, num_micro_batch=2,
              pipeline_interleave=2)
  batch = _batch(B=4)
  jm = jbert.Bert(jbert.BertConfig(**base, dtype=jnp.float32,
                                   pipeline_debug_sequential=True))
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  params = jm.init(jax.random.PRNGKey(0), jb["ids"])["params"]
  want_loss, want_grads = jax.value_and_grad(
      lambda p: jbert.bert_mlm_loss(jm, p, jb)[0])(params)
  model = tbert.Bert(tbert.BertConfig(**base, dtype=torch.float32))
  tp = _port(params, grad=True)
  assert set(tp) == {n for n, _ in model.named_parameters()}
  flat = init_params(tbert.BertConfig(**dict(TINY, num_layers=4),
                                      dtype=torch.float32), 1, "cpu")
  assert {k: v.shape for k, v in stack_stages(flat, model.cfg).items()} \
      == {k: v.shape for k, v in tp.items()}
  loss, _ = tbert.bert_mlm_loss(model, tp, {k: torch.from_numpy(v) for k, v
                                            in batch.items()})
  loss.backward()
  np.testing.assert_allclose(loss.item(), float(want_loss), rtol=OUT_TOL)
  _hold_grads({k: v.grad for k, v in tp.items()},
              from_jax_params(_numpy_tree(want_grads), device="cpu"))


def _jax_trajectory(cfg_kwargs, batches):
  jepl.init(devices=jax.devices()[:1])
  with jepl.replicate(1):
    model = jbert.Bert(jbert.BertConfig(**cfg_kwargs, dtype=jnp.float32))
  mesh = jepl.current_plan().build_mesh()
  ids = jnp.asarray(batches[0]["ids"])

  def init_fn(rng):
    return japi.TrainState.create(
        apply_fn=model.apply, params=model.init(rng, ids)["params"],
        tx=optax.adamw(1e-3, weight_decay=0.01))

  state, shardings = japi.create_sharded_train_state(
      init_fn, mesh, jax.random.PRNGKey(0))
  params0 = _numpy_tree(state.params)
  step = japi.parallelize(jbert.make_bert_train_step(model), mesh, shardings)
  losses = []
  for b in batches:
    state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                    jax.random.PRNGKey(0))
    losses.append(float(m["loss"]))
  return params0, losses, _numpy_tree(state.params)


@pytest.mark.quick
def test_adamw_trajectory_matches_jax():
  """5 AdamW(1e-3, weight_decay=0.01) steps through init / replicate /
  build_mesh / create_sharded_train_state / parallelize(
  make_bert_train_step) on both sides from the JAX package's initial
  parameters: losses within 2e-5 relative (Adam's normalised first steps
  carry the frameworks' last-bit differences on) and the final
  parameters within 1e-4."""
  cfg = dict(TINY, attn_impl="pallas_flash")
  batches = [_batch(B=4, seed=10)] * 5
  params0, want, want_final = _jax_trajectory(cfg, batches)
  tepl.init(device="cpu")
  with tepl.replicate(1):
    model = tbert.Bert(tbert.BertConfig(**cfg, dtype=torch.float32))
  mesh = tepl.current_plan().build_mesh()
  state, shardings = tapi.create_sharded_train_state(
      lambda: tapi.TrainState.create(
          apply_fn=model, params=from_jax_params(params0, device="cpu"),
          tx=tadamw.adamw(1e-3, weight_decay=0.01)), mesh)
  step = tbert.make_bert_train_step(model)
  assert step.dispatch == ("autodiff", None, None)
  run = tapi.parallelize(step, mesh, shardings)
  got = []
  for b in batches:
    state, m = run(state, b, None)
    got.append(m["loss"].item())
  assert want[-1] < want[0]
  np.testing.assert_allclose(got, want, rtol=2e-5)
  final = from_jax_params(want_final, device="cpu")
  D = TINY["d_model"]
  for name, p in state.params.items():
    got_p, want_p = p.detach().numpy(), final[name].numpy()
    if name.endswith("qkv.bias"):
      # The key bias's gradient is 0 up to rounding (a shift of every
      # key's score by one constant a query), so Adam's normalised step
      # moves it by +-lr on noise in either package: bounded, not held.
      assert np.abs(got_p[D:2 * D]).max() <= 5 * 1e-3 * 1.01, name
      got_p, want_p = (np.concatenate([x[:D], x[2 * D:]])
                       for x in (got_p, want_p))
    assert _rel(got_p, want_p) <= GRAD_LIMIT, name


def test_unknown_attn_impl_raises_in_both_packages():
  bad = dict(vocab_size=64, num_layers=1, num_heads=2, d_model=16, d_ff=32,
             max_seq_len=16, attn_impl="flash")
  jepl.init()
  with pytest.raises(ValueError, match="attn_impl"):
    jbert.Bert(jbert.BertConfig(**bad)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
  cfg = tbert.BertConfig(**bad, dtype=torch.float32)
  params = init_params(cfg, seed=0, device="cpu")
  with pytest.raises(ValueError, match="attn_impl"):
    torch.func.functional_call(tbert.Bert(cfg), params,
                               (torch.zeros((1, 16), dtype=torch.long),))


def test_weights_layout_both_ways_and_init_statistics():
  """``init_params`` gives the JAX tree's names and shapes, with flax's
  families (normal(0.02) tables, lecun-normal kernels, unit norm
  scales); the port's saver tree (``params_tree``) is the JAX layout
  of the bridged parameters, bit for bit."""
  jm = jbert.Bert(jbert.BertConfig(**TINY, dtype=jnp.float32))
  jparams = _numpy_tree(jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 16), jnp.int32))["params"])
  flat = {}
  for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]:
    flat["/".join(p.key for p in path)] = np.asarray(v)
  back = tsaver.params_tree(from_jax_params(jparams, device="cpu"))
  assert back.keys() == flat.keys()
  for path, v in flat.items():
    np.testing.assert_array_equal(back[path].numpy(), v, err_msg=path)
  cfg = tbert.BertConfig(**dict(TINY, d_model=256, d_ff=512),
                         dtype=torch.float32)
  fresh = init_params(cfg, seed=3, device="cpu")
  jshape = jax.eval_shape(
      lambda: jbert.Bert(jbert.BertConfig(**dict(TINY, d_model=256,
                                                 d_ff=512))).init(
          jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))
  want = {k: tuple(v.shape) for k, v in from_jax_params(
      jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                             nn.meta.unbox(jshape["params"])),
      device="cpu").items()}
  assert {k: tuple(v.shape) for k, v in fresh.items()} == want
  assert abs(float(fresh["wse.weight"].std()) - 0.02) < 4e-3
  assert abs(float(fresh["wte.weight"].std()) - 0.02) < 2e-3
  std = float(fresh["block_0.wi.weight"].std())
  assert abs(std - 256 ** -0.5) < 0.05 * 256 ** -0.5, std
  assert float(fresh["ln_emb.weight"].min()) == 1.0
  assert float(fresh["block_1.qkv.bias"].abs().max()) == 0.0


SMAP_GUARDS = [
    ({"pipeline_stages": 1}, "1f1b", "needs pipeline_stages > 1"),
    ({}, "interleaved", "needs pipeline_interleave"),
    ({"pipeline_interleave": 2, "num_layers": 4}, "gpipe",
     "requires the interleaved-1F1B"),
    ({"vocab_size": 63}, "1f1b", "must divide into"),
    ({"num_layers": 3}, "1f1b", "num_layers must be divisible"),
    ({}, "zigzag", "schedule must be"),
]


@pytest.mark.parametrize("over,schedule,message", SMAP_GUARDS)
def test_smap_guards_raise_as_jax(over, schedule, message):
  """Each guard of ``make_bert_smap_grad_fn`` raises in both packages with
  the same words (the port's model may refuse the config when built)."""
  kw = dict(TINY, pipeline_stages=2, num_micro_batch=2)
  kw.update(over)
  jepl.init(jepl.Config({"pipeline.engine": "smap"}))
  with pytest.raises(ValueError, match=message):
    jbert.make_bert_smap_grad_fn(
        jbert.Bert(jbert.BertConfig(**kw, dtype=jnp.float32)),
        schedule=schedule)
  tepl.init(tepl.Config({"pipeline.engine": "smap"}), device="cpu")
  with pytest.raises(ValueError, match=message):
    tbert.make_bert_smap_grad_fn(
        tbert.Bert(tbert.BertConfig(**kw, dtype=torch.float32)),
        schedule=schedule)


def test_1f1b_without_the_smap_engine_warns_and_runs_gpipe(monkeypatch):
  """``PreferBackward`` on the ``vmap`` layout: the JAX package's warning
  (BERT has no vmapped 1F1B) and GPipe order; ``PreferForward`` warns
  nothing.  On one process without a stage axis the step trains through
  ``bert_mlm_loss``."""
  said = []

  class Recorder:
    def warning(self, msg, *args):
      said.append(msg % args)

  monkeypatch.setattr(tbert, "get_logger", lambda: Recorder())
  for strategy, warns in (("PreferBackward", True), ("PreferForward", False)):
    said.clear()
    tepl.init(tepl.Config({"pipeline.strategy": strategy}), device="cpu")
    model = tbert.Bert(tbert.BertConfig(**TINY, pipeline_stages=2,
                                        num_micro_batch=2,
                                        dtype=torch.float32))
    step = tbert.make_bert_train_step(model)
    assert step.dispatch == ("autodiff", None, None)
    assert bool(said) == warns, said
    if warns:
      assert "runs as GPipe-order autodiff unless pipeline.engine='smap'" \
          in said[0]
