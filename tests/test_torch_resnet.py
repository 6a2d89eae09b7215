"""The port's ResNet, ``MutableTrainState`` and initializers against the
JAX package's, on one process.

The JAX package's own initialised variables (params and
``batch_stats``, bridged with ``weights.from_jax_params``) and the same
numpy images on both sides, fp32: a resnet18-shaped model (stage sizes
2-2-2-2 at narrow widths) at 32 x 32 and at an odd size, so that
``SAME`` pads unevenly; group and batch norm, train and eval; the
gradients; a 3-step ``make_mutable_train_step`` trajectory with its
batch statistics; the unknown-norm raise; the weights and a checkpoint
in the JAX layout both ways; ``init_params``' families; and the Glorot
initializers' fan rule and draws.  Outputs and batch statistics within
1e-5, gradients within 1e-4 by normalized error.
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
from easyparallellibrary_tpu.models import resnet as jresnet
from easyparallellibrary_tpu.ops import initializers as jinit
from easyparallellibrary_tpu.parallel import api as japi
from easyparallellibrary_tpu.runtime import saver as jsaver
from easyparallellibrary_tpu_torch.models import resnet as tresnet
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.ops import initializers as tinit
from easyparallellibrary_tpu_torch.parallel import api as tapi
from easyparallellibrary_tpu_torch.runtime import saver as tsaver
from easyparallellibrary_tpu_torch.weights import (
    from_jax_params, init_model_state, init_params)

torch.set_num_threads(1)

R18 = dict(stage_sizes=(2, 2, 2, 2), num_filters=8, num_classes=10,
           norm_groups=4)
OUT_TOL, GRAD_LIMIT = 1e-5, 1e-4
LR = 0.05


def _sgd(lr):
  """``optax.sgd``: the trajectory test steps with plain SGD, since
  Adam's normalised first step turns a gradient that is 0 up to rounding
  (a channel that ReLU zeroes) into +-lr in either package."""
  return tadamw.Recipe(lambda params, fused=None: torch.optim.SGD(
      list(params.values()), lr=lr))


@pytest.fixture(autouse=True)
def _reset_port_env():
  yield
  tepl.Env.get().reset()


def _numpy_tree(tree):
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _port(tree):
  return from_jax_params(_numpy_tree(tree), device="cpu")


def _images(B, hw, seed=1):
  return np.random.RandomState(seed).randn(B, hw, hw, 3).astype(np.float32)


def _labels(B, classes=10, seed=2):
  return np.random.RandomState(seed).randint(0, classes, (B,))


def _models(norm, **over):
  cfg = dict(R18, norm=norm, **over)
  return (jresnet.ResNet(jresnet.ResNetConfig(**cfg, dtype=jnp.float32)),
          tresnet.ResNet(tresnet.ResNetConfig(**cfg, dtype=torch.float32)))


def _variables(jm, x):
  v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False)
  return v["params"], v.get("batch_stats")


def _rel(got, want):
  return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("norm,train", [("group", False), ("batch", False),
                                        ("batch", True)])
@pytest.mark.parametrize("hw", [32, 37])
def test_forward_matches_jax(norm, hw, train):
  """Logits (and, for batch norm in training mode, the new running
  statistics) at an even size and an odd one.  (Group norm has no
  training mode.)  Batch 8: at 32 x 32 the last stage is 1 x 1, and
  batch statistics over fewer values are ill-conditioned in any two
  fp32 implementations."""
  jm, tm = _models(norm)
  x = _images(8, hw)
  params, stats = _variables(jm, x)
  variables = {"params": params}
  state = {}
  if stats is not None:
    variables["batch_stats"] = stats
    state = _port(stats)
  inputs = (torch.from_numpy(x),)
  if norm == "batch" and train:
    want, new = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    got, got_new = torch.func.functional_call(
        tm, {**_port(params), **state}, inputs,
        {"train": True, "mutable": True})
    want_new = _port(new["batch_stats"])
    assert got_new.keys() == want_new.keys() == state.keys()
    for name, t in want_new.items():
      np.testing.assert_allclose(got_new[name].numpy(), t.numpy(),
                                 rtol=OUT_TOL, atol=OUT_TOL, err_msg=name)
  else:
    want = jax.jit(lambda v, x: jm.apply(v, x, train=train))(
        variables, jnp.asarray(x))
    got = torch.func.functional_call(tm, {**_port(params), **state}, inputs,
                                     {"train": train})
  assert got.dtype == torch.float32 and tuple(got.shape) == (8, 10)
  got, want = got.detach().numpy(), np.asarray(want)
  if not (norm == "batch" and train):
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    return
  # Nine batch norms on batch statistics, the last over 8 values a
  # channel: both fp32 programs stray from the exact logits by ~1e-4
  # here.  So the port is held to the float64 port, no farther from it
  # than the JAX package is (and to JAX within that distance twice).
  exact = torch.func.functional_call(
      tresnet.ResNet(tresnet.ResNetConfig(**dict(R18, norm=norm),
                                          dtype=torch.float64)),
      {k: v.double() for k, v in {**_port(params), **state}.items()},
      (torch.from_numpy(x).double(),), {"train": True}).numpy()
  jax_gap = np.abs(want - exact).max()
  assert np.abs(got - exact).max() <= max(jax_gap, OUT_TOL)
  assert np.abs(got - want).max() <= 2 * jax_gap + OUT_TOL


def test_same_padding_is_xla_s():
  """Each (size, window, stride) of a ResNet-50 at 224 and of the odd
  test size pads as ``lax.padtype_to_pads("SAME")``: the stem (2, 3),
  the stride-2 3x3 convs and ``max_pool`` (0, 1) at even sizes."""
  for size, k, s in [(224, 7, 2), (112, 3, 2), (56, 3, 2), (28, 3, 2),
                     (14, 3, 2), (56, 1, 2), (56, 3, 1), (37, 7, 2),
                     (19, 3, 2), (5, 3, 2), (1, 3, 2)]:
    want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert tresnet.same_pads(size, k, s) == tuple(want), (size, k, s)
  assert tresnet.same_pads(224, 7, 2) == (2, 3)
  assert tresnet.same_pads(112, 3, 2) == (0, 1)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_gradients_match_jax(norm):
  jm, tm = _models(norm)
  x, y = _images(4, 33, seed=3), _labels(4)
  params, stats = _variables(jm, x)
  extra = {"batch_stats": stats} if stats is not None else {}

  def jloss(p):
    out = jm.apply({"params": p, **extra}, jnp.asarray(x), train=True,
                   mutable=["batch_stats"] if stats is not None else False)
    logits = out[0] if stats is not None else out
    return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(y)))

  want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
  tp = {k: v.requires_grad_(True) for k, v in _port(params).items()}
  state = _port(stats) if stats is not None else {}
  out = torch.func.functional_call(tm, {**tp, **state},
                                   (torch.from_numpy(x),),
                                   {"train": True, "mutable": bool(state)})
  logits = out[0] if state else out
  loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
  loss.backward()
  np.testing.assert_allclose(loss.item(), float(want_loss), rtol=OUT_TOL)
  want = _port(want_grads)
  assert want.keys() == tp.keys()
  for name, t in want.items():
    assert _rel(tp[name].grad.numpy(), t.numpy()) <= GRAD_LIMIT, name


def _jax_mutable_run(x, y, steps):
  """JAX ``make_mutable_train_step`` over ``MutableTrainState`` on the
  8-device CPU mesh (the batch split over data: global statistics)."""
  jepl.init()
  with jepl.replicate(1):
    pass
  mesh = jepl.current_plan().build_mesh()
  jm, _ = _models("batch", stage_sizes=(1, 1))

  def init_fn(rng):
    v = jm.init(rng, jnp.asarray(x[:1]), train=True)
    return japi.MutableTrainState.create(
        apply_fn=jm.apply, params=v["params"],
        tx=optax.sgd(LR), model_state={"batch_stats": v["batch_stats"]})

  state, sh = japi.create_sharded_train_state(init_fn, mesh,
                                              jax.random.PRNGKey(0))
  init = (_numpy_tree(state.params),
          _numpy_tree(state.model_state["batch_stats"]))

  def loss_fn(p, ms, batch, rng):
    logits, new = jm.apply({"params": p, **ms}, batch["x"], train=True,
                           mutable=["batch_stats"])
    return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
        logits, batch["y"])), ({}, new)

  step = japi.parallelize(japi.make_mutable_train_step(loss_fn), mesh, sh)
  losses, stats = [], []
  for _ in range(steps):
    state, m = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                    jax.random.PRNGKey(1))
    losses.append(float(m["loss"]))
    stats.append(_numpy_tree(state.model_state["batch_stats"]))
  return init, losses, stats, state


def _port_mutable_state(init):
  tepl.init(device="cpu")
  with tepl.replicate(1):
    model = tresnet.ResNet(tresnet.ResNetConfig(
        **dict(R18, norm="batch", stage_sizes=(1, 1)), dtype=torch.float32))
  mesh = tepl.current_plan().build_mesh()
  params0, stats0 = init
  state, sh = tapi.create_sharded_train_state(
      lambda: tapi.MutableTrainState.create(
          apply_fn=model, params=from_jax_params(params0, device="cpu"),
          tx=_sgd(LR), model_state=from_jax_params(stats0, device="cpu")),
      mesh)
  return model, mesh, state, sh


@pytest.mark.quick
def test_mutable_train_state_trajectory_matches_jax():
  """3 SGD steps of batch-norm ResNet through ``MutableTrainState`` and
  ``make_mutable_train_step`` on both sides, from the JAX package's
  initial variables: the losses within 1e-5 relative, and after every
  step the running statistics within 1e-5 of JAX's."""
  x, y = _images(8, 16, seed=5), _labels(8, seed=6)
  init, want_losses, want_stats, _ = _jax_mutable_run(x, y, 3)
  model, mesh, state, sh = _port_mutable_state(init)

  def loss_fn(params, model_state, batch, rng):
    logits, new = torch.func.functional_call(
        model, {**params, **model_state}, (batch["x"],),
        {"train": True, "mutable": True})
    return torch.nn.functional.cross_entropy(logits, batch["y"]), ({}, new)

  run = tapi.parallelize(tapi.make_mutable_train_step(loss_fn), mesh, sh)
  first = {k: v.clone() for k, v in state.model_state.items()}
  for i in range(3):
    state, m = run(state, {"x": x, "y": y}, None)
    np.testing.assert_allclose(m["loss"].item(), want_losses[i],
                               rtol=OUT_TOL)
    want = from_jax_params(want_stats[i], device="cpu")
    assert want.keys() == state.model_state.keys()
    for name, t in want.items():
      np.testing.assert_allclose(state.model_state[name].numpy(), t.numpy(),
                                 rtol=OUT_TOL, atol=OUT_TOL, err_msg=name)
  assert state.step == 3
  assert max(float((state.model_state[k] - first[k]).abs().max())
             for k in first) > 1e-4
  # Eval: the running statistics, no update.
  logits = torch.func.functional_call(
      model, {**state.params, **state.model_state}, (torch.from_numpy(x),))
  assert bool(torch.isfinite(logits).all())


def test_unknown_norm_raises_in_both_packages():
  cfg = dict(stage_sizes=(1,), num_filters=8, num_classes=4, norm="layer")
  jepl.init()
  with pytest.raises(ValueError, match="norm"):
    jresnet.ResNet(jresnet.ResNetConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3), jnp.float32))
  with pytest.raises(ValueError, match="norm"):
    tresnet.ResNet(tresnet.ResNetConfig(**cfg))


def _flat(tree, prefix=""):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, f"{prefix}{k}/"))
    else:
      out[f"{prefix}{k}"] = np.asarray(v)
  return out


def test_weights_and_checkpoints_in_the_jax_layout_both_ways(tmp_path):
  """The bridged parameters and statistics back in the JAX layout
  (``saver.params_tree``, ``model_state_tree``: HWIO conv kernels) bit
  for bit; a JAX checkpoint of a batch-norm state restored into a port
  ``MutableTrainState`` (params and ``batch_stats``), and the port's
  checkpoint read back by the JAX saver, each leaf equal."""
  x, y = _images(8, 16, seed=5), _labels(8, seed=6)
  init, _, _, jstate = _jax_mutable_run(x, y, 2)
  jparams = _numpy_tree(jstate.params)
  jstats = _numpy_tree(jstate.model_state["batch_stats"])
  back = tsaver.params_tree(from_jax_params(jparams, device="cpu"))
  want = _flat(jparams)
  assert back.keys() == want.keys()
  for path, v in want.items():
    np.testing.assert_array_equal(back[path].numpy(), v, err_msg=path)
  root = str(tmp_path / "jax")
  jsaver.save_checkpoint(root, {"params": jstate.params,
                                "opt_state": jstate.opt_state,
                                "model_state": jstate.model_state}, step=2)
  _, _, state, _ = _port_mutable_state(init)
  state, step = tsaver.restore_train_state(root, state)
  assert step == 2
  for name, t in from_jax_params(jparams, device="cpu").items():
    torch.testing.assert_close(state.params[name].detach(), t, rtol=0,
                               atol=0)
  for name, t in from_jax_params(jstats, device="cpu").items():
    torch.testing.assert_close(state.model_state[name], t, rtol=0, atol=0)
  mine = str(tmp_path / "port")
  tsaver.save_checkpoint(mine, tsaver.state_tree(state), step=2)
  raw, rstep = jsaver.restore_checkpoint(mine)
  assert rstep == 2
  for path, v in _flat({"params": jparams,
                        "model_state": {"batch_stats": jstats}}).items():
    np.testing.assert_array_equal(np.asarray(raw[path]), v, err_msg=path)


def test_init_params_follow_flax_families():
  """Names and shapes of the JAX tree; lecun-normal conv kernels with
  fan-in ``kh kw in``; unit norm scales; fresh statistics (means 0,
  variances 1)."""
  cfg = dict(R18, norm="batch", num_filters=16)
  jm = jresnet.ResNet(jresnet.ResNetConfig(**cfg))
  shapes = jax.eval_shape(lambda: jm.init(
      jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
  zeros = lambda t: jax.tree_util.tree_map(  # noqa: E731
      lambda s: np.zeros(s.shape, np.float32), nn.meta.unbox(t))
  tcfg = tresnet.ResNetConfig(**cfg)
  fresh = init_params(tcfg, seed=0, device="cpu")
  want = from_jax_params(zeros(shapes["params"]), device="cpu")
  assert {k: v.shape for k, v in fresh.items()} == \
      {k: v.shape for k, v in want.items()}
  stats = init_model_state(tcfg, device="cpu")
  want = from_jax_params(zeros(shapes["batch_stats"]), device="cpu")
  assert {k: v.shape for k, v in stats.items()} == \
      {k: v.shape for k, v in want.items()}
  assert all(float(v.abs().max()) == (0.0 if k.endswith("mean") else 1.0)
             and float(v.min()) == float(v.max()) for k, v in stats.items())
  w = fresh["stage1_block0.Conv_1.weight"]        # 3x3, 32 -> 32
  fan_in = 3 * 3 * 32
  assert abs(float(w.std()) - fan_in ** -0.5) < 0.06 * fan_in ** -0.5
  assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796256 + 1e-6
  assert float(fresh["BatchNorm_0.weight"].min()) == 1.0
  assert float(fresh["head.bias"].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["uniform", "normal"])
def test_glorot_full_fan_initializers(kind):
  """The fan rule (``prod(shape[:-1])``, a 1-d shape's ``shape[0]``, or
  the full fans given) and the draws' statistics against the JAX
  helpers' on the same shapes."""
  tmake = getattr(tinit, f"glorot_{kind}_full_fan")
  jmake = getattr(jinit, f"glorot_{kind}_full_fan")
  g = torch.Generator().manual_seed(0)
  for shape, fans in [((64, 256), (0, 0)), ((3, 3, 16, 32), (0, 0)),
                      ((4096,), (0, 0)), ((64, 128), (64, 512))]:
    got = tmake(*fans)(g, shape)
    want = np.asarray(jmake(*fans)(jax.random.PRNGKey(1), shape))
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    fan_in = fans[0] or (int(np.prod(shape[:-1])) if len(shape) > 1
                         else shape[0])
    fan_out = fans[1] or shape[-1]
    if kind == "uniform":
      limit = np.sqrt(6.0 / (fan_in + fan_out))
      assert float(got.abs().max()) <= limit
      assert abs(float(got.abs().max()) - np.abs(want).max()) < 0.02 * limit
      std = limit / np.sqrt(3.0)
    else:
      std = np.sqrt(2.0 / (fan_in + fan_out))
    assert abs(float(got.std()) - std) < 0.05 * std, (shape, fans)
    assert abs(float(want.std()) - std) < 0.05 * std, (shape, fans)
  bf = tmake()(g, (8, 8), dtype=torch.bfloat16)
  assert bf.dtype == torch.bfloat16
