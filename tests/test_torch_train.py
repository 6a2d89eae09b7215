"""The port's training step against the JAX package.

Same numpy inputs and the JAX package's own initialised parameters
(bridged with ``weights.from_jax_params``) on both sides: the
cross-entropy, ``gpt_loss`` and its gradients under every remat policy,
the 10-step AdamW loss trajectory of ``bench.py``'s smoke configuration
through the ``epl`` annotation surface, the remat contract (how often
the flash forward runs), and the annotation surface itself.  On the CPU
the port's flash attention runs its plain version and the JAX package's
Pallas kernels run in interpret mode.
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
from easyparallellibrary_tpu.ops.losses import (
    distributed_sparse_softmax_cross_entropy_with_logits as jax_ce)
from easyparallellibrary_tpu.parallel import api as japi
from easyparallellibrary_tpu_torch.kernels import flash_attention as tfa
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.ops.losses import (
    distributed_sparse_softmax_cross_entropy_with_logits as torch_ce)
from easyparallellibrary_tpu_torch.parallel import api as tapi
from easyparallellibrary_tpu_torch.weights import _torch_name, from_jax_params

# Small shapes: one intra-op thread leaves the cores to the suite's
# other worker processes.
torch.set_num_threads(1)

# bench.py's smoke configuration (bench.py:154-156); the gpt_loss cases
# cut the sequence to 64 to keep the interpreted Pallas kernels quick.
SMOKE = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=128,
             d_ff=512, max_seq_len=128)


@pytest.fixture(autouse=True)
def _reset_port_env():
  yield
  tepl.Env.get().reset()


def _numpy_tree(params):
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def _ids(batch, seq, vocab, seed=0):
  return np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1))


# ------------------------------------------------------------ losses ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_jax(dtype, z_loss):
  r = np.random.RandomState(3)
  logits = (3 * r.randn(4, 6, 32)).astype(np.float32)
  labels = r.randint(0, 32, (4, 6))
  cot = r.randn(4, 6).astype(np.float32)
  jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
  want, vjp = jax.vjp(lambda x: jax_ce(jnp.asarray(labels), x,
                                       z_loss=z_loss), jl)
  (want_grad,) = vjp(jnp.asarray(cot))
  tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
  got = torch_ce(torch.from_numpy(labels), tl, z_loss=z_loss)
  (got_grad,) = torch.autograd.grad(got, tl, torch.from_numpy(cot))
  assert got.dtype == torch.float32 and got_grad.dtype == tl.dtype
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-6, atol=1e-6)
  # The gradient rounds once to the storage dtype on both sides.
  tol = 1e-6 if dtype == "float32" else 2 ** -8
  np.testing.assert_allclose(got_grad.float().numpy(),
                             np.asarray(want_grad, np.float32),
                             rtol=tol, atol=1e-7)


def test_cross_entropy_bf16_confident_label_gradient_survives():
  """p rounds to 1 in bf16, yet the label's gradient p - 1 is not 0: the
  two cotangents add in fp32 and round once (losses.py:57-68)."""
  logits = np.zeros((2, 8), np.float32)
  labels = np.array([3, 5])
  logits[0, 3] = logits[1, 5] = 9.0
  tl = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
  loss = torch_ce(torch.from_numpy(labels), tl).sum()
  (grad,) = torch.autograd.grad(loss, tl)
  p = torch.softmax(tl.float(), -1)
  assert bool((p.to(torch.bfloat16)[[0, 1], [3, 5]] == 1).all())
  label_grad = grad[[0, 1], [3, 5]].float()
  assert bool((label_grad < 0).all()), label_grad
  want = jax.grad(lambda x: jax_ce(jnp.asarray(labels), x).sum())(
      jnp.asarray(logits).astype(jnp.bfloat16))
  np.testing.assert_array_equal(grad.float().numpy(),
                                np.asarray(want, np.float32))


# ---------------------------------------------------------- gpt_loss ---


def _loss_and_grads_pair(seq=64, batch=2, **overrides):
  fields = dict(SMOKE, max_seq_len=seq, **overrides)
  jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32)
  tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
  ids = _ids(batch, seq, SMOKE["vocab_size"], seed=1)
  jmodel = jgpt.GPT(jcfg)
  params = jmodel.init(jax.random.PRNGKey(0),
                       jnp.asarray(ids[:, :-1]))["params"]
  jbatch = {"ids": jnp.asarray(ids, jnp.int32)}
  (jloss, _), jgrads = jax.value_and_grad(
      lambda p: jgpt.gpt_loss(jmodel, p, jbatch), has_aux=True)(params)
  tparams = {k: v.requires_grad_(True) for k, v in
             from_jax_params(_numpy_tree(params), device="cpu").items()}
  tloss, _ = tgpt.gpt_loss(tgpt.GPT(tcfg), tparams,
                           {"ids": torch.from_numpy(ids)})
  tloss.backward()
  want_grads = from_jax_params(_numpy_tree(jgrads), device="cpu")
  return (float(jloss), tloss.item(), want_grads,
          {k: v.grad for k, v in tparams.items()})


@pytest.mark.parametrize("attn,remat_policy,loss_chunk", [
    ("pallas_flash", "nothing", 16),
    ("pallas_flash", "dots", 16),
    ("pallas_flash", "dots_flash", 16),
    ("pallas_flash", "everything", 16),
    ("pallas_flash", "dots_flash", 0),
    ("xla", None, 0),
])
def test_gpt_loss_and_grads_match_jax(attn, remat_policy, loss_chunk):
  remat = dict(remat=True, remat_policy=remat_policy) if remat_policy else {}
  want, got, want_grads, got_grads = _loss_and_grads_pair(
      attn_impl=attn, loss_chunk=loss_chunk, **remat)
  np.testing.assert_allclose(got, want, rtol=1e-6)
  assert got_grads.keys() == want_grads.keys()
  for name, g in got_grads.items():
    np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                               rtol=1e-4, atol=1e-6, err_msg=name)


# -------------------------------------------------- the remat contract --


@pytest.mark.parametrize("policy,fwd_per_layer", [
    ("dots_flash", 1), ("dots", 2), ("nothing", 2), ("everything", 2)])
def test_remat_policy_sets_flash_forward_calls(policy, fwd_per_layer):
  """One training step under ``dots_flash`` runs the flash forward once
  per layer (its outputs are saved); the other policies re-run it in the
  recompute.  The step's result is the same with and without remat."""
  fields = dict(SMOKE, max_seq_len=32, attn_impl="pallas_flash",
                dtype=torch.float32)
  ids = {"ids": torch.from_numpy(_ids(2, 32, SMOKE["vocab_size"]))}
  from easyparallellibrary_tpu_torch.weights import init_params
  start = init_params(tgpt.GPTConfig(**fields), 0, device="cpu")

  def one_step(cfg):
    model = tgpt.GPT(cfg)
    state = tapi.TrainState.create(apply_fn=model, params=start,
                                   tx=tadamw.adamw(3e-4, weight_decay=0.01))
    step = tapi.make_train_step(lambda p, b, r: tgpt.gpt_loss(model, p, b))
    tfa.reset_counts()
    state, metrics = step(state, ids, None)
    return state, metrics

  tepl.init(device="cpu")
  state, metrics = one_step(tgpt.GPTConfig(**fields, remat=True,
                                           remat_policy=policy))
  L = SMOKE["num_layers"]
  assert tfa.flash_fwd_reference.calls == fwd_per_layer * L
  assert tfa.flash_bwd_dkv_reference.calls == L
  assert tfa.flash_bwd_dq_reference.calls == L
  plain_state, plain_metrics = one_step(tgpt.GPTConfig(**fields))
  assert tfa.flash_fwd_reference.calls == L
  assert metrics["loss"].item() == plain_metrics["loss"].item()
  for name, p in state.params.items():
    torch.testing.assert_close(p, plain_state.params[name], rtol=0, atol=0,
                               msg=lambda m: f"{name}: {m}")


# ------------------------------------------------- the 10-step pin ----


def _jax_trajectory(cfg, ids, steps):
  jepl.init(devices=jax.devices()[:1])
  with jepl.replicate(1):
    model = jgpt.GPT(cfg)
  mesh = jepl.current_plan().build_mesh()
  batch = {"ids": jnp.asarray(ids, jnp.int32)}
  tx = optax.adamw(3e-4, weight_decay=0.01)

  def init_fn(r):
    return japi.TrainState.create(
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


def _torch_trajectory(cfg, params0, ids, steps):
  tepl.init(device="cpu")
  with tepl.replicate(1):
    model = tgpt.GPT(cfg)
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
    state, metrics = step(state, {"ids": ids}, None)
    assert metrics["loss"].device == mesh.device
    losses.append(metrics["loss"].item())
  assert state.step == steps
  return losses


@pytest.mark.quick
def test_adamw_trajectory_matches_jax_on_the_smoke_config():
  """bench.py's smoke run: 10 AdamW(3e-4, weight_decay=0.01) steps on
  one batch, built through init / replicate / build_mesh /
  create_sharded_train_state / parallelize(make_train_step) on both
  sides from the same initial parameters.  fp32 on the CPU; the
  frameworks sum in other orders, and Adam's normalised first steps
  carry those last-bit differences on, so the per-step losses are held
  to rtol 2e-5."""
  ids = _ids(8, SMOKE["max_seq_len"], SMOKE["vocab_size"])
  params0, want = _jax_trajectory(
      jgpt.GPTConfig(**SMOKE, dtype=jnp.float32), ids, 10)
  got = _torch_trajectory(tgpt.GPTConfig(**SMOKE, dtype=torch.float32),
                          params0, torch.from_numpy(ids), 10)
  assert want[-1] < want[0] - 0.5      # it trains
  np.testing.assert_allclose(got, want, rtol=2e-5)


# --------------------------------------------------- the API surface ---


def _plan_summary(epl_mod, scope):
  plan = None
  if scope == "replicate":
    with epl_mod.replicate(1):
      plan = epl_mod.current_plan()
  else:
    plan = epl_mod.current_plan()
  return (plan.num_stages, plan.model_parallel, plan.seq_parallel,
          plan.expert_parallel, plan.num_micro_batch, plan.mesh_request())


@pytest.mark.parametrize("scope", ["replicate", "none"])
def test_single_device_plan_matches_jax(scope):
  jepl.init(devices=jax.devices()[:1])
  want = _plan_summary(jepl, scope)
  jmesh = jepl.current_plan().build_mesh()
  tepl.init(device="cpu")
  got = _plan_summary(tepl, scope)
  tmesh = tepl.current_plan().build_mesh()
  assert got == want
  assert dict(tmesh.shape) == dict(jmesh.shape)
  assert tepl.Env.get().cluster.axis_size("data") == 1


def test_split_raises_not_ported_once_the_mesh_is_built():
  jepl.init()
  with jepl.split(2):
    pass
  assert jepl.current_plan().model_parallel == 2
  tepl.init(device="cpu")
  with tepl.split(2):
    pass
  plan = tepl.current_plan()
  assert plan.model_parallel == 2            # recorded, not lowered yet
  # The tensor-parallel mesh is ported: a split(2) needs two processes
  # (one device each), so one process cannot lay it out.
  with pytest.raises(ValueError, match="Cannot lay out mesh"):
    plan.build_mesh()


@pytest.mark.parametrize("mesh_shape,devices,error", [
    ("data:1,model:1", 1, None),
    ("stage:2", 1, ValueError),
    ("seq:2", 1, ValueError),
    ("bogus:1", 1, ValueError),
    ("", 2, NotImplementedError),
])
def test_mesh_above_one_device_raises(mesh_shape, devices, error):
  """The one-device mesh: a ``cluster.mesh_shape`` spec of ones builds
  it; an axis above 1, from the spec or from several devices on the data
  axis, raises when the mesh is built: a stage or seq axis (ported)
  because one process cannot lay it out."""
  tepl.init(tepl.Config({"cluster.mesh_shape": mesh_shape}),
            devices=[torch.device("cpu")] * devices)
  with tepl.replicate(1):
    pass
  if error is None:
    mesh = tepl.current_plan().build_mesh()
    assert set(mesh.shape.values()) == {1}
  else:
    with pytest.raises(error):
      tepl.current_plan().build_mesh()


def test_config_to_dict_matches_jax():
  assert tepl.Config().to_dict() == jepl.Config().to_dict()
  overrides = {"communication.gradients_reduce_method": "sum",
               "pipeline.num_micro_batch": 4}
  assert (tepl.Config(overrides).to_dict()
          == jepl.Config(overrides).to_dict())


def test_weight_decay_mask_follows_the_jax_paths():
  jmodel = jgpt.GPT(jgpt.GPTConfig(**dict(SMOKE, num_layers=1),
                                   dtype=jnp.float32))
  tree = _numpy_tree(jmodel.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4), jnp.int32))["params"])
  paths = []
  jax.tree_util.tree_map_with_path(
      lambda p, _: paths.append("/".join(k.key for k in p)), tree)
  params = from_jax_params(tree, device="cpu")
  for path in paths:
    assert tadamw.jax_path(_torch_name(path)) == path
  opt = tadamw.adam_weight_decay_optimizer(1e-3).init(params)
  decay_ids = {id(p) for p in opt.param_groups[0]["params"]}
  decayed = {n for n, p in params.items() if id(p) in decay_ids}
  assert opt.param_groups[1]["weight_decay"] == 0.0
  assert decayed == {"block_0.attn.qkv.weight", "block_0.attn.proj.weight",
                     "block_0.mlp.wi.weight", "block_0.mlp.wo.weight",
                     "wte.weight", "wpe"}


def test_train_step_merges_collections_and_refuses_what_is_not_ported():
  tepl.init(device="cpu")
  mesh = tepl.current_plan().build_mesh()
  w = torch.ones(3)
  tx = tadamw.adamw(0.1)

  def loss_fn(params, batch, rng):
    loss = (params["w"] * batch["x"]).sum()
    tepl.add_to_collection(batch["x"], tepl.GraphKeys.GLOBAL_MEAN_OBJECTS)
    return loss, {}

  state, shardings = tapi.create_sharded_train_state(
      lambda: tapi.TrainState.create(apply_fn=None, params={"w": w}, tx=tx),
      mesh)
  assert shardings == {"w": ()}
  step = tapi.parallelize(tapi.make_train_step(loss_fn), mesh, shardings)
  state, metrics = step(state, {"x": np.arange(3.0, dtype=np.float32)}, None)
  assert metrics["global_mean_objects_0"].item() == 1.0
  assert state.step == 1 and torch.equal(w, torch.ones(3))   # own copy
  with pytest.raises(ValueError, match="in place"):
    tapi.parallelize(step, mesh, shardings, donate_state=False)
  # ZeRO is ported: at a data axis of 1 the optimizer stays whole (the
  # JAX package's warning), and an unknown level raises.
  zstate, _ = tapi.create_sharded_train_state(lambda: state, mesh,
                                              zero_level="v0")
  assert zstate.zero is None
  with pytest.raises(ValueError, match="zero.level"):
    tapi.create_sharded_train_state(lambda: state, mesh, zero_level="v9")


@pytest.mark.parametrize("name,want,known", [
    ("NVIDIA H100 80GB HBM3", 989e12, True),
    ("NVIDIA H100 PCIe", 756e12, True),
    ("NVIDIA H100 NVL", 835e12, True),
    ("NVIDIA H200", 989e12, True),
    ("NVIDIA A100-SXM4-80GB", 989e12, False),
])
def test_peak_flops_by_card_name(monkeypatch, name, want, known):
  from easyparallellibrary_tpu_torch.profiler import flops
  monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
  assert flops.peak_flops_info() == (want, known)


def test_flops_per_token_matches_jax():
  for fields in (SMOKE, dict(SMOKE, num_layers=24, d_model=1024,
                              num_heads=16, d_ff=4096, vocab_size=32768,
                              max_seq_len=1024)):
    assert tgpt.gpt_flops_per_token(tgpt.GPTConfig(**fields)) == \
        jgpt.gpt_flops_per_token(jgpt.GPTConfig(**fields))


def test_bench_cpu_smoke_prints_one_json_line(capsys):
  import json
  from easyparallellibrary_tpu_torch import bench
  assert bench.main(["--device", "cpu"]) == 0
  lines = capsys.readouterr().out.strip().splitlines()
  assert len(lines) == 1
  record = json.loads(lines[0])
  assert record["metric"] == "gpt_smoke_tokens_per_sec"
  assert record["unit"] == "tokens/sec" and record["value"] > 0
  assert record["detail"]["device"] == "cpu"
  assert np.isfinite(record["detail"]["loss"])
