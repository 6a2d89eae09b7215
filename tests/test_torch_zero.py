"""ZeRO-1 of the port (``runtime/zero.py``) on two gloo ranks: the
trajectory of JAX ``make_zero1_train_step`` on a two-device mesh and of
the port's plain data parallelism, each rank's AdamW moments at half of
data parallelism's, and the coupled-optimizer refusal."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
from easyparallellibrary_tpu.parallel import (
    TrainState, create_sharded_train_state)
from easyparallellibrary_tpu.runtime.zero import make_zero1_train_step
from easyparallellibrary_tpu_torch.runtime import zero as tzero
from easyparallellibrary_tpu_torch.testing import tp_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn
from easyparallellibrary_tpu import ops as jops
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
DEADLINE = 120


class Net(nn.Module):
  """The MLP of ``tp_workers._mlp_loss`` (Dense_0 -> relu -> Dense_1)."""

  @nn.compact
  def __call__(self, x):
    h = nn.relu(jops.Dense(32, parallel="none")(x))
    return jops.Dense(8, parallel="none")(h)


def _data(steps=4, seed=0):
  r = np.random.RandomState(seed)
  return [(r.randn(8, 16).astype(np.float32),
           r.randint(0, 8, (8,)).astype(np.int32)) for _ in range(steps)]


def _init():
  net = Net()
  params = net.init(jax.random.PRNGKey(1), jnp.zeros((1, 16)))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))
  return net, params, {k: v.numpy() for k, v in
                       from_jax_params(tree, device="cpu").items()}


def _jax_loss(net):
  def loss_fn(params, batch, rng):
    logits = net.apply({"params": params}, batch["x"])
    return jnp.mean(jops.distributed_sparse_softmax_cross_entropy_with_logits(
        batch["y"], logits)), {}
  return loss_fn


def test_zero1_equals_jax_and_dp_with_half_the_moments():
  """ZeRO-1 at data = 2: losses and final parameters equal JAX
  ``make_zero1_train_step`` (rtol 1e-5, atol 1e-6) and the port's
  implicit DP; each rank's moment bytes are half of DP's."""
  net, params, port = _init()
  batches = _data()
  jepl.init(jepl.Config({"cluster.mesh_shape": "data:2"}),
            devices=jax.devices()[:2])
  mesh = jepl.Env.get().cluster.build_mesh()
  state, _ = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=net.apply, params=params,
                                tx=optax.adamw(1e-2, weight_decay=0.0)),
      mesh, zero_level="v1")
  step = make_zero1_train_step(_jax_loss(net), mesh)
  want = []
  for x, y in batches:
    state, m = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                    jax.random.PRNGKey(0))
    want.append(float(m["loss"]))
  zero = spawn(tp_workers.dp_train, 2, ("zero1", port, batches, 1e-2),
               timeout_s=DEADLINE)
  dp = spawn(tp_workers.dp_train, 2, ("implicit", port, batches, 1e-2),
             timeout_s=DEADLINE)
  for rank in range(2):
    np.testing.assert_allclose(zero[rank]["losses"], want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(zero[rank]["losses"], dp[rank]["losses"],
                               rtol=1e-5, atol=1e-6)
    for k, v in dp[rank]["params"].items():
      np.testing.assert_allclose(zero[rank]["params"][k], v, rtol=1e-5,
                                 atol=1e-6, err_msg=k)
    assert zero[rank]["moment_bytes"] * 2 == dp[rank]["moment_bytes"]


def test_zero1_refuses_a_coupled_optimizer():
  """A global-norm clip couples every position, so its owner slices
  would diverge from the whole: the ZeRO-1 step refuses it, as JAX's
  ``_assert_elementwise_tx``."""
  _, _, port = _init()
  ranks = spawn(tp_workers.zero_refuses_coupled_optimizer, 2, (port,),
                timeout_s=DEADLINE)
  for rank in range(2):
    assert "requires an elementwise optimizer" in ranks[rank]


def test_zero_owner_dim_is_the_jax_rule():
  """The owner dim rule, case by case against JAX's."""
  from easyparallellibrary_tpu.runtime.zero import (
      zero_owner_dim as jax_owner_dim)
  cases = [((8, 4), 2), ((3, 4), 2), ((3, 5), 2), ((), 2), ((6,), 4),
           ((4, 8), 1), ((1, 8), 2)]
  for shape, dp in cases:
    taken = [False] * len(shape)
    assert tzero.zero_owner_dim(shape, taken, dp) == jax_owner_dim(
        shape, taken, dp), (shape, dp)
  assert tzero.zero_owner_dim((8, 4), [True, False], 2) == 1
