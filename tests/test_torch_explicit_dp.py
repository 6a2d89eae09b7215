"""Data parallelism of the port on gloo ranks against the JAX package:
the explicit step with tiny fusion buckets and a bf16 wire against JAX
``make_explicit_dp_train_step`` on a two-device mesh, the implicit step
(``make_train_step`` / ``parallelize``) against one process, and a true
two-process run through the port's ``launch_local`` and
``io.global_batch``, after ``tests/test_multiprocess_dp.py``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
from easyparallellibrary_tpu import ops as jops
from easyparallellibrary_tpu.parallel import (
    TrainState, create_sharded_train_state)
from easyparallellibrary_tpu.parallel.explicit import (
    make_explicit_dp_train_step)
from easyparallellibrary_tpu_torch.testing import tp_workers
from easyparallellibrary_tpu_torch.utils.launcher import (
    launch_local, spawn)
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


COMM = {"communication.fusion_threshold_mb": 0,
        "communication.max_splits": 2,
        "communication.compress_dtype": "bf16",
        "communication.compress_scale": 4.0}


def test_explicit_dp_tiny_buckets_bf16_wire_equals_jax():
  """Explicit DP at data = 2 with one-leaf buckets capped at two splits
  and a bf16 wire (scale 4): the port's loss trajectory and final
  parameters equal JAX ``make_explicit_dp_train_step`` on two devices
  within rtol 1e-5, atol 1e-6."""
  net, params, port = _init()
  batches = _data()
  jepl.init(jepl.Config({"cluster.mesh_shape": "data:2", **COMM}),
            devices=jax.devices()[:2])
  mesh = jepl.Env.get().cluster.build_mesh()
  state, _ = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=net.apply, params=params,
                                tx=optax.adamw(1e-2, weight_decay=0.0)),
      mesh)
  step = make_explicit_dp_train_step(_jax_loss(net), mesh)
  want = []
  for x, y in batches:
    state, m = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                    jax.random.PRNGKey(0))
    want.append(float(m["loss"]))
  ranks = spawn(tp_workers.dp_train, 2,
                ("explicit", port, batches, 1e-2, COMM),
                timeout_s=DEADLINE)
  final = from_jax_params(jax.tree_util.tree_map(
      np.asarray, nn.meta.unbox(state.params)), device="cpu")
  for rank in range(2):
    np.testing.assert_allclose(ranks[rank]["losses"], want, rtol=1e-5,
                               atol=1e-6)
    for k, v in final.items():
      np.testing.assert_allclose(ranks[rank]["params"][k], v.numpy(),
                                 rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["implicit", "guarded"])
def test_implicit_dp_two_ranks_equal_one_process(kind):
  """``make_train_step`` (and ``runtime.trainer.build_train_step``, the
  step ``fit`` drives) under ``parallelize`` at data = 2 (each rank its
  half of the global batch, the gradient mean over the data group)
  equals one process on the whole batch within rtol 1e-5."""
  _, _, port = _init()
  batches = _data()
  one = tp_workers.dp_train(0, 1, kind, port, batches, 1e-2)
  ranks = spawn(tp_workers.dp_train, 2, (kind, port, batches, 1e-2),
                timeout_s=DEADLINE)
  for rank in range(2):
    np.testing.assert_allclose(ranks[rank]["losses"], one["losses"],
                               rtol=1e-5, atol=1e-6)
    for k, v in one["params"].items():
      np.testing.assert_allclose(ranks[rank]["params"][k], v, rtol=1e-5,
                                 atol=1e-6, err_msg=k)


WORKER = """
import json, os, sys
sys.path.insert(0, %(repo)r)
import numpy as np, torch
torch.set_num_threads(1)
import torch.nn.functional as F
import easyparallellibrary_tpu_torch as epl
from easyparallellibrary_tpu_torch.io.device import global_batch
from easyparallellibrary_tpu_torch.ops.adamw import adamw
from easyparallellibrary_tpu_torch.parallel.api import (
    TrainState, create_sharded_train_state, make_train_step, parallelize)

epl.init(device="cpu")
mesh = epl.current_plan().build_mesh()
r = np.random.RandomState(0)
X = r.randn(16, 4).astype(np.float32)
Y = (X @ r.randn(4, 1)).astype(np.float32)
pid, pc = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
lo, hi = pid * 16 // pc, (pid + 1) * 16 // pc
batch = global_batch({"x": X[lo:hi], "y": Y[lo:hi]}, mesh)
g = np.random.RandomState(1)
params = {"w0": torch.from_numpy(g.randn(8, 4).astype(np.float32) * 0.5),
          "w1": torch.from_numpy(g.randn(1, 8).astype(np.float32) * 0.5)}
state, sh = create_sharded_train_state(
    lambda: TrainState.create(apply_fn=None, params=params,
                              tx=adamw(0.05, weight_decay=0.0)), mesh)

def loss_fn(p, b, rng):
  pred = F.linear(torch.tanh(F.linear(b["x"], p["w0"])), p["w1"])
  return torch.mean((pred - b["y"]) ** 2), {}

step = parallelize(make_train_step(loss_fn), mesh, sh)
losses = []
for _ in range(5):
  state, m = step(state, batch, None)
  losses.append(float(m["loss"]))
with open(os.path.join(%(out)r, "rank%%d.json" %% pid), "w") as f:
  json.dump({"losses": losses, "data": mesh.shape["data"],
             "rows": int(batch["x"].shape[0])}, f)
"""


def test_two_process_dp_through_launch_local_equals_one_process(tmp_path):
  """Two processes started by the port's ``launch_local`` (RANK /
  WORLD_SIZE / MASTER_ADDR / MASTER_PORT; ``epl.init`` starts gloo),
  each feeding its half of a 16-row dataset through ``global_batch``,
  train to the losses of one process on all 16 rows (rtol 1e-5)."""
  code = WORKER % {"repo": REPO, "out": str(tmp_path)}
  env = {"PYTHONPATH": REPO}
  assert launch_local(2, [sys.executable, "-c", code], retries=0,
                      log_dir=str(tmp_path / "logs"), extra_env=env,
                      timeout_s=DEADLINE) == 0
  ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
  assert ranks[0]["data"] == 2 and ranks[0]["rows"] == 16
  single = tmp_path / "single"
  single.mkdir()
  out = subprocess.run([sys.executable, "-c", (WORKER % {
      "repo": REPO, "out": str(single)}).replace(
          'pid, pc = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])',
          "pid, pc = 0, 1")], env={**os.environ, **env, "WORLD_SIZE": "1",
                                   "RANK": "0"}, timeout=DEADLINE)
  assert out.returncode == 0
  one = json.load(open(single / "rank0.json"))
  assert one["data"] == 1
  for r in ranks:
    np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)


def test_launch_local_kills_the_group_when_a_worker_fails(tmp_path):
  """A worker that exits non-zero while its peer waits: the launcher
  kills the peer and reports the failure (no retry asked), well inside
  the deadline."""
  code = ("import os, sys, time\n"
          "if os.environ['RANK'] == '1': sys.exit(3)\n"
          "time.sleep(60)\n")
  import time
  t0 = time.monotonic()
  assert launch_local(2, [sys.executable, "-c", code], retries=0,
                      timeout_s=DEADLINE) == 1
  assert time.monotonic() - t0 < 30
