"""``split``'s automatic layer placement in the port against the JAX
package's (``tests/test_split_tp.py:221-322``).

``ops.Dense`` and ``ops.Embedding`` default to ``parallel="auto"``: under
an active ``split`` scope a Dense is column-parallel and an Embedding
vocab-parallel, and with ``auto.tensor_split`` the scope's auto Dense
layers alternate column, row, column.  The port resolves the mode when a
layer is built (the JAX layer when it is applied), in build order (JAX:
flax's ``Dense_<i>`` names).  ``AutoNet`` runs on two gloo ranks
(``testing/ckpt_workers.py``, one group); JAX runs it on its 8-device
CPU mesh in this process.
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
from easyparallellibrary_tpu import ops as jops
from easyparallellibrary_tpu.parallel import (
    TrainState, create_sharded_train_state, make_train_step, parallelize)
from easyparallellibrary_tpu.runtime import saver as jsaver
from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding
from easyparallellibrary_tpu_torch.testing import ckpt_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn

torch.set_num_threads(1)

STEPS = 5
DEADLINE = 300


class JaxAutoNet(nn.Module):
  """JAX ``tests/test_split_tp.py``'s ``AutoNet``."""
  hidden: int = 64
  vocab: int = 96

  @nn.compact
  def __call__(self, x):
    with jepl.split():
      h = nn.relu(jops.Dense(self.hidden)(x))    # Dense_0
      h = nn.relu(jops.Dense(self.hidden)(h))    # Dense_1
      return jops.Dense(self.vocab)(h)           # Dense_2


def _data(n=32, d=16, vocab=96):
  r = np.random.RandomState(0)
  return (r.randn(n, d).astype(np.float32),
          r.randint(0, vocab, size=(n,)).astype(np.int32))


def _jax_run(pairs, root=None):
  """JAX ``test_auto_tensor_split_matches_unsharded``'s run: the kernel
  specs and STEPS SGD(0.1) losses; the initial parameters saved to
  ``root`` when given."""
  jepl.init(jepl.Config({"auto.tensor_split": pairs}))
  model = JaxAutoNet()
  with jepl.split():
    pass
  mesh = jepl.current_plan().build_mesh()
  x, y = _data()

  def init_fn(rng):
    return TrainState.create(apply_fn=model.apply,
                             params=model.init(rng, x)["params"],
                             tx=optax.sgd(0.1))

  state, shardings = create_sharded_train_state(init_fn, mesh,
                                                jax.random.PRNGKey(7))
  specs = {k: state.params[k]["kernel"].names for k in state.params}
  if root is not None:
    jsaver.save_checkpoint(root, state.params, step=0)

  def loss_fn(params, batch, rng):
    logits = model.apply({"params": params}, batch["x"])
    loss = jops.distributed_sparse_softmax_cross_entropy_with_logits(
        batch["y"], logits)
    return jnp.mean(loss), {}

  step = parallelize(make_train_step(loss_fn), mesh, shardings)
  losses = []
  for _ in range(STEPS):
    state, m = step(state, {"x": x, "y": y}, jax.random.PRNGKey(3))
    losses.append(float(m["loss"]))
  return specs, losses


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("auto_init"))
  return {"root": root, False: _jax_run(False, root), True: _jax_run(True)}


@pytest.fixture(scope="module")
def ranks(jax_runs):
  x, y = _data()
  return spawn(ckpt_workers.suite, 2,
               ([("split_auto", (jax_runs["root"], x, y, STEPS))],),
               timeout_s=DEADLINE)


@pytest.fixture(autouse=True)
def _reset_port_env():
  yield
  tepl.Env.get().reset()


def test_auto_default_keeps_all_column(jax_runs, ranks):
  """``test_auto_tensor_split_default_off_keeps_all_column``: every auto
  Dense is column-parallel, as JAX's kernels' ``(None, "model")``."""
  for layer, names in jax_runs[False][0].items():
    assert names == (None, "model"), layer
  for got in ranks:
    run = got[0][False]
    assert run["modes"] == ["column", "column", "column"]
    for i in range(3):
      assert run["specs"][f"Dense_{i}.weight"] == ("model", None)


def test_auto_tensor_split_pairs_column_row(jax_runs, ranks):
  """``test_auto_tensor_split_pairs_column_row``: with
  ``auto.tensor_split`` the layers alternate column, row, column, as
  JAX's kernel specs do."""
  assert jax_runs[True][0] == {"Dense_0": (None, "model"),
                               "Dense_1": ("model", None),
                               "Dense_2": (None, "model")}
  for got in ranks:
    run = got[0][True]
    assert run["modes"] == ["column", "row", "column"]
    assert run["specs"]["Dense_1.weight"] == (None, "model")
    assert "Dense_1.bias" not in run["specs"]


@pytest.mark.parametrize("pairs", [False, True], ids=["column", "paired"])
def test_auto_placement_sgd_losses_equal_jax(jax_runs, ranks, pairs):
  """``test_auto_tensor_split_matches_unsharded``: five SGD(0.1) steps of
  the auto-placed net from JAX's initial parameters (restored by the
  port's layouts) give JAX's losses, rtol 1e-4, atol 1e-5."""
  for rank, got in enumerate(ranks):
    np.testing.assert_allclose(got[0][pairs]["losses"], jax_runs[pairs][1],
                               rtol=1e-4, atol=1e-5, err_msg=f"rank {rank}")


def test_embedding_is_vocab_parallel_under_split(ranks):
  """JAX ``test_embedding_vocab_sharded_under_split``: an auto Embedding
  under split holds this rank's vocab rows, and a lookup sums the ranks'
  rows (ids 1, 2, 3 on rank 0's, 40 on rank 1's)."""
  for rank, got in enumerate(ranks):
    layers = got[0]["layers"]
    assert layers["embedding"] == ("vocab", (32, 16))
    look = layers["lookup"]
    assert look.shape == (2, 2, 16)
    np.testing.assert_array_equal(look[0, 0], np.arange(16, 32))
    np.testing.assert_array_equal(look[1, 1],
                                  np.arange(8 * 16, 9 * 16) + 1000.0)


def test_explicit_parallel_wins_under_split(ranks):
  """An explicit ``parallel=`` is taken as given inside a split scope,
  with ``auto.tensor_split`` on, and is not counted in the alternation."""
  for got in ranks:
    layers = got[0]["layers"]
    assert layers["explicit_none"] == ("none", (8, 16))
    assert layers["explicit_row"] == ("row", (8, 8))
    assert layers["outer"] == ("column", (32, 16))


def test_nested_split_does_not_reshard(ranks):
  """A split opened inside a split is nested (``is_nested``): its layers
  are split over ``model`` once (a column Dense ``[64 / 2, 64]``, not a
  quarter), and continue the outer scope's column / row count."""
  for got in ranks:
    layers = got[0]["layers"]
    assert layers["nested"] == ("row", (64, 32))
    assert layers["nested_embedding"] == ("vocab", (32, 16))
    assert layers["after_nested"] == ("column", (16, 64))


def test_auto_is_none_at_a_model_axis_of_one():
  """Outside a split scope, and inside one on a model axis of 1, the
  auto layers are unsharded."""
  tepl.init(device="cpu")
  tepl.Env.get().cluster.build_mesh()
  assert Dense(4, 8).parallel == "none"
  with tepl.split():
    dense, emb = Dense(4, 8), Embedding(16, 4)
  assert (dense.parallel, tuple(dense.weight.shape)) == ("none", (8, 4))
  assert (emb.parallel, tuple(emb.weight.shape)) == ("none", (16, 4))
  with pytest.raises(ValueError, match="auto/none/column/row"):
    Dense(4, 8, parallel="rows")
