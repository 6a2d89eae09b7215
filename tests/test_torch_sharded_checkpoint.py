"""Checkpoints of a sharded training state in the port, against the JAX
package's saver.

A torch tensor is one rank's block, so the port's saver takes each
leaf's layout (``parallel.api.LeafSpec``: spec and logical shape) and
gathers it, as the JAX saver gathers a sharded ``jax.Array``; a restore
keeps each rank's block of the logical leaf, re-padding only attested
pad.  The rank programs (``testing/ckpt_workers.py``) run on two gloo
ranks, all in one group started once; JAX runs in this process on two
of its CPU devices.  The JAX saver tests ported here are
``tests/test_saver.py:76-235``.
"""

import json
import os

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
from easyparallellibrary_tpu.parallel import api as japi
from easyparallellibrary_tpu.runtime import loop as jloop
from easyparallellibrary_tpu.runtime import saver as jsaver
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.runtime import saver as tsaver
from easyparallellibrary_tpu_torch.testing import ckpt_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn
from easyparallellibrary_tpu_torch.weights import (
    from_jax_params, shard_params, unshard_params)

torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=16)
LR, STEPS, SPLIT = 1e-2, 6, 3
# Every group's deadline (seconds): a hung collective fails the tests.
DEADLINE = 400
# Loss tolerances of the existing parity test of each layout: TP
# (tests/test_torch_tp.py), ZeRO-1 (tests/test_torch_zero.py), the smap
# 1F1B pipeline (tests/test_torch_pipeline.py).
TOLERANCE = {"tp": dict(rtol=1e-4, atol=1e-5),
             "zero": dict(rtol=1e-5, atol=1e-6),
             "smap_1f1b": dict(rtol=1e-5, atol=0.0)}
PIPELINE = dict(pipeline_stages=2, num_micro_batch=4)
RESUME = {  # name: (mesh, config, GPT config overrides)
    "tp": ("model:2", None, {}),
    "zero": ("data:2", {"zero.level": "v1"}, {}),
    "smap_1f1b": ("stage:2", {"pipeline.engine": "smap",
                              "pipeline.strategy": "PreferBackward"},
                  PIPELINE),
}


@pytest.fixture(autouse=True)
def _reset_port_env():
  tepl.init(device="cpu")
  yield
  tepl.Env.get().reset()


def _batches():
  r = np.random.RandomState(11)
  return [r.randint(0, TINY["vocab_size"], (8, 17)).astype(np.int32)
          for _ in range(STEPS)]


def _numpy(tree):
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _nest(flat, prefix):
  """The leaves of a flat ``{path: array}`` under ``prefix`` as a tree."""
  out = {}
  for path, value in flat.items():
    if path.startswith(prefix):
      node = out
      *keys, last = path[len(prefix):].split("/")
      for k in keys:
        node = node.setdefault(k, {})
      node[last] = np.asarray(value)
  return out


def _port(tree):
  """A JAX-layout tree as the port's ``{name: tensor}`` on the CPU."""
  return from_jax_params(tree, device="cpu")


def _jax_tp_fit(root):
  """JAX: the tiny GPT, tensor-parallel on ``model:2``, through ``fit``
  for STEPS AdamW steps, checkpointing every SPLIT.  Returns the initial
  parameters (port names, numpy), the losses and the final state."""
  jepl.init(jepl.Config({"cluster.mesh_shape": "model:2"}),
            devices=jax.devices()[:2])
  mesh = jepl.Env.get().cluster.build_mesh()
  model = jgpt.GPT(jgpt.GPTConfig(**TINY, dtype=jnp.float32,
                                  tensor_parallel=True))
  batches = _batches()

  def init_fn(rng):
    return japi.TrainState.create(
        apply_fn=model.apply,
        params=model.init(rng, jnp.asarray(batches[0][:, :-1]))["params"],
        tx=optax.adamw(LR, weight_decay=0.01))

  state, sh = japi.create_sharded_train_state(init_fn, mesh,
                                              jax.random.PRNGKey(0))
  params0 = {k: v.numpy() for k, v in _port(_numpy(state.params)).items()}
  step = japi.parallelize(japi.make_train_step(
      lambda p, b, r: jgpt.gpt_loss(model, p, b, r)), mesh, sh)
  losses = []

  def recorded(s, b, r):
    s, m = step(s, b, r)
    losses.append(float(m["loss"]))
    return s, m

  state, _ = jloop.fit(recorded, state,
                       [{"ids": jnp.asarray(b)} for b in batches],
                       num_steps=STEPS, log_every=0, checkpoint_dir=root,
                       checkpoint_every=SPLIT, shardings=sh)
  return params0, losses, state


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
  root = tmp_path_factory.mktemp("jax_tp")
  params0, losses, state = _jax_tp_fit(str(root))
  return {"root": str(root), "params0": params0, "losses": losses,
          "state": state}


def _dense_whole(seed, features):
  r = np.random.RandomState(seed)
  return {"Dense_0.weight": r.randn(features, 16).astype(np.float32),
          "Dense_0.bias": r.randn(features).astype(np.float32)}


X = np.random.RandomState(5).randn(8, 16).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
  """Every two-rank case in one group."""
  base = tmp_path_factory.mktemp("ranks")
  layouts_root = base / "layouts"
  for features in (64, 9):
    tsaver.save_checkpoint(
        str(layouts_root / f"dp{features}"),
        tsaver.params_tree({k: torch.from_numpy(v) for k, v in
                            _dense_whole(features, features).items()}),
        step=1)
  batches = _batches()
  cases = [("fault_pin", (str(base / "fault"),)),
           ("layouts", (str(layouts_root), X))]
  for name, (mesh, config, over) in RESUME.items():
    cases.append(("train_resume", (mesh, dict(TINY, **over),
                                   refs["params0"], batches,
                                   str(base / name), SPLIT, config, LR)))
  for name in ("tp", "zero"):
    mesh, config, _ = RESUME[name]
    cases.append(("interop", (mesh, config, TINY, refs["params0"],
                              batches[:2], refs["root"],
                              str(base / f"interop_{name}"))))
  got = spawn(ckpt_workers.suite, 2, (cases,), timeout_s=DEADLINE)
  names = ["fault_pin", "layouts"] + [f"resume_{n}" for n in RESUME] + \
      ["interop_tp", "interop_zero"]
  out = {n: [r[i] for r in got] for i, n in enumerate(names)}
  out["base"] = base
  return out


# ------------------------------------------------------- the fault pin --


@pytest.mark.quick
def test_each_rank_restores_its_own_rows_of_a_tp2_checkpoint(ranks):
  """The fault this slice fixed: a column-parallel ``Dense(16, 64)`` at
  tp = 2 whose rank r holds r + 1 is stored whole (kernel ``[16, 64]``,
  rank 0's columns 1, rank 1's 2), and each rank restores its own rows,
  not rank 0's."""
  r0, r1 = ranks["fault_pin"]
  assert r0["step"] == r1["step"] == 1
  assert (r0["Dense_0.weight"] == 1.0).all() and r0["Dense_0.weight"].shape \
      == (32, 16)
  assert (r1["Dense_0.weight"] == 2.0).all()
  assert (r1["Dense_0.bias"] == 2.0).all()
  raw, _ = jsaver.restore_checkpoint(str(ranks["base"] / "fault"))
  assert raw["Dense_0/kernel"].shape == (16, 64)
  assert (raw["Dense_0/kernel"][:, :32] == 1).all()
  assert (raw["Dense_0/kernel"][:, 32:] == 2).all()


# ------------------------------------------- ports of the JAX saver tests --


def _dense_out(whole, x):
  return x @ whole["Dense_0.weight"].T + whole["Dense_0.bias"]


def test_restore_with_resharding_to_tp_mesh(ranks):
  """``test_restore_with_resharding_to_tp_mesh``: a one-process (DP)
  checkpoint restores onto the tp = 2 ranks, each its rows, with the
  whole output of the one-process layer."""
  whole = _dense_whole(64, 64)
  for rank, got in enumerate(ranks["layouts"]):
    np.testing.assert_array_equal(
        got["blocks64"]["Dense_0.weight"],
        whole["Dense_0.weight"][32 * rank:32 * (rank + 1)])
    np.testing.assert_allclose(got["y64"], _dense_out(whole, X), rtol=1e-5,
                               atol=1e-6)


def test_padded_params_saved_at_logical_shape(ranks):
  """``test_padded_params_saved_at_logical_shape``: features 9 at tp = 2
  are padded to 10 in memory (rank 1's last row zero) and stored at the
  logical ``[16, 9]`` / ``[9]``."""
  whole = _dense_whole(9, 9)
  r0, r1 = (got["blocks9"] for got in ranks["layouts"])
  assert ranks["layouts"][0]["logical9"] == (9, 16)
  assert r0["Dense_0.weight"].shape == r1["Dense_0.weight"].shape == (5, 16)
  np.testing.assert_array_equal(r1["Dense_0.weight"][:4],
                                whole["Dense_0.weight"][5:])
  assert (r1["Dense_0.weight"][4] == 0).all() and r1["Dense_0.bias"][4] == 0
  path = os.path.join(ranks["base"], "layouts", "tp9", "step_00000001")
  index = json.load(open(os.path.join(path, "index.json")))
  assert index["leaves"]["Dense_0/kernel"]["shape"] == [16, 9]
  assert index["leaves"]["Dense_0/bias"]["shape"] == [9]


def test_checkpoint_portable_across_tensor_layouts(ranks):
  """``test_checkpoint_portable_across_tensor_layouts``: DP -> tp = 2
  (stored ``[16, 9]`` re-padded to 10) gives the DP output, and the
  tp = 2 checkpoint restores at tp = 1 to the DP parameters and
  output."""
  for features in (9, 64):
    whole = _dense_whole(features, features)
    want = _dense_out(whole, X)
    for got in ranks["layouts"]:
      np.testing.assert_allclose(got[f"y{features}"], want, rtol=1e-5,
                                 atol=1e-6)
    back, _ = tsaver.restore_params(
        os.path.join(ranks["base"], "layouts", f"tp{features}"),
        target={k: torch.zeros(v.shape) for k, v in whole.items()},
        device="cpu")
    for k, v in whole.items():
      np.testing.assert_array_equal(back[k].numpy(), v, k)


def test_unattested_shape_mismatch_still_raises(tmp_path, ranks):
  """``test_unattested_shape_mismatch_still_raises``: a too-small stored
  tensor into a larger plain target raises, and so does a sharded
  restore whose spec attests no logical shape (``[9, 16]`` stored, tp
  = 2 blocks of 5 rows)."""
  path = tsaver.save_checkpoint(str(tmp_path / "s"),
                                {"w": torch.ones(4, 4)}, step=1)
  with pytest.raises(ValueError, match="out of bounds"):
    tsaver.restore_checkpoint(path, target={"w": torch.zeros(4, 8)})
  for got in ranks["layouts"]:
    assert "out of bounds" in got["unattested_error"]


def test_attested_repad_requires_logical_coverage():
  """``test_attested_repad_requires_logical_coverage``, on the port's
  ``_slice_to_shape``."""
  out = tsaver._slice_to_shape(np.ones((8, 10)), (16, 10),
                               logical_shape=(8, 10))
  assert out.shape == (16, 10)
  assert (out[8:] == 0).all() and (out[:8] == 1).all()
  with pytest.raises(ValueError, match="logical"):
    tsaver._slice_to_shape(np.ones((4, 10)), (16, 10), logical_shape=(8, 10))


def test_a_leaf_without_a_layout_is_refused_under_a_process_group(ranks):
  """Under a process group a save never writes one rank's copy: a leaf
  with no layout raises on every rank."""
  for got in ranks["layouts"]:
    assert "no layout" in got["bare_error"]
  assert not os.path.exists(os.path.join(ranks["base"], "layouts", "bare"))


# --------------------------------------------------- across the packages --


def _jax_raw(root, step):
  raw, got = jsaver.restore_checkpoint(
      os.path.join(root, f"step_{step:08d}"))
  assert got == step
  return raw


def _port_side(raw):
  """A ``fit`` checkpoint's params and moments in the port's names."""
  return {"params": _port(_nest(raw, "params/")),
          "exp_avg": _port(_nest(raw, "opt_state/0/mu/")),
          "exp_avg_sq": _port(_nest(raw, "opt_state/0/nu/"))}


def _tp_model():
  return tgpt.GPT(tgpt.GPTConfig(**TINY, tensor_parallel=True),
                  device="meta")


def test_jax_tp_checkpoint_restores_in_the_port_ranks_bit_equal(refs,
                                                                ranks):
  """JAX ``fit``'s tp = 2 checkpoint at step 6 restores into the port's
  tp = 2 ranks and its ZeRO-1 ranks (``data:2``): parameters and moments
  bit-equal to the stored leaves, shard by shard (the owner slices of a
  ZeRO rank)."""
  want = _port_side(_jax_raw(refs["root"], STEPS))
  model = _tp_model()
  for rank, got in enumerate(ranks["interop_tp"]):
    assert got["rstep"] == STEPS
    for part, tree in want.items():
      blocks = shard_params(tree, model, tp=2, rank=rank)
      for name, value in blocks.items():
        key = name if part == "params" else f"{part}/{name}"
        np.testing.assert_array_equal(got["restored"][key], value.numpy(),
                                      key)
  for rank, got in enumerate(ranks["interop_zero"]):
    for part, tree in want.items():
      for name, value in tree.items():
        key = name if part == "params" else f"{part}/{name}"
        d = got["dims"][name]
        if part != "params" and d is not None:
          size = value.shape[d] // 2
          value = value.narrow(d, rank * size, size)
        np.testing.assert_array_equal(got["restored"][key], value.numpy(),
                                      key)


def _whole_from_ranks(ranks, kind):
  """The trained state the ranks hold, whole: ``{part: {name: array}}``."""
  cfg = tgpt.GPTConfig(**TINY, tensor_parallel=True)
  out = {}
  for part in ("params", "exp_avg", "exp_avg_sq"):
    per_rank = []
    for got in ranks:
      prefix = "" if part == "params" else f"{part}/"
      per_rank.append({k[len(prefix):]: torch.from_numpy(v)
                       for k, v in got["trained"].items()
                       if (k.startswith(prefix) if prefix else "/" not in k)})
    if kind == "tp":
      out[part] = unshard_params(per_rank, cfg)
    else:
      dims = ranks[0]["dims"]
      out[part] = {n: (torch.cat([r[n] for r in per_rank], dims[n])
                       if part != "params" and dims[n] is not None
                       else per_rank[0][n]) for n in per_rank[0]}
  return out


@pytest.mark.parametrize("kind", ["tp", "zero"])
def test_port_sharded_checkpoint_restores_in_jax_bit_equal(refs, ranks,
                                                           kind):
  """The port's tp = 2 and ZeRO-1 checkpoints (two AdamW steps from the
  JAX init) restore through the JAX package's targeted restore into its
  tp = 2 state bit-equal to the ranks' state gathered whole; every leaf
  path and shape equals the JAX ``fit`` checkpoint's."""
  root = os.path.join(ranks["base"], f"interop_{kind}")
  state = refs["state"]
  restored, step = jsaver.restore_checkpoint(
      root, target={"params": state.params, "opt_state": state.opt_state})
  assert step == 2
  adam = restored["opt_state"][0]
  assert int(adam.count) == 2
  got = {"params": _port(_numpy(restored["params"])),
         "exp_avg": _port(_numpy(adam.mu)),
         "exp_avg_sq": _port(_numpy(adam.nu))}
  want = _whole_from_ranks(ranks[f"interop_{kind}"], kind)
  for part in got:
    assert sorted(got[part]) == sorted(want[part])
    for name in got[part]:
      np.testing.assert_array_equal(got[part][name].numpy(),
                                    want[part][name].numpy(),
                                    f"{part}/{name}")
  mine = json.load(open(os.path.join(root, "step_00000002", "index.json")))
  theirs = json.load(open(os.path.join(refs["root"], "step_00000003",
                                       "index.json")))
  assert {k: (v["shape"], v["dtype"]) for k, v in mine["leaves"].items()} \
      == {k: (v["shape"], v["dtype"]) for k, v in theirs["leaves"].items()}


def test_tp2_state_round_trips_through_dcp_and_restores_at_tp1(ranks):
  """The DCP path under a process group stores each leaf gathered whole
  (distinct shards are never deduplicated as copies): the tp = 2 state
  read back in one process equals the native checkpoint's leaves, and
  both equal the ranks' state."""
  root = os.path.join(ranks["base"], "interop_tp")
  dcp = tsaver.restore_checkpoint_orbax(root + "_dcp", 2, device="cpu")
  native, _ = tsaver.restore_checkpoint(root, device="cpu")
  assert sorted(dcp) == sorted(native)
  for path, value in native.items():
    assert torch.equal(dcp[path], value), path
  want = _whole_from_ranks(ranks["interop_tp"], "tp")["params"]
  got = _port(_nest({k: v.numpy() for k, v in dcp.items()}, "params/"))
  for name, value in want.items():
    assert torch.equal(got[name], value), name


def test_serving_loads_a_tp_checkpoint_at_tp1_and_tp2(ranks):
  """``restore_params``: at tp = 1 the tp = 2 checkpoint gives the whole
  parameters; at tp = 2 (``shardings=``) each rank's blocks, as does
  ``DraftModelDrafter.from_checkpoint(shardings=)``."""
  root = os.path.join(ranks["base"], "interop_tp")
  want = _whole_from_ranks(ranks["interop_tp"], "tp")["params"]
  target = {k: torch.zeros(v.shape) for k, v in want.items()}
  got, step = tsaver.restore_params(root, target=target, device="cpu")
  assert step == 2
  for name, value in want.items():
    assert torch.equal(got[name], value), name
  for got in ranks["interop_tp"]:
    assert got["served_differ"] == [] and got["drafter_differ"] == []


# ------------------------------------------------------------- resume --


@pytest.mark.parametrize("name", list(RESUME))
def test_fit_resumes_a_sharded_state_on_the_uninterrupted_trajectory(
    refs, ranks, name):
  """``fit`` at tp = 2, ZeRO-1 on ``data:2`` and the smap 1F1B pipeline
  on ``stage:2`` checkpoints at step 3; a fresh state restores every
  rank's blocks (parameters and moments bit-equal to the saving run's)
  and resumes to step 6 bit-equal to the uninterrupted run, whose losses
  follow JAX's tp = 2 ``fit`` within the layout's parity tolerance."""
  for rank, got in enumerate(ranks[f"resume_{name}"]):
    assert got["rstep"] == SPLIT
    assert got["restored_differ"] == [], (rank, got["restored_differ"])
    assert got["final_differ"] == [], (rank, got["final_differ"])
    assert got["resumed"] == got["straight"][SPLIT:], rank
    np.testing.assert_allclose(got["straight"], refs["losses"],
                               **TOLERANCE[name], err_msg=f"rank {rank}")


def test_sharded_fit_checkpoints_hold_the_jax_logical_layout(refs, ranks):
  """The index of every layout's ``fit`` checkpoint at step 3 holds each
  leaf at the path and logical shape of JAX ``fit``'s tp = 2 checkpoint
  (a pipelined state: its stacked ``[2, ...]`` leaves and the whole
  stage-resident table), and the specs name the axes each leaf is split
  over."""
  theirs = json.load(open(os.path.join(refs["root"], "step_00000003",
                                       "index.json")))
  want = {k: v["shape"] for k, v in theirs["leaves"].items()}
  for name in ("tp", "zero"):
    assert ranks[f"resume_{name}"][0]["index"] == want
  pipelined = ranks["resume_smap_1f1b"][0]["index"]
  assert pipelined["params/wte/embedding"] == want["params/wte/embedding"]
  assert pipelined["params/pipeline/stages/stacked/block_0/mlp/wi/kernel"] \
      == [2] + want["params/block_0/mlp/wi/kernel"]
  specs = ranks["resume_tp"][0]["specs"]
  assert specs["block_0.attn.qkv.weight"] == ("model", None)
  assert specs["wte.weight"] == ("model", None)
  zero = ranks["resume_zero"][0]["specs"]
  assert zero["opt_state/block_0.mlp.wi.weight"] == ("data", None)
