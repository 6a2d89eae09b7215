"""The port's checkpoint saver against the JAX package's.

A checkpoint written by either package restores in the other with the
parameters, both Adam moments and the count bit-equal, for fp32 and
bf16 leaves and through the Dense transposes; the crash-consistency
contract of ``tests/test_resilience.py`` (fallback, quarantine, size and
checksum checks, retention, staging, the legacy flat layout) holds for
the port's own saves; ``assign_map`` and slice-at-load read the same
values as the JAX restore; and a run the JAX package trained and
checkpointed continues in the port on the JAX trajectory.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu.models import gpt as jgpt
from easyparallellibrary_tpu.parallel import api as japi
from easyparallellibrary_tpu.runtime import saver as jsaver
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.parallel import api as tapi
from easyparallellibrary_tpu_torch.runtime import saver as tsaver
from easyparallellibrary_tpu_torch.testing import chaos
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=16)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _reset_port_env():
  tepl.init(device="cpu")
  yield
  tepl.Env.get().reset()


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _bits(x):
  """A leaf's bit pattern: numpy (incl. ml_dtypes bf16) or a tensor."""
  if isinstance(x, torch.Tensor):
    x = x.detach()
    if x.dtype == torch.bfloat16:
      return x.contiguous().view(torch.int16).numpy()
    return x.contiguous().numpy()
  x = np.asarray(x)
  if x.dtype == ml_dtypes.bfloat16 or x.dtype.kind == "V":
    return x.view(np.int16)
  return x


def _batches(n, batch=4, seed=0):
  r = np.random.RandomState(seed)
  return [r.randint(0, TINY["vocab_size"], (batch, TINY["max_seq_len"] + 1))
          for _ in range(n)]


def _jax_run(steps, dtype="float32", batches=None):
  """JAX: a tiny GPT trained ``steps`` AdamW steps.  Returns (params0
  numpy, state, losses)."""
  jdtype = DTYPES[dtype][0]
  jepl.init(devices=jax.devices()[:1])
  with jepl.replicate(1):
    model = jgpt.GPT(jgpt.GPTConfig(**TINY, dtype=jnp.float32,
                                    param_dtype=jdtype))
  mesh = jepl.current_plan().build_mesh()
  batches = batches if batches is not None else _batches(6)
  tx = optax.adamw(1e-2, weight_decay=0.01)

  def init_fn(r):
    return japi.TrainState.create(
        apply_fn=model.apply,
        params=model.init(r, jnp.asarray(batches[0][:, :-1]))["params"],
        tx=tx)

  state, shardings = japi.create_sharded_train_state(
      init_fn, mesh, jax.random.PRNGKey(0))
  params0 = _np(state.params)
  step = japi.parallelize(
      japi.make_train_step(lambda p, b, r: jgpt.gpt_loss(model, p, b, r)),
      mesh, shardings)
  losses = []
  for i in range(steps):
    state, m = step(state, {"ids": jnp.asarray(batches[i], jnp.int32)},
                    jax.random.PRNGKey(0))
    losses.append(float(m["loss"]))
  return params0, state, losses


def _torch_state(params0, dtype="float32", fused=None):
  tdtype = DTYPES[dtype][1]
  model = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32,
                                  param_dtype=tdtype))
  # Each leaf keeps the JAX tree's own dtype (LayerNorms stay fp32).
  state = tapi.TrainState.create(
      apply_fn=model, params=from_jax_params(params0, device="cpu"),
      tx=tadamw.adamw(1e-2, weight_decay=0.01), fused=fused)
  return model, state


def _torch_train(model, state, batches):
  step = tapi.make_train_step(lambda p, b, r: tgpt.gpt_loss(model, p, b, r))
  losses = []
  for b in batches:
    state, m = step(state, {"ids": torch.from_numpy(b)}, None)
    losses.append(m["loss"].item())
  return state, losses


def _assert_state_equals_jax(tstate, jstate, step):
  want_p = from_jax_params(_np(jstate.params), device="cpu")
  adam = jstate.opt_state[0]
  want_mu = from_jax_params(_np(adam.mu), device="cpu")
  want_nu = from_jax_params(_np(adam.nu), device="cpu")
  assert int(adam.count) == step
  for name, p in tstate.params.items():
    st = tstate.opt_state.state[p]
    np.testing.assert_array_equal(_bits(p), _bits(want_p[name]), name)
    np.testing.assert_array_equal(_bits(st["exp_avg"]),
                                  _bits(want_mu[name]), name)
    np.testing.assert_array_equal(_bits(st["exp_avg_sq"]),
                                  _bits(want_nu[name]), name)
    assert float(st["step"]) == step
  assert tstate.step == step


# ------------------------------------------------- JAX <-> port layout --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_port_bit_equal(tmp_path, dtype):
  params0, jstate, _ = _jax_run(3, dtype)
  root = str(tmp_path / "ck")
  jsaver.save_checkpoint(root, {"params": jstate.params,
                                "opt_state": jstate.opt_state}, step=3)
  index = json.load(open(os.path.join(root, "step_00000003", "index.json")))
  assert index["leaves"]["params/wte/embedding"]["dtype"] == dtype
  _, tstate = _torch_state(params0, dtype)
  tstate, rstep = tsaver.restore_train_state(root, tstate)
  assert rstep == 3
  _assert_state_equals_jax(tstate, jstate, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax_bit_equal(tmp_path, dtype):
  """The port writes the JAX layout: every leaf path, shape and dtype of
  the JAX ``fit`` checkpoint, Dense kernels ``[in, out]``, one count.
  fp32 restores through the JAX package's targeted restore; a bf16
  leaf is held through its untargeted restore (the JAX package's own
  targeted restore of a bf16 leaf raises, ROADMAP Queue 3 caveat)."""
  params0, jstate0, _ = _jax_run(0, dtype)
  model, tstate = _torch_state(params0, dtype)
  tstate, _ = _torch_train(model, tstate, _batches(3))
  root = str(tmp_path / "ck")
  tsaver.save_checkpoint(root, tsaver.state_tree(tstate), step=3)
  jroot = str(tmp_path / "jck")
  jsaver.save_checkpoint(jroot, {"params": jstate0.params,
                                 "opt_state": jstate0.opt_state}, step=3)
  mine = json.load(open(os.path.join(root, "step_00000003", "index.json")))
  theirs = json.load(open(os.path.join(jroot, "step_00000003",
                                       "index.json")))
  assert {k: (v["shape"], v["dtype"]) for k, v in mine["leaves"].items()} \
      == {k: (v["shape"], v["dtype"]) for k, v in theirs["leaves"].items()}
  target = {"params": jstate0.params, "opt_state": jstate0.opt_state}
  if dtype == "float32":
    restored, rstep = jsaver.restore_checkpoint(root, target=target)
    got_p, adam = _np(restored["params"]), restored["opt_state"][0]
    got_mu, got_nu, count = _np(adam.mu), _np(adam.nu), int(adam.count)
  else:
    raw, rstep = jsaver.restore_checkpoint(root)
    with pytest.raises(ValueError, match="cast"):
      jsaver.restore_checkpoint(jroot, target=target)

    def nest(prefix):
      out = {}
      for path, v in raw.items():
        if path.startswith(prefix):
          node = out
          keys = path[len(prefix):].split("/")
          for k in keys[:-1]:
            node = node.setdefault(k, {})
          node[keys[-1]] = (v.view(ml_dtypes.bfloat16)
                            if v.dtype.kind == "V" else v)
      return out

    got_p, got_mu, got_nu = (nest("params/"), nest("opt_state/0/mu/"),
                             nest("opt_state/0/nu/"))
    count = int(raw["opt_state/0/count"])
  assert rstep == 3 and count == 3
  for tree, key in ((got_p, None), (got_mu, "exp_avg"),
                    (got_nu, "exp_avg_sq")):
    want = from_jax_params(tree, device="cpu")
    for name, p in tstate.params.items():
      live = p if key is None else tstate.opt_state.state[p][key]
      np.testing.assert_array_equal(_bits(want[name]), _bits(live), name)


def test_bf16_leaves_round_trip_in_the_port_without_ml_dtypes(tmp_path):
  root = str(tmp_path / "ck")
  x = torch.randn(5, 3).to(torch.bfloat16)
  tsaver.save_checkpoint(root, {"w": x, "f": torch.arange(4.0)}, step=1)
  with np.load(os.path.join(root, "step_00000001", "shard_00000.npz")) as z:
    assert z["w"].dtype == np.dtype("V2")
  got, _ = tsaver.restore_checkpoint(root, device="cpu")
  assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], x)
  # The JAX package reads the same bits through ml_dtypes.
  raw, _ = jsaver.restore_checkpoint(root)
  np.testing.assert_array_equal(raw["w"].view(np.int16), _bits(x))
  target, _ = tsaver.restore_checkpoint(
      root, target={"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                    "f": torch.zeros(4)})
  assert torch.equal(target["w"], x)


def test_fingerprints_and_leaf_shapes_match_jax(tmp_path):
  params0, jstate, _ = _jax_run(1)
  root = str(tmp_path / "ck")
  jsaver.save_checkpoint(root, {"params": jstate.params,
                                "opt_state": jstate.opt_state}, step=1)
  assert tsaver.checkpoint_fingerprint(root) == \
      jsaver.checkpoint_fingerprint(root)
  assert tsaver.peek_leaf_shapes(root) == jsaver.peek_leaf_shapes(root)
  index = json.load(open(os.path.join(root, "step_00000001", "index.json")))
  assert tsaver.params_fingerprint(index) == jsaver.params_fingerprint(index)
  ok, reason = tsaver.verify_checkpoint(os.path.join(root, "step_00000001"))
  assert ok, reason


def test_assign_map_and_slice_at_load_match_jax(tmp_path):
  root = str(tmp_path / "ck")
  stored = np.arange(48, dtype=np.float32).reshape(6, 8)
  tsaver.save_checkpoint(root, {"enc": {"w": torch.from_numpy(stored)}},
                         step=2)
  amap = {"^dec/": "enc/"}
  offsets = {"dec/w": (2, 3)}
  got, _ = tsaver.restore_checkpoint(root, target={"dec": {
      "w": torch.zeros(3, 4)}}, assign_map=amap, slice_offsets=offsets)
  want, _ = jsaver.restore_checkpoint(root, target={"dec": {
      "w": jnp.zeros((3, 4))}}, assign_map=amap, slice_offsets=offsets)
  np.testing.assert_array_equal(got["dec"]["w"].numpy(),
                                np.asarray(want["dec"]["w"]))
  np.testing.assert_array_equal(got["dec"]["w"].numpy(), stored[2:5, 3:7])
  with pytest.raises(ValueError, match="out of bounds"):
    tsaver.restore_checkpoint(root, target={"dec": {"w": torch.zeros(5, 7)}},
                              assign_map=amap, slice_offsets=offsets)


@pytest.mark.parametrize("layout", ["train_state", "bare_params"])
def test_restore_params_reads_jax_checkpoints(tmp_path, layout):
  params0, jstate, _ = _jax_run(2)
  root = str(tmp_path / "ck")
  tree = ({"params": jstate.params, "opt_state": jstate.opt_state}
          if layout == "train_state" else jstate.params)
  jsaver.save_checkpoint(root, tree, step=2)
  want = from_jax_params(_np(jstate.params), device="cpu")
  got, rstep = tsaver.restore_params(root, device="cpu")
  assert rstep == 2 and got.keys() == want.keys()
  for name in want:
    assert torch.equal(got[name], want[name]), name
  model = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  shaped, _ = tsaver.restore_params(root, target=dict(
      model.named_parameters()), device="cpu")
  assert all(torch.equal(shaped[n], want[n]) for n in want)


def test_jax_run_continues_in_the_port_on_the_jax_trajectory(tmp_path):
  """JAX trains 3 AdamW steps and checkpoints; the port restores and
  trains 3 more; its losses follow JAX's own 6-step run at rtol 2e-5
  (the tolerance of the 10-step trajectory pin)."""
  batches = _batches(6, seed=3)
  params0, jstate, _ = _jax_run(3, batches=batches)
  root = str(tmp_path / "ck")
  jsaver.save_checkpoint(root, {"params": jstate.params,
                                "opt_state": jstate.opt_state}, step=3)
  _, _, want = _jax_run(6, batches=batches)
  model, tstate = _torch_state(params0)
  tstate, rstep = tsaver.restore_train_state(root, tstate)
  assert rstep == 3
  tstate, got = _torch_train(model, tstate, batches[3:])
  np.testing.assert_allclose(got, want[3:], rtol=2e-5)


def test_orbax_path_is_not_ported(tmp_path):
  """The orbax format itself is not ported: the port's orbax-named path
  is DCP's (next test), and it refuses a checkpoint that the JAX
  package's orbax path wrote with a named error, where it might
  otherwise fail deep inside DCP's reader."""
  _, jstate, _ = _jax_run(1)
  path = jsaver.save_checkpoint_orbax(str(tmp_path / "jax"), _np(
      jstate.params), step=1)
  assert os.path.isdir(path)
  with pytest.raises(FileNotFoundError, match="no DCP checkpoint"):
    tsaver.restore_checkpoint_orbax(str(tmp_path / "jax"), 1, device="cpu")
  with pytest.raises(FileNotFoundError, match="no DCP checkpoint"):
    tsaver.restore_checkpoint_orbax(str(tmp_path / "none"), 1, device="cpu")


def test_orbax_path_is_dcp_and_round_trips(tmp_path):
  """The JAX package's orbax path is ``torch.distributed.checkpoint``
  here, under the same names: a params tree round-trips bit-equal, as
  the JAX orbax test holds it, under ``step_<N>``; the format is DCP's
  own, not the native ``step_N`` one both packages read, so the native
  reader finds no checkpoint in it."""
  _, jstate, _ = _jax_run(1)
  params = from_jax_params(_np(jstate.params), device="cpu")
  path = tsaver.save_checkpoint_orbax(str(tmp_path / "ock"), params,
                                      step=3)
  assert path.endswith("step_3") and os.path.isdir(path)
  restored = tsaver.restore_checkpoint_orbax(str(tmp_path / "ock"), 3,
                                             target=params)
  assert restored.keys() == params.keys()
  for name, leaf in params.items():
    assert torch.equal(restored[name], leaf), name
  with pytest.raises(FileNotFoundError):
    tsaver.restore_checkpoint(path, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dcp_train_state_round_trip_bit_equal(tmp_path, dtype):
  """A trained state's whole tree (``state_tree``: params, both moments,
  the int32 count; bf16 leaves in the bf16 run) through
  ``save_checkpoint_orbax`` / ``restore_checkpoint_orbax``: every leaf
  bit-equal with its dtype, with a target and without one (flat paths
  on the requested device); a target of another shape is refused."""
  params0, _, _ = _jax_run(0, dtype=dtype)
  model, state = _torch_state(params0, dtype)
  state, _ = _torch_train(model, state, _batches(2))
  tree = tsaver.state_tree(state)
  root = str(tmp_path / "dcp")
  tsaver.save_checkpoint_orbax(root, tree, step=2)
  got = tsaver.restore_checkpoint_orbax(root, 2, target=tree)
  flat = tsaver.restore_checkpoint_orbax(root, 2, device="cpu")
  want = dict(tsaver._sorted_leaves(tree))
  assert set(flat) == set(want)
  for (path, a), (_, b) in zip(tsaver._sorted_leaves(got),
                               tsaver._sorted_leaves(tree)):
    assert a.dtype == b.dtype and torch.equal(a, b), path
    assert torch.equal(flat[path], b), path
  if dtype == "bfloat16":
    assert any(t.dtype == torch.bfloat16 for t in want.values())
  bad = {"params": {k: torch.zeros(3) for k in tree["params"]}}
  with pytest.raises(ValueError, match="shape"):
    tsaver.restore_checkpoint_orbax(root, 2, target=bad)


# ------------------------------------------ crash consistency (port) --


def _tree(seed=0):
  g = torch.Generator().manual_seed(seed)
  return {"dense": {"kernel": torch.randn(8, 4, generator=g),
                    "bias": torch.randn(4, generator=g)}}


def test_atomic_commit_layout_and_checksums(tmp_path):
  root = str(tmp_path / "ck")
  path = tsaver.save_checkpoint(root, _tree(), step=7)
  assert os.path.basename(path) == "step_00000007"
  assert not [d for d in os.listdir(root) if d.endswith(".tmp")]
  index = json.load(open(os.path.join(path, "index.json")))
  assert index["shards"] and all(
      set(e) >= {"file", "bytes", "sha256"} for e in index["shards"])
  assert index["params_fingerprint"] == tsaver.params_fingerprint(index)
  ok, reason = tsaver.verify_checkpoint(path)
  assert ok, reason
  ok, reason = jsaver.verify_checkpoint(path)     # the JAX package agrees
  assert ok, reason


def test_small_shards_split_the_leaves(tmp_path):
  root = str(tmp_path / "ck")
  big = {f"w{i}": torch.randn(256, 256) for i in range(3)}   # 256 KiB each
  path = tsaver.save_checkpoint(root, big, step=1, shard_mb=1)
  index = json.load(open(os.path.join(path, "index.json")))
  assert len(index["shards"]) == 1
  path = tsaver.save_checkpoint(root, {f"w{i}": torch.randn(512, 512)
                                       for i in range(3)}, step=2, shard_mb=1)
  index = json.load(open(os.path.join(path, "index.json")))
  assert len(index["shards"]) == 3
  got, _ = jsaver.restore_checkpoint(root)
  assert sorted(got) == ["w0", "w1", "w2"]


def test_corrupt_newest_falls_back_and_quarantines(tmp_path):
  root = str(tmp_path / "ck")
  t5, t9 = _tree(5), _tree(9)
  tsaver.save_checkpoint(root, t5, step=5)
  p9 = tsaver.save_checkpoint(root, t9, step=9)
  chaos.corrupt_shard(p9, mode="flip")
  assert tsaver.latest_step(root) == 5
  assert not os.path.isdir(p9)
  assert any(d.endswith(".corrupt") for d in os.listdir(root))
  restored, rstep = tsaver.restore_checkpoint(root, target=_tree(0))
  assert rstep == 5
  assert torch.equal(restored["dense"]["kernel"], t5["dense"]["kernel"])


def test_truncated_shard_detected_by_size(tmp_path):
  root = str(tmp_path / "ck")
  tsaver.save_checkpoint(root, _tree(), step=3)
  p6 = tsaver.save_checkpoint(root, _tree(), step=6)
  chaos.corrupt_shard(p6, mode="truncate")
  ok, reason = tsaver.verify_checkpoint(p6)
  assert not ok and "size" in reason
  assert tsaver.latest_step(root) == 3


def test_truncated_or_missing_index_skipped(tmp_path):
  root = str(tmp_path / "ck")
  tsaver.save_checkpoint(root, _tree(), step=2)
  p4 = tsaver.save_checkpoint(root, _tree(), step=4)
  p8 = tsaver.save_checkpoint(root, _tree(), step=8)
  chaos.corrupt_index(p8, mode="truncate")
  chaos.corrupt_index(p4, mode="delete")
  assert tsaver.latest_step(root) == 2
  _, rstep = tsaver.restore_checkpoint(root, target=_tree())
  assert rstep == 2


def test_all_candidates_corrupt_raises_clearly(tmp_path):
  root = str(tmp_path / "ck")
  p1 = tsaver.save_checkpoint(root, _tree(), step=1)
  chaos.corrupt_index(p1, mode="garbage")
  with pytest.raises(tsaver.NoValidCheckpointError, match="VALID"):
    tsaver.restore_checkpoint(root, target=_tree())
  assert tsaver.latest_step(root) is None
  assert tsaver.has_quarantined(root)


def test_keep_last_retention(tmp_path):
  root = str(tmp_path / "ck")
  for s in (1, 2, 3, 4, 5):
    tsaver.save_checkpoint(root, _tree(), step=s, keep_last=2)
  steps = sorted(d for d in os.listdir(root) if d.startswith("step_"))
  assert steps == ["step_00000004", "step_00000005"]
  assert tsaver.latest_step(root) == 5


def test_stale_staging_dir_cleaned_and_ignored(tmp_path):
  root = str(tmp_path / "ck")
  tsaver.save_checkpoint(root, _tree(), step=1)
  os.makedirs(os.path.join(root, "step_00000002.tmp"))
  assert tsaver.latest_step(root) == 1
  tsaver.save_checkpoint(root, _tree(), step=3)
  assert not [d for d in os.listdir(root) if d.endswith(".tmp")]


def test_legacy_flat_layout_still_restores(tmp_path):
  root = str(tmp_path / "ck")
  tree = _tree(2)
  path = tsaver.save_checkpoint(root, tree, step=5)
  flat = str(tmp_path / "flat")
  os.makedirs(flat)
  for f in os.listdir(path):
    shutil.copy(os.path.join(path, f), os.path.join(flat, f))
  assert tsaver.latest_step(flat) == 5
  restored, rstep = tsaver.restore_checkpoint(flat, target=_tree())
  assert rstep == 5
  assert torch.equal(restored["dense"]["bias"], tree["dense"]["bias"])


def test_flat_legacy_coexists_with_step_dirs(tmp_path):
  root = str(tmp_path / "ck")
  src = tsaver.save_checkpoint(root, _tree(3), step=3)
  for f in os.listdir(src):
    shutil.copy(os.path.join(src, f), os.path.join(root, f))
  shutil.rmtree(src)
  assert tsaver.latest_step(root) == 3
  p5 = tsaver.save_checkpoint(root, _tree(5), step=5)
  assert tsaver.latest_step(root) == 5
  chaos.corrupt_shard(p5, mode="flip")
  _, rstep = tsaver.restore_checkpoint(root, target=_tree())
  assert rstep == 3


def test_non_atomic_mode_still_validates(tmp_path):
  root = str(tmp_path / "ck")
  path = tsaver.save_checkpoint(root, _tree(), step=2, atomic=False)
  assert os.path.basename(path) == "step_00000002"
  ok, reason = tsaver.verify_checkpoint(path)
  assert ok, reason


def test_restore_without_a_target_defaults_to_the_card(tmp_path,
                                                         monkeypatch):
  root = str(tmp_path / "ck")
  tsaver.save_checkpoint(root, _tree(), step=1)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tsaver.restore_checkpoint(root)
  got, _ = tsaver.restore_checkpoint(root, device="cpu")
  assert got["dense/kernel"].device.type == "cpu"
