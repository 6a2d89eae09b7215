"""The port's resilience layer against the JAX package's, under the
injected faults of ``testing/chaos.py``.

The model of ``tests/test_resilience.py`` (Dense(8) -> tanh -> Dense(1),
Adam(1e-2), the same initial parameters on both sides): a sentinel-
skipped step is a bit-exact no-op — parameters, both moments, every
per-parameter step and ``TrainState.step`` — through ``guard_step`` and
through ``build_train_step``; ``bad_steps`` / ``bad_steps_total`` /
``grads_finite`` follow the JAX values on the same NaN schedule;
rollback, rollback-off, the give-up cap and the learning-rate backoff
(against JAX with ``optax.inject_hyperparams``) behave as in the JAX
loop; the watchdog, ``retry_call`` and the transient / permanent data
errors too.
"""

import json
import logging
import time

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
from easyparallellibrary_tpu.parallel import api as japi
from easyparallellibrary_tpu.runtime import loop as jloop
from easyparallellibrary_tpu.runtime import resilience as jres
from easyparallellibrary_tpu.testing import chaos as jchaos
from easyparallellibrary_tpu.utils.metrics_writer import (
    MetricsWriter as JWriter)
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.ops.layers import Dense
from easyparallellibrary_tpu_torch.parallel import api as tapi
from easyparallellibrary_tpu_torch.profiler.profiler import StepProfiler
from easyparallellibrary_tpu_torch.runtime import loop as tloop
from easyparallellibrary_tpu_torch.runtime import resilience as tres
from easyparallellibrary_tpu_torch.runtime import saver as tsaver
from easyparallellibrary_tpu_torch.runtime import trainer as ttrainer
from easyparallellibrary_tpu_torch.testing import chaos
from easyparallellibrary_tpu_torch.utils.logging import get_logger
from easyparallellibrary_tpu_torch.utils.metrics_writer import (
    MetricsWriter as TWriter)
from easyparallellibrary_tpu_torch.utils.retry import retry_call
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_port_env():
  yield
  tepl.Env.get().reset()


class JNet(nn.Module):
  @nn.compact
  def __call__(self, x):
    return jops.Dense(1, parallel="none")(jnp.tanh(
        jops.Dense(8, parallel="none")(x)))


class TNet(torch.nn.Module):
  """JNet's layers under flax's names: the outer Dense(1) is built first
  (``Dense_0``), the inner Dense(8) second (``Dense_1``)."""

  def __init__(self):
    super().__init__()
    self.add_module("Dense_0", Dense(8, 1, device="meta"))
    self.add_module("Dense_1", Dense(4, 8, device="meta"))

  def forward(self, x):
    return getattr(self, "Dense_0")(torch.tanh(getattr(self, "Dense_1")(x)))


def _batch(seed=0):
  r = np.random.RandomState(seed)
  return {"x": r.randn(16, 4).astype(np.float32),
          "y": r.randn(16, 1).astype(np.float32)}


def _params0():
  return JNet().init(jax.random.PRNGKey(0), jnp.zeros((16, 4)))["params"]


def _jax(config=None, sentinel=False, tx=None):
  jepl.init(config)
  mesh = jepl.current_plan().build_mesh()
  model = JNet()
  params = _params0()
  tx = tx or optax.adam(1e-2)

  def init_fn():
    st = japi.TrainState.create(apply_fn=model.apply, params=params, tx=tx)
    return jres.attach_sentinel(st) if sentinel else st

  state, sh = japi.create_sharded_train_state(init_fn, mesh)

  def loss_fn(p, b, rng):
    pred = model.apply({"params": p}, b["x"])
    return jnp.mean((pred - b["y"]) ** 2), {}

  step = japi.make_train_step(loss_fn)
  if sentinel:
    step = jres.guard_step(step)
  return state, japi.parallelize(step, mesh, sh)


def _port(config=None, sentinel=False, trainer=False, tx=None):
  """``trainer``: the sentinel through ``build_train_step`` (fused
  AdamW's found_inf) instead of ``guard_step`` (a snapshot)."""
  tepl.init(config, device="cpu")
  mesh = tepl.current_plan().build_mesh()
  model = TNet()
  params = from_jax_params(jax.tree_util.tree_map(
      np.asarray, nn.meta.unbox(_params0())), device="cpu")
  tx = tx or tadamw.adamw(1e-2, weight_decay=0.0)

  def loss_fn(p, b, rng):
    pred = torch.func.functional_call(model, p, (b["x"],))
    return torch.mean((pred - b["y"]) ** 2), {}

  if trainer:
    cfg = tepl.Env.get().config
    if sentinel and not tres.sentinel_enabled(cfg):
      cfg = tepl.Config({"resilience.sentinel": True})
    state, sh = tapi.create_sharded_train_state(
        lambda: ttrainer.create_train_state(model, params, tx, config=cfg),
        mesh)
    step = ttrainer.build_train_step(loss_fn, config=cfg)
  else:
    def init_fn():
      st = tapi.TrainState.create(apply_fn=model, params=params, tx=tx,
                                  fused=True if sentinel else None)
      return tres.attach_sentinel(st) if sentinel else st
    state, sh = tapi.create_sharded_train_state(init_fn, mesh)
    step = tapi.make_train_step(loss_fn)
    if sentinel:
      step = tres.guard_step(step)
  return state, tapi.parallelize(step, mesh, sh)


def _snap(state):
  out = {}
  for name, p in state.params.items():
    st = state.opt_state.state.get(p, {})
    out[name] = [p.detach().clone()] + [st[k].clone() for k in sorted(st)]
  return out


def _assert_same(a, b):
  assert a.keys() == b.keys()
  for name in a:
    assert len(a[name]) == len(b[name])
    for x, y in zip(a[name], b[name]):
      assert torch.equal(x, y), name


# ---------------------------------------------------- anomaly sentinel --


@pytest.mark.parametrize("trainer", [False, True],
                         ids=["guard_step", "build_train_step"])
def test_sentinel_skips_nan_update_exactly(trainer):
  """A NaN batch is a true no-op: the run afterwards is bit-identical to
  one that never saw it, the step count lags by the skip."""
  b1, b3 = _batch(1), _batch(3)
  state, step = _port(sentinel=True, trainer=trainer)
  state, metrics = tloop.fit(step, state, [b1, chaos.nan_batch(b1), b3],
                             num_steps=3, log_every=0, device="cpu")
  assert int(state.step) == 2
  assert int(metrics["bad_steps"]) == 0
  assert int(metrics["bad_steps_total"]) == 1
  state2, step2 = _port(sentinel=True, trainer=trainer)
  state2, _ = tloop.fit(step2, state2, [b1, b3], num_steps=2, log_every=0,
                        device="cpu")
  _assert_same(_snap(state), _snap(state2))


@pytest.mark.parametrize("trainer", [False, True],
                         ids=["guard_step", "build_train_step"])
def test_skipped_step_leaves_every_leaf_bit_identical(trainer):
  """Right after a bad step: parameters, both moments, every
  per-parameter step and ``TrainState.step`` equal the state before it
  (weight decay included: the trainer's AdamW decays)."""
  state, step = _port(sentinel=True, trainer=trainer)
  state, _ = step(state, _batch(1), None)
  before, step_before = _snap(state), int(state.step)
  state, m = step(state, chaos.nan_batch(_batch(2)), None)
  _assert_same(_snap(state), before)
  assert int(state.step) == step_before
  assert float(m["update_skipped"]) == 1.0


@pytest.mark.parametrize("trainer", [False, True],
                         ids=["guard_step", "build_train_step"])
def test_sentinel_metrics_match_jax_on_the_same_nan_schedule(tmp_path,
                                                             trainer):
  batch = _batch()
  data = [batch, jchaos.nan_batch(batch), jchaos.nan_batch(batch), batch]
  jstate, jstep = _jax(sentinel=True)
  with JWriter(str(tmp_path / "j.jsonl")) as w:
    jloop.fit(jstep, jstate, data, num_steps=4, log_every=0,
              metrics_writer=w)
  tstate, tstep = _port(sentinel=True, trainer=trainer)
  with TWriter(str(tmp_path / "t.jsonl")) as w:
    tloop.fit(tstep, tstate, [chaos.nan_batch(b) if np.isnan(
        b["x"]).any() else b for b in data], num_steps=4, log_every=0,
        metrics_writer=w, device="cpu")
  keys = ("bad_steps", "bad_steps_total", "update_skipped")
  want = [{k: line[k] for k in keys}
          for line in map(json.loads, open(tmp_path / "j.jsonl"))]
  got = [{k: line[k] for k in keys}
         for line in map(json.loads, open(tmp_path / "t.jsonl"))]
  assert got == want
  assert [line["bad_steps"] for line in want] == [0.0, 1.0, 2.0, 0.0]


def test_trainer_grads_finite_matches_jax():
  """``build_train_step``'s ``grads_finite`` against the JAX trainer's
  on a clean and a poisoned batch."""
  from easyparallellibrary_tpu.runtime import trainer as jtrainer
  jepl.init(jepl.Config({"resilience": {"sentinel": True}}))
  model = JNet()

  def jloss(p, b, rng):
    return jnp.mean((model.apply({"params": p}, b["x"]) - b["y"]) ** 2), {}

  jstate = jtrainer.create_train_state(model.apply, _params0(),
                                       optax.adam(1e-2))
  jstep = jax.jit(jtrainer.build_train_step(jloss))
  tstate, tstep = _port(sentinel=True, trainer=True)
  for b in (_batch(), chaos.nan_batch(_batch()), _batch(2)):
    jstate, jm = jstep(jstate, b, jax.random.PRNGKey(0))
    tstate, tm = tstep(tstate, b, None)
    for k in ("grads_finite", "bad_steps", "bad_steps_total",
              "update_skipped"):
      assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)


def test_guard_step_requires_counters_and_a_device_side_step():
  state, step = _port()
  with pytest.raises(ValueError, match="attach_sentinel"):
    tres.guard_step(lambda s, b, r: (s, {}))(state, _batch(), None)
  plain = tres.attach_sentinel(state)
  assert plain.sentinel is not None
  assert tres.attach_sentinel(plain) is plain


def test_rollback_recovers_from_persistent_nans(tmp_path):
  """As the JAX test: steps 4..6 poisoned on first draw, max_bad_steps 2
  trips at step 5, fit rolls back to the step-4 checkpoint and replays;
  the state advances 7 times in 8 loop steps.  The JAX loop on the same
  schedule reads the same counts."""
  results = {}
  for side in ("jax", "port"):
    cfg = {"resilience": {"max_bad_steps": 2}}
    if side == "jax":
      state, step = _jax(jepl.Config(cfg), sentinel=True)
      inj = jchaos.NaNInjector(lambda s: _batch(s), bad_steps=(4, 5, 6),
                               num_steps=8)
      run = lambda data, **kw: jloop.fit(step, state, data, **kw)  # noqa
    else:
      state, step = _port(tepl.Config(cfg), sentinel=True)
      inj = chaos.NaNInjector(lambda s: _batch(s), bad_steps=(4, 5, 6),
                              num_steps=8)
      run = lambda data, **kw: tloop.fit(step, state, data,  # noqa
                                         device="cpu", **kw)
    starts = []

    def factory(start_step=0, inj=inj, starts=starts):
      starts.append(start_step)
      return inj(start_step)

    ckpt = str(tmp_path / side)
    out, _ = run(factory, num_steps=8, checkpoint_dir=ckpt,
                 checkpoint_every=4, log_every=0)
    results[side] = (int(out.step), inj.poisoned, starts,
                     jres.MAX_CONSECUTIVE_ROLLBACKS)
  assert results["port"][:3] == (7, [4, 5, 6], [0, 4])
  assert results["port"] == results["jax"]
  assert tres.MAX_CONSECUTIVE_ROLLBACKS == jres.MAX_CONSECUTIVE_ROLLBACKS
  assert tsaver.latest_step(str(tmp_path / "port")) == 8


def test_rollback_off_fails_fast(tmp_path):
  state, step = _port(tepl.Config(
      {"resilience": {"max_bad_steps": 2, "rollback": False}}),
      sentinel=True)
  b = _batch()
  data = [b, b, chaos.nan_batch(b), chaos.nan_batch(b), b, b]
  with pytest.raises(RuntimeError, match="non-finite"):
    tloop.fit(step, state, data, num_steps=6, log_every=0,
              checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
              device="cpu")


def test_persistent_fault_gives_up_after_rollback_cap(tmp_path):
  state, step = _port(tepl.Config({"resilience": {"max_bad_steps": 2}}),
                      sentinel=True)
  inj = chaos.NaNInjector(lambda s: _batch(s), bad_steps=(4, 5, 6, 7),
                          num_steps=8, once=False)
  with pytest.raises(RuntimeError, match="not transient"):
    tloop.fit(step, state, lambda start_step=0: inj(start_step),
              num_steps=8, checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_every=4, log_every=0, device="cpu")
  assert inj.poisoned.count(4) == tres.MAX_CONSECUTIVE_ROLLBACKS + 1


def test_rollback_lr_backoff_compounds_as_jax_inject_hyperparams(tmp_path):
  """A fault that poisons the window after the step-4 checkpoint on its
  first two draws: two consecutive rollbacks, the learning rate
  compounding 0.5 then 0.25 from the checkpoint's value.  The JAX loop
  applies the backoff only under ``optax.inject_hyperparams``; with it
  both end at the same rate."""
  draws = {}

  def make(side):
    def batch_fn(s):
      return _batch(s)

    class Twice:
      """Steps 4-5 poisoned on their first two draws."""
      def __init__(self, nan):
        self.nan, self.poisoned = nan, []

      def __call__(self, start_step=0):
        def gen():
          for s in range(start_step, 10):
            b = batch_fn(s)
            n = draws.setdefault((side, s), 0)
            draws[(side, s)] = n + 1
            if s in (4, 5) and n < 2:
              self.poisoned.append(s)
              b = self.nan(b)
            yield b
        return gen()
    return Twice

  cfg = {"resilience": {"max_bad_steps": 2, "rollback_lr_backoff": 0.5}}
  tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-2)
  jstate, jstep = _jax(jepl.Config(cfg), sentinel=True, tx=tx)
  jdata = make("jax")(jchaos.nan_batch)
  jstate, _ = jloop.fit(jstep, jstate, jdata, num_steps=10, log_every=0,
                        checkpoint_dir=str(tmp_path / "j"),
                        checkpoint_every=4)
  want = float(jstate.opt_state.hyperparams["learning_rate"])
  tstate, tstep = _port(tepl.Config(cfg), sentinel=True)
  tdata = make("port")(chaos.nan_batch)
  tstate, _ = tloop.fit(tstep, tstate, tdata, num_steps=10, log_every=0,
                        checkpoint_dir=str(tmp_path / "t"),
                        checkpoint_every=4, device="cpu")
  got = [g["lr"] for g in tstate.opt_state.param_groups]
  assert tdata.poisoned == jdata.poisoned == [4, 5, 4, 5]
  np.testing.assert_allclose(got, [want] * len(got), rtol=1e-6)
  np.testing.assert_allclose(want, 1e-2 * 0.25, rtol=1e-6)
  assert int(tstate.step) == int(jstate.step) == 10


class _PoisonTwice:
  """Batches of steps 4-5 poisoned on their first two draws (two
  consecutive rollbacks to the step-4 checkpoint), on either side."""

  def __init__(self, nan, num_steps=10):
    self.nan, self.num_steps = nan, num_steps
    self.draws, self.poisoned = {}, []

  def __call__(self, start_step=0):
    def gen():
      for s in range(start_step, self.num_steps):
        b = _batch(s)
        n = self.draws.get(s, 0)
        self.draws[s] = n + 1
        if s in (4, 5) and n < 2:
          self.poisoned.append(s)
          b = self.nan(b)
        yield b
    return gen()


def test_restart_after_backoff_resumes_at_the_jax_rate(tmp_path):
  """``ops.adamw.inject_hyperparams`` keeps the rate in the checkpoint
  at the JAX ``InjectHyperparamsState`` paths.  After two rollbacks back
  the rate off to 1e-2 * 0.25, the JAX checkpoint restores in the port
  at that rate (rtol 1e-6: a float32 leaf) and the port's restores in
  JAX at it; a port ``fit`` restarted on the JAX run's checkpoints
  resumes at it, on the JAX restart's losses (rtol 2e-5)."""
  cfg = {"resilience": {"max_bad_steps": 2, "rollback_lr_backoff": 0.5}}
  want_lr = 1e-2 * 0.25
  jtx = optax.inject_hyperparams(optax.adamw)(learning_rate=1e-2,
                                              weight_decay=0.0)
  ttx = tadamw.inject_hyperparams(tadamw.adamw)(1e-2, weight_decay=0.0)
  jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
  jstate, jstep = _jax(jepl.Config(cfg), sentinel=True, tx=jtx)
  jdata = _PoisonTwice(jchaos.nan_batch)
  jloop.fit(jstep, jstate, jdata, num_steps=10, log_every=0,
            checkpoint_dir=jdir, checkpoint_every=4)
  tstate, tstep = _port(tepl.Config(cfg), sentinel=True, tx=ttx)
  tdata = _PoisonTwice(chaos.nan_batch)
  tloop.fit(tstep, tstate, tdata, num_steps=10, log_every=0,
            checkpoint_dir=tdir, checkpoint_every=4, device="cpu")
  assert tdata.poisoned == jdata.poisoned == [4, 5, 4, 5]

  # JAX -> port: a fresh port state built the same way.
  fresh, _ = _port(sentinel=True, tx=ttx)
  assert [g["lr"] for g in fresh.opt_state.param_groups] == [1e-2]
  fresh, rstep = tsaver.restore_train_state(jdir, fresh)
  assert rstep == 8
  np.testing.assert_allclose(
      [g["lr"] for g in fresh.opt_state.param_groups], [want_lr], rtol=1e-6)
  # Port -> JAX: the port wrote inject_hyperparams' leaves.
  assert tsaver.latest_step(tdir) == 8
  jfresh, _ = _jax(sentinel=True, tx=jtx)
  from easyparallellibrary_tpu.runtime import saver as jsaver
  restored, jrstep = jsaver.restore_checkpoint(
      tdir, target={"params": jfresh.params, "opt_state": jfresh.opt_state})
  assert int(jrstep) == 8
  np.testing.assert_allclose(
      float(restored["opt_state"].hyperparams["learning_rate"]), want_lr,
      rtol=1e-6)
  # The plain recipe still writes optax's plain adamw layout.
  plain, _ = _port(sentinel=True)
  assert isinstance(tsaver.state_tree(plain)["opt_state"], tuple)

  # Restarted on the JAX checkpoints: both resume at the backed-off rate.
  jdir2, tdir2 = str(tmp_path / "j2"), str(tmp_path / "t2")
  import shutil
  shutil.copytree(jdir, jdir2)
  shutil.copytree(jdir, tdir2)
  jstate, jstep = _jax(jepl.Config(cfg), sentinel=True, tx=jtx)
  jstate, jm = jloop.fit(jstep, jstate, lambda start_step=0: (
      _batch(s) for s in range(start_step, 12)), num_steps=12, log_every=0,
                         checkpoint_dir=jdir2, checkpoint_every=0)
  tstate, tstep = _port(tepl.Config(cfg), sentinel=True, tx=ttx)
  tstate, tm = tloop.fit(tstep, tstate, lambda start_step=0: (
      _batch(s) for s in range(start_step, 12)), num_steps=12, log_every=0,
                         checkpoint_dir=tdir2, checkpoint_every=0,
                         device="cpu")
  np.testing.assert_allclose(
      float(jstate.opt_state.hyperparams["learning_rate"]), want_lr,
      rtol=1e-6)
  np.testing.assert_allclose(
      [g["lr"] for g in tstate.opt_state.param_groups], [want_lr], rtol=1e-6)
  assert int(tstate.step) == int(jstate.step) == 12
  np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                             rtol=2e-5)
  for name, p in tstate.params.items():
    jleaf = tsaver.params_tree({name: p})
    for path, value in jleaf.items():
      node = jstate.params
      for part in path.split("/"):
        node = node[part]
      np.testing.assert_allclose(value.detach().numpy(),
                                 np.asarray(nn.meta.unbox(node)), rtol=2e-5,
                                 atol=1e-7)


def test_backoff_learning_rate_scales_every_group():
  p = {"dense.weight": torch.ones(2, 3, requires_grad=True),
       "dense.bias": torch.ones(2, requires_grad=True)}   # two groups
  opt = tadamw.adam_weight_decay_optimizer(0.5).init(p)
  same, applied = tres.backoff_learning_rate(opt, 0.5)
  assert applied and same is opt
  assert [g["lr"] for g in opt.param_groups] == [0.25, 0.25]
  jtx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.5)
  jstate, japplied = jres.backoff_learning_rate(jtx.init({"w": jnp.ones(2)}),
                                                0.5)
  assert japplied and float(jstate.hyperparams["learning_rate"]) == 0.25
  assert tres.backoff_learning_rate(object(), 0.5)[1] is False


def test_fit_refuses_fresh_start_over_corrupt_checkpoints(tmp_path):
  state, step = _port()
  root = str(tmp_path / "ck")
  p1 = tsaver.save_checkpoint(root, tsaver.state_tree(state), step=1)
  chaos.corrupt_index(p1, mode="garbage")
  with pytest.raises(RuntimeError, match="refusing to start fresh"):
    tloop.fit(step, state, [_batch()], num_steps=3, log_every=0,
              checkpoint_dir=root, device="cpu")
  assert tsaver.has_quarantined(root)
  state2, step2 = _port()
  with pytest.raises(RuntimeError, match="refusing to start fresh"):
    tloop.fit(step2, state2, [_batch()], num_steps=3, log_every=0,
              checkpoint_dir=root, device="cpu")


def test_nonfinite_report_names_bad_leaves():
  from easyparallellibrary_tpu_torch.runtime.amp import nonfinite_report
  tree = {"a": {"w": torch.tensor([1.0, float("nan"), float("inf")]),
                "b": torch.ones(3)},
          "n": torch.tensor([1, 2], dtype=torch.int32)}
  assert nonfinite_report(tree) == {"a/w": 2}


# -------------------------------------------------------- retry and IO --


def test_retry_call_recovers_transient_and_respects_permanent():
  assert retry_call(chaos.flaky(lambda: "ok", failures=2), retries=3,
                    backoff_s=0.0) == "ok"
  with pytest.raises(IOError):
    retry_call(chaos.flaky(lambda: "ok", failures=5), retries=2,
               backoff_s=0.0)
  attempts = {"n": 0}

  def missing():
    attempts["n"] += 1
    raise FileNotFoundError("gone")

  with pytest.raises(FileNotFoundError):
    retry_call(missing, retries=3, backoff_s=0.0)
  assert attempts["n"] == 1
  retried = []
  assert retry_call(chaos.flaky(lambda: 7, failures=1), retries=1,
                    backoff_s=0.0, on_retry=lambda a, e: retried.append(a)
                    ) == 7
  assert retried == [1]


def test_fit_retries_transient_data_error(tmp_path):
  state, step = _port()
  data = chaos.FlakyIterator([_batch()] * 5, fail_at=2, failures=2)
  path = str(tmp_path / "m.jsonl")
  with TWriter(path) as w:
    state, _ = tloop.fit(step, state, data, num_steps=5, log_every=0,
                         metrics_writer=w, device="cpu")
  assert int(state.step) == 5
  lines = [json.loads(line) for line in open(path)]
  assert lines[-1]["io_retries"] == 2


def test_fit_feeds_profiler_resilience_counters():
  state, step = _port()
  prof = StepProfiler(warmup=0)
  data = chaos.FlakyIterator([_batch()] * 4, fail_at=1, failures=2)
  tloop.fit(step, state, data, num_steps=4, log_every=0, profiler=prof,
            device="cpu")
  assert prof.io_retries == 2
  assert prof.summary().get("io_retries") == 2.0


def test_fit_exhausted_retries_reraises():
  state, step = _port()
  data = chaos.FlakyIterator([_batch()] * 5, fail_at=1, failures=99)
  with pytest.raises(IOError):
    tloop.fit(step, state, data, num_steps=5, log_every=0, device="cpu")


def test_fit_permanent_error_mid_retry_not_retried():
  state, step = _port()
  errors = [IOError("transient blip"), FileNotFoundError("really gone")]

  class Flaky2:
    def __init__(self):
      self.attempts = 0

    def __iter__(self):
      return self

    def __next__(self):
      if errors:
        self.attempts += 1
        raise errors.pop(0)
      return _batch()

  data = Flaky2()
  with pytest.raises(FileNotFoundError):
    tloop.fit(step, state, data, num_steps=3, log_every=0, device="cpu")
  assert data.attempts == 2


# ----------------------------------------------------------- watchdog --


def test_watchdog_fires_and_disarms():
  fired = []
  dog = tres.StepWatchdog(0.05, on_timeout=fired.append)
  dog.arm(7)
  time.sleep(0.3)
  assert fired == [7] and dog.timeouts_fired == 1
  dog.arm(8)
  dog.disarm()
  time.sleep(0.15)
  assert fired == [7]
  dog.close()


def test_fit_watchdog_logs_slow_step():
  state, step = _port(tepl.Config({"resilience": {"step_timeout_s": 0.1}}))
  batch = _batch()

  class SlowOnce:
    def __init__(self):
      self.n = 0

    def __iter__(self):
      return self

    def __next__(self):
      self.n += 1
      if self.n == 2:
        time.sleep(0.4)
      return batch

  records = []
  handler = logging.Handler()
  handler.emit = records.append
  logger = get_logger()
  logger.addHandler(handler)
  try:
    state, _ = tloop.fit(step, state, SlowOnce(), num_steps=3, log_every=0,
                         device="cpu")
  finally:
    logger.removeHandler(handler)
  assert int(state.step) == 3
  assert any("watchdog" in r.getMessage() for r in records)


def test_sigterm_injector_preempts_fit(tmp_path):
  state, step = _port()
  ckpt = str(tmp_path / "ck")
  with pytest.raises(SystemExit):
    tloop.fit(step, state, chaos.SigtermInjector(_batch(), at_batch=2),
              num_steps=50, checkpoint_dir=ckpt, log_every=0, device="cpu")
  saved = tsaver.latest_step(ckpt)
  assert saved is not None and 2 <= saved <= 4
