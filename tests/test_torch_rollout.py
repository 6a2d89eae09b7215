"""The port's blue/green rollout (``serving/rollout.py``) against the JAX
package's.

Validation refuses a bad or mismatched checkpoint in both packages
(geometry and the checksum chain) before any replica exists; the
scheduler and the process transport's parent side refuse a
cross-version restore.  On an in-process tiny fp32 fleet a full rollout
under live traffic loses no request, each finished request is
attributed to one version, and its stream equals JAX ``generate`` of
that version's weights, with the green checkpoint written by the port's
saver or by the JAX package's.  A canary breach rolls back, and every
blue stream equals a never-rolled fleet's.  A process fleet rolls one
blue child to one green child that restores the checkpoint itself.

The tests never race the spawner thread against the fake clock: they
sweep with the clock stopped until the controller has adopted its green
replicas, and advance it only after, each wait bounded by a deadline.
"""

import importlib
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
from easyparallellibrary_tpu.models import GPT as JaxGPT
from easyparallellibrary_tpu.models import GPTConfig as JaxGPTConfig
from easyparallellibrary_tpu.models.gpt import generate as jax_generate
from easyparallellibrary_tpu.runtime import saver as jsaver
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.observability import slo as tslo
from easyparallellibrary_tpu_torch.observability import trace as ttrace
from easyparallellibrary_tpu_torch.runtime import saver as tsaver
from easyparallellibrary_tpu_torch.serving import Request, Router
from easyparallellibrary_tpu_torch.serving import transport as ttransport
from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

PACKAGES = ("easyparallellibrary_tpu", "easyparallellibrary_tpu_torch")
TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
GEOMETRY = dict(num_slots=2, prefill_chunk=4)
FACTORY = {"fn": "easyparallellibrary_tpu_torch.testing.factories:tiny_gpt",
           "kwargs": {}}
GUARD_S = 240


def _mod(pkg, name):
  return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _guarded(monkeypatch):
  """One torch thread in every child, a wall-clock guard, every child
  reaped and the ambient observability reset at teardown."""
  monkeypatch.setenv("OMP_NUM_THREADS", "1")
  jepl.init()
  tepl.init(device="cpu")

  def _expired(signum, frame):
    raise TimeoutError(f"test exceeded its {GUARD_S} s guard")

  prev = signal.signal(signal.SIGALRM, _expired)
  signal.alarm(GUARD_S)
  try:
    yield
  finally:
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)
    ttransport._reap_orphans()
    for pkg in PACKAGES:
      _mod(pkg, "observability.slo").reset()
      _mod(pkg, "observability.trace").reset()
    tepl.Env.get().reset()


class FakeClock:

  def __init__(self, t=0.0):
    self.t = t

  def __call__(self):
    return self.t

  def advance(self, dt):
    self.t += dt


def _models(scale=1.0):
  """The tiny GPT in both packages; ``scale`` multiplies every weight
  (the green checkpoint: other weights, same geometry)."""
  jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(lambda x: np.asarray(x) * scale,
                                nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  return jmodel, tree, tmodel, from_jax_params(tree, device="cpu")


_JAX_WANT = {}


def _oracle(jmodel, tree, tmodel, params, prompt, max_new, scale):
  """``generate`` of one version's weights: the port's, held once per
  version and prompt length to JAX ``generate`` (which costs about a
  second a call here)."""
  want = tgpt.generate(tmodel, params, torch.from_numpy(prompt)[None].long(),
                       max_new)[0].numpy()
  key = (scale, len(prompt), max_new)
  if key not in _JAX_WANT:
    _JAX_WANT[key] = (prompt, np.asarray(jax_generate(
        jmodel, tree, jnp.asarray(prompt)[None], max_new))[0])
  jprompt, jwant = _JAX_WANT[key]
  if np.array_equal(jprompt, prompt):
    np.testing.assert_array_equal(want, jwant)
  return want


def _prompts(n, lengths=(5, 3, 7, 2), seed=0):
  r = np.random.RandomState(seed)
  return [r.randint(0, 64, (lengths[i % len(lengths)],)).astype(np.int32)
          for i in range(n)]


def _pump(router, until, *, clock=None, dt=0.0, submit=None,
          deadline_s=120.0):
  """Sweep (submitting one request a sweep, advancing the fake clock by
  ``dt``) until ``until()``; the deadline is on the wall clock, since a
  green spawn runs on a real thread."""
  deadline = time.monotonic() + deadline_s
  while not until():
    assert time.monotonic() < deadline, (
        f"rollout stuck in state {router.rollout.state!r}")
    if submit is not None:
      submit()
    router.step()
    if dt:
      clock.advance(dt)
    time.sleep(0.002)


def _greens_adopted(router):
  ctl = router.rollout
  return ctl.state != "spawning" or len(ctl._green) >= ctl._target_greens


# ------------------------------------------------------ validation units


def test_rollout_config_validation_as_jax():
  bad = [({"canary_frac": 0.0}, "canary_frac"),
         ({"canary_frac": 1.5}, "canary_frac"),
         ({"min_replicas": 0}, "min_replicas"),
         ({"spawn_timeout_s": 0.0}, "spawn_timeout_s"),
         ({"canary_hold_s": -1.0}, "canary_hold_s")]
  for pkg in PACKAGES:
    Config = _mod(pkg, "config").Config
    for rollout, match in bad:
      with pytest.raises(ValueError, match=match):
        Config({"serving": {"rollout": rollout}})
    conf = Config({"serving": {"rollout": {"rules": "ttft_p99"}}})
    assert conf.serving.rollout.rules == ("ttft_p99",)
    assert conf.serving.rollout.enabled is False


def _corrupt_first_shard(path):
  shard = next(f for f in os.listdir(path) if f.endswith(".npz"))
  with open(os.path.join(path, shard), "r+b") as f:
    f.seek(0)
    f.write(b"\x00" * 8)


def test_rollout_begin_refuses_bad_checkpoint_as_jax(tmp_path):
  """Geometry (a truncated leaf, written by either package's saver) and
  a corrupt shard fail ``begin`` in both packages before any green
  replica exists; the fleet is untouched."""
  config = {"serving": {"rollout": {"enabled": True}}}
  jmodel, jtree, tmodel, tparams = _models()
  truncated = jax.tree_util.tree_map(lambda x: x, jtree)
  truncated["wte"]["embedding"] = truncated["wte"]["embedding"][:, :1]
  jsaver.save_checkpoint(str(tmp_path / "bad_j"), truncated, step=1)
  port_bad = tsaver.params_tree(tparams)
  port_bad["wpe"] = port_bad["wpe"][:4]
  tepl.init(device="cpu")
  tsaver.save_checkpoint(str(tmp_path / "bad_t"), port_bad, step=1)
  good_j = jsaver.save_checkpoint(str(tmp_path / "good_j"), jtree, step=1)
  good_t = tsaver.save_checkpoint(str(tmp_path / "good_t"),
                                  tsaver.params_tree(tparams), step=1)
  _corrupt_first_shard(good_j)
  _corrupt_first_shard(good_t)
  jepl.init(jepl.Config(config))
  jrouter = _mod(PACKAGES[0], "serving.router").Router(
      jmodel, jtree, num_replicas=1, config=jepl.Config(config), **GEOMETRY)
  tepl.init(tepl.Config(config), device="cpu")
  trouter = Router(tmodel, tparams, num_replicas=1,
                   config=tepl.Config(config), device="cpu", **GEOMETRY)
  for router in (jrouter, trouter):
    for bad in ("bad_j", "bad_t"):
      with pytest.raises(ValueError, match="rollout validation failed"):
        router.rollout.begin(str(tmp_path / bad))
    for corrupt in ("good_j", "good_t"):
      with pytest.raises((FileNotFoundError, ValueError)):
        router.rollout.begin(str(tmp_path / corrupt))
    assert router.rollout.state == "idle" and len(router.replicas) == 1
    assert router.rollout.counters()["rollout_started"] == 0.0
    router.close()


def test_scheduler_refuses_cross_version_restore_as_jax():
  for pkg in PACKAGES:
    sched_mod = _mod(pkg, "serving.scheduler")
    sched = sched_mod.FCFSScheduler(num_slots=2, prefill_chunk=4,
                                    max_seq_len=32, checkpoint_version=1)
    req = sched_mod.Request(uid="r1", prompt=np.asarray([1, 2, 3],
                                                        np.int32),
                            max_new_tokens=4, checkpoint_version=1)
    snap = {"request": req.snapshot(), "generated": [7], "requeues": 0,
            "first_token_emitted": True, "submitted_at": 0.0}
    assert sched.restore_request(snap) == "r1"
    legacy = dict(snap, request=dict(snap["request"],
                                     checkpoint_version=None, uid="r2"))
    assert sched.restore_request(legacy) == "r2"
    wrong = dict(snap, request=dict(snap["request"], checkpoint_version=2,
                                    uid="r3"))
    with pytest.raises(ValueError, match="cross-version restore refused"):
      sched.restore_request(wrong)


def test_process_transport_refuses_cross_version_restore_parent_side():
  """The parent-side fence fires before any journaling or wire traffic
  (no child is started)."""
  rep = ttransport.ProcessTransport(
      0, FACTORY, config=tepl.Config(),
      engine_kwargs={"checkpoint_version": 3, "device": "cpu"},
      start=False)
  assert rep.checkpoint_version == 3
  req = Request(uid="x", prompt=np.asarray([1, 2], np.int32),
                max_new_tokens=2, checkpoint_version=2)
  snap = {"request": req.snapshot(), "generated": [], "requeues": 0,
          "first_token_emitted": False, "submitted_at": 0.0}
  with pytest.raises(ValueError, match="cross-version restore refused"):
    rep.restore_request(snap)
  assert not rep._journal


# ------------------------------------------------- in-process rollouts


def _rollout_conf(**rollout):
  rollout = {"enabled": True, "canary_frac": 0.5, "canary_hold_s": 1.0,
             "min_replicas": 2, "drain_timeout_s": 60.0, **rollout}
  return tepl.Config({"serving": {"rollout": rollout}})


def _write_green(tmp_path, writer, green_tree, green_params):
  path = str(tmp_path / f"green_{writer}")
  if writer == "jax":
    jsaver.save_checkpoint(path, green_tree, step=7)
  else:
    tsaver.save_checkpoint(path, tsaver.params_tree(green_params), step=7)
  return path


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_full_rollout_zero_loss_single_version_attribution(tmp_path,
                                                           writer):
  """Under live traffic a full blue -> green rollout loses no request;
  each request retires on the version it was admitted to, with the
  stream ``generate`` gives for that version's weights (the port's,
  held to JAX ``generate``); the fleet
  lands on green (version, weights, recipe) and no kernel library is
  loaded.  The green checkpoint comes from the port's saver or from the
  JAX package's."""
  jmodel, jtree, tmodel, tparams = _models()
  _, green_tree, _, green_params = _models(scale=1.5)
  ckpt = _write_green(tmp_path, writer, green_tree, green_params)
  config = _rollout_conf()
  tepl.init(config, device="cpu")
  clock = FakeClock()
  router = Router(tmodel, tparams, num_replicas=2, config=config,
                  clock=clock, device="cpu", **GEOMETRY)
  libs = _build.loaded_count()
  prompts = _prompts(24, seed=9)
  max_new = 5
  admitted = {}
  ctr = [0]

  def submit_one():
    uid = ctr[0]
    if uid >= len(prompts):
      return
    ctr[0] += 1
    assert router.submit(Request(uid=uid, prompt=prompts[uid],
                                 max_new_tokens=max_new))
    admitted[uid] = router._replica_version(router.placement[uid])

  for _ in range(4):
    submit_one()
  router.step()
  assert router.rollout.begin(ckpt) == 1
  assert router.rollout.state == "spawning"
  # The clock stands still until both greens are in the fleet.
  _pump(router, lambda: _greens_adopted(router), submit=submit_one)
  assert router.rollout.state == "canary" and len(router.replicas) == 4
  assert router._version_weights == {0: 0.5, 1: 0.5}
  _pump(router, lambda: router.rollout.state != "canary", clock=clock,
        dt=0.05, submit=submit_one)
  _pump(router, lambda: router.rollout.state == "idle", clock=clock,
        dt=0.05, submit=submit_one)
  while ctr[0] < len(prompts):
    submit_one()
  router.run()
  assert sorted(router.finished) == list(range(len(prompts)))
  assert set(admitted.values()) == {0, 1}
  assert sum(v == 1 for v in admitted.values()) >= 2
  for uid, prompt in enumerate(prompts):
    fin = router.finished[uid]
    assert fin.finish_reason == "length", (uid, fin.finish_reason)
    green = admitted[uid] == 1
    want = _oracle(jmodel, green_tree if green else jtree, tmodel,
                   green_params if green else tparams, prompt, max_new,
                   1.5 if green else 1.0)
    np.testing.assert_array_equal(fin.tokens, want, err_msg=f"req {uid}")
  assert _build.loaded_count() == libs
  assert router._fleet_version == 1 and router._version_weights is None
  assert router.states() == ["draining", "draining", "healthy", "healthy"]
  spec = router._replica_spec
  assert spec["engine_kwargs"]["checkpoint_version"] == 1
  assert all(torch.equal(spec["params"][k], green_params[k])
             for k in green_params)
  assert router.rollout.counters() == {
      "rollout_started": 1.0, "rollout_completed": 1.0,
      "rollout_rollbacks": 0.0, "rollout_spawn_failures": 0.0,
      "rollout_active": 0.0}
  router.close()


@pytest.mark.quick
def test_canary_breach_rolls_back_blue_bit_exact(tmp_path):
  """A breach on green's own stream (``serving/fleet/v1/...``) rolls the
  rollout back: green drains with its canary requests completing in
  place, blue admission returns, and every blue stream equals a
  never-rolled fleet's and JAX ``generate``'s."""
  jmodel, jtree, tmodel, tparams = _models()
  _, green_tree, _, green_params = _models(scale=1.5)
  ckpt = _write_green(tmp_path, "port", green_tree, green_params)
  prompts = _prompts(16, seed=13)
  max_new = 4

  def make_router(clock):
    config = tepl.Config({
        "serving": {"rollout": {
            "enabled": True, "canary_frac": 0.5,
            "canary_hold_s": 1000.0,   # only the breach ends the canary
            "min_replicas": 2, "drain_timeout_s": 60.0}},
        "observability": {"slo": {"enabled": True, "ttft_p99_s": 0.5}}})
    tepl.init(config, device="cpu")
    return Router(tmodel, tparams, num_replicas=2, config=config,
                  clock=clock, device="cpu", **GEOMETRY)

  def drive(router, clock, roll):
    admitted = {}
    ctr = [0]

    def submit_one():
      uid = ctr[0]
      if uid >= len(prompts):
        return
      ctr[0] += 1
      assert router.submit(Request(uid=uid, prompt=prompts[uid],
                                   max_new_tokens=max_new))
      admitted[uid] = router._replica_version(router.placement[uid])

    for _ in range(4):
      submit_one()
    router.step()
    if roll:
      router.rollout.begin(ckpt)
      _pump(router, lambda: _greens_adopted(router))
      assert router.rollout.state == "canary"
      for _ in range(4):
        submit_one()
      router.step()
      tslo.get_monitor().observe(router.steps,
                                 {"serving/fleet/v1/ttft_p99_s": 99.0})
      _pump(router, lambda: router.rollout.state != "canary",
            clock=clock, dt=0.05)
      assert router.rollout.state == "rolling_back"
      _pump(router, lambda: router.rollout.state == "idle", clock=clock,
            dt=0.05)
    while ctr[0] < len(prompts):
      submit_one()
    router.run()
    return admitted

  base_router = make_router(FakeClock())
  base_attr = drive(base_router, None, roll=False)
  base = {u: f.tokens for u, f in base_router.finished.items()}
  base_router.close()
  tslo.reset()
  clock = FakeClock()
  router = make_router(clock)
  attr = drive(router, clock, roll=True)
  counters = router.rollout.counters()
  assert counters["rollout_rollbacks"] == 1.0
  assert counters["rollout_completed"] == 0.0
  assert router._fleet_version == 0 and router._version_weights is None
  assert all(router.health[i].state == "draining"
             for i in router.rollout._green)
  assert sorted(router.finished) == list(range(len(prompts)))
  green_uids = {u for u, v in attr.items() if v == 1}
  assert green_uids, "the canary never carried traffic"
  assert base_attr.keys() == attr.keys()
  for uid, fin in router.finished.items():
    assert fin.finish_reason == "length"
    green = uid in green_uids
    want = _oracle(jmodel, green_tree if green else jtree, tmodel,
                   green_params if green else tparams, prompts[uid],
                   max_new, 1.5 if green else 1.0)
    np.testing.assert_array_equal(fin.tokens, want, err_msg=f"req {uid}")
    if uid not in green_uids:
      np.testing.assert_array_equal(fin.tokens, base[uid],
                                    err_msg=f"blue req {uid}")
  router.close()


def test_rollout_enabled_but_idle_is_bit_identical_zero_actuations():
  """Rollout on but never begun: the same streams as the fleet without
  it, zero actuations, no version weights, no kernel library loaded."""
  _, _, tmodel, tparams = _models()
  prompts = _prompts(4)
  max_new = (6, 7, 4, 5)

  def drive(router):
    out = {}
    for i in range(2):
      assert router.submit(Request(uid=i, prompt=prompts[i],
                                   max_new_tokens=max_new[i]))
    for _ in range(2):
      for fin in router.step():
        out[fin.uid] = fin.tokens
    for i in range(2, 4):
      assert router.submit(Request(uid=i, prompt=prompts[i],
                                   max_new_tokens=max_new[i]))
    out.update(router.run())
    return out

  base_router = Router(tmodel, tparams, num_replicas=2, device="cpu",
                       **GEOMETRY)
  base = drive(base_router)
  base_router.close()
  libs = _build.loaded_count()
  config = tepl.Config({
      "serving": {"rollout": {"enabled": True}},
      "observability": {"slo": {"enabled": True, "ttft_p99_s": 100.0,
                                "itl_p99_s": 100.0}}})
  tepl.init(config, device="cpu")
  router = Router(tmodel, tparams, num_replicas=2, config=config,
                  device="cpu", **GEOMETRY)
  rolled = drive(router)
  assert tslo.get_monitor().actuations == 0
  assert router.rollout.state == "idle"
  assert router.rollout.counters()["rollout_started"] == 0.0
  assert router._version_weights is None and router._fleet_version == 0
  assert _build.loaded_count() == libs
  assert sorted(base) == sorted(rolled)
  for uid in base:
    np.testing.assert_array_equal(rolled[uid], base[uid])
  router.close()


# ------------------------------------------------------ process rollout


def test_process_rollout_one_blue_child_to_one_green_child(tmp_path):
  """One blue child rolls to one green child that restores the
  checkpoint over the factory's weights itself (the init frame's
  ``checkpoint``): no request lost, each stream equal to ``generate`` of
  its version's weights, the fleet on green, both children reaped."""
  blue_model, blue_params = tiny_gpt(device="cpu")
  _, green_params = tiny_gpt(seed=1, device="cpu")
  ckpt = str(tmp_path / "green")
  tsaver.save_checkpoint(ckpt, tsaver.params_tree(green_params), step=3)
  config = tepl.Config({"serving": {
      "router": {"transport": "process", "spawn_timeout_s": 90.0,
                 "rpc_timeout_s": 60.0, "suspect_after": 600.0,
                 "down_after": 1200.0},
      "rollout": {"enabled": True, "canary_frac": 0.5,
                  "canary_hold_s": 0.5, "min_replicas": 1,
                  "spawn_timeout_s": 90.0, "drain_timeout_s": 60.0}}})
  tepl.init(config, device="cpu")
  clock = FakeClock()
  router = Router(num_replicas=1, config=config, factory=FACTORY,
                  clock=clock, device="cpu", paged=True, block_size=4,
                  **GEOMETRY)
  try:
    prompts = _prompts(10, seed=4)
    max_new = 5
    admitted = {}
    ctr = [0]

    def submit_one():
      uid = ctr[0]
      if uid >= len(prompts):
        return
      ctr[0] += 1
      assert router.submit(Request(uid=uid, prompt=prompts[uid],
                                   max_new_tokens=max_new))
      admitted[uid] = router._replica_version(router.placement[uid])

    for _ in range(3):
      submit_one()
    router.step()
    router.rollout.begin(ckpt)
    _pump(router, lambda: _greens_adopted(router))
    green = router.replicas[1]
    assert green.child_pid is not None and green.last_spawn_s > 0
    _pump(router, lambda: router.rollout.state == "idle", clock=clock,
          dt=0.05, submit=submit_one)
    while ctr[0] < len(prompts):
      submit_one()
    router.run()
    assert sorted(router.finished) == list(range(len(prompts)))
    assert set(admitted.values()) == {0, 1}
    for uid, prompt in enumerate(prompts):
      params = green_params if admitted[uid] == 1 else blue_params
      want = tgpt.generate(blue_model, params,
                           torch.from_numpy(prompt)[None].long(),
                           max_new)[0].numpy()
      np.testing.assert_array_equal(router.finished[uid].tokens, want,
                                    err_msg=f"req {uid}")
    assert router._fleet_version == 1
    assert router._replica_spec["checkpoint"] == ckpt
    pids = [rep.child_pid for rep in router.replicas]
  finally:
    router.close()
  for pid in pids:
    with pytest.raises(ChildProcessError):
      os.waitpid(pid, os.WNOHANG)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="needs a machine without a card")
@pytest.mark.parametrize("transport", ["inproc", "process"])
def test_green_asked_for_cuda_without_a_card_rolls_back(tmp_path,
                                                        transport):
  """No fallback to the CPU: a green replica asked for ``"cuda"`` where
  there is no card raises (the child at init, or the in-process restore
  of the checkpoint); the rollout books a spawn failure and rolls back,
  and the blue fleet serves on."""
  model, params = tiny_gpt(device="cpu")
  ckpt = str(tmp_path / "green")
  tsaver.save_checkpoint(ckpt, tsaver.params_tree(params), step=1)
  router_conf = ({"transport": "process", "spawn_timeout_s": 90.0,
                  "rpc_timeout_s": 60.0} if transport == "process" else {})
  config = tepl.Config({"serving": {
      "router": router_conf,
      "rollout": {"enabled": True, "min_replicas": 1,
                  "spawn_timeout_s": 90.0}}})
  tepl.init(config, device="cpu")
  kwargs = (dict(factory=FACTORY) if transport == "process"
            else dict(model=model, params=params))
  router = Router(num_replicas=1, config=config, device="cpu", **kwargs,
                  **GEOMETRY)
  try:
    router._replica_spec["engine_kwargs"]["device"] = "cuda"
    router.rollout.begin(ckpt)
    deadline = time.monotonic() + 120.0
    while router.rollout.active:
      assert time.monotonic() < deadline, router.rollout.state
      router.step()
      time.sleep(0.005)
    counters = router.rollout.counters()
    assert counters["rollout_spawn_failures"] == 1.0
    assert counters["rollout_rollbacks"] == 1.0
    assert len(router.replicas) == 1 and router.states() == ["healthy"]
    prompt = np.arange(1, 6, dtype=np.int32)
    assert router.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
    out = router.run()
    want = tgpt.generate(model, params, torch.from_numpy(prompt)[None].long(),
                         4)[0].numpy()
    np.testing.assert_array_equal(out[0], want)
  finally:
    router.close()


def test_close_stops_the_spawner_thread_and_frees_the_fleet(tmp_path):
  """The spawner thread holds the controller, and with it the router and
  every engine, for as long as it runs: ``Router.close()`` stops it, and
  the rolled fleet is then collectable (on the card, its engines' memory
  is given back)."""
  import gc
  import weakref
  model, params = tiny_gpt(device="cpu")
  ckpt = str(tmp_path / "green")
  tsaver.save_checkpoint(ckpt, tsaver.params_tree(params), step=1)
  config = _rollout_conf(min_replicas=1, canary_hold_s=0.0)
  tepl.init(config, device="cpu")
  router = Router(model, params, num_replicas=1, config=config,
                  device="cpu", **GEOMETRY)
  router.rollout.begin(ckpt)
  _pump(router, lambda: not router.rollout.active)
  assert router.rollout.completed == 1
  thread = router.rollout._spawn_thread
  assert thread.is_alive()
  ref = weakref.ref(router)
  router.close()
  thread.join(timeout=30.0)
  assert not thread.is_alive()
  del router
  gc.collect()
  assert ref() is None
