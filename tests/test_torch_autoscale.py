"""The port's fleet autoscaler (``serving/autoscale.py``) and the router's
growth levers against the JAX package's.

Each scenario of the JAX package's policy tests runs on both packages'
``Router`` + ``FleetAutoscaler`` with one fake clock and fake replicas:
scale-up on burn and drain after quiet, the named threshold rule, warm
rejoin of only its own drained capacity, operator capacity never
drained, a live burn sustaining growth, the flap breaker, and the cold
spawn off the sweep thread.  The actuation sequences, the router's
counters and the replica states must be equal step for step.  The
fault-free guard: with the autotuner, the autoscaler and the SLO monitor
on and no breach, a tiny in-process fleet is bit-identical to the fleet
without them, with zero actuations and no kernel library loaded.
"""

import importlib
import json
import threading
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
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

PACKAGES = ("easyparallellibrary_tpu", "easyparallellibrary_tpu_torch")
TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)


def _mod(pkg, name):
  return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _reset_ambient():
  yield
  for pkg in PACKAGES:
    _mod(pkg, "observability.slo").reset()
    _mod(pkg, "observability.trace").reset()
  tepl.Env.get().reset()


def _actuations(monitor):
  if monitor is None:
    return []
  seq = [{k: v for k, v in ev.items() if k != "time"}
         for ev in monitor.events if ev.get("event") == "actuation"]
  return json.loads(json.dumps(seq, default=str))


class FakeClock:

  def __init__(self, t=0.0):
    self.t = t

  def __call__(self):
    return self.t

  def advance(self, dt):
    self.t += dt


class FakeReplica:
  """A replica with no work: the router's duck surface, nothing else."""

  def __init__(self, index):
    self.index = index
    self.finished = {}
    self.has_work = False
    self.num_slots = 4
    self.stats = None
    self.watchdog_timeouts = 0
    self.bad_steps = 0
    self.itl_ewma_s = 0.0

  load = property(lambda self: 0)
  queue_depth = property(lambda self: 0)
  num_active = property(lambda self: 0)

  def submit(self, req):
    return True

  def cancel(self, uid):
    return False

  def step(self):
    return []

  def evacuate(self):
    return []

  def restore_request(self, snap, front=False):
    return snap["request"]["uid"]

  def close(self):
    pass


def _burn_monitor(pkg):
  slo = _mod(pkg, "observability.slo")
  return slo.SLOMonitor([slo.BurnRateRule(
      "shed_burn", bad="shed", good="finished_requests", objective=0.5,
      fast_window=2, slow_window=3, fast_burn=1.0, slow_burn=1.0)])


def _scaling_router(pkg, clock, monitor=None, **autoscale):
  """An injected two-replica fleet of fakes with the autoscaler on; it
  grows by appending fakes (an injected fleet carries no recipe)."""
  autoscale.setdefault("enabled", True)
  autoscale.setdefault("min_replicas", 2)
  autoscale.setdefault("max_replicas", 4)
  autoscale.setdefault("scale_up_cooldown_s", 1.0)
  autoscale.setdefault("scale_down_cooldown_s", 10.0)
  autoscale.setdefault("flap_window_s", 30.0)
  config = _mod(pkg, "config").Config({"serving": {"autoscale": autoscale}})
  _mod(pkg, "observability.slo").reset()    # each scenario starts afresh
  if monitor is not None:
    _mod(pkg, "observability.slo").install(monitor)
  router = _mod(pkg, "serving.router").Router(
      replicas=[FakeReplica(0), FakeReplica(1)], config=config, clock=clock)

  def add_replica():
    index = len(router.replicas)
    router.replicas.append(FakeReplica(index))
    router.health.append(router._make_health(index))
    return index
  router.add_replica = add_replica
  return router, router._autoscaler


def _burn_breach(scaler, rule="shed_burn"):
  """One burn-rate breach as the monitor delivers it to a listener."""
  scaler._on_breach(rule, {"metric": "serving/fleet/shed",
                           "fast_burn": 4.0, "slow_burn": 2.0})


class _Recorder:
  """What a scenario observed after each sweep: replica states, the
  autoscaler's books and the router's counters."""

  def __init__(self, router, scaler):
    self.router, self.scaler, self.rows = router, scaler, []

  def step(self):
    self.router.step()
    self.note()

  def note(self):
    s, r = self.scaler, self.router
    self.rows.append({
        "states": r.states(), "scale_ups": s.scale_ups,
        "scale_downs": s.scale_downs, "holds": s.holds,
        "flap_trips": s.flap_trips, "spawn_failures": s.spawn_failures,
        "added": list(s._added), "parked": list(s._parked),
        "counters": r.router_counters()})


# ------------------------------------------------------------- scenarios


def _scenario_burn_and_quiet(pkg):
  clock = FakeClock()
  router, scaler = _scaling_router(pkg, clock)
  rec = _Recorder(router, scaler)
  rec.step()
  scaler._on_breach("ttft_p99", {"metric": "serving/fleet/ttft_p99_s",
                                 "value": 9.0, "target": 0.5})
  rec.step()                          # an unnamed threshold rule: ignored
  _burn_breach(scaler)
  rec.step()
  for dt in (0.5, 1.0, 1.5):
    clock.advance(dt)
    _burn_breach(scaler)
    rec.step()
  for _ in range(3):
    clock.advance(100.0)
    rec.step()
  return rec.rows


def _scenario_named_rule(pkg):
  clock = FakeClock()
  router, scaler = _scaling_router(pkg, clock, rules="ttft_p99")
  rec = _Recorder(router, scaler)
  scaler._on_breach("ttft_p99", {"metric": "serving/fleet/ttft_p99_s",
                                 "value": 9.0, "target": 0.5})
  rec.step()
  return rec.rows


def _scenario_own_capacity(pkg):
  clock = FakeClock()
  router, scaler = _scaling_router(pkg, clock, min_replicas=1,
                                   scale_down_cooldown_s=5.0)
  rec = _Recorder(router, scaler)
  router.drain(1)                     # an operator's maintenance drain
  rec.note()
  _burn_breach(scaler)
  rec.step()
  clock.advance(50.0)
  rec.step()                          # quiet: drains its own replica 2
  clock.advance(2.0)
  _burn_breach(scaler)
  rec.step()                          # warm rejoin of 2
  clock.advance(50.0)
  rec.step()                          # quiet: parks 2 again
  router.rejoin(2)                    # the operator takes it back ...
  rec.step()                          # ... the parked claim dies
  router.drain(2)                     # ... and drains it for maintenance
  clock.advance(2.0)
  _burn_breach(scaler)
  rec.step()                          # a cold spawn, never that drain
  return rec.rows


def _scenario_base_capacity(pkg):
  clock = FakeClock()
  router, scaler = _scaling_router(pkg, clock)
  rec = _Recorder(router, scaler)
  _burn_breach(scaler)
  rec.step()
  router.health[2].mark_down("chaos: added capacity died")
  clock.advance(100.0)
  rec.step()
  return rec.rows


def _scenario_live_burn(pkg):
  clock = FakeClock()
  monitor = _burn_monitor(pkg)
  router, scaler = _scaling_router(pkg, clock, monitor=monitor)
  assert router._slo is monitor
  rec = _Recorder(router, scaler)
  feed = {"i": 0, "shed": 0.0}

  def burn():
    feed["shed"] += 5.0
    monitor.observe(feed["i"], {
        "serving/custom/shed": feed["shed"],
        "serving/custom/finished_requests": 1.0})
    feed["i"] += 1

  for _ in range(5):
    burn()
  rec.step()
  clock.advance(1.2)
  burn()
  rec.step()
  for _ in range(12):
    clock.advance(3.0)
    burn()
    rec.step()
  clock.advance(100.0)
  rec.step()
  return rec.rows + [{"breaches": monitor.breaches,
                      "events": _actuations(monitor)}]


def _scenario_flap(pkg):
  clock = FakeClock()
  router, scaler = _scaling_router(pkg, clock, scale_down_cooldown_s=5.0,
                                   flap_window_s=30.0)
  rec = _Recorder(router, scaler)
  _burn_breach(scaler)
  rec.step()
  clock.advance(6.0)
  rec.step()                          # quiet: drain
  clock.advance(2.0)
  _burn_breach(scaler)
  rec.step()                          # re-grow inside the flap window
  holdout = scaler.scale_up_holdout_s()
  clock.advance(1.2)
  _burn_breach(scaler)
  rec.step()                          # inside the doubled hold-out: held
  clock.advance(31.0)
  rec.step()                          # a clean window forgives the trip
  return rec.rows + [{"holdout": holdout,
                      "base": scaler.scale_up_cooldown_s}]


SCENARIOS = {
    "burn_and_quiet": _scenario_burn_and_quiet,
    "named_rule": _scenario_named_rule,
    "own_capacity": _scenario_own_capacity,
    "base_capacity": _scenario_base_capacity,
    "live_burn": _scenario_live_burn,
    "flap": _scenario_flap,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscaler_scenario_equals_jax(name):
  """The scenario on both packages: the same states, books and router
  counters after every sweep."""
  jax_rows, port_rows = (SCENARIOS[name](pkg) for pkg in PACKAGES)
  assert port_rows == jax_rows


def test_autoscaler_scenarios_reach_what_jax_asserts():
  """The port's runs make the JAX package's own assertions."""
  rows = _scenario_burn_and_quiet(PACKAGES[1])
  assert rows[1]["scale_ups"] == 0            # unnamed rule ignored
  assert rows[2]["scale_ups"] == 1 and rows[2]["added"] == [2]
  assert rows[2]["counters"]["scale_ups"] == 1.0
  assert rows[3]["holds"] == 1                # inside the cooldown
  assert rows[4]["states"] == ["healthy"] * 4
  assert rows[5]["holds"] == 2                # at max_replicas
  assert rows[7]["states"] == ["healthy", "healthy", "draining",
                               "draining"]
  assert rows[8]["scale_downs"] == 2          # base capacity untouched
  assert _scenario_named_rule(PACKAGES[1])[0]["states"] == ["healthy"] * 3
  own = _scenario_own_capacity(PACKAGES[1])
  assert own[1]["states"] == ["healthy", "draining", "healthy"]
  assert own[2]["parked"] == [2]
  assert own[3]["states"] == ["healthy", "draining", "healthy"]
  assert own[3]["scale_ups"] == 2 and own[3]["parked"] == []
  assert own[5]["parked"] == []
  assert len(own[6]["states"]) == 4 and own[6]["states"][2] == "draining"
  base = _scenario_base_capacity(PACKAGES[1])
  assert base[1]["scale_downs"] == 0
  assert base[1]["states"][:2] == ["healthy", "healthy"]
  live = _scenario_live_burn(PACKAGES[1])
  assert live[-1]["breaches"] == 1
  assert live[0]["scale_ups"] == 1 and live[1]["scale_ups"] == 2
  assert live[-3]["scale_downs"] == 0 and live[-2]["scale_downs"] == 1
  assert live[-2]["states"][3] == "draining"
  flap = _scenario_flap(PACKAGES[1])
  assert flap[2]["flap_trips"] == 1
  assert flap[-1]["holdout"] == pytest.approx(2 * flap[-1]["base"])
  assert flap[3]["scale_ups"] == 2 and flap[3]["holds"] >= 1
  assert flap[4]["flap_trips"] == 0


def _wait_spawn_outcome(scaler, timeout=10.0):
  """Wait on the autoscaler's own state (a posted spawn outcome), with a
  deadline; never on the clock the policy reads."""
  deadline = time.monotonic() + timeout
  while time.monotonic() < deadline:
    with scaler._lock:
      if scaler._spawn_outcome is not None:
        return True
    time.sleep(0.005)
  return False


def _scenario_cold_spawn(pkg):
  clock = FakeClock()
  router, scaler = _scaling_router(pkg, clock)
  rec = _Recorder(router, scaler)
  release = threading.Event()

  def slow_build(index=None):
    assert release.wait(timeout=10.0)
    return FakeReplica(len(router.replicas))

  router.build_replica = slow_build
  router._replica_spec = {}           # a recipe: the off-thread path
  assert router.spawn_recipe_available
  _burn_breach(scaler)
  t0 = time.monotonic()
  rec.step()                          # starts the spawn, returns at once
  fast = time.monotonic() - t0 < 1.0
  in_flight = scaler.spawn_in_flight
  _burn_breach(scaler)
  rec.step()                          # a second impulse holds
  release.set()
  posted = _wait_spawn_outcome(scaler)
  before = len(router.replicas)
  rec.step()                          # adopted at this sweep
  landed = not scaler.spawn_in_flight
  clock.advance(100.0)
  rec.step()                          # quiet: drains replica 2

  def bad_build(index=None):
    raise RuntimeError("fake spawn failure")

  router.build_replica = bad_build
  scaler._parked = []                 # the cold path, not a rejoin
  clock.advance(2.0)
  _burn_breach(scaler)
  rec.step()
  failed = _wait_spawn_outcome(scaler)
  rec.step()                          # books the failure
  return rec.rows + [{"fast": fast, "in_flight": in_flight,
                      "posted": posted, "before": before,
                      "landed": landed, "failed": failed}]


def test_cold_spawn_off_the_sweep_thread_equals_jax():
  """A slow spawn runs off the sweep thread: the sweep returns at once,
  the replica is unroutable until adopted at a later sweep, a second
  impulse holds, and a failing spawn books ``spawn_failures`` and never
  a flap.  The test waits on the autoscaler's posted outcome, never on
  the clock the policy reads.  Same books in both packages."""
  jax_rows, port_rows = (_scenario_cold_spawn(pkg) for pkg in PACKAGES)
  assert port_rows == jax_rows
  *rows, flags = port_rows
  assert flags == {"fast": True, "in_flight": True, "posted": True,
                   "before": 2, "landed": True, "failed": True}
  assert rows[0]["scale_ups"] == 0 and len(rows[0]["states"]) == 2
  assert rows[1]["holds"] >= 1 and len(rows[1]["states"]) == 2
  assert rows[2]["scale_ups"] == 1 and rows[2]["added"] == [2]
  assert rows[2]["states"] == ["healthy"] * 3
  assert rows[-1]["spawn_failures"] == 1 and rows[-1]["flap_trips"] == 0
  assert rows[-1]["scale_ups"] == 1 and len(rows[-1]["states"]) == 3


def test_close_stops_the_autoscaler_spawner_thread():
  """After an off-thread cold spawn the spawner thread (which holds the
  policy and its router) stops at ``Router.close()``."""
  clock = FakeClock()
  router, scaler = _scaling_router(PACKAGES[1], clock)
  router.build_replica = lambda index=None: FakeReplica(len(router.replicas))
  router._replica_spec = {}
  _burn_breach(scaler)
  router.step()
  assert _wait_spawn_outcome(scaler)
  router.step()
  assert scaler.scale_ups == 1
  thread = scaler._spawn_thread
  router.close()
  thread.join(timeout=30.0)
  assert not thread.is_alive() and scaler._spawn_thread is None


def test_not_ported_no_longer_names_the_fleet():
  """Queue 1 item 7 is done: no fleet feature raises "not ported"."""
  from easyparallellibrary_tpu_torch import _not_ported
  assert not hasattr(_not_ported, "FLEET")


def test_recipe_router_builds_and_adopts_a_replica_off_the_list():
  """A router that built its own in-process replicas can build one more
  without registering it (``build_replica``, what the spawner thread
  runs), then adopt it; ``add_replica`` is the two at once.  An injected
  fleet without a ``replica_factory`` refuses, as in JAX."""
  from easyparallellibrary_tpu_torch.serving import Request, Router
  tepl.init(device="cpu")
  _, _, tmodel, tparams = _models()
  router = Router(tmodel, tparams, num_replicas=1, device="cpu",
                  num_slots=2, prefill_chunk=4)
  assert router.spawn_recipe_available
  rep = router.build_replica()
  assert len(router.replicas) == 1 and rep.index == 1
  assert router.adopt_replica(rep) == 1
  assert router.add_replica() == 2
  assert router.states() == ["healthy"] * 3
  prompt = np.arange(1, 6, dtype=np.int32)
  for uid in range(3):
    assert router.submit(Request(uid=uid, prompt=prompt, max_new_tokens=4))
  out = router.run()
  assert all(np.array_equal(out[u], out[0]) for u in out)
  injected = Router(replicas=[FakeReplica(0)])
  assert not injected.spawn_recipe_available
  with pytest.raises(RuntimeError, match="injected replicas"):
    injected.add_replica()
  factory = Router(replicas=[FakeReplica(0)],
                   replica_factory=lambda i: FakeReplica(i))
  assert factory.add_replica() == 1
  with pytest.raises(RuntimeError, match="recipe levers"):
    factory.build_replica(checkpoint_version=1)


# ------------------------------------------------- the fault-free guard


def _models():
  jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  return jmodel, jparams, tmodel, from_jax_params(tree, device="cpu")


HEAL_CONF = {
    "serving": {
        "resilience": {"enabled": True, "queue_limit": 16},
        "autotune": {"enabled": True, "hold_steps": 2},
        "autoscale": {"enabled": True, "min_replicas": 2,
                      "max_replicas": 4, "scale_up_cooldown_s": 0.0,
                      "scale_down_cooldown_s": 0.5},
    },
    "observability": {"slo": {
        "enabled": True, "ttft_p99_s": 100.0, "itl_p99_s": 100.0,
        "shed_objective": 0.5, "fast_window": 2, "slow_window": 3,
        "fast_burn": 1.0, "slow_burn": 1.0}},
}


def _drive_guard(router, request_cls):
  r = np.random.RandomState(0)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32) for n in (5, 3, 7, 2)]
  max_new = (6, 7, 4, 5)
  out = {}
  for i in range(2):
    assert router.submit(request_cls(uid=i, prompt=prompts[i],
                                     max_new_tokens=max_new[i]))
  for _ in range(2):
    for fin in router.step():
      out[fin.uid] = fin.tokens
  for i in range(2, 4):
    assert router.submit(request_cls(uid=i, prompt=prompts[i],
                                     max_new_tokens=max_new[i]))
  out.update(router.run())
  return out


@pytest.mark.quick
def test_actuators_fault_free_bit_exact_zero_actuations():
  """The fault-free guard: the autotuner, the autoscaler and the SLO
  monitor on with no breach give the same streams as the fleet without
  them (and as the JAX fleet with them), zero actuations, the monitor
  silent, and no kernel library loaded; the per-step records carry the
  actuator's keys."""
  from easyparallellibrary_tpu.observability import slo as jslo
  from easyparallellibrary_tpu.observability.registry import (
      MetricRegistry as JaxRegistry)
  from easyparallellibrary_tpu.serving import Request as JaxRequest
  from easyparallellibrary_tpu.serving import Router as JaxRouter
  from easyparallellibrary_tpu_torch.observability import slo as tslo
  from easyparallellibrary_tpu_torch.observability.registry import (
      MetricRegistry)
  from easyparallellibrary_tpu_torch.serving import Request, Router
  jmodel, jparams, tmodel, tparams = _models()
  tepl.init(device="cpu")
  base_router = Router(tmodel, tparams, num_replicas=2, device="cpu",
                       num_slots=2, prefill_chunk=4,
                       registry=MetricRegistry())
  base = _drive_guard(base_router, Request)
  base_router.close()
  tslo.reset()
  libs = _build.loaded_count()
  config = tepl.Config(HEAL_CONF)
  tepl.init(config, device="cpu")
  router = Router(tmodel, tparams, num_replicas=2, config=config,
                  device="cpu", num_slots=2, prefill_chunk=4,
                  registry=MetricRegistry())
  healed = _drive_guard(router, Request)
  monitor = tslo.get_monitor()
  assert monitor is not None and monitor.breaches == 0
  assert monitor.actuations == 0
  assert router._autoscaler.counters() == {
      "scale_ups": 0.0, "scale_downs": 0.0, "autoscale_holds": 0.0,
      "flap_trips": 0.0, "predictive_fires": 0.0}
  assert len(router.replicas) == 2
  for rep in router.replicas:
    tuner = rep.engine._autotuner
    assert tuner is not None and tuner.actuations == 0 and tuner.level == 0
    assert rep.engine._compile_sentinel.recompiles == 0
  assert _build.loaded_count() == libs
  latest = router.replicas[0].engine.registry.latest()
  assert latest["serving/replica0/autotune_level"] == 0
  assert latest["serving/replica0/autotune_actuations"] == 0
  router.close()
  jconfig = jepl.Config(HEAL_CONF)
  jepl.init(jconfig)
  jrouter = JaxRouter(jmodel, jparams, num_replicas=2, config=jconfig,
                      num_slots=2, prefill_chunk=4, registry=JaxRegistry())
  want = _drive_guard(jrouter, JaxRequest)
  assert jslo.get_monitor().actuations == 0
  jrouter.close()
  assert sorted(base) == sorted(healed) == sorted(want)
  for uid in base:
    np.testing.assert_array_equal(healed[uid], base[uid],
                                  err_msg=f"req {uid}")
    np.testing.assert_array_equal(healed[uid], want[uid],
                                  err_msg=f"req {uid}")
