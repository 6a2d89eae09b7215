"""The port's router over in-process replicas against the JAX package's
(``serving/router.py``, ``replica.py``, ``transport.InprocTransport``
and the fleet injectors of ``testing/chaos.py``).

fp32 on weights bridged with ``weights.from_jax_params``: an N=1 router
equals the bare engine and the JAX N=1 router, with the kernel-library
count unchanged; a replica killed mid-decode loses nothing and every
greedy stream equals the JAX router's fault-free one, with the router's
counters equal to the JAX router's on the same episode; drain, rejoin,
total outage, a hang, a flapping replica; dispatch decisions against the
JAX router's on duck-typed replicas; and a failed-over request traced as
one flow across both replicas' tracks.
"""

import json

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
from easyparallellibrary_tpu.serving import Request as JaxRequest
from easyparallellibrary_tpu.serving import Router as JaxRouter
from easyparallellibrary_tpu.serving.scheduler import (
    FinishedRequest as JaxFinished)
from easyparallellibrary_tpu.testing import chaos as jchaos
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.observability import report as treport
from easyparallellibrary_tpu_torch.observability import slo as tslo
from easyparallellibrary_tpu_torch.observability import trace as ttrace
from easyparallellibrary_tpu_torch.observability.registry import (
    MetricRegistry)
from easyparallellibrary_tpu_torch.serving import (
    ContinuousBatchingEngine, Request, Router)
from easyparallellibrary_tpu_torch.serving.scheduler import FinishedRequest
from easyparallellibrary_tpu_torch.testing import chaos
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
GEOMETRY = dict(num_slots=2, prefill_chunk=4, paged=True, block_size=4)
MAX_NEW = 6


@pytest.fixture(autouse=True)
def _envs():
  jepl.init()
  tepl.init(device="cpu")
  yield
  ttrace.reset()
  tslo.reset()
  tepl.Env.get().reset()


def _models(seed=0):
  jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  return jmodel, jparams, tmodel, from_jax_params(tree, device="cpu")


def _prompts(lengths, seed=0):
  r = np.random.RandomState(seed)
  return [r.randint(0, 64, (n,)).astype(np.int32) for n in lengths]


def _oracle(jmodel, jparams, prompt, max_new=MAX_NEW):
  return np.asarray(jax_generate(jmodel, jparams, jnp.asarray(prompt)[None],
                                 max_new))[0]


def _staggered(router_or_engine, request_cls, prompts):
  """Half the requests, two steps, the rest, then until drained."""
  half = len(prompts) // 2
  out = {}
  for i in range(half):
    router_or_engine.submit(request_cls(uid=i, prompt=prompts[i],
                                        max_new_tokens=MAX_NEW))
  for _ in range(2):
    for fin in router_or_engine.step():
      out[fin.uid] = fin.tokens
  for i in range(half, len(prompts)):
    router_or_engine.submit(request_cls(uid=i, prompt=prompts[i],
                                        max_new_tokens=MAX_NEW))
  out.update(router_or_engine.run())
  return out


class FakeClock:

  def __init__(self, t: float = 0.0):
    self.t = t

  def __call__(self) -> float:
    return self.t

  def advance(self, dt: float):
    self.t += dt


# ------------------------------------------------------ quick acceptance


@pytest.mark.quick
def test_single_replica_router_equals_bare_engine_and_jax_router():
  """N=1 fault-free: the router's streams equal the bare port engine's,
  the JAX N=1 router's and JAX ``generate``; the kernel-library count
  (the compile sentinel's) does not move, and nothing fails over."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3, 9, 2, 6, 4), seed=1)
  bare = _staggered(ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                             **GEOMETRY), Request, prompts)
  libs = _build.loaded_count()
  router = Router(tmodel, tparams, num_replicas=1, device="cpu", **GEOMETRY)
  got = _staggered(router, Request, prompts)
  assert _build.loaded_count() == libs == router.replicas[0].compile_count
  want = _staggered(JaxRouter(jmodel, jparams, num_replicas=1, **GEOMETRY),
                    JaxRequest, prompts)
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(got[i], bare[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(got[i], _oracle(jmodel, jparams, p))
    assert router.finished[i].finish_reason == "length"
  assert router.failovers == 0 and router.placement == {}
  assert router.router_counters()["replicas_healthy"] == 1.0


# ---------------------------------------------------------- failover


def _kill_episode(router, killer_cls, prompts):
  killer = killer_cls(router.replicas[0].engine, kill_calls=(3,))
  for i, p in enumerate(prompts):
    assert router.submit(type_of_request(router)(
        uid=i, prompt=p, max_new_tokens=MAX_NEW))
  placed = dict(router.placement)
  out = router.run()
  return killer, placed, out


def type_of_request(router):
  return JaxRequest if isinstance(router, JaxRouter) else Request


def test_replica_kill_mid_decode_loses_nothing_and_counts_like_jax():
  """One of two replicas dies mid-decode (``ReplicaKiller`` on its third
  step call): one failover, every request resolved exactly once with
  reason ``"length"``, streams equal to the JAX router's fault-free run;
  the router counters and the dispatch equal the JAX router's on the
  same kill; the survivor's library count is unchanged."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3, 9, 2), seed=8)
  fault_free = JaxRouter(jmodel, jparams, num_replicas=2, **GEOMETRY)
  for i, p in enumerate(prompts):
    fault_free.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW))
  want = fault_free.run()
  libs = _build.loaded_count()
  router = Router(tmodel, tparams, num_replicas=2, device="cpu", **GEOMETRY)
  killer, placed, got = _kill_episode(router, chaos.ReplicaKiller, prompts)
  jrouter = JaxRouter(jmodel, jparams, num_replicas=2, **GEOMETRY)
  jkiller, jplaced, _ = _kill_episode(jrouter, jchaos.ReplicaKiller,
                                      prompts)
  assert killer.kills == jkiller.kills == 1
  assert placed == jplaced and set(placed.values()) == {0, 1}
  assert router.failovers == 1 and router.migrated_requests >= 1
  assert sorted(router.finished) == list(range(len(prompts)))
  assert sorted(got) == list(range(len(prompts)))
  for i in range(len(prompts)):
    assert router.finished[i].finish_reason == "length"
    np.testing.assert_array_equal(got[i], np.asarray(want[i]),
                                  err_msg=f"req {i}")
  assert router.states() == jrouter.states() == ["down", "healthy"]
  keys = ("failovers", "migrated_requests", "router_shed", "probes",
          "parked", "replicas_healthy", "replicas_down")
  assert {k: router.router_counters()[k] for k in keys} == \
      {k: jrouter.router_counters()[k] for k in keys}
  assert router.replicas[1].compile_count == libs
  # The corpse rejoins warm (forced past the breaker) and serves again.
  assert router.rejoin(0, force=True)
  assert router.submit(Request(uid="post", prompt=prompts[0],
                               max_new_tokens=MAX_NEW))
  np.testing.assert_array_equal(router.run()["post"], got[0])


def test_drain_migrates_then_rejoin_resumes_warm():
  """``drain(0, timeout_s=0)`` mid-decode migrates replica 0's requests
  at the next sweep; it stays ``draining`` and unroutable until
  ``rejoin(0)``, then serves warm; every stream equals JAX
  ``generate``."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 7, 3, 6), seed=9)
  fresh = _prompts((4,), seed=10)[0]
  clock = FakeClock()
  router = Router(tmodel, tparams, num_replicas=2, device="cpu",
                  clock=clock, **GEOMETRY)
  for i, p in enumerate(prompts):
    router.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
  for _ in range(3):
    router.step()
  on_zero = [u for u, r in router.placement.items() if r == 0]
  assert on_zero
  router.drain(0, timeout_s=0.0)
  assert router.state(0) == "draining"
  router.step()
  assert router.migrated_requests == len(on_zero)
  assert all(router.placement.get(u, 1) == 1 for u in on_zero)
  assert not router.replicas[0].has_work
  router.submit(Request(uid="during", prompt=prompts[0],
                        max_new_tokens=MAX_NEW))
  assert router.placement["during"] == 1          # not to the drained one
  router.run()
  assert router.state(0) == "draining"
  assert router.rejoin(0) and router.state(0) == "healthy"
  router.submit(Request(uid="after", prompt=fresh,
                        max_new_tokens=MAX_NEW))
  assert router.placement["after"] == 0           # least loaded, warm
  router.run()
  for uid, p in [(i, p) for i, p in enumerate(prompts)] + [
      ("during", prompts[0]), ("after", fresh)]:
    np.testing.assert_array_equal(router.finished[uid].tokens,
                                  _oracle(jmodel, jparams, p),
                                  err_msg=str(uid))


def test_total_outage_parks_until_rejoin():
  """Killing the only replica parks its requests (nothing resolved, the
  ``parked`` counter up); a forced rejoin flushes them and they finish
  exactly."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3), seed=13)
  router = Router(tmodel, tparams, num_replicas=1, device="cpu", **GEOMETRY)
  chaos.ReplicaKiller(router.replicas[0].engine, kill_calls=(2,))
  for i, p in enumerate(prompts):
    router.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
  assert router.run() == {} and router.states() == ["down"]
  assert router.router_counters()["parked"] == 2.0 and not router.finished
  assert router.rejoin(0, force=True)
  out = router.run()
  assert router.router_counters()["parked"] == 0.0
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(out[i], _oracle(jmodel, jparams, p))


def test_replica_hang_is_a_latency_fault_only():
  """``ReplicaHang`` stalls one step call past the watchdog: the replica's
  timeout count rides its beat and it is marked suspect, nothing
  migrates, and the streams equal JAX ``generate``."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3), seed=11)
  config = tepl.Config({"serving": {"resilience": {
      "enabled": True, "step_timeout_s": 0.05}}})
  router = Router(tmodel, tparams, num_replicas=2, device="cpu",
                  config=config, **GEOMETRY)
  try:
    inj = chaos.ReplicaHang(router.replicas[0].engine, hang_calls=(1,),
                            hang_s=0.4)
    transitions = []
    router.health[0].on_transition = \
        lambda old, new, reason: transitions.append((old, new))
    for i, p in enumerate(prompts):
      router.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
    out = router.run()
  finally:
    router.close()
  assert inj.hangs == 1
  assert router.replicas[0].watchdog_timeouts >= 1
  assert ("healthy", "suspect") in transitions
  assert router.failovers == 0 and router.migrated_requests == 0
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(out[i], _oracle(jmodel, jparams, p))


def test_flapping_replica_doubles_the_breaker_hold_out():
  """``FlappingHealth`` fails every second step call of replica 0: each
  trip doubles the hold-out before the next probe (on a fake clock), and
  every request still finishes exactly."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3, 4, 6), seed=12)
  clock = FakeClock()
  router = Router(tmodel, tparams, num_replicas=2, device="cpu",
                  clock=clock, **GEOMETRY)
  flap = chaos.FlappingHealth(router.replicas[0].engine, fail_every=2)
  h = router.health[0]
  cooldowns, next_uid = [], 0
  for _ in range(400):
    if (h.state == "healthy" and next_uid < len(prompts)
        and not router.replicas[0].has_work):
      router.replicas[0].submit(Request(uid=next_uid,
                                        prompt=prompts[next_uid],
                                        max_new_tokens=MAX_NEW))
      next_uid += 1
    if h.state == "down":
      if not cooldowns or cooldowns[-1] != h.cooldown_s():
        cooldowns.append(h.cooldown_s())
      clock.advance(h.cooldown_s() + 1.0)
    router.step()
    if next_uid >= len(prompts) and not router.has_work:
      break
  assert not router.has_work and flap.faults >= 2 and h.trips >= 2
  assert len(cooldowns) >= 2 and cooldowns[1] == 2 * cooldowns[0]
  assert router.probes >= 1
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(router.finished[i].tokens,
                                  _oracle(jmodel, jparams, p))


# ----------------------------------------------- dispatch, against JAX


class _Fake:
  """Duck-typed replica for routing-policy tests (no engine)."""

  def __init__(self, finished_cls, load=0, num_slots=4):
    self._cls = finished_cls
    self._load = load
    self.num_slots = num_slots
    self.submitted, self.restored, self.finished = [], [], {}
    self.snaps, self.stats, self.accept = [], None, True
    self.watchdog_timeouts = self.bad_steps = 0
    self.itl_ewma_s = 0.0
    self.has_work = False

  def submit(self, req):
    if not self.accept:
      self.finished[req.uid] = self._cls(
          uid=req.uid, tokens=np.asarray(req.prompt, np.int32),
          new_tokens=0, finish_reason="shed")
      return False
    self.submitted.append(req.uid)
    self._load += 1
    return True

  def cancel(self, uid):
    return False

  def step(self):
    return []

  @property
  def load(self):
    return self._load

  queue_depth = 0

  @property
  def num_active(self):
    return self._load

  def evacuate(self):
    snaps, self.snaps = self.snaps, []
    self.has_work = False
    return snaps

  def restore_request(self, snap, front=False):
    self.restored.append(snap["request"]["uid"])
    return snap["request"]["uid"]

  def close(self):
    pass


def _fake_pair(loads, **router_conf):
  out = []
  for router_cls, fin_cls, epl_mod in ((Router, FinishedRequest, tepl),
                                       (JaxRouter, JaxFinished, jepl)):
    reps = [_Fake(fin_cls, load=l) for l in loads]
    clock = FakeClock()
    cfg = epl_mod.Config({"serving": {"router": router_conf}})
    out.append((router_cls(replicas=reps, config=cfg, clock=clock), reps,
                clock))
  return out


def test_dispatch_decisions_equal_jax():
  """Least loaded, prefix affinity within spare capacity, a saturated
  affinity target falling back, round robin on stale signals, version
  weights, the router shed and a replica's own shed mirrored: the same
  decisions as the JAX router's over the same duck-typed replicas."""
  p1, p2 = _prompts((6, 6), seed=5)
  decisions = []
  for router, reps, clock in _fake_pair([2, 0], heartbeat_s=1.0,
                                        suspect_after=60.0,
                                        down_after=120.0):
    cls = type_of_request(router)
    d = []
    d.append(router.submit(cls(uid="a", prompt=p1, max_new_tokens=2)))
    d.append([r.submitted for r in reps])
    reps[0]._load = 0
    d.append(router._choose(np.asarray(p1, np.int32)))
    d.append(router._choose(np.asarray(p2, np.int32)))
    reps[1]._load = reps[1].num_slots
    d.append(router._choose(np.asarray(p1, np.int32)))
    router.set_version_weights({0: 1.0})
    d.append(router._choose(np.asarray(p2, np.int32)))
    router.set_version_weights(None)
    for r in reps:
      r.has_work = True
    clock.advance(5.0)
    d.append(sorted({router._choose(np.asarray([1, 2], np.int32))
                     for _ in range(4)}))
    for r in reps:
      r.has_work = False
    reps[1].accept = False
    router.health[0].mark_down("chaos")
    d.append(router.submit(cls(uid="y", prompt=p2, max_new_tokens=2)))
    router.health[1].drain()
    d.append(router.submit(cls(uid="x", prompt=p2, max_new_tokens=2)))
    d.append({u: f.finish_reason for u, f in router.finished.items()})
    d.append(router.router_shed)
    decisions.append(d)
  assert decisions[0] == decisions[1]
  assert decisions[0][1] == [[], ["a"]]
  assert decisions[0][2] == (1, "affinity")
  assert decisions[0][-2] == {"y": "shed", "x": "shed"}


def test_parked_cancel_and_passive_reap_equal_jax():
  """A parked request is cancellable (resolved ``"cancelled"`` with its
  committed tokens), and a replica holding work whose beats aged past
  ``down_after`` is failed over at the next dispatch: as in JAX."""
  results = []
  for router, reps, clock in _fake_pair([1, 0]):
    cls = type_of_request(router)
    router._parked.append({"request": {"uid": "p1", "prompt": [1, 2, 3]},
                           "generated": [7], "requeues": 0,
                           "first_token_emitted": True,
                           "submitted_at": 0.0})
    r = [router.cancel("p1"), router.cancel("ghost")]
    fin = router.finished["p1"]
    r.append((fin.finish_reason, fin.new_tokens, list(fin.tokens)))
    reps[0].has_work = True
    reps[0].snaps = [{"request": {"uid": "stranded", "prompt": [1, 2]},
                      "generated": [], "requeues": 0,
                      "first_token_emitted": False, "submitted_at": 0.0}]
    clock.advance(1000.0)
    r.append(router.submit(cls(uid="new", prompt=np.arange(4),
                               max_new_tokens=2)))
    r.append((router.states(), router.failovers, reps[1].restored,
              dict(router.placement)))
    results.append(r)
  assert results[0] == results[1]
  assert results[0][2] == ("cancelled", 1, [1, 2, 3, 7])


def test_fleet_knobs_outside_the_slice_raise():
  """The autoscaler, blue/green rollout and the reactor have been ported
  since: enabling each builds its controller (or driver); a process
  fleet without a factory and an empty fleet still raise."""
  _, _, tmodel, tparams = _models()
  for conf, attr in (({"serving": {"autoscale": {"enabled": True}}},
                      "_autoscaler"),
                     ({"serving": {"rollout": {"enabled": True}}},
                      "rollout"),
                     ({"serving": {"router": {"reactor": True}}},
                      "_reactor_enabled")):
    router = Router(tmodel, tparams, num_replicas=1, device="cpu",
                    config=tepl.Config(conf), **GEOMETRY)
    assert getattr(router, attr)
    router.close()
  with pytest.raises(ValueError, match="factory"):
    Router(num_replicas=1, device="cpu",
           config=tepl.Config({"serving": {"router": {
               "transport": "process"}}}))
  with pytest.raises(ValueError, match="num_replicas"):
    Router(tmodel, tparams, num_replicas=0, device="cpu")


# ------------------------------------------------------- observability


def _track_names(events):
  return {e["tid"]: e["args"]["name"] for e in events
          if e.get("ph") == "M" and e.get("name") == "thread_name"}


def test_failed_over_request_is_one_flow_across_replica_tracks(tmp_path):
  """Observability on, one of two replicas killed: the export validates
  (flows included), every flow runs ``s ... f``, and each migrated
  request's flow touches both replicas' slot tracks; the fleet rollup
  lands in the registry beside each replica's records, with a
  ``replica_down`` breach in the SLO log."""
  jmodel, jparams, tmodel, tparams = _models()
  events_path = str(tmp_path / "slo_events.jsonl")
  cfg = tepl.Config({"observability": {
      "enabled": True,
      "slo": {"enabled": True, "events_path": events_path,
              "capture_min_interval_s": 0.0,
              "capture_dir": str(tmp_path / "diag")}}})
  tepl.init(cfg, device="cpu")
  tracer = ttrace.ensure_configured(cfg)
  records = []

  class Sink:
    def write(self, step, record):
      records.append(record)

  registry = MetricRegistry(Sink())
  prompts = _prompts((5, 3, 9, 2), seed=8)
  router = Router(tmodel, tparams, num_replicas=2, device="cpu",
                  registry=registry, config=cfg, **GEOMETRY)
  chaos.ReplicaKiller(router.replicas[0].engine, kill_calls=(3,))
  for i, p in enumerate(prompts):
    router.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
  out = router.run()
  assert router.failovers == 1
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(out[i], _oracle(jmodel, jparams, p))
  path = str(tmp_path / "trace.json")
  assert tracer.export(path)
  events = ttrace.validate_trace(path)
  tracks = _track_names(events)
  flows = {}
  for ev in events:
    if ev.get("ph") in ("s", "t", "f"):
      flows.setdefault(ev["id"], []).append(ev)
  assert flows
  for fid, evs in flows.items():
    assert evs[0]["ph"] == "s" and evs[-1]["ph"] == "f", fid
  spans, _ = treport.pair_spans(events)
  migrated = {s["args"]["uid"] for s in spans
              if s["args"].get("finish_reason") == "migrated"}
  assert migrated
  uid_flow = {ev["args"]["uid"]: ev["id"] for ev in events
              if ev.get("ph") == "s" and "uid" in ev.get("args", {})}
  for uid in migrated:
    names = {tracks.get(e["tid"], "") for e in flows[uid_flow[uid]]}
    assert any(n.startswith("serving/replica0/slot") for n in names), names
    assert any(n.startswith("serving/replica1/slot") for n in names), names
  keys = set().union(*(r.keys() for r in records))
  assert any(k.startswith("serving/fleet/") for k in keys)
  assert any(k.startswith("serving/replica1/") for k in keys)
  router.publish(registry, router.steps)
  assert records[-1]["serving/fleet/failovers"] == 1.0
  breaches = [json.loads(line) for line in open(events_path)]
  assert any(e["event"] == "breach" and e["rule"] == "replica_down"
             for e in breaches)
