"""The port's fleet simulator (``sim/``) against the JAX package's.

``XorShift``, ``SimClock``, ``EventQueue``, the arrival processes and
``make_workload`` give the JAX package's values for the same seeds; the
``SimReplica`` and ``FaultInjector`` cases and the simulated fleet's
scale-up and failover episodes give the same books and actuation
sequences.  The cost model refuses sim provenance (as JAX does) and,
unlike JAX, any record not taken on an NVIDIA card.  The golden
chaos-heal episode (``tests/golden/sim_chaos_heal.json``, recorded from
a real JAX fleet) replays in the port's simulator to the identical
sequence and counts, and the port's real in-process fleet (tiny fp32
engines on the CPU) driven through the same episode makes it too.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import easyparallellibrary_tpu as jepl
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.sim import replay as treplay

torch.set_num_threads(1)

PACKAGES = ("easyparallellibrary_tpu", "easyparallellibrary_tpu_torch")


def _mod(pkg, name):
  return importlib.import_module(f"{pkg}.{name}")


def _init(pkg, conf):
  """A fresh monitor and the package's framework on ``conf``."""
  _mod(pkg, "observability.slo").reset()
  config = _mod(pkg, "config").Config(conf)
  if pkg == PACKAGES[0]:
    jepl.init(config)
  else:
    tepl.init(config, device="cpu")
  return config


@pytest.fixture(autouse=True)
def _reset_ambient():
  yield
  for pkg in PACKAGES:
    _mod(pkg, "observability.slo").reset()
    _mod(pkg, "observability.trace").reset()
    _mod(pkg, "utils.vclock").reset()
  tepl.Env.get().reset()


def _both(fn):
  jax_out, port_out = (fn(pkg) for pkg in PACKAGES)
  assert port_out == jax_out
  return port_out


# ------------------------------------------------------------- the core


def test_core_primitives_equal_jax():
  """XorShift streams, SimClock jumps and EventQueue order."""

  def run(pkg):
    eng = _mod(pkg, "sim.engine")
    seqs = []
    for seed in (0, 7, 42, 2 ** 63 + 5):
      rng = eng.XorShift(seed)
      seqs.append([rng.next_u64() for _ in range(50)])
    rng = eng.XorShift(7)
    uniform = [rng.uniform() for _ in range(200)]
    clk = eng.SimClock()
    clk.advance(1.5)
    clk.advance_to(1.0)
    clk.advance_to(3.0)
    times = [clk()]
    with pytest.raises(ValueError):
      clk.advance(-0.1)
    q = eng.EventQueue()
    for t, ev in ((2.0, "late"), (1.0, "early-a"), (1.0, "early-b"),
                  (1.0, "early-c"), (0.5, "first")):
      q.push(t, ev)
    order = [q.peek_time(), q.pop_due(1.0), q.pop_due(5.0), bool(q)]
    return seqs, uniform, times, order

  seqs, uniform, times, order = _both(run)
  assert len(set(seqs[0])) == 50 and all(0.0 <= u < 1.0 for u in uniform)
  assert times == [3.0]
  assert order == [0.5, ["first", "early-a", "early-b", "early-c"],
                   ["late"], False]


def test_arrivals_and_workloads_equal_jax():
  """The arrival processes, Zipf prompts and every workload kind give
  the JAX package's values for the same seeds; unknown kinds raise."""

  def run(pkg):
    arr = _mod(pkg, "sim.arrivals")
    xs = _mod(pkg, "sim.engine").XorShift
    out = [arr.poisson_times(50.0, 2.0, xs(5)),
           arr.diurnal_times(10.0, 80.0, 2.0, 2.0, xs(5)),
           arr.overload_times(100.0, 30, 10, 3.0, xs(1)),
           [p.tolist() for p in arr.zipf_prompts(50, xs(3),
                                                 num_templates=8, plen=6)]]
    for kind in ("poisson", "diurnal", "overload"):
      wl = _mod(pkg, "sim").make_workload(kind, xs(2), duration_s=1.0,
                                          rate_rps=50.0)
      out.append((list(wl.times), [p.tolist() for p in wl.prompts],
                  list(wl.max_new)))
    with pytest.raises(ValueError):
      _mod(pkg, "sim").make_workload("bogus", xs(2), duration_s=1.0,
                                     rate_rps=1.0)
    return out

  out = _both(run)
  assert all(t == sorted(t) and t for t in out[:3])
  assert len({tuple(p) for p in out[3]}) <= 8


# ----------------------------------------------------------- cost model


def _evidence(tmp_path, records):
  path = str(tmp_path / "ev.json")
  with open(path, "w") as f:
    json.dump({"records": records}, f)
  return path


def test_cost_model_refuses_sim_provenance_as_jax(tmp_path):
  """A newer sim-tagged record is never a calibration source; the older
  hardware one (here taken on an NVIDIA card, which the port also
  demands) is."""
  path = _evidence(tmp_path, [
      {"metric": "decode_throughput", "unix_time": 2.0, "provenance": "sim",
       "device_kind": "NVIDIA H100 80GB HBM3",
       "continuous": {"tokens_per_s": 1000.0}},
      {"metric": "decode_throughput", "unix_time": 1.0,
       "provenance": "hardware", "device_kind": "NVIDIA H100 80GB HBM3",
       "continuous": {"tokens_per_s": 500.0}}])
  for pkg in PACKAGES:
    cm = _mod(pkg, "sim.replica").CostModel.calibrate(path)
    assert cm.decode_token_cost_s == pytest.approx(1.0 / 500.0)
    assert cm.source == "decode_throughput@1"
  cm = _mod(PACKAGES[1], "sim.replica").CostModel(1e-3, 2e-3, 1e-4)
  assert cm.step_time(4, 3) == pytest.approx(1e-4 + 4e-3 + 6e-3)


def test_cost_model_takes_only_an_nvidia_card_record(tmp_path):
  """A TPU's, a CPU's or an unnamed device's decode rate is not the
  card's cost: the port falls back to its labelled default (the JAX
  package takes them); an NVIDIA record is taken."""
  from easyparallellibrary_tpu.sim.replica import CostModel as JaxCost
  from easyparallellibrary_tpu_torch.sim.replica import (
      _DEFAULT_TOKEN_COST_S, CostModel)
  others = [{"metric": "decode_throughput", "unix_time": float(i),
             "device_kind": kind, "tokens_per_s": 123.0}
            for i, kind in enumerate(("TPU v5 lite", "cpu", None))]
  path = _evidence(tmp_path, others)
  cm = CostModel.calibrate(path)
  assert cm.source == "default"
  assert cm.decode_token_cost_s == _DEFAULT_TOKEN_COST_S == 1.0 / 260.8
  assert JaxCost.calibrate(path).decode_token_cost_s == pytest.approx(
      1.0 / 123.0)
  card = {"metric": "decode_throughput", "unix_time": 0.5,
          "device_kind": "NVIDIA H100 80GB HBM3", "tokens_per_s": 300.0}
  cm = CostModel.calibrate(_evidence(tmp_path, others + [card]))
  assert cm.decode_token_cost_s == pytest.approx(1.0 / 300.0)
  assert cm.source == "decode_throughput@0"
  # The repo's own evidence holds no card record yet: the default.
  assert CostModel.calibrate().source == "default"


# -------------------------------------------------- replica and faults


SIM_CONF = {"serving": {
    "num_slots": 4, "prefill_chunk": 4,
    "resilience": {"enabled": True, "queue_limit": 6},
    "router": {"heartbeat_s": 0.002}}}


class _CaptureRegistry:

  def __init__(self):
    self.records = []

  def publish(self, step, metrics, namespace="train"):
    self.records.append((step, dict(metrics), namespace))


def test_sim_replica_cases_equal_jax():
  """One request in ceil(6/4) + 7 steps with the engine's record schema
  under the replica's namespace; an idle step publishes nothing; the
  queue limit sheds; same records, costs and books as JAX."""

  def run(pkg):
    config = _init(pkg, SIM_CONF)
    rmod = _mod(pkg, "sim.replica")
    eng = _mod(pkg, "sim.engine")
    Req = _mod(pkg, "serving.scheduler").Request
    cost = rmod.CostModel(1e-3, 1e-3, 1e-4)
    reg = _CaptureRegistry()
    rep = rmod.SimReplica(0, config=config, registry=reg,
                          clock=eng.SimClock(), cost=cost, max_seq_len=64)
    idle_reg = _CaptureRegistry()
    idle = rmod.SimReplica(1, config=config, registry=idle_reg,
                           clock=eng.SimClock(), cost=cost, max_seq_len=64)
    idle.step()
    assert rep.submit(Req(uid="r0", prompt=np.arange(6, dtype=np.int32),
                          max_new_tokens=8))
    steps, fins, costs = 0, [], []
    while rep.has_work:
      fins.extend(f.uid for f in rep.step())
      costs.append(rep.last_step_cost)
      steps += 1
    shedder = rmod.SimReplica(2, config=config, clock=eng.SimClock(),
                              cost=cost, max_seq_len=64)
    admitted = [shedder.submit(Req(uid=i, prompt=np.arange(
        6, dtype=np.int32), max_new_tokens=4)) for i in range(40)]
    return {"steps": steps, "fins": fins, "costs": costs,
            "records": json.loads(json.dumps(reg.records)),
            "idle": (idle_reg.records, idle.last_step_cost),
            "admitted": admitted,
            "shed": shedder.stats.shed_requests,
            "reason": rep.finished["r0"].finish_reason}

  out = _both(run)
  assert out["steps"] == 2 + 7 and out["fins"] == ["r0"]
  assert out["reason"] == "length" and all(c > 0 for c in out["costs"])
  assert {ns for _, _, ns in out["records"]} == {"serving/replica0"}
  for key in ("active_slots", "slot_occupancy", "prefill_tokens",
              "decode_tokens", "step_time_s", "queue_depth",
              "degraded_level", "shed", "finished_requests"):
    assert key in out["records"][0][1], key
  assert out["idle"] == ([], 0.0)
  assert 0 < sum(out["admitted"]) < 40
  assert out["shed"] == 40 - sum(out["admitted"])


def test_fault_injector_kill_revive_stall_equal_jax():

  def run(pkg):
    config = _init(pkg, SIM_CONF)
    rmod = _mod(pkg, "sim.replica")
    fmod = _mod(pkg, "sim.faults")
    Req = _mod(pkg, "serving.scheduler").Request
    rep = rmod.SimReplica(0, config=config,
                          clock=_mod(pkg, "sim.engine").SimClock(),
                          cost=rmod.CostModel(1e-3, 1e-3, 1e-4),
                          max_seq_len=64)
    inj = fmod.FaultInjector(fmod.death_and_recovery(1.0, 0, 2.0) + [
        fmod.FaultEvent(at=4.0, kind="stall", replica=0, value=0.25)])
    seen = [inj.next_time()]
    inj.fire_due(0.5, [rep])
    rep.step()
    inj.fire_due(1.0, [rep])
    with pytest.raises(rmod.SimReplicaDead):
      rep.step()
    inj.fire_due(3.0, [rep])
    rep.step()
    inj.fire_due(4.0, [rep])
    rep.submit(Req(uid="s", prompt=np.arange(6, dtype=np.int32),
                   max_new_tokens=2))
    rep.step()
    seen += [rep.last_step_cost, inj.pending, len(inj.fired)]
    with pytest.raises(ValueError):
      fmod.FaultInjector([fmod.FaultEvent(at=0.0, kind="meteor",
                                          replica=0)])
    return seen

  seen = _both(run)
  assert seen[0] == 1.0 and seen[1] > 0.25 and seen[2] == 0


# --------------------------------------------------------- fleet episodes


def _episode(pkg, conf, replicas, kind, seed, duration, rate, faults=None):
  config = _init(pkg, conf)
  sim = _mod(pkg, "sim")
  fleet = sim.SimFleet(num_replicas=replicas, config=config, num_slots=4,
                       prefill_chunk=4, max_seq_len=64,
                       cost=sim.CostModel(1e-3, 1e-3, 1e-4))
  wl = sim.make_workload(kind, sim.XorShift(seed), duration_s=duration,
                         rate_rps=rate, plen=6, max_new=8)
  injector = None if faults is None else sim.FaultInjector(
      sim.death_and_recovery(*faults))
  summary = fleet.run(wl, faults=injector)
  summary.pop("wall_s")
  summary["sequence"] = sim.actuation_sequence()
  summary["vclock_left"] = _mod(pkg, "utils.vclock").installed()
  return summary


HEAL_CONF = {
    "serving": {
        "num_slots": 4, "prefill_chunk": 4,
        "resilience": {"enabled": True, "queue_limit": 6},
        "router": {"heartbeat_s": 0.002},
        "autotune": {"enabled": True, "hold_steps": 20},
        "autoscale": {"enabled": True, "min_replicas": 2,
                      "max_replicas": 4, "scale_up_cooldown_s": 0.05,
                      "scale_down_cooldown_s": 0.3, "flap_window_s": 1.0,
                      "sync_spawn": True}},
    "observability": {"slo": {
        "enabled": True, "shed_objective": 0.9, "fast_window": 3,
        "slow_window": 6, "fast_burn": 1.0, "slow_burn": 1.0}},
}


def test_sim_fleet_overload_scales_up_and_back_as_jax():
  out = _both(lambda pkg: _episode(pkg, HEAL_CONF, 2, "overload", 9, 1.0,
                                   300.0))
  assert out["served"] + out["shed"] == out["requests"]
  assert out["scale_ups"] >= 1 and out["replicas_peak"] > 2
  assert out["replicas_final_live"] == 2 and out["slo_breaches"] >= 1
  assert "autoscale" in {e["actuator"] for e in out["sequence"]}
  assert not out["vclock_left"] and out["sim_duration_s"] > 0


def test_sim_fleet_replica_death_heals_via_failover_as_jax():
  conf = {"serving": {"num_slots": 4, "prefill_chunk": 4,
                      "resilience": {"enabled": True, "queue_limit": 8},
                      "router": {"heartbeat_s": 0.002}},
          "observability": {"slo": {
              "enabled": True, "shed_objective": 0.9,
              "replicas_down": True, "fast_window": 3, "slow_window": 6,
              "fast_burn": 1.0, "slow_burn": 1.0}}}
  out = _both(lambda pkg: _episode(pkg, conf, 3, "poisson", 4, 2.0, 100.0,
                                   faults=(0.2, 0, 50.0)))
  assert out["faults_fired"] == 2 and out["served"] > 0
  assert out["replicas_final_live"] >= 2


# ------------------------------------------------------------ golden replay


@pytest.mark.quick
def test_port_replays_golden_chaos_heal_episode():
  """The slice's parity pin: the port's simulator replays the recorded
  real-fleet episode to the identical actuation sequence and the same
  shed, busy-sweep, breach, recovery and peak-replica counts."""
  golden = treplay.load_golden()
  out = treplay.replay(golden)
  assert out["sequence"] == golden["sequence"]
  assert out["shed"] == golden["counters"]["shed"]
  assert out["busy_sweeps"] == golden["counters"]["busy_sweeps"]
  assert out["breaches"] == golden["counters"]["breaches"]
  assert out["recoveries"] == golden["counters"]["recoveries"]
  assert out["replicas_peak"] == golden["counters"]["replicas_peak"]


def test_port_replay_is_deterministic_and_blind_to_the_reactor_knob():
  """A second replay, and one with ``serving.router.reactor`` on (the
  simulator drives the sweep), give the same episode."""
  golden = treplay.load_golden()
  base = treplay.replay(golden)
  again = treplay.replay(golden)
  serving = dict(golden["config"]["serving"])
  serving["router"] = {**serving.get("router", {}), "reactor": True}
  reactored = treplay.replay(dict(golden, config=dict(golden["config"],
                                                      serving=serving)))
  for out in (again, reactored):
    for key in ("sequence", "shed", "busy_sweeps", "breaches",
                "recoveries", "replicas_peak"):
      assert out[key] == base[key], key
  assert base["sequence"] == golden["sequence"]


def test_port_real_fleet_drives_the_golden_episode():
  """The port's real fleet (two in-process tiny fp32 contiguous engines,
  the autotuner and the autoscaler on, ``sync_spawn``) driven through
  the recorded episode by ``sim.fleet.drive_episode`` makes the golden
  file's actuation sequence and counts: the engine's step order, the
  scheduler, the SLO monitor and the policies decide as the JAX fleet
  did."""
  from easyparallellibrary_tpu_torch.models import gpt as tgpt
  from easyparallellibrary_tpu_torch.observability import slo as tslo
  from easyparallellibrary_tpu_torch.observability.registry import (
      MetricRegistry)
  from easyparallellibrary_tpu_torch.serving import Router
  from easyparallellibrary_tpu_torch.sim.arrivals import Workload
  from easyparallellibrary_tpu_torch.sim.engine import SimClock
  from easyparallellibrary_tpu_torch.sim.fleet import (
      actuation_sequence, drive_episode, warm_fleet)
  from easyparallellibrary_tpu_torch.weights import init_params
  golden = treplay.load_golden()
  config = _init(PACKAGES[1], golden["config"])
  cfg = tgpt.GPTConfig(vocab_size=256, num_layers=2, num_heads=8,
                       d_model=128, d_ff=512,
                       max_seq_len=golden["max_seq_len"],
                       dtype=torch.float32)
  model = tgpt.GPT(cfg)
  params = init_params(cfg, seed=0, device="cpu")
  prompt = np.asarray(golden["prompt"], np.int32)
  clock = SimClock()
  router = Router(model, params, num_replicas=golden["num_replicas"],
                  config=config, registry=MetricRegistry(), clock=clock,
                  device="cpu", num_slots=golden["num_slots"],
                  prefill_chunk=golden["chunk"])
  warm_fleet(router, clock, prompt, golden["warm_max_new"])
  n = len(golden["arrivals"])
  loop = drive_episode(
      router, clock, Workload(times=list(golden["arrivals"]),
                              prompts=[prompt] * n,
                              max_new=[golden["max_new"]] * n),
      fixed_dt=golden["fixed_dt"], idle_dt=golden["idle_dt"],
      settle_steps=golden["settle_steps"])
  monitor = tslo.get_monitor()
  shed = sum(router.finished[u].finish_reason == "shed" for u in range(n))
  assert actuation_sequence() == golden["sequence"]
  assert {"shed": shed, "busy_sweeps": loop["busy_sweeps"],
          "idle_jumps": loop["idle_jumps"],
          "replicas_peak": loop["replicas_peak"],
          "breaches": monitor.breaches, "recoveries": monitor.recoveries,
          "actuations": monitor.actuations} == {
              k: golden["counters"][k] for k in (
                  "shed", "busy_sweeps", "idle_jumps", "replicas_peak",
                  "breaches", "recoveries", "actuations")}
  router.close()
