"""The port's SLO monitor, compile sentinel, diagnostic capture and device
gauges against the JAX package's classes, on the same inputs.

Threshold streaks and recovery, suffix matching, burn-rate windows,
rules from config, listener isolation, capture rate limit and
retention, and the sentinel's watermark run through both packages'
classes and must agree breach for breach; a random record sequence
through monitors built from the same config gives the same events.  The
device introspector: the CPU fallback of the HBM gauges to the cost
card's bound, ``publish_hbm``'s namespace and ``ensure_configured``'s
contract.  The serving engine publishes its percentile rollup mid-run.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import easyparallellibrary_tpu as jepl
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu.observability import device as jdevice
from easyparallellibrary_tpu.observability import slo as jslo
from easyparallellibrary_tpu.observability import trace as jtrace
from easyparallellibrary_tpu_torch.observability import device as tdevice
from easyparallellibrary_tpu_torch.observability import registry as tregistry
from easyparallellibrary_tpu_torch.observability import slo as tslo
from easyparallellibrary_tpu_torch.observability import trace as ttrace
from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
from easyparallellibrary_tpu_torch.serving import (
    ContinuousBatchingEngine, Request)
from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
from easyparallellibrary_tpu_torch.utils import vclock
from easyparallellibrary_tpu_torch.utils.logging import get_logger

torch.set_num_threads(1)

IMPLS = {"jax": jslo, "port": tslo}


@pytest.fixture(autouse=True)
def _clean_ambient_state():
  for mod in (jtrace, jslo, jdevice, ttrace, tslo, tdevice, vclock):
    mod.reset()
  yield
  for mod in (jtrace, jslo, jdevice, ttrace, tslo, tdevice, vclock):
    mod.reset()
  tepl.Env.get().reset()
  jepl.Env.get().reset()


def _events(monitor):
  """A monitor's events without the wall-clock stamp."""
  return [{k: v for k, v in e.items() if k != "time"}
          for e in monitor.events]


class FakeClock:

  def __init__(self, t=0.0):
    self.t = t

  def __call__(self):
    return self.t


# ------------------------------------------------------------ rule units


def test_threshold_rule_streak_and_recovery_match_jax():
  got = {}
  for impl, mod in IMPLS.items():
    m = mod.SLOMonitor([mod.SLORule("ttft", "ttft_p99_s", "<=", 0.5,
                                    for_records=2)])
    for step, v in enumerate((0.9, 0.9, 0.9, 0.1, 0.9, 0.9)):
      m.observe(step, {"serving/ttft_p99_s": v})
    got[impl] = (m.breaches, m.recoveries, _events(m), m.status())
  assert got["port"] == got["jax"]
  assert got["port"][:2] == (2, 1)
  with pytest.raises(ValueError, match="op"):
    tslo.SLORule("x", "y", "==", 1.0)
  with pytest.raises(ValueError, match="for_records"):
    tslo.SLORule("x", "y", for_records=0)


def test_rule_suffix_matching_tracks_separate_streams():
  for mod in IMPLS.values():
    m = mod.SLOMonitor([mod.SLORule("itl", "itl_p99_s", "<=", 0.1)])
    m.observe(1, {"serving/fleet/itl_p99_s": 0.5,
                  "serving/replica0/itl_p99_s": 0.05,
                  "serving/itl_p50_s": 9.0})
    assert m.breaches == 1
    assert m.status() == {"itl@serving/fleet/itl_p99_s": "breach",
                          "itl@serving/replica0/itl_p99_s": "ok"}
    assert m.breached_streams("serving/fleet") == [
        ("itl", "serving/fleet/itl_p99_s")]


def test_burn_rate_fast_and_slow_windows_match_jax():
  got = {}
  for impl, mod in IMPLS.items():
    rule = mod.BurnRateRule("shed", bad="shed", good="finished_requests",
                            objective=0.9, fast_window=2, slow_window=6,
                            fast_burn=3.0, slow_burn=2.0)
    m = mod.SLOMonitor([rule])
    shed = fin = 0.0
    trace = []
    for step in range(7):           # healthy: 2% shed against 10%
      shed, fin = shed + 1, fin + 49
      m.observe(step, {"serving/fleet/shed": shed,
                       "serving/fleet/finished_requests": fin})
    trace.append(m.breaches)
    m.observe(7, {"serving/fleet/shed": shed + 30,   # a spike: no page
                  "serving/fleet/finished_requests": fin + 20})
    trace.append(m.breaches)
    for step in range(8, 14):       # sustained: both windows burn
      shed, fin = shed + 30, fin + 20
      m.observe(step, {"serving/fleet/shed": shed,
                       "serving/fleet/finished_requests": fin})
    trace.append(m.breaches)
    for step in range(14, 18):      # clean again: recovery
      fin += 50
      m.observe(step, {"serving/fleet/shed": shed,
                       "serving/fleet/finished_requests": fin})
    got[impl] = (trace, m.recoveries, _events(m))
  assert got["port"] == got["jax"]
  assert got["port"][0] == [0, 0, 1] and got["port"][1] == 1


def test_rules_from_config_match_jax():
  for knobs in ({"enabled": True, "ttft_p99_s": 0.5, "itl_p99_s": 0.05,
                 "shed_objective": 0.95, "hbm_frac": 0.9},
                {"enabled": True, "replicas_down": False}):
    conf = {"observability": {"slo": knobs}}
    want = jslo.rules_from_config(jepl.Config(conf).observability.slo)
    got = tslo.rules_from_config(tepl.Config(conf).observability.slo)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert [type(r).__name__ for r in got] == [
        type(r).__name__ for r in want]
  with pytest.raises(ValueError, match="shed_objective"):
    tepl.Config({"observability.slo.shed_objective": 1.0})


def test_same_record_sequence_gives_same_breaches_as_jax(tmp_path):
  """Monitors built from the same ``observability.slo.*`` config by each
  package's ``ensure_configured`` see the same 200 random records (fleet,
  replica and bare-engine keys, counters and percentiles) and write the
  same events to their ``slo_events.jsonl``."""
  r = np.random.RandomState(0)
  records = []
  shed = fin = 0.0
  for step in range(200):
    shed += float(r.poisson(3 if 80 <= step < 120 else 0.2))
    fin += float(r.poisson(10))
    prefix = ("serving/fleet", "serving/replica1", "serving")[step % 3]
    records.append((step, {
        f"{prefix}/ttft_p99_s": float(r.gamma(2.0, 0.2)),
        f"{prefix}/itl_p99_s": float(r.gamma(2.0, 0.01)),
        f"{prefix}/shed": shed, f"{prefix}/finished_requests": fin,
        "serving/fleet/replicas_down": float(step in range(150, 155)),
        "observability/device/hbm_frac": float(r.uniform(0.5, 1.0))}))
  knobs = {"enabled": True, "ttft_p99_s": 0.8, "itl_p99_s": 0.05,
           "shed_objective": 0.9, "fast_window": 3, "slow_window": 9,
           "fast_burn": 2.0, "slow_burn": 1.5, "hbm_frac": 0.95}
  lines = {}
  for impl, (mod, epl_mod) in {"jax": (jslo, jepl),
                               "port": (tslo, tepl)}.items():
    path = str(tmp_path / f"{impl}.jsonl")
    epl_mod.Env.get().reset(epl_mod.Config({"observability": {
        "slo": dict(knobs, events_path=path)}}))
    m = mod.ensure_configured()
    for step, rec in records:
      m.observe(step, rec)
    m.close()
    lines[impl] = [{k: v for k, v in json.loads(x).items() if k != "time"}
                   for x in open(path)]
  assert lines["port"] == lines["jax"]
  assert {e["rule"] for e in lines["port"]} >= {
      "ttft_p99", "itl_p99", "shed_burn", "replica_down", "hbm_high"}


def test_monitor_skips_tensors_and_idle_burn_windows():
  """A tensor passing through the registry raw (on the card it would
  cost a sync to read) is never evaluated, a 0-d one included; a burn
  rule with no traffic renders no verdict."""
  m = tslo.SLOMonitor([tslo.SLORule("loss", "loss", "<=", 0.1),
                       tslo.BurnRateRule("b", bad="shed",
                                         good="finished_requests",
                                         objective=0.9, fast_window=1,
                                         slow_window=2)])
  for step in range(4):
    m.observe(step, {"train/loss": torch.tensor(5.0),
                     "train/vec": torch.ones(3),
                     "serving/shed": 0.0,
                     "serving/finished_requests": 0.0})
  assert m.breaches == 0
  assert "loss@train/loss" not in m.status()      # never evaluated
  m.observe(5, {"train/loss": np.float32(5.0)})   # numpy scalars count
  assert m.breaches == 1


def test_raising_listener_is_isolated_logged_once_and_counted():
  m = tslo.SLOMonitor([tslo.SLORule("ttft", "ttft_p99_s", "<=", 0.1)])
  heard = []

  def bad_listener(name, payload):
    raise RuntimeError("chaos: broken subscriber")

  m.add_listener(bad_listener)
  m.add_listener(lambda name, payload: heard.append(name))
  captured = []

  class _Capture(logging.Handler):
    def emit(self, record):
      captured.append(record.getMessage())

  handler = _Capture()
  get_logger().addHandler(handler)
  try:
    for step in range(4):
      m.observe(step, {"serving/ttft_p99_s": 9.0 if step % 2 == 0
                       else 0.01})
  finally:
    get_logger().removeHandler(handler)
  assert m.breaches == 2 and heard == ["ttft", "ttft"]
  assert m.listener_errors == 2
  assert len([x for x in captured if "broken subscriber" in x]) == 1
  m.note_event("watchdog_timeout", {"twin": "serving/fused_step"})
  assert m.listener_errors == 3 and heard[-1] == "watchdog_timeout"


def test_weak_listener_and_context_provider_do_not_pin_their_owner():
  """The ambient monitor outlives engines: an engine subscribing with
  ``weak=True`` stays collectible, and its hooks vanish with it."""
  import gc

  class Owner:
    def on_breach(self, name, payload):
      pass

    def context(self):
      return {"owner": 1}

  m = tslo.SLOMonitor([])
  owner = Owner()
  m.add_listener(owner.on_breach, weak=True)
  m.add_context_provider(owner.context)
  del owner
  gc.collect()
  m.note_event("x")
  assert m._listeners == [] and m._collect(m._context_providers) == []


def test_diagnostic_capture_rate_limit_and_retention_match_jax(tmp_path):
  got = {}
  for impl, mod in IMPLS.items():
    root = tmp_path / impl
    clock = FakeClock()
    cap = mod.DiagnosticCapture(str(root), limit=2, min_interval_s=10.0,
                                clock=clock)
    results = [cap.capture("first") is not None,
               cap.capture("suppressed") is not None]
    for i in range(3):
      clock.t += 11.0
      results.append(cap.capture(f"later{i}") is not None)
    bundles = sorted(os.listdir(root))
    got[impl] = (results, cap.suppressed, cap.captures,
                 [b.split("_", 3)[-1] for b in bundles])
  assert got["port"] == got["jax"]
  assert got["port"] == ([True, False, True, True, True], 1, 4,
                         ["later1", "later2"])


def test_diagnostic_bundle_holds_trace_registry_and_context(tmp_path):
  tracer = ttrace.install(ttrace.Tracer())
  tracer.instant("before")
  reg = tregistry.MetricRegistry()
  reg.publish(1, {"itl_p99_s": 0.2}, "serving")
  cap = tslo.DiagnosticCapture(str(tmp_path), min_interval_s=0.0)
  m = tslo.SLOMonitor([tslo.SLORule("itl", "itl_p99_s", "<=", 0.1)],
                      capture=cap)
  m.attach(reg)
  m.add_context_provider(lambda: {"engine": {"x": torch.ones(2)}},
                         weak=False)
  reg.publish(2, {"itl_p99_s": 0.3}, "serving")
  (bundle,) = [e["bundle"] for e in m.events]
  for name in ("meta.json", "trace.json", "registry.json", "state.json"):
    with open(os.path.join(bundle, name)) as f:
      doc = json.load(f)
  assert doc == {"engine": {"x": {"shape": [2],
                                  "dtype": "torch.float32"}}}
  with open(os.path.join(bundle, "registry.json")) as f:
    assert json.load(f)["serving/itl_p99_s"] == 0.3


def test_monitor_and_capture_follow_an_installed_vclock(tmp_path):
  clock = FakeClock(1000.0)
  vclock.install(clock)
  tepl.Env.get().reset(tepl.Config({"observability": {"slo": {
      "enabled": True, "ttft_p99_s": 0.5}}}))
  m = tslo.ensure_configured()
  m.observe(1, {"serving/fleet/ttft_p99_s": 0.9})
  assert m.events[-1]["time"] == 1000.0
  clock.t = 1007.0
  cap = tslo.DiagnosticCapture(str(tmp_path), min_interval_s=30.0)
  first = cap.capture("vclock")
  assert os.path.basename(first).startswith("bundle_1007_")
  assert cap.capture("same-instant") is None
  clock.t += 31.0
  assert cap.capture("later") is not None


def test_ensure_configured_ambient_and_explicit_install():
  tepl.Env.get().reset(tepl.Config({"observability": {"slo": {
      "enabled": True, "ttft_p99_s": 1.0}}}))
  m1 = tslo.ensure_configured()
  assert [r.name for r in m1.rules] == ["ttft_p99", "replica_down"]
  assert tslo.ensure_configured() is m1
  assert tslo.ensure_configured(tepl.Config({"serving.num_slots": 2})) is m1
  tepl.Env.get().reset()
  assert tslo.ensure_configured() is None
  mine = tslo.SLOMonitor([])
  tslo.install(mine)
  assert tslo.ensure_configured() is mine


def test_breach_pressure_freshness_is_per_stream():
  class FakeMon:
    streams = {}

    def breached_stream_obs(self):
      return dict(self.streams)

  mon = FakeMon()
  probes = [mod.BreachPressure(mon, lambda rule, key: True)
            for mod in IMPLS.values()]
  for streams in ({}, {("b", "x"): 3, ("b", "y"): 5}, None,
                  {("b", "x"): 3}, {("b", "x"): 4}, {}):
    if streams is not None:
      mon.streams = streams
    polls = [p.poll() for p in probes]
    assert polls[0] == polls[1], streams


# ------------------------------------------------------------- sentinel


def test_compile_sentinel_watermark_and_attribution_match_jax():
  got = {}
  for impl, mod in IMPLS.items():
    sizes = iter([1, 1, 3, 3, 4])
    fired = []
    s = mod.CompileSentinel("twin", lambda: next(sizes),
                            on_recompile=[lambda *a: fired.append(a)])
    checks = [s.check(), s.check(), s.check(lambda: {"t": "i32[2,4]"}),
              s.check(), s.check()]
    got[impl] = (checks, s.recompiles, fired)
  assert got["port"] == got["jax"]
  assert got["port"][:2] == ([0, 0, 2, 0, 1], 3)


def test_compile_sentinel_from_a_zero_warmup_count():
  """The port's engine takes the warmup count after its first step, and a
  CPU engine has loaded no kernel library: from 0, the first load
  fires."""
  sizes = iter([0, 0, 1])
  s = tslo.CompileSentinel("twin", lambda: next(sizes), expected=0)
  assert [s.check(), s.check(), s.check()] == [0, 0, 1]
  with pytest.raises(ValueError, match="expected"):
    tslo.CompileSentinel("twin", lambda: 0, expected=-1)


def test_compile_sentinel_survives_an_unreadable_count():
  def boom():
    raise AttributeError("no count")
  for mod in IMPLS.values():
    s = mod.CompileSentinel("twin", boom)
    assert s.check() == 0 and s.check() == 0 and s.cache_size() is None


def test_sentinel_breach_reaches_monitor_and_capture(tmp_path):
  cap = tslo.DiagnosticCapture(str(tmp_path), min_interval_s=0.0)
  m = tslo.SLOMonitor([], events_path=str(tmp_path / "ev.jsonl"),
                      capture=cap)
  heard = []
  m.add_listener(lambda name, payload: heard.append(name))
  sizes = iter([1, 2])
  s = tslo.CompileSentinel(
      "fused_step", lambda: next(sizes),
      on_recompile=[lambda label, size, extra, sig: m.note_event(
          "unexpected_recompile",
          {"twin": label, "cache_size": size, "signature": str(sig)})])
  s.check()
  s.check(lambda: "f32[4,8]")
  m.close()
  assert m.breaches == 1 and heard == ["unexpected_recompile"]
  (line,) = [json.loads(x) for x in open(tmp_path / "ev.jsonl")]
  assert line["signature"] == "f32[4,8]"
  assert any(d.startswith("bundle_") for d in os.listdir(tmp_path))


# --------------------------------------------------------------- device


def test_hbm_gauges_fall_back_to_the_cost_card_bound_on_the_cpu():
  """Without a card the gauges report the cost cards' bound, as JAX's do
  where ``memory_stats()`` is None: no frac, source ``cost_card``; the
  card is captured once per label and a failing collect degrades."""
  for mod in (jdevice, tdevice):
    assert mod.DeviceIntrospector().hbm_gauges() == {}
  intro = tdevice.DeviceIntrospector()
  card = intro.capture_twin("serving/fused_step",
                            lambda: dict(peak_hbm_bytes=1234.0, flops=2.0),
                            compile_count=0, meta={"tokens_per_step": 4})
  assert intro.capture_twin("serving/fused_step", lambda: {}) is card
  assert card.metrics()["flops_per_token"] == 0.5
  assert intro.hbm_gauges() == {
      "hbm_bytes_in_use": 1234.0, "hbm_peak_bytes": 1234.0,
      "hbm_bytes_limit": 0.0, "hbm_source": "cost_card"}
  assert intro.capture_twin("bad", lambda: 1 / 0) is None
  assert intro.capture_failures == 1
  assert intro.context()["capture_failures"] == 1
  jcard = jdevice.CostCard(label="x", flops=2.0,
                           meta={"tokens_per_step": 4})
  assert tdevice.CostCard(label="x", flops=2.0,
                          meta={"tokens_per_step": 4}).metrics() == \
      jcard.metrics()


def test_publish_hbm_namespace_and_counters():
  sink = []

  class Sink:
    def write(self, step, rec):
      sink.append((step, rec))

    def flush(self):
      pass

    def close(self):
      pass

  tracer = ttrace.install(ttrace.Tracer())
  intro = tdevice.DeviceIntrospector()
  intro.capture_twin("t", lambda: dict(peak_hbm_bytes=10.0))
  intro.publish_hbm(3, registry=tregistry.MetricRegistry(Sink()))
  assert sink == [(3, {"observability/device/hbm_bytes_in_use": 10.0,
                       "observability/device/hbm_peak_bytes": 10.0,
                       "observability/device/hbm_bytes_limit": 0.0})]
  m = tslo.SLOMonitor([tslo.SLORule("hbm", "hbm_bytes_in_use", "<=", 1.0)])
  intro.publish_hbm(4, monitor=m)
  assert m.breaches == 1
  counters = {e["name"] for e in tracer.events() if e["ph"] == "C"}
  assert {"device/hbm_bytes_in_use", "device/hbm_peak_bytes"} <= counters
  tdevice.DeviceIntrospector(hbm_gauges=False).publish_hbm(
      5, registry=tregistry.MetricRegistry(Sink()))
  assert len(sink) == 1


def test_device_ensure_configured_contract(tmp_path):
  cards = str(tmp_path / "cards.json")
  tepl.Env.get().reset(tepl.Config({"observability": {"device": {
      "enabled": True, "cards_path": cards}}}))
  intro = tdevice.ensure_configured()
  assert intro is not None and tdevice.get_introspector() is intro
  assert tdevice.ensure_configured() is intro
  assert tdevice.ensure_configured(tepl.Config({})) is intro  # foreign
  intro.register_site("s", kind="reduce_scatter", axis_n=2, m=4, k=8,
                      n_out=8, dtype_bytes=2)
  intro.record_site_bytes("s", 64.0)
  assert tdevice.measured_collective_bytes("s") == 64.0
  intro.capture_twin("t", lambda: dict(flops=1.0))
  with open(cards) as f:
    assert json.load(f)["t"]["flops"] == 1.0
  tepl.Env.get().reset()
  assert tdevice.ensure_configured() is None
  assert tdevice.measured_collective_bytes("s") is None
  mine = tdevice.install(tdevice.DeviceIntrospector())
  assert tdevice.ensure_configured() is mine


# --------------------------------------------------------------- engine


def test_engine_publishes_percentile_rollups_mid_run():
  """Per-step records carry only step-local gauges, so the TTFT / ITL
  rules need the periodic rollup (every 50 steps) to stay live on an
  engine driven by ``step()`` alone."""
  records = []

  class Sink:
    def write(self, step, rec):
      records.append(dict(rec))

    def flush(self):
      pass

    def close(self):
      pass

  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.weights import init_params
  cfg = GPTConfig(vocab_size=64, num_layers=1, num_heads=4, d_model=32,
                  d_ff=64, max_seq_len=128, dtype=torch.float32)
  tepl.Env.get().reset(tepl.Config({"observability": {"slo": {
      "enabled": True, "ttft_p99_s": 60.0}}}))
  eng = ContinuousBatchingEngine(GPT(cfg), init_params(cfg, device="cpu"),
                                 device="cpu", num_slots=1, prefill_chunk=4,
                                 stats=ServingStats(),
                                 registry=tregistry.MetricRegistry(Sink()))
  eng.submit(Request(uid="a", prompt=np.arange(4, dtype=np.int32),
                     max_new_tokens=70))
  while eng.has_work:
    eng.step()
  assert any("serving/ttft_p99_s" in r for r in records)
  monitor = tslo.get_monitor()
  assert any(key.startswith("ttft_p99") for key in monitor.status())
  assert monitor.breaches == 0


def test_registry_less_engine_feeds_the_monitor_directly():
  """Without a registry, the per-step records still reach the monitor:
  an ITL rule no step can meet breaches on them."""
  model, params = tiny_gpt(device="cpu")
  tepl.Env.get().reset(tepl.Config({"observability": {"slo": {
      "enabled": True}}}))
  monitor = tslo.get_monitor() or tslo.ensure_configured()
  monitor.rules.append(tslo.SLORule("step", "step_time_s", "<=", 0.0))
  eng = ContinuousBatchingEngine(model, params, device="cpu", num_slots=2,
                                 prefill_chunk=4)
  eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                     max_new_tokens=3))
  eng.run()
  assert tslo.get_monitor().breaches == 1
  assert tslo.get_monitor().events[-1]["metric"] == "serving/step_time_s"


def test_not_ported_no_longer_names_tracing():
  from easyparallellibrary_tpu_torch import _not_ported
  assert not hasattr(_not_ported, "TRACING")
