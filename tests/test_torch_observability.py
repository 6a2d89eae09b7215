"""The port's tracing, metric registry and serving observability against
the JAX package's.

The engines: the JAX engine and the port's run the same staggered
requests on TINY (fp32, parameters bridged with
``weights.from_jax_params``, ``device="cpu"``) with tracing on, and their
exported traces carry the same multiset of ``(ph, name, cat, track)``
events, the same request-span and speculate-span arguments, and the same
per-step ``serving/*`` records on every key that is not a time.  The
port's ``report`` over the JAX engine's trace equals JAX's.  Fully-on
observability is token-equal to off; episodes with a paged preemption,
a persistent NaN fault and a hanging step export traces that
``validate_trace`` passes.  The units hold the port's tracer, registry
and metric writers against JAX's classes on the same inputs.
"""

import collections
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu.models import GPT as JaxGPT
from easyparallellibrary_tpu.models import GPTConfig as JaxGPTConfig
from easyparallellibrary_tpu.observability import device as jdevice
from easyparallellibrary_tpu.observability import registry as jregistry
from easyparallellibrary_tpu.observability import report as jreport
from easyparallellibrary_tpu.observability import slo as jslo
from easyparallellibrary_tpu.observability import trace as jtrace
from easyparallellibrary_tpu.profiler.serving import (
    ServingStats as JaxServingStats)
from easyparallellibrary_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine, NgramDrafter as JaxNgramDrafter,
    Request as JaxRequest)
from easyparallellibrary_tpu.testing import chaos as jchaos
from easyparallellibrary_tpu.utils import metrics_writer as jwriter
from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.models import bert as tbert
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.observability import device as tdevice
from easyparallellibrary_tpu_torch.observability import registry as tregistry
from easyparallellibrary_tpu_torch.observability import report as treport
from easyparallellibrary_tpu_torch.observability import slo as tslo
from easyparallellibrary_tpu_torch.observability import trace as ttrace
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.parallel import api as tapi
from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
from easyparallellibrary_tpu_torch.runtime import loop as tloop
from easyparallellibrary_tpu_torch.serving import (
    ContinuousBatchingEngine, NgramDrafter, Request)
from easyparallellibrary_tpu_torch.testing import chaos
from easyparallellibrary_tpu_torch.utils import metrics_writer as twriter
from easyparallellibrary_tpu_torch.weights import from_jax_params

# Tiny shapes: one intra-op thread leaves the cores to the suite's other
# worker processes.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
PAGED = dict(num_slots=3, prefill_chunk=8, paged=True, block_size=4)
CONTIGUOUS = dict(num_slots=3, prefill_chunk=8, paged=False)
MAX_NEW = (6, 7, 8, 4, 5, 9)
# Record keys that carry a time (or a rate over one): compared by
# presence only, every other key by value.
TIME_KEYS = ("step_time_s", "tokens_per_s", "prefill_tokens_per_s",
             "decode_tokens_per_s", "wall_s", "ttft", "itl", "_ewma")


@pytest.fixture(autouse=True)
def _clean_ambient_state():
  """The ambient tracer, monitor and introspector of both packages
  outlive the per-test Env reset: drop them around every test."""
  for mod in (jtrace, jslo, jdevice, ttrace, tslo, tdevice):
    mod.reset()
  yield
  for mod in (jtrace, jslo, jdevice, ttrace, tslo, tdevice):
    mod.reset()
  tepl.Env.get().reset()
  jepl.Env.get().reset()


def _models(seed=0):
  jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  return jmodel, jparams, tmodel, from_jax_params(tree, device="cpu")


def _prompts(seed=3):
  """Six prompts with a shared 8-token head and repeated spans, so the
  prefix cache hits and the n-gram drafter proposes."""
  r = np.random.RandomState(seed)
  shared = np.arange(1, 9, dtype=np.int32)
  return [np.concatenate([shared, np.tile(r.randint(0, 64, (n,)), 2)])
          .astype(np.int32) for n in (3, 1, 6, 2, 5, 4)]


def _drive_staggered(engine, request_cls, prompts, max_new=MAX_NEW):
  """Three requests, two steps, then the rest join mid-flight."""
  for i in range(3):
    engine.submit(request_cls(uid=i, prompt=prompts[i],
                              max_new_tokens=max_new[i]))
  out = {}
  for _ in range(2):
    for fin in engine.step():
      out[fin.uid] = fin.tokens
  for i in range(3, len(prompts)):
    engine.submit(request_cls(uid=i, prompt=prompts[i],
                              max_new_tokens=max_new[i]))
  out.update(engine.run())
  return out


class _ListSink:

  def __init__(self):
    self.records = []
    self.closed = False

  def write(self, step, metrics):
    self.records.append((step, dict(metrics)))

  def flush(self):
    pass

  def close(self):
    self.closed = True


def _track_names(events):
  return {(e["pid"], e["tid"]): e["args"]["name"] for e in events
          if e["ph"] == "M" and e["name"] == "thread_name"}


def _event_multiset(events):
  names = _track_names(events)
  return collections.Counter(
      (e["ph"], e["name"], e.get("cat", ""), names[(e["pid"], e["tid"])])
      for e in events if e["ph"] != "M")


def _span_args(events, name=None, cat=None, keys=()):
  names = _track_names(events)
  spans, unmatched = treport.pair_spans(events)
  assert unmatched == 0
  return collections.Counter(
      (names[(s["pid"], s["tid"])],) + tuple(s["args"].get(k) for k in keys)
      for s in spans
      if (name is None or s["name"] == name)
      and (cat is None or s["cat"] == cat))


def _is_time_key(key):
  return any(t in key for t in TIME_KEYS)


def _assert_records_equal(want, got):
  """Per-step records (those with ``serving/step_time_s``) equal on every
  non-time key; rollup records equal in their key sets."""
  assert [s for s, _ in got] == [s for s, _ in want]
  for (step, w), (_, g) in zip(want, got):
    assert set(g) == set(w), (step, set(g) ^ set(w))
    if "serving/step_time_s" not in w:
      continue
    for key in w:
      if not _is_time_key(key):
        assert g[key] == w[key], (step, key, g[key], w[key])


def _run_pair(layout, drafter, tmp_path):
  """The same staggered load through the JAX engine and the port's, each
  traced into its own package's tracer and publishing into a registry;
  returns both sides' streams, exported traces and records."""
  jepl.init()
  jmodel, jparams, tmodel, tparams = _models()
  knobs = dict(PAGED, prefix_cache=True) if layout == "paged" else CONTIGUOUS
  prompts = _prompts()
  out = {}
  for side in ("jax", "port"):
    sink = _ListSink()
    if side == "jax":
      jtrace.install(jtrace.Tracer(ring_capacity=1 << 16))
      eng = JaxEngine(jmodel, jparams, registry=jregistry.MetricRegistry(sink),
                      stats=JaxServingStats(),
                      drafter=JaxNgramDrafter(k=4) if drafter else None,
                      **knobs)
      streams = _drive_staggered(eng, JaxRequest, prompts)
      path = jtrace.get_tracer().export(str(tmp_path / "jax.json"))
    else:
      ttrace.install(ttrace.Tracer(ring_capacity=1 << 16))
      eng = ContinuousBatchingEngine(
          tmodel, tparams, device="cpu",
          registry=tregistry.MetricRegistry(sink), stats=ServingStats(),
          drafter=NgramDrafter(k=4) if drafter else None, **knobs)
      streams = _drive_staggered(eng, Request, prompts)
      path = ttrace.get_tracer().export(str(tmp_path / "port.json"))
    with open(path) as f:
      events = json.load(f)["traceEvents"]
    out[side] = dict(streams=streams, events=events, records=sink.records,
                     path=path, engine=eng)
  return out


# ------------------------------------------------------- engine parity --


@pytest.mark.parametrize("layout,drafter", [
    ("paged", True), ("contiguous", False), ("contiguous", True)],
    ids=["paged-ngram-prefix", "contiguous", "contiguous-ngram"])
def test_engine_trace_and_records_equal_jax(layout, drafter, tmp_path):
  """Same requests, same knobs, tracing on: the port's trace is the JAX
  engine's event for event (phase, name, category and track, times
  aside), its request spans close with the same uid, finish reason and
  token count, its speculate spans carry the same drafted / accepted
  counts, and every per-step ``serving/*`` record is equal on every
  non-time key.  Both traces pass ``validate_trace``."""
  run = _run_pair(layout, drafter, tmp_path)
  jax_side, port = run["jax"], run["port"]
  for i in range(6):
    np.testing.assert_array_equal(port["streams"][i], jax_side["streams"][i])
  ttrace.validate_trace(port["path"])
  jtrace.validate_trace(jax_side["path"])
  assert _event_multiset(port["events"]) == _event_multiset(
      jax_side["events"])
  keys = ("uid", "finish_reason", "new_tokens")
  assert _span_args(port["events"], cat="serving.request", keys=keys) == \
      _span_args(jax_side["events"], cat="serving.request", keys=keys)
  spec = ("drafted", "accepted")
  got_spec = _span_args(port["events"], name="speculate", keys=spec)
  assert got_spec == _span_args(jax_side["events"], name="speculate",
                                keys=spec)
  assert bool(got_spec) == drafter
  _assert_records_equal(jax_side["records"], port["records"])
  assert len(port["records"]) == port["engine"].steps + 1  # + the rollup


def test_report_over_jax_trace_equals_jax_report(tmp_path):
  """The port's ``report`` reads the JAX engine's exported trace exactly
  as JAX's does: the same request timelines, span table and text."""
  run = _run_pair("paged", True, tmp_path)
  events = jreport.load_events(run["jax"]["path"])
  assert treport.load_events(run["jax"]["path"]) == events
  assert treport.request_timelines(events) == jreport.request_timelines(
      events)
  spans, unmatched = treport.pair_spans(events)
  assert (spans, unmatched) == jreport.pair_spans(events)
  assert treport.span_table(spans) == jreport.span_table(spans)
  assert treport.format_report(events) == jreport.format_report(events)
  timelines = treport.request_timelines(
      treport.load_events(run["port"]["path"]))
  assert sorted(r["uid"] for r in timelines) == [str(i) for i in range(6)]
  assert sum(r["drafted"] for r in timelines) > 0


def test_report_cli_over_a_port_trace(tmp_path, capsys):
  """``python -m easyparallellibrary_tpu_torch.observability.report``
  over the port's trace prints the span table and every request's
  timeline; ``--follow`` tails a registry JSONL."""
  run = _run_pair("paged", True, tmp_path)
  assert treport.main([run["port"]["path"]]) == 0
  out = capsys.readouterr().out
  for want in ("serving/device_step", "prefill", "speculate", "finish",
               "blk-reused"):
    assert want in out, want
  metrics = tmp_path / "metrics.jsonl"
  with twriter.MetricsWriter(str(metrics)) as w:
    for step, rec in run["port"]["records"]:
      w.write(step, rec)
  assert treport.main(["--follow", str(metrics), "--max-polls", "1",
                       "--interval", "0"]) == 0
  assert "record(s)" in capsys.readouterr().out


# --------------------------------------------- observability on vs off --


def _full_config(tmp_path, **slo):
  return tepl.Config({"observability": {
      "enabled": True, "ring_capacity": 1 << 16,
      "slo": dict({"enabled": True,
                   "events_path": str(tmp_path / "slo_events.jsonl"),
                   "capture_dir": str(tmp_path / "bundles"),
                   "capture_min_interval_s": 0.0}, **slo),
      "device": {"enabled": True}}})


@pytest.mark.quick
def test_full_observability_is_token_equal_to_off(tmp_path):
  """The slice's pin: the paged engine with the n-gram drafter and the
  prefix cache, observability fully on (tracer, SLO monitor, device
  introspector, a registry with a JSONL sink) is token-equal to the same
  engine with it off; the trace validates with one complete lifecycle
  per request (a submit and a first-token instant, one request span
  holding at least one prefill and one decode or speculate span); the
  JSONL holds a ``serving/*`` record for every step; the compile
  sentinel stays silent; the cost card shows the caches written in
  place; the CPU's HBM gauges fall back to the card's bound."""
  _, _, tmodel, tparams = _models()
  prompts = _prompts()
  knobs = dict(PAGED, prefix_cache=True)
  off = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 drafter=NgramDrafter(k=4), **knobs)
  want = _drive_staggered(off, Request, prompts)
  tepl.Env.get().reset(_full_config(tmp_path))
  metrics = str(tmp_path / "metrics.jsonl")
  registry = tregistry.MetricRegistry(twriter.MetricsWriter(metrics))
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 drafter=NgramDrafter(k=4), stats=
                                 ServingStats(), registry=registry, **knobs)
  got = _drive_staggered(eng, Request, prompts)
  registry.close()
  for i in range(6):
    np.testing.assert_array_equal(got[i], want[i])
  assert eng.steps == off.steps
  path = ttrace.get_tracer().export(str(tmp_path / "trace.json"))
  events = ttrace.validate_trace(path)
  names = _track_names(events)
  for uid in map(str, range(6)):
    kinds = collections.Counter(
        e["name"] for e in events if e["ph"] == "i"
        and (e.get("args") or {}).get("uid") == uid)
    assert kinds["serving/submit"] == 1 and kinds[
        "serving/first_token"] == 1, (uid, kinds)
  spans, _ = treport.pair_spans(events)
  requests = [s for s in spans if s["cat"] == "serving.request"]
  assert sorted(s["args"]["uid"] for s in requests) == list(map(str,
                                                                range(6)))
  for req in requests:
    inner = [s["name"] for s in spans
             if (s["pid"], s["tid"]) == (req["pid"], req["tid"])
             and s is not req and req["ts"] <= s["ts"]
             and s["ts"] + s["dur"] <= req["ts"] + req["dur"]]
    assert "prefill" in inner, req["args"]
    assert {"decode", "speculate"} & set(inner), req["args"]
  assert all(names[(e["pid"], e["tid"])].startswith("serving")
             for e in events if e["ph"] == "B" and e["name"] == "prefill")
  with open(metrics) as f:
    lines = [json.loads(line) for line in f]
  per_step = [r["step"] for r in lines if "serving/step_time_s" in r]
  assert per_step == list(range(1, eng.steps + 1))
  assert eng._compile_sentinel.recompiles == 0
  assert tslo.get_monitor().breaches == 0
  card = tdevice.get_introspector().card("serving/fused_step")
  assert card.donation_requested and card.donation_verified
  assert card.flops > 0 and card.argument_bytes > 0
  gauges = [r for r in lines if "observability/device/hbm_bytes_in_use" in r]
  assert gauges and gauges[0][
      "observability/device/hbm_bytes_in_use"] == card.peak_hbm_bytes


def test_device_trace_of_the_step_after_an_engine_attributed_breach(
    tmp_path):
  """``observability.slo.capture_xla``: a breach attributed to this
  engine's twin arms ``Tracer.device_trace`` around the next step, into
  the breach's bundle (a ``torch.profiler`` Chrome trace); a breach
  attributed to another twin arms nothing."""
  _, _, tmodel, tparams = _models()
  tepl.Env.get().reset(_full_config(tmp_path, capture_xla=True))
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **PAGED)
  eng.submit(Request(uid=0, prompt=_prompts()[0], max_new_tokens=6))
  eng.step()
  monitor = tslo.get_monitor()
  monitor.note_event("watchdog_timeout", {"twin": "serving/replica9/x"})
  assert eng._pending_device_dir is None
  monitor.note_event("watchdog_timeout", {"twin": eng._twin_label})
  bundle = monitor.events[-1]["bundle"]
  assert eng._pending_device_dir == os.path.join(bundle, "device")
  eng.step()
  with open(os.path.join(bundle, "device", "device_trace.json")) as f:
    prof = json.load(f)
  assert prof["traceEvents"]
  assert eng._pending_device_dir is None
  with open(os.path.join(bundle, "state.json")) as f:
    state = json.load(f)
  assert state["serving"]["engine_steps"] == 1
  assert "cost_cards" in state["device"]
  events = ttrace.get_tracer().events()
  assert any(e["ph"] == "B" and e["name"] == "device_trace"
             for e in events)


# ------------------------------------------------------------- episodes --


def test_preemption_episode_traces_validly_and_equals_jax(tmp_path):
  """A paged pool too small for the load preempts: the preempted
  request's span closes ("requeued") and reopens on readmission, the
  trace validates with every span paired, the streams equal the
  untraced run's, and the events are the JAX engine's."""
  jepl.init()
  jmodel, jparams, tmodel, tparams = _models()
  r = np.random.RandomState(7)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32) for n in (9, 7, 8)]
  knobs = dict(num_slots=3, prefill_chunk=4, paged=True, block_size=4,
               num_blocks=9)
  untraced = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **knobs)
  for i, p in enumerate(prompts):
    untraced.submit(Request(uid=i, prompt=p, max_new_tokens=12))
  want = untraced.run()
  ttrace.install(ttrace.Tracer())
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **knobs)
  jtrace.install(jtrace.Tracer())
  jeng = JaxEngine(jmodel, jparams, **knobs)
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=12))
    jeng.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=12))
  got = eng.run()
  jeng.run()
  assert eng.scheduler.preemptions > 0
  for i in range(3):
    np.testing.assert_array_equal(got[i], want[i])
  events = ttrace.validate_trace(
      ttrace.get_tracer().export(str(tmp_path / "t.json")))
  assert any(e["name"] == "serving/requeue"
             and e["args"]["reason"] == "preempted" for e in events)
  ends = _span_args(events, cat="serving.request", keys=("finish_reason",))
  assert sum(n for (_, reason), n in ends.items()
             if reason == "requeued") == eng.scheduler.preemptions
  assert _event_multiset(events) == _event_multiset(
      jtrace.get_tracer().events())


def test_persistent_nan_episode_traces_validly_and_equals_jax(tmp_path):
  """A persistent NaN fault (``NaNLogitsInjector`` on adjacent calls)
  escalates from retry to requeue: the trace validates with every span
  paired, carries the ``serving/bad_step`` and ``serving/requeue``
  instants, the streams equal the untraced faulted run's, and the events
  are the JAX engine's on the same episode."""
  jepl.init()
  jmodel, jparams, tmodel, tparams = _models()
  r = np.random.RandomState(2)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32) for n in (5, 7, 3)]
  knobs = dict(num_slots=3, prefill_chunk=4, paged=True, block_size=4,
               resilience=True)

  def port_run():
    eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **knobs)
    inj = chaos.NaNLogitsInjector(eng, bad_calls=(3, 4))
    for i, p in enumerate(prompts):
      eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
    return eng, inj, eng.run()

  _, _, want = port_run()
  ttrace.install(ttrace.Tracer())
  eng, inj, got = port_run()
  jtrace.install(jtrace.Tracer())
  jeng = JaxEngine(jmodel, jparams, **knobs)
  jchaos.NaNLogitsInjector(jeng, bad_calls=(3, 4))
  for i, p in enumerate(prompts):
    jeng.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=8))
  jeng.run()
  assert inj.poisoned == [3, 4] and eng._bad_policy.requeues > 0
  for i in range(3):
    np.testing.assert_array_equal(got[i], want[i])
  events = ttrace.validate_trace(
      ttrace.get_tracer().export(str(tmp_path / "t.json")))
  names = {e["name"] for e in events}
  assert {"serving/bad_step", "serving/requeue"} <= names
  assert _event_multiset(events) == _event_multiset(
      jtrace.get_tracer().events())


def test_watchdog_timeout_instant_and_slo_event(tmp_path):
  """A hanging step (``HangingStepInjector``, 0.4 s against a 0.05 s
  deadline) fires the watchdog: a ``resilience/watchdog_timeout``
  instant on the watchdog's track and a ``watchdog_timeout`` SLO event
  attributed to this engine's twin; the streams stay exact."""
  _, _, tmodel, tparams = _models()
  tepl.Env.get().reset(tepl.Config({
      "observability": {"enabled": True, "slo": {"enabled": True}},
      "serving": {"resilience": {"enabled": True,
                                 "step_timeout_s": 0.05}}}))
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **PAGED)
  chaos.HangingStepInjector(eng, hang_calls=(1,), hang_s=0.4)
  prompt = _prompts()[1]
  eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
  got = eng.run()[0]
  eng.close()
  want = tgpt.generate(tmodel, tparams, torch.from_numpy(prompt[None]).long(),
                       5)[0].numpy()
  np.testing.assert_array_equal(got, want)
  events = ttrace.get_tracer().events()
  names = _track_names(events)
  fired = [e for e in events if e["name"] == "resilience/watchdog_timeout"]
  assert len(fired) == 1 and fired[0]["args"]["step"] == 1
  assert names[(fired[0]["pid"], fired[0]["tid"])] == "resilience/watchdog"
  monitor = tslo.get_monitor()
  (event,) = [e for e in monitor.events if e["rule"] == "watchdog_timeout"]
  assert event["twin"] == "serving/fused_step" and event["engine_step"] == 1
  assert eng.stats.watchdog_timeouts == 1


def test_compile_sentinel_fires_on_a_kernel_library_loaded_mid_run(
    monkeypatch):
  """The counterpart of a mid-serving recompile: a kernel library
  loaded after the engine's first step.  The sentinel takes its warmup
  count at the end of that step; a later load fires a
  ``serving/recompile`` instant, the stats counter and an
  ``unexpected_recompile`` SLO event naming the step's signature."""
  _, _, tmodel, tparams = _models()
  tepl.Env.get().reset(tepl.Config({"observability": {
      "enabled": True, "slo": {"enabled": True}}}))
  stats = ServingStats()
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", stats=stats,
                                 **PAGED)
  eng.submit(Request(uid=0, prompt=_prompts()[0], max_new_tokens=6))
  libs = dict(_build._LIBS)
  monkeypatch.setattr(_build, "_LIBS", libs)
  eng.step()
  eng.step()
  assert eng._compile_sentinel.recompiles == 0
  libs["late_kernel"] = object()
  eng.step()
  assert eng._compile_sentinel.recompiles == 1
  eng.run()
  assert eng._compile_sentinel.recompiles == 1
  (inst,) = [e for e in ttrace.get_tracer().events()
             if e["name"] == "serving/recompile"]
  assert inst["args"]["new_compiles"] == 1
  assert "PagedStepPlan" in inst["args"]["signature"]
  (event,) = tslo.get_monitor().events
  assert event["rule"] == "unexpected_recompile"
  assert event["twin"] == "serving/fused_step"
  assert stats.summary()["recompiles"] == 1.0


def test_shed_and_degraded_instants(tmp_path):
  """Admission control's shed lands as a ``serving/shed`` instant (its
  flow terminated), and the ladder's transitions (an ITL SLO no step
  can meet forces ``spec_off``) as ``serving/degraded`` instants with
  the level counter; the trace validates."""
  _, _, tmodel, tparams = _models()
  ttrace.install(ttrace.Tracer())
  eng = ContinuousBatchingEngine(
      tmodel, tparams, device="cpu", resilience=True,
      config=tepl.Config({"serving": {"resilience": {
          "enabled": True, "queue_limit": 2, "itl_slo_s": 1e-6}}}),
      **PAGED)
  prompts = _prompts()
  eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=4))
  eng.step()
  accepted = [eng.submit(Request(uid=i, prompt=prompts[i % 6],
                                 max_new_tokens=4)) for i in range(1, 8)]
  assert not all(accepted)
  eng.run()
  events = ttrace.validate_trace(
      ttrace.get_tracer().export(str(tmp_path / "t.json")))
  sheds = [e for e in events if e["name"] == "serving/shed"]
  assert len(sheds) == accepted.count(False)
  assert any(e["name"] == "serving/degraded" for e in events)
  assert any(e["ph"] == "C" and e["name"] == "serving/degraded_level"
             for e in events)


# ------------------------------------------------------------ tracer unit


def _both_tracers(**kw):
  return jtrace.Tracer(**kw), ttrace.Tracer(**kw)


def test_tracer_ring_capacity_and_dropped_count():
  for tracer in _both_tracers(enabled=True, ring_capacity=4):
    for i in range(10):
      tracer.instant(f"e{i}")
    events = [e for e in tracer.events() if e["ph"] == "i"]
    assert [e["name"] for e in events] == ["e6", "e7", "e8", "e9"]
    assert tracer.dropped == 6


def test_wrapped_ring_exports_a_valid_trace(tmp_path):
  """A ring that wrapped keeps the newest window: the export notes what
  it dropped, and the engine's trace still validates (spans cut by the
  wrap are left out of the window, not half-exported), as in JAX."""
  _, _, tmodel, tparams = _models()
  ttrace.install(ttrace.Tracer(ring_capacity=64))
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **PAGED)
  for i, p in enumerate(_prompts()[:3]):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
  eng.run()
  tracer = ttrace.get_tracer()
  assert tracer.dropped > 0
  path = tracer.export(str(tmp_path / "t.json"))
  with open(path) as f:
    doc = json.load(f)
  assert doc["otherData"]["dropped_events"] == tracer.dropped
  spans, unmatched = treport.pair_spans(doc["traceEvents"])
  assert spans and unmatched > 0


def test_tracer_concurrent_recording_is_consistent():
  tracer = ttrace.Tracer(enabled=True, ring_capacity=64)
  n = 2000

  def monitor():
    for i in range(n):
      tracer.instant("timeout", track=f"watchdog {i % 7}")

  t = threading.Thread(target=monitor)
  t.start()
  for i in range(n):
    with tracer.span("step", track=f"slot {i % 7}"):
      pass
  t.join()
  total = n + 2 * n  # instants + B/E pairs
  assert tracer._n_appended == total
  assert tracer.dropped == total - len(tracer._events)
  tids = list(tracer._tracks.values())
  assert len(tids) == len(set(tids))


@pytest.mark.parametrize("rate,want", [(0.5, {1, 3, 5, 7}), (0.25, {3, 7})])
def test_tracer_sampling_is_deterministic_and_keeps_whole_steps(rate, want):
  """Per-step ``sample_tick`` decisions, passed to every phase span as
  ``record=``, record exactly what JAX's tracer records on the same
  sequence: every other step's whole phase set at rate 0.5, every 4th
  at 0.25, phases that only some steps reach included."""
  steps = {}
  for impl, tracer in zip(("jax", "port"),
                          _both_tracers(enabled=True, sample_rate=rate)):
    kept = []
    for step in range(8):
      rec = tracer.sample_tick("train")
      phases = ["data_next", "step_dispatch"] + (
          ["host_sync"] if step % 2 else [])
      for phase in phases:
        before = len(tracer._events)
        with tracer.span(phase, record=rec):
          pass
        if len(tracer._events) > before:
          kept.append((step, phase))
    steps[impl] = kept
  assert steps["port"] == steps["jax"]
  assert {s for s, _ in steps["port"]} == want
  assert len(steps["port"]) == sum(3 if s % 2 else 2 for s in want)


def test_tracer_disabled_is_noop_and_null_span_shared():
  tracer = ttrace.Tracer(enabled=False, ring_capacity=8)
  s1 = tracer.span("a")
  s2 = tracer.span("b", record=False)
  assert s1 is s2 is ttrace._NULL_SPAN
  with s1:
    tracer.instant("x")
    tracer.counter("c", 1)
    tracer.flow("s", 1)
    tracer.span_at("y", 0.0, 1.0)
  assert not list(tracer._events)
  assert ttrace.get_tracer().enabled is False


def test_device_trace_brackets_a_torch_profiler_capture(tmp_path):
  """``Tracer.device_trace`` (JAX: ``xla_trace``) writes a
  ``torch.profiler`` Chrome trace into the directory and records a host
  span around it; the capture runs even with the tracer disabled."""
  tracer = ttrace.Tracer()
  with tracer.device_trace(str(tmp_path / "a")) as prof:
    torch.ones(4, 4) @ torch.ones(4, 4)
  assert prof is not None
  with open(tmp_path / "a" / "device_trace.json") as f:
    assert json.load(f)["traceEvents"]
  (span,) = [e for e in tracer.events() if e["ph"] == "B"]
  assert span["name"] == "device_trace" and span["cat"] == "device"
  off = ttrace.Tracer(enabled=False)
  with off.device_trace(str(tmp_path / "b")):
    torch.ones(2) + 1
  assert (tmp_path / "b" / "device_trace.json").exists()
  assert not list(off._events)


# ------------------------------------------------- the train step's spans

STEP_SPANS = {"train/forward", "train/backward", "train/optimizer",
              "train/remat", "train/flash_delta"}


def _tiny_step(family):
  """A tiny train step with flash attention and remat on (GPT:
  ``dots_flash`` and the chunked tied head; BERT: whole blocks), its
  state and a batch, on the CPU."""
  tepl.init(device="cpu")
  gen = torch.Generator().manual_seed(0)
  kw = dict(TINY, dtype=torch.float32, attn_impl="pallas_flash", remat=True)
  if family == "gpt":
    with tepl.replicate(1):
      model = tgpt.GPT(tgpt.GPTConfig(**kw, remat_policy="dots_flash",
                                      loss_chunk=8))
    step = tapi.make_train_step(
        lambda p, b, r: tgpt.gpt_loss(model, p, b, r))
    batch = {"ids": torch.randint(0, TINY["vocab_size"], (2, 17),
                                  generator=gen)}
  else:
    with tepl.replicate(1):
      model = tbert.Bert(tbert.BertConfig(**kw))
    step = tbert.make_bert_train_step(model)
    ids = torch.randint(4, TINY["vocab_size"], (2, 16), generator=gen)
    mask = torch.zeros(2, 16)
    mask[:, ::4] = 1
    batch = {"ids": ids, "labels": ids, "mask": mask}
  mesh = tepl.current_plan().build_mesh()
  params = {n: 0.02 * torch.randn(p.shape, generator=gen)
            for n, p in model.named_parameters()}
  state, shardings = tapi.create_sharded_train_state(
      lambda: tapi.TrainState.create(apply_fn=model, params=params,
                                     tx=tadamw.adamw(1e-3)), mesh)
  return tapi.parallelize(step, mesh, shardings), state, batch


def _refuse_step_ranges(monkeypatch):
  """``record_function`` raises for the train step's span names (torch's
  own optimizer opens one of its own on every step)."""
  real = torch.autograd.profiler.record_function

  def guarded(name, *args, **kwargs):
    if name in STEP_SPANS:
      raise AssertionError(f"record_function({name!r}) outside a profiler")
    return real(name, *args, **kwargs)

  monkeypatch.setattr(torch.autograd.profiler, "record_function", guarded)


def _profiled_spans(fn):
  """``[(start_us, end_us, name)]`` of the ``train/*`` ranges a CPU
  ``torch.profiler`` capture of ``fn()`` holds, by start."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    fn()
  return sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.name.startswith("train/"))


def _enclosing(spans, span):
  start, end, _ = span
  return {n for s, e, n in spans if s <= start and end <= e
          and (s, e, n) != span}


def test_span_mirrors_into_a_running_profiler_whatever_the_tracer():
  """Off and with no profiler, ``span`` is the shared null span; under a
  profiler every context-manager span is a ``record_function`` range,
  sampled or not, and only an enabled tracer's sampled span reaches the
  ring."""
  for enabled in (False, True):
    tracer = ttrace.Tracer(enabled=enabled)
    assert (tracer.span("a") is ttrace._NULL_SPAN) is not enabled
    assert tracer.span("a", record=False) is ttrace._NULL_SPAN

    def body(tracer=tracer):
      with tracer.span("train/forward", cat="train", track="train"):
        torch.ones(2) + 1
      with tracer.span("train/backward", record=False):
        torch.ones(2) + 1

    spans = _profiled_spans(body)
    assert [n for _, _, n in spans] == ["train/forward", "train/backward"]
    ring = [e["name"] for e in tracer.events() if e["ph"] == "B"]
    assert ring == (["train/forward"] if enabled else [])


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_train_step_calls_no_record_function_with_nothing_on(family,
                                                              monkeypatch):
  step, state, batch = _tiny_step(family)
  _refuse_step_ranges(monkeypatch)
  state, metrics = step(state, batch, None)
  assert torch.isfinite(metrics["loss"])
  assert ttrace.get_tracer().pending == 0


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_train_step_spans_nest_in_a_profiler_capture(family):
  """Under a CPU capture the step holds the five phases: forward,
  backward and optimizer in turn, the remat body inside the forward (its
  first run) and inside the backward (the recompute, through the
  selective-checkpoint dispatch mode on GPT), K1's ``delta`` inside the
  backward."""
  step, state, batch = _tiny_step(family)
  state, _ = step(state, batch, None)
  spans = _profiled_spans(lambda: step(state, batch, None))
  assert {n for _, _, n in spans} == STEP_SPANS
  top = [n for s in spans if not _enclosing(spans, s) for n in s[2:]]
  assert top == ["train/forward", "train/backward", "train/optimizer"]
  remat = [_enclosing(spans, s) for s in spans if s[2] == "train/remat"]
  assert {"train/forward"} in remat and {"train/backward"} in remat
  assert all(len(o) == 1 for o in remat)
  delta = [_enclosing(spans, s) for s in spans if s[2] == "train/flash_delta"]
  assert len(delta) == TINY["num_layers"]
  assert all(o == {"train/backward"} for o in delta)


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_train_step_spans_reach_an_enabled_tracer_alone(family, monkeypatch):
  """With a tracer on and no profiler the phases nest in the ring's
  ``train`` track (the export validates) and no ``record_function``
  opens."""
  step, state, batch = _tiny_step(family)
  tracer = ttrace.install(ttrace.Tracer())
  _refuse_step_ranges(monkeypatch)
  step(state, batch, None)
  events = ttrace.validate_trace(tracer.events())
  names = [e["name"] for e in events if e.get("ph") == "B"]
  assert set(names) == STEP_SPANS
  assert names.count("train/flash_delta") == TINY["num_layers"]
  assert {e["tid"] for e in events if e.get("ph") == "B"} == {
      tracer.track("train")}


def test_fit_keeps_the_step_spans_on_exactly_the_sampled_steps():
  """At ``sample_rate`` 0.5, fit's every other step records its whole
  phase set inside its ``train/step_dispatch`` and the other steps
  record none."""
  step, state, batch = _tiny_step("gpt")
  tracer = ttrace.install(ttrace.Tracer(sample_rate=0.5))
  tloop.fit(step, state, [batch] * 4, num_steps=4, log_every=0,
            device="cpu")
  events = ttrace.validate_trace(tracer.events())
  dispatch, inside = [], []
  for e in events:
    if e.get("name") == "train/step_dispatch":
      if e["ph"] == "B":
        dispatch.append([e["ts"], None])
      else:
        dispatch[-1][1] = e["ts"]
    elif e.get("ph") == "B" and e["name"] in STEP_SPANS:
      inside.append((e["ts"], e["name"]))
  assert len(dispatch) == 2
  for start, end in dispatch:
    assert {n for t, n in inside if start <= t <= end} == STEP_SPANS
  assert all(any(a <= t <= b for a, b in dispatch) for t, _ in inside)


VALIDATE_NEGATIVES = {
    "monotonic": [{"ph": "B", "name": "a", "pid": 0, "tid": 0, "ts": 2.0},
                  {"ph": "E", "name": "a", "pid": 0, "tid": 0, "ts": 1.0}],
    "unclosed": [{"ph": "B", "name": "a", "pid": 0, "tid": 0, "ts": 1.0}],
    "no open B": [{"ph": "E", "name": "a", "pid": 0, "tid": 0, "ts": 1.0}],
    "missing": [{"ph": "B", "name": "a", "ts": 1.0}],
    "traceEvents": {"foo": []},
    "never terminated": [{"ph": "s", "name": "f", "ts": 1.0, "id": 7,
                          "pid": 0, "tid": 0, "cat": "serving"}],
    "no open flow": [{"ph": "t", "name": "f", "ts": 1.0, "id": 7,
                      "pid": 0, "tid": 0, "cat": "serving"}],
    "started again": [
        {"ph": "s", "name": "f", "ts": 1.0, "id": 7, "pid": 0, "tid": 0,
         "cat": "serving"},
        {"ph": "s", "name": "f", "ts": 2.0, "id": 7, "pid": 0, "tid": 0,
         "cat": "serving"},
        {"ph": "f", "name": "f", "ts": 3.0, "id": 7, "pid": 0, "tid": 0,
         "cat": "serving"}],
    "has cat": [
        {"ph": "s", "name": "f", "ts": 1.0, "id": 7, "pid": 0, "tid": 0,
         "cat": "serving"},
        {"ph": "f", "name": "f", "ts": 2.0, "id": 7, "pid": 1, "tid": 0,
         "cat": "router"}],
    "missing 'id'": [{"ph": "s", "name": "f", "ts": 1.0, "pid": 0,
                      "tid": 0, "cat": "serving"}],
    "duplicate thread_name": [
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 1,
         "args": {"name": "a"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 1,
         "args": {"name": "b"}}],
}


@pytest.mark.parametrize("problem", sorted(VALIDATE_NEGATIVES))
def test_validate_trace_negatives_match_jax(problem):
  """Each malformed trace fails both validators, naming the problem."""
  for validate in (jtrace.validate_trace, ttrace.validate_trace):
    with pytest.raises(ValueError, match=problem):
      validate(VALIDATE_NEGATIVES[problem])


def test_validate_trace_per_pid_monotonic_across_interleaved_pids():
  """Merged traces interleave processes: monotonic is judged per pid."""
  events = [{"ph": "i", "name": "a", "pid": 1, "tid": 0, "ts": 5.0},
            {"ph": "i", "name": "b", "pid": 2, "tid": 0, "ts": 1.0},
            {"ph": "i", "name": "c", "pid": 1, "tid": 0, "ts": 6.0}]
  assert ttrace.validate_trace(events) == jtrace.validate_trace(events)
  with pytest.raises(ValueError, match="pid 1"):
    ttrace.validate_trace(events + [
        {"ph": "i", "name": "d", "pid": 1, "tid": 0, "ts": 2.0}])


def _strip_times(chunk):
  return [ev[:3] + ev[4:] for ev in chunk["events"]]


def test_wire_methods_match_jax():
  """``drain_wire`` / ``ingest_remote`` / ``close_remote`` /
  ``remote_summary`` on the same recorded sequence: the same chunks
  under the byte bound (oldest first, the first event always fits), the
  same rebase with the per-pid monotonic clamp, and the same synthesized
  ``E`` events closing a dead process's open spans."""
  results = {}
  for impl, tracer in zip(("jax", "port"),
                          _both_tracers(enabled=True, ring_capacity=32)):
    tracer.begin("request 0", cat="serving.request", track="serving/slot 0")
    for i in range(6):
      tracer.instant(f"tick{i}", track="serving", args={"i": i})
    first = tracer.drain_wire(max_bytes=90)
    rest = tracer.drain_wire()
    parent = type(tracer)(enabled=True, ring_capacity=32)
    wire = [["B", "request 7", "serving.request", 10.0, "serving/slot 1",
             {"uid": "7"}],
            ["i", "x", "serving", 12.0, "serving", None],
            "malformed",
            ["i", "y", "serving", 11.0, "serving", None]]
    n1 = parent.ingest_remote(4242, wire, offset_us=100.0, label="child")
    n2 = parent.ingest_remote(4242, [["i", "z", "serving", 0.0, "serving",
                                      None]], offset_us=-50.0)
    closed = parent.close_remote(4242, reason="lost")
    again = parent.close_remote(4242)
    remote = [e for e in parent.events() if e["pid"] == 4242]
    results[impl] = dict(
        first=_strip_times(first), rest=_strip_times(rest),
        dropped=(first["dropped"], rest["dropped"], tracer.pending),
        ingested=(n1, n2, closed, again),
        remote=[(e["ph"], e["name"], e["ts"], e.get("args")) for e in remote
                if e["ph"] != "M"],
        summary=parent.remote_summary())
  assert results["port"] == results["jax"]
  port = results["port"]
  assert 1 <= len(port["first"]) < 7 and port["dropped"] == (0, 0, 0)
  assert port["ingested"] == (3, 1, 1, 0)
  stamps = [ts for _, _, ts, _ in port["remote"]]
  assert stamps == sorted(stamps) and stamps[-1] == 112.0


def test_ensure_configured_follows_config_and_explicit_install_wins():
  tepl.init(tepl.Config({"observability.enabled": True,
                         "observability.ring_capacity": 128}),
            device="cpu")
  t1 = ttrace.ensure_configured()
  assert t1.enabled and t1.ring_capacity == 128
  assert ttrace.ensure_configured() is t1
  foreign = tepl.Config({"observability.enabled": True,
                         "observability.ring_capacity": 32})
  assert ttrace.ensure_configured(foreign) is t1  # no rebuild
  tepl.init(device="cpu")
  assert not ttrace.ensure_configured().enabled
  mine = ttrace.Tracer(enabled=True, ring_capacity=16)
  ttrace.install(mine)
  tepl.init(device="cpu")
  assert ttrace.ensure_configured() is mine


# ---------------------------------------------------- registry and sinks


def test_metric_registry_namespaces_and_schema_match_jax():
  """The same publish sequence through both registries reaches the sinks
  as the same records; an unknown root raises in both."""
  sinks = {}
  for impl, mod in (("jax", jregistry), ("port", tregistry)):
    sink = _ListSink()
    reg = mod.MetricRegistry(sink)
    reg.publish(1, {"loss": 0.5}, "train")
    reg.publish(1, {"tokens_per_s": 10.0}, "serving")
    reg.publish_many(2, {"train": {"loss": 0.4},
                         "resilience": {"bad_steps": 1}, "comm": {}})
    reg.publish(3, {"x": 1}, "serving/slot0")
    reg.publish(4, {"hbm_frac": 0.5}, mod.DEVICE_NAMESPACE)
    reg.add_sink_once(sink)
    reg.publish(5, {"y": 2}, mod.FLEET_NAMESPACE)
    with pytest.raises(ValueError, match="namespace"):
      reg.publish(6, {"x": 1}, "bogus")
    assert reg.latest()["train/loss"] == 0.4
    reg.close()
    assert sink.closed
    sinks[impl] = sink.records
  assert sinks["port"] == sinks["jax"]
  assert tregistry.NAMESPACES == jregistry.NAMESPACES
  flat = {"loss": 1.0, "bad_steps": 2, "comm_share": 0.1, "io_retries": 0}
  assert tregistry.split_namespaces(flat) == jregistry.split_namespaces(flat)


def test_registry_feeds_metrics_writer_and_serving_stats(tmp_path):
  """ServingStats publishes its rollup through the registry into the
  JSONL writer, as the JAX package's does."""
  lines = {}
  for impl, (stats_cls, reg_mod, writer_mod) in {
      "jax": (JaxServingStats, jregistry, jwriter),
      "port": (ServingStats, tregistry, twriter)}.items():
    path = str(tmp_path / f"{impl}.jsonl")
    stats = stats_cls(clock=iter(range(100)).__next__)
    stats.note_submitted("a")
    stats.note_admitted("a")
    stats.note_first_token("a")
    stats.note_finished("a", 3)
    stats.note_step(1, 2, 4, 1, 0.5)
    with writer_mod.MetricsWriter(path) as w:
      stats.publish(reg_mod.MetricRegistry(w), step=7)
    (line,) = [json.loads(x) for x in open(path)]
    del line["time"]
    lines[impl] = line
  assert lines["port"] == lines["jax"]
  assert lines["port"]["serving/finished_requests"] == 1.0


def test_metrics_writer_array_summary_takes_tensors_and_arrays(tmp_path):
  """Multi-element values flush as ``{shape, dtype, mean}``: numpy
  arrays as in JAX, and torch tensors (bf16 included), moved to the host
  at the flush; scalars (0-d tensors included) become floats."""
  path = str(tmp_path / "m.jsonl")
  big = np.arange(2048, dtype=np.float32).reshape(32, 64)
  with twriter.MetricsWriter(path, flush_every=4) as w:
    w.write(1, {"loss": torch.tensor(0.5), "grads_debug": big,
                "vec": torch.arange(3.0),
                "bf16": torch.ones(2, 2, dtype=torch.bfloat16),
                "note": "hello", "one": np.float32(2.0)})
    assert not open(path).read()    # buffered until the flush
  (line,) = [json.loads(x) for x in open(path)]
  assert line["loss"] == 0.5 and line["one"] == 2.0
  assert line["grads_debug"] == {"shape": [32, 64], "dtype": "float32",
                                 "mean": pytest.approx(1023.5)}
  assert line["vec"] == {"shape": [3], "dtype": "torch.float32",
                         "mean": pytest.approx(1.0)}
  assert line["bf16"]["mean"] == 1.0 and line["note"] == "hello"
  jpath = str(tmp_path / "j.jsonl")
  with jwriter.MetricsWriter(jpath) as w:
    w.write(1, {"grads_debug": big, "note": "hello"})
  (jline,) = [json.loads(x) for x in open(jpath)]
  assert jline["grads_debug"] == line["grads_debug"]


def test_tensorboard_writer_missing_dep_actionable(monkeypatch):
  monkeypatch.setitem(sys.modules, "tensorboardX", None)
  with pytest.raises(ImportError, match="tensorboardX"):
    twriter.TensorBoardWriter(logdir="/nonexistent/unused_tb")


def test_tensorboard_writer_writes_scalars_and_text(tmp_path):
  pytest.importorskip("tensorboardX")
  with twriter.TensorBoardWriter(str(tmp_path / "tb")) as w:
    w.write(1, {"serving/tokens_per_s": 3.0, "note": "x"})
  assert any(name.startswith("events.out.tfevents")
             for name in os.listdir(tmp_path / "tb"))
