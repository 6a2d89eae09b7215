"""The port's engine autotuner (``serving/autotune.py``) and the
scheduler's clamps against the JAX package's.

The ladder's policy runs on both packages' ``EngineAutotuner`` over one
scripted breach / recovery stream, with a real scheduler and admission
ladder behind a duck-typed engine: each step the two show the same level
and knobs (escalation, sustain, stale breach, the spec_trim floor, scope
matching).  A tiny fp32 paged engine with the n-gram drafter and the
autotuner on, under an overload burst, makes the JAX engine's actuations
step for step, and its streams are token-equal to the JAX engine's and
to JAX ``generate``.  The plans it builds at each level (drafts trimmed
below k, the prefill budget clamped, fewer live slots) tile as brute
force says and the tiled kernel's arithmetic over them equals the plain
version.
"""

import importlib
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
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.weights import from_jax_params
from test_torch_paged_attention import _check_runs, _emulate_tiled

torch.set_num_threads(1)

PACKAGES = ("easyparallellibrary_tpu", "easyparallellibrary_tpu_torch")
TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=64)
PAGED = dict(num_slots=4, prefill_chunk=8, paged=True, block_size=4)
BURST_CONF = {
    "serving": {"resilience": {"enabled": True, "queue_limit": 3},
                "autotune": {"enabled": True, "hold_steps": 3}},
    "observability": {"slo": {
        "enabled": True, "shed_objective": 0.5, "fast_window": 2,
        "slow_window": 3, "fast_burn": 1.0, "slow_burn": 1.0}},
}


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
  """The monitor's actuation events without their wall stamps, JSON
  round-tripped (the form ``sim.fleet.actuation_sequence`` compares)."""
  seq = [{k: v for k, v in ev.items() if k != "time"}
         for ev in monitor.events if ev.get("event") == "actuation"]
  return json.loads(json.dumps(seq, default=str))


# ------------------------------------------------- the ladder's policy


class _FakeEngine:
  """What the tuner reads of an engine: a real scheduler and admission
  ladder of ``pkg`` behind the engine's attribute names."""

  def __init__(self, pkg, spec_k=4, num_slots=4, queue_limit=8):
    self.scheduler = _mod(pkg, "serving.scheduler").FCFSScheduler(
        num_slots=num_slots, prefill_chunk=8, max_seq_len=32,
        spec_k=spec_k)
    self.chunk = 8
    self._admission = _mod(pkg, "serving.resilience").AdmissionController(
        queue_limit=queue_limit)
    self._twin_label = "serving/fused_step"
    self._track_prefix = "serving"


def _burn_monitor(pkg):
  slo = _mod(pkg, "observability.slo")
  return slo.SLOMonitor([slo.BurnRateRule(
      "shed_burn", bad="shed", good="finished_requests", objective=0.5,
      fast_window=2, slow_window=3, fast_burn=1.0, slow_burn=1.0)])


class _BurnFeed:
  """Monotone cumulative shed / finished counters fed to a monitor."""

  def __init__(self, mon):
    self.mon, self.i, self.shed, self.good = mon, 0, 0.0, 1.0

  def drive(self, records, shed_step=5.0, good_step=0.0):
    for _ in range(records):
      self.shed += shed_step
      self.good += good_step
      self.mon.observe(self.i, {"serving/shed": self.shed,
                                "serving/finished_requests": self.good})
      self.i += 1


def _knobs(eng):
  s = eng.scheduler
  return (s.tune_spec_k, s.tune_budget, s.tune_slot_cap,
          s.effective_spec_k, s.effective_max_batch,
          s._effective_budget(), eng._admission.floor_level)


def _escalate_sustain_recover(pkg):
  cfg = _mod(pkg, "config").Config(
      {"serving": {"autotune": {"enabled": True, "hold_steps": 5}}})
  mon = _burn_monitor(pkg)
  eng = _FakeEngine(pkg)
  tuner = _mod(pkg, "serving.autotune").EngineAutotuner(eng, mon,
                                                        config=cfg)
  feed = _BurnFeed(mon)
  trace = []
  tuner.on_step(0)
  trace.append((tuner.level, _knobs(eng)))
  feed.drive(5)
  for s in range(0, 20):
    tuner.on_step(s)
    trace.append((tuner.level, _knobs(eng)))
  floor_obs = eng._admission.observe(0, 0.0)
  feed.drive(4, shed_step=0.0, good_step=10.0)
  clear = mon.breached_streams() == []
  for s in range(20, 60):
    tuner.on_step(s)
    trace.append((tuner.level, _knobs(eng)))
  return {"trace": trace, "floor_obs": floor_obs, "clear": clear,
          "actuations": tuner.actuations, "heard": tuner.breaches_heard,
          "monitor_actuations": mon.actuations,
          "events": _actuations(mon)}


def test_autotuner_escalates_sustains_and_recovers_as_jax():
  """One breach, a sustained stream, then recovery: the same level and
  knobs every step in both packages; up to slot_cap through spec_trim
  (k = 4 -> 2) and budget_tight, the admission floor pinned, then back
  down one level per clean hold window to every clamp released."""
  jax_run, port = (_escalate_sustain_recover(p) for p in PACKAGES)
  assert port == jax_run
  levels = [lvl for lvl, _ in port["trace"]]
  assert levels[0] == 0 and levels[1] == 1 and max(levels) == 3
  top = next(k for lvl, k in port["trace"] if lvl == 3)
  assert top == (0, 8, 2, 0, 2, 8, 1)
  assert port["floor_obs"] == 1 and port["clear"]
  assert port["trace"][-1] == (0, (-1, 0, 0, 4, 4, 0, 0))
  assert port["actuations"] == port["monitor_actuations"] == 6
  assert port["heard"] == 1


def _live_and_stale(pkg, live):
  cfg = _mod(pkg, "config").Config({"serving": {"autotune": {
      "enabled": True, "hold_steps": 2, "max_level": 1}}})
  mon = _burn_monitor(pkg)
  eng = _FakeEngine(pkg)
  tuner = _mod(pkg, "serving.autotune").EngineAutotuner(eng, mon,
                                                        config=cfg)
  feed = _BurnFeed(mon)
  feed.drive(5)
  tuner.on_step(0)
  levels = [tuner.level]
  for s in range(1, 2 * tuner.stale_steps + 5):
    if live:
      feed.drive(1)            # the overload goes on: records flow
    tuner.on_step(s)
    levels.append(tuner.level)
  return {"levels": levels, "breached": bool(mon.breached_streams()),
          "events": _actuations(mon)}


@pytest.mark.parametrize("live", [True, False], ids=["live", "stale"])
def test_autotuner_live_breach_holds_and_stale_breach_releases(live):
  """A breach whose records keep flowing holds spec_trim for good; one
  whose records stopped (an idle engine) goes stale and the tuner climbs
  down.  Same levels step for step in both packages."""
  jax_run, port = (_live_and_stale(p, live) for p in PACKAGES)
  assert port == jax_run
  assert port["breached"]
  if live:
    assert set(port["levels"]) == {1}
  else:
    assert port["levels"][0] == 1 and port["levels"][-1] == 0


def test_autotuner_spec_trim_floor_and_scope_matching_as_jax():
  """spec_trim floors at one draft (k = 1 keeps it, k = 0 a no-op); a
  breach concerns an engine by its twin label or namespace, never the
  fleet's or a sibling replica's."""
  probes = [{"metric": "serving/replica0/ttft_p99_s"},
            {"metric": "serving/itl_p99_s"},
            {"twin": "serving/replica0/fused_step"},
            {"metric": "serving/replica1/ttft_p99_s"},
            {"metric": "serving/fleet/ttft_p99_s"},
            {"twin": "serving/replica1/fused_step"},
            {"metric": "train/loss"}, {}, {"metric": "serving/ttft_p99_s"}]
  seen = []
  for pkg in PACKAGES:
    cfg = _mod(pkg, "config").Config(
        {"serving": {"autotune": {"enabled": True}}})
    tune = _mod(pkg, "serving.autotune").EngineAutotuner
    floors = [tune(_FakeEngine(pkg, spec_k=k), None,
                   config=cfg)._level_knobs(lvl)["tune_spec_k"]
              for k in (1, 0, 4) for lvl in (1, 2)]
    rep = _FakeEngine(pkg)
    rep._track_prefix = "serving/replica0"
    rep._twin_label = "serving/replica0/fused_step"
    scoped = tune(rep, None, config=cfg)
    bare = tune(_FakeEngine(pkg), None, config=cfg)
    seen.append((floors, [scoped._matches(p) for p in probes],
                 [bare._matches(p) for p in probes]))
  assert seen[0] == seen[1]
  floors, scoped, bare = seen[1]
  assert floors == [1, 0, 0, 0, 2, 0]
  assert scoped == [True, True, True, False, False, False, False, False,
                    True]
  assert bare == [False, True, False, False, False, False, False, False,
                  True]


def test_scheduler_clamps_and_the_ladder_are_separate_gates():
  """``spec_enabled`` (the degradation ladder) and ``tune_spec_k`` (the
  autotuner's clamp) gate drafting separately, as in the JAX package:
  the clamp trims ``effective_spec_k`` while the ladder keeps it, and
  switching the ladder off plans no drafts whatever the clamp says."""
  seen = []
  for pkg in PACKAGES:
    sched_mod = _mod(pkg, "serving.scheduler")
    sched = sched_mod.FCFSScheduler(
        num_slots=3, prefill_chunk=8, max_seq_len=32, spec_k=4,
        block_size=4, num_blocks=25, token_budget=3 + 8)
    for i in range(3):
      sched.submit(sched_mod.Request(uid=i, prompt=np.arange(
          1, 4 + i, dtype=np.int32), max_new_tokens=12))
    caps = []
    for knobs in ((-1, True), (2, True), (0, True), (-1, False),
                  (3, False), (-1, True)):
      sched.tune_spec_k, sched.spec_enabled = knobs
      plan = sched.plan_step()
      caps.append((sched.effective_spec_k, plan.draft_cap.tolist()))
      sched.commit(np.ones((3,), np.int32))
    sched.tune_slot_cap, sched.tune_budget = 1, 2
    seen.append((caps, sched.effective_max_batch, sched._effective_budget()))
  assert seen[0] == seen[1]
  caps = seen[1][0]
  assert [k for k, _ in caps] == [4, 2, 0, 4, 3, 4]
  assert max(caps[1][1]) == 2 and not any(caps[2][1])
  assert not any(caps[3][1]) and not any(caps[4][1])
  assert max(caps[5][1]) == 4
  assert seen[1][1:] == (1, 2)


# --------------------------------------------- a tiny engine under a burst


def _models():
  jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  return jmodel, jparams, tmodel, from_jax_params(tree, device="cpu")


def _burst_prompts():
  r = np.random.RandomState(0)
  # Repeated spans, so the n-gram drafter proposes and trimming shows.
  return [np.tile(r.randint(0, 64, (3,)), 3).astype(np.int32)
          for _ in range(40)]


def _drive_burst(eng, request_cls, plans=None):
  """Four waves of six submits against a queue limit of 3 (the excess is
  shed), three steps after each, the backlog drained, then twelve light
  requests one by one while the ladder climbs down.  Returns the
  finished requests, the level after each step and (``plans``) each
  step's plan with its level."""
  prompts = _burst_prompts()
  out, levels = {}, []
  if plans is not None:
    plan_step = eng.scheduler.plan_step

    def capture():
      plan = plan_step()
      if plan is not None:
        plans.append((eng._autotuner.level, plan))
      return plan
    eng.scheduler.plan_step = capture

  def step():
    for fin in eng.step():
      out[fin.uid] = fin
    levels.append(eng._autotuner.level)

  uid = 0
  for _ in range(4):
    for _ in range(6):
      if not eng.submit(request_cls(uid=uid, prompt=prompts[uid],
                                    max_new_tokens=10)):
        out[uid] = eng.finished[uid]
      uid += 1
    for _ in range(3):
      step()
  while eng.has_work:
    step()
  for k in range(12):
    eng.submit(request_cls(uid=uid, prompt=prompts[k], max_new_tokens=6))
    uid += 1
    while eng.has_work:
      step()
  return out, levels


def _port_burst_engine(tmodel, tparams):
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, NgramDrafter)
  config = tepl.Config(BURST_CONF)
  tepl.init(config, device="cpu")
  return ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                  drafter=NgramDrafter(k=4),
                                  config=config, **PAGED)


@pytest.mark.quick
def test_paged_engine_under_a_burst_actuates_as_jax_and_stays_exact():
  """The slice's engine pin: the port's paged engine with the n-gram
  drafter and the autotuner climbs spec_trim, budget_tight and slot_cap
  and back on the step the JAX engine does, with the same knobs; the
  same requests are shed; every other stream equals the JAX engine's and
  JAX ``generate``; no kernel library is loaded by an actuation."""
  from easyparallellibrary_tpu.observability import slo as jslo
  from easyparallellibrary_tpu.serving import (
      ContinuousBatchingEngine as JaxEngine, NgramDrafter as JaxNgram,
      Request as JaxRequest)
  from easyparallellibrary_tpu_torch.observability import slo as tslo
  from easyparallellibrary_tpu_torch.serving import Request
  jmodel, jparams, tmodel, tparams = _models()
  jconfig = jepl.Config(BURST_CONF)
  jepl.init(jconfig)
  jeng = JaxEngine(jmodel, jparams, drafter=JaxNgram(k=4), config=jconfig,
                   **PAGED)
  want, jlevels = _drive_burst(jeng, JaxRequest)
  libs = _build.loaded_count()
  eng = _port_burst_engine(tmodel, tparams)
  got, levels = _drive_burst(eng, Request)
  assert _build.loaded_count() == libs
  assert eng._compile_sentinel.recompiles == 0
  assert levels == jlevels and max(levels) == 3 and levels[-1] == 0
  events = _actuations(tslo.get_monitor())
  assert events == _actuations(jslo.get_monitor())
  assert [e["to_level"] for e in events] == [
      "spec_trim", "budget_tight", "slot_cap", "budget_tight",
      "spec_trim", "normal"]
  assert sorted(got) == sorted(want)
  shed = [u for u, f in got.items() if f.finish_reason == "shed"]
  assert shed and shed == [u for u, f in want.items()
                           if f.finish_reason == "shed"]
  prompts = _burst_prompts()
  served = [u for u, f in got.items() if f.finish_reason == "length"]
  for uid, fin in got.items():
    assert fin.finish_reason == want[uid].finish_reason
    np.testing.assert_array_equal(fin.tokens, want[uid].tokens,
                                  err_msg=f"req {uid}")
    # JAX generate costs about a second a call here: the first six
    # served streams stand for the rest (each equals the JAX engine's).
    if uid in served[:6]:
      prompt = prompts[uid] if uid < 24 else prompts[uid - 24]
      oracle = np.asarray(jax_generate(
          jmodel, jparams, jnp.asarray(prompt)[None], fin.new_tokens))[0]
      np.testing.assert_array_equal(fin.tokens, oracle,
                                    err_msg=f"req {uid}")


def test_plans_at_every_level_tile_as_brute_force_says():
  """Each plan the burst engine builds, at each level: the planner's
  tiles (with the plan's draft runs) cover every flat token once, one
  slot per tile, and the tiled kernel's arithmetic over them equals the
  plain version on a random pool.  spec_trim plans drafts of at most 2
  (k = 4), budget_tight none and at most one chunk of prefill, slot_cap
  admits nothing while 2 or more slots are live."""
  from easyparallellibrary_tpu_torch.serving import Request
  _, _, tmodel, tparams = _models()
  eng = _port_burst_engine(tmodel, tparams)
  plans = []
  _drive_burst(eng, Request, plans)
  by_level = {}
  for level, plan in plans:
    by_level.setdefault(level, []).append(plan)
  assert sorted(by_level) == [0, 1, 2, 3]
  assert max(int(p.draft_cap.max()) for p in by_level[0]) == 4
  assert max(int(p.draft_cap.max()) for p in by_level[1]) == 2
  for level in (2, 3):
    assert all(not p.draft_cap.any() for p in by_level[level])
    assert all(p.prefill_tokens <= PAGED["prefill_chunk"]
               for p in by_level[level])
  # The slot cap gates admission: live slots only fall while above it.
  live = [p.active_slots for p in by_level[3]]
  assert all(b <= max(a, 2) for a, b in zip(live, live[1:]))
  assert live[-1] <= 2 < live[0]
  r = np.random.RandomState(0)
  NB, bs, H, hd = eng.num_blocks, PAGED["block_size"], 2, 8
  kp, vp = (torch.from_numpy(r.randn(NB, bs, H, hd).astype(np.float32))
            for _ in range(2))
  for level, level_plans in sorted(by_level.items()):
    for plan in level_plans[:6]:
      tables_tok = plan.block_tables[plan.slot_ids]
      positions = plan.positions
      runs = pa.tile_runs_from_plan(plan.base_idx, plan.num_valid,
                                    len(positions), plan.draft_base,
                                    plan.draft_cap)
      _check_runs(runs, tables_tok, positions)
      items, _ = pa.work_items(runs, positions, tables_tok.shape[1], bs)
      q = torch.from_numpy(r.randn(len(positions), H, hd).astype(
          np.float32))
      tables, pos = torch.from_numpy(tables_tok), torch.from_numpy(
          positions)
      torch.testing.assert_close(
          _emulate_tiled(q, kp, vp, tables, pos, items),
          pa.paged_attention_reference(q, kp, vp, tables, pos),
          rtol=1e-5, atol=1e-5, msg=f"level {level}")
