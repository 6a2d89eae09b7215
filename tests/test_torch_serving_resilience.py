"""Serving resilience in the port against the JAX package's, on both
cache layouts.

The policy classes (admission ladder, bad-step policy, replica health)
against JAX's on the same signal sequences; the engine with resilience
on and no fault token-equal to resilience off; NaN steps injected with
``testing.chaos.NaNLogitsInjector`` (the model computes on NaN params,
so the verdict judges real output) retried in place or requeued with
the committed prefix, streams still equal to JAX ``generate`` and the
counters equal to the JAX engine's on the same episode; the poisoned
rows zeroed after the bad step (and shared prefix blocks untouched); a
flaky drafter, the bounded queue, and the watchdog.  fp32 throughout on
parameters bridged with ``weights.from_jax_params``.  The JAX package's
``slow`` chaos episodes are ``slow`` here too.
"""

import gc
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as epl
from easyparallellibrary_tpu.models import GPT as JaxGPT
from easyparallellibrary_tpu.models import GPTConfig as JaxGPTConfig
from easyparallellibrary_tpu.models.gpt import generate as jax_generate
from easyparallellibrary_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine, Request as JaxRequest)
from easyparallellibrary_tpu.serving import resilience as jres
from easyparallellibrary_tpu.testing import chaos as jchaos
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.runtime.resilience import StepWatchdog
from easyparallellibrary_tpu_torch.serving import (
    ContinuousBatchingEngine, NgramDrafter, Request)
from easyparallellibrary_tpu_torch.serving import resilience as tres
from easyparallellibrary_tpu_torch.testing import chaos
from easyparallellibrary_tpu_torch.weights import from_jax_params

# Tiny shapes: one intra-op thread leaves the cores to the suite's other
# worker processes.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
LAYOUTS = {"contiguous": dict(paged=False),
           "paged": dict(paged=True, block_size=4)}


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


def _oracle(model, params, prompt, max_new):
  return np.asarray(jax_generate(model, params, jnp.asarray(prompt)[None],
                                 max_new))[0]


def _res_config(**resilience):
  resilience.setdefault("enabled", True)
  return tepl.Config({"serving": {"resilience": resilience}})


class FakeClock:

  def __init__(self, t: float = 0.0):
    self.t = t

  def __call__(self) -> float:
    return self.t

  def advance(self, dt: float):
    self.t += dt


# ------------------------------------------------------------ policy units


LADDER_EPISODES = {
    # Escalation in cost order; budget_tight needs full occupancy.
    "escalate": (dict(queue_limit=8, degrade_queue_frac=0.5),
                 [(1, 1.0, 0.0), (4, 1.0, 0.0), (6, 0.5, 0.0),
                  (6, 1.0, 0.0), (8, 1.0, 0.0)]),
    # Hysteresis: one level down per observation, only well clear.
    "hysteresis": (dict(queue_limit=8, degrade_queue_frac=0.5),
                   [(8, 1.0, 0.0), (5, 1.0, 0.0), (3, 1.0, 0.0),
                    (0, 1.0, 0.0), (0, 1.0, 0.0), (6, 1.0, 0.0),
                    (6, 0.5, 0.0)]),
    # The ITL SLO forces spec_off, also on an unbounded queue.
    "itl_slo": (dict(queue_limit=0, itl_slo_s=0.01),
                [(100, 1.0, 0.0), (0, 0.5, 0.05), (0, 0.5, 0.05),
                 (0, 0.5, 0.001), (0, 0.0, 0.02)]),
}


@pytest.mark.parametrize("episode", sorted(LADDER_EPISODES))
def test_admission_ladder_matches_jax(episode):
  kw, signals = LADDER_EPISODES[episode]
  seen = {"jax": [], "port": []}
  want = jres.AdmissionController(
      **kw, on_transition=lambda o, n, s: seen["jax"].append((o, n, s)))
  got = tres.AdmissionController(
      **kw, on_transition=lambda o, n, s: seen["port"].append((o, n, s)))
  for q, occ, itl in signals:
    assert got.observe(q, occ, itl) == want.observe(q, occ, itl)
    for name in ("speculation_enabled", "budget_tightened", "transitions"):
      assert getattr(got, name) == getattr(want, name), name
    assert got.should_shed(q) == want.should_shed(q)
  assert seen["port"] == seen["jax"] and seen["port"]
  assert tres.DEGRADE_LEVELS == jres.DEGRADE_LEVELS


def test_admission_sheds_on_full_queue_before_ladder():
  for cls in (jres.AdmissionController, tres.AdmissionController):
    ctl = cls(queue_limit=2)
    assert (ctl.should_shed(1), ctl.should_shed(2)) == (False, True)
    assert ctl.level == 0 and ctl.shed_total == 0
    ctl.note_shed()
    assert ctl.shed_total == 1


def test_bad_step_policy_retry_then_requeue_then_fail_matches_jax():
  class S:
    def __init__(self):
      self.bad_streak = 0
      self.requeues = 0

  pols = [jres.BadStepPolicy(1, 1), tres.BadStepPolicy(1, 1)]
  slots = [{0: S(), 1: S()}, {0: S(), 1: S()}]
  script = [([0], None), ([0], None), ("requeued", None), ([0], {0, 1}),
            ([1], {1}), ([0], {0}), ([], {1}), ([], None)]
  for bad, exercised in script:
    if bad == "requeued":
      for sl in slots:
        sl[0].requeues, sl[0].bad_streak = 1, 0
      continue
    got = pols[1].judge(slots[1], bad, exercised=exercised)
    assert got == pols[0].judge(slots[0], bad, exercised=exercised)
    assert [s.bad_streak for s in slots[1].values()] == [
        s.bad_streak for s in slots[0].values()]
  assert pols[1].counters() == pols[0].counters()
  assert pols[1].counters()["failed_requests"] == 1


def test_replica_health_matches_jax():
  clocks = [FakeClock(), FakeClock()]
  seen = [[], []]
  hs = [cls(suspect_after=1.0, down_after=3.0, clock=c,
            on_transition=lambda o, n, r, i=i: seen[i].append((o, n, r)))
        for i, (cls, c) in enumerate(zip(
            (jres.ReplicaHealth, tres.ReplicaHealth), clocks))]
  script = [("advance", 1.5), ("observe",), ("beat", 0, 0), ("observe",),
            ("beat", 1, 0), ("beat", 1, 0), ("advance", 3.5), ("observe",),
            ("probe",), ("advance", 3.0), ("probe",), ("rejoin",),
            ("beat", 1, 2), ("mark_down",), ("rejoin",), ("drain",),
            ("advance", 10.0), ("observe",)]
  for op in script:
    results = []
    for h, c in zip(hs, clocks):
      if op[0] == "advance":
        c.advance(op[1])
      elif op[0] == "beat":
        h.beat(watchdog_timeouts=op[1], bad_steps=op[2])
      elif op[0] == "probe":
        results.append(h.can_probe())
      else:
        results.append(getattr(h, op[0])())
    assert results[:1] == results[1:], op
    assert hs[1].state == hs[0].state and hs[1].trips == hs[0].trips, op
  assert seen[1] == seen[0] and len(seen[1]) >= 5
  assert tres.HEALTH_STATES == jres.HEALTH_STATES


def test_watchdog_fires_once_per_arm_and_its_thread_ends_on_close():
  fired = []
  dog = StepWatchdog(0.01, on_timeout=fired.append)
  dog.arm(7)
  for _ in range(500):                   # up to 5 s on a loaded machine
    if fired:
      break
    threading.Event().wait(0.01)
  dog.disarm()
  dog.timeout_s = 60.0                   # a step that ends in time
  dog.arm(8)
  dog.disarm()
  assert fired == [7] and dog.timeouts_fired == 1
  thread = dog._thread
  dog.close()
  assert not thread.is_alive()


# ----------------------------------------------------------- the engine --


def _engine(tmodel, tparams, layout, **kw):
  kw.setdefault("num_slots", 2)
  kw.setdefault("prefill_chunk", 4)
  return ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                  **LAYOUTS[layout], **kw)


@pytest.mark.quick
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fault_free_resilient_engine_token_equal(layout):
  """Resilience on with no fault is a no-op: streams token-equal to the
  same engine with resilience off and to JAX ``generate``, no bad step,
  the verdict fetched with the tokens."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3, 9, 2))
  max_new = (6, 7, 4, 5)

  def drive(resilient):
    eng = _engine(tmodel, tparams, layout, resilience=resilient)
    for i in range(2):
      eng.submit(Request(uid=i, prompt=prompts[i],
                         max_new_tokens=max_new[i]))
    out = {}
    for _ in range(2):
      for fin in eng.step():
        out[fin.uid] = fin.tokens
    for i in range(2, 4):
      eng.submit(Request(uid=i, prompt=prompts[i],
                         max_new_tokens=max_new[i]))
    out.update(eng.run())
    return eng, out

  (base_eng, base), (eng, res) = drive(False), drive(True)
  assert base_eng._bad_policy is None and eng.stats is not None
  assert eng._bad_policy.counters() == {"bad_steps": 0, "step_retries": 0,
                                        "requeues": 0, "failed_requests": 0}
  assert eng.steps == base_eng.steps
  for i in range(4):
    np.testing.assert_array_equal(res[i], base[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(
        res[i], _oracle(jmodel, jparams, prompts[i], max_new[i]))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_nan_step_retried_in_place_equal_jax(layout):
  """A transient NaN step (call 2) is retried in place: streams equal to
  JAX ``generate``, exactly the poisoned call seen by the injector, one
  bad step, and every counter equal to the JAX engine's on the same
  episode."""
  epl.init()
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3))
  eng = _engine(tmodel, tparams, layout, resilience=True)
  inj = chaos.NaNLogitsInjector(eng, bad_calls=(2,))
  jeng = JaxEngine(jmodel, jparams, num_slots=2, prefill_chunk=4,
                   resilience=True, **LAYOUTS[layout])
  jinj = jchaos.NaNLogitsInjector(jeng, bad_calls=(2,))
  for e, cls in ((eng, Request), (jeng, JaxRequest)):
    for i, p in enumerate(prompts):
      e.submit(cls(uid=i, prompt=p, max_new_tokens=6))
  out, jout = eng.run(), jeng.run()
  assert inj.poisoned == jinj.poisoned == [2]
  assert inj.calls == jinj.calls == eng.steps
  assert eng.stats.bad_steps == 1 and eng.stats.step_retries >= 1
  assert eng._bad_policy.counters() == jeng._bad_policy.counters()
  for i, p in enumerate(prompts):
    assert eng.finished[i].finish_reason == "length"
    np.testing.assert_array_equal(out[i], jout[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(out[i], _oracle(jmodel, jparams, p, 6))


@pytest.mark.slow
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_persistent_nan_requeues_and_replays_prefix_exact(layout):
  """Two adjacent bad calls exceed ``max_step_retries=1``: the request is
  requeued with its committed prefix and replays it exactly."""
  jmodel, jparams, tmodel, tparams = _models()
  (p,) = _prompts((5,))
  eng = _engine(tmodel, tparams, layout, resilience=True)
  inj = chaos.NaNLogitsInjector(eng, bad_calls=(2, 3))
  eng.submit(Request(uid="q", prompt=p, max_new_tokens=6))
  out = eng.run()
  assert inj.poisoned == [2, 3]
  assert eng.stats.requeues == 1 and eng.stats.bad_steps == 2
  assert eng.finished["q"].finish_reason == "length"
  np.testing.assert_array_equal(out["q"], _oracle(jmodel, jparams, p, 6))


@pytest.mark.slow
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_requeue_overflow_fails_request_not_batch(layout):
  jmodel, jparams, tmodel, tparams = _models()
  bad_p, good_p = _prompts((5, 3), seed=7)
  eng = _engine(tmodel, tparams, layout, num_slots=1,
                config=_res_config(max_step_retries=0, max_requeues=0))
  chaos.NaNLogitsInjector(eng, bad_calls=(1,))
  eng.submit(Request(uid="bad", prompt=bad_p, max_new_tokens=6))
  eng.submit(Request(uid="good", prompt=good_p, max_new_tokens=6))
  out = eng.run()
  assert eng.finished["bad"].finish_reason == "failed"
  assert eng.finished["good"].finish_reason == "length"
  np.testing.assert_array_equal(out["good"],
                                _oracle(jmodel, jparams, good_p, 6))


@pytest.mark.slow
def test_hung_step_trips_watchdog_outputs_exact():
  jmodel, jparams, tmodel, tparams = _models()
  (p,) = _prompts((4,))
  with _engine(tmodel, tparams, "contiguous", num_slots=1,
               config=_res_config(step_timeout_s=0.05)) as eng:
    inj = chaos.HangingStepInjector(eng, hang_calls=(1,), hang_s=0.4)
    eng.submit(Request(uid="h", prompt=p, max_new_tokens=5))
    out = eng.run()
  assert inj.hangs == 1 and eng.stats.watchdog_timeouts >= 1
  np.testing.assert_array_equal(out["h"], _oracle(jmodel, jparams, p, 5))


@pytest.mark.slow
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", ["raise", "garbage"])
def test_flaky_drafter_never_changes_streams(mode, layout):
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3), seed=2)
  eng = _engine(tmodel, tparams, layout, resilience=True,
                drafter=chaos.FlakyDrafter(NgramDrafter(k=2),
                                           bad_calls=(1, 3), mode=mode))
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
  out = eng.run()
  assert eng.drafter.faults == 2
  assert (eng.drafter_failures == 2) == (mode == "raise")
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(out[i], _oracle(jmodel, jparams, p, 8),
                                  err_msg=f"req {i} ({mode})")


@pytest.mark.slow
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bounded_queue_sheds_at_submit(layout):
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((3, 4, 3, 5), seed=5)
  eng = _engine(tmodel, tparams, layout, num_slots=1, max_batch=1,
                config=_res_config(queue_limit=2))
  accepted = [eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
              for i, p in enumerate(prompts)]
  assert accepted == [True, True, False, False]
  assert [eng.finished[i].finish_reason for i in (2, 3)] == ["shed"] * 2
  assert eng.stats.shed_requests == 2
  with pytest.raises(ValueError):        # malformed raises whatever the load
    eng.submit(Request(uid=9, prompt=np.zeros((0,), np.int32),
                       max_new_tokens=4))
  out = eng.run()
  assert sorted(out) == [0, 1]
  for i in (0, 1):
    np.testing.assert_array_equal(
        out[i], _oracle(jmodel, jparams, prompts[i], 4), err_msg=f"req {i}")


@pytest.mark.slow
def test_stale_shed_level_clears_on_idle_submit():
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((3, 4, 3, 5), seed=7)
  eng = _engine(tmodel, tparams, "contiguous", num_slots=1, max_batch=1,
                config=_res_config(queue_limit=2, degrade_queue_frac=0.25))
  eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=4))
  eng.step()
  eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=4))
  eng.submit(Request(uid=3, prompt=prompts[3], max_new_tokens=4))
  eng.step()
  assert eng._admission.level == 3
  assert eng.cancel(1) and eng.cancel(3) and eng.cancel(0)
  assert not eng.has_work
  assert eng.submit(Request(uid="fresh", prompt=prompts[2],
                            max_new_tokens=4))
  np.testing.assert_array_equal(
      eng.run()["fresh"], _oracle(jmodel, jparams, prompts[2], 4))


def test_the_ladder_switches_speculation_off_and_clamps_the_budget():
  """An ITL SLO the CPU cannot meet holds the ladder at spec_off: the
  drafter is skipped from the next plan on, and the streams stay exact;
  at budget_tight the scheduler's budget is clamped to one chunk."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3), seed=3)
  eng = _engine(tmodel, tparams, "contiguous", prefill_chunk=8,
                drafter=NgramDrafter(k=2),
                config=_res_config(itl_slo_s=1e-9))
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
  out = eng.run()
  assert eng._admission.level == 1 and not eng.scheduler.spec_enabled
  assert eng.stats.degraded_level == 1
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(out[i], _oracle(jmodel, jparams, p, 8))
  eng._admission.floor_level = 2          # hold the ladder at budget_tight
  eng._apply_degradation()
  assert eng._admission.budget_tightened
  assert eng.scheduler._effective_budget() == eng.chunk


# ------------------------------------------------------------- sanitize --


def _step_until_poisoned(eng, inj):
  while not inj.poisoned:
    eng.step()


def test_sanitize_zeroes_the_bad_slots_rows_from_the_cursor():
  """Contiguous: right after the bad step (call 3, a decode step of both
  slots), each retried slot's rows from its committed cursor up are
  zero in every layer, the rows below hold its committed K/V, and the
  whole cache is finite."""
  _, _, tmodel, tparams = _models()
  prompts = _prompts((5, 7), seed=1)
  eng = _engine(tmodel, tparams, "contiguous", resilience=True)
  inj = chaos.NaNLogitsInjector(eng, bad_calls=(3,))
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
  _step_until_poisoned(eng, inj)
  cursors = eng._cursors.numpy()
  assert eng.stats.bad_steps == 1 and cursors.min() > 0
  for layer in eng._kv.values():
    for leaf in layer["attn"].values():
      assert bool(torch.isfinite(leaf).all())
      for slot, cur in enumerate(cursors):
        assert not leaf[slot, cur:].any()
        assert bool((leaf[slot, :cur].abs().sum(dim=(1, 2)) > 0).all())
  out = eng.run()
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(
        out[i], tgpt.generate(tmodel, tparams,
                              torch.from_numpy(p[None]).long(), 6)[0])


def test_sanitize_paged_zeroes_above_the_watermark_keeps_shared_prefix():
  """Paged with the prefix cache: a warm request maps two shared blocks;
  a NaN step during its decode zeroes its blocks from the watermark up
  and the null block, and leaves the shared prefix blocks (wholly below
  the watermark) bit-identical."""
  _, _, tmodel, tparams = _models()
  shared = np.arange(1, 9, dtype=np.int32)            # two 4-row blocks
  eng = _engine(tmodel, tparams, "paged", resilience=True,
                prefix_cache=True)
  eng.submit(Request(uid="a", prompt=np.concatenate([shared, [30, 31]]),
                     max_new_tokens=3))
  eng.run()
  eng.submit(Request(uid="b", prompt=np.concatenate([shared, [40]]),
                     max_new_tokens=6))
  eng.step()                                          # warm prefill
  slot = next(iter(eng.scheduler.active))
  blocks = eng.scheduler.slot_blocks(slot)
  assert eng.scheduler.prefix_hits == 1 and len(blocks) >= 3
  before = {name: {leaf: t.clone() for leaf, t in layer["attn"].items()}
            for name, layer in eng._kv.items()}
  inj = chaos.NaNLogitsInjector(eng, bad_calls=(0,))  # the next call
  plan_pos = eng.scheduler._resident_tokens(eng.scheduler.active[slot])
  eng.step()                                          # poisoned decode
  assert inj.poisoned == [0] and eng.stats.bad_steps == 1
  bs = eng.block_size
  for name, layer in eng._kv.items():
    for leaf, t in layer["attn"].items():
      assert bool(torch.isfinite(t).all())
      assert not t[0].any()                           # the null block
      for j, blk in enumerate(blocks):
        lo = max(0, plan_pos - j * bs)
        if (j + 1) * bs <= plan_pos:
          assert torch.equal(t[blk], before[name][leaf][blk]), (j, blk)
        else:
          assert not t[blk, lo:].any(), (j, blk)
          assert torch.equal(t[blk, :lo], before[name][leaf][blk, :lo])
  out = eng.run()
  prompt_b = np.concatenate([shared, [40]]).astype(np.int32)
  np.testing.assert_array_equal(
      out["b"], tgpt.generate(tmodel, tparams,
                              torch.from_numpy(prompt_b[None]).long(), 6)[0])


def test_a_discarded_engine_leaves_no_watchdog_thread():
  _, _, tmodel, tparams = _models()

  def watchdogs():
    return [t for t in threading.enumerate()
            if t.name == "epl-step-watchdog" and t.is_alive()]

  start = len(watchdogs())
  eng = _engine(tmodel, tparams, "contiguous",
                config=_res_config(step_timeout_s=30.0))
  eng.submit(Request(uid=0, prompt=np.arange(3, dtype=np.int32),
                     max_new_tokens=2))
  eng.run()
  assert len(watchdogs()) == start + 1
  del eng
  gc.collect()
  assert len(watchdogs()) == start
