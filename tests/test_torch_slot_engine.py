"""The port's contiguous-slot engine (the default serving layout) against
the JAX package's.

The slot cache's geometry, ``slot_step_logits`` and the scheduler's slot
plans against JAX; greedy streams of the engine (``device="cpu"``,
default ``serving.*`` config, ``paged=False``) token-equal to the JAX
engine with ``paged=False`` and to JAX ``generate`` through staggered
admission, slot reuse and a stop token; and its speculative twins (the
n-gram drafter and a draft model on the slot layout) token-equal to
JAX's.  fp32 throughout, on parameters bridged with
``weights.from_jax_params``.
"""

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
from easyparallellibrary_tpu.models.gpt import (
    slot_step_logits as jax_slot_step_logits)
from easyparallellibrary_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine,
    DraftModelDrafter as JaxDraftModelDrafter, FCFSScheduler as JaxScheduler,
    NgramDrafter as JaxNgramDrafter, Request as JaxRequest)
from easyparallellibrary_tpu.serving import kv_cache as jkv
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
from easyparallellibrary_tpu_torch.serving import (
    ContinuousBatchingEngine, DraftModelDrafter, FCFSScheduler,
    NgramDrafter, Request, StepPlan)
from easyparallellibrary_tpu_torch.serving import kv_cache as tkv
from easyparallellibrary_tpu_torch.weights import from_jax_params

# Tiny shapes: one intra-op thread leaves the cores to the suite's other
# worker processes.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
SLOTS = dict(num_slots=3, prefill_chunk=4, paged=False)
PROMPT_LENS = (5, 3, 9, 1, 6, 2)
MAX_NEW = (6, 7, 8, 4, 5, 9)


def _models(seed=0):
  jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  return jmodel, jparams, tmodel, from_jax_params(tree, device="cpu")


def _prompts(lengths, seed=0, repeat=1):
  r = np.random.RandomState(seed)
  return [np.tile(r.randint(0, 64, (n,)).astype(np.int32), repeat)
          for n in lengths]


def _oracle(model, params, prompt, max_new):
  return np.asarray(jax_generate(model, params, jnp.asarray(prompt)[None],
                                 max_new))[0]


def _drive_staggered(engine, request_cls, prompts, max_new):
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


# ------------------------------------------------------------ the cache --


@pytest.mark.parametrize("num_slots,chunk,dtype", [
    (3, 4, "float32"), (8, 16, "bfloat16"), (1, 1, "float16")])
def test_allocate_kv_cache_and_cache_bytes_match_jax(num_slots, chunk,
                                                     dtype):
  jcfg = JaxGPTConfig(**TINY, dtype=getattr(jnp, dtype))
  tcfg = tgpt.GPTConfig(**TINY, dtype=getattr(torch, dtype))
  jkv_tree, jcur = jkv.allocate_kv_cache(jcfg, num_slots, chunk)
  tkv_tree, tcur = tkv.allocate_kv_cache(tcfg, num_slots, chunk,
                                         device="cpu")
  assert tkv_tree.keys() == jkv_tree.keys()
  for name, layer in tkv_tree.items():
    for leaf, t in layer["attn"].items():
      want = jkv_tree[name]["attn"][leaf]
      assert tuple(t.shape) == want.shape
      assert str(t.dtype) == f"torch.{np.dtype(want.dtype).name}"
      assert not t.any()
  assert tcur.dtype == torch.int32 and tuple(tcur.shape) == jcur.shape
  assert tkv.cache_length(tcfg, chunk) == jkv.cache_length(jcfg, chunk)
  assert tkv.cache_bytes(tcfg, num_slots, chunk) == jkv.cache_bytes(
      jcfg, num_slots, chunk)


def test_slot_step_logits_matches_jax():
  """Two chained calls at per-slot cursors (a prefill chunk from 0 for
  slot 0, chunks at cursors 5 and 11 for slots 1 and 2 over a filled
  cache): logits and every cache leaf within fp32 rtol/atol 1e-5."""
  jmodel, jparams, tmodel, tparams = _models(seed=1)
  r = np.random.RandomState(2)
  C = 4
  tcache, _ = tkv.allocate_kv_cache(tmodel.cfg, 3, C, device="cpu")
  jcache = {}
  for name, layer in tcache.items():
    jcache[name] = {"attn": {}}
    for leaf, t in layer["attn"].items():
      fill = r.randn(*t.shape).astype(np.float32) * 0.3
      t.copy_(torch.from_numpy(fill))
      jcache[name]["attn"][leaf] = jnp.asarray(fill)
  for cursors in ([0, 5, 11], [4, 9, 12]):
    tokens = r.randint(0, 64, (3, C)).astype(np.int32)
    want, jcache = jax_slot_step_logits(
        jmodel, jparams, jcache, jnp.asarray(tokens),
        jnp.asarray(cursors, jnp.int32))
    with torch.no_grad():
      got, tcache = tgpt.slot_step_logits(
          tmodel, tparams, tcache, torch.from_numpy(tokens),
          torch.tensor(cursors, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
  for name, layer in tcache.items():
    for leaf, t in layer["attn"].items():
      np.testing.assert_allclose(t.numpy(),
                                 np.asarray(jcache[name]["attn"][leaf]),
                                 rtol=1e-5, atol=1e-5,
                                 err_msg=f"{name}/{leaf}")


# -------------------------------------------------------- the scheduler --


_SLOT_PLAN_FIELDS = tuple(f.name for f in
                          __import__("dataclasses").fields(StepPlan))


@pytest.mark.parametrize("seed", range(3))
def test_slot_plans_equal_jax_step_by_step(seed):
  """The port's scheduler and JAX's on the slot layout (``block_size=0``,
  ``spec_k=3``, a prefill budget) take the same staggered requests and
  the same commits: multi-token commits, bad-slot verdicts, requeues,
  failures, the ladder's budget clamp and speculation switched off and
  on.  Equal plans field by field on every step, equal retirements."""
  r = np.random.RandomState(seed)
  kw = dict(num_slots=3, prefill_chunk=6, max_seq_len=48, spec_k=3,
            prefill_token_budget=12, clock=lambda: 0.0)
  port, ref = FCFSScheduler(**kw), JaxScheduler(**kw)
  arrivals = {0: 3, 2: 2, 5: 2, 9: 2}
  uid = 0
  for step in range(400):
    for _ in range(arrivals.get(step, 0)):
      fields = dict(uid=uid, prompt=r.randint(0, 12, (r.randint(1, 20),)
                                              ).astype(np.int32),
                    max_new_tokens=int(r.randint(4, 24)),
                    speculative=False if uid == 1 else None,
                    stop_token=5 if uid == 3 else -1)
      port.submit(Request(**fields))
      ref.submit(JaxRequest(**fields))
      uid += 1
    for s in (port, ref):
      s.budget_override = 6 if step % 7 == 3 else 0
      s.spec_enabled = step % 5 != 2
    got, want = port.plan_step(), ref.plan_step()
    assert (got is None) == (want is None), step
    if got is None:
      if not (port.has_work or ref.has_work) and step > 9:
        break
      continue
    assert isinstance(got, StepPlan)
    for name in _SLOT_PLAN_FIELDS:
      np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                    err_msg=f"step {step}: {name}")
    tokens = r.randint(0, 12, (3, 4)).astype(np.int32)
    counts = np.asarray([r.randint(1, c + 2) for c in got.draft_cap],
                        np.int32)
    slot_ok = r.rand(3) > 0.15
    fin = [(f.uid, f.finish_reason, f.tokens.tolist())
           for f in port.commit(tokens, counts, slot_ok=slot_ok)]
    assert fin == [(f.uid, f.finish_reason, f.tokens.tolist())
                   for f in ref.commit(tokens, counts, slot_ok=slot_ok)], step
    bad = [s for s in np.nonzero(~slot_ok)[0] if s in port.active]
    if bad and r.rand() < 0.5:
      if r.rand() < 0.7:
        assert port.requeue_slot(int(bad[0])) == ref.requeue_slot(
            int(bad[0]))
      else:
        a = port.retire_slot(int(bad[0]), "failed")
        b = ref.retire_slot(int(bad[0]), "failed")
        assert (a.uid, a.finish_reason, a.tokens.tolist()) == (
            b.uid, b.finish_reason, b.tokens.tolist())
      assert [f.uid for f in port.take_finished()] == [
          f.uid for f in ref.take_finished()]
  assert not port.has_work and uid == 9


def test_slot_scheduler_refuses_the_prefix_cache():
  with pytest.raises(ValueError, match="requires the paged cache"):
    FCFSScheduler(num_slots=2, prefill_chunk=4, max_seq_len=32,
                  prefix_cache=True)


# ----------------------------------------------------------- the engine --


@pytest.mark.quick
def test_default_engine_greedy_staggered_equal_jax():
  """The default config's engine (contiguous slots: 8 slots, chunk 16,
  nothing passed but the device) against the JAX package's default
  engine: staggered greedy streams token-equal to it and to JAX
  ``generate``."""
  epl.init()
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts(PROMPT_LENS)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu")
  assert not eng.paged and (eng.num_slots, eng.chunk) == (8, 16)
  got = _drive_staggered(eng, Request, prompts, MAX_NEW)
  want = _drive_staggered(JaxEngine(jmodel, jparams), JaxRequest, prompts,
                          MAX_NEW)
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(got[i], _oracle(jmodel, jparams, p,
                                                  MAX_NEW[i]))


def test_contiguous_greedy_staggered_equal_jax_small_chunks():
  """3 slots x chunk 4 (slots reused as requests retire, prompts longer
  than a chunk): token-equal to the JAX engine with ``paged=False`` and
  to JAX ``generate``, with the step's input shapes constant and the
  device cursors equal to each slot's resident tokens."""
  epl.init()
  jmodel, jparams, tmodel, tparams = _models(seed=4)
  prompts = _prompts(PROMPT_LENS, seed=1)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **SLOTS)
  shapes = set()
  real_step = eng._step_fn

  def recording(params, plan):
    shapes.add((plan.tokens.shape, plan.num_valid.shape))
    return real_step(params, plan)

  eng._step_fn = recording
  got = _drive_staggered(eng, Request, prompts, MAX_NEW)
  jeng = JaxEngine(jmodel, jparams, **SLOTS)
  want = _drive_staggered(jeng, JaxRequest, prompts, MAX_NEW)
  assert shapes == {((3, 4), (3,))} and eng.steps == jeng._steps
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(got[i], _oracle(jmodel, jparams, p,
                                                  MAX_NEW[i]))
  np.testing.assert_array_equal(eng._cursors.numpy(),
                                np.asarray(jax.device_get(jeng._cursors)))


def test_slot_reuse_leaks_no_stale_kv():
  """JAX ``test_slot_reuse_no_stale_kv_leakage``: a short request served
  after a long one in the only slot matches its own oracle (the long
  request's K/V tail is still in the cache, and never attended)."""
  jmodel, jparams, tmodel, tparams = _models(seed=2)
  long_p, short_p = _prompts((12, 3), seed=3)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", num_slots=1,
                                 prefill_chunk=4, paged=False)
  eng.submit(Request(uid="long", prompt=long_p, max_new_tokens=10))
  out = eng.run()
  assert eng._kv["block_0"]["attn"]["cached_key"][0, 12:21].abs().sum() > 0
  eng.submit(Request(uid="short", prompt=short_p, max_new_tokens=6))
  out.update(eng.run())
  np.testing.assert_array_equal(out["long"],
                                _oracle(jmodel, jparams, long_p, 10))
  np.testing.assert_array_equal(out["short"],
                                _oracle(jmodel, jparams, short_p, 6))


def test_stop_token_retires_early():
  """JAX ``test_stop_token_retires_early`` on the contiguous engine."""
  jmodel, jparams, tmodel, tparams = _models()
  (prompt,) = _prompts((5,))
  ref = _oracle(jmodel, jparams, prompt, 4)
  gen_part = list(ref[len(prompt):])
  stop = gen_part[1]
  cut = gen_part.index(stop)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", num_slots=2,
                                 prefill_chunk=4, paged=False)
  eng.submit(Request(uid="s", prompt=prompt, max_new_tokens=20,
                     stop_token=int(stop)))
  fins = []
  while eng.has_work:
    fins.extend(eng.step())
  assert len(fins) == 1 and fins[0].finish_reason == "stop_token"
  np.testing.assert_array_equal(fins[0].tokens, ref[:len(prompt) + cut + 1])


def test_sampled_stream_independent_of_batch_and_slot():
  """A sampled request draws from its own counter stream on the slot
  layout too: alone, or admitted late into a busy batch, the same
  tokens."""
  _, _, tmodel, tparams = _models(seed=1)
  (p,) = _prompts((5,), seed=3)
  others = _prompts((7, 4), seed=4)

  def drive(busy):
    eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **SLOTS)
    if busy:
      for i, o in enumerate(others):
        eng.submit(Request(uid=f"o{i}", prompt=o, max_new_tokens=8,
                           temperature=0.8, seed=i))
      eng.step()
    eng.submit(Request(uid="s", prompt=p, max_new_tokens=10,
                       temperature=1.0, top_k=20, top_p=0.9, seed=11))
    return eng.run()["s"]

  np.testing.assert_array_equal(drive(True), drive(False))


# -------------------------------------------------------- speculation --


@pytest.mark.parametrize("kind", ["ngram", "self_draft"])
def test_speculative_contiguous_greedy_equal_jax(kind):
  """JAX's contiguous speculative cases (tests/test_serving_speculative.
  py): the n-gram drafter over repeated spans, and the target's own
  weights as the draft model on the slot layout (full acceptance),
  token-equal to the JAX engine with the same drafter and to JAX
  ``generate``; drafts proposed and accepted."""
  epl.init()
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts(PROMPT_LENS, seed=3, repeat=2)
  knobs = dict(SLOTS, prefill_chunk=8)
  if kind == "ngram":
    drafter, jdrafter = NgramDrafter(k=4), JaxNgramDrafter(k=4)
  else:
    drafter = DraftModelDrafter(tmodel, tparams, k=3)
    jdrafter = JaxDraftModelDrafter(jmodel, jparams, k=3)
  stats = ServingStats()
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 drafter=drafter, stats=stats, **knobs)
  got = _drive_staggered(eng, Request, prompts, MAX_NEW)
  want = _drive_staggered(JaxEngine(jmodel, jparams, drafter=jdrafter,
                                    **knobs), JaxRequest, prompts, MAX_NEW)
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(got[i], _oracle(jmodel, jparams, p,
                                                  MAX_NEW[i]))
  s = stats.summary()
  assert s["drafted_tokens"] > 0 and s["accepted_tokens"] > 0
  if kind == "self_draft":
    assert s["acceptance_rate"] == 1.0 and eng.drafter.rollout_steps > 0
