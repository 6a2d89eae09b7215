"""The PyTorch port's speculative decoding against the JAX package's.

The contracts: the port's scheduler plans the same steps as the JAX
package's (drafts and prefix cache on); greedy speculative streams
(``device="cpu"``) are token-equal to the JAX paged engine's and to
``generate``; sampled verification keeps the target distribution (the
port's counter-based sampler draws other bits than JAX's, so sampled
streams are held to the distribution, not to JAX's tokens); a slot
without drafts reproduces the plain sampled stream bit for bit.
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
from easyparallellibrary_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine,
    DraftModelDrafter as JaxDraftModelDrafter, FCFSScheduler as JaxScheduler,
    NgramDrafter as JaxNgramDrafter, Request as JaxRequest,
    ngram_propose as jax_ngram_propose, verify_tokens as jax_verify_tokens)
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.profiler.serving import ServingStats
from easyparallellibrary_tpu_torch.serving import (
    ContinuousBatchingEngine, DraftModelDrafter, FCFSScheduler,
    NgramDrafter, Request, ngram_propose, sample_token_slots, verify_tokens)
from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
from easyparallellibrary_tpu_torch.utils import prng
from easyparallellibrary_tpu_torch.weights import from_jax_params

# Tiny shapes: one intra-op thread is enough, and it leaves the cores
# to the test suite's other worker processes.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
PAGED = dict(num_slots=3, prefill_chunk=8, paged=True, block_size=4)
PROMPT_LENS = (5, 3, 9, 1, 6, 2)
MAX_NEW = (6, 7, 8, 4, 5, 9)


def _models(cfg=TINY, seed=0):
  jmodel = JaxGPT(JaxGPTConfig(**cfg, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**cfg, dtype=torch.float32))
  return jmodel, jparams, tmodel, from_jax_params(tree, device="cpu")


def _prompts(lengths, seed=0, repeat=1):
  """Random prompts; ``repeat`` tiles each, so the n-gram drafter finds
  spans to propose."""
  r = np.random.RandomState(seed)
  return [np.tile(r.randint(0, 64, (n,)).astype(np.int32), repeat)
          for n in lengths]


def _oracle(model, params, prompt, max_new):
  return np.asarray(jax_generate(model, params, jnp.asarray(prompt)[None],
                                 max_new))[0]


def _port_oracle(model, params, prompt, max_new):
  """The port's ``generate(use_cache=True)`` (held against JAX's in
  tests/test_torch_gpt.py): no compile per prompt shape."""
  return tgpt.generate(model, params, torch.from_numpy(prompt[None]).long(),
                       max_new)[0].numpy()


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


# --------------------------------------------------------------- drafters


@pytest.mark.parametrize("seed", range(4))
def test_ngram_propose_equals_jax(seed):
  r = np.random.RandomState(seed)
  for _ in range(40):
    vocab = int(r.choice([3, 8, 64]))
    hist = r.randint(0, vocab, (r.randint(1, 60),)).astype(np.int32)
    k, lo = int(r.randint(1, 6)), int(r.randint(1, 3))
    hi = lo + int(r.randint(0, 4))
    np.testing.assert_array_equal(ngram_propose(hist, k, hi, lo),
                                  jax_ngram_propose(hist, k, hi, lo))


# -------------------------------------------------------------- scheduler


_PLAN_FIELDS = ("tokens", "slot_ids", "positions", "valid", "base_idx",
                "num_valid", "draft_base", "draft_cap", "block_tables",
                "prefilling", "keys", "tok_index", "temperature", "top_k",
                "top_p", "prefill_tokens", "decode_tokens",
                "scheduled_tokens", "active_slots")


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_plans_equal_jax_with_drafts_and_prefix_cache(seed):
  """The port's ``FCFSScheduler`` and JAX's, with ``spec_k=4`` and the
  prefix cache on, take the same staggered requests (shared prefixes,
  one ``speculative=False``, one stop token, a pool small enough to
  evict and preempt) and the same committed tokens (multi-token
  commits included): equal plans field by field on every step, equal
  retirements, equal prefix counters."""
  r = np.random.RandomState(seed)
  kw = dict(num_slots=3, prefill_chunk=8, max_seq_len=64, spec_k=4,
            block_size=4, num_blocks=22, token_budget=14,
            prefix_cache=True, clock=lambda: 0.0)
  port, ref = FCFSScheduler(**kw), JaxScheduler(**kw)
  heads = [r.randint(0, 12, (9,)).astype(np.int32) for _ in range(2)]
  arrivals = {0: 3, 2: 2, 5: 2, 9: 2}
  uid = 0
  for step in range(400):
    for _ in range(arrivals.get(step, 0)):
      prompt = np.concatenate([heads[uid % 2],
                               r.randint(0, 12, (r.randint(1, 14),))])
      fields = dict(uid=uid, prompt=prompt.astype(np.int32),
                    max_new_tokens=int(r.randint(4, 24)),
                    speculative=False if uid == 1 else None,
                    stop_token=5 if uid == 3 else -1)
      port.submit(Request(**fields))
      ref.submit(JaxRequest(**fields))
      uid += 1
    got, want = port.plan_step(), ref.plan_step()
    assert (got is None) == (want is None), step
    if got is None:
      if not (port.has_work or ref.has_work) and step > 9:
        break
      continue
    for name in _PLAN_FIELDS:
      np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                    err_msg=f"step {step}: {name}")
    tokens = r.randint(0, 12, (3, 5)).astype(np.int32)
    counts = np.asarray([r.randint(1, c + 2) for c in got.draft_cap],
                        np.int32)
    fin = [(f.uid, f.finish_reason, f.tokens.tolist())
           for f in port.commit(tokens, counts)]
    assert fin == [(f.uid, f.finish_reason, f.tokens.tolist())
                   for f in ref.commit(tokens, counts)], step
  assert not port.has_work and uid == 9
  assert (port.prefix_hits, port.prefix_blocks_reused,
          port.prefix_evictions, port.preemptions) == (
              ref.prefix_hits, ref.prefix_blocks_reused,
              ref.prefix_evictions, ref.preemptions)
  assert port.prefix_hits > 0


def test_commit_retires_at_a_stop_token_inside_the_draft():
  sched = FCFSScheduler(num_slots=1, prefill_chunk=4, max_seq_len=32,
                        spec_k=3, block_size=4, num_blocks=9,
                        token_budget=8)
  sched.submit(Request(uid="s", prompt=np.arange(3, dtype=np.int32),
                       max_new_tokens=10, stop_token=7))
  sched.plan_step()
  sched.commit(np.asarray([1]))
  plan = sched.plan_step()
  assert plan.draft_cap[0] == 3 and plan.draft_base[0] == 1
  (fin,) = sched.commit(np.asarray([[4, 7, 8, 9]]), np.asarray([4]))
  assert fin.finish_reason == "stop_token"
  np.testing.assert_array_equal(fin.tokens, [0, 1, 2, 1, 4, 7])


# ----------------------------------------------------------------- verify


def test_verify_tokens_greedy_equals_jax():
  """Exact-prefix acceptance with the argmax correction or bonus, on the
  same logits and drafts as JAX's ``verify_tokens``."""
  N, K, V = 6, 4, 16
  r = np.random.RandomState(1)
  logits = r.randn(N, K + 1, V).astype(np.float32)
  am = logits.argmax(-1)
  drafts = am[:, :K].copy()
  drafts[1, 0] = (am[1, 0] + 1) % V               # rejected at 0
  drafts[2, 2] = (am[2, 2] + 3) % V               # rejected at 2
  num_draft = np.asarray([4, 4, 4, 2, 0, 3], np.int32)
  keys = np.stack([prng.prng_key(i) for i in range(N)])
  tok_index = np.arange(N, dtype=np.int32)
  zeros = np.zeros((N,), np.float32)
  knobs = (zeros, np.zeros((N,), np.int32), np.ones((N,), np.float32))
  want = [np.asarray(x) for x in jax_verify_tokens(
      jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(num_draft),
      jnp.asarray(keys), jnp.asarray(tok_index),
      *[jnp.asarray(x) for x in knobs])]
  got = [x.numpy() for x in verify_tokens(
      torch.from_numpy(logits), torch.from_numpy(drafts),
      torch.from_numpy(num_draft), torch.from_numpy(keys.astype(np.int64)),
      torch.from_numpy(tok_index), *[torch.from_numpy(x) for x in knobs])]
  np.testing.assert_array_equal(got[1], want[1])
  np.testing.assert_array_equal(got[2], want[2])
  np.testing.assert_array_equal(got[2], [4, 0, 2, 2, 0, 3])
  for s in range(N):
    n = int(want[1][s])
    np.testing.assert_array_equal(got[0][s, :n], want[0][s, :n])


def test_verify_tokens_preserves_sampling_distribution():
  """JAX ``test_verify_tokens_preserves_sampling_distribution`` on the
  port's sampler: over 6000 request streams the first committed token
  follows the filtered target softmax (chi-square, 7 degrees of
  freedom, below 24.32, the 0.999 quantile; and total variation below
  0.035 as the JAX test), whether the point-mass draft is likely,
  unlikely or outside the top-k filter; the draft is accepted with
  probability p(draft) (within 0.035)."""
  N, V = 6000, 8
  r = np.random.RandomState(0)
  base = (r.randn(V) * 1.5).astype(np.float32)
  tgt = torch.from_numpy(np.broadcast_to(base, (N, 2, V)).copy())
  keys = torch.from_numpy(np.stack([prng.prng_key(i) for i in range(N)])
                          .astype(np.int64))
  ones = torch.ones((N,))
  zeros = torch.zeros((N,), dtype=torch.int32)

  def emitted(draft_tok, top_k=0):
    committed, _, accepted = verify_tokens(
        tgt, torch.full((N, 1), draft_tok), torch.ones((N,), dtype=torch.int32),
        keys, zeros, ones, torch.full((N,), top_k, dtype=torch.int32), ones)
    return committed[:, 0].numpy(), accepted.numpy()

  def expect(top_k=0):
    x = base.astype(np.float64)
    if top_k:
      x[np.argsort(x)[:-top_k]] = -np.inf
    p = np.exp(x - x.max())
    return p / p.sum()

  def check(first, p):
    freq = np.bincount(first, minlength=V)
    live = p > 0
    assert freq[~live].sum() == 0
    chi2 = (((freq[live] - N * p[live]) ** 2) / (N * p[live])).sum()
    assert chi2 < 24.32, chi2
    assert 0.5 * np.abs(freq / N - p).sum() < 0.035

  p = expect()
  for draft_tok in (int(np.argmax(base)), int(np.argmin(base))):
    first, accepted = emitted(draft_tok)
    check(first, p)
    assert abs(accepted.mean() - p[draft_tok]) < 0.035
  first, accepted = emitted(int(np.argmin(base)), top_k=3)
  assert accepted.sum() == 0
  check(first, expect(top_k=3))


def test_zero_draft_slot_reproduces_the_plain_sample():
  """A slot with ``num_draft == 0`` samples with the plain fold: the
  same token as ``sample_token_slots`` with that fold, bit for bit."""
  N, K, V = 64, 4, 32
  r = np.random.RandomState(2)
  logits = torch.from_numpy(r.randn(N, K + 1, V).astype(np.float32) * 2)
  keys = torch.from_numpy(np.stack([prng.prng_key(100 + i)
                                    for i in range(N)]).astype(np.int64))
  tok_index = torch.from_numpy(r.randint(0, 50, (N,)).astype(np.int32))
  temp = torch.from_numpy(r.uniform(0.5, 1.5, (N,)).astype(np.float32))
  top_k = torch.from_numpy(r.randint(0, 12, (N,)).astype(np.int32))
  top_p = torch.from_numpy(r.uniform(0.6, 1.0, (N,)).astype(np.float32))
  committed, n_committed, _ = verify_tokens(
      logits, torch.from_numpy(r.randint(0, V, (N, K))),
      torch.zeros((N,), dtype=torch.int32), keys, tok_index, temp, top_k,
      top_p)
  plain = sample_token_slots(logits[:, 0], prng.fold_in(keys, tok_index),
                             temp, top_k, top_p)
  assert (n_committed == 1).all()
  torch.testing.assert_close(committed[:, 0], plain, rtol=0, atol=0)


# ----------------------------------------------------------------- engine


@pytest.mark.quick
def test_spec_and_prefix_cache_greedy_staggered_equal_jax():
  """The slice's pin: staggered greedy requests (repeated spans, shared
  prefixes) on the port's engine with the n-gram drafter and the prefix
  cache both on are token-equal to the JAX paged engine with the same
  knobs and to JAX ``generate``; drafts were proposed and accepted."""
  epl.init()
  jmodel, jparams, tmodel, tparams = _models()
  shared = np.arange(1, 9, dtype=np.int32)
  prompts = [np.concatenate([shared, p]) for p in _prompts(
      (3, 1, 6, 2, 5, 4), seed=3, repeat=2)]
  max_new = (6, 7, 8, 4, 5, 9)
  knobs = dict(PAGED, prefix_cache=True)
  stats = ServingStats()
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 drafter=NgramDrafter(k=4), stats=stats,
                                 **knobs)
  got = _drive_staggered(eng, Request, prompts, max_new)
  jeng = JaxEngine(jmodel, jparams, drafter=JaxNgramDrafter(k=4), **knobs)
  want = _drive_staggered(jeng, JaxRequest, prompts, max_new)
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(
        got[i], _port_oracle(tmodel, tparams, p, max_new[i]))
  assert eng.steps == jeng._steps
  assert eng.scheduler.prefix_hits == jeng.scheduler.prefix_hits > 0
  s = stats.summary()
  assert s["drafted_tokens"] > 0 and s["accepted_tokens"] > 0
  assert eng.scheduler.kv_blocks_used == eng.scheduler.prefix_cached_blocks


def test_self_draft_model_full_acceptance_equal_jax():
  """JAX ``test_spec_draft_model_full_acceptance_and_exactness`` on the
  paged engine: the target's own weights as the draft model.  The
  port's one-token rollout rows and its verify rows come from fp32
  products over batches of another size; at these widths their argmax
  agrees, and acceptance is full, as JAX pins it."""
  epl.init()
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts(PROMPT_LENS)
  stats = ServingStats()
  eng = ContinuousBatchingEngine(
      tmodel, tparams, device="cpu", stats=stats,
      drafter=DraftModelDrafter(tmodel, tparams, k=3), **PAGED)
  got = _drive_staggered(eng, Request, prompts, MAX_NEW)
  jeng = JaxEngine(jmodel, jparams,
                   drafter=JaxDraftModelDrafter(jmodel, jparams, k=3),
                   **PAGED)
  want = _drive_staggered(jeng, JaxRequest, prompts, MAX_NEW)
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(
        got[i], _port_oracle(tmodel, tparams, p, MAX_NEW[i]))
  s = stats.summary()
  assert s["acceptance_rate"] == 1.0
  assert s["accepted_per_step_mean"] > 1.0
  assert s["drafted_tokens"] == s["accepted_tokens"] > 0
  assert eng.drafter.rollout_steps > 0


def test_smaller_draft_model_with_other_heads_still_exact():
  """A draft model of another width and head count (its own pools, its
  own tile plans) cannot change greedy output."""
  _, _, tmodel, tparams = _models()
  draft_cfg = dict(TINY, num_layers=1, d_model=16, num_heads=2, d_ff=32)
  dmodel, dparams = tiny_gpt(**draft_cfg, seed=9, device="cpu")
  prompts = _prompts(PROMPT_LENS, seed=5, repeat=2)[:4]
  eng = ContinuousBatchingEngine(
      tmodel, tparams, device="cpu",
      drafter=DraftModelDrafter(dmodel, dparams, k=4), **PAGED)
  plain = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **PAGED)
  got = _drive_staggered(eng, Request, prompts, MAX_NEW)
  want = _drive_staggered(plain, Request, prompts, MAX_NEW)
  for i in range(len(prompts)):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
  assert eng.drafter._kv["block_0"]["attn"]["cached_key"].shape[2] == 2


@pytest.mark.parametrize("drafter", ["self_draft", "ngram"])
def test_stop_token_mid_draft_retires_exactly(drafter):
  """JAX ``test_spec_stop_token_mid_draft_retires_exactly``: a stop
  token committed inside an accepted burst retires the request there;
  the output is the oracle cut at the stop, in fewer steps than
  tokens."""
  jmodel, jparams, tmodel, tparams = _models(seed=3)
  (prompt,) = _prompts((5,), seed=4, repeat=3)
  plen = len(prompt)
  ref = _oracle(jmodel, jparams, prompt, 8)
  gen = list(ref[plen:])
  stop = gen[2]
  cut = gen.index(stop)
  made = (DraftModelDrafter(tmodel, tparams, k=3) if drafter == "self_draft"
          else NgramDrafter(k=3))
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 num_slots=2, prefill_chunk=8, paged=True,
                                 block_size=4, drafter=made)
  eng.submit(Request(uid="s", prompt=prompt, max_new_tokens=16,
                     stop_token=int(stop)))
  fins = []
  while eng.has_work:
    fins.extend(eng.step())
  assert len(fins) == 1 and fins[0].finish_reason == "stop_token"
  np.testing.assert_array_equal(fins[0].tokens, ref[:plen + cut + 1])
  if drafter == "self_draft":
    assert eng.steps < 2 + cut + 1


def test_sampled_opt_out_keeps_the_plain_stream():
  """JAX ``test_sampled_request_without_drafts_keeps_plain_stream``: a
  sampled ``speculative=False`` request on a speculative engine, beside
  a sampled speculating one, reproduces the non-speculative engine's
  stream bit for bit."""
  _, _, tmodel, tparams = _models()
  prompt, other = _prompts((5, 4), seed=6, repeat=2)

  def run(drafter):
    eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                   drafter=drafter, **PAGED)
    eng.submit(Request(uid="s", prompt=prompt, max_new_tokens=8,
                       temperature=0.9, top_k=12, seed=7,
                       speculative=False))
    eng.submit(Request(uid="o", prompt=other, max_new_tokens=8,
                       temperature=0.7, seed=8))
    return eng.run()["s"]

  np.testing.assert_array_equal(run(None), run(NgramDrafter(k=3)))
  np.testing.assert_array_equal(
      run(None), run(DraftModelDrafter(tmodel, tparams, k=3)))


class _FailingDrafter(NgramDrafter):

  def __init__(self, fail_calls):
    super().__init__(k=3)
    self.calls, self.fail_calls = 0, fail_calls

  def propose(self, plan, histories):
    self.calls += 1
    if self.calls in self.fail_calls:
      raise RuntimeError("drafter fault")
    return super().propose(plan, histories)


def test_a_raising_drafter_degrades_to_zero_drafts_and_is_counted():
  _, _, tmodel, tparams = _models()
  prompts = _prompts(PROMPT_LENS[:3], seed=2, repeat=2)
  plain = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **PAGED)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 drafter=_FailingDrafter({3, 4, 6}),
                                 **PAGED)
  want = _drive_staggered(plain, Request, prompts, MAX_NEW[:3])
  got = _drive_staggered(eng, Request, prompts, MAX_NEW[:3])
  assert eng.drafter_failures == 3
  for i in range(3):
    np.testing.assert_array_equal(got[i], want[i])


def test_entry_points_resolve_drafters_and_name_what_is_not_ported():
  tmodel, tparams = tiny_gpt(device="cpu")
  cfg = epl.Config({"serving.speculative.enabled": True,
                    "serving.speculative.kind": "draft_model"})
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", paged=True,
                                 prefill_chunk=8, config=cfg,
                                 draft_model=tmodel, draft_params=tparams)
  assert isinstance(eng.drafter, DraftModelDrafter) and eng.drafter.k == 4
  with pytest.raises(ValueError, match="draft_params"):
    ContinuousBatchingEngine(tmodel, tparams, device="cpu", paged=True,
                             prefill_chunk=8, config=cfg)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", paged=True,
                                 prefill_chunk=8, speculative=True)
  assert isinstance(eng.drafter, NgramDrafter)
  assert ContinuousBatchingEngine(
      tmodel, tparams, device="cpu", paged=True, prefill_chunk=8,
      speculative=False, drafter=NgramDrafter()).drafter is None
  with pytest.raises(ValueError, match="prefill_chunk"):
    ContinuousBatchingEngine(tmodel, tparams, device="cpu", paged=True,
                             prefill_chunk=4, speculative=True)
  with pytest.raises(NotImplementedError,
                     match="ROADMAP.md Queue 1, 'Runtime around the step'"):
    DraftModelDrafter.from_checkpoint("ckpt", tmodel)
  # The contiguous engine (ported since) gives the draft model a slot
  # cache of its geometry, one chunk of slack past max_seq_len.
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", paged=False,
                                 num_slots=3, prefill_chunk=8, config=cfg,
                                 draft_model=tmodel, draft_params=tparams)
  draft_cache = eng.drafter._kv["block_0"]["attn"]["cached_key"]
  assert tuple(draft_cache.shape[:2]) == (3, 32 + 8)
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="device='cpu'"):
      ContinuousBatchingEngine(tmodel, tparams, paged=True,
                               prefill_chunk=8, speculative=True,
                               prefix_cache=True)
