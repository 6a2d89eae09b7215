"""The PyTorch port's copy-on-write prefix cache against the JAX package's.

The radix tree is host code over numpy and crc32, so its keys, matches,
refcounts and eviction counts must equal the JAX package's exactly.  On
the engine, warm admission only changes planning: every token the port
emits (``device="cpu"``) equals the JAX paged engine's with the same
knobs and a cold prefill of the same prompt, and the shared blocks' pool
rows never change.  Every comparison here is exact (token ids, block
ids, counts).
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
    BlockAllocator as JaxBlockAllocator,
    ContinuousBatchingEngine as JaxEngine, PrefixCache as JaxPrefixCache,
    Request as JaxRequest, block_prefix_keys as jax_block_prefix_keys)
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.serving import (
    BlockAllocator, ContinuousBatchingEngine, PrefixCache, Request,
    block_prefix_keys)
from easyparallellibrary_tpu_torch.weights import from_jax_params

# Tiny shapes: one intra-op thread is enough, and it leaves the cores
# to the test suite's other worker processes.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
WARM = dict(num_slots=2, prefill_chunk=4, paged=True, block_size=4,
            prefix_cache=True)


def _models(seed=0):
  jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  return jmodel, jparams, tmodel, from_jax_params(tree, device="cpu")


def _oracle(model, params, prompt, max_new):
  return np.asarray(jax_generate(model, params, jnp.asarray(prompt)[None],
                                 max_new))[0]


# ------------------------------------------------------------- the tree


@pytest.mark.parametrize("seed", range(4))
def test_block_prefix_keys_equal_jax(seed):
  r = np.random.RandomState(seed)
  for _ in range(10):
    prompt = r.randint(0, 50000, (r.randint(1, 70),)).astype(np.int32)
    bs = int(r.choice([1, 4, 16]))
    kw = dict(max_blocks=int(r.randint(1, 10)),
              version=int(r.choice([0, 0, 3])))
    assert (block_prefix_keys(prompt, bs, **kw)
            == jax_block_prefix_keys(prompt, bs, **kw))


def _tree_ops(cache_cls, alloc_cls, seed):
  """A random sequence of tree operations over a fake clock; returns the
  log of every result, refcount and counter along the way."""
  r = np.random.RandomState(seed)
  now = [0.0]
  alloc = alloc_cls(num_blocks=24, block_size=4)
  cache = cache_cls(alloc, block_size=4, session_ttl_s=6.0,
                    max_cached_blocks=10, clock=lambda: now[0])
  # Prompts with shared heads, so matches go deep and forks happen.
  heads = [r.randint(0, 9, (8,)).astype(np.int32) for _ in range(3)]
  log, held = [], []
  for _ in range(60):
    now[0] += float(r.randint(0, 3))
    prompt = np.concatenate([heads[r.randint(3)],
                             r.randint(0, 9, (r.randint(1, 12),))])
    op = r.randint(5)
    if op == 0:
      got = cache.match(prompt)
      held.extend(got)
      log.append(("match", got))
    elif op == 1:
      n = len(prompt) // 4
      blocks = [alloc.alloc() for _ in range(n)]
      if None in blocks:
        blocks = [b for b in blocks if b is not None]
        n = len(blocks)
      log.append(("register", cache.register(prompt, n, blocks)))
      held.extend(blocks)
    elif op == 2:
      log.append(("evict", cache.evict_for_space(int(r.randint(1, 4)))))
    elif op == 3:
      log.append(("expire", cache.expire()))
    elif held:
      alloc.decref(held.pop(r.randint(len(held))))
    log.append((cache.hits, cache.misses, cache.blocks_reused,
                cache.evictions, cache.num_cached_blocks, alloc.num_free,
                [alloc.refcount(b) for b in range(24)]))
  while held:
    alloc.decref(held.pop())
  log.append(("clear", cache.clear(), alloc.num_free))
  return log


@pytest.mark.parametrize("seed", range(3))
def test_tree_operations_equal_jax(seed):
  """match / register / evict_for_space / TTL expire / budget, with a
  fake clock: the same matches, refcounts and eviction counts as the
  JAX package's tree over its own allocator."""
  got = _tree_ops(PrefixCache, BlockAllocator, seed)
  want = _tree_ops(JaxPrefixCache, JaxBlockAllocator, seed)
  assert got == want
  assert any(e[0] == "match" and e[1] for e in got if isinstance(e[0], str))


# ------------------------------------------------------------ the engine


def _sessions(prompts, max_new, engine, request_cls):
  """Requests served one after another: each session seeds or reuses
  the tree."""
  out = {}
  for i, p in enumerate(prompts):
    engine.submit(request_cls(uid=i, prompt=p, max_new_tokens=max_new))
    out.update(engine.run())
  return out


@pytest.mark.quick
def test_warm_admission_equals_cold_prefill_and_jax():
  """JAX ``test_warm_admission_bit_exact_with_cow_divergence``: a seed
  request, one that forks after the two shared blocks and one that
  diverges inside the second; streams equal the JAX engine's, JAX
  ``generate`` and the port's cache-off engine, with the JAX counters."""
  epl.init()
  jmodel, jparams, tmodel, tparams = _models()
  base = np.arange(1, 9, dtype=np.int32)
  prompts = [np.concatenate([base, [9]]).astype(np.int32),
             np.concatenate([base, [10, 11]]).astype(np.int32),
             np.concatenate([base[:6], [12, 13, 14]]).astype(np.int32)]
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 **{**WARM, "num_slots": 4})
  got = _sessions(prompts, 6, eng, Request)
  jeng = JaxEngine(jmodel, jparams, **{**WARM, "num_slots": 4})
  want = _sessions(prompts, 6, jeng, JaxRequest)
  cold = _sessions(prompts, 6, ContinuousBatchingEngine(
      tmodel, tparams, device="cpu", **{**WARM, "prefix_cache": False}),
      Request)
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(got[i], cold[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(got[i], _oracle(jmodel, jparams, p, 6))
  s, js = eng.scheduler, jeng.scheduler
  assert (s.prefix_hits, s.prefix_misses, s.prefix_blocks_reused) == (2, 1,
                                                                      3)
  assert ((js.prefix_hits, js.prefix_misses, js.prefix_blocks_reused,
           js.prefix_cached_blocks)
          == (s.prefix_hits, s.prefix_misses, s.prefix_blocks_reused,
              s.prefix_cached_blocks))
  assert s.kv_blocks_used == s.prefix_cached_blocks > 0


def test_shared_blocks_are_mapped_and_never_written():
  """A warm request's leading table entries are the blocks its
  predecessor wrote; their pool rows are bit-identical before and after
  the sharer prefills and decodes past them, and re-serving the
  original prompt reproduces its stream."""
  _, _, tmodel, tparams = _models(seed=2)
  base = np.arange(1, 9, dtype=np.int32)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **WARM)
  first = np.concatenate([base, [9]]).astype(np.int32)
  eng.submit(Request(uid="seed", prompt=first, max_new_tokens=4))
  out = eng.run()
  sched = eng.scheduler
  shared = sched.prefix_cache.match(first)
  for b in shared:
    sched.block_allocator.decref(b)              # a probe only
  assert len(shared) == 2

  def rows():
    return [torch.cat([eng._kv[f"block_{i}"]["attn"][n][shared].flatten()
                       for n in ("cached_key", "cached_value")]).clone()
            for i in range(TINY["num_layers"])]

  before = rows()
  eng.submit(Request(uid="fork", prompt=np.concatenate(
      [base, [10, 11]]).astype(np.int32), max_new_tokens=6))
  eng.step()
  slot = next(iter(sched.active))
  assert sched.slot_blocks(slot)[:2] == shared
  assert all(sched.block_allocator.refcount(b) >= 2 for b in shared)
  out.update(eng.run())
  for a, b in zip(before, rows()):
    assert torch.equal(a, b)
  eng.submit(Request(uid="again", prompt=first, max_new_tokens=4))
  out.update(eng.run())
  np.testing.assert_array_equal(out["again"], out["seed"])


def test_cached_blocks_evicted_before_any_preemption():
  """JAX ``test_cached_blocks_evicted_before_any_preemption``: with 8
  usable blocks the second request can only prefill by reclaiming the
  first one's cached session blocks, and no live slot is preempted."""
  jmodel, jparams, tmodel, tparams = _models(seed=4)
  r = np.random.RandomState(5)
  p1, p2 = (r.randint(0, 64, (12,)).astype(np.int32) for _ in range(2))

  def drive(engine, request_cls):
    engine.submit(request_cls(uid="a", prompt=p1, max_new_tokens=10))
    out = engine.run(max_steps=300)
    assert engine.scheduler.prefix_cached_blocks > 0
    engine.submit(request_cls(uid="b", prompt=p2, max_new_tokens=10))
    out.update(engine.run(max_steps=300))
    return out

  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 **{**WARM, "num_blocks": 9})
  got = drive(eng, Request)
  jeng = JaxEngine(jmodel, jparams, **{**WARM, "num_blocks": 9})
  want = drive(jeng, JaxRequest)
  assert eng.scheduler.preemptions == 0
  assert eng.scheduler.prefix_evictions == jeng.scheduler.prefix_evictions
  assert eng.scheduler.prefix_evictions > 0
  for uid, p in (("a", p1), ("b", p2)):
    np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)
    np.testing.assert_array_equal(got[uid], _oracle(jmodel, jparams, p, 10))


def test_requeue_rematches_own_prefix_and_releases_refs():
  """A request requeued mid-decode (``requeue_slot``, the preemption
  path) keeps its registered blocks in the tree, re-matches its own
  committed prefix on readmission, and ends token-equal to the JAX
  engine driven the same way; every block still held is a tree pin."""
  jmodel, jparams, tmodel, tparams = _models()
  p = np.arange(1, 10, dtype=np.int32)

  def drive(engine, request_cls):
    engine.submit(request_cls(uid="q", prompt=p, max_new_tokens=12))
    for _ in range(6):                 # prefill, then a few decodes
      engine.step()
    slot = next(iter(engine.scheduler.active))
    assert engine.scheduler.requeue_slot(slot) == "q"
    return engine.run()

  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **WARM)
  got = drive(eng, Request)
  jeng = JaxEngine(jmodel, jparams, **WARM)
  want = drive(jeng, JaxRequest)
  assert eng.scheduler.prefix_hits == jeng.scheduler.prefix_hits == 1
  assert (eng.scheduler.prefix_blocks_reused
          == jeng.scheduler.prefix_blocks_reused >= 3)
  np.testing.assert_array_equal(got["q"], want["q"])
  np.testing.assert_array_equal(got["q"], _oracle(jmodel, jparams, p, 12))
  assert eng.scheduler.kv_blocks_used == eng.scheduler.prefix_cached_blocks
  assert eng.scheduler.prefix_cache.clear() > 0
  assert eng.scheduler.kv_blocks_used == 0


def test_unique_prompts_leave_streams_unchanged():
  """Cache on with nothing shareable: the same streams as cache off,
  every admission a miss."""
  _, _, tmodel, tparams = _models(seed=3)
  r = np.random.RandomState(11)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32) for n in (5, 9, 3, 7)]

  def drive(prefix_cache):
    eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                   **{**WARM, "prefix_cache": prefix_cache})
    for i, p in enumerate(prompts):
      eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    return eng, eng.run(max_steps=300)

  warm_eng, warm = drive(True)
  _, cold = drive(False)
  for i in range(len(prompts)):
    np.testing.assert_array_equal(warm[i], cold[i], err_msg=f"req {i}")
  assert warm_eng.scheduler.prefix_hits == 0
  assert warm_eng.scheduler.prefix_misses == len(prompts)
