"""The PyTorch port's paged serving engine against the JAX package's.

Greedy streams of the port's engine (``device="cpu"``) must be
token-equal to the JAX paged engine's and to JAX ``generate(use_cache=
True)`` on the same (bridged) parameters, through staggered admission,
slot and block reuse, and pool-exhaustion preemption.
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
    ContinuousBatchingEngine as JaxEngine, Request as JaxRequest)
from easyparallellibrary_tpu_torch.config import Config as TorchConfig
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.serving import (
    ContinuousBatchingEngine, Request)
from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
from easyparallellibrary_tpu_torch.weights import from_jax_params

# Tiny shapes: one intra-op thread is enough, and it leaves the cores
# to the test suite's other worker processes.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)


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


def _jax_oracle(model, params, prompt, max_new):
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


@pytest.mark.quick
def test_paged_greedy_exact_staggered_vs_jax(monkeypatch):
  """The staggered case of the JAX package's
  ``test_paged_greedy_exact_staggered_compile_once``: token-equal to the
  JAX engine and to JAX ``generate``, every block returned at the end,
  and the step's input shapes constant over the run (the port's
  stand-in for compile-once)."""
  epl.init()
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3, 9, 1, 6, 2))
  max_new = (6, 7, 8, 4, 5, 9)
  geometry = dict(num_slots=3, prefill_chunk=4, paged=True, block_size=4)

  shapes = set()
  real_step = tgpt.paged_step_logits

  def recording_step(model, params, kv, *inputs):
    shapes.add(tuple((tuple(x.shape), x.dtype) for x in inputs))
    return real_step(model, params, kv, *inputs)

  monkeypatch.setattr(tgpt, "paged_step_logits", recording_step)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **geometry)
  got = _drive_staggered(eng, Request, prompts, max_new)
  want = _drive_staggered(JaxEngine(jmodel, jparams, **geometry),
                          JaxRequest, prompts, max_new)
  assert eng.steps > 0 and len(shapes) == 1
  for i, p in enumerate(prompts):
    oracle = _jax_oracle(jmodel, jparams, p, max_new[i])
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(got[i], oracle, err_msg=f"req {i}")
  assert eng.scheduler.kv_blocks_used == 0


def test_block_pool_exhaustion_preempts_and_replays_exact():
  """The JAX package's exhaustion case: 9 usable blocks x 4 rows cannot
  hold two 24-row requests, so one is preempted and replays its
  committed prefix; both finish token-equal to JAX ``generate``."""
  jmodel, jparams, tmodel, tparams = _models()
  p1, p2 = _prompts((10, 10), seed=7)
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 num_slots=2, prefill_chunk=4, paged=True,
                                 block_size=4, num_blocks=10)
  eng.submit(Request(uid="a", prompt=p1, max_new_tokens=14))
  eng.submit(Request(uid="b", prompt=p2, max_new_tokens=14))
  out = eng.run(max_steps=300)
  assert eng.scheduler.preemptions >= 1
  for uid, p in (("a", p1), ("b", p2)):
    assert eng.finished[uid].finish_reason == "length"
    np.testing.assert_array_equal(out[uid],
                                  _jax_oracle(jmodel, jparams, p, 14),
                                  err_msg=uid)
  assert eng.scheduler.kv_blocks_used == 0
  assert eng.scheduler.kv_blocks_free == 9


def test_sampled_stream_independent_of_batch_and_slot():
  """A sampled request draws from its own counter stream: alone, or
  admitted late into a busy batch (another slot, other iterations), it
  produces the same tokens; a stop token retires it with the token
  included."""
  _, _, tmodel, tparams = _models(seed=1)
  (p,) = _prompts((5,), seed=3)
  others = _prompts((7, 4), seed=4)

  def drive(busy):
    eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                   num_slots=3, prefill_chunk=4,
                                   paged=True, block_size=4)
    if busy:
      for i, o in enumerate(others):
        eng.submit(Request(uid=f"o{i}", prompt=o, max_new_tokens=8,
                           temperature=0.8, seed=i))
      eng.step()
    eng.submit(Request(uid="s", prompt=p, max_new_tokens=10,
                       temperature=1.0, top_k=20, top_p=0.9, seed=11))
    return eng.run()["s"]

  alone = drive(False)
  np.testing.assert_array_equal(drive(True), alone)
  stop = int(alone[len(p) + 2])
  eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                 num_slots=1, prefill_chunk=4, paged=True,
                                 block_size=4)
  eng.submit(Request(uid="s", prompt=p, max_new_tokens=10, temperature=1.0,
                     top_k=20, top_p=0.9, seed=11, stop_token=stop))
  out = eng.run()["s"]
  first = len(p) + list(alone[len(p):]).index(stop)
  np.testing.assert_array_equal(out, alone[:first + 1])
  assert eng.finished["s"].finish_reason == "stop_token"


@pytest.mark.parametrize("kwargs", [
    dict(config=TorchConfig({"serving.autotune.enabled": True})),
    dict(config=TorchConfig({"observability.enabled": True})),
    dict(mesh=object()), dict(registry=object()),
])
def test_features_outside_the_slice_raise(kwargs):
  """What the port has not reached raises on both layouts (the
  contiguous engine and serving resilience have been ported since)."""
  tmodel, tparams = tiny_gpt(device="cpu")
  for paged in (True, False):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
      ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                               **{"paged": paged, **kwargs})
