"""Request migration in the port against the JAX package's: the
``Request.snapshot`` wire shape, the scheduler's ``snapshot_requests`` /
``progress`` / ``restore_request`` / ``evacuate`` and the engine's
endpoints, on both cache layouts.

A snapshot taken by either package restores in the other and the stream
continues token-equal (greedy, fp32, weights bridged with
``weights.from_jax_params``); the snapshots and watermarks equal the JAX
scheduler's step by step; an evacuation releases every slot and block
and its requests finish exactly elsewhere; a snapshot pinned to another
checkpoint version is refused by both.
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
from easyparallellibrary_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine, FCFSScheduler as JaxScheduler,
    Request as JaxRequest)
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.serving import (
    ContinuousBatchingEngine, FCFSScheduler, Request)
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
LAYOUTS = {"contiguous": dict(paged=False, num_slots=2, prefill_chunk=4),
           "paged": dict(paged=True, block_size=4, num_slots=2,
                         prefill_chunk=4)}
MAX_NEW = 8


@pytest.fixture(autouse=True)
def _envs():
  jepl.init()
  tepl.init(device="cpu")
  yield
  tepl.Env.get().reset()


def _models(seed=0):
  jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  return jmodel, jparams, tmodel, from_jax_params(tree, device="cpu")


def _prompts(lengths=(5, 9, 3, 7), seed=0):
  r = np.random.RandomState(seed)
  return [r.randint(0, 64, (n,)).astype(np.int32) for n in lengths]


def _oracle(jmodel, jparams, prompt, max_new=MAX_NEW):
  return np.asarray(jax_generate(jmodel, jparams, jnp.asarray(prompt)[None],
                                 max_new))[0]


def _wire(snaps):
  """Through the wire: a JSON round trip, as the process transport
  sends it."""
  return json.loads(json.dumps(snaps))


# ----------------------------------------------------------- wire shape


REQUEST_FIELDS = [
    dict(uid=0, max_new_tokens=4),
    dict(uid="s", max_new_tokens=9, temperature=0.7, top_k=5, top_p=0.9,
         stop_token=3, seed=11, speculative=False, deadline_s=2.5,
         ttft_budget_s=0.5, priority="latency", flow_id=77,
         checkpoint_version=3),
    dict(uid=12, max_new_tokens=1, speculative=True, flow_id=1,
         checkpoint_version=0),
]


@pytest.mark.parametrize("fields", REQUEST_FIELDS,
                         ids=lambda f: str(f["uid"]))
def test_request_snapshot_is_the_jax_wire_shape(fields):
  """Key for key, value for value and type for type the JAX package's v2
  snapshot; each package restores the other's (after JSON), and both
  read a v1 snapshot and refuse an unknown version."""
  prompt = np.arange(1, 6, dtype=np.int32)
  got = Request(prompt=prompt, **fields).snapshot()
  want = JaxRequest(prompt=prompt, **fields).snapshot()
  assert got == want
  assert [type(got[k]) for k in sorted(got)] == \
      [type(want[k]) for k in sorted(want)]
  assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
  back = Request.restore(_wire(want))
  assert back.snapshot() == want and back.prompt.dtype == np.int32
  assert JaxRequest.restore(_wire(got)).snapshot() == got
  v1 = {k: v for k, v in want.items() if k not in ("v", "checkpoint_version")}
  assert Request.restore(v1).checkpoint_version is None
  assert JaxRequest.restore(v1).checkpoint_version is None
  for cls in (Request, JaxRequest):
    with pytest.raises(ValueError, match="snapshot version"):
      cls.restore({**want, "v": 3})


# ------------------------------------------- cross-package continuation


def _start(engine, request_cls, prompts, steps=3):
  for i, p in enumerate(prompts):
    engine.submit(request_cls(uid=i, prompt=p, max_new_tokens=MAX_NEW))
  out = {}
  for _ in range(steps):
    for fin in engine.step():
      out[fin.uid] = fin.tokens
  return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_jax_snapshot_continues_token_equal_in_port(layout):
  """A JAX engine serves three steps of a mixed load (two requests
  decoding, two queued), snapshots it, and the snapshots go over the wire
  into a fresh port engine: every stream finishes token-equal to the JAX
  engine's own uninterrupted run and to JAX ``generate``."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts()
  jeng = JaxEngine(jmodel, jparams, **LAYOUTS[layout])
  done = _start(jeng, JaxRequest, prompts)
  snaps = _wire(jeng.snapshot_requests())
  assert len(snaps) == len(prompts) - len(done)
  assert any(s["generated"] for s in snaps)      # mid-decode, not queued
  want = {**done, **jeng.run()}
  teng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                  **LAYOUTS[layout])
  for snap in snaps:
    assert teng.restore_request(snap) == snap["request"]["uid"]
  got = {**done, **teng.run()}
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    np.testing.assert_array_equal(got[i], _oracle(jmodel, jparams, p))
    assert teng.finished.get(i, jeng.finished[i]).finish_reason == "length"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_snapshot_continues_token_equal_in_jax(layout):
  """The reverse: a port engine's snapshots restore in a JAX engine and
  finish token-equal to the port's uninterrupted run."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts(seed=3)
  teng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                  **LAYOUTS[layout])
  done = _start(teng, Request, prompts, steps=4)
  snaps = _wire(teng.snapshot_requests())
  want = {**done, **teng.run()}
  jeng = JaxEngine(jmodel, jparams, **LAYOUTS[layout])
  for snap in reversed(snaps):
    jeng.restore_request(snap, front=True)
  got = {**done, **jeng.run()}
  for i in range(len(prompts)):
    np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_snapshots_and_progress_equal_jax_step_by_step(layout):
  """Driven in lock step, the port's and the JAX engine's
  ``snapshot_requests`` (all but the submit time, a clock reading) and
  the schedulers' ``progress`` watermarks are equal after every step."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((6, 2, 8, 4, 5), seed=5)
  jeng = JaxEngine(jmodel, jparams, **LAYOUTS[layout])
  teng = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                  **LAYOUTS[layout])
  for i, p in enumerate(prompts):
    kw = dict(uid=i, prompt=p, max_new_tokens=MAX_NEW, flow_id=100 + i)
    jeng.submit(JaxRequest(**kw))
    teng.submit(Request(**kw))

  def strip(snaps):
    return [{k: v for k, v in s.items() if k != "submitted_at"}
            for s in snaps]

  steps = 0
  while jeng.has_work or teng.has_work:
    assert strip(teng.snapshot_requests()) == \
        strip(_wire(jeng.snapshot_requests()))
    assert [(u, list(g)) for u, g in teng.scheduler.progress()] == \
        [(u, [int(t) for t in g]) for u, g in jeng.scheduler.progress()]
    jeng.step()
    teng.step()
    steps += 1
    assert steps < 200
  assert teng.snapshot_requests() == [] == jeng.snapshot_requests()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_evacuate_releases_everything_and_requests_finish_elsewhere(layout):
  """Mid-decode evacuation (from a warm prefix cache on the paged
  layout): no slot, queued request or block stays held but the prefix
  tree's, the engine serves again at once, and the evacuated requests
  finish on another engine token-equal to JAX ``generate``."""
  jmodel, jparams, tmodel, tparams = _models()
  kw = dict(LAYOUTS[layout])
  if kw["paged"]:
    kw["prefix_cache"] = True
  shared = _prompts((8,), seed=9)[0]
  prompts = [np.concatenate([shared, p]) for p in _prompts((3, 5, 2, 4))]
  a = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **kw)
  b = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **kw)
  done = _start(a, Request, prompts, steps=5)
  snaps = a.evacuate()
  assert snaps and not a.has_work
  assert a.scheduler.num_active == 0 and a.scheduler.queue_depth == 0
  if kw["paged"]:
    assert a.scheduler.kv_blocks_used == a.scheduler.prefix_cached_blocks
  for snap in reversed(_wire(snaps)):
    b.restore_request(snap, front=True)
  got = {**done, **b.run()}
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(got[i], _oracle(jmodel, jparams, p),
                                  err_msg=f"req {i}")
  # The evacuated engine is warm and serves again.
  a.submit(Request(uid="again", prompt=prompts[0], max_new_tokens=MAX_NEW))
  np.testing.assert_array_equal(a.run()["again"], got[0])


def test_cross_version_restore_refused_and_prefix_tree_scoped():
  """A scheduler serving checkpoint version 1 refuses a snapshot pinned
  to version 0 (as the JAX scheduler does), takes an unpinned one, and
  its prefix tree is salted with its version."""
  kw = dict(num_slots=2, prefill_chunk=4, max_seq_len=32, block_size=4,
            num_blocks=16, token_budget=8, prefix_cache=True,
            checkpoint_version=1)
  port, jax_s = FCFSScheduler(**kw), JaxScheduler(**kw)
  prompt = np.arange(1, 6, dtype=np.int32)
  for sched, cls in ((port, Request), (jax_s, JaxRequest)):
    snap = {"request": cls(uid="a", prompt=prompt, max_new_tokens=3,
                           checkpoint_version=0).snapshot(),
            "generated": [], "requeues": 0, "first_token_emitted": False,
            "submitted_at": 0.0}
    with pytest.raises(ValueError, match="cross-version restore refused"):
      sched.restore_request(snap)
    snap["request"]["checkpoint_version"] = None
    assert sched.restore_request(snap) == "a"
    assert sched.queue_depth == 1
  assert port.prefix_cache.version == jax_s.prefix_cache.version == 1
  assert ContinuousBatchingEngine(
      *(_models()[2:]), device="cpu", paged=True, block_size=4,
      prefix_cache=True,
      checkpoint_version=2).scheduler.prefix_cache.version == 2
