"""The port's reactor (``serving/reactor.py``) and streaming front door
(``serving/frontdoor/``) against the JAX package's.

The in-process N=1 reactor is token-equal to the sweep and to the JAX
reactor with no kernel library loaded; a replica killed under the reactor
fails over as the JAX router's does.  Over real sockets on 127.0.0.1
(port 0): an HTTP/SSE stream assembles to the direct-submit stream,
headers map onto the request and malformed requests get a 400,
``traceparent`` is parsed and minted as the JAX functions do and echoed,
a disconnect frees the slot and finalizes the flow, a slow reader's
overflow sheds only its own flow, and the two packages' clients and
servers speak the same wire both ways.  Under the reactor a SIGSTOPped
child is condemned at its wire deadline while the other child keeps
stepping, and no request is lost.
"""

import json
import signal
import threading
import time

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
from easyparallellibrary_tpu.observability import trace as jtrace
from easyparallellibrary_tpu.serving import Request as JaxRequest
from easyparallellibrary_tpu.serving import Router as JaxRouter
from easyparallellibrary_tpu.serving import frontdoor as jfd
from easyparallellibrary_tpu.serving.frontdoor import server as jserver
from easyparallellibrary_tpu.testing import chaos as jchaos
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.observability import slo as tslo
from easyparallellibrary_tpu_torch.observability import trace as ttrace
from easyparallellibrary_tpu_torch.serving import Request, Router
from easyparallellibrary_tpu_torch.serving import frontdoor as tfd
from easyparallellibrary_tpu_torch.serving import transport as ttransport
from easyparallellibrary_tpu_torch.serving.frontdoor import server as tserver
from easyparallellibrary_tpu_torch.serving.reactor import RouterReactor
from easyparallellibrary_tpu_torch.serving.scheduler import FinishedRequest
from easyparallellibrary_tpu_torch.testing import chaos
from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
GEOMETRY = dict(num_slots=2, prefill_chunk=4)
FACTORY = {"fn": "easyparallellibrary_tpu_torch.testing.factories:tiny_gpt",
           "kwargs": {}}
GUARD_S = 240


@pytest.fixture(autouse=True)
def _guarded(monkeypatch):
  monkeypatch.setenv("OMP_NUM_THREADS", "1")
  jepl.init()
  tepl.init(device="cpu")

  def _expired(signum, frame):
    raise TimeoutError(f"test exceeded its {GUARD_S} s guard")

  prev = signal.signal(signal.SIGALRM, _expired)
  signal.alarm(GUARD_S)
  try:
    yield
  finally:
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)
    ttransport._reap_orphans()
    ttrace.reset()
    tslo.reset()
    jtrace.reset()
    tepl.Env.get().reset()


def _models():
  jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
  jparams = jmodel.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 4), jnp.int32))["params"]
  tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jparams))
  tmodel = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  return jmodel, jparams, tmodel, from_jax_params(tree, device="cpu")


def _prompts(lengths, seed=0):
  r = np.random.RandomState(seed)
  return [r.randint(0, 64, (n,)).astype(np.int32) for n in lengths]


def _oracle(jmodel, jparams, prompt, max_new):
  return np.asarray(jax_generate(jmodel, jparams, jnp.asarray(prompt)[None],
                                 max_new))[0]


def _conf(package, reactor=True, **frontdoor):
  conf = {"serving": {"router": {"reactor": reactor}}}
  if frontdoor:
    conf["serving"]["frontdoor"] = frontdoor
  return package.Config(conf)


def _wait_for(predicate, timeout_s=30.0, interval_s=0.02):
  deadline = time.monotonic() + timeout_s
  while time.monotonic() < deadline:
    if predicate():
      return True
    time.sleep(interval_s)
  return predicate()


# ------------------------------------------------------------- reactor


@pytest.mark.quick
def test_reactor_inproc_n1_equals_sweep_and_jax_reactor():
  """The reactor over one in-process replica re-cadences the same engine
  steps: its streams equal the sweep's, the JAX reactor's and JAX
  ``generate``; no kernel library is loaded by it."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3, 9, 2))
  max_new = (6, 7, 4, 5)

  def drive(router, request_cls, step_once, run):
    for i in range(2):
      assert router.submit(request_cls(uid=i, prompt=prompts[i],
                                       max_new_tokens=max_new[i]))
    out = {}
    for _ in range(2):
      for fin in step_once():
        out[fin.uid] = fin.tokens
    for i in range(2, 4):
      assert router.submit(request_cls(uid=i, prompt=prompts[i],
                                       max_new_tokens=max_new[i]))
    out.update(run())
    return out

  sweep = Router(tmodel, tparams, num_replicas=1, device="cpu",
                 config=_conf(tepl, reactor=False), **GEOMETRY)
  swept = drive(sweep, Request, sweep.step, sweep.run)
  libs = _build.loaded_count()
  rrouter = Router(tmodel, tparams, num_replicas=1, device="cpu",
                   config=_conf(tepl), **GEOMETRY)
  reactor = rrouter.reactor()
  assert isinstance(reactor, RouterReactor) and rrouter.reactor() is reactor
  reacted = drive(rrouter, Request, reactor.cycle, rrouter.run)
  jrouter = JaxRouter(jmodel, jparams, num_replicas=1,
                      config=_conf(jepl), **GEOMETRY)
  jreacted = drive(jrouter, JaxRequest, jrouter.reactor().cycle,
                   jrouter.run)
  assert _build.loaded_count() == libs
  assert reactor.cycles == jrouter.reactor().cycles > 0
  assert reactor.dispatched == jrouter.reactor().dispatched
  assert rrouter.failovers == 0 and rrouter.states() == ["healthy"]
  assert sorted(swept) == sorted(reacted) == list(range(4))
  for i in range(4):
    np.testing.assert_array_equal(reacted[i], swept[i])
    np.testing.assert_array_equal(reacted[i], jreacted[i])
    np.testing.assert_array_equal(
        reacted[i], _oracle(jmodel, jparams, prompts[i], max_new[i]))
    assert rrouter.finished[i].finish_reason == "length"


def test_replica_kill_under_reactor_fails_over_as_jax():
  """One of two in-process replicas killed mid-decode under the reactor:
  the same failover, migration and finished counts as the JAX router's
  on the same episode, and every stream equals JAX ``generate``."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3, 9, 2), seed=8)
  seen = []
  for router, killer_mod, request_cls in (
      (Router(tmodel, tparams, num_replicas=2, device="cpu",
              config=_conf(tepl), **GEOMETRY), chaos, Request),
      (JaxRouter(jmodel, jparams, num_replicas=2, config=_conf(jepl),
                 **GEOMETRY), jchaos, JaxRequest)):
    killer = killer_mod.ReplicaKiller(router.replicas[0].engine,
                                      kill_calls=(3,))
    for i, p in enumerate(prompts):
      assert router.submit(request_cls(uid=i, prompt=p, max_new_tokens=6))
    placed = {router.placement[i] for i in range(4)}
    out = router.run()
    fleet = router.fleet_summary()
    seen.append({"placed": placed, "kills": killer.kills,
                 "failovers": router.failovers,
                 "migrated": router.migrated_requests,
                 "states": router.states(),
                 "finished": fleet["finished_requests"],
                 "reasons": {u: f.finish_reason
                             for u, f in router.finished.items()},
                 "out": {u: np.asarray(t).tolist() for u, t in out.items()}})
  assert seen[0] == seen[1]
  port = seen[0]
  assert port["placed"] == {0, 1} and port["kills"] == 1
  assert port["failovers"] == 1 and port["migrated"] == 2
  assert port["states"] == ["down", "healthy"] and port["finished"] == 4.0
  for i, p in enumerate(prompts):
    np.testing.assert_array_equal(port["out"][i],
                                  _oracle(jmodel, jparams, p, 6))


def _stash_state(transport_mod, config_cls, buffered):
  """A process transport (no child) with step 7 in flight and the
  socket's reader holding ``buffered`` bytes: one whole frame, or only
  a part of one."""
  import socket
  import struct
  rep = transport_mod.ProcessTransport(0, FACTORY, config=config_cls(),
                                       start=False)
  a, b = socket.socketpair()
  rep._reader = transport_mod.FrameReader(a)
  payload = json.dumps({"id": 7, "ok": True}).encode()
  frame = struct.pack(">I", len(payload)) + payload
  rep._reader.buf = frame if buffered == "whole" else frame[:-2]
  rep._inflight_step = 7
  return rep, (a, b)


@pytest.mark.parametrize("buffered", ["whole", "part"])
def test_step_ready_sees_a_reply_buffered_behind_another(buffered):
  """An interleaved submit can read the step reply off the socket into
  the frame reader's buffer, behind its own reply: the socket then never
  polls readable for it.  The port's ``step_ready`` reports such a whole
  buffered frame (the JAX package's sees only ``_pending``, and its
  reactor waits out the wire deadline); a part of a frame is not
  ready."""
  from easyparallellibrary_tpu.serving import transport as jtransport
  port, socks = _stash_state(ttransport, tepl.Config, buffered)
  ref, jsocks = _stash_state(jtransport, jepl.Config, buffered)
  try:
    assert port.step_ready() == (buffered == "whole")
    assert ref.step_ready() is False
    port._pending[7] = {"id": 7, "ok": True}
    ref._pending[7] = {"id": 7, "ok": True}
    assert port.step_ready() and ref.step_ready()
  finally:
    for sock in socks + jsocks:
      sock.close()


# ---------------------------------------------------------- HTTP / SSE


@pytest.mark.quick
def test_http_sse_stream_assembles_to_direct_submit():
  """Over the real socket the SSE stream (one token event per engine
  iteration, then one done) assembles to what a direct submit returns;
  the tokens in the frames are plain ints."""
  _, _, tmodel, tparams = _models()
  prompts = _prompts((5, 3, 7), seed=3)
  max_new = (8, 6, 5)
  direct = Router(tmodel, tparams, num_replicas=1, device="cpu",
                  config=_conf(tepl, reactor=False), **GEOMETRY)
  for i, p in enumerate(prompts):
    assert direct.submit(Request(uid=i, prompt=p, max_new_tokens=max_new[i]))
  direct_out = direct.run()
  libs = _build.loaded_count()
  router = Router(tmodel, tparams, num_replicas=1, device="cpu",
                  config=_conf(tepl), **GEOMETRY)
  with tfd.FrontDoor(router) as fd:
    assert fd.address[0] == "127.0.0.1" and fd.address[1] > 0
    assert tfd.healthz(fd.address)["states"] == ["healthy"]
    for i, p in enumerate(prompts):
      events = list(tfd.stream_generate(
          fd.address, {"uid": f"h{i}", "prompt": [int(t) for t in p],
                       "max_new_tokens": max_new[i]}))
      tokens = [d for e, d in events if e == "token"]
      dones = [d for e, d in events if e == "done"]
      assert dones == [{"finish_reason": "length",
                        "new_tokens": max_new[i], "truncated": False}]
      assert len(tokens) > 1
      streamed = [t for d in tokens for t in d["tokens"]]
      assert all(type(t) is int for t in streamed)
      np.testing.assert_array_equal([int(t) for t in p] + streamed,
                                    direct_out[i])
    assert fd.streamed_events >= sum(max_new) - len(max_new)
  assert _build.loaded_count() == libs


class FakeRouter:
  """A router that sheds every submit: the front door's parsing alone."""

  def __init__(self):
    self.on_tokens, self.finished, self.captured = [], {}, []
    self.steps, self.has_work = 0, False

  def submit(self, request):
    self.captured.append(request)
    self.finished[request.uid] = FinishedRequest(
        uid=request.uid, tokens=np.asarray(request.prompt, np.int32),
        new_tokens=0, finish_reason="shed")
    return False

  def cancel(self, uid):
    return False

  def step(self):
    return []

  def states(self):
    return ["healthy"]


def test_header_mapping_and_request_validation():
  """X-Deadline-S / X-TTFT-Budget-S / X-Priority map onto the request
  (headers win over the body), a shed admission is a done event, and
  malformed requests get a 400, over the real socket."""
  router = FakeRouter()
  with tfd.FrontDoor(router, config=_conf(tepl, reactor=False)) as fd:
    toks, done = tfd.generate(
        fd.address,
        {"prompt": [1, 2, 3], "max_new_tokens": 4, "deadline_s": 9.0,
         "temperature": 0.5, "top_k": 7, "seed": 11},
        headers={"X-Deadline-S": "2.5", "X-TTFT-Budget-S": "0.75",
                 "X-Priority": "latency"})
    assert toks == [] and done["finish_reason"] == "shed"
    (req,) = router.captured
    assert isinstance(req, Request)
    assert (req.deadline_s, req.ttft_budget_s, req.priority) == (
        2.5, 0.75, "latency")
    assert (req.max_new_tokens, req.temperature, req.top_k,
            req.seed) == (4, 0.5, 7, 11)
    np.testing.assert_array_equal(req.prompt, [1, 2, 3])
    for body, hdrs in [({"prompt": [], "max_new_tokens": 4}, None),
                       ({"prompt": "not-ids"}, None),
                       ({"prompt": [1, 2]}, {"X-Priority": "urgent"}),
                       ({"prompt": [1, 2]}, {"X-Deadline-S": "soon"})]:
      with pytest.raises(RuntimeError, match="HTTP 400"):
        list(tfd.stream_generate(fd.address, body, headers=hdrs))
    assert len(router.captured) == 1


TRACEPARENTS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "zz-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01",
    "00-" + "0" * 32 + "-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-" + "0" * 16 + "-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-0g",
    " 00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00 ",
]


def _parse_all(module):
  out = []
  for header in TRACEPARENTS:
    try:
      tid, pid, flags = module.parse_traceparent(header)
      out.append((tid, pid, flags, module.flow_id_from_trace_id(tid)))
    except ValueError:
      out.append("ValueError")
  return out


def test_traceparent_parse_and_mint_equal_jax():
  """``parse_traceparent``, ``flow_id_from_trace_id`` and
  ``mint_traceparent`` give the JAX functions' results on the same
  strings and ids; a minted header round-trips to its flow id."""
  assert _parse_all(tserver) == _parse_all(jserver)
  assert _parse_all(tserver)[0] == (
      "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7", "01",
      int("4bf92f3577b34da6a3ce929d0e0e4736", 16) & ((1 << 53) - 1))
  assert _parse_all(tserver)[1:10] == ["ValueError"] * 9
  for flow in (1, 12345, (1 << 53) - 1, 2 ** 40 + 7):
    minted = tserver.mint_traceparent(flow)
    assert minted == jserver.mint_traceparent(flow)
    tid, _, _ = tserver.parse_traceparent(minted)
    assert tserver.flow_id_from_trace_id(tid) == flow


def test_traceparent_echo_and_400_over_socket():
  """A caller's ``traceparent`` sets the request's flow id and comes back
  beside ``X-Request-Id``; an absent one is minted from the flow id; a
  malformed one is a 400 and submits nothing."""
  from easyparallellibrary_tpu_torch.serving.frontdoor.client import _post
  header = TRACEPARENTS[0]
  router = FakeRouter()
  with tfd.FrontDoor(router, config=_conf(tepl, reactor=False)) as fd:
    resp = _post(fd.address, {"uid": "tp-1", "prompt": [1, 2, 3],
                              "max_new_tokens": 2},
                 {"traceparent": header}, timeout=30.0)
    assert resp.status == 200
    assert resp.getheader("X-Request-Id") == "tp-1"
    assert resp.getheader("traceparent") == header
    resp.read()
    resp.close()
    assert router.captured[0].flow_id == tserver.flow_id_from_trace_id(
        "4bf92f3577b34da6a3ce929d0e0e4736")
    resp = _post(fd.address, {"uid": "tp-2", "prompt": [4, 5],
                              "max_new_tokens": 2}, None, timeout=30.0)
    minted = resp.getheader("traceparent")
    resp.read()
    resp.close()
    tid, _, _ = tserver.parse_traceparent(minted)
    assert tserver.flow_id_from_trace_id(tid) == router.captured[-1].flow_id
    for bad in ["garbage", "00-dead-beef-01", TRACEPARENTS[4]]:
      with pytest.raises(RuntimeError, match="HTTP 400"):
        list(tfd.stream_generate(fd.address, {"prompt": [1]},
                                 headers={"traceparent": bad}))
    assert len(router.captured) == 2


def test_cancel_on_disconnect_frees_slot_and_finalizes_flow():
  """A client that drops mid-stream (RST) cancels its request: reason
  ``"cancelled"``, the slot freed, the trace flow finalized with that
  reason, the fleet counting it once."""
  tracer = ttrace.install(ttrace.Tracer(enabled=True, ring_capacity=4096))
  _, _, tmodel, tparams = _models()
  (prompt,) = _prompts((6,), seed=5)
  router = Router(tmodel, tparams, num_replicas=1, device="cpu",
                  config=_conf(tepl, keepalive_s=0.1, write_timeout_s=2.0),
                  **GEOMETRY)
  engine = router.replicas[0].engine
  # Paced steps (~25 ms), so the drop lands mid-stream.
  chaos.HangingStepInjector(engine, hang_calls=range(1, 500), hang_s=0.025)
  with tfd.FrontDoor(router) as fd:
    client = chaos.DisconnectingClient(
        fd.address, {"uid": "gone", "prompt": [int(t) for t in prompt],
                     "max_new_tokens": 24}, after_events=2, rst=True)
    client.start()
    client.join(timeout=30.0)
    assert client.dropped and client.error is None
    assert 2 <= client.events_seen < 24
    assert _wait_for(lambda: getattr(router.finished.get("gone"),
                                     "finish_reason", None) == "cancelled")
    assert 0 < router.finished["gone"].new_tokens < 24
    assert _wait_for(lambda: not engine.has_work)
    assert engine.scheduler.active == {}
    assert fd.disconnect_cancels == 1
  assert router.fleet_summary()["finished_requests"] == 1.0
  finishes = [e for e in tracer.events() if e.get("ph") == "f"
              and e.get("args", {}).get("uid") == "gone"]
  assert finishes and finishes[-1]["args"]["reason"] == "cancelled"


def test_slow_reader_overflow_sheds_only_its_flow():
  """A reader that never drains its bounded queue overflows it and its
  flow alone is cancelled after the cycle, while a neighbour streams to
  JAX ``generate``'s tokens; the bound holds."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((6, 5), seed=7)
  # The stuck flow's own buffer is 2; the neighbour keeps the default,
  # so a loaded host cannot overflow it too.
  router = Router(tmodel, tparams, num_replicas=1, device="cpu",
                  config=_conf(tepl), **GEOMETRY)
  with tfd.FrontDoor(router) as fd:
    stuck = tserver._StreamState("stuck", prompt_len=6, buffer=2)
    with fd._streams_lock:
      fd._streams["stuck"] = stuck
    fd._commands.put(("submit", Request(uid="stuck", prompt=prompts[0],
                                        max_new_tokens=16), stuck))
    assert stuck.admitted.wait(timeout=30.0) and stuck.accepted
    toks, done = tfd.generate(
        fd.address, {"uid": "ok", "prompt": [int(t) for t in prompts[1]],
                     "max_new_tokens": 8})
    assert done["finish_reason"] == "length"
    np.testing.assert_array_equal([int(t) for t in prompts[1]] + toks,
                                  _oracle(jmodel, jparams, prompts[1], 8))
    assert _wait_for(lambda: getattr(router.finished.get("stuck"),
                                     "finish_reason", None) == "cancelled")
    assert stuck.overflow and fd.overflow_sheds == 1
    assert stuck.final["finish_reason"] == "cancelled"
    assert stuck.queue.qsize() <= 2
  assert router.fleet_summary()["finished_requests"] == 2.0


def _lone_overflow(fd_mod, server_mod, router, request_cls, prompt):
  """The fleet's only request, on a stream that overflows at once (a
  buffer of one batch nobody drains); returns its stream state."""
  door = fd_mod.FrontDoor(router).start()
  stuck = server_mod._StreamState("lone", prompt_len=len(prompt), buffer=1)
  with door._streams_lock:
    door._streams["lone"] = stuck
  door._commands.put(("submit", request_cls(uid="lone", prompt=prompt,
                                            max_new_tokens=16), stuck))
  assert stuck.admitted.wait(timeout=30.0) and stuck.accepted
  return door, stuck


def test_an_overflow_cancel_of_the_last_request_finalizes_its_flow():
  """An overflow cancel retires the request into its replica's finished
  buffer.  When it was the fleet's only request, the port's driver
  cycles once more and the flow gets its done event; the JAX front door
  never steps again, so the flow (and a client reading it, fed
  keepalives) waits for ever."""
  jmodel, jparams, tmodel, tparams = _models()
  (prompt,) = _prompts((6,), seed=7)
  router = Router(tmodel, tparams, num_replicas=1, device="cpu",
                  config=_conf(tepl), **GEOMETRY)
  door, stuck = _lone_overflow(tfd, tserver, router, Request, prompt)
  try:
    assert _wait_for(lambda: getattr(router.finished.get("lone"),
                                     "finish_reason", None) == "cancelled")
    assert _wait_for(lambda: stuck.final is not None)
    assert stuck.final["finish_reason"] == "cancelled"
    assert door.overflow_sheds == 1 and not router.has_work
  finally:
    door.close()
  jrouter = JaxRouter(jmodel, jparams, num_replicas=1, config=_conf(jepl),
                      **GEOMETRY)
  jdoor, jstuck = _lone_overflow(jfd, jserver, jrouter, JaxRequest, prompt)
  try:
    assert _wait_for(lambda: jdoor.overflow_sheds == 1)
    assert not _wait_for(lambda: jstuck.final is not None, timeout_s=2.0)
    assert "lone" not in jrouter.finished and not jrouter.has_work
  finally:
    jdoor.close()


# ---------------------------------------------------- wire compatibility


def _frames(client, address, prompts, max_new):
  return [list(client.stream_generate(
      address, {"uid": f"w{i}", "prompt": [int(t) for t in p],
                "max_new_tokens": max_new}))
          for i, p in enumerate(prompts)]


def test_wire_compatibility_both_ways():
  """The port's client reads the same frames from the JAX front door as
  from the port's, and the JAX client reads the port's front door: one
  wire, one framing, one schema."""
  jmodel, jparams, tmodel, tparams = _models()
  prompts = _prompts((5, 3, 7), seed=21)
  trouter = Router(tmodel, tparams, num_replicas=1, device="cpu",
                   config=_conf(tepl), **GEOMETRY)
  jrouter = JaxRouter(jmodel, jparams, num_replicas=1, config=_conf(jepl),
                      **GEOMETRY)
  with tfd.FrontDoor(trouter) as tdoor, jfd.FrontDoor(jrouter) as jdoor:
    port_on_port = _frames(tfd, tdoor.address, prompts, 6)
    port_on_jax = _frames(tfd, jdoor.address, prompts, 6)
    jax_on_port = _frames(jfd, tdoor.address, prompts, 6)
    assert tfd.healthz(jdoor.address) == jfd.healthz(jdoor.address)
    assert jfd.healthz(tdoor.address)["states"] == ["healthy"]
  assert port_on_port == port_on_jax == jax_on_port
  for frames, p in zip(port_on_port, prompts):
    assert frames[-1] == ("done", {"finish_reason": "length",
                                   "new_tokens": 6, "truncated": False})
    streamed = [t for e, d in frames if e == "token" for t in d["tokens"]]
    np.testing.assert_array_equal([int(t) for t in p] + streamed,
                                  _oracle(jmodel, jparams, p, 6))


# ----------------------------------------------- a stalled child (process)


def test_sigstop_under_the_reactor_other_child_keeps_stepping():
  """Two process replicas under the reactor; one child is SIGSTOPped
  with work in flight.  The reactor keeps stepping the other child while
  the stalled one waits out its wire deadline; then the stalled replica
  is condemned and fenced, its requests fail over, and every request
  finishes with ``generate``'s stream."""
  model, params = tiny_gpt(device="cpu")
  prompts = _prompts((6, 6, 6, 6), seed=13)
  config = tepl.Config({"serving": {"router": {
      "transport": "process", "reactor": True, "rpc_timeout_s": 3.0,
      "spawn_timeout_s": 90.0, "suspect_after": 600.0,
      "down_after": 1200.0}}})
  tepl.init(config, device="cpu")
  router = Router(num_replicas=2, config=config, factory=FACTORY,
                  device="cpu", paged=True, block_size=4, **GEOMETRY)
  try:
    for i, p in enumerate(prompts):
      assert router.submit(Request(uid=i, prompt=p, max_new_tokens=12))
    assert {router.placement[i] for i in range(4)} == {0, 1}
    victim = router.replicas[0]
    collects = {0: 0, 1: 0}
    collect_one = router._collect_one

    def counting(i, now):
      collects[i] += 1
      return collect_one(i, now)
    router._collect_one = counting
    reactor = router.reactor()
    reactor.cycle()
    staller = chaos.ProcessStaller(victim)
    staller.stall()
    t0 = time.monotonic()
    before = dict(collects)
    while router.failovers == 0:
      assert time.monotonic() - t0 < 60.0, "the stall was never condemned"
      reactor.cycle()
    stall_s = time.monotonic() - t0
    during = collects[1] - before[1]
    out = router.run()
    assert stall_s >= 2.5
    assert during > 1, "the other child stopped stepping during the stall"
    assert collects[0] - before[0] == 1       # the condemning collect
    assert router.states()[0] == "down"
    assert sorted(router.finished) == [0, 1, 2, 3]
    for i, p in enumerate(prompts):
      want = tgpt.generate(model, params, torch.from_numpy(p)[None].long(),
                           12)[0].numpy()
      assert router.finished[i].finish_reason == "length"
      np.testing.assert_array_equal(router.finished[i].tokens, want)
    assert set(out) <= set(range(4))
  finally:
    router.close()
