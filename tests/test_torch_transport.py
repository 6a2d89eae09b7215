"""Process replicas in the port (``serving/transport.py`` and the worker
of ``serving/replica.py``) against the JAX package's router, on the CPU.

Each spawning test starts at most two children of
``testing.factories.tiny_gpt`` (fp32, ``device="cpu"``, one torch
thread), bounds itself (the transport's ``spawn_timeout_s`` /
``rpc_timeout_s``, and a ``signal.alarm`` guard) and kills whatever it
spawned at teardown.  The oracle is the JAX router, fault-free, over the
same weights (the port's ``tiny_gpt`` weights in the JAX tree layout):

* a real SIGKILL of one child mid-decode loses nothing, every greedy
  stream equals the JAX router's, the survivor's library count does not
  move, the dead pid is reaped, ``rejoin(0, force=True)`` respawns with
  a new pid, and after ``close()`` no child is left;
* ``drain(1, timeout_s=0)`` migrates through the evacuate RPC;
* ``ReplyDropper``: a lost submit reply is retried and deduplicated in
  the child; a lost step reply condemns the replica, and its requests
  replay from the journal's stale watermark without a token committed
  twice;
* ``ProcessStaller``: a stopped child misses its step deadline, is
  condemned, fenced with SIGKILL and its requests fail over;
* traced children: their spans are harvested and a failed-over
  request's flow crosses both replicas' tracks;
* a child asked for ``"cuda"`` without a card raises at spawn.

Framing, factory specs, the journal's snapshots and the worker's init
checks are held against the JAX module without spawning.
"""

import json
import os
import signal
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyparallellibrary_tpu as jepl
from easyparallellibrary_tpu.models import GPT as JaxGPT
from easyparallellibrary_tpu.models import GPTConfig as JaxGPTConfig
from easyparallellibrary_tpu.serving import Request as JaxRequest
from easyparallellibrary_tpu.serving import Router as JaxRouter
from easyparallellibrary_tpu.serving import transport as jtransport
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.observability import slo as tslo
from easyparallellibrary_tpu_torch.observability import trace as ttrace
from easyparallellibrary_tpu_torch.runtime.saver import params_tree
from easyparallellibrary_tpu_torch.serving import (
    InprocTransport, RemoteError, ReplicaDeadError, Request, Router)
from easyparallellibrary_tpu_torch.serving import replica as treplica
from easyparallellibrary_tpu_torch.serving import transport as ttransport
from easyparallellibrary_tpu_torch.testing import chaos
from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt

torch.set_num_threads(1)

FACTORY = {"fn": "easyparallellibrary_tpu_torch.testing.factories:tiny_gpt",
           "kwargs": {}}
GEOMETRY = dict(num_slots=2, prefill_chunk=4, paged=True, block_size=4)
MAX_NEW = 8
# Per-test wall guard (seconds); a child spawn takes a few seconds here.
GUARD_S = 240


def _router_conf(**router):
  # Breaker hold-outs longer than any test: a dead child comes back by an
  # explicit rejoin, never by a probe on a slow machine's wall clock.
  router = {"transport": "process", "spawn_timeout_s": 90.0,
            "rpc_timeout_s": 60.0, "suspect_after": 600.0,
            "down_after": 1200.0, **router}
  return {"serving": {"router": router}}


@pytest.fixture(autouse=True)
def _guarded(monkeypatch):
  """One torch thread in every child, the port's env reset, a wall-clock
  guard, and every child this test spawned killed at teardown."""
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
    tepl.Env.get().reset()


def _jax_tree(tparams):
  """The port's weights as the JAX package's params tree."""
  tree = {}
  for path, t in params_tree(tparams).items():
    node = tree
    *parents, leaf = path.split("/")
    for k in parents:
      node = node.setdefault(k, {})
    node[leaf] = jnp.asarray(t.numpy())
  return tree


def _prompts(lengths=(5, 3, 9, 2), seed=8):
  r = np.random.RandomState(seed)
  return [r.randint(0, 64, (n,)).astype(np.int32) for n in lengths]


_WANT = {}


def _jax_fault_free(prompts, seed):
  """The JAX router's fault-free streams over the children's weights."""
  if seed not in _WANT:
    _, tparams = tiny_gpt(device="cpu")
    jmodel = JaxGPT(JaxGPTConfig(vocab_size=64, num_layers=2, num_heads=4,
                                 d_model=32, d_ff=64, max_seq_len=32,
                                 dtype=jnp.float32))
    router = JaxRouter(jmodel, _jax_tree(tparams), num_replicas=2,
                       **GEOMETRY)
    for i, p in enumerate(prompts):
      router.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW))
    _WANT[seed] = {u: np.asarray(t) for u, t in router.run().items()}
  return _WANT[seed]


def _process_router(n=2, config=None, **router):
  cfg = tepl.Config(config or _router_conf(**router))
  return Router(num_replicas=n, config=cfg, factory=FACTORY, device="cpu",
                **GEOMETRY)


def _submit_all(router, prompts):
  for i, p in enumerate(prompts):
    assert router.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))


def _gone(pid):
  try:
    os.kill(pid, 0)
  except ProcessLookupError:
    return True
  return False


def _assert_streams(router, want, n):
  assert sorted(router.finished) == list(range(n))
  for i in range(n):
    assert router.finished[i].finish_reason == "length"
    np.testing.assert_array_equal(router.finished[i].tokens, want[i],
                                  err_msg=f"req {i}")


# ------------------------------------------------------ spawning tests


def test_sigkill_of_a_child_loses_nothing_then_respawn_and_no_orphan():
  prompts = _prompts()
  want = _jax_fault_free(prompts, 8)
  router = _process_router()
  try:
    for rep in router.replicas:
      assert rep.alive and rep.kind == "process"
    _submit_all(router, prompts)
    assert set(router.placement.values()) == {0, 1}
    for _ in range(3):
      router.step()
    survivor_libs = router.replicas[1].compile_count
    victim = chaos.ProcessKiller(router.replicas[0]).kill()
    router.run()
    assert router.failovers == 1
    assert router.replicas[0].exit_signal == signal.SIGKILL
    assert _gone(victim)
    _assert_streams(router, want, len(prompts))
    assert router.replicas[1].compile_count == survivor_libs
    # The children's launches reach the parent through the beat: on the
    # CPU the plain version ran, no kernel.
    launches = router.replicas[1].kernel_launches
    assert launches.get("paged_attention_plain", 0) > 0
    assert launches.get("paged_attention", 0) == 0
    assert router.rejoin(0, force=True)
    rep0 = router.replicas[0]
    assert rep0.alive and rep0.child_pid != victim
    assert rep0.child_restarts == 1
    router.submit(Request(uid="post", prompt=prompts[0],
                          max_new_tokens=MAX_NEW))
    np.testing.assert_array_equal(router.run()["post"], want[0])
    pids = [rep.child_pid for rep in router.replicas]
  finally:
    router.close()
  assert all(_gone(pid) for pid in pids)
  assert not ttransport._LIVE_CHILDREN


def test_drain_migrates_through_the_evacuate_rpc():
  prompts = _prompts((6, 4, 7, 3), seed=21)
  want = _jax_fault_free(prompts, 21)
  router = _process_router()
  try:
    _submit_all(router, prompts)
    for _ in range(3):
      router.step()
    on_one = [u for u, r in router.placement.items() if r == 1]
    assert on_one
    router.drain(1, timeout_s=0.0)
    router.step()
    assert router.migrated_requests == len(on_one)
    assert router.replicas[1].alive          # evacuated, not fenced
    assert router.state(1) == "draining"
    router.run()
    _assert_streams(router, want, len(prompts))
    assert router.rejoin(1) and router.state(1) == "healthy"
    assert router.replicas[1].child_restarts == 0   # warm, same child
  finally:
    router.close()


def test_reply_dropper_dedups_submits_and_replays_a_lost_step():
  """A dropped submit reply (the child admitted the request) is retried
  and answered from the child's dedup record: admitted once.  A dropped
  step reply (the child committed tokens the journal never saw) condemns
  the replica, which is fenced, and its requests replay from the stale
  watermark on the survivor: no token is committed twice."""
  prompts = _prompts()
  want = _jax_fault_free(prompts, 8)
  router = _process_router(rpc_backoff_s=0.01)
  try:
    victim = router.replicas[0]
    dropper = chaos.ReplyDropper(victim, drop=(0,))
    _submit_all(router, prompts)
    assert dropper.dropped and dropper.dropped[0]["m"] == "submit"
    assert victim.rpc_counters()["rpc_retries"] == 1
    dropper.uninstall()
    for _ in range(2):
      router.step()
    assert victim.has_work
    chaos.ReplyDropper(victim, drop=(0,))
    router.run()
    assert router.failovers == 1
    assert victim.exit_signal == signal.SIGKILL
    assert router.router_counters()["rpc_timeouts"] >= 1
    _assert_streams(router, want, len(prompts))
    for i, p in enumerate(prompts):
      assert router.finished[i].new_tokens == MAX_NEW
  finally:
    router.close()


def test_process_staller_is_condemned_and_fenced():
  prompts = _prompts((5, 6, 3, 4), seed=41)
  want = _jax_fault_free(prompts, 41)
  router = _process_router()
  try:
    _submit_all(router, prompts)
    for _ in range(2):
      router.step()                           # warm: no cold first step
    rep0 = router.replicas[0]
    rep0.rpc_timeout_s = 1.0
    staller = chaos.ProcessStaller(rep0)
    pid = staller.stall()
    router.step()
    assert router.state(0) == "down" and router.failovers == 1
    assert rep0.exit_signal == signal.SIGKILL and _gone(pid)
    staller.resume()                          # finds nothing to wake
    router.run()
    _assert_streams(router, want, len(prompts))
  finally:
    router.close()


def test_traced_children_are_harvested_and_a_flow_crosses_replicas(
    tmp_path):
  """Observability on: a child's spans ride its step replies into the
  parent's tracer; after a SIGKILL mid-decode the merged export
  validates, carries the parent and both children, and a failed-over
  request is one flow (``s`` ... ``f``) touching all three."""
  prompts = _prompts()
  want = _jax_fault_free(prompts, 8)
  conf = _router_conf()
  conf["observability"] = {"enabled": True}
  cfg = tepl.Config(conf)
  tepl.init(cfg, device="cpu")
  tracer = ttrace.ensure_configured(cfg)
  router = _process_router(config=conf)
  pids = [rep.child_pid for rep in router.replicas]
  try:
    _submit_all(router, prompts)
    for _ in range(3):
      router.step()
    assert router.replicas[0].has_work
    chaos.ProcessKiller(router.replicas[0]).kill()
    router.run()
    _assert_streams(router, want, len(prompts))
    router.harvest_traces()
    assert router.router_counters()["trace_events_harvested"] > 0
  finally:
    router.close()
  path = str(tmp_path / "trace.json")
  assert tracer.export(path)
  events = ttrace.validate_trace(path)
  parent = {e["pid"] for e in events if e.get("ph") != "M"} - set(pids)
  assert len(parent) == 1 and set(pids) <= {
      e["pid"] for e in events if e.get("ph") != "M"}
  flows = {}
  for ev in events:
    if ev.get("ph") in ("s", "t", "f"):
      flows.setdefault(ev["id"], []).append(ev)
  spanning = [fid for fid, evs in flows.items()
              if parent | set(pids) <= {e["pid"] for e in evs}]
  assert spanning, "no failed-over flow touches the parent and both children"
  for fid in spanning:
    phases = [e["ph"] for e in flows[fid]]
    assert phases[0] == "s" and phases[-1] == "f", (fid, phases)


def test_a_child_asked_for_cuda_without_a_card_raises():
  if torch.cuda.is_available():
    pytest.skip("this machine has a card: the child would find it")
  cfg = tepl.Config(_router_conf(spawn_timeout_s=60.0))
  with pytest.raises(RemoteError, match="no CUDA device"):
    ttransport.ProcessTransport(0, FACTORY, config=cfg,
                                engine_kwargs={"device": "cuda", **GEOMETRY})
  assert not ttransport._LIVE_CHILDREN      # fenced, not orphaned


# --------------------------------------------------- without spawning


def test_frames_are_the_jax_frames_and_survive_partial_reads():
  """``send_frame`` writes the JAX module's bytes; ``FrameReader`` reads
  a frame split across writes and across a deadline, and raises the
  dead-replica error on EOF (and the JAX reader reads the port's
  frames)."""
  obj = {"id": 3, "m": "step", "p": {"acked": [[1, 4], ["u", 0]]}}
  for send, reader_cls in ((ttransport.send_frame, jtransport.FrameReader),
                           (jtransport.send_frame, ttransport.FrameReader)):
    a, b = socket.socketpair()
    send(a, obj)
    assert reader_cls(b).read(5.0) == obj
    a.close()
    b.close()
  a, b = socket.socketpair()
  try:
    payload = json.dumps(obj).encode()
    raw = ttransport._LEN.pack(len(payload)) + payload
    reader = ttransport.FrameReader(b)
    a.sendall(raw[:3])
    with pytest.raises(ttransport.TransportTimeout):
      reader.read(0.05)
    a.sendall(raw[3:9])
    with pytest.raises(ttransport.TransportTimeout):
      reader.read(0.05)
    a.sendall(raw[9:])
    assert reader.read(5.0) == obj
    a.close()
    with pytest.raises(ReplicaDeadError):
      reader.read(5.0)
  finally:
    b.close()


def test_factory_specs_and_journal_snapshots_equal_jax():
  spec = ttransport.factory_spec(FACTORY["fn"])
  assert spec == {"fn": FACTORY["fn"], "kwargs": {}}
  fn, kwargs = ttransport.resolve_factory({"fn": FACTORY["fn"],
                                           "kwargs": {"seed": 3}})
  assert fn is tiny_gpt and kwargs == {"seed": 3}
  assert ttransport.factory_spec(tiny_gpt)["fn"] == FACTORY["fn"]
  with pytest.raises(ValueError, match="module:attr"):
    ttransport.factory_spec("no_colon")
  req = Request(uid="j", prompt=np.arange(1, 4, dtype=np.int32),
                max_new_tokens=5, flow_id=9).snapshot()
  got = ttransport._JournalEntry(req, 1.5, generated=[7, 8]).snapshot()
  want = jtransport._JournalEntry(req, 1.5, generated=[7, 8]).snapshot()
  assert got == want and got["first_token_emitted"] is True
  fin = treplica.FinishedRequest(uid=1, tokens=np.arange(3), new_tokens=1,
                                 finish_reason="length")
  assert ttransport.encode_finished(fin) == jtransport.encode_finished(fin)


def test_worker_init_checks_the_wire_version_and_the_device():
  a, b = socket.socketpair()
  try:
    worker = treplica._WorkerServer(b)
    with pytest.raises(ValueError, match="wire version mismatch"):
      worker.do_init({"wire_version": ttransport.WIRE_VERSION + 1})
    if not torch.cuda.is_available():
      with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.do_init({"wire_version": ttransport.WIRE_VERSION,
                        "factory": FACTORY, "config": {},
                        "engine_kwargs": {"device": "cuda"}})
    out = worker.do_init({"wire_version": ttransport.WIRE_VERSION,
                          "factory": FACTORY, "config": {},
                          "engine_kwargs": {"device": "cpu", **GEOMETRY}})
    assert out == {"pid": os.getpid(), "platform": "cpu",
                   "device_name": "cpu"}
    beat = worker._beat()
    assert beat["num_slots"] == 2 and beat["compiles"] >= 0
    assert set(beat["launches"]) >= {"paged_attention",
                                     "paged_attention_plain"}
  finally:
    a.close()
    b.close()


def test_inproc_transport_defaults():
  model, params = tiny_gpt(device="cpu")
  rep = InprocTransport(0, model, params, device="cpu", **GEOMETRY)
  assert rep.kind == "inproc" and rep.alive and not rep.ensure_started()
  assert rep.rpc_counters() == {"rpc_retries": 0, "rpc_timeouts": 0,
                                "child_restarts": 0}
  assert rep.wire_beat is None and rep.child_pid is None
  assert rep.compile_count >= 0
  rep.submit(Request(uid=0, prompt=np.arange(1, 5, dtype=np.int32),
                     max_new_tokens=2))
  rep.step_send()
  assert rep.step_recv() == [] and rep.load == 1
