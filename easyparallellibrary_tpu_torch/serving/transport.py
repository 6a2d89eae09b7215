"""Replica transports: the fault boundary between the router and its
replicas (port of ``easyparallellibrary_tpu/serving/transport.py``).

:class:`ReplicaTransport` is the surface the
:class:`~easyparallellibrary_tpu_torch.serving.router.Router` speaks
(submit / cancel / step / snapshot / restore / evacuate, health beats,
load signals, finished records), with two implementations:

* :class:`InprocTransport`: an
  :class:`~easyparallellibrary_tpu_torch.serving.replica.EngineReplica`
  in this process (the default);
* :class:`ProcessTransport`: the replica lives in a spawned subprocess
  with its own CUDA context (a SIGKILL takes exactly one replica's
  memory).  Parent and child speak length-prefixed JSON frames over a
  ``socketpair``; the child is started with ``subprocess.Popen`` (never
  ``fork``: the parent may already hold a CUDA context).

The wire currency is :meth:`Request.snapshot` (the JAX package's v2
shape) and the scheduler's migration snapshots.  The layer is defensive
end to end, as in the JAX package:

* per-call deadlines with jittered exponential backoff on idempotent
  calls; ``submit`` / ``restore`` are idempotent through child-side uid
  dedup; ``step`` is never retried, and a step whose reply misses its
  deadline condemns the replica (fenced with SIGKILL at evacuation);
* every reply carries a beat: the child's watchdog and bad-step
  watermarks, ITL EWMA, load signals, its compile-sentinel count (kernel
  libraries loaded) and its kernel launch counters, which the parent
  accumulates across respawns (:attr:`ProcessTransport.kernel_launches`);
* a dead child (``Popen.poll``, pipe EOF) raises
  :class:`ReplicaDeadError`; every child is registered with an
  ``atexit`` reaper and asks for ``PR_SET_PDEATHSIG``;
* the parent keeps a journal of each admitted request's snapshot and
  committed-token watermark, advanced from step replies with
  acked-watermark resync; on a death ``evacuate()`` fences the child and
  rebuilds the snapshots from the journal, which the router replays on
  survivors.

Knobs: ``serving.router.transport`` (``"inproc"`` | ``"process"``),
``rpc_timeout_s`` / ``rpc_retries`` / ``rpc_backoff_s`` /
``spawn_timeout_s``.
"""

from __future__ import annotations

import atexit
import importlib
import itertools
import json
import os
import signal as _signal
import socket
import struct
import subprocess
import sys
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.serving.replica import EngineReplica
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FinishedRequest, Request)
from easyparallellibrary_tpu_torch.utils.logging import get_logger
from easyparallellibrary_tpu_torch.utils.retry import retry_call

# Wire protocol version, checked at child init — a parent/child build
# mismatch must fail loudly at spawn, not corrupt a journal mid-flight.
WIRE_VERSION = 1

_LEN = struct.Struct(">I")
_MAX_FRAME = 256 * 1024 * 1024


class TransportError(RuntimeError):
  """Base class for transport-layer failures."""


class ReplicaDeadError(TransportError):
  """The child process is gone (waitpid reaped it / the socket hit
  EOF) or has been condemned — the router must fail its requests over
  via the parent-side journal."""


class TransportTimeout(TransportError):
  """One RPC exceeded its wire deadline.  Idempotent calls retry with
  jittered backoff; a ``step`` timeout condemns the replica instead
  (the call is not idempotent)."""


class RemoteError(TransportError):
  """The child REPLIED with an application error (``ok: false``) — an
  UNambiguous outcome: the call was received and did not apply.  Carries
  the remote exception's type name so callers can translate client
  errors (a remote ``ValueError`` for a malformed request must surface
  as a ``ValueError``, never as replica death)."""

  def __init__(self, message: str, etype: str = ""):
    super().__init__(message)
    self.etype = etype


# ------------------------------------------------------------- framing --


def send_frame(sock: socket.socket, obj: Any) -> None:
  """Write one length-prefixed JSON frame (4-byte big-endian length +
  UTF-8 payload)."""
  payload = json.dumps(obj).encode("utf-8")
  sock.sendall(_LEN.pack(len(payload)) + payload)


class FrameReader:
  """Incremental frame reader that survives deadlines mid-frame.

  Partial bytes stay buffered across calls, so a timeout between (or
  inside) frames never desynchronizes the stream — the next ``read``
  resumes exactly where the wire left off."""

  def __init__(self, sock: socket.socket):
    self.sock = sock
    self.buf = b""

  def has_frame(self) -> bool:
    """True when a whole frame already sits in the buffer (read off the
    socket with an earlier one), so ``read`` returns without the socket
    polling readable."""
    if len(self.buf) < _LEN.size:
      return False
    (n,) = _LEN.unpack_from(self.buf)
    return len(self.buf) >= _LEN.size + n

  def read(self, timeout: Optional[float] = None) -> Any:
    """Next frame as a decoded object; ``timeout`` is a per-call
    deadline in seconds (None blocks forever).  Raises
    :class:`TransportTimeout` on deadline, :class:`ReplicaDeadError`
    on EOF."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
      if len(self.buf) >= _LEN.size:
        (n,) = _LEN.unpack_from(self.buf)
        if n > _MAX_FRAME:
          raise TransportError(f"frame length {n} exceeds limit")
        if len(self.buf) >= _LEN.size + n:
          payload = self.buf[_LEN.size:_LEN.size + n]
          self.buf = self.buf[_LEN.size + n:]
          return json.loads(payload.decode("utf-8"))
      if deadline is None:
        self.sock.settimeout(None)
      else:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
          raise TransportTimeout("rpc deadline exceeded")
        self.sock.settimeout(remaining)
      try:
        chunk = self.sock.recv(1 << 16)
      except socket.timeout as e:
        raise TransportTimeout("rpc deadline exceeded") from e
      except OSError as e:
        raise ReplicaDeadError(f"socket error: {e}") from e
      if not chunk:
        raise ReplicaDeadError("peer closed the socket (pipe EOF)")
      self.buf += chunk


# -------------------------------------------------- wire (de)serializers --


def encode_finished(fin: FinishedRequest) -> Dict[str, Any]:
  return {"uid": fin.uid,
          "tokens": [int(t) for t in np.asarray(fin.tokens).reshape(-1)],
          "new_tokens": int(fin.new_tokens),
          "finish_reason": fin.finish_reason}


def decode_finished(d: Dict[str, Any]) -> FinishedRequest:
  return FinishedRequest(
      uid=d["uid"], tokens=np.asarray(d["tokens"], np.int32),
      new_tokens=int(d["new_tokens"]), finish_reason=d["finish_reason"])


def resolve_factory(factory) -> Tuple[Callable, Dict[str, Any]]:
  """Resolve a replica factory spec to ``(callable, kwargs)``.

  A spec is ``"module:attr"``, ``{"fn": "module:attr", "kwargs":
  {...}}``, or a module-level callable (serialized by reference).  The
  callable runs IN THE CHILD and returns ``(model, params)`` — the
  child builds its own weights, so live tensors never cross the wire,
  and parent and child hold bit-identical weights by construction (same
  factory, same seed: ``weights.init_params`` draws with numpy)."""
  kwargs: Dict[str, Any] = {}
  if isinstance(factory, dict):
    kwargs = dict(factory.get("kwargs") or {})
    factory = factory["fn"]
  if callable(factory):
    return factory, kwargs
  mod, sep, attr = str(factory).partition(":")
  if not sep:
    raise ValueError(
        f"replica factory must be 'module:attr' (got {factory!r})")
  fn = importlib.import_module(mod)
  for part in attr.split("."):
    fn = getattr(fn, part)
  return fn, kwargs


def factory_spec(factory) -> Dict[str, Any]:
  """Wire form of a factory: ``{"fn": "module:attr", "kwargs": ...}``."""
  if isinstance(factory, dict):
    spec = {"fn": factory["fn"], "kwargs": dict(factory.get("kwargs")
                                                or {})}
  elif callable(factory):
    spec = {"fn": f"{factory.__module__}:{factory.__qualname__}",
            "kwargs": {}}
  else:
    spec = {"fn": str(factory), "kwargs": {}}
  # Fail in the parent, at construction — not in the child, at spawn.
  resolve_factory(spec)
  return spec


# ------------------------------------------------------- orphan reaping --

# Every live child Popen, so a dying router (normal exit, sys.exit, an
# unhandled exception) reaps its fleet: a dead router never leaks
# children.  The belt to the child-side prctl suspenders.
_LIVE_CHILDREN: Dict[int, subprocess.Popen] = {}
_REAPER_INSTALLED = False


def _reap_orphans() -> None:
  for pid, proc in list(_LIVE_CHILDREN.items()):
    try:
      if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=5.0)
    except Exception:  # pragma: no cover - best-effort at interpreter exit
      pass
    _LIVE_CHILDREN.pop(pid, None)


def _register_child(proc: subprocess.Popen) -> None:
  global _REAPER_INSTALLED
  if not _REAPER_INSTALLED:
    atexit.register(_reap_orphans)
    _REAPER_INSTALLED = True
  _LIVE_CHILDREN[proc.pid] = proc


# ----------------------------------------------------------- interface --


class ReplicaTransport:
  """The surface the router drives a replica through.

  Serving: ``submit`` / ``cancel`` / ``step`` (or the pipelined
  ``step_send`` + ``step_recv`` pair, so process replicas overlap their
  steps) / ``has_work`` / ``finished``.  Load signals:
  ``queue_depth`` / ``num_active`` / ``num_slots`` / ``load``.  Health:
  ``watchdog_timeouts`` / ``bad_steps`` / ``itl_ewma_s`` /
  ``wire_beat`` / ``alive`` / ``exit_signal`` / ``compile_count``.
  Migration: ``snapshot_requests`` / ``restore_request`` /
  ``evacuate``.  Lifecycle: ``ensure_started`` / ``close``.
  Observability: ``rpc_counters``.

  Implementations are duck-typed (tests inject fakes); this class only
  documents the contract and supplies inert defaults for the
  transport-specific extras."""

  kind = "abstract"
  wire_beat: Optional[Dict[str, Any]] = None
  exit_signal: Optional[int] = None
  child_pid: Optional[int] = None

  @property
  def alive(self) -> bool:
    return True

  def ensure_started(self) -> bool:
    """(Re)start the replica's host if it is gone; True when a restart
    actually happened (the engine state is fresh — compile count resets,
    caches are cold)."""
    return False

  def step_send(self) -> None:
    """Dispatch one step without waiting (pipelining hook; no-op for
    in-process replicas, whose step runs at :meth:`step_recv`)."""

  def step_recv(self) -> List[FinishedRequest]:
    raise NotImplementedError

  def rpc_counters(self) -> Dict[str, int]:
    return {"rpc_retries": 0, "rpc_timeouts": 0, "child_restarts": 0}

  def readiness_fd(self) -> Optional[int]:
    """A select()-able fd that turns readable when this replica's
    pipelined step reply lands (the reactor's wait handle).  None: no
    wire, the replica computes at :meth:`step_recv`, so the reactor
    treats it as ready once dispatched."""
    return None

  def step_ready(self) -> bool:
    """True when :meth:`step_recv` would return without blocking on the
    wire (in-process replicas compute inside it)."""
    return True


class InprocTransport(EngineReplica, ReplicaTransport):
  """The default transport: an in-process ``EngineReplica`` (this IS
  one: same construction, same synchronous step) wearing the transport
  interface, so the router treats every fleet member alike.  The inert
  affordances (``alive``, ``ensure_started``, ``step_send``,
  ``rpc_counters``) are :class:`ReplicaTransport`'s defaults."""

  kind = "inproc"

  def step_recv(self) -> List[FinishedRequest]:
    return self.step()

  @property
  def compile_count(self) -> int:
    """The compile sentinel's count: kernel libraries this process has
    loaded (the GPU counterpart of the JAX step's compile cache)."""
    return int(_build.loaded_count())


# ------------------------------------------------------ process transport --


class _JournalEntry:
  """Parent-side recovery record for one admitted request: the
  versioned request snapshot plus the committed-token watermark
  advanced from step replies."""

  __slots__ = ("request", "generated", "submitted_at", "requeues",
               "first_token_emitted")

  def __init__(self, request: Dict[str, Any], submitted_at: float,
               generated: Optional[List[int]] = None, requeues: int = 0,
               first_token_emitted: bool = False):
    self.request = request
    self.generated: List[int] = list(generated or [])
    self.submitted_at = float(submitted_at)
    self.requeues = int(requeues)
    self.first_token_emitted = bool(first_token_emitted)

  def snapshot(self) -> Dict[str, Any]:
    return {"request": self.request,
            "generated": [int(t) for t in self.generated],
            "requeues": self.requeues,
            "first_token_emitted": (self.first_token_emitted
                                    or bool(self.generated)),
            "submitted_at": self.submitted_at}


class ProcessTransport(ReplicaTransport):
  """A replica hosted in a spawned subprocess (module docstring).
  ``factory`` builds ``(model, params)`` in the child; ``engine_kwargs``
  must be JSON-serializable and pass through to the child's
  :class:`EngineReplica` (``device`` among them: the child raises when
  it was asked for ``"cuda"`` and has none).  ``checkpoint`` names a
  checkpoint directory the child restores over the factory's params
  (the rollout's green replicas)."""

  kind = "process"

  def __init__(self, index: int, factory, *, config=None,
               engine_kwargs: Optional[Dict[str, Any]] = None,
               rpc_timeout_s: Optional[float] = None,
               rpc_retries: Optional[int] = None,
               rpc_backoff_s: Optional[float] = None,
               spawn_timeout_s: Optional[float] = None,
               checkpoint: Optional[str] = None,
               start: bool = True):
    from easyparallellibrary_tpu_torch.env import Env
    self.index = index
    self._checkpoint = checkpoint
    self._config = config if config is not None else Env.get().config
    rconf = self._config.serving.router
    self._factory = factory_spec(factory)
    self._engine_kwargs = dict(engine_kwargs or {})
    self.rpc_timeout_s = (rpc_timeout_s if rpc_timeout_s is not None
                          else rconf.rpc_timeout_s)
    self.rpc_retries = (rpc_retries if rpc_retries is not None
                        else rconf.rpc_retries)
    self.rpc_backoff_s = (rpc_backoff_s if rpc_backoff_s is not None
                          else rconf.rpc_backoff_s)
    self.spawn_timeout_s = (spawn_timeout_s if spawn_timeout_s is not None
                            else rconf.spawn_timeout_s)
    # Crash-recovery journal: uid -> _JournalEntry, insertion-ordered by
    # admission; _service_order is the child's last reported line order.
    self._journal: "OrderedDict[Any, _JournalEntry]" = OrderedDict()
    self._service_order: List[Any] = []
    self.finished: Dict[Any, FinishedRequest] = {}
    self._finished_backlog: List[FinishedRequest] = []
    self.on_first_token: List[Callable[[Any], None]] = []
    # Parent-side per-iteration token delivery: fn(uid, [tok, ...]) for
    # every journal watermark advance — the child's scheduler commits
    # ride the step reply's `progress` suffixes, so the wire already
    # carries them; this fans the FRESH tokens (beyond what the parent
    # had) out exactly once, mirroring how `first` -> on_first_token.
    self.on_tokens: List[Callable[[Any, List[int]], None]] = []
    self.wire_beat: Optional[Dict[str, Any]] = None
    self.exit_signal: Optional[int] = None
    self.rpc_retries_total = 0
    self.rpc_timeouts_total = 0
    self.child_restarts = 0
    # The children's kernel launch counters, summed over every child
    # this transport spawned (a child's launches are invisible to the
    # parent: each beat reports its running totals, and the deltas are
    # added here, so a killed child's launches stay counted).
    self.kernel_launches: Dict[str, int] = {}
    self._beat_launches: Dict[str, int] = {}
    # Cross-process trace harvest and clock alignment.  Every reply's beat can
    # carry the child tracer's clock; paired with the parent-side
    # send/recv perf_counter_ns stamps per rid it yields an NTP-style
    # midpoint offset estimate.  The best (smallest-RTT) sample wins
    # within a heartbeat-cadence resync window.
    obs = self._config.observability
    self._harvest_on = bool(obs.enabled and obs.harvest.enabled)
    self._harvest_final_timeout_s = float(obs.harvest.final_timeout_s)
    self.trace_events_harvested = 0
    self._send_ns: Dict[Any, int] = {}
    self._clock_offset_us: Optional[float] = None
    self._clock_rtt_ns: Optional[int] = None
    self._clock_at = 0.0
    self._clock_resync_s = max(float(rconf.heartbeat_s), 0.1)
    self.last_spawn_s = 0.0     # spawn-to-ready wall time (start())
    self._t_spawn = 0.0
    self._init_id: Optional[int] = None
    self._proc: Optional[subprocess.Popen] = None
    self._sock: Optional[socket.socket] = None
    self._reader: Optional[FrameReader] = None
    self._seq = itertools.count(1)
    self._pending: Dict[int, Dict[str, Any]] = {}
    self._inflight_step: Optional[int] = None
    self._condemned = False
    self._stats_cache = None
    if start:
      self.start()

  # ------------------------------------------------------------ lifecycle

  @property
  def child_pid(self) -> Optional[int]:
    return self._proc.pid if self._proc is not None else None

  @property
  def alive(self) -> bool:
    """Usable for RPC: a live child, an open socket, and no
    condemnation (a step timeout condemns — the child may be stalled
    mid-step and must be fenced, never spoken to again)."""
    if self._condemned or self._proc is None or self._sock is None:
      return False
    if self._proc.poll() is not None:
      self._note_exit()
      return False
    return True

  def _note_exit(self) -> None:
    if self._proc is not None and self._proc.returncode is not None:
      rc = self._proc.returncode
      self.exit_signal = -rc if rc < 0 else None
      _LIVE_CHILDREN.pop(self._proc.pid, None)

  def start(self) -> None:
    """Spawn the child, hand it the socketpair end, and block until its
    engine is built (``ready``).  The child process is registered with
    the atexit reaper before anything can fail past the spawn.
    ``last_spawn_s`` records the spawn-to-ready wall time: the cold
    cost of a capacity add or a respawn."""
    if self.alive:
      return
    self._launch()
    self._await_ready()

  @staticmethod
  def start_all(transports: List["ProcessTransport"]) -> None:
    """Start several children at once: every child is launched first
    and builds its engine while the others do, then each is awaited.
    If one fails, every child started here is fenced before raising."""
    launched = []
    try:
      for t in transports:
        if not t.alive:
          t._launch()
          launched.append(t)
      for t in launched:
        t._await_ready()
    except BaseException:
      for t in launched:
        t._fence()
      raise

  def _launch(self) -> None:
    """Spawn the child and post its init frame (not awaited)."""
    self._t_spawn = time.monotonic()
    parent_sock, child_sock = socket.socketpair()
    try:
      env = dict(os.environ)
      # The child resolves the package the same way the parent did,
      # even when running from a source checkout that is not installed.
      pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
          os.path.abspath(__file__))))
      env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
      # `-c` rather than `-m`: runpy would re-execute replica.py as
      # __main__ after serving/__init__ already imported it, and warn.
      worker_cmd = (
          "from easyparallellibrary_tpu_torch.serving.replica import "
          f"replica_worker_main; raise SystemExit(replica_worker_main("
          f"{child_sock.fileno()}))")
      self._proc = subprocess.Popen(
          [sys.executable, "-c", worker_cmd],
          pass_fds=(child_sock.fileno(),), env=env, close_fds=True)
    except Exception:
      parent_sock.close()
      raise
    finally:
      child_sock.close()
    _register_child(self._proc)
    self._sock = parent_sock
    self._reader = FrameReader(parent_sock)
    self._pending.clear()
    self._inflight_step = None
    self._condemned = False
    self.exit_signal = None
    self.wire_beat = None
    self._beat_launches = {}
    self._seq = itertools.count(1)
    # A fresh child is a fresh tracer timebase: the old offset (and the
    # min-RTT gate that protects it) must not survive a respawn.
    self._send_ns.clear()
    self._clock_offset_us = None
    self._clock_rtt_ns = None
    self._clock_at = 0.0
    try:
      self._init_id = self._post("init", {
          "wire_version": WIRE_VERSION,
          "index": int(self.index),
          "factory": self._factory,
          "engine_kwargs": self._engine_kwargs,
          "config": self._config.to_dict(),
          "checkpoint": self._checkpoint,
      })
    except Exception:
      self._fence()
      raise

  def _await_ready(self) -> None:
    """Wait for the launched child's init reply (its engine built)."""
    try:
      reply = self._wait(self._init_id, timeout=self.spawn_timeout_s)
    except Exception:
      # A child that failed init (version mismatch, factory error,
      # spawn deadline) must not linger half-born: fence before raising.
      self._fence()
      raise
    info = reply.get("result") or {}
    self.last_spawn_s = time.monotonic() - self._t_spawn
    if (self.wire_beat or {}).get("trace_now_us") is not None:
      # Handshake clock sample: the init reply's RTT spans the whole
      # engine build (useless for a midpoint estimate), so take one
      # tight ping now — _ingest pairs its send/recv stamps with the
      # beat's child clock and seeds the offset.
      try:
        self._call("ping", {}, retry=False, condemn=False,
                   timeout=min(self.rpc_timeout_s, 5.0))
      except TransportError:
        pass
    self.device_name = info.get("device_name", "?")
    get_logger().info(
        "replica %d: process transport up (pid %d, %s: %s, spawn %.1fs)",
        self.index, self._proc.pid, info.get("platform", "?"),
        self.device_name, self.last_spawn_s)

  def ensure_started(self) -> bool:
    """Respawn a dead/condemned child (breaker probe, operator rejoin).
    The fresh engine is cold: compile count resets, the KV cache is
    empty — exactly what a real process restart costs.  Requests the
    journal still owns (placed here, never failed over) are replayed
    into the fresh child in service order, so a respawn resumes its own
    backlog bit-exactly instead of stranding it."""
    if self.alive:
      return False
    self._fence()
    self.start()
    self.child_restarts += 1
    for entry in self._iter_journal():
      self._call("restore", {"snap": entry.snapshot(), "front": False})
    return True

  def _fence(self) -> None:
    """Make the child inert: SIGKILL if still running (a condemned or
    stalled child must never race the fleet for requests the journal is
    about to fail over), reap the pid, close the wire."""
    if self._proc is not None:
      if self._proc.poll() is None:
        try:
          self._proc.kill()
        except OSError:  # pragma: no cover - already gone
          pass
        try:
          self._proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:  # pragma: no cover
          pass
      self._note_exit()
    if self._sock is not None:
      try:
        self._sock.close()
      except OSError:  # pragma: no cover
        pass
      self._sock = None
      self._reader = None
    self._condemned = True
    # The corpse will never flush again: close whatever spans its
    # harvested ring left open, at its last rebased timestamp, so the
    # merged trace stays schema-valid and shows the work ENDING here.
    pid = self.child_pid
    if pid is not None:
      tracer = trace_lib.get_tracer()
      if tracer.enabled:
        tracer.close_remote(
            pid, reason="killed" if self.exit_signal else "lost")

  def kill(self, sig: int = _signal.SIGKILL) -> None:
    """Deliver ``sig`` to the child (the chaos harness's real-process
    fault injection rides this; see testing/chaos.py ProcessKiller)."""
    if self._proc is not None and self._proc.poll() is None:
      os.kill(self._proc.pid, sig)

  def close(self):
    if self.alive:
      try:
        sid = self._post("shutdown", {})
        self._wait(sid, timeout=min(5.0, self.rpc_timeout_s))
        self._proc.wait(timeout=5.0)
      except (TransportError, subprocess.TimeoutExpired):
        pass
    self._fence()

  # ------------------------------------------------------------- rpc core

  def _mark_dead(self) -> None:
    self._condemned = True
    if self._proc is not None and self._proc.poll() is not None:
      self._note_exit()

  def _post(self, method: str, params: Dict[str, Any]) -> int:
    if self._sock is None or self._condemned:
      raise ReplicaDeadError(f"replica {self.index}: transport closed")
    rid = next(self._seq)
    try:
      # Bound the send too (FrameReader leaves the last per-read
      # timeout on the shared socket, and a child that will not drain
      # its receive buffer for a full deadline is a dead replica, not
      # a reason to block the router forever).
      self._sock.settimeout(self.rpc_timeout_s)
      send_frame(self._sock, {"id": rid, "m": method, "p": params})
    except OSError as e:  # socket.timeout included
      self._mark_dead()
      raise ReplicaDeadError(
          f"replica {self.index}: send failed ({e})") from e
    # Clock-offset raw material: the reply pairs this send stamp with
    # its receive stamp (bounded: abandoned rids are evicted oldest
    # first — their replies will never arrive).
    self._send_ns[rid] = time.perf_counter_ns()
    while len(self._send_ns) > 256:
      self._send_ns.pop(next(iter(self._send_ns)))
    return rid

  def _read_frame(self, timeout: Optional[float]) -> Dict[str, Any]:
    # Seam for wire-level chaos (testing/chaos.py ReplyDropper).
    return self._reader.read(timeout)

  def _wait(self, rid: int, timeout: Optional[float] = None
            ) -> Dict[str, Any]:
    if rid in self._pending:
      frame = self._pending.pop(rid)
      self._prune_pending()
      return self._check(frame)
    deadline = time.monotonic() + (self.rpc_timeout_s
                                   if timeout is None else timeout)
    while True:
      remaining = deadline - time.monotonic()
      if remaining <= 0:
        self.rpc_timeouts_total += 1
        raise TransportTimeout(
            f"replica {self.index}: rpc {rid} timed out")
      try:
        frame = self._read_frame(remaining)
      except TransportTimeout:
        self.rpc_timeouts_total += 1
        raise
      except ReplicaDeadError:
        self._mark_dead()
        raise
      self._ingest(frame)
      if frame.get("id") == rid:
        self._prune_pending()
        return self._check(frame)
      self._pending[frame["id"]] = frame

  def _prune_pending(self) -> None:
    """Drop stashed replies no one will ever wait on again.  The router
    is single-threaded, so the only rid that can still be awaited after
    a ``_wait`` returns is the pipelined in-flight step; everything
    else belongs to abandoned (timed-out, retried) calls whose content
    ``_ingest`` already applied — keeping the frames would leak."""
    for k in [k for k in self._pending if k != self._inflight_step]:
      del self._pending[k]

  def _check(self, frame: Dict[str, Any]) -> Dict[str, Any]:
    if not frame.get("ok", False):
      etype = frame.get("etype", "error")
      raise RemoteError(
          f"replica {self.index}: remote {etype}: "
          f"{frame.get('error', '?')}", etype=etype)
    return frame

  def _update_clock(self, send_ns: Optional[int], recv_ns: int,
                    child_now_us: Optional[float]) -> None:
    """NTP-style midpoint offset estimate: the child's tracer clock at
    ``child_now_us`` corresponds to roughly the midpoint of this RPC's
    send/recv ``perf_counter_ns`` pair, so
    ``parent_ts ≈ child_ts + offset``.  The error bound is RTT/2:
    prefer the smallest-RTT sample, re-opening acceptance on the
    heartbeat cadence (``serving.router.heartbeat_s``) so the estimate
    tracks long-run drift without letting a step-inflated RTT (the
    reply that waited on a whole engine step) wreck a tight one."""
    if send_ns is None or child_now_us is None:
      return
    tracer = trace_lib.get_tracer()
    if not tracer.enabled:
      return
    rtt = recv_ns - send_ns
    now = time.monotonic()
    stale = now - self._clock_at >= self._clock_resync_s
    if self._clock_rtt_ns is not None and rtt >= self._clock_rtt_ns \
        and not (stale and rtt <= 4 * self._clock_rtt_ns):
      return
    self._clock_offset_us = (tracer.at_us((send_ns + recv_ns) // 2)
                             - float(child_now_us))
    self._clock_rtt_ns = rtt
    self._clock_at = now

  def _harvest_ingest(self, result: Any) -> None:
    """Merge a reply's piggybacked trace chunk into the ambient tracer
    (exactly once — `_ingest` is the single funnel every received frame
    passes through)."""
    chunk = result.get("trace") if isinstance(result, dict) else None
    if not chunk:
      return
    tracer = trace_lib.get_tracer()
    if not tracer.enabled or self._clock_offset_us is None:
      return
    pid = self.child_pid or int((self.wire_beat or {}).get("pid") or 0)
    if not pid:
      return
    self.trace_events_harvested += tracer.ingest_remote(
        pid, chunk.get("events") or (),
        offset_us=self._clock_offset_us,
        label=f"replica{self.index} worker (pid {pid})")

  def _ingest(self, frame: Dict[str, Any]) -> None:
    """Apply a reply's side-band content exactly once, whether it is
    the awaited reply or a stale one that surfaced while waiting for a
    different id (the lost-reply recovery path: a late step reply still
    advances the journal watermark and still surfaces its finishes).
    Side-band now includes the distributed-tracing material: every
    beat's child-clock sample feeds the offset estimate, and any
    reply — step piggyback, explicit harvest, evacuate/shutdown final
    flush, or the worker's unsolicited EOF flush — may carry a trace
    chunk."""
    recv_ns = time.perf_counter_ns()
    send_ns = self._send_ns.pop(frame.get("id"), None)
    beat = frame.get("beat")
    if beat:
      self.wire_beat = beat
      self._note_launches(beat.get("launches"))
      self._update_clock(send_ns, recv_ns, beat.get("trace_now_us"))
    if not frame.get("ok", False):
      return
    result = frame.get("result") or {}
    self._harvest_ingest(result)
    if frame.get("m") != "step":
      return
    for uid, start, tokens in result.get("progress", ()):
      entry = self._journal.get(uid)
      if entry is None:
        continue
      # Cumulative-watermark resync: the child sends the suffix from
      # the count the parent last acked; overlap overwrites (the
      # stream is deterministic, so overlapping tokens are identical).
      prev = len(entry.generated)
      entry.generated[start:] = [int(t) for t in tokens]
      if self.on_tokens and len(entry.generated) > prev:
        # Stream delivery exactly once: only the tokens beyond what the
        # journal already held are fresh — a stale frame's overlap
        # re-applied above never re-fires (deterministic stream).
        fresh = list(entry.generated[prev:])
        for cb in self.on_tokens:
          cb(uid, fresh)
    order = result.get("order")
    if order is not None:
      self._service_order = list(order)
    fins = [decode_finished(d) for d in result.get("finished", ())]
    for fin in fins:
      self._journal.pop(fin.uid, None)
      self.finished[fin.uid] = fin
    self._finished_backlog.extend(fins)
    for uid in result.get("first", ()):
      for cb in self.on_first_token:
        cb(uid)

  def _note_launches(self, counts: Optional[Dict[str, int]]) -> None:
    """Add the growth of the child's running launch totals since its
    previous beat (a respawned child starts again from zero)."""
    if not counts:
      return
    for key, total in counts.items():
      delta = int(total) - self._beat_launches.get(key, 0)
      if delta > 0:
        self.kernel_launches[key] = self.kernel_launches.get(key, 0) + delta
    self._beat_launches = {k: int(v) for k, v in counts.items()}

  def reset_launch_counts(self) -> None:
    """Zero the summed launch counters (the child's own keep running;
    only growth after this call is counted)."""
    self.kernel_launches = {}

  def _call(self, method: str, params: Dict[str, Any], *,
            retry: bool = True, timeout: Optional[float] = None,
            condemn: bool = True) -> Dict[str, Any]:
    """One request/reply exchange.  ``retry=True`` (idempotent calls
    only) rides utils.retry with jittered exponential backoff; the
    final timeout condemns the replica (``condemn=True``) — an
    unresponsive child must be fenced, not trusted with half-applied
    state.  Pass ``condemn=False`` for best-effort observability polls
    whose deadline miss must NEVER cost a healthy replica its life."""

    def once():
      rid = self._post(method, params)
      return self._wait(rid, timeout=timeout)

    def note(attempt, exc):
      self.rpc_retries_total += 1

    try:
      if not retry or self.rpc_retries <= 0:
        return once()
      return retry_call(once, retries=self.rpc_retries,
                        backoff_s=self.rpc_backoff_s,
                        max_backoff_s=max(self.rpc_backoff_s * 8, 1.0),
                        jitter=0.25, exceptions=(TransportTimeout,),
                        on_retry=note, what=f"replica {self.index} {method}")
    except TransportTimeout as e:
      if not condemn:
        raise
      self._condemned = True
      raise ReplicaDeadError(
          f"replica {self.index}: {method} exhausted its deadline "
          f"({self.rpc_timeout_s:.1f}s x {self.rpc_retries + 1}); "
          f"condemned for fencing") from e

  # -------------------------------------------------------------- serving

  def submit(self, request: Request) -> bool:
    """Journal-then-send: the request spec is journaled BEFORE the RPC,
    so an ambiguous outcome (timeout, child death mid-call) is always
    recoverable — failover replays the journal entry, and the child's
    uid dedup guarantees a retried or replayed submit admits once."""
    snap = request.snapshot()
    uid = request.uid
    self._journal[uid] = _JournalEntry(snap, time.monotonic())
    try:
      reply = self._call("submit", {"snap": snap})
    except RemoteError as e:
      # The child REPLIED with an error: unambiguously not admitted —
      # the journal must not resurrect it later.  A remote client
      # error (malformed request) surfaces as the client exception the
      # engine contract promises, never as replica death.
      self._journal.pop(uid, None)
      if e.etype == "ValueError":
        raise ValueError(str(e)) from e
      raise
    result = reply.get("result") or {}
    accepted = bool(result.get("accepted"))
    if not accepted:
      self._journal.pop(uid, None)
      fin = result.get("finished")
      if fin is not None:
        self.finished[uid] = decode_finished(fin)
    return accepted

  def cancel(self, uid: Any) -> bool:
    if not self.alive:
      entry = self._journal.pop(uid, None)
      if entry is None:
        return False
      generated = np.asarray(entry.generated, np.int32)
      fin = FinishedRequest(
          uid=uid,
          tokens=np.concatenate([
              np.asarray(entry.request["prompt"], np.int32), generated]),
          new_tokens=int(generated.size), finish_reason="cancelled")
      self.finished[uid] = fin
      self._finished_backlog.append(fin)
      return True
    reply = self._call("cancel", {"uid": uid})
    return bool((reply.get("result") or {}).get("cancelled"))

  def _acked(self) -> List[List[Any]]:
    return [[uid, len(entry.generated)]
            for uid, entry in self._journal.items()]

  def step_send(self) -> None:
    """Dispatch one step (pipelined: the router sends to every process
    replica, then collects — concurrent children overlap their sweeps).
    The request carries the journal's acked watermarks so the child
    knows exactly which token suffix the parent still needs."""
    if self._inflight_step is not None:
      return
    self._inflight_step = self._post("step", {"acked": self._acked()})

  def step_recv(self) -> List[FinishedRequest]:
    """Collect the pipelined step.  NEVER retried: a step is not
    idempotent, so a timeout condemns the replica — the journal (not a
    second RPC) is the recovery path, and the condemned child is fenced
    with SIGKILL at evacuation so it cannot double-serve."""
    rid, self._inflight_step = self._inflight_step, None
    if rid is None:
      rid = self._post("step", {"acked": self._acked()})
    try:
      self._wait(rid)
    except TransportTimeout as e:
      self._condemned = True
      raise ReplicaDeadError(
          f"replica {self.index}: step reply missed its "
          f"{self.rpc_timeout_s:.1f}s deadline; condemned for fencing"
      ) from e
    fins, self._finished_backlog = self._finished_backlog, []
    return fins

  def step(self) -> List[FinishedRequest]:
    self.step_send()
    return self.step_recv()

  def readiness_fd(self) -> Optional[int]:
    """The socket's fd while a step is in flight: readable exactly when
    the child's reply (or a side-band frame) lands."""
    if (self._inflight_step is None or self._sock is None
        or self._condemned):
      return None
    try:
      return self._sock.fileno()
    except OSError:
      return None

  def step_ready(self) -> bool:
    """True when the in-flight step's reply is already off the socket:
    stashed by an interleaved submit or cancel that drained it while
    waiting for its own reply, or buffered whole behind that reply.
    The socket will not poll readable for either."""
    if self._inflight_step is None:
      return False
    return (self._inflight_step in self._pending
            or (self._reader is not None and self._reader.has_frame()))

  @property
  def has_work(self) -> bool:
    if not self.alive:
      return bool(self._journal)
    beat = self.wire_beat or {}
    return bool(beat.get("has_work")) or bool(self._journal)

  # --------------------------------------------------------- load signals

  def _beat_get(self, key: str, default=0):
    beat = self.wire_beat or {}
    return beat.get(key, default)

  @property
  def queue_depth(self) -> int:
    return int(self._beat_get("queue_depth"))

  @property
  def num_active(self) -> int:
    return int(self._beat_get("num_active"))

  @property
  def num_slots(self) -> int:
    return int(self._beat_get("num_slots",
                              self._engine_kwargs.get("num_slots", 1)))

  @property
  def load(self) -> int:
    if not self.alive:
      return len(self._journal)
    return int(self._beat_get("load", len(self._journal)))

  # ------------------------------------------------------- health signals

  @property
  def watchdog_timeouts(self) -> int:
    return int(self._beat_get("watchdog_timeouts"))

  @property
  def bad_steps(self) -> int:
    return int(self._beat_get("bad_steps"))

  @property
  def itl_ewma_s(self) -> float:
    return float(self._beat_get("itl_ewma_s", 0.0))

  @property
  def compile_count(self) -> int:
    return int(self._beat_get("compiles"))

  @property
  def checkpoint_version(self) -> int:
    """This replica's checkpoint version, from the last wire beat
    (falling back to the engine kwargs the child was spawned with —
    correct before the first beat arrives, same pattern as
    ``num_slots``)."""
    return int(self._beat_get(
        "checkpoint_version",
        self._engine_kwargs.get("checkpoint_version", 0)))

  def rpc_counters(self) -> Dict[str, int]:
    return {"rpc_retries": int(self.rpc_retries_total),
            "rpc_timeouts": int(self.rpc_timeouts_total),
            "child_restarts": int(self.child_restarts),
            "trace_events_harvested": int(self.trace_events_harvested)}

  def harvest(self, drain: bool = True) -> int:
    """Pull the child's tracer ring into the ambient tracer via the
    explicit low-priority ``harvest`` RPC (each reply stays within the
    configured sweep byte bound; ``drain=True`` loops until the ring is
    dry or ``observability.harvest.final_timeout_s`` elapses).  Best
    effort: a deadline miss is an observability gap, never a death
    sentence for a healthy replica.  Returns the events harvested."""
    if not self.alive or not self._harvest_on:
      return 0
    before = self.trace_events_harvested
    deadline = time.monotonic() + self._harvest_final_timeout_s
    while True:
      try:
        reply = self._call("harvest", {}, retry=False, condemn=False,
                           timeout=min(self.rpc_timeout_s, 5.0))
      except TransportError:
        break
      result = reply.get("result") or {}
      if not drain or result.get("done") or not result.get("trace"):
        break
      if time.monotonic() >= deadline:
        break
    return self.trace_events_harvested - before

  @property
  def stats(self):
    """Fleet-rollup stats: fetched from the child on demand and loaded
    into a parent-side ServingStats twin; the last good snapshot is
    served when the child is unreachable (a dead replica's history
    still belongs in the rollup)."""
    if self.alive:
      try:
        # condemn=False: a slow metrics reply is an observability miss,
        # never a death sentence for a healthy replica.
        reply = self._call("stats", {}, retry=False, condemn=False,
                           timeout=min(self.rpc_timeout_s, 5.0))
        state = (reply.get("result") or {}).get("stats")
        if state is not None:
          from easyparallellibrary_tpu_torch.profiler.serving import (
              ServingStats)
          if self._stats_cache is None:
            self._stats_cache = ServingStats()
          self._stats_cache.load_state(state)
      except TransportError:
        pass
    return self._stats_cache

  # ------------------------------------------------------------ migration

  def snapshot_requests(self) -> List[Dict[str, Any]]:
    if self.alive:
      reply = self._call("snapshot", {})
      return list((reply.get("result") or {}).get("snaps", ()))
    return [e.snapshot() for e in self._iter_journal()]

  def owns(self, uid: Any) -> bool:
    """True when this transport's journal holds ``uid`` — i.e. an
    ambiguously-applied call left the request HERE to recover (the
    router uses this to avoid double-placing a snapshot whose restore
    timed out but may have landed)."""
    return uid in self._journal

  def restore_request(self, snap: Dict[str, Any],
                      front: bool = False) -> Any:
    uid = snap["request"]["uid"]
    pinned = snap["request"].get("checkpoint_version")
    if pinned is not None and int(pinned) != self.checkpoint_version:
      # Refused BEFORE journaling: a cross-version snapshot must never
      # enter this replica's recovery journal (the child would reject
      # the replay anyway — the scheduler enforces the same policy —
      # but the parent-side check keeps the refusal unambiguous and
      # free of wire traffic).
      raise ValueError(
          f"cross-version restore refused: request {uid!r} is pinned to "
          f"checkpoint version {int(pinned)} but replica {self.index} "
          f"serves version {self.checkpoint_version} — prefix replay "
          f"across versions is not bit-exact")
    self._journal[uid] = _JournalEntry(
        snap["request"], snap.get("submitted_at", time.monotonic()),
        generated=snap.get("generated"),
        requeues=snap.get("requeues", 0),
        first_token_emitted=snap.get("first_token_emitted", False))
    try:
      self._call("restore", {"snap": snap, "front": bool(front)})
    except RemoteError:
      # Unambiguous rejection: the snapshot is still the caller's to
      # re-place — a stale journal entry here would double-serve it.
      self._journal.pop(uid, None)
      raise
    return uid

  def _iter_journal(self) -> List[_JournalEntry]:
    """Journal entries in the child's last reported service order
    (requests never seen in a reply keep submit order, at the back)."""
    ordered: List[_JournalEntry] = []
    seen = set()
    for uid in self._service_order:
      entry = self._journal.get(uid)
      if entry is not None and uid not in seen:
        ordered.append(entry)
        seen.add(uid)
    for uid, entry in self._journal.items():
      if uid not in seen:
        ordered.append(entry)
    return ordered

  def evacuate(self) -> List[Dict[str, Any]]:
    """Snapshot + remove every queued/in-flight request.  Graceful RPC
    while the child is responsive (exact scheduler snapshots); on a
    dead, condemned or unresponsive child: **fence** (SIGKILL — a
    stalled child must not keep decoding requests the fleet is about
    to re-place) and synthesize snapshots from the journal — no RPC to
    the corpse, bit-exact by prefix replay from the last committed
    watermark."""
    if self.alive:
      try:
        reply = self._call("evacuate", {}, retry=False)
        snaps = list((reply.get("result") or {}).get("snaps", ()))
        for snap in snaps:
          self._journal.pop(snap["request"]["uid"], None)
        # Anything the journal still holds was resolved child-side in
        # replies we already ingested; nothing else to recover.
        return snaps
      except TransportError:
        pass
    self._fence()
    snaps = [e.snapshot() for e in self._iter_journal()]
    self._journal.clear()
    self._service_order = []
    if snaps:
      get_logger().warning(
          "replica %d: child fenced%s; recovered %d request(s) from the "
          "parent-side journal", self.index,
          (f" (exit signal {self.exit_signal})"
           if self.exit_signal else ""), len(snaps))
    return snaps

  def __repr__(self):
    return (f"ProcessTransport({self.index}, pid={self.child_pid}, "
            f"alive={self.alive}, journal={len(self._journal)})")
