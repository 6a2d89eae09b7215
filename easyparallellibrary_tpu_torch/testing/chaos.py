"""Fault injectors (port of the training and serving parts of
``easyparallellibrary_tpu/testing/chaos.py``): the adversaries the
resilience layers are tested against.

Training (``runtime/resilience.py``, ``runtime/loop.py``):

* :func:`corrupt_shard` / :func:`corrupt_index` damage a committed
  checkpoint (bit rot, truncation, deletion);
* :func:`nan_batch` and :class:`NaNInjector` poison batches;
* :class:`FlakyIterator` and :func:`flaky` raise transient errors;
* :class:`SigtermInjector` delivers a real SIGTERM mid-stream.

Serving (``serving/resilience.py``):

* :class:`NaNLogitsInjector` wraps the engine's step callable and hands
  chosen device calls fully-NaN parameters, so the model really computes
  non-finite logits and the engine's finiteness verdict judges real
  device output;
* :class:`HangingStepInjector` sleeps before chosen calls, tripping the
  step watchdog;
* :class:`FlakyDrafter` raises or proposes garbage on chosen calls.

Fleet (``serving/router.py``, ``serving/transport.py``):

* in process: :class:`ReplicaKiller` (chosen step calls raise: a
  replica dying mid-step), :class:`ReplicaHang` (a host sleep the
  watchdog must surface) and :class:`FlappingHealth` (a replica that
  keeps dying and recovering, against the circuit breaker);
* front door clients: :class:`SlowReader` (drains its stream too slowly)
  and :class:`DisconnectingClient` (vanishes mid-stream);
* process replicas, for real: :class:`ProcessKiller` (SIGKILL of the
  child), :class:`ProcessStaller` (SIGSTOP: the wire deadline must
  condemn and fence it) and :class:`ReplyDropper` (reply frames read
  and discarded at the parent: the exactly-once machinery under test).
"""

from __future__ import annotations

import os
import signal as _signal
import socket as _socket
import struct
import threading
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, Optional,
                    Sequence, Tuple)

import numpy as np
import torch


# -------------------------------------------------- checkpoint corruption --


def _shard_files(ckpt_dir: str) -> list:
  names = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
  if not names:
    raise FileNotFoundError(f"no shard files under {ckpt_dir}")
  return names


def corrupt_shard(ckpt_dir: str, shard: int = 0, mode: str = "flip",
                  offset: int = -64) -> str:
  """Damage one committed shard file: ``"flip"`` XORs a byte at
  ``offset`` (bit rot; only the checksum can catch it), ``"truncate"``
  drops the trailing half, ``"delete"`` removes it.  Returns its path."""
  path = os.path.join(ckpt_dir, _shard_files(ckpt_dir)[shard])
  if mode == "delete":
    os.remove(path)
    return path
  size = os.path.getsize(path)
  if mode == "truncate":
    with open(path, "r+b") as f:
      f.truncate(max(1, size // 2))
    return path
  if mode == "flip":
    pos = offset % size
    with open(path, "r+b") as f:
      f.seek(pos)
      byte = f.read(1)
      f.seek(pos)
      f.write(bytes([byte[0] ^ 0xFF]))
    return path
  raise ValueError(f"unknown corruption mode {mode!r}")


def corrupt_index(ckpt_dir: str, mode: str = "truncate") -> str:
  """Damage a checkpoint's ``index.json``: ``"truncate"``, ``"garbage"``
  (unparsable bytes) or ``"delete"``."""
  path = os.path.join(ckpt_dir, "index.json")
  if mode == "delete":
    os.remove(path)
  elif mode == "truncate":
    with open(path, "r+b") as f:
      f.truncate(max(1, os.path.getsize(path) // 3))
  elif mode == "garbage":
    with open(path, "wb") as f:
      f.write(b"\x00not json\xff")
  else:
    raise ValueError(f"unknown corruption mode {mode!r}")
  return path


# ------------------------------------------------------- numeric poison --


def nan_batch(batch):
  """A copy of ``batch`` (a dict / list / tuple tree) with every floating
  leaf fully NaN; tensors stay on their device."""
  if isinstance(batch, dict):
    return {k: nan_batch(v) for k, v in batch.items()}
  if isinstance(batch, (list, tuple)):
    return type(batch)(nan_batch(v) for v in batch)
  if isinstance(batch, torch.Tensor):
    return torch.full_like(batch, float("nan")) \
        if batch.is_floating_point() else batch
  arr = np.asarray(batch)
  if np.issubdtype(arr.dtype, np.floating):
    return np.full_like(arr, np.nan)
  return batch


class NaNInjector:
  """A per-step batch source poisoning chosen steps with NaNs.

  ``batch_fn(step) -> batch`` is the clean stream; steps in
  ``bad_steps`` come out poisoned — with ``once=True`` only the first
  time they are drawn (a replay after a rollback sees clean data).  A
  ``fit`` data factory: it takes ``start_step``.  ``poison(batch)``
  (default :func:`nan_batch`) makes the bad batch: a token batch has no
  floating leaf, so a caller poisons it its own way."""

  def __init__(self, batch_fn: Callable[[int], Any],
               bad_steps: Sequence[int], num_steps: int,
               once: bool = True, poison: Callable[[Any], Any] = None):
    self.batch_fn = batch_fn
    self.bad_steps = set(bad_steps)
    self.num_steps = num_steps
    self.once = once
    self.poison = poison or nan_batch
    self.poisoned: list = []

  def __call__(self, start_step: int = 0) -> Iterator[Any]:
    def gen():
      for step in range(start_step, self.num_steps):
        batch = self.batch_fn(step)
        if step in self.bad_steps:
          if self.once:
            self.bad_steps.discard(step)
          self.poisoned.append(step)
          batch = self.poison(batch)
        yield batch
    return gen()


# -------------------------------------------------------- transient IO --


class FlakyIterator:
  """Iterator raising a transient exception ``failures`` times at
  position ``fail_at`` before yielding that element."""

  def __init__(self, items: Iterable[Any], fail_at: int = 0,
               failures: int = 1,
               exc_factory: Callable[[], BaseException] = lambda:
               IOError("chaos: transient read failure")):
    self._items = list(items)
    self.fail_at = fail_at
    self.failures_left = failures
    self.exc_factory = exc_factory
    self._pos = 0

  def __iter__(self):
    return self

  def __next__(self):
    if self._pos >= len(self._items):
      raise StopIteration
    if self._pos == self.fail_at and self.failures_left > 0:
      self.failures_left -= 1
      raise self.exc_factory()
    item = self._items[self._pos]
    self._pos += 1
    return item


def flaky(fn: Callable, failures: int = 1,
          exc_factory: Callable[[], BaseException] = lambda:
          IOError("chaos: transient failure")) -> Callable:
  """``fn`` raising a transient exception on its first ``failures``
  calls."""
  state = {"left": failures}

  def wrapped(*args, **kwargs):
    if state["left"] > 0:
      state["left"] -= 1
      raise exc_factory()
    return fn(*args, **kwargs)

  wrapped.chaos_state = state
  return wrapped


# ---------------------------------------------------------- preemption --


class SigtermInjector:
  """Iterable delivering SIGTERM to this process when batch ``at_batch``
  (0-based) is drawn, then continuing to yield — ``fit`` finishes the
  step in flight, checkpoints and exits, as under a scheduler's
  preemption."""

  def __init__(self, batch: Any, at_batch: int = 3,
               max_batches: int = 10_000):
    self.batch = batch
    self.at_batch = at_batch
    self.max_batches = max_batches
    self._drawn = 0

  def __iter__(self):
    return self

  def __next__(self):
    if self._drawn >= self.max_batches:
      raise StopIteration
    if self._drawn == self.at_batch:
      os.kill(os.getpid(), _signal.SIGTERM)
    self._drawn += 1
    return self.batch


# ------------------------------------------------------- serving faults --


class _StepFnWrapper:
  """Base of the step interceptors: installs itself over
  ``engine._step_fn`` (``fn(params, plan[, num_draft])``) and counts the
  device calls."""

  def __init__(self, engine):
    self.engine = engine
    self.inner = engine._step_fn
    self.calls = 0
    engine._step_fn = self

  def uninstall(self):
    self.engine._step_fn = self.inner


class NaNLogitsInjector(_StepFnWrapper):
  """Poison chosen step calls so the model genuinely computes non-finite
  logits.

  For call indices in ``bad_calls`` (0-based, every step dispatch
  counts), the params argument is swapped for a copy with every floating
  tensor times NaN (same names, shapes, dtypes and device).  A retry of
  the poisoned work is a later call and sees clean params: a transient
  fault.  Adjacent indices (``(3, 4)``) model a persistent one that must
  escalate from retry to requeue.  ``poisoned`` lists the calls that
  were poisoned."""

  def __init__(self, engine, bad_calls: Sequence[int]):
    super().__init__(engine)
    self.bad_calls = set(bad_calls)
    self.poisoned: list = []
    self._nan_params = None

  def _poison(self, params):
    if self._nan_params is None:
      self._nan_params = {
          name: p * float("nan") if p.is_floating_point() else p
          for name, p in params.items()}
    return self._nan_params

  def __call__(self, params, *args):
    call, self.calls = self.calls, self.calls + 1
    if call in self.bad_calls:
      self.poisoned.append(call)
      params = self._poison(params)
    return self.inner(params, *args)


class HangingStepInjector(_StepFnWrapper):
  """Stall chosen step calls by ``hang_s`` of host sleep, which the
  serving watchdog (``serving.resilience.step_timeout_s``) exists to
  surface.  The step then completes normally: outputs stay exact."""

  def __init__(self, engine, hang_calls: Sequence[int],
               hang_s: float = 0.05):
    super().__init__(engine)
    self.hang_calls = set(hang_calls)
    self.hang_s = hang_s
    self.hangs = 0

  def __call__(self, params, *args):
    call, self.calls = self.calls, self.calls + 1
    if call in self.hang_calls:
      self.hangs += 1
      time.sleep(self.hang_s)
    return self.inner(params, *args)


class FlakyDrafter:
  """Drafter wrapper that raises (``mode="raise"``) or proposes uniformly
  random tokens (``mode="garbage"``) on chosen ``propose`` calls.  The
  engine must degrade a raising drafter to zero drafts for the step, and
  verification must reject garbage; either way the committed output
  stays exact."""

  def __init__(self, inner, bad_calls: Sequence[int],
               mode: str = "raise", seed: int = 0):
    if mode not in ("raise", "garbage"):
      raise ValueError(f"unknown FlakyDrafter mode {mode!r}")
    self.inner = inner
    self.bad_calls = set(bad_calls)
    self.mode = mode
    self.calls = 0
    self.faults = 0
    self._rng = np.random.RandomState(seed)
    self._vocab: Optional[int] = None

  @property
  def k(self) -> int:
    return self.inner.k

  def bind(self, engine) -> None:
    self._vocab = engine.model.cfg.vocab_size
    self.inner.bind(engine)

  def propose(self, plan, histories):
    call, self.calls = self.calls, self.calls + 1
    if call in self.bad_calls:
      self.faults += 1
      if self.mode == "raise":
        raise RuntimeError("chaos: drafter failure")
      N = plan.draft_cap.shape[0]
      drafts = self._rng.randint(
          0, self._vocab or 2, (N, self.k)).astype(np.int32)
      return drafts, np.asarray(plan.draft_cap, np.int32)
    return self.inner.propose(plan, histories)

  def observe_commit(self, new_cursors) -> None:
    self.inner.observe_commit(new_cursors)

  def observe_skip(self, plan) -> None:
    self.inner.observe_skip(plan)


# ------------------------------------------------------------ fleet faults --


class ReplicaKiller(_StepFnWrapper):
  """Kill an in-process replica mid-decode: the step calls in
  ``kill_calls`` (0-based) raise once each, so the router sees a replica
  die with requests in flight and must fail them over.  The replica's
  host state survives for evacuation; :class:`ProcessKiller` is the real
  thing."""

  def __init__(self, engine, kill_calls: Sequence[int]):
    super().__init__(engine)
    self.kill_calls = set(kill_calls)
    self.kills = 0

  def __call__(self, params, *args):
    call, self.calls = self.calls, self.calls + 1
    if call in self.kill_calls:
      self.kill_calls.discard(call)
      self.kills += 1
      raise RuntimeError(f"chaos: replica killed mid-step "
                         f"(device call {call})")
    return self.inner(params, *args)


class ReplicaHang(HangingStepInjector):
  """Stall a replica's step calls by a host sleep (the router suite's
  name for :class:`HangingStepInjector`).  The replica's watchdog fires
  during the stall, the count rides the next beat and the health machine
  marks it suspect; nothing migrates and no stream changes.
  :class:`ProcessStaller` is the real thing."""


class FlappingHealth(_StepFnWrapper):
  """A replica that keeps dying and recovering: every ``fail_every``-th
  step call from ``start_at`` raises.  Each breaker trip must double the
  hold-out before the next probe, while every migrated request still
  finishes exactly on the survivors."""

  def __init__(self, engine, fail_every: int = 4, start_at: int = 0):
    if fail_every < 2:
      raise ValueError(f"fail_every must be >= 2: {fail_every}")
    super().__init__(engine)
    self.fail_every = fail_every
    self.start_at = start_at
    self.faults = 0

  def __call__(self, params, *args):
    call, self.calls = self.calls, self.calls + 1
    if call >= self.start_at and (call - self.start_at) \
        % self.fail_every == self.fail_every - 1:
      self.faults += 1
      raise RuntimeError(f"chaos: flapping replica failed again "
                         f"(device call {call})")
    return self.inner(params, *args)


class ProcessKiller:
  """SIGKILL a process replica's child: its memory (engine, KV cache,
  scheduler) is gone at once.  The router must see the death at the wire
  and recover the requests from the parent-side journal."""

  def __init__(self, transport):
    self.transport = transport
    self.kills = 0
    self.killed_pids: list = []

  def kill(self) -> int:
    """Deliver SIGKILL now; returns the victim's pid."""
    pid = self.transport.child_pid
    if pid is None:
      raise RuntimeError("ProcessKiller: transport has no live child")
    self.transport.kill(_signal.SIGKILL)
    self.kills += 1
    self.killed_pids.append(pid)
    return pid


class ProcessStaller:
  """Freeze a process replica's child with SIGSTOP: it cannot answer the
  wire, so the call's deadline must condemn the replica and the fence
  SIGKILL it before its requests fail over.  :meth:`resume` (SIGCONT)
  after a fence finds nothing to wake."""

  def __init__(self, transport):
    self.transport = transport
    self.stalls = 0

  def stall(self) -> int:
    pid = self.transport.child_pid
    if pid is None:
      raise RuntimeError("ProcessStaller: transport has no live child")
    self.transport.kill(_signal.SIGSTOP)
    self.stalls += 1
    return pid

  def resume(self) -> None:
    pid = self.transport.child_pid
    if pid is not None:
      try:
        os.kill(pid, _signal.SIGCONT)
      except ProcessLookupError:
        pass  # already fenced


class ReplyDropper:
  """Drop chosen reply frames at the parent: the child applied the call
  and answered, the parent never hears it (the read raises the
  ``TransportTimeout`` a deadline miss would).  A retried ``submit``
  must hit the child's uid dedup; a lost ``step`` reply must not commit
  tokens twice.  ``drop`` counts every reply frame the parent reads
  (0-based)."""

  def __init__(self, transport, drop: Sequence[int]):
    self.transport = transport
    self.inner = transport._read_frame
    self.drop = set(drop)
    self.calls = 0
    self.dropped: list = []
    transport._read_frame = self

  def __call__(self, timeout):
    from easyparallellibrary_tpu_torch.serving.transport import (
        TransportTimeout)
    frame = self.inner(timeout)
    call, self.calls = self.calls, self.calls + 1
    if call in self.drop:
      self.drop.discard(call)
      self.dropped.append(frame)
      raise TransportTimeout(
          f"chaos: reply frame {call} dropped after the child applied it")
    return frame

  def uninstall(self):
    self.transport._read_frame = self.inner


# ----------------------------------------------------- front door clients


class SlowReader(threading.Thread):
  """A client too slow for its own stream: opens ``/v1/generate`` on a
  live front door (serving/frontdoor/) over a raw socket, then drains
  the SSE response ``read_bytes`` at a time with ``interval_s`` pauses,
  so its bounded queue (``serving.frontdoor.stream_buffer``) overflows
  and the front door must shed this flow alone.  After ``join()``:
  ``bytes_read`` and ``eof`` (the server closed the stream)."""

  def __init__(self, address: Tuple[str, int], body: Dict[str, Any],
               headers: Optional[Dict[str, str]] = None,
               read_bytes: int = 1, interval_s: float = 0.2,
               duration_s: float = 30.0):
    super().__init__(daemon=True)
    self.address = address
    self.body = body
    self.headers = headers
    self.read_bytes = int(read_bytes)
    self.interval_s = float(interval_s)
    self.duration_s = float(duration_s)
    self.bytes_read = 0
    self.eof = False
    self.error: Optional[BaseException] = None

  def run(self) -> None:
    from easyparallellibrary_tpu_torch.serving.frontdoor.client import (
        open_raw_stream)
    deadline = time.monotonic() + self.duration_s
    try:
      sock = open_raw_stream(self.address, self.body, headers=self.headers,
                             timeout=self.duration_s)
      try:
        while time.monotonic() < deadline:
          chunk = sock.recv(self.read_bytes)
          if not chunk:
            self.eof = True
            return
          self.bytes_read += len(chunk)
          time.sleep(self.interval_s)
      finally:
        sock.close()
    except OSError as e:
      self.error = e


class DisconnectingClient(threading.Thread):
  """A client that vanishes mid-stream: consumes ``after_events`` SSE
  token events, then drops the connection, with an RST (``rst=True``,
  SO_LINGER 0: no FIN) or a plain close.  The front door must cancel the
  request within one keepalive interval.  After ``join()``:
  ``events_seen`` and ``dropped`` (the stream did not finish first)."""

  def __init__(self, address: Tuple[str, int], body: Dict[str, Any],
               headers: Optional[Dict[str, str]] = None,
               after_events: int = 2, rst: bool = False,
               timeout_s: float = 30.0):
    super().__init__(daemon=True)
    self.address = address
    self.body = body
    self.headers = headers
    self.after_events = int(after_events)
    self.rst = rst
    self.timeout_s = float(timeout_s)
    self.events_seen = 0
    self.dropped = False
    self.error: Optional[BaseException] = None

  def run(self) -> None:
    from easyparallellibrary_tpu_torch.serving.frontdoor.client import (
        open_raw_stream)
    try:
      sock = open_raw_stream(self.address, self.body, headers=self.headers,
                             timeout=self.timeout_s)
      buf = b""
      try:
        while self.events_seen < self.after_events:
          chunk = sock.recv(4096)
          if not chunk:
            return                      # finished before the drop
          buf += chunk
          self.events_seen = buf.count(b"event: token")
        if self.rst:
          sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_LINGER,
                          struct.pack("ii", 1, 0))
        self.dropped = True
      finally:
        sock.close()
    except OSError as e:
      self.error = e


__all__ = ["DisconnectingClient", "FlakyDrafter", "FlappingHealth",
           "HangingStepInjector", "NaNLogitsInjector", "ProcessKiller",
           "ProcessStaller", "ReplicaHang", "ReplicaKiller", "ReplyDropper",
           "SlowReader"]
