"""One serving replica: an engine plus what the router needs to treat it
as a fleet member (port of ``easyparallellibrary_tpu/serving/replica.py``).

A replica is a :class:`~easyparallellibrary_tpu_torch.serving.engine.
ContinuousBatchingEngine` with its own scheduler, KV cache, watchdog and
:class:`~easyparallellibrary_tpu_torch.profiler.serving.ServingStats`;
replicas share nothing but the weights' source.  On top of the engine:

* heartbeat material: a :meth:`EngineReplica.step` that returns is a
  beat carrying the watchdog and bad-step counters and the ITL EWMA; one
  that raises is a death the router fails over;
* load signals for least-loaded dispatch (``queue_depth``,
  ``num_active``, ``load``);
* a per-replica metric namespace (``serving/replica<i>/*``) through a
  thin registry proxy, and per-replica Perfetto tracks;
* the migration endpoints (``snapshot_requests`` / ``restore_request`` /
  ``evacuate``).

The router drives replicas in process through
:class:`serving.transport.InprocTransport` by default.  With
``serving.router.transport = "process"`` the same class runs in a
spawned worker process: :func:`replica_worker_main` below answers the
parent's :class:`serving.transport.ProcessTransport` over a
length-prefixed JSON socket pair.  The worker takes its device from the
init frame and raises when it was asked for ``"cuda"`` and has none.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Dict, List, Optional

from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.serving.engine import (
    ContinuousBatchingEngine)
from easyparallellibrary_tpu_torch.serving.scheduler import (
    FinishedRequest, Request)


def kernel_launches() -> Dict[str, int]:
  """This process's kernel launch counters, by wrapper (and the plain
  paged version's calls): what a worker reports in its beat, since the
  parent cannot see a child's launches."""
  from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
  return {"paged_attention": int(pa.paged_attention_cuda.launches),
          "paged_attention_tiled": int(pa.paged_attention_tiled_cuda.launches),
          "paged_attention_warp": int(pa.paged_attention_warp_cuda.launches),
          "paged_attention_mixed": int(pa.paged_attention_mixed_cuda.launches),
          "paged_attention_plain": int(pa.paged_attention_reference.calls)}


class _ReplicaRegistry:
  """Registry proxy re-rooting ``serving`` to ``serving/replica<i>``, so
  every replica's records land side by side in one registry."""

  def __init__(self, inner, index: int):
    self._inner = inner
    self._prefix = f"serving/replica{index}"

  def publish(self, step: int, metrics, namespace: str = "train"):
    if namespace == "serving":
      namespace = self._prefix
    elif namespace.startswith("serving/"):
      namespace = self._prefix + namespace[len("serving"):]
    self._inner.publish(step, metrics, namespace)

  def __getattr__(self, name):
    return getattr(self._inner, name)


class EngineReplica:
  """One fleet member: engine, stats and the migration endpoints.

  ``engine_kwargs`` pass through to :class:`ContinuousBatchingEngine`
  (``device``, ``num_slots``, ``prefill_chunk``, ``paged``, ...).  A
  ``ServingStats`` is always attached: the health beats and the fleet
  rollup read it.  ``registry`` (optional) is wrapped per replica; pass
  the same registry to every replica and to the router."""

  def __init__(self, index: int, model, params, *, mesh=None,
               registry=None, config=None, stats=None, **engine_kwargs):
    self.index = index
    if stats is None and engine_kwargs.get("stats") is None:
      from easyparallellibrary_tpu_torch.profiler.serving import (
          ServingStats)
      stats = ServingStats()
    if stats is not None:
      engine_kwargs["stats"] = stats
    # Per-replica tracks, so a failed-over request's flow visibly
    # crosses from one replica's slots to another's.
    engine_kwargs.setdefault("track_prefix", f"serving/replica{index}")
    self.engine = ContinuousBatchingEngine(
        model, params, mesh=mesh, config=config,
        registry=(_ReplicaRegistry(registry, index)
                  if registry is not None else None),
        **engine_kwargs)
    self.stats = self.engine.stats
    self.steps = 0

  # ------------------------------------------------------------- serving

  def submit(self, request: Request) -> bool:
    return self.engine.submit(request)

  def cancel(self, uid: Any) -> bool:
    return self.engine.cancel(uid)

  def step(self) -> List[FinishedRequest]:
    """One engine iteration.  Raises whatever the engine raises: the
    router reads an escaping exception as this replica dying."""
    fins = self.engine.step()
    self.steps += 1
    return fins

  @property
  def has_work(self) -> bool:
    return self.engine.has_work

  @property
  def scheduler(self):
    return self.engine.scheduler

  @property
  def finished(self) -> Dict[Any, FinishedRequest]:
    return self.engine.finished

  # -------------------------------------------------------- load signals

  @property
  def queue_depth(self) -> int:
    return self.engine.scheduler.queue_depth

  @property
  def num_active(self) -> int:
    return self.engine.scheduler.num_active

  @property
  def num_slots(self) -> int:
    return self.engine.num_slots

  @property
  def load(self) -> int:
    """Requests this replica answers for (active + queued): the
    least-loaded dispatch key."""
    return self.num_active + self.queue_depth

  @property
  def checkpoint_version(self) -> int:
    return self.engine.checkpoint_version

  # ------------------------------------------------------ health signals

  @property
  def watchdog_timeouts(self) -> int:
    return self.stats.watchdog_timeouts if self.stats is not None else 0

  @property
  def bad_steps(self) -> int:
    return self.stats.bad_steps if self.stats is not None else 0

  @property
  def itl_ewma_s(self) -> float:
    return self.stats.itl_ewma_s if self.stats is not None else 0.0

  # ---------------------------------------------------------- migration

  def snapshot_requests(self) -> List[Dict[str, Any]]:
    return self.engine.snapshot_requests()

  def restore_request(self, snap: Dict[str, Any],
                      front: bool = False) -> Any:
    return self.engine.restore_request(snap, front=front)

  def evacuate(self) -> List[Dict[str, Any]]:
    return self.engine.evacuate()

  # ----------------------------------------------------------- lifecycle

  def close(self):
    self.engine.close()

  def __repr__(self):
    return (f"EngineReplica({self.index}, active={self.num_active}, "
            f"queued={self.queue_depth})")


# ---------------------------------------------------------- worker main --
#
# The child half of serving/transport.py's ProcessTransport: a spawned
# process answering length-prefixed JSON frames over the socket-pair fd
# it inherited.  The engine underneath is the in-process one.


def _install_pdeathsig() -> None:
  """Ask Linux to SIGKILL this worker when its parent dies
  (PR_SET_PDEATHSIG); the pipe-EOF exit below is the portable half."""
  try:
    import ctypes
    libc = ctypes.CDLL("libc.so.6", use_errno=True)
    PR_SET_PDEATHSIG = 1
    libc.prctl(PR_SET_PDEATHSIG, 9)  # SIGKILL
  except Exception:  # pragma: no cover - non-Linux / no libc
    pass


class _WorkerServer:
  """Dispatch loop state for one worker process."""

  def __init__(self, sock):
    from easyparallellibrary_tpu_torch.serving import transport as transport_lib
    self._t = transport_lib
    self.sock = sock
    self.reader = transport_lib.FrameReader(sock)
    self.replica: Optional[EngineReplica] = None
    self._first_tokens: List[Any] = []
    # Trace harvest: when the parent's config enables the tracer, this
    # child records into its own ring and the parent drains it in
    # bounded chunks riding step replies (0 bytes: harvest off).
    self.tracer: Optional[Any] = None
    self._harvest_bytes = 0
    # uid -> recorded reply: a submit or restore retried after a lost
    # reply returns the recorded verdict instead of admitting twice.
    self._applied: Dict[Any, Dict[str, Any]] = {}

  # ------------------------------------------------------------- handlers

  def _beat(self) -> Dict[str, Any]:
    rep = self.replica
    if rep is None:
      return {}
    beat = {
        "watchdog_timeouts": int(rep.watchdog_timeouts),
        "bad_steps": int(rep.bad_steps),
        "itl_ewma_s": float(rep.itl_ewma_s),
        "queue_depth": int(rep.queue_depth),
        "num_active": int(rep.num_active),
        "num_slots": int(rep.num_slots),
        "load": int(rep.load),
        "has_work": bool(rep.has_work),
        # The compile sentinel's count: kernel libraries loaded.
        "compiles": int(_build.loaded_count()),
        "launches": kernel_launches(),
        "checkpoint_version": int(rep.checkpoint_version),
        "pid": os.getpid(),
    }
    if self.tracer is not None and self.tracer.enabled:
      # Paired parent-side with send/recv stamps for the clock offset.
      beat["trace_now_us"] = self.tracer.now_us()
    return beat

  def do_init(self, p: Dict[str, Any]) -> Dict[str, Any]:
    wire = int(p.get("wire_version", -1))
    if wire != self._t.WIRE_VERSION:
      raise ValueError(
          f"wire version mismatch: parent speaks v{wire}, this worker "
          f"speaks v{self._t.WIRE_VERSION}; parent and child must run "
          f"the same build")
    import torch

    import easyparallellibrary_tpu_torch as epl
    from easyparallellibrary_tpu_torch.utils.device import resolve_device
    engine_kwargs = dict(p.get("engine_kwargs") or {})
    # Raises on a child asked for "cuda" that has no card: no replica
    # quietly serves from the CPU.
    device = resolve_device(engine_kwargs.get("device"))
    engine_kwargs["device"] = str(device)
    config = epl.Config(p.get("config") or {})
    epl.init(config, device="cpu" if device.type == "cpu" else None)
    # The parent's observability config came in the init frame: this
    # child's own tracer ring, which the parent harvests.  flow_id rides
    # every snapshot, so the spans recorded here join the request's flow.
    tracer = trace_lib.ensure_configured(config)
    obs = config.observability
    if tracer.enabled and obs.harvest.enabled:
      self.tracer = tracer
      self._harvest_bytes = int(obs.harvest.max_bytes_per_sweep)
    fn, kwargs = self._t.resolve_factory(p["factory"])
    try:
      takes_device = "device" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # pragma: no cover - builtins
      takes_device = False
    if takes_device:
      kwargs.setdefault("device", str(device))
    model, params = fn(**kwargs)
    checkpoint = p.get("checkpoint")
    if checkpoint:
      # This child serves a given checkpoint (a rollout's green replica),
      # restored over the factory's params on the init frame's device:
      # the checksum chain is verified and every leaf is sliced to the
      # factory's shape, so a bad checkpoint fails the init call.
      from easyparallellibrary_tpu_torch.runtime.saver import (
          restore_params)
      params, _ = restore_params(checkpoint, target=params, device=device)
    self.replica = EngineReplica(
        int(p.get("index", 0)), model, params, config=config,
        **engine_kwargs)
    self.replica.engine.scheduler.on_first_token.append(
        self._first_tokens.append)
    del params
    name = "cpu"
    if device.type == "cuda":
      # The factory's fp32 weights were cast into the engine's copy:
      # give their blocks back, so each child holds only what it serves.
      torch.cuda.empty_cache()
      name = torch.cuda.get_device_name(device)
    return {"pid": os.getpid(), "platform": device.type,
            "device_name": name}

  def do_submit(self, p: Dict[str, Any]) -> Dict[str, Any]:
    req = Request.restore(p["snap"])
    if req.uid in self._applied:
      return self._applied[req.uid]
    accepted = self.replica.submit(req)
    result: Dict[str, Any] = {"accepted": bool(accepted)}
    if not accepted:
      fin = self.replica.finished.get(req.uid)
      if fin is not None:
        result["finished"] = self._t.encode_finished(fin)
    self._applied[req.uid] = result
    return result

  def do_restore(self, p: Dict[str, Any]) -> Dict[str, Any]:
    uid = p["snap"]["request"]["uid"]
    if uid in self._applied and self._applied[uid].get("restored"):
      return self._applied[uid]
    self.replica.restore_request(p["snap"], front=bool(p.get("front")))
    result = {"accepted": True, "restored": True, "uid": uid}
    self._applied[uid] = result
    return result

  def do_cancel(self, p: Dict[str, Any]) -> Dict[str, Any]:
    return {"cancelled": bool(self.replica.cancel(p["uid"]))}

  def do_step(self, p: Dict[str, Any]) -> Dict[str, Any]:
    acked = {uid: int(n) for uid, n in p.get("acked", ())}
    fins = self.replica.step()
    progress = []
    order = []
    for uid, gen in self.replica.engine.scheduler.progress():
      order.append(uid)
      start = min(acked.get(uid, 0), len(gen))
      progress.append([uid, start, [int(t) for t in gen[start:]]])
    # A finished request frees its dedup entry (uids may be reused).
    for fin in fins:
      self._applied.pop(fin.uid, None)
    # Shed verdicts free at the next step: the parent is synchronous, so
    # every earlier submit's retries have resolved by now.
    for uid in [u for u, v in self._applied.items()
                if not v.get("accepted")]:
      self._applied.pop(uid, None)
    # Drain in place: the scheduler hook holds this list object.
    first = list(self._first_tokens)
    self._first_tokens.clear()
    out = {"finished": [self._t.encode_finished(f) for f in fins],
           "progress": progress, "order": order, "first": first}
    if self._harvest_bytes:
      # Bounded trace chunk per step; the rest rides later replies.
      chunk = self.tracer.drain_wire(self._harvest_bytes)
      if chunk["events"]:
        out["trace"] = chunk
    return out

  def do_snapshot(self, p: Dict[str, Any]) -> Dict[str, Any]:
    return {"snaps": self.replica.snapshot_requests()}

  def do_evacuate(self, p: Dict[str, Any]) -> Dict[str, Any]:
    snaps = self.replica.evacuate()
    for snap in snaps:
      self._applied.pop(snap["request"]["uid"], None)
    result: Dict[str, Any] = {"snaps": snaps}
    # An evacuation usually precedes a fence: flush the whole ring.
    chunk = self._final_flush()
    if chunk is not None:
      result["trace"] = chunk
    return result

  def do_stats(self, p: Dict[str, Any]) -> Dict[str, Any]:
    stats = self.replica.stats
    return {"stats": stats.state_dict() if stats is not None else None}

  def do_ping(self, p: Dict[str, Any]) -> Dict[str, Any]:
    return {"pong": True}

  def do_harvest(self, p: Dict[str, Any]) -> Dict[str, Any]:
    """Drain up to ``max_bytes`` of the tracer ring (the sweep bound when
    unspecified; ``drain=True`` empties it)."""
    if self.tracer is None:
      return {"done": True}
    if p.get("drain"):
      max_bytes = None
    else:
      max_bytes = int(p.get("max_bytes") or self._harvest_bytes or 65536)
    chunk = self.tracer.drain_wire(max_bytes)
    out: Dict[str, Any] = {"done": not self.tracer.pending}
    if chunk["events"]:
      out["trace"] = chunk
    return out

  def _final_flush(self) -> Optional[Dict[str, Any]]:
    """The whole ring remainder, for the shutdown and evacuate replies."""
    if self.tracer is None:
      return None
    chunk = self.tracer.drain_wire(None)
    return chunk if chunk["events"] else None

  # ----------------------------------------------------------- serve loop

  def serve(self) -> int:
    handlers = {
        "init": self.do_init, "submit": self.do_submit,
        "restore": self.do_restore, "cancel": self.do_cancel,
        "step": self.do_step, "snapshot": self.do_snapshot,
        "evacuate": self.do_evacuate, "stats": self.do_stats,
        "ping": self.do_ping, "harvest": self.do_harvest,
    }
    while True:
      try:
        frame = self.reader.read(None)
      except self._t.ReplicaDeadError:
        # Parent gone (pipe EOF): exit rather than orphan.  A parent
        # that shut down only its write side can still take the ring.
        chunk = self._final_flush()
        if chunk is not None:
          try:
            self._t.send_frame(self.sock, {
                "id": None, "m": "trace_flush", "ok": True,
                "result": {"trace": chunk}, "beat": self._beat()})
          except OSError:
            pass
        break
      rid, method = frame.get("id"), frame.get("m")
      if method == "shutdown":
        result: Dict[str, Any] = {}
        chunk = self._final_flush()
        if chunk is not None:
          result["trace"] = chunk
        self._reply(rid, method, {"ok": True, "result": result})
        break
      handler = handlers.get(method)
      try:
        if handler is None:
          raise ValueError(f"unknown transport method {method!r}")
        result = handler(frame.get("p") or {})
        self._reply(rid, method, {"ok": True, "result": result})
      except Exception as e:  # noqa: BLE001 - reported, the parent decides
        self._reply(rid, method,
                    {"ok": False, "error": str(e),
                     "etype": type(e).__name__})
    if self.replica is not None:
      self.replica.close()
    return 0

  def _reply(self, rid, method, body: Dict[str, Any]) -> None:
    body["id"] = rid
    body["m"] = method
    body["beat"] = self._beat()
    try:
      self._t.send_frame(self.sock, body)
    except OSError:
      raise self._t.ReplicaDeadError("parent went away mid-reply")


def replica_worker_main(fd: int) -> int:
  """Entry point of the spawned replica worker (the transport's child)."""
  _install_pdeathsig()
  import socket as socket_lib
  sock = socket_lib.socket(fileno=fd)
  try:
    return _WorkerServer(sock).serve()
  finally:
    try:
      sock.close()
    except OSError:
      pass


if __name__ == "__main__":
  import argparse
  parser = argparse.ArgumentParser(
      description="serving replica worker (spawned by ProcessTransport; "
                  "not a user-facing CLI)")
  parser.add_argument("--worker-fd", type=int, required=True)
  raise SystemExit(replica_worker_main(parser.parse_args().worker_fd))
