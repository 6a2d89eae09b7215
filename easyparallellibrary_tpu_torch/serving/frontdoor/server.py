"""Event-driven streaming front door: stdlib HTTP/1.1 + SSE over one
router (port of ``easyparallellibrary_tpu/serving/frontdoor/server.py``,
the same wire format both ways).

Threading model — the router keeps its single-threaded contract:

* One **driver thread** owns the router, and with it every CUDA call
  the fleet makes, exclusively.  It drains a
  command queue (submit/cancel marshalled from HTTP handler threads),
  then drives one cycle — the reactor
  (serving/reactor.py) when ``serving.router.reactor`` is on, the
  ``router.step()`` sweep otherwise.  No router method is ever called
  from a handler thread.
* One **handler thread per connection** (``ThreadingHTTPServer``)
  parses the request, posts a submit command, and then only *reads*
  its own stream's queue and writes SSE frames to its own socket.
  The tokens it writes are the Python ints the scheduler committed on
  the host: no tensor reaches a handler, and none is read back here.

Token flow is push, never poll: the router's ``on_tokens`` fanout
(scheduler commit -> transport side-band -> router -> here) lands each
request's freshly committed tokens in its per-connection bounded queue
**on the driver thread, inside the cycle** — the handler thread wakes
and writes the SSE frame while the fleet keeps stepping.

Backpressure is per-flow: the queue holds at most
``serving.frontdoor.stream_buffer`` batches.  A reader too slow to
drain it overflows ONLY its own queue; the overflow marks the stream
and the driver cancels that uid *after* the cycle (never reentrantly
inside scheduler.commit), so one slow phone on a bad link costs one
request — not a batch slot held hostage, and never a neighbour's
tokens.  A second line of defence — ``write_timeout_s`` on the
connection socket — catches the reader whose TCP window closed
entirely.

Cancel-on-disconnect: every SSE write failure (broken pipe, reset,
write timeout) and every keepalive-probe failure posts a cancel
command; the driver runs ``router.cancel(uid)``, which retires the
request with reason ``"cancelled"``, frees its slot and cache blocks,
and finalizes its trace flow — capacity returns to the fleet within
one keepalive interval (``keepalive_s``) even when the client vanishes
without a FIN.

Wire schema (one ``event:``/``data:`` pair per frame, UTF-8 JSON)::

    event: token
    data: {"tokens": [733, 12, ...]}     # one engine iteration's commit

    event: done
    data: {"finish_reason": "length", "new_tokens": 16,
           "truncated": false}

Request headers map onto scheduler fields (the same admission/deadline
machinery every other entry point uses): ``X-Deadline-S`` ->
``deadline_s``, ``X-TTFT-Budget-S`` ->
``ttft_budget_s``, ``X-Priority`` -> ``priority``.

Trace context: a W3C
``traceparent`` request header binds the request to the caller's
trace — its trace-id maps onto the scheduler's ``Request.flow_id``,
so the flow arc in the merged Perfetto export starts at the HTTP edge
and the id is recoverable from the caller's trace-id.  When absent,
one is minted.  A malformed header is a 400 (a proxy that mangles
trace context should hear about it, not silently fork a new trace).
The SSE response echoes ``X-Request-Id`` (the request uid) and the
effective ``traceparent``; ``frontdoor/request`` / ``frontdoor/
first_byte`` instants give report.py the client-observed TTFT hop.
"""

from __future__ import annotations

import itertools
import json
import queue
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.serving.scheduler import (
    Request, next_flow_id)
from easyparallellibrary_tpu_torch.utils.logging import get_logger

_PRIORITIES = ("throughput", "latency")

# Perfetto flow ids are JSON numbers; keep them inside the 53-bit
# exact-integer range so a round-trip through any JSON tooling cannot
# corrupt the flow binding.
_FLOW_ID_MASK = (1 << 53) - 1


def parse_traceparent(header: str) -> Tuple[str, str, str]:
  """Strictly parse a W3C ``traceparent`` header
  (``00-<32hex trace-id>-<16hex parent-id>-<2hex flags>``); returns
  ``(trace_id, parent_id, flags)`` or raises ``ValueError`` (the front
  door maps that to a 400)."""
  parts = header.strip().split("-")
  if len(parts) != 4:
    raise ValueError(
        f"malformed traceparent (want version-traceid-parentid-flags): "
        f"{header!r}")
  version, trace_id, parent_id, flags = parts
  hexdigits = "0123456789abcdef"

  def _hex(field: str, value: str, width: int) -> str:
    if len(value) != width or any(c not in hexdigits for c in value):
      raise ValueError(f"malformed traceparent: {field} must be "
                       f"{width} lowercase hex chars: {value!r}")
    return value

  _hex("version", version, 2)
  if version == "ff":
    raise ValueError("malformed traceparent: version 'ff' is invalid")
  _hex("trace-id", trace_id, 32)
  if trace_id == "0" * 32:
    raise ValueError("malformed traceparent: trace-id must be non-zero")
  _hex("parent-id", parent_id, 16)
  if parent_id == "0" * 16:
    raise ValueError("malformed traceparent: parent-id must be non-zero")
  _hex("flags", flags, 2)
  return trace_id, parent_id, flags


def mint_traceparent(flow_id: int) -> str:
  """A fresh ``traceparent`` carrying ``flow_id`` as its trace-id, for
  requests that arrive without one — the caller can correlate the SSE
  response's echoed header with the exported trace's flow id."""
  return f"00-{flow_id:032x}-{flow_id & ((1 << 64) - 1):016x}-01"


def flow_id_from_trace_id(trace_id: str) -> int:
  """Map a 128-bit W3C trace-id onto a Perfetto-safe flow id (low 53
  bits; collision odds at serving-fleet scale are negligible)."""
  return int(trace_id, 16) & _FLOW_ID_MASK


class _StreamState:
  """Per-connection stream plumbing: the bounded token queue the driver
  pushes into and the handler drains, plus the terminal record.  Tokens
  are only ever pushed BEFORE ``final`` is set, so a handler that sees
  ``final`` with an empty queue has streamed everything."""

  __slots__ = ("uid", "prompt_len", "queue", "pushed", "overflow",
               "admitted", "accepted", "error", "final")

  def __init__(self, uid: Any, prompt_len: int, buffer: int):
    self.uid = uid
    self.prompt_len = prompt_len
    self.queue: "queue.Queue[List[int]]" = queue.Queue(maxsize=buffer)
    self.pushed = 0            # generated tokens enqueued so far
    self.overflow = False
    self.admitted = threading.Event()
    self.accepted = False
    self.error: Optional[str] = None
    self.final: Optional[Dict[str, Any]] = None


class FrontDoor:
  """The serving fleet's streaming HTTP entry point (module docstring).

  ``with FrontDoor(router) as fd:`` binds ``serving.frontdoor.host`` /
  ``.port`` (port 0 = ephemeral; read the bound one off
  ``fd.address``), starts the HTTP listener and the router driver
  thread, and serves until ``close()``.  The router must not be driven
  by anyone else while the front door owns it."""

  def __init__(self, router, config=None):
    root = config if config is not None else router._root_config
    fconf = root.serving.frontdoor
    self.router = router
    self._reactor_enabled = bool(root.serving.router.reactor)
    self.stream_buffer = int(fconf.stream_buffer)
    self.write_timeout_s = float(fconf.write_timeout_s)
    self.keepalive_s = float(fconf.keepalive_s)
    self._streams: Dict[Any, _StreamState] = {}
    self._streams_lock = threading.Lock()
    self._commands: "queue.Queue[Tuple[Any, ...]]" = queue.Queue()
    self._overflow_cancels: List[Any] = []   # driver-thread local
    self._kick = False                       # cycle once though idle
    self._uid_counter = itertools.count()
    self._stop = threading.Event()
    self._driver: Optional[threading.Thread] = None
    self._server_thread: Optional[threading.Thread] = None
    # Observable counters.
    self.streamed_events = 0   # token batches pushed to stream queues
    self.overflow_sheds = 0    # slow-reader flows cancelled on overflow
    self.disconnect_cancels = 0
    router.on_tokens.append(self._on_tokens)
    front_door = self

    class _Handler(BaseHTTPRequestHandler):
      protocol_version = "HTTP/1.1"

      def log_message(self, fmt, *args):   # noqa: N802 (stdlib name)
        get_logger().debug("frontdoor http: " + fmt, *args)

      def do_GET(self):                    # noqa: N802
        front_door._handle_get(self)

      def do_POST(self):                   # noqa: N802
        front_door._handle_post(self)

    self._httpd = ThreadingHTTPServer(
        (str(fconf.host), int(fconf.port)), _Handler)
    self._httpd.daemon_threads = True
    self.address: Tuple[str, int] = self._httpd.server_address[:2]

  # ------------------------------------------------------------ lifecycle

  def start(self) -> "FrontDoor":
    self._driver = threading.Thread(
        target=self._drive, name="frontdoor-driver", daemon=True)
    self._driver.start()
    self._server_thread = threading.Thread(
        target=self._httpd.serve_forever, name="frontdoor-http",
        kwargs={"poll_interval": 0.05}, daemon=True)
    self._server_thread.start()
    return self

  def close(self) -> None:
    self._stop.set()
    self._httpd.shutdown()
    self._httpd.server_close()
    for t in (self._server_thread, self._driver):
      if t is not None:
        t.join(timeout=5.0)

  def __enter__(self) -> "FrontDoor":
    return self.start()

  def __exit__(self, *exc) -> None:
    self.close()

  @property
  def url(self) -> str:
    return f"http://{self.address[0]}:{self.address[1]}"

  # ------------------------------------------------------ driver thread

  def _drive(self) -> None:
    """The router's single owner: commands, then one cycle, repeat."""
    r = self.router
    drive = (r.reactor().cycle if self._reactor_enabled else r.step)
    while not self._stop.is_set():
      busy = r.has_work
      try:
        cmd = self._commands.get(timeout=0.0 if busy else 0.05)
      except queue.Empty:
        cmd = None
      while cmd is not None:
        self._handle_command(cmd)
        try:
          cmd = self._commands.get_nowait()
        except queue.Empty:
          cmd = None
      if not r.has_work and not self._kick:
        continue
      self._kick = False
      try:
        fins = drive()
      except Exception:
        get_logger().exception("frontdoor driver: cycle raised")
        continue
      for fin in fins:
        self._finalize(fin)
      if self._overflow_cancels:
        # Post-cycle, never inside scheduler.commit: cancelling
        # reentrantly from the on_tokens callback would mutate the
        # batch mid-commit.
        for uid in self._overflow_cancels:
          with self._streams_lock:
            self.overflow_sheds += 1
          r.cancel(uid)
        self._overflow_cancels = []
        # The cancelled request retires into its replica's finished
        # buffer; cycle once more even if it was the fleet's last, or
        # its stream never gets its done event (the "cancel" command's
        # rule below).
        self._kick = True

  def _handle_command(self, cmd: Tuple[Any, ...]) -> None:
    r = self.router
    kind = cmd[0]
    if kind == "submit":
      _, request, stream = cmd
      with self._streams_lock:
        self._streams[request.uid] = stream
      try:
        stream.accepted = r.submit(request)
      except ValueError as e:
        stream.error = str(e)
        stream.accepted = False
        with self._streams_lock:
          self._streams.pop(request.uid, None)
      else:
        if not stream.accepted:
          # Shed at admission: the resolution is already in
          # router.finished — surface it as the stream's done event.
          fin = r.finished.get(request.uid)
          if fin is not None:
            self._finalize(fin)
      stream.admitted.set()
    elif kind == "cancel":
      _, uid = cmd
      with self._streams_lock:
        stream = self._streams.pop(uid, None)
      if stream is not None and stream.final is None:
        stream.final = {"finish_reason": "cancelled",
                        "new_tokens": stream.pushed, "truncated": False}
      with self._streams_lock:
        self.disconnect_cancels += 1
      # Retires with reason "cancelled" wherever the request lives
      # (active slot, queue, parked backlog); slot + blocks free now,
      # the fin rides the next cycle into router.finished — kick one
      # even if this was the fleet's last request (an idle step is
      # cheap and it's what surfaces the retirement fleet-side).
      r.cancel(uid)
      self._kick = True

  def _on_tokens(self, uid: Any, toks: List[int]) -> None:
    """Router on_tokens fanout -> this stream's bounded queue (driver
    thread, inside the cycle)."""
    with self._streams_lock:
      stream = self._streams.get(uid)
    if stream is None or stream.final is not None or stream.overflow:
      return
    try:
      stream.queue.put_nowait(list(toks))
      stream.pushed += len(toks)
      with self._streams_lock:
        self.streamed_events += 1
    except queue.Full:
      # Slow reader: bound ITS buffer, shed ITS flow — after the cycle.
      stream.overflow = True
      self._overflow_cancels.append(uid)

  def _finalize(self, fin) -> None:
    with self._streams_lock:
      stream = self._streams.pop(fin.uid, None)
    if stream is None or stream.final is not None:
      return
    # Backfill anything committed but not yet pushed (e.g. tokens a
    # failover replayed, or the final commit of a finish that retired
    # before its on_tokens landed) so the stream byte-assembles to
    # exactly fin.tokens.
    generated = [int(t) for t in
                 np.asarray(fin.tokens).reshape(-1)[stream.prompt_len:]]
    backfill = generated[stream.pushed:]
    truncated = False
    if backfill:
      try:
        stream.queue.put_nowait(backfill)
        stream.pushed += len(backfill)
        with self._streams_lock:
          self.streamed_events += 1
      except queue.Full:
        truncated = True   # overflowed reader: already being shed
    stream.final = {"finish_reason": fin.finish_reason,
                    "new_tokens": int(fin.new_tokens),
                    "truncated": truncated}

  # ----------------------------------------------------- handler threads

  def _handle_get(self, h: BaseHTTPRequestHandler) -> None:
    if h.path != "/healthz":
      self._send_error(h, 404, "unknown path (POST /v1/generate)")
      return
    body = json.dumps({
        "states": list(self.router.states()),
        "steps": int(self.router.steps),
    }).encode()
    h.send_response(200)
    h.send_header("Content-Type", "application/json")
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    h.wfile.write(body)

  def _handle_post(self, h: BaseHTTPRequestHandler) -> None:
    if h.path != "/v1/generate":
      self._send_error(h, 404, "unknown path (POST /v1/generate)")
      return
    try:
      request, prompt_len, traceparent = self._parse_request(h)
    except ValueError as e:
      self._send_error(h, 400, str(e))
      return
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
      # Client-arrival mark for the hop breakdown (report.py): the gap
      # to the router's serving/submit instant is front-door ingress,
      # the gap from the engine's first token to frontdoor/first_byte
      # is wire + stream delivery.
      tracer.instant("frontdoor/request", cat="serving",
                     track="frontdoor",
                     args={"uid": str(request.uid),
                           "flow": int(request.flow_id)})
    stream = _StreamState(request.uid, prompt_len, self.stream_buffer)
    self._commands.put(("submit", request, stream))
    if not stream.admitted.wait(timeout=60.0):
      self._send_error(h, 503, "router driver unresponsive")
      return
    if stream.error is not None:
      self._send_error(h, 400, stream.error)
      return
    self._stream_sse(h, stream, traceparent)

  def _parse_request(self, h: BaseHTTPRequestHandler
                     ) -> Tuple[Request, int, str]:
    length = int(h.headers.get("Content-Length", 0) or 0)
    raw = h.rfile.read(length) if length else b""
    try:
      body = json.loads(raw.decode() or "{}")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
      raise ValueError(f"body is not JSON: {e}")
    if not isinstance(body, dict):
      raise ValueError("body must be a JSON object")
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or not prompt
        or not all(isinstance(t, int) for t in prompt)):
      raise ValueError('"prompt" must be a non-empty list of token ids')
    uid = body.get("uid")
    if uid is None:
      uid = f"fd-{next(self._uid_counter)}"

    def _num(source: str, name: str, raw_val: Any, cast, default):
      if raw_val is None:
        return default
      try:
        return cast(raw_val)
      except (TypeError, ValueError):
        raise ValueError(f"{source} {name!r} must be a number: {raw_val!r}")

    # Header mapping: headers win over
    # body fields — proxies inject policy without rewriting payloads.
    deadline_s = _num("header", "X-Deadline-S",
                      h.headers.get("X-Deadline-S"), float,
                      _num("field", "deadline_s", body.get("deadline_s"),
                           float, 0.0))
    ttft_budget_s = _num("header", "X-TTFT-Budget-S",
                         h.headers.get("X-TTFT-Budget-S"), float,
                         _num("field", "ttft_budget_s",
                              body.get("ttft_budget_s"), float, 0.0))
    priority = h.headers.get("X-Priority", body.get("priority",
                                                    "throughput"))
    if priority not in _PRIORITIES:
      raise ValueError(f'priority must be one of {_PRIORITIES}: '
                       f'{priority!r}')
    # Trace-context propagation: bind the caller's trace-id onto the
    # request's flow id (mint both when the header is absent), so the
    # scheduler's flow events — including the child replicas' harvested
    # ones — connect back to the HTTP edge.
    header_tp = h.headers.get("traceparent")
    if header_tp is not None:
      trace_id, _parent_id, _flags = parse_traceparent(header_tp)
      flow_id = flow_id_from_trace_id(trace_id) or next_flow_id()
      traceparent = header_tp.strip()
    else:
      flow_id = next_flow_id()
      traceparent = mint_traceparent(flow_id)
    request = Request(
        uid=uid,
        prompt=np.asarray(prompt, np.int32),
        max_new_tokens=_num("field", "max_new_tokens",
                            body.get("max_new_tokens"), int, 16),
        temperature=_num("field", "temperature",
                         body.get("temperature"), float, 0.0),
        top_k=_num("field", "top_k", body.get("top_k"), int, 0),
        top_p=_num("field", "top_p", body.get("top_p"), float, 1.0),
        stop_token=_num("field", "stop_token",
                        body.get("stop_token"), int, -1),
        seed=_num("field", "seed", body.get("seed"), int, None),
        deadline_s=deadline_s,
        ttft_budget_s=ttft_budget_s,
        priority=priority,
        flow_id=flow_id)
    return request, len(prompt), traceparent

  def _stream_sse(self, h: BaseHTTPRequestHandler,
                  stream: _StreamState,
                  traceparent: Optional[str] = None) -> None:
    h.send_response(200)
    h.send_header("Content-Type", "text/event-stream")
    h.send_header("Cache-Control", "no-store")
    h.send_header("Connection", "close")
    # Trace-context echo: the uid correlates a client log line with the
    # trace/report, the traceparent hands back the effective trace-id
    # (the minted one when the request arrived without).
    h.send_header("X-Request-Id", str(stream.uid))
    if traceparent:
      h.send_header("traceparent", traceparent)
    h.end_headers()
    h.close_connection = True
    # Second backpressure line: a reader whose TCP window stays shut
    # past write_timeout_s reads as gone (the bounded queue is the
    # first line — it trips before the kernel buffers fill in most
    # slow-reader shapes).
    h.connection.settimeout(self.write_timeout_s)
    last_write = time.monotonic()
    tracer = trace_lib.get_tracer()
    first_byte_pending = tracer.enabled

    def _mark_first_byte():
      nonlocal first_byte_pending
      if first_byte_pending:
        # Client-observed TTFT endpoint: the first payload frame left
        # this process (post-flush), everything upstream included.
        tracer.instant("frontdoor/first_byte", cat="serving",
                       track="frontdoor", args={"uid": str(stream.uid)})
        first_byte_pending = False

    try:
      while True:
        if stream.final is not None and stream.queue.empty():
          payload = json.dumps(stream.final)
          h.wfile.write(f"event: done\ndata: {payload}\n\n".encode())
          h.wfile.flush()
          _mark_first_byte()
          return
        try:
          batch = stream.queue.get(timeout=0.05)
        except queue.Empty:
          if time.monotonic() - last_write >= self.keepalive_s:
            # Probe: surfaces a vanished client (no FIN) as a write
            # error within one keepalive interval.
            h.wfile.write(b": keepalive\n\n")
            h.wfile.flush()
            last_write = time.monotonic()
          continue
        payload = json.dumps({"tokens": batch})
        h.wfile.write(f"event: token\ndata: {payload}\n\n".encode())
        h.wfile.flush()
        _mark_first_byte()
        last_write = time.monotonic()
    except (BrokenPipeError, ConnectionResetError, socket.timeout,
            OSError):
      # Client gone (or unwritable past write_timeout_s): free its
      # slot and blocks NOW rather than decoding to a dead socket.
      self._commands.put(("cancel", stream.uid))

  @staticmethod
  def _send_error(h: BaseHTTPRequestHandler, code: int,
                  message: str) -> None:
    body = json.dumps({"error": message}).encode()
    try:
      h.send_response(code)
      h.send_header("Content-Type", "application/json")
      h.send_header("Content-Length", str(len(body)))
      h.end_headers()
      h.wfile.write(body)
    except OSError:
      pass
