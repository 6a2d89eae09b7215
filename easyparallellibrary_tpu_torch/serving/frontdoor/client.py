"""Stdlib SSE consumer for the front door (server.py; port of
``easyparallellibrary_tpu/serving/frontdoor/client.py``) — the client
the tests and ``chip_smoke.py`` drive the HTTP surface with, so every
equivalence pin exercises the REAL wire (socket, chunking, SSE framing)
rather than in-process shortcuts."""

from __future__ import annotations

import http.client
import json
import socket
from typing import Any, Dict, Iterator, List, Optional, Tuple


def _post(address: Tuple[str, int], body: Dict[str, Any],
          headers: Optional[Dict[str, str]],
          timeout: float) -> http.client.HTTPResponse:
  conn = http.client.HTTPConnection(address[0], address[1],
                                    timeout=timeout)
  hdrs = {"Content-Type": "application/json"}
  if headers:
    hdrs.update(headers)
  conn.request("POST", "/v1/generate", json.dumps(body).encode(), hdrs)
  resp = conn.getresponse()
  resp._frontdoor_conn = conn   # keep the socket alive with the response
  return resp


def stream_generate(address: Tuple[str, int], body: Dict[str, Any],
                    headers: Optional[Dict[str, str]] = None,
                    timeout: float = 60.0
                    ) -> Iterator[Tuple[str, Dict[str, Any]]]:
  """POST /v1/generate and yield ``(event, data)`` pairs as SSE frames
  arrive — ``("token", {"tokens": [...]})`` per engine iteration, then
  one ``("done", {"finish_reason": ..., ...})``.  Raises RuntimeError
  with the server's message on a non-200 response.  Keepalive comments
  are consumed silently."""
  resp = _post(address, body, headers, timeout)
  if resp.status != 200:
    detail = resp.read().decode(errors="replace")
    resp.close()
    raise RuntimeError(f"frontdoor HTTP {resp.status}: {detail}")
  event: Optional[str] = None
  try:
    for raw in resp:
      line = raw.rstrip(b"\r\n").decode()
      if line.startswith(":"):
        continue                       # keepalive comment
      if line.startswith("event:"):
        event = line[len("event:"):].strip()
      elif line.startswith("data:") and event is not None:
        data = json.loads(line[len("data:"):].strip())
        yield event, data
        if event == "done":
          return
        event = None
  finally:
    resp.close()


def generate(address: Tuple[str, int], body: Dict[str, Any],
             headers: Optional[Dict[str, str]] = None,
             timeout: float = 60.0
             ) -> Tuple[List[int], Dict[str, Any]]:
  """Run one request to completion; returns ``(streamed_tokens, done)``
  where ``streamed_tokens`` is every token event's payload concatenated
  in arrival order (the byte-exact-assembly currency of
  tests/test_serving_frontdoor.py)."""
  tokens: List[int] = []
  done: Dict[str, Any] = {}
  for event, data in stream_generate(address, body, headers=headers,
                                     timeout=timeout):
    if event == "token":
      tokens.extend(int(t) for t in data["tokens"])
    elif event == "done":
      done = data
  if not done:
    raise RuntimeError("stream ended without a done event")
  return tokens, done


def healthz(address: Tuple[str, int],
            timeout: float = 10.0) -> Dict[str, Any]:
  conn = http.client.HTTPConnection(address[0], address[1],
                                    timeout=timeout)
  try:
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    if resp.status != 200:
      raise RuntimeError(f"healthz HTTP {resp.status}")
    return json.loads(resp.read().decode())
  finally:
    conn.close()


def open_raw_stream(address: Tuple[str, int], body: Dict[str, Any],
                    headers: Optional[Dict[str, str]] = None,
                    timeout: float = 60.0) -> socket.socket:
  """Open /v1/generate as a RAW socket and return it after the request
  is written, without reading the response — the chaos suite's handle
  for misbehaving clients (testing/chaos.py SlowReader /
  DisconnectingClient): close it to vanish mid-stream, read one byte an
  hour to strangle the flow."""
  payload = json.dumps(body).encode()
  lines = [f"POST /v1/generate HTTP/1.1",
           f"Host: {address[0]}:{address[1]}",
           "Content-Type: application/json",
           f"Content-Length: {len(payload)}"]
  for k, v in (headers or {}).items():
    lines.append(f"{k}: {v}")
  raw = ("\r\n".join(lines) + "\r\n\r\n").encode() + payload
  sock = socket.create_connection(address, timeout=timeout)
  sock.sendall(raw)
  return sock
