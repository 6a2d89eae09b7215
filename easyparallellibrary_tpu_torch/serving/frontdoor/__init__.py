"""Streaming HTTP front door for the serving fleet (port of
``easyparallellibrary_tpu/serving/frontdoor/``; the wire format is the
same, so either package's client reads either package's server).

``FrontDoor`` (server.py) owns a router on a single driver thread and
exposes ``POST /v1/generate`` with Server-Sent-Events token streaming:
tokens surface per engine iteration as they commit (the scheduler's
``on_tokens`` hook — never by polling ``finished``), a slow reader
bounds its own buffer and sheds/cancels only its own flow, and a client
that disconnects mid-stream cancels its request (slot and cache blocks
freed, flow trace finalized).  ``client.py`` is the stdlib SSE consumer
the tests, benchmarks and chaos suite drive it with.  Stdlib only — no
new dependencies.
"""

from easyparallellibrary_tpu_torch.serving.frontdoor.server import FrontDoor
from easyparallellibrary_tpu_torch.serving.frontdoor.client import (
    generate, healthz, open_raw_stream, stream_generate)

__all__ = ["FrontDoor", "generate", "healthz", "open_raw_stream",
           "stream_generate"]
