"""Ambient virtual clock (port of ``easyparallellibrary_tpu/utils/vclock.py``)
— the simulator's time seam.

Every policy object in the serving stack already takes an injectable
clock (``FCFSScheduler(clock=...)``, ``ServingStats(clock=...)``,
``Router(clock=...)``, ``ReplicaHealth(clock=...)``); the stragglers
were the *defaults* on observability objects built from config
(``slo.ensure_configured`` constructs an ``SLOMonitor`` and a
``DiagnosticCapture`` without threading a clock through).  This module
closes that gap: those defaults now route through :func:`monotonic` /
:func:`wall`, which pass straight to :mod:`time` until a simulation
calls :func:`install`.

The contract is deliberately minimal — two zero-argument callables and
a process-global install/reset pair — because the point is replay
determinism, not a scheduling framework: a discrete-event engine (the
JAX package's ``sim/``, not ported yet) owns the virtual timeline and
installs itself here for the duration of an episode so that *config-built*
policy objects (which never saw a ``clock=`` kwarg) still read
simulated time.  Installation is idempotent per episode; always pair
with :func:`reset` (``try/finally``) so a crashed sim cannot leak a
frozen clock into live serving.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

# Process-global overrides.  ``None`` → passthrough to the real clocks.
_monotonic: Optional[Callable[[], float]] = None
_wall: Optional[Callable[[], float]] = None


def monotonic() -> float:
  """Monotonic seconds — ``time.monotonic`` unless a sim is installed."""
  fn = _monotonic
  return fn() if fn is not None else time.monotonic()


def wall() -> float:
  """Wall-clock seconds — ``time.time`` unless a sim is installed."""
  fn = _wall
  return fn() if fn is not None else time.time()


def installed() -> bool:
  """True while a virtual clock is installed (sim episode in flight)."""
  return _monotonic is not None or _wall is not None


def install(monotonic_fn: Optional[Callable[[], float]] = None,
            wall_fn: Optional[Callable[[], float]] = None) -> None:
  """Install virtual time sources.

  ``monotonic_fn`` backs :func:`monotonic`; ``wall_fn`` backs
  :func:`wall` and defaults to ``monotonic_fn`` (a simulated episode
  has one timeline — wall-stamped artifacts like slo_events then carry
  virtual seconds, which is what makes them replayable)."""
  global _monotonic, _wall
  _monotonic = monotonic_fn
  _wall = wall_fn if wall_fn is not None else monotonic_fn


def reset() -> None:
  """Drop any installed virtual clock (return to real time)."""
  global _monotonic, _wall
  _monotonic = None
  _wall = None
