"""Retry with exponential backoff for transient IO errors (port of
``easyparallellibrary_tpu/utils/retry.py``).

Checkpoint shards and input records live on network filesystems in
production (GCS fuse, NFS); both fail transiently under load.  The
reference's recovery story for these is kill-and-retry of the whole
worker (SURVEY §5.3) — here the retry happens at the call site instead,
bounded by ``resilience.io_retries`` / ``resilience.io_retry_backoff_s``
so a dead filesystem still surfaces as the original exception, with the
attempt history logged.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple, Type

from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Exceptions worth retrying by default: OSError covers IOError, network
# filesystem hiccups, and interrupted syscalls.  Never retry programming
# errors (TypeError/KeyError) — those reproduce identically.
TRANSIENT_EXCEPTIONS: Tuple[Type[BaseException], ...] = (OSError,)

# OSError subclasses that reproduce deterministically — retrying them
# only delays the real error.  Honored when the caller uses the default
# exception set; pass `exceptions=` explicitly to retry these too.
PERMANENT_IO_EXCEPTIONS: Tuple[Type[BaseException], ...] = (
    FileNotFoundError, IsADirectoryError, NotADirectoryError,
    PermissionError)


def retry_call(fn: Callable[..., Any],
               *args,
               retries: Optional[int] = None,
               backoff_s: Optional[float] = None,
               max_backoff_s: float = 2.0,
               jitter: float = 0.0,
               exceptions: Tuple[Type[BaseException], ...] = (),
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               what: str = "",
               **kwargs) -> Any:
  """Call ``fn(*args, **kwargs)``, retrying transient failures.

  ``retries`` is the number of RE-tries after the first attempt
  (``retries=0`` means one attempt, no retry); defaults to the active
  config's ``resilience.io_retries``.  Backoff doubles each attempt,
  capped at ``max_backoff_s``.  ``jitter`` stretches each sleep by a
  uniformly random factor in ``[1, 1 + jitter]`` — RPC retries against
  a shared replica (serving/transport.py) must decorrelate, or every
  caller that timed out together retries together and the thundering
  herd re-times-out together.  ``on_retry(attempt, exc)`` is invoked
  before each sleep — callers use it to count retries into metrics.
  The final failure re-raises the last exception unchanged.
  """
  if retries is None or backoff_s is None:
    from easyparallellibrary_tpu_torch.env import Env
    res = Env.get().config.resilience
    if retries is None:
      retries = res.io_retries
    if backoff_s is None:
      backoff_s = res.io_retry_backoff_s
  if jitter < 0:
    raise ValueError(f"jitter must be >= 0: {jitter}")
  default_set = not exceptions
  exceptions = exceptions or TRANSIENT_EXCEPTIONS
  delay = max(0.0, backoff_s)
  for attempt in range(retries + 1):
    try:
      return fn(*args, **kwargs)
    except exceptions as e:
      if default_set and isinstance(e, PERMANENT_IO_EXCEPTIONS):
        raise
      if attempt >= retries:
        raise
      sleep_s = delay
      if delay and jitter:
        import random
        sleep_s = delay * (1.0 + random.uniform(0.0, jitter))
      get_logger().warning(
          "transient failure%s (attempt %d/%d): %s — retrying in %.2fs",
          f" in {what}" if what else "", attempt + 1, retries + 1, e,
          sleep_s)
      if on_retry is not None:
        on_retry(attempt + 1, e)
      if sleep_s:
        time.sleep(sleep_s)
      delay = min(delay * 2 if delay else 0.0, max_backoff_s)
  raise AssertionError("unreachable")  # pragma: no cover


def retrying(what: str = "", **retry_kwargs) -> Callable[[Callable], Callable]:
  """Decorator form of :func:`retry_call`."""

  def deco(fn: Callable) -> Callable:
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
      return retry_call(fn, *args, what=what or fn.__name__,
                        **retry_kwargs, **kwargs)

    return wrapped

  return deco
