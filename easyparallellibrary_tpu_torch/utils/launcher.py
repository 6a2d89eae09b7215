"""Launcher: multi-process bootstrap on ``torch.distributed`` (port of
``easyparallellibrary_tpu/utils/launcher.py``).

* :func:`init_distributed` starts this process's default process group
  from arguments or the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` environment the launcher exports.  The backend is
  explicit: ``nccl`` for a CUDA device, ``gloo`` for the CPU, or the one
  the caller names; a failed init raises and never switches backend.
* :func:`launch_local` runs ``num_workers`` copies of a command with
  that environment (the JAX launcher's ``EPL_*`` names are exported
  too), kills the whole group on the first non-zero exit or at the
  deadline, and retries once.
* :func:`spawn` runs a picklable function on ``world_size`` ranks in
  processes started with ``spawn`` (a parent that imported JAX must not
  fork), returns each rank's result, and kills the group on the first
  failure or at the deadline, so a rank that raises while its peer waits
  in a collective never hangs the caller.

Console use: ``python -m easyparallellibrary_tpu_torch.utils.launcher
--num_workers 2 -- python train.py``.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import queue as queue_lib
import socket
import subprocess
import sys
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Default deadline of one collective before gloo / NCCL give up.
DEFAULT_TIMEOUT_S = 120.0


def free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def default_backend(device) -> str:
  """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
  import torch
  return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(backend: Optional[str] = None, device=None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S):
  """Start the default process group; returns this rank's device.

  ``device`` follows the port's rule (``None`` is the GPU, and a machine
  without one raises unless ``device="cpu"``); on CUDA each rank takes
  ``cuda:(rank % device_count)``, so two ranks on a one-card machine
  share the card.  ``rank`` / ``world_size`` / ``init_method`` default
  to the launcher's environment.  A world of one starts no group.  A
  group already started is kept."""
  import torch
  import torch.distributed as dist

  from easyparallellibrary_tpu_torch.utils.device import resolve_device
  dev = resolve_device(device)
  rank = int(os.environ.get("RANK", 0)) if rank is None else rank
  world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                else world_size)
  if dev.type == "cuda":
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
  if world_size <= 1 or dist.is_initialized():
    return dev
  if init_method is None:
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT")
    if port is None:
      raise RuntimeError(
          "init_distributed: WORLD_SIZE > 1 but no MASTER_PORT (or "
          "init_method) to meet at; start the ranks with launch_local()")
    init_method = f"tcp://{addr}:{port}"
  backend = backend or default_backend(dev)
  dist.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=world_size,
                          timeout=datetime.timedelta(seconds=timeout_s))
  get_logger().info("torch.distributed: rank %d/%d on %s (%s)", rank,
                    world_size, dev, backend)
  return dev


def _rank_env(rank: int, world_size: int, port: int) -> dict:
  return {"RANK": str(rank), "LOCAL_RANK": str(rank),
          "WORLD_SIZE": str(world_size), "MASTER_ADDR": "127.0.0.1",
          "MASTER_PORT": str(port),
          # The JAX launcher's names, for scripts written against it.
          "EPL_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
          "EPL_NUM_PROCESSES": str(world_size),
          "EPL_PROCESS_ID": str(rank)}


def _reap(procs, poll: Callable, kill: Callable,
          deadline: Optional[float]) -> bool:
  """Wait for every process; on the first failure (or the deadline)
  kill the rest.  ``poll(p)`` returns None while ``p`` runs, else its
  exit code.  Returns True when all exited 0."""
  alive = list(procs)
  ok = True
  while alive:
    still = []
    for p in alive:
      code = poll(p)
      if code is None:
        still.append(p)
      elif code != 0:
        ok = False
    timed_out = deadline is not None and time.monotonic() > deadline
    if (not ok or timed_out) and still:
      for p in still:
        kill(p)
      return False
    alive = still
    if alive:
      time.sleep(0.05)
  return ok


def launch_local(num_workers: int, command: List[str], retries: int = 1,
                 log_dir: str = "", extra_env: Optional[dict] = None,
                 timeout_s: Optional[float] = None) -> int:
  """Run ``num_workers`` local copies of ``command``, each with its
  rank's distributed environment.  Returns 0 when all succeeded; on a
  worker failure (or past ``timeout_s``) the others are killed and the
  job is retried up to ``retries`` times (the JAX launcher's
  semantics)."""
  for attempt in range(retries + 1):
    port = free_port()
    procs, logs = [], []
    try:
      for rank in range(num_workers):
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update(_rank_env(rank, num_workers, port))
        stdout = None
        if log_dir:
          os.makedirs(log_dir, exist_ok=True)
          logf = open(os.path.join(log_dir, f"worker_{rank}.log"), "w")
          logs.append(logf)
          stdout = logf
        procs.append(subprocess.Popen(
            command, env=env, stdout=stdout,
            stderr=subprocess.STDOUT if stdout else None))
      deadline = None if timeout_s is None else time.monotonic() + timeout_s
      ok = _reap(procs, lambda p: p.poll(), lambda p: p.kill(), deadline)
    finally:
      for p in procs:
        if p.poll() is None:
          p.kill()
        p.wait()
      for logf in logs:
        logf.close()
    if ok:
      return 0
    get_logger().warning("worker failed (attempt %d/%d)", attempt + 1,
                         retries + 1)
  return 1


class WorkerError(RuntimeError):
  """A rank of :func:`spawn` failed, or the group passed its deadline."""


def _spawn_entry(fn, rank: int, world_size: int, port: int, args,
                 results) -> None:
  os.environ.update(_rank_env(rank, world_size, port))
  try:
    out = fn(rank, world_size, *args)
    results.put((rank, True, pickle.dumps(out)))
  except BaseException:  # noqa: BLE001 — reported to the parent, re-raised
    results.put((rank, False, traceback.format_exc()))
    raise


def spawn(fn: Callable[..., Any], world_size: int, args: Sequence = (),
          timeout_s: float = 120.0) -> List[Any]:
  """``[fn(rank, world_size, *args) for rank in ranks]``, each rank in
  its own process (``multiprocessing`` ``spawn``) with the launcher's
  environment, so ``init_distributed()`` inside ``fn`` joins the group.
  ``fn`` and ``args`` must pickle, and ``fn``'s module must import
  without side effects.  The first rank to fail, or the deadline, kills
  the rest and raises :class:`WorkerError` with the failing rank's
  traceback."""
  import multiprocessing as mp
  ctx = mp.get_context("spawn")
  results = ctx.Queue()
  port = free_port()
  procs = [ctx.Process(target=_spawn_entry,
                       args=(fn, r, world_size, port, tuple(args), results),
                       daemon=True)
           for r in range(world_size)]
  deadline = time.monotonic() + timeout_s
  out: dict = {}
  errors: dict = {}
  try:
    for p in procs:
      p.start()
    # Drain results while polling, so a full pipe never blocks a child.
    while len(out) + len(errors) < world_size:
      try:
        rank, ok, payload = results.get(timeout=0.1)
      except queue_lib.Empty:
        dead = [p for p in procs if p.exitcode not in (None, 0)]
        if dead or time.monotonic() > deadline:
          break
        continue
      if ok:
        out[rank] = pickle.loads(payload)
      else:
        errors[rank] = payload
        break
  finally:
    if errors or len(out) < world_size:
      for p in procs:
        if p.is_alive():
          p.kill()
    for p in procs:
      p.join(timeout=10)
      if p.is_alive():
        p.kill()
        p.join()
    results.close()
  if errors:
    rank = min(errors)
    raise WorkerError(f"rank {rank} of {world_size} failed:\n{errors[rank]}")
  if len(out) < world_size:
    codes = {r: p.exitcode for r, p in enumerate(procs)}
    raise WorkerError(
        f"{world_size - len(out)} of {world_size} ranks returned nothing "
        f"(exit codes {codes}; deadline {timeout_s:g} s)")
  return [out[r] for r in range(world_size)]


def main(argv: Optional[List[str]] = None) -> int:
  parser = argparse.ArgumentParser(
      prog="python -m easyparallellibrary_tpu_torch.utils.launcher",
      description="Launch a multi-process job on torch.distributed")
  parser.add_argument("--num_workers", type=int, default=1)
  parser.add_argument("--log_dir", default="")
  parser.add_argument("--retries", type=int, default=1)
  parser.add_argument("--timeout", type=float, default=None,
                      help="kill the group after this many seconds")
  parser.add_argument("command", nargs=argparse.REMAINDER,
                      help="-- python train.py ...")
  args = parser.parse_args(argv)
  command = [c for c in args.command if c != "--"]
  if not command:
    parser.error("no command given; usage: ... -- python train.py")
  return launch_local(args.num_workers, command, retries=args.retries,
                      log_dir=args.log_dir, timeout_s=args.timeout)


if __name__ == "__main__":
  sys.exit(main())
