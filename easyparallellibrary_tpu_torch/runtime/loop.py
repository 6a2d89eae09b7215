"""The training loop — ``fit`` with checkpoints, resume, the anomaly
sentinel and rollback (port of ``easyparallellibrary_tpu/runtime/loop.py``).

An explicit loop over the step function (``runtime.trainer.
build_train_step`` or ``parallel.make_train_step`` under
``parallelize``), with the JAX loop's contracts:

* restore-on-start from the newest valid checkpoint in
  ``checkpoint_dir``, and the refusal to start fresh over a root whose
  checkpoints all fail validation;
* SIGTERM finishes the step in flight, checkpoints and exits (the
  caller's handler is restored on every exit); ``KeyboardInterrupt``
  checkpoints before it propagates;
* a data factory taking ``start_step`` resumes its stream mid-epoch, and
  exhaustion restarts an epoch;
* transient data errors are retried (``resilience.io_retries``), the
  step watchdog (``resilience.step_timeout_s``) logs a wedged iteration,
  and the sentinel's on-device counter is read once per
  ``resilience.max_bad_steps`` window — never per step — to roll back to
  the newest checkpoint with a compounding learning-rate backoff, up to
  ``MAX_CONSECUTIVE_ROLLBACKS``;
* ``train/*`` spans, a JSONL metric registry under the checkpoint dir
  (``observability.metrics_jsonl``), and the trace exported on every
  exit.

The step's rng is a host ``uint32 [2]`` key (``utils.prng``) folded
with the step index, so a resumed run draws the dropout masks of an
uninterrupted one.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.observability.registry import (
    split_namespaces)
from easyparallellibrary_tpu_torch.profiler.profiler import StepProfiler
from easyparallellibrary_tpu_torch.runtime import resilience as resilience_lib
from easyparallellibrary_tpu_torch.runtime import saver
from easyparallellibrary_tpu_torch.utils import prng
from easyparallellibrary_tpu_torch.utils.device import process_count
from easyparallellibrary_tpu_torch.utils.logging import get_logger
from easyparallellibrary_tpu_torch.utils.retry import (
    PERMANENT_IO_EXCEPTIONS, TRANSIENT_EXCEPTIONS)


def _accepts_start_step(factory: Callable) -> bool:
  """Whether a data factory declares a ``start_step`` parameter (the
  opt-in contract for resuming the input stream mid-epoch)."""
  import inspect
  try:
    params = inspect.signature(factory).parameters
  except (TypeError, ValueError):
    return False
  return "start_step" in params


def _lrs(state):
  return [g["lr"] for g in getattr(state.opt_state, "param_groups", [])]


def _set_lrs(state, lrs):
  for g, lr in zip(state.opt_state.param_groups, lrs):
    g["lr"] = lr


def _check_device(state, device):
  from easyparallellibrary_tpu_torch.utils.device import resolve_device
  want = resolve_device(device)
  for name, p in state.params.items():
    if p.device.type != want.type:
      raise ValueError(
          f"fit(device={str(want)!r}) but parameter {name!r} lives on "
          f"{p.device}; build the state on that device (pass "
          f"device='cpu' to train on the CPU)")
    break
  return want


def fit(step_fn: Callable,
        state,
        data: Iterable[Any],
        *,
        num_steps: int,
        rng=None,
        checkpoint_dir: str = "",
        checkpoint_every: int = 0,
        log_every: int = 50,
        profiler: Optional[StepProfiler] = None,
        shardings=None,
        checkpoint_on_preemption: bool = True,
        metrics_writer=None,
        device=None):
  """Run ``step_fn(state, batch, rng) -> (state, metrics)`` until
  ``state.step`` reaches ``num_steps``.

  ``data`` yields batches (``io.DevicePrefetcher`` puts them on the
  card): an iterable, a re-iterable, or a zero-argument factory; a
  factory with a ``start_step`` parameter is called with the step it
  resumes at (and ``start_step=0`` on epoch restarts), so it can skip
  ``(N * records_per_step) % shard_records`` records.  ``rng`` is a
  ``utils.prng`` key (default ``prng_key(0)``), folded with the step
  index each step.  ``device`` (default the GPU; ``"cpu"`` trains on
  the CPU) must be where the state lives.  Checkpoints, the resume and
  the rollback go by the state's layouts (``shardings``, default
  ``parallel.api.state_shardings(state)``): under a process group every
  rank saves and restores its blocks of the logical leaves.  Returns
  ``(state, last_metrics)``.
  """
  from easyparallellibrary_tpu_torch.parallel.api import state_shardings
  _check_device(state, device)
  log = get_logger()
  config = Env.get().config
  res = config.resilience
  obs = config.observability
  tracer = trace_lib.ensure_configured(config)
  from easyparallellibrary_tpu_torch.observability import device as device_lib
  introspector = device_lib.ensure_configured(config)
  fit_step_captured = False
  rng = prng.prng_key(0) if rng is None else rng
  start_step = int(state.step) if hasattr(state, "step") else 0

  own_registry = None
  if metrics_writer is None and checkpoint_dir and obs.metrics_jsonl:
    from easyparallellibrary_tpu_torch.observability.registry import (
        MetricRegistry)
    from easyparallellibrary_tpu_torch.utils.metrics_writer import (
        MetricsWriter)
    # Flushing floats buffered device values (a host sync), so the
    # period must stay > 1 even when periodic logging is off.
    own_registry = MetricRegistry(MetricsWriter(
        os.path.join(checkpoint_dir, "metrics.jsonl"),
        flush_every=log_every if log_every > 0 else 50))

  # The learning rate at each checkpoint this run wrote or restored: a
  # rollback restores it with the moments (the JAX package keeps it in
  # the optax state of inject_hyperparams), and the backoff compounds
  # from there.
  ckpt_lrs: Dict[int, list] = {}

  def _layouts():
    return state_shardings(state) if shardings is None else shardings

  def _save(at_step: int):
    saver.save_checkpoint(checkpoint_dir,
                          saver.state_tree(state, _layouts()), step=at_step)
    ckpt_lrs[at_step] = _lrs(state)

  if checkpoint_dir:
    try:
      state, rstep = saver.restore_train_state(
          checkpoint_dir, state, after_step=start_step,
          shardings=_layouts())
    except saver.NoValidCheckpointError as e:
      raise RuntimeError(
          f"refusing to start fresh: {checkpoint_dir!r} contains "
          f"checkpoints but none validate ({e})") from e
    except FileNotFoundError as e:
      if saver.has_quarantined(checkpoint_dir):
        raise RuntimeError(
            f"refusing to start fresh: {checkpoint_dir!r} holds only "
            f"quarantined (*.corrupt) checkpoints; inspect or clear "
            f"them to really start over") from e
      rstep = None  # fresh run
    if process_count() > 1:
      # Each process validated the chain on its own; a transient read
      # error can make one fall back further.  Compare with the leader.
      import torch.distributed as dist
      mine = -1 if rstep is None else int(rstep)
      box = [mine]
      dist.broadcast_object_list(box, src=0)
      if int(box[0]) != mine:
        raise RuntimeError(
            f"multi-process resume disagreement: leader restored step "
            f"{box[0]} but process {dist.get_rank()} restored {mine} from "
            f"{checkpoint_dir!r} — refusing to train on diverged states")
    if rstep is not None and int(rstep) > start_step:
      log.info("resuming from %s at step %d", checkpoint_dir, rstep)
      start_step = int(rstep)
      ckpt_lrs[start_step] = _lrs(state)
  base_lrs = _lrs(state)

  preempted = {"flag": False}
  prev_handler = None
  handler_installed = False
  if checkpoint_on_preemption and checkpoint_dir:
    def _on_sigterm(signum, frame):
      preempted["flag"] = True
    try:
      prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
      handler_installed = True
    except ValueError:  # not the main thread
      prev_handler = None

  def _make_iter(at_step: int):
    if not callable(data):
      return iter(data)
    if _accepts_start_step(data):
      return iter(data(start_step=at_step))
    return iter(data())

  io_retries = {"n": 0}

  def _next_with_retry(it):
    """``next(it)`` with transient-IO retry.  StopIteration on a CLEAN
    first attempt is the epoch boundary; on a retry it means a generator
    died on the original error, which is re-raised instead."""
    try:
      return next(it)
    except TRANSIENT_EXCEPTIONS as e:
      if res.io_retries <= 0 or isinstance(e, PERMANENT_IO_EXCEPTIONS):
        raise
      delay, last = res.io_retry_backoff_s, e
      for attempt in range(res.io_retries):
        log.warning("transient data-iterator failure (attempt %d/%d): %s "
                    "— retrying in %.2fs", attempt + 1,
                    res.io_retries + 1, last, delay)
        io_retries["n"] += 1
        if delay:
          time.sleep(delay)
        delay = min(delay * 2 if delay else 0.0, 2.0)
        try:
          return next(it)
        except StopIteration:
          raise last from None
        except TRANSIENT_EXCEPTIONS as e2:
          if isinstance(e2, PERMANENT_IO_EXCEPTIONS):
            raise
          last = e2
      raise last

  watchdog = None
  if res.step_timeout_s > 0:
    watchdog = resilience_lib.StepWatchdog(res.step_timeout_s)

  check_every = res.max_bad_steps if res.max_bad_steps > 0 else 0
  # `trigger` is the step index of the last rollback: only surviving
  # PAST it resets the consecutive count (a clean replayed prefix must
  # not, or a deterministic fault would replay forever).
  rollbacks = {"total": 0, "consecutive": 0, "trigger": -1}
  fed = {"bad": 0, "retries": 0}

  def _rollback(state, bad, at_step):
    log.error(
        "anomaly sentinel: %d consecutive non-finite steps at step %d — "
        "rolling back to the newest valid checkpoint", bad, at_step + 1)
    from easyparallellibrary_tpu_torch.runtime import amp as amp_lib
    bad_params = amp_lib.nonfinite_report(state.params)
    if bad_params:
      log.error("non-finite live params at rollback: %s", bad_params)
    if not checkpoint_dir:
      raise RuntimeError(
          "anomaly rollback requires checkpoint_dir; pass one to fit() "
          "or set resilience.max_bad_steps=0")
    try:
      state, rstep = saver.restore_train_state(checkpoint_dir, state,
                                               shardings=_layouts())
    except FileNotFoundError as e:
      raise RuntimeError(
          f"anomaly rollback at step {at_step + 1} failed: no valid "
          f"checkpoint under {checkpoint_dir!r}") from e
    if getattr(state, "sentinel", None) is not None:
      device = state.sentinel.bad_total.device
      state = state.replace(
          sentinel=resilience_lib.SentinelState.create(device))
    _set_lrs(state, ckpt_lrs.get(rstep, base_lrs))
    if res.rollback_lr_backoff < 1.0:
      factor = res.rollback_lr_backoff ** rollbacks["consecutive"]
      _, applied = resilience_lib.backoff_learning_rate(state.opt_state,
                                                        factor)
      if applied:
        log.warning("rollback: learning rate backed off by %.3g "
                    "(rollback #%d since last progress)", factor,
                    rollbacks["consecutive"])
    log.warning("rolled back to step %d; replaying", rstep)
    return state

  def _cost_card(batch, ptrs):
    from easyparallellibrary_tpu_torch.utils.pytree import tree_bytes
    opt_bytes = sum(tree_bytes([v for v in st.values()
                                if isinstance(v, torch.Tensor)])
                    for st in state.opt_state.state.values())
    dev = next(iter(state.params.values())).device
    peak = device_lib.allocator_peak_bytes(dev)
    return {"flops": float(getattr(profiler, "flops_per_step", 0.0) or 0.0),
            "argument_bytes": float(tree_bytes(state.params) + opt_bytes
                                    + tree_bytes(batch)),
            "peak_hbm_bytes": peak, "donation_requested": True,
            "donation_verified": ptrs == [p.data_ptr() for p in
                                          state.params.values()]}

  it = _make_iter(start_step)
  metrics: Dict[str, Any] = {}
  step_idx = start_step
  try:
    while step_idx < num_steps:
      if preempted["flag"]:
        log.warning("preemption signal received: checkpointing at step %d "
                    "and exiting", step_idx)
        _save(step_idx)
        raise SystemExit(0)
      if watchdog is not None:
        watchdog.arm(step_idx)
      step_rec = tracer.sample_tick("train")
      with tracer.span("train/data_next", cat="train", track="train",
                       record=step_rec):
        try:
          batch = _next_with_retry(it)
        except StopIteration:
          if step_idx == start_step and start_step > 0:
            log.warning(
                "data factory resumed at start_step=%d yielded no "
                "batches; restarting the stream from its beginning.  If "
                "the factory skips records, skip (start_step * "
                "records_per_step) MODULO the shard's record count.",
                start_step)
          it = _make_iter(0)
          try:
            batch = _next_with_retry(it)
          except StopIteration:
            raise RuntimeError(
                "data iterator exhausted and could not be restarted; "
                "pass a re-iterable (list) or a zero-arg iterator "
                "factory to fit() for multi-epoch runs") from None
      capture = introspector is not None and not fit_step_captured
      ptrs = [p.data_ptr() for p in state.params.values()] if capture \
          else None
      with tracer.span("train/step_dispatch", cat="train", track="train",
                       record=step_rec), tracer.sampled(step_rec):
        state, metrics = step_fn(state, batch,
                                 prng.host_fold_in(rng, step_idx))
      if capture:
        fit_step_captured = True
        introspector.capture_twin("train/fit_step",
                                  lambda: _cost_card(batch, ptrs),
                                  compile_count=1)
        if own_registry is not None:
          introspector.publish_hbm(step_idx + 1, registry=own_registry)
      if watchdog is not None:
        watchdog.disarm()
      if check_every and (step_idx + 1) % check_every == 0 \
          and "bad_steps" in metrics:
        # epl-lint: disable=host-sync — the sentinel's designed read: one
        # sync per max_bad_steps window, amortized, never per step
        bad = int(metrics["bad_steps"])
        if profiler is not None and hasattr(profiler, "note_bad_step") \
            and "bad_steps_total" in metrics:
          # epl-lint: disable=host-sync — same amortized window as the
          # bad_steps read above; no additional per-step sync
          total_bad = int(metrics["bad_steps_total"])
          if total_bad > fed["bad"]:
            profiler.note_bad_step(total_bad - fed["bad"])
          fed["bad"] = total_bad
        if bad >= res.max_bad_steps:
          tracer.instant(
              "resilience/sentinel_escalation", cat="resilience",
              track="train",
              args={"bad_steps": bad, "step": step_idx + 1,
                    "action": "rollback" if res.rollback else "raise"})
          if not res.rollback:
            raise RuntimeError(
                f"{bad} consecutive non-finite steps at step "
                f"{step_idx + 1} (resilience.max_bad_steps="
                f"{res.max_bad_steps}, rollback off)")
          rollbacks["total"] += 1
          rollbacks["consecutive"] += 1
          if rollbacks["consecutive"] > \
              resilience_lib.MAX_CONSECUTIVE_ROLLBACKS:
            raise RuntimeError(
                f"{rollbacks['consecutive']} rollbacks without a clean "
                f"window in between — the anomaly is not transient; "
                f"giving up at step {step_idx + 1}")
          with tracer.span("resilience/rollback", cat="resilience",
                           track="train"):
            state = _rollback(state, bad, step_idx)
          fed["bad"] = 0  # the sentinel counters were reset with the state
          rollbacks["trigger"] = step_idx
          step_idx = int(state.step)
          it = _make_iter(step_idx)
          continue  # the bad window is not checkpointed or logged
        if step_idx > rollbacks["trigger"]:
          rollbacks["consecutive"] = 0
      if profiler is not None:
        profiler.tick()
        if hasattr(profiler, "note_retry") and io_retries["n"] > \
            fed["retries"]:
          profiler.note_retry(io_retries["n"] - fed["retries"])
          fed["retries"] = io_retries["n"]
      out = metrics
      if io_retries["n"] or rollbacks["total"]:
        out = {**metrics, "io_retries": io_retries["n"],
               "rollbacks": rollbacks["total"]}
      if metrics_writer is not None:
        # Writers buffer device values and float them at their flush
        # boundary; legacy flat keys.
        with tracer.span("train/metrics_flush", cat="train",
                         track="train", record=step_rec):
          metrics_writer.write(step_idx + 1, out)
      elif own_registry is not None:
        with tracer.span("train/metrics_flush", cat="train",
                         track="train", record=step_rec):
          own_registry.publish_many(step_idx + 1, split_namespaces(out))
      if (introspector is not None and own_registry is not None
          and log_every and (step_idx + 1) % log_every == 0):
        introspector.publish_hbm(step_idx + 1, registry=own_registry)
      if log_every and (step_idx + 1) % log_every == 0:
        # The loop's one periodic host sync.
        with tracer.span("train/host_sync", cat="train", track="train",
                         record=step_rec):
          loss = metrics.get("loss")
          # epl-lint: disable=host-sync — the loop's ONE designated
          # periodic sync point (log_every boundary), wrapped in the
          # train/host_sync span precisely because it syncs
          loss_text = f"{float(loss):.5f}" if loss is not None else "n/a"
          log.info("step %d: loss %s", step_idx + 1, loss_text)
      if (checkpoint_dir and checkpoint_every
          and (step_idx + 1) % checkpoint_every == 0):
        _save(step_idx + 1)
      step_idx += 1
  except KeyboardInterrupt:
    if checkpoint_on_preemption and checkpoint_dir:
      log.warning("KeyboardInterrupt: saving final checkpoint at step %d",
                  step_idx)
      try:
        _save(step_idx)
      except Exception as e:  # a failed best-effort save must not mask it
        log.error("final checkpoint on interrupt failed: %s", e)
    raise
  finally:
    if handler_installed and prev_handler is not None:
      signal.signal(signal.SIGTERM, prev_handler)
    if watchdog is not None:
      watchdog.close()
    if own_registry is not None:
      try:
        if profiler is not None and hasattr(profiler, "publish"):
          profiler.publish(own_registry, step_idx)
        own_registry.close()
      except Exception as e:  # must not mask the real exit
        log.error("metrics flush on exit failed: %s", e)
    if tracer.enabled:
      path = obs.trace_path or (os.path.join(checkpoint_dir, "trace.json")
                                if checkpoint_dir else "")
      if path:
        try:
          tracer.export(path)
        except Exception as e:  # must not mask the real exit
          log.error("trace export to %s failed: %s", path, e)
  if profiler is not None and profiler.summary():
    log.info("training profile: %s", profiler.summary())
  return state, metrics


def evaluate(eval_fn: Callable, state, data: Iterable[Any], *,
             max_batches: int = 0, rng=None) -> Dict[str, float]:
  """Average ``eval_fn(state, batch, rng) -> metrics`` over ``data``."""
  rng = prng.prng_key(0) if rng is None else rng
  totals: Dict[str, float] = {}
  count = 0
  for i, batch in enumerate(data):
    if max_batches and i >= max_batches:
      break
    metrics = eval_fn(state, batch, rng)
    for k, v in metrics.items():
      totals[k] = totals.get(k, 0.0) + float(v)
    count += 1
  return {k: v / max(count, 1) for k, v in totals.items()}


def train_and_evaluate(step_fn: Callable, eval_fn: Callable, state,
                       train_data: Iterable[Any],
                       eval_data: Iterable[Any], *,
                       num_steps: int, eval_every: int,
                       max_eval_batches: int = 0, **fit_kwargs):
  """Interleave training with periodic evaluation."""
  log = get_logger()
  done = int(state.step) if hasattr(state, "step") else 0
  metrics = {}
  while done < num_steps:
    target = min(done + eval_every, num_steps)
    state, metrics = fit(step_fn, state, train_data, num_steps=target,
                         **fit_kwargs)
    done = target
    eval_metrics = evaluate(eval_fn, state, eval_data,
                            max_batches=max_eval_batches)
    log.info("eval @ step %d: %s", done, eval_metrics)
    metrics = {**metrics, **{f"eval_{k}": v
                             for k, v in eval_metrics.items()}}
  return state, metrics
