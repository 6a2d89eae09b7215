"""FLOP counting, collective traffic and MFU accounting (port of
``easyparallellibrary_tpu/profiler/flops.py``).

The JAX package asks XLA: ``compiled_cost`` reads
``Compiled.cost_analysis()`` of the optimized program, and the
collective counters parse its StableHLO text.  PyTorch runs eagerly and
has no compiled program, so the port counts one run of the function:

* :func:`compiled_cost` runs ``fn`` on copies of its arguments
  (:func:`copy_args`; the caller's tensors are never touched) under
  ``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode that
  sums each op's operand and result bytes.  The port's kernels count by
  formula, never by what runs inside them (``kernels/_cost.py``), so a
  step counts the same with the kernels and with their plain versions,
  on the card and on the CPU.  Keys: ``"flops"``, ``"bytes accessed"``
  and ``"bytes accessedout{}"`` (the result bytes), XLA's names.  XLA's
  other keys have no counterpart here: ``transcendentals``,
  ``utilization<i>{}``, ``optimal_seconds`` and the per-operand
  ``bytes accessed<i>{}`` (:data:`XLA_ONLY_COST_KEYS`).  The counter
  sees the matrix products (two FLOPs a multiply-add), not the
  elementwise work, which XLA also counts.
* :func:`collective_op_sizes` reads the collectives the backend ran from
  ``torch.profiler`` events (``gloo:<op>`` / ``nccl:<op>``), under JAX's
  op kinds and sized as JAX sizes them, by the result;
  :func:`collective_bytes` runs ``fn`` once under the profiler and sums
  them.  In a process group every rank must make the call.
* :class:`FlopsProfiler` — the per-step GFLOPs / MFU / comm-share line.

The peak table (the dense bf16 tensor-core rate of the card, the one
denominator of every MFU number of the port) and the GPT forward's FLOP
count that the serving engine's cost card reports
(observability/device.py) live here too.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from easyparallellibrary_tpu_torch.utils.logging import get_logger

# Dense bf16 FLOP/s per card by `torch.cuda.get_device_name()` prefix
# (NVIDIA data sheets, without sparsity).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,   # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
    "NVIDIA H200": 989e12,
}
_GUESS = 989e12

# Keys of XLA's cost analysis that the port does not produce (module
# docstring); a name ending in "{}" after a digit is a per-operand key.
XLA_ONLY_COST_KEYS = ("transcendentals", "utilization<i>{}",
                      "optimal_seconds", "bytes accessed<i>{}")


def is_xla_only_cost_key(key: str) -> bool:
  """Whether ``key`` of a JAX cost analysis has no port counterpart."""
  if key in ("transcendentals", "optimal_seconds"):
    return True
  for stem in ("utilization", "bytes accessed"):
    tail = key[len(stem):]
    if key.startswith(stem) and tail.endswith("{}") and tail[:-2].isdigit():
      return True
  return False


def peak_flops_info(device=None) -> Tuple[float, bool]:
  """(peak bf16 FLOP/s, recognized?) for the card, matched on the
  longest name prefix.  An unknown card is flagged: the MFU denominator
  is then a guess."""
  name = torch.cuda.get_device_name(device)
  for prefix, flops in sorted(PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
    if name.startswith(prefix):
      return flops, True
  get_logger().warning("unknown device %r; assuming %.0f TFLOP/s — MFU "
                       "numbers against this denominator are guesses", name,
                       _GUESS / 1e12)
  return _GUESS, False


def peak_flops_per_chip(device=None) -> float:
  return peak_flops_info(device)[0]


def estimate_mfu(flops_per_step: float, step_time_s: float,
                 n_chips: Optional[int] = None, device=None) -> float:
  """Model FLOPs utilisation: ``flops_per_step`` over ``step_time_s``
  against the card's dense bf16 peak times ``n_chips`` (default: the
  visible CUDA devices)."""
  if n_chips is None:
    n_chips = max(1, torch.cuda.device_count())
  achieved = flops_per_step / max(step_time_s, 1e-12)
  return achieved / (peak_flops_per_chip(device) * n_chips)


def gpt_forward_flops(cfg: Any, tokens: int, context: int) -> float:
  """Forward FLOPs of ``tokens`` query tokens through a GPT of config
  ``cfg`` (``d_model``, ``d_ff``, ``num_layers``, ``vocab_size``), each
  attending ``context`` keys: two per multiply-add of every weight
  matrix (qkv and output projections, the MLP, the tied head) plus
  QK^T and PV."""
  D, F, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
  n_matmul = L * (4 * D * D + 2 * D * F) + D * V
  return float(tokens) * (2.0 * n_matmul + 4.0 * L * D * context)


# ------------------------------------------------------ argument copies --


def _is_port_object(x) -> bool:
  return (type(x).__module__.startswith("easyparallellibrary_tpu_torch")
          and hasattr(x, "__dict__")
          and not isinstance(x, torch.nn.Module))


def _copy(x, memo: Dict[int, Any], clone: bool = True):
  """``x`` with every tensor cloned (``clone=False``: walked and
  recorded in ``memo``, nothing built)."""
  key = id(x)
  if key in memo:
    return memo[key]
  if not clone:
    memo[key] = x
    if isinstance(x, dict):
      for k, v in x.items():
        _copy(k, memo, False)
        _copy(v, memo, False)
    elif isinstance(x, (list, tuple)):
      for v in x:
        _copy(v, memo, False)
    elif isinstance(x, torch.optim.Optimizer) or _is_port_object(x):
      for v in vars(x).values():
        _copy(v, memo, False)
    return x
  if isinstance(x, torch.Tensor):
    y = x.detach().clone()
    if x.requires_grad:
      y.requires_grad_(True)
    memo[key] = y
    if x.grad is not None:
      y.grad = x.grad.detach().clone()
    return y
  if isinstance(x, dict):
    y = copy.copy(x)
    memo[key] = y
    y.clear()
    for k, v in x.items():
      y[_copy(k, memo)] = _copy(v, memo)
    return y
  if isinstance(x, list):
    y = []
    memo[key] = y
    y.extend(_copy(v, memo) for v in x)
    return y
  if isinstance(x, tuple):
    items = [_copy(v, memo) for v in x]
    y = type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    memo[key] = y
    return y
  if isinstance(x, torch.optim.Optimizer) or _is_port_object(x):
    # The object's own attributes, each copied (an optimizer's
    # param_groups and state re-keyed onto the copied parameters);
    # streams, modules and process groups are shared.
    y = object.__new__(type(x))
    memo[key] = y
    for name, value in vars(x).items():
      object.__setattr__(y, name, _copy(value, memo))
    return y
  return x


def tensors_of(tree) -> List[torch.Tensor]:
  """Every distinct tensor in ``tree``, walked as :func:`copy_args`
  walks it (an optimizer's parameters and state included)."""
  memo: Dict[int, Any] = {}
  _copy(tree, memo, clone=False)
  return [t for t in memo.values() if isinstance(t, torch.Tensor)]


def copy_args(*trees):
  """Copies of ``trees`` in which every tensor (parameters, optimizer
  moments, batches) is a fresh clone, shared tensors staying shared:
  what the profilers run a step on, so that a step that updates its
  state in place leaves the caller's bit-equal.  Modules, streams,
  process groups and other objects are shared, not copied."""
  memo: Dict[int, Any] = {}
  out = tuple(_copy(t, memo) for t in trees)
  return out[0] if len(trees) == 1 else out


# -------------------------------------------------------------- the count --


def _tensor_bytes(tree) -> List[int]:
  out: List[int] = []
  if isinstance(tree, torch.Tensor):
    out.append(tree.numel() * tree.element_size())
  elif isinstance(tree, (tuple, list)):
    for x in tree:
      out.extend(_tensor_bytes(x))
  return out


class _Count(TorchDispatchMode):
  """Each op's operand and result bytes (views move none); kernels
  booked by formula through ``kernels._cost.kernel_call``."""

  def __init__(self):
    super().__init__()
    self.operand_bytes = 0
    self.result_bytes = 0
    self.kernel_flops: Dict[str, int] = {}

  def add_kernel(self, name: str, flops: int, in_bytes: int,
                 out_bytes: int) -> None:
    self.kernel_flops[name] = self.kernel_flops.get(name, 0) + flops
    self.operand_bytes += in_bytes
    self.result_bytes += out_bytes

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    if not func.is_view:
      self.operand_bytes += sum(_tensor_bytes(list(args)))
      self.operand_bytes += sum(_tensor_bytes(list((kwargs or {}).values())))
      self.result_bytes += sum(_tensor_bytes(out))
    return out


def _counted_run(fn: Callable, args, kwargs) -> Dict[str, float]:
  from torch.utils.flop_counter import FlopCounterMode

  from easyparallellibrary_tpu_torch.kernels import _cost
  args, kwargs = copy_args(args, kwargs)
  counter = FlopCounterMode(display=False)
  count = _Count()
  _cost._ACTIVE.append(count)
  try:
    with counter, count:
      fn(*args, **kwargs)
  finally:
    _cost._ACTIVE.remove(count)
  flops = counter.get_total_flops() + sum(count.kernel_flops.values())
  return {"flops": float(flops),
          "bytes accessed": float(count.operand_bytes + count.result_bytes),
          "bytes accessedout{}": float(count.result_bytes)}


def compiled_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
  """The cost of one run of ``fn(*args, **kwargs)`` on copies of the
  arguments: ``"flops"``, ``"bytes accessed"``, ``"bytes
  accessedout{}"`` (module docstring).  The run is real: on a process
  group every rank must make the call."""
  return _counted_run(fn, args, kwargs)


# ---------------------------------------------------------- collectives --

# torch.distributed backend event names -> JAX's collective op kinds.
_EVENT_KINDS = (("all_reduce", "all_reduce"), ("allreduce", "all_reduce"),
                ("reduce_scatter", "reduce_scatter"),
                ("all_gather", "all_gather"), ("allgather", "all_gather"),
                ("all_to_all", "all_to_all"), ("alltoall", "all_to_all"),
                ("send", "collective_permute"),
                ("broadcast", "collective_broadcast"))
_COLLECTIVE_OPS = ("all_gather", "all_reduce", "reduce_scatter",
                   "collective_permute", "all_to_all",
                   "collective_broadcast")
_DTYPE_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
                "long int": 8, "long": 8, "int": 4, "short int": 2,
                "signed char": 1, "unsigned char": 1, "bool": 1}


def _event_kind(name: str) -> Optional[str]:
  if not name.startswith(("gloo:", "nccl:")):
    return None
  op = name.split(":", 1)[1]
  for needle, kind in _EVENT_KINDS:
    if needle in op:
      return kind
  return None


def collective_op_sizes(events, group_size: Optional[int] = None,
                        dtype_bytes: int = 4) -> List[Tuple[str, float]]:
  """``(op_kind, result_bytes)`` for every collective the backend ran in
  ``events`` (a ``torch.profiler`` event list), in order, under JAX's
  op kinds: ``all_reduce``, ``all_gather``, ``reduce_scatter``,
  ``all_to_all``, ``collective_permute`` (a send; its receive is the
  same transfer) and ``collective_broadcast``.  Each event carries the
  tensor handed to the backend (``observability.device.
  collective_event_bytes``); an all-gather's result is ``group_size``
  times it and a reduce-scatter's a ``group_size``-th (default: the
  default group's size), as JAX sizes each op by its result tensor.
  ``dtype_bytes`` is the width of an event whose dtype the profiler did
  not record."""
  from easyparallellibrary_tpu_torch.observability.device import (
      collective_event_bytes)
  if group_size is None:
    import torch.distributed as dist
    group_size = (dist.get_world_size()
                  if dist.is_available() and dist.is_initialized() else 1)
  out: List[Tuple[str, float]] = []
  for e in events:
    kind = _event_kind(e.name)
    if kind is None:
      continue
    dtypes = getattr(e, "input_dtypes", None) or []
    width = _DTYPE_BYTES.get(dtypes[0], dtype_bytes) if dtypes \
        else dtype_bytes
    handed = collective_event_bytes([e], width)
    if kind == "all_gather":
      handed *= group_size
    elif kind == "reduce_scatter":
      handed /= group_size
    out.append((kind, float(handed)))
  return out


class _Event:
  """A profiler record with the fields :func:`collective_op_sizes`
  reads, taken from the profiler's raw (kineto) events, which carry
  each input's dtype in every PyTorch release the port runs on."""

  def __init__(self, raw):
    self.name = raw.name()
    self.input_shapes = raw.shapes()
    self.input_dtypes = raw.dtypes()


def collective_sizes_of(fn: Callable, *args, **kwargs
                        ) -> List[Tuple[str, float]]:
  """:func:`collective_op_sizes` of one run of ``fn`` on copies of its
  arguments under ``torch.profiler`` (every rank of the group runs it)."""
  args, kwargs = copy_args(args, kwargs)
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU],
      record_shapes=True) as prof:
    fn(*args, **kwargs)
  return collective_op_sizes(
      [_Event(e) for e in prof.profiler.kineto_results.events()
       if e.name().startswith(("gloo:", "nccl:"))])


def collective_bytes(fn: Callable, *args, **kwargs) -> float:
  """Result bytes of the collectives one run of ``fn(*args)`` made: the
  comm-traffic counter of the profiler's comm-share line."""
  return float(sum(b for _kind, b in collective_sizes_of(fn, *args,
                                                         **kwargs)))


# ------------------------------------------------------------ the hook --


class FlopsProfiler:
  """Per-step GFLOPs / MFU reporter (the reference's FlopsProfilerHook:
  measure once, then log every ``every_n_steps``).  ``fit(profiler=)``
  takes it: ``tick`` is :meth:`step`, ``summary`` the last line."""

  def __init__(self, flops_per_step: Optional[float] = None,
               every_n_steps: int = 100,
               comm_bytes_per_step: Optional[float] = None,
               link_bytes_per_s: Optional[float] = None,
               registry=None):
    # Optional MetricRegistry: each stats line also publishes under the
    # namespaced schema (train/*, comm/*, resilience/*).
    self.registry = registry
    self.flops_per_step = flops_per_step
    self.every_n_steps = every_n_steps
    # The comm-share line: what fraction of the step the wire would need
    # at link_bytes_per_s (the quantity the overlap crossover of
    # parallel/planner.py trades against the matrix products).
    self.comm_bytes_per_step = comm_bytes_per_step
    if link_bytes_per_s is None:
      from easyparallellibrary_tpu_torch.parallel.planner import (
          DEFAULT_LINK_BYTES_PER_S)
      link_bytes_per_s = DEFAULT_LINK_BYTES_PER_S
    self.link_bytes_per_s = link_bytes_per_s
    self.bad_steps = 0
    self.io_retries = 0
    self.last: Dict[str, float] = {}
    self._t0 = None
    self._step0 = 0
    self._step = 0

  def note_bad_step(self, n: int = 1):
    """Count ``n`` anomaly-skipped steps into the next stats line."""
    self.bad_steps += n

  def note_retry(self, n: int = 1):
    """Count ``n`` transient-IO retries into the next stats line."""
    self.io_retries += n

  def measure_from(self, fn: Callable, *args, **kwargs):
    """Fill ``flops_per_step`` (and the comm counter) from one counted
    run of ``fn`` on copies of its arguments."""
    cost = compiled_cost(fn, *args, **kwargs)
    self.flops_per_step = float(cost.get("flops", 0.0))
    try:
      self.comm_bytes_per_step = collective_bytes(fn, *args, **kwargs)
    except Exception:  # the comm counter is best-effort; flops must survive
      self.comm_bytes_per_step = None
    return self.flops_per_step

  def step(self) -> Optional[Dict[str, float]]:
    """Call once per training step; returns stats every n steps."""
    now = time.perf_counter()
    self._step += 1
    if self._t0 is None:
      self._t0 = now
      self._step0 = self._step
      return None
    if (self._step - self._step0) % self.every_n_steps != 0:
      return None
    dt = (now - self._t0) / (self._step - self._step0)
    self._t0, self._step0 = now, self._step
    stats = {"step_time_s": dt, "steps_per_sec": 1.0 / dt}
    if self.flops_per_step:
      stats["gflops_per_step"] = self.flops_per_step / 1e9
      if torch.cuda.is_available():
        # MFU is against the card's peak: no card, no MFU.
        stats["mfu"] = estimate_mfu(self.flops_per_step, dt)
    if self.comm_bytes_per_step:
      stats["comm_gb_per_step"] = self.comm_bytes_per_step / 1e9
      stats["comm_share"] = min(
          self.comm_bytes_per_step / self.link_bytes_per_s / dt, 1.0)
    if self.bad_steps:
      stats["bad_steps"] = float(self.bad_steps)
    if self.io_retries:
      stats["io_retries"] = float(self.io_retries)
    get_logger().info("flops profiler: %s", stats)
    if self.registry is not None:
      from easyparallellibrary_tpu_torch.observability.registry import (
          split_namespaces)
      self.registry.publish_many(self._step, split_namespaces(stats))
    self.last = stats
    return stats

  tick = step

  def summary(self) -> Dict[str, float]:
    """The last stats line ({} before the first)."""
    return dict(self.last)
