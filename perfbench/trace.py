"""Reading a ``torch.profiler`` window (CPU and CUDA activities) of a few
training steps into what the per-layer readers take.

* Every device event (kernels, copies, sets) with its interval and the
  names of the CPU ops that were running when it was launched: the
  launch is the CUDA API call (`cuda*`, `cu*`) that shares the event's
  correlation id, and the ops are those whose interval holds the call.
  A reader picks an operation's device events by op names, not kernel
  names, so whatever the operation launches counts.
* Busy time: the union of the device intervals (the method of
  ``chip_smoke.py``'s ``_busy_us``).
* The breakdown: device time by kernel name, and idle time between
  device intervals by the innermost CPU op running at the gap's middle
  (what the host was doing while the device waited).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

SHORT_GAP_US = 10.0
NAME_CHARS = 120
HOST_IDLE = "no op (host between ops)"


def busy_us(intervals) -> float:
  """Length of the union of ``(start, end)`` intervals."""
  total, cur_start, cur_end = 0.0, None, None
  for start, end in sorted(intervals):
    if cur_end is None or start > cur_end:
      if cur_end is not None:
        total += cur_end - cur_start
      cur_start, cur_end = start, end
    else:
      cur_end = max(cur_end, end)
  if cur_end is not None:
    total += cur_end - cur_start
  return total


def covering(ops: List[tuple], times: Iterable[float]
             ) -> Dict[float, Tuple[str, ...]]:
  """For each time, the names of the ops ``(start, end, name)`` (sorted
  by start) whose interval holds it, outermost first."""
  out, active, i = {}, [], 0
  for t in sorted(set(times)):
    while i < len(ops) and ops[i][0] <= t:
      active.append(ops[i])
      i += 1
    active = [op for op in active if op[1] >= t]
    out[t] = tuple(op[2] for op in active)
  return out


NOISE = ("void ", "at::native::", "(anonymous namespace)::", "c10::",
         "std::")


def short(name: str) -> str:
  """A kernel's name without the namespaces that hide what it does."""
  for part in NOISE:
    name = name.replace(part, "")
  return name[:NAME_CHARS]


def _top(totals: Dict[str, float], n: int = 10) -> List[list]:
  return [[short(name), us / 1e6]
          for name, us in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def read(prof, window_s: float, steps: int) -> dict:
  """``{"window_s", "steps", "busy_s", "kernels": [(name, start_us,
  end_us, op_names)], "breakdown": {"device_ops", "idle_gaps"}}``."""
  from torch.autograd import DeviceType
  device, launches, ops = [], {}, []
  for e in prof.events():
    start, end = e.time_range.start, e.time_range.end
    if e.device_type == DeviceType.CUDA:
      if end > start and not getattr(e, "is_user_annotation", False):
        device.append((e.name, start, end, e.id))
    elif e.name.startswith("cu"):        # a CUDA API call (`cuda*`, `cu*`)
      launches[e.id] = start
    elif not e.is_async:
      ops.append((start, end, e.name))
  ops.sort()
  device.sort(key=lambda d: d[1])
  gaps, reach = [], None
  for _, start, end, _ in device:
    if reach is not None and start > reach:
      gaps.append((reach, start))
    reach = end if reach is None else max(reach, end)
  held = covering(ops, [launches[d[3]] for d in device if d[3] in launches]
                  + [(a + b) / 2 for a, b in gaps if b - a >= SHORT_GAP_US])
  kernels = [(name, start, end, held.get(launches.get(cid), ()))
             for name, start, end, cid in device]
  by_name: Dict[str, float] = {}
  for name, start, end, _ in kernels:
    by_name[name] = by_name.get(name, 0.0) + end - start
  idle: Dict[str, float] = {}
  for a, b in gaps:
    if b - a < SHORT_GAP_US:
      label = f"gaps under {SHORT_GAP_US:g} us"
    else:
      label = (held[(a + b) / 2] or (HOST_IDLE,))[-1]
    idle[label] = idle.get(label, 0.0) + b - a
  return {
      "window_s": window_s,
      "steps": steps,
      "busy_s": busy_us([(k[1], k[2]) for k in kernels]) / 1e6,
      "kernels": kernels,
      "breakdown": {"device_ops": _top(by_name), "idle_gaps": _top(idle)},
  }


def under(trace: dict, op_part: str):
  """The device events launched under an op whose name contains
  ``op_part``: ``(name, start_us, end_us)``."""
  return [(n, s, e) for n, s, e, names in trace["kernels"]
          if any(op_part in x for x in names)]
