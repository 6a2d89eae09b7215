"""``perfbench/phases.py`` on the CPU: its readers over synthetic traces
(a kernel launched on the autograd thread while the main thread's
``train/backward`` is open counts under it), and the host phases of a
tiny step of each family from the port's tracer."""

import importlib
import types

import pytest

import tiny
from perfbench import phases, run
from perfbench import trace as trace_lib


def _event(name, start, end, *, cuda=False, cid=0, thread=1,
           annotation=False):
  from torch.autograd import DeviceType
  return types.SimpleNamespace(
      name=name, time_range=types.SimpleNamespace(start=start, end=end),
      device_type=DeviceType.CUDA if cuda else DeviceType.CPU, id=cid,
      is_async=False, is_user_annotation=annotation, thread=thread)


class _Profile:
  def __init__(self, events):
    self._events = events

  def events(self):
    return self._events


def _step_trace():
  """One step: the forward launches a 10 us kernel; the backward's
  autograd thread (2) runs K1's ``delta`` and a remat recompute while
  the main thread (1) holds ``train/backward``; the optimizer launches
  a 5 us kernel; one 2 us kernel launches outside every span.  The
  device's ``record_function`` ranges are annotations and no work."""
  return trace_lib.read(_Profile([
      _event("train/forward", 0, 100),
      _event("aten::mm", 10, 20),
      _event("cudaLaunchKernel", 12, 13, cid=1),
      _event("gemm", 200, 210, cuda=True, cid=1),
      _event("train/backward", 100, 400),
      _event("train/flash_delta", 110, 130, thread=2),
      _event("aten::mul", 111, 115, thread=2),
      _event("cudaLaunchKernel", 112, 113, cid=2, thread=2),
      _event("mul_kernel", 220, 224, cuda=True, cid=2),
      _event("train/remat", 150, 200, thread=2),
      _event("cudaLaunchKernel", 160, 161, cid=3, thread=2),
      _event("gemm", 230, 250, cuda=True, cid=3),
      _event("cudaLaunchKernel", 300, 301, cid=4, thread=2),
      _event("gemm", 260, 300, cuda=True, cid=4),
      _event("train/backward", 205, 305, cuda=True, annotation=True),
      _event("train/optimizer", 400, 450),
      _event("cudaLaunchKernel", 410, 411, cid=5),
      _event("adam_kernel", 410, 415, cuda=True, cid=5),
      _event("cudaMemsetAsync", 460, 461, cid=6),
      _event("memset", 461, 463, cuda=True, cid=6),
  ]), 1e-3, 1)


def test_the_phase_readers_over_a_synthetic_step():
  t = _step_trace()
  assert phases.device_ms(t, "train/forward") == pytest.approx(0.010)
  # delta 4 + recompute 20 + the rest of the backward 40, all launched
  # on the autograd thread inside the main thread's backward.
  assert phases.device_ms(t, "train/backward") == pytest.approx(0.064)
  assert phases.device_ms(t, "train/remat",
                          within="train/backward") == pytest.approx(0.020)
  assert phases.device_ms(t, "train/remat",
                          within="train/forward") is None
  assert phases.device_ms(t, "train/flash_delta") == pytest.approx(0.004)
  assert phases.device_ms(t, "train/optimizer") == pytest.approx(0.005)
  assert phases.launches_per_step(t) == 6
  rest = phases.outside(t)
  assert rest["share_pct"] == pytest.approx(100 * 2 / 81)
  assert rest["largest"] == [["(no op) :: memset", pytest.approx(0.002)]]


def test_no_span_reads_none_and_an_empty_trace_no_launches():
  t = _step_trace()
  assert phases.device_ms(t, "train/nothing") is None
  empty = trace_lib.read(_Profile([]), 1e-3, 1)
  assert phases.launches_per_step(empty) is None
  assert phases.outside(empty)["share_pct"] is None


def test_ring_ms_pairs_each_span_and_sums_repeats():
  events = [{"ph": "M", "name": "thread_name", "tid": 1},
            {"ph": "B", "name": "train/forward", "tid": 1, "ts": 0.0},
            {"ph": "B", "name": "train/remat", "tid": 1, "ts": 100.0},
            {"ph": "E", "name": "train/remat", "tid": 1, "ts": 300.0},
            {"ph": "E", "name": "train/forward", "tid": 1, "ts": 1000.0},
            {"ph": "B", "name": "train/remat", "tid": 1, "ts": 1500.0},
            {"ph": "E", "name": "train/remat", "tid": 1, "ts": 1600.0}]
  assert phases.ring_ms(events) == {"train/forward": 1.0,
                                    "train/remat": pytest.approx(0.3)}
  assert phases.host_phase_ms([{"a": 1.0}, {"a": 3.0, "b": 2.0},
                               {"a": 2.0}]) == {"a": 2.0, "b": 0.0}


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_a_tiny_step_gives_every_host_phase(cell):
  """The port's tracer records the five phases of a tiny step of each
  family, and the forward, backward and optimizer take time."""
  from easyparallellibrary_tpu_torch.observability import trace as port
  config, mix, _ = tiny.spec(cell)
  fam = importlib.import_module(f"perfbench.families.{config['family']}")
  _, state, step, pool, _ = run.program_readings(
      fam.build(config, tiny.CPU), fam, config, mix, 5, tiny.CPU)
  tracer = port.install(port.Tracer(enabled=True))
  try:
    step(state, pool[0], None)
  finally:
    port.install(None)
  host = phases.ring_ms(tracer.events())
  assert set(host) == {"train/forward", "train/backward", "train/optimizer",
                       "train/remat", "train/flash_delta"}
  assert all(host[p] > 0 for p in phases.PHASES)
