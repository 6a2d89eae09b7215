"""epl-lint over the PyTorch port (``easyparallellibrary_tpu_torch/
analysis/``) against the JAX package's linter.

The carried-over rules (``metric-schema``, ``span-pairing``,
``lock-discipline``, ``suppression``) find the same findings (rule,
line, column) as JAX's on shared fixture sources.  Each retargeted rule
(``host-sync``, ``device-introspection``, ``recompile-hazard``,
``donation-after-use``) finds its planted violation in a PyTorch fixture
and nothing in the fixture's clean twin.  The port's package scans with
zero findings against an empty baseline.
"""

import os
import textwrap

import pytest

from easyparallellibrary_tpu.analysis import Analyzer as JAnalyzer
from easyparallellibrary_tpu_torch.analysis import (
    Analyzer, apply_baseline, default_baseline_path, load_baseline,
    package_root, write_baseline)
from easyparallellibrary_tpu_torch.analysis import __main__ as cli
from easyparallellibrary_tpu_torch.analysis.core import Suppressions

CARRIED = ("metric-schema", "span-pairing", "lock-discipline", "suppression")


def _write(root, rel, src):
  path = os.path.join(str(root), rel)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, "w") as f:
    f.write(textwrap.dedent(src))
  return path


def _keys(findings, rules):
  return sorted((f.rule, f.path, f.line, f.col) for f in findings
                if f.rule in rules)


def _by_rule(findings, rule):
  return [f for f in findings if f.rule == rule]


# Fixture sources shared by both linters (plain Python: no jax, no torch).
SHARED = {
    "obs/emit.py": """\
        def emit(reg, step, record):
          reg.publish(step, record, "serving")
          reg.publish(step, record, "latency/foo")
          reg.publish_many(step, {"train": record, "bogus": record})
          reg.publish(step, record, namespace="serving/fleet")
          reg.publish(step, record, f"comm/{step}")
          reg.publish(step, record, f"{step}/x")
          return reg.namespaced("queues/depth", record)
        """,
    "obs/t.py": """\
        def a(tracer):
          tracer.span("phase")


        def b(tracer):
          with tracer.span("phase"):
            pass


        def c(tracer, uid):
          tracer.begin(f"request {uid}")


        def d(tracer, state):
          tracer.end(f"request {state.req.uid}")


        def e(self):
          self._tracer.end("orphan")


        def f(tracer, uid):
          tracer.begin(f"open {uid}")
        """,
    "obs/w.py": """\
        import threading


        class Ring:
          def __init__(self):
            self._lock = threading.Lock()
            self._n = 0

          def add(self):
            with self._lock:
              self._n += 1

          def reset(self):
            self._n = 0
        """,
    "runtime/w.py": """\
        import threading


        class Watchdog:
          def __init__(self):
            self._cond = threading.Condition()
            self.fired = 0
            self._quiet = 0

          def start(self):
            t = threading.Thread(target=self._run)
            t.start()

          def _run(self):
            self._fire()
            with self._cond:
              self._quiet += 1

          def _fire(self):
            self.fired += 1
        """,
    "runtime/clean.py": """\
        import threading


        class Watchdog:
          def __init__(self):
            self._cond = threading.Condition()
            self.fired = 0

          def start(self):
            t = threading.Thread(target=self._run)
            t.start()

          def _run(self):
            with self._cond:
              self.fired += 1
        """,
    "obs/sup.py": """\
        def g(reg, step, record):
          # epl-lint: disable=metric-schema — a legacy dashboard key
          reg.publish(step, record, "legacy/a")
          reg.publish(step, record, "legacy/b")  # epl-lint: disable=metric-schema,span-pairing — both
          # epl-lint: disable=metric-schema
          reg.publish(step, record, "legacy/c")
          x = 1  # epl-lint: nonsense
          return x
        """,
    "observability/registry.py": """\
        NAMESPACES = ("train", "serving", "comm", "resilience", "legacy2")
        """,
}


def test_carried_over_rules_find_what_jax_finds(tmp_path):
  for rel, src in SHARED.items():
    _write(tmp_path, rel, src)
  got = _keys(Analyzer(str(tmp_path)).run(), CARRIED)
  want = _keys(JAnalyzer(str(tmp_path)).run(), CARRIED)
  assert got == want
  assert {r for r, *_ in got} == set(CARRIED)
  assert len(got) >= 9


@pytest.mark.parametrize("rel", sorted(SHARED))
def test_carried_over_rules_agree_file_by_file(tmp_path, rel):
  path = _write(tmp_path, rel, SHARED[rel])
  assert _keys(Analyzer(path).run(), CARRIED) == \
      _keys(JAnalyzer(path).run(), CARRIED)


def test_suppressions_bind_as_in_jax():
  sup = Suppressions("m.py", (
      "x = 1\n"
      "# epl-lint: disable=host-sync — standalone binds to next code\n"
      "# (continuation comment)\n"
      "y = 2\n"
      "z = 3  # epl-lint: disable=span-pairing — trailing binds here\n"))
  assert sup.is_suppressed("host-sync", 4)
  assert not sup.is_suppressed("host-sync", 5)
  assert sup.is_suppressed("span-pairing", 5)


# ------------------------------------------------------- retargeted rules

# (rule, module path, planted source, its clean twin, planted lines)
RETARGETED = [
    ("host-sync", "serving/eng.py", """\
        import numpy as np
        import torch


        def step_loop(step_fn, state, batch, log):
          state, metrics = step_fn(state, batch)
          loss = metrics["loss"].item()
          log(f"{metrics['loss']}")
          if metrics["bad"]:
            pass
          return np.asarray(metrics["x"]), float(loss)


        class Engine:
          def _fetch(self, *cols):
            return torch.cat(cols).cpu().numpy()

          def step(self, params, ids):
            logits = paged_step_logits(self.model, params, ids)
            self._last = logits
            out = self._fetch(logits.argmax(-1))
            return out.tolist(), int(out[0])

          def peek(self):
            return self._last.cpu()


        def forward(model, params, x):
          return torch.func.functional_call(model, params, (x,)).tolist()
        """, """\
        import numpy as np
        import torch


        def step_loop(step_fn, state, batch, log, fetch):
          state, metrics = step_fn(state, batch)
          host = fetch(metrics)
          return float(host["loss"])


        class Engine:
          def _fetch(self, *cols):
            return torch.cat(cols).cpu().numpy()

          def step(self, params, ids):
            logits = paged_step_logits(self.model, params, ids)
            out = self._fetch(logits.argmax(-1))
            return out.tolist(), int(out[0])


        def cold(x):
          return x.cpu().numpy().tolist(), float(x.sum())
        """, [7, 8, 9, 11, 11, 25, 29]),
    ("device-introspection", "serving/eng.py", """\
        import torch
        from torch.utils.flop_counter import FlopCounterMode


        def step(dev):
          peak = torch.cuda.max_memory_allocated(dev)
          with torch.profiler.profile() as prof:
            pass
          with FlopCounterMode(display=False):
            pass
          return peak, torch.cuda.mem_get_info(dev), prof
        """, """\
        from easyparallellibrary_tpu_torch.observability import device


        def step(dev):
          return device.allocator_peak_bytes(dev)
        """, [6, 7, 9, 11]),
    ("device-introspection", "models/m.py", """\
        import torch


        def train(steps, dev):
          peaks = []
          for _ in range(steps):
            peaks.append(torch.cuda.memory_stats(dev))
          return peaks, torch.cuda.max_memory_allocated(dev)
        """, """\
        import torch


        def train(steps, dev):
          for _ in range(steps):
            pass
          return torch.cuda.max_memory_allocated(dev)
        """, [7]),
    ("recompile-hazard", "kernels/k.py", """\
        import ctypes

        import torch

        from easyparallellibrary_tpu_torch.kernels import _build

        _compiled = torch.compile(lambda x: x * 2)


        def launch_all(names, x):
          for name in names:
            _build.load(name)
          while x.sum() < 0:
            lib = ctypes.CDLL("libfoo.so")
          y = torch.compile(lambda t: t + 1)(x)
          return _compiled(x, "mode"), _compiled(x, f"{y}")
        """, """\
        import torch

        from easyparallellibrary_tpu_torch.kernels import _build

        _compiled = torch.compile(lambda x: x * 2)


        def _library():
          return _build.load("flash_attention")


        def launch_all(names, x):
          lib = _library()
          for name in names:
            x = _compiled(x)
          return lib, x
        """, [12, 14, 15, 16, 16]),
    ("donation-after-use", "runtime/free.py", """\
        import torch


        def release(buf, other):
          buf.untyped_storage().resize_(0)
          total = buf.sum()
          other.resize_(0)
          if other.numel():
            pass
          return total
        """, """\
        import torch


        def release(buf, other):
          buf.untyped_storage().resize_(0)
          buf = torch.empty(0)
          other.resize_(0)
          other = None
          return buf, other
        """, [6, 8]),
]


@pytest.mark.parametrize("rule,rel,planted,clean,lines", RETARGETED,
                         ids=[f"{r[0]}:{r[1]}" for r in RETARGETED])
def test_retargeted_rule_finds_its_planted_violation(tmp_path, rule, rel,
                                                     planted, clean, lines):
  _write(tmp_path / "planted", rel, planted)
  found = _by_rule(Analyzer(str(tmp_path / "planted")).run(), rule)
  assert sorted(f.line for f in found) == lines, [f.format() for f in found]
  _write(tmp_path / "clean", rel, clean)
  assert Analyzer(str(tmp_path / "clean")).run() == []


def test_host_sync_covers_the_hot_modules_only(tmp_path):
  src = """\
      def loop(step_fn, state):
        _state, metrics = step_fn(state)
        return metrics["loss"].item()
      """
  for rel in ("serving/a.py", "observability/b.py", "sim/c.py",
              "runtime/loop.py"):
    path = _write(tmp_path, rel, src)
    assert [f.rule for f in Analyzer(path).run()] == ["host-sync"], rel
  for rel in ("runtime/trainer.py", "models/gpt.py", "testing/x.py"):
    path = _write(tmp_path, rel, src)
    assert Analyzer(path).run() == [], rel


def test_device_introspection_homes_are_exempt(tmp_path):
  src = """\
      import torch


      def gauge(dev):
        for _ in range(3):
          torch.cuda.max_memory_allocated(dev)
        with torch.profiler.profile():
          pass
      """
  for home in ("observability/device.py", "profiler/memory.py"):
    assert Analyzer(_write(tmp_path, home, src)).run() == []
  assert [f.line for f in Analyzer(_write(
      tmp_path, "serving/x.py", src)).run()] == [6, 7]


# ------------------------------------------------------------- the port


@pytest.mark.quick
def test_the_port_scans_with_zero_findings_and_an_empty_baseline():
  assert package_root().endswith("easyparallellibrary_tpu_torch")
  assert load_baseline(default_baseline_path()) == {}
  findings = Analyzer(package_root()).run()
  assert findings == [], "\n".join(f.format() for f in findings)


def test_cli_exit_codes_list_and_baseline(tmp_path, capsys):
  assert cli.main([]) == 0
  assert "epl-lint: clean" in capsys.readouterr().out
  assert cli.main(["--list-rules"]) == 0
  listed = capsys.readouterr().out.split("\n")
  assert sorted(line.split()[0] for line in listed if line) == sorted([
      "host-sync", "recompile-hazard", "donation-after-use",
      "metric-schema", "span-pairing", "lock-discipline",
      "device-introspection"])
  bad = _write(tmp_path, "serving/eng.py", RETARGETED[0][2])
  assert cli.main([bad]) == 1
  assert "[host-sync]" in capsys.readouterr().out
  base = str(tmp_path / "base.json")
  assert cli.main([bad, "--baseline", base, "--write-baseline"]) == 0
  capsys.readouterr()
  assert cli.main([bad, "--baseline", base]) == 0
  assert "7 baselined finding(s) suppressed" in capsys.readouterr().out
  findings = Analyzer(bad).run()
  write_baseline(base, findings[:2])
  new, old = apply_baseline(findings, load_baseline(base))
  assert len(new) == len(findings) - 2 and len(old) == 2
