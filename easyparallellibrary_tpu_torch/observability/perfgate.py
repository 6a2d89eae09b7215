"""Perf regression gate: cost-card and benchmark-evidence invariants
pinned in a budget file (port of
``easyparallellibrary_tpu/observability/perfgate.py``: the same entry
forms, tolerances and exit codes).

The budget pins

* **cost-card invariants** — per twin of the deterministic tiny
  reference geometry :func:`collect_cards` builds, bounds on the numbers
  the serving engine's cost card reports after its first step
  (observability/device.py): ``compile_count`` (kernel libraries loaded
  by the end of the first step), ``flops`` and ``flops_per_token``,
  ``kv_bytes_per_request``, ``peak_hbm_bytes`` and
  ``donation_verified`` (the caches written in place).  All but the
  peak are counted, not timed, and read the same on the CPU and on the
  card; the peak is a static bound on the CPU and measured on the card,
  where it must stay within that bound.
* **benchmark-evidence invariants** — metrics of the latest
  ``BENCH_EVIDENCE.json`` record per pinned name.  Every record is
  validated against the evidence schema first
  (``utils.bench_evidence.validate_record``), and a malformed record
  FAILS the gate.

The port's budget is ``easyparallellibrary_tpu_torch/perf_budget.json``
(the repo root's is the JAX package's), generated with
``--write-budget --device cpu``; its ``bench`` list is empty until the
port writes records of its own.  Entry forms::

    {"version": 1,
     "cost_cards": {
       "<twin label>": {"<metric>": {"max": 1.0}            # <= bound
                        | {"min": 1.0}                      # >= bound
                        | {"max": ..., "min": ...}}},
     "bench": [
       {"metric": "<record name>", "path": "kill.orphans_after",
        "op": "<=", "target": 0}]}

Bounds are written pre-inflated (``--write-budget`` applies the
per-metric tolerances below), so the check is a plain comparison.  Exit
status: 0 clean, 1 on any violation, one ``path: got vs bound`` line
each.

Run: ``python -m easyparallellibrary_tpu_torch.observability.perfgate
[--device cpu]`` (``make perf-gate-torch``; ``make gate-torch`` runs
epl-lint over the port first).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from easyparallellibrary_tpu_torch.utils.logging import get_logger

_OPS = {
    "<=": lambda v, t: v <= t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    ">": lambda v, t: v > t,
    "==": lambda v, t: v == t,
}

# Tolerance applied per cost-card metric when GENERATING a budget from
# measured cards (--write-budget).  compile_count and donation_verified
# are exact: a second compile or a lost in-place write IS the regression.
_CARD_TOLERANCE = {
    "compile_count": 0.0,
    "donation_verified": 0.0,
    "flops_per_token": 0.10,
    "flops": 0.10,
    "kv_bytes_per_request": 0.10,
    "peak_hbm_bytes": 0.25,
}
# Metrics the generated budget pins per twin (when the card carries
# them); max-bounded except donation_verified, which is min-bounded.
_CARD_PINNED = ("compile_count", "flops_per_token", "flops",
                "kv_bytes_per_request", "peak_hbm_bytes")

_DEFAULT_BUDGET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "perf_budget.json")


def default_budget_path() -> str:
  return os.environ.get("EPL_TORCH_PERF_BUDGET", _DEFAULT_BUDGET)


def load_budget(path: Optional[str] = None) -> Dict[str, Any]:
  path = path or default_budget_path()
  with open(path, encoding="utf-8") as f:
    doc = json.load(f)
  if not isinstance(doc, dict):
    raise ValueError(f"perf budget {path!r} is not a JSON object")
  return doc


# ------------------------------------------------------ card collection


def collect_cards(twins: Tuple[str, ...] = ("plain", "guarded", "paged"),
                  device=None) -> Dict[str, Dict[str, float]]:
  """Cost cards of the reference twins on ``device`` (default the card;
  ``"cpu"`` to ask for the CPU): deterministic
  ``testing.factories.tiny_gpt`` engines, each serving one seeded
  request so the first step's capture fires.  Returns ``{twin label:
  flat metrics dict}``.  The geometry is the budget's reference
  program: a change here must regenerate the budget
  (``--write-budget``)."""
  import numpy as np
  import torch

  from easyparallellibrary_tpu_torch.observability import device as device_lib
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt

  previous = device_lib.get_introspector()
  intro = device_lib.install(device_lib.DeviceIntrospector())
  try:
    model, params = tiny_gpt(device=device)
    dev = next(iter(params.values())).device
    if dev.type == "cuda":
      # The BLAS library's workspace is the process's, allocated at its
      # first product: not a twin's step memory.
      w = torch.ones(8, 8, device=dev)
      torch.nn.functional.linear(w, w, w[0]) @ w
    variants = {
        "plain": dict(resilience=False, track_prefix="serving"),
        "guarded": dict(resilience=True,
                        track_prefix="serving/guarded"),
        "paged": dict(resilience=False, paged=True, block_size=8,
                      track_prefix="serving/paged"),
    }
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, 64, (5,)).astype(np.int32)
    for name in twins:
      eng = ContinuousBatchingEngine(model, params, device=device,
                                     num_slots=2, prefill_chunk=4,
                                     speculative=False, **variants[name])
      try:
        eng.submit(Request(uid=f"gate-{name}", prompt=prompt,
                           max_new_tokens=3))
        eng.run()
      finally:
        eng.close()
    return {label: card.metrics()
            for label, card in sorted(intro.cards.items())}
  finally:
    device_lib.install(previous)


# ------------------------------------------------------------ checking


def _check_bound(path: str, value: Any, bound: Dict[str, Any]
                 ) -> List[str]:
  if isinstance(value, bool):
    value = float(value)
  if not isinstance(value, (int, float)):
    return [f"{path}: measured value {value!r} is not numeric"]
  errs = []
  if "max" in bound and value > bound["max"]:
    errs.append(f"{path}: {value:g} exceeds budget max {bound['max']:g}")
  if "min" in bound and value < bound["min"]:
    errs.append(f"{path}: {value:g} below budget min {bound['min']:g}")
  return errs


def check_cost_cards(budget: Dict[str, Any],
                     cards: Dict[str, Dict[str, float]]) -> List[str]:
  """Violations of the budget's ``cost_cards`` section against measured
  cards.  A budgeted twin or metric that was NOT measured is a
  violation: a gate that cannot see a pinned number has not passed it."""
  errs: List[str] = []
  for label, pins in (budget.get("cost_cards") or {}).items():
    card = cards.get(label)
    if card is None:
      errs.append(f"cost_cards[{label}]: twin not captured "
                  f"(collection geometry changed?)")
      continue
    for metric, bound in pins.items():
      if metric not in card:
        errs.append(f"cost_cards[{label}].{metric}: metric missing "
                    f"from the captured card")
        continue
      errs.extend(_check_bound(f"cost_cards[{label}].{metric}",
                               card[metric], bound))
  return errs


def _resolve_path(record: Dict[str, Any], dotted: str) -> Any:
  cur: Any = record
  for part in dotted.split("."):
    if not isinstance(cur, dict) or part not in cur:
      return None
    cur = cur[part]
  return cur


def check_bench(budget: Dict[str, Any],
                evidence_path: Optional[str] = None) -> List[str]:
  """Violations of the budget's ``bench`` section against the latest
  evidence record per pinned metric.  EVERY record in the log is
  schema-validated first; malformed records are refused as violations,
  never skipped."""
  from easyparallellibrary_tpu_torch.utils import bench_evidence
  errs: List[str] = []
  records = bench_evidence.load_records(evidence_path)
  for i, rec in enumerate(records):
    for problem in bench_evidence.validate_record(rec):
      errs.append(
          f"bench evidence record #{i} "
          f"({rec.get('metric') if isinstance(rec, dict) else '?'}): "
          f"malformed — {problem}")
  by_name: Dict[str, Dict[str, Any]] = {}
  for rec in records:
    if not isinstance(rec, dict):
      continue
    name = rec.get("metric")
    prev = by_name.get(name)
    if prev is None or (rec.get("unix_time", 0)
                        > prev.get("unix_time", 0)):
      by_name[name] = rec
  for entry in budget.get("bench") or ():
    name, dotted = entry["metric"], entry["path"]
    op, target = entry.get("op", "<="), entry["target"]
    where = f"bench[{name}].{dotted}"
    rec = by_name.get(name)
    if rec is None:
      errs.append(f"{where}: no evidence record named {name!r}")
      continue
    value = _resolve_path(rec, dotted)
    if isinstance(value, bool):
      value = float(value)
    if not isinstance(value, (int, float)):
      errs.append(f"{where}: path missing or non-numeric "
                  f"(got {value!r})")
      continue
    if op not in _OPS:
      errs.append(f"{where}: unknown op {op!r}")
      continue
    if not _OPS[op](value, target):
      errs.append(f"{where}: {value:g} violates '{op} {target:g}'")
  return errs


def run_gate(budget_path: Optional[str] = None,
             evidence_path: Optional[str] = None,
             cards: Optional[Dict[str, Dict[str, float]]] = None,
             device=None) -> List[str]:
  """The whole gate: load the budget, collect (or accept) measured
  cards on ``device``, check both sections.  Returns every violation."""
  budget = load_budget(budget_path)
  errs: List[str] = []
  if budget.get("cost_cards"):
    if cards is None:
      cards = collect_cards(device=device)
    errs.extend(check_cost_cards(budget, cards))
  errs.extend(check_bench(budget, evidence_path))
  return errs


# ----------------------------------------------------------- generation


def generate_budget(cards: Dict[str, Dict[str, float]],
                    bench: Optional[List[Dict[str, Any]]] = None
                    ) -> Dict[str, Any]:
  """A budget document pinning ``cards`` with the standard tolerances
  (the ``--write-budget`` path).  ``bench`` defaults to no pins: the
  port has written no evidence record yet."""
  cost_cards: Dict[str, Any] = {}
  for label, metrics in sorted(cards.items()):
    pins: Dict[str, Any] = {}
    for metric in _CARD_PINNED:
      if metric not in metrics:
        continue
      tol = _CARD_TOLERANCE.get(metric, 0.25)
      bound = metrics[metric] * (1.0 + tol)
      pins[metric] = {"max": round(bound, 4)}
    if metrics.get("donation_verified") is not None:
      pins["donation_verified"] = {"min": metrics["donation_verified"]}
    cost_cards[label] = pins
  return {
      "version": 1,
      "comment": "Perf budget of the PyTorch port: cost-card + "
                 "bench-evidence invariants enforced by `make "
                 "perf-gate-torch` (observability/perfgate.py).  "
                 "Regenerate with --write-budget --device cpu ONLY when "
                 "a perf change is intentional, and say why in the PR.",
      "cost_cards": cost_cards,
      "bench": list(bench) if bench is not None else [],
  }


def main(argv: Optional[List[str]] = None) -> int:
  parser = argparse.ArgumentParser(
      prog="python -m easyparallellibrary_tpu_torch.observability.perfgate",
      description="Perf regression gate of the PyTorch port over the "
                  "serving cost cards and BENCH_EVIDENCE.json")
  parser.add_argument("--budget", default=None,
                      help="budget file (default: the port's "
                           "perf_budget.json)")
  parser.add_argument("--evidence", default=None,
                      help="evidence file (default: BENCH_EVIDENCE.json)")
  parser.add_argument("--device", default=None,
                      help="where the twins run (default: the GPU; "
                           "'cpu' to ask for the CPU)")
  parser.add_argument("--write-budget", action="store_true",
                      help="regenerate the budget from freshly "
                           "collected cards (tolerances applied) "
                           "instead of checking")
  args = parser.parse_args(argv)
  budget_path = args.budget or default_budget_path()
  if args.write_budget:
    cards = collect_cards(device=args.device)
    doc = generate_budget(cards)
    with open(budget_path, "w", encoding="utf-8") as f:
      json.dump(doc, f, indent=1, sort_keys=False)
      f.write("\n")
    print(f"perf budget written: {budget_path} "
          f"({len(doc['cost_cards'])} twin(s), "
          f"{len(doc['bench'])} bench pin(s))")
    return 0
  violations = run_gate(budget_path, args.evidence, device=args.device)
  if violations:
    print(f"perf-gate: {len(violations)} violation(s):")
    for v in violations:
      print(f"  FAIL {v}")
    return 1
  budget = load_budget(budget_path)
  print(f"perf-gate: OK ({len(budget.get('cost_cards') or {})} twin(s), "
        f"{len(budget.get('bench') or ())} bench pin(s))")
  return 0


if __name__ == "__main__":
  get_logger().setLevel("WARNING")
  sys.exit(main())
