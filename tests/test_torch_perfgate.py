"""The port's perf gate (``observability/perfgate.py``) against the JAX
package's: the checks and the budget generator return exactly what
JAX's return on the same dicts; the port's own budget
(``easyparallellibrary_tpu_torch/perf_budget.json``) passes on the CPU
twins, was generated from them, and a planted regression — doubled
flops, a second compile, a malformed evidence record — fails the gate
with exit 1, as ``tests/test_observability_device.py`` holds JAX's.
"""

import copy
import json
import os

import pytest
import torch

import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu.observability import perfgate as jgate
from easyparallellibrary_tpu_torch.observability import perfgate as tgate

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(REPO, "BENCH_EVIDENCE.json")


@pytest.fixture(scope="module")
def cards():
  """The reference twins' cards on the CPU (three tiny engines)."""
  out = tgate.collect_cards(device="cpu")
  tepl.Env.get().reset()
  return out


def _evidence(tmp_path, records):
  path = tmp_path / "ev.json"
  path.write_text(json.dumps({"records": records}))
  return str(path)


def test_the_port_budget_is_its_own_and_generated_from_the_cpu_twins(cards):
  assert tgate.default_budget_path() == os.path.join(
      REPO, "easyparallellibrary_tpu_torch", "perf_budget.json")
  budget = tgate.load_budget()
  assert budget == tgate.generate_budget(cards)
  assert sorted(budget["cost_cards"]) == [
      "serving/fused_step", "serving/guarded/fused_step",
      "serving/paged/fused_step"]
  assert budget["bench"] == []
  for label, card in cards.items():
    assert card["compile_count"] == 1.0, label
    assert card["donation_verified"] == 1.0, label


def test_the_gate_passes_on_the_port_budget(cards):
  assert tgate.run_gate(evidence_path=EVIDENCE, cards=cards) == []
  assert tgate.check_bench(tgate.load_budget(), EVIDENCE) == []


def test_checks_and_generator_return_what_jax_returns(cards, tmp_path):
  """Every check on the same budget, cards and evidence, against JAX's:
  the port's budget and JAX's, clean and tampered cards, the JAX bench
  pins over a corpus with a malformed and a regressed record."""
  budgets = [tgate.load_budget(), jgate.load_budget()]
  worse = copy.deepcopy(cards)
  for card in worse.values():
    card["flops"] *= 2
    card["compile_count"] = 2.0
    card["donation_verified"] = 0.0
  missing = {k: v for k, v in cards.items() if k != "serving/fused_step"}
  for budget in budgets:
    for measured in (cards, worse, missing, {}):
      assert tgate.check_cost_cards(budget, measured) == \
          jgate.check_cost_cards(budget, measured)
  path = _evidence(tmp_path, [
      {"metric": "observability_overhead", "unix_time": 5.0,
       "recompiles_flagged": 1, "within_5pct": True},
      {"metric": "router_failover_process", "unix_time": 4.0,
       "kill": {"orphans_after": 0, "kills": 2}},
      {"metric": "", "unix_time": "x"},
      "not a record"])
  for budget in budgets + [jgate.generate_budget(cards)]:
    for evidence in (path, EVIDENCE, str(tmp_path / "absent.json")):
      assert tgate.check_bench(budget, evidence) == \
          jgate.check_bench(budget, evidence)
  for bench in ([], jgate._DEFAULT_BENCH_PINS):
    got, want = (tgate.generate_budget(cards, bench),
                 jgate.generate_budget(cards, bench))
    assert {k: v for k, v in got.items() if k != "comment"} == \
        {k: v for k, v in want.items() if k != "comment"}
  assert tgate._resolve_path({"a": {"b": 3}}, "a.b") == \
      jgate._resolve_path({"a": {"b": 3}}, "a.b") == 3


def test_planted_regressions_fail_the_gate_with_exit_1(cards, tmp_path,
                                                       monkeypatch,
                                                       capsys):
  """Doubled flops and a second compile bust their pins; a malformed
  evidence record is refused; each through ``main`` exits 1."""
  monkeypatch.setattr(tgate, "collect_cards", lambda device=None: cards)
  assert tgate.main(["--device", "cpu", "--evidence", EVIDENCE]) == 0
  assert "perf-gate: OK (3 twin(s), 0 bench pin(s))" in \
      capsys.readouterr().out
  doubled = {k: dict(v, flops=2 * v["flops"]) for k, v in cards.items()}
  errs = tgate.run_gate(evidence_path=EVIDENCE, cards=doubled)
  assert len(errs) == 3 and all("].flops:" in e and "exceeds" in e
                                for e in errs)
  recompiled = copy.deepcopy(cards)
  recompiled["serving/paged/fused_step"]["compile_count"] = 2.0
  errs = tgate.run_gate(evidence_path=EVIDENCE, cards=recompiled)
  assert errs == ["cost_cards[serving/paged/fused_step].compile_count: 2 "
                  "exceeds budget max 1"]
  for planted in (doubled, recompiled):
    monkeypatch.setattr(tgate, "collect_cards",
                        lambda device=None, c=planted: c)
    assert tgate.main(["--device", "cpu", "--evidence", EVIDENCE]) == 1
  monkeypatch.setattr(tgate, "collect_cards", lambda device=None: cards)
  bad = _evidence(tmp_path, [{"metric": "m", "value": 1.0, "unix_time": 1.0},
                             {"metric": "", "unix_time": "x"}])
  assert tgate.main(["--device", "cpu", "--evidence", bad]) == 1
  out = capsys.readouterr().out
  assert "FAIL bench evidence record #1 (): malformed" in out


def test_write_budget_writes_what_the_gate_then_passes(cards, tmp_path,
                                                       monkeypatch):
  monkeypatch.setattr(tgate, "collect_cards", lambda device=None: cards)
  path = str(tmp_path / "budget.json")
  assert tgate.main(["--write-budget", "--budget", path, "--device",
                     "cpu"]) == 0
  assert tgate.load_budget(path) == tgate.load_budget()
  assert tgate.main(["--budget", path, "--device", "cpu", "--evidence",
                     EVIDENCE]) == 0
