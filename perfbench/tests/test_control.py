"""The comparison that decides ``correct`` fails what it must.

* The control: the float32 reference against itself with every linear
  layer in fp8 (the precision below the configurations' bf16) reads
  past at least one of the cell's limits.
* Each fault a one-chip training cell can have, planted under the timed
  path of a whole run (everything but the look for a card): a step that
  returns its state unchanged, and half the batch left out with the
  mean over the rest, turn ``correct`` false; the same run without a
  fault keeps it true.  (No exchange between chips exists on one chip,
  and a training step produces no token to alter.)
"""

import importlib

import pytest
import torch

import tiny
from perfbench import check, run


def unchanged(step):
  def wrapped(state, batch, rng):
    kept = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = step(state, batch, rng)
    with torch.no_grad():
      for n, p in state.params.items():
        p.copy_(kept[n])
    state.opt_state.state.clear()
    return state, metrics
  return wrapped


def half_batch(step):
  def wrapped(state, batch, rng):
    rows = next(iter(batch.values())).shape[0] // 2
    return step(state, {k: v[:rows] for k, v in batch.items()}, rng)
  return wrapped


@pytest.mark.parametrize("cell", ["gpt3-medium.train.s1024",
                                  "bert-large.train.s512",
                                  "gpt3-medium.train.s2048",
                                  "bert-large.train.s128"])
def test_the_fp8_control_reads_past_a_limit(cell):
  config, mix, _ = tiny.spec(cell)
  fam = importlib.import_module(f"perfbench.families.{config['family']}")
  prog = fam.build(config, tiny.CPU)
  _, _, _, pool, shapes = run.program_readings(prog, fam, config, mix, 23,
                                               tiny.CPU)
  ref = run.reference_readings(fam, config, mix, 23, tiny.CPU, pool, shapes)
  control = run.reference_readings(fam, config, mix, 23, tiny.CPU, pool,
                                   shapes, precision="fp8")
  numbers = check.compare(control, ref)
  assert not check.verdict(numbers, run.cell_spec(cell)[0]["limits"]), numbers


@pytest.mark.parametrize("fault", [None, unchanged, half_batch],
                         ids=["sound", "unchanged", "half_batch"])
@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_a_planted_fault_turns_correct_false(cell, fault):
  result = run.run_cell(cell, 41, 0.2, False, tiny.CPU, tiny.CARD,
                        overrides=tiny.OVERRIDES[tiny.CELLS[cell]],
                        step_fault=fault)
  assert result["correct"] is (fault is None), result["checks"]
