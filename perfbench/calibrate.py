"""The readings that the limits of ``correct`` are set from, for one
cell, on the card, in one process (the kernel library loads once):

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--controls 3]

For every seed, the program's three checked steps against the float32
reference (the lower readings).  For the first ``--controls`` seeds
also the control, the reference with its linear layers in fp8, and two
faults planted in the reference: half the batch left out (the mean over
the other half), and a step that returns its state unchanged (a rate of
0: its ``change_gap`` reads 1, its ``loss_gap`` is the reference's own
fall in loss); each against the float32 reference (the upper readings).
Each reading is judged as a run is, by ``check.verdict`` against the
cell's limits (``correct``): the program's must come out true, every
control's and fault's false.  Prints a JSON line a reading, with the
reference's losses, and a summary line last.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys

from perfbench import check, run


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seeds", required=True)
  parser.add_argument("--controls", type=int, default=3)
  args = parser.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print("calibrate: no CUDA device", file=sys.stderr)
    return 2
  device = torch.device("cuda", 0)
  cell, config, mix = run.cell_spec(args.workload)
  limits = cell.get("limits", {})
  fam = importlib.import_module(f"perfbench.families.{config['family']}")
  prog = fam.build(config, device)
  readings = {"program": [], "control": [], "half_batch": [], "unchanged": []}
  for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
    program, state, _, pool, shapes = run.program_readings(
        prog, fam, config, mix, seed, device)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ref = run.reference_readings(fam, config, mix, seed, device, pool,
                                 shapes)
    rows = {"program": check.compare(program, ref)}
    if i < args.controls:
      rows["control"] = check.compare(run.reference_readings(
          fam, config, mix, seed, device, pool, shapes, precision="fp8"), ref)
      rows["half_batch"] = check.compare(run.reference_readings(
          fam, config, mix, seed, device, pool, shapes,
          rows=mix["batch"] // 2), ref)
      frozen = {**config, "optimizer": {**config["optimizer"],
                                        "learning_rate": 0.0}}
      rows["unchanged"] = check.compare(run.reference_readings(
          fam, frozen, mix, seed, device, pool, shapes), ref)
    for kind, numbers in rows.items():
      readings[kind].append(numbers)
      print(json.dumps({"seed": seed, "kind": kind, **numbers,
                        "correct": check.verdict(numbers, limits),
                        "reference_losses": ref.losses}), flush=True)
  verdicts = {kind: [check.verdict(r, limits) for r in rows]
              for kind, rows in readings.items() if rows}
  summary = {"workload": args.workload, "limits": limits,
             "program_all_correct": all(verdicts["program"]),
             "faults_all_incorrect": not any(
                 v for kind, vs in verdicts.items() if kind != "program"
                 for v in vs)}
  for kind, pick in (("program", max), ("control", min),
                     ("half_batch", min), ("unchanged", min)):
    if readings[kind]:
      summary[kind] = {k: pick(r[k] for r in readings[kind])
                       for k in check.NUMBERS}
  print(json.dumps(summary), flush=True)
  return 0 if summary["program_all_correct"] and \
      summary["faults_all_incorrect"] else 1


if __name__ == "__main__":
  sys.exit(main())
