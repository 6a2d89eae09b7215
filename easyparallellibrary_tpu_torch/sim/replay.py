"""Golden-episode replay (port of ``easyparallellibrary_tpu/sim/
replay.py``): run a recorded real-fleet chaos episode through the
simulator and return the simulated actuation sequence.

The fidelity contract: a chaos-heal episode recorded from the REAL
fleet — overload burst, breach, autotune escalation, scale-up,
recovery, drain-back — replayed in the simulator must produce the SAME
actuation sequence: same actuators, same knob transitions, same order.
The golden file (``tests/golden/sim_chaos_heal.json``, read only) was
recorded by the JAX package from a real two-replica fleet on a
fixed-dt virtual clock; this module replays it sim-side, and
``chip_smoke.py`` drives the port's real fleet on the card through the
same episode.

What makes equality achievable rather than aspirational: both sides
run the identical policy objects over the identical per-step record
schema, the episode clock is virtual and fixed-dt on BOTH sides, and
with ``itl_slo_s = 0`` every actuation signal is count- or
clock-driven (sim/replica.py module docstring) — so the only degrees
of freedom left are the ones the golden file pins (config knobs,
arrival times, request shapes, dt).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

import easyparallellibrary_tpu_torch as epl
from easyparallellibrary_tpu_torch.observability import slo as slo_lib
from easyparallellibrary_tpu_torch.sim.arrivals import Workload
from easyparallellibrary_tpu_torch.sim.fleet import (
    SimFleet, actuation_sequence, warm_fleet)

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "tests", "golden", "sim_chaos_heal.json")


def load_golden(path: str = GOLDEN_PATH) -> Dict[str, Any]:
  with open(path) as f:
    return json.load(f)


def replay(golden: Dict[str, Any]) -> Dict[str, Any]:
  """Replay ``golden`` in the simulator; returns the episode summary
  plus ``sequence`` (the simulated actuation sequence, normalized the
  same way the recorder normalized the real one).

  Resets the ambient SLO monitor: a replay is a fresh episode and its
  breach/actuation log must start empty.  The simulator does no device
  work, so the framework is initialised on the CPU.
  """
  slo_lib.reset()
  config = epl.Config(golden["config"])
  epl.init(config, device="cpu")
  prompt = np.asarray(golden["prompt"], dtype=np.int32)
  fleet = SimFleet(
      num_replicas=int(golden["num_replicas"]), config=config,
      num_slots=int(golden["num_slots"]),
      prefill_chunk=int(golden["chunk"]),
      max_seq_len=int(golden["max_seq_len"]))
  # Warm phase, exactly as recorded: the real fleet warmed its steps
  # outside the timed episode; the recorded step/record counts include
  # those steps, so the replay performs the same submits and drain
  # (the point is record-stream parity, not the warm-up itself).
  warm_fleet(fleet.router, fleet.clock, prompt,
             int(golden["warm_max_new"]))
  n = len(golden["arrivals"])
  workload = Workload(
      times=[float(t) for t in golden["arrivals"]],
      prompts=[prompt] * n,
      max_new=[int(golden["max_new"])] * n)
  summary = fleet.run(
      workload, fixed_dt=float(golden["fixed_dt"]),
      idle_dt=float(golden["idle_dt"]),
      settle_steps=int(golden["settle_steps"]))
  summary["sequence"] = actuation_sequence()
  monitor = slo_lib.get_monitor()
  summary["breaches"] = monitor.breaches if monitor else 0
  summary["recoveries"] = monitor.recoveries if monitor else 0
  return summary
