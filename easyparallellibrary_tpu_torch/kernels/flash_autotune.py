"""Flash-attention block autotune on the card: the port's counterpart of
``benchmarks/flash_autotune.py``, a tool that writes the kernels' block
table.

    python -m easyparallellibrary_tpu_torch.kernels.flash_autotune
    python -m easyparallellibrary_tpu_torch.kernels.flash_autotune \\
        --shapes 1024:64,8192:128

For each ``(S, D)`` of ``SWEEP`` (the JAX sweep's shapes: S 1024-32768 at
D 64 and 2048-8192 at D 128, the batch halving as S doubles, 16 heads,
bf16) it times the causal forward and backward (the three kernels, and
``delta = rowsum(dO * O)`` between them as the autograd backward forms
it) of every candidate: a block-table ``want`` of 32, 64 or 128 (each
kernel's largest tile <= it, ``flash_attention.tile_for_want``) at TMA
ring depth 2 or 3.  Each candidate, and SDPA's forward and backward on
the same inputs (the yardstick; the port never calls it), is timed with
CUDA events in ABBA rounds inside the one process after a warm-up (the
calls of a sample queued behind a device sleep), and
each kernel's builds are also timed alone.  Into
``flash_block_table.json`` (beside ``flash_attention.py``) go only the
winners that beat the default build by more than 3% (the JAX sweep's
rule), under this card's name; that card's entries for shapes not swept
are kept, every swept shape is decided anew.  Prints one JSON line per
shape and a summary line.

Without a card it raises (the JAX sweep exits 0 off the TPU): there are
no kernels to tune on a CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from easyparallellibrary_tpu_torch.kernels import flash_attention as fa

# (S, D, batch, heads): the JAX sweep's shapes.
SWEEP = [
    (1024, 64, 8, 16),
    (2048, 64, 8, 16),
    (4096, 64, 8, 16),
    (8192, 64, 4, 16),
    (16384, 64, 2, 16),
    (32768, 64, 1, 16),
    (2048, 128, 4, 16),
    (4096, 128, 2, 16),
    (8192, 128, 1, 16),
]
WANTS = (32, 64, 128)
STAGES = (2, 3)
DEFAULT = fa.DEFAULT_BUILD  # the candidate (want, stages) of the default
MIN_GAIN = 1.03
KERNELS = ("fwd", "dkv", "dq")
ROUNDS, REPS = 4, 5
SLEEP_CYCLES = 50_000_000  # ~30 ms of the card's clock: the launches queue


def _label(pair) -> str:
  return f"{pair[0]}x{pair[1]}"


def _inputs(B, H, S, D, seed):
  g = torch.Generator(device="cuda").manual_seed(seed)
  return [torch.randn(B, H, S, D, device="cuda", generator=g,
                      dtype=torch.float32).to(torch.bfloat16)
          for _ in range(4)]


def _events_ms(fn, reps: int) -> float:
  """Device ms of one call: CUDA events around ``reps`` calls, queued
  behind a device sleep so that the host's launch time stays out."""
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda._sleep(SLEEP_CYCLES)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def _abba(fns: Dict[str, callable]) -> Dict[str, float]:
  """Median ms of each callable over ``ROUNDS`` rounds of ``REPS`` calls,
  the order reversed every other round; one warm-up call each first."""
  for fn in fns.values():
    fn()
  torch.cuda.synchronize()
  samples = {name: [] for name in fns}
  names = list(fns)
  for r in range(ROUNDS):
    for name in (names if r % 2 == 0 else names[::-1]):
      samples[name].append(_events_ms(fns[name], REPS))
  return {name: statistics.median(v) for name, v in samples.items()}


def candidate_builds(D: int, want: int, stages: int):
  """The three kernels' ``(tile, stages)`` builds a candidate names."""
  return {k: fa.tile_for_want(k, D, torch.bfloat16, want, stages)
          for k in KERNELS}


def sweep_shape(S: int, D: int, B: int, H: int, seed: int = 0) -> dict:
  """One shape's row: each candidate's causal forward + backward ms,
  each kernel's builds alone, SDPA's forward + backward, the winner."""
  q, k, v, dout = _inputs(B, H, S, D, seed)
  out, lse = fa.flash_fwd_cuda(q, k, v, True, build=fa.DEFAULT_BUILD)
  delta = (dout.float() * out.float()).sum(-1)

  def chain(b):
    def run():
      o, l = fa.flash_fwd_cuda(q, k, v, True, build=b["fwd"])
      d = (dout.float() * o.float()).sum(-1)
      fa.flash_bwd_dkv_cuda(q, k, v, dout, l, d, True, build=b["dkv"])
      fa.flash_bwd_dq_cuda(q, k, v, dout, l, d, True, build=b["dq"])
    return run

  sdpa = torch.nn.functional.scaled_dot_product_attention
  leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

  def library():
    o = sdpa(*leaves, is_causal=True)
    torch.autograd.grad(o, leaves, dout)

  candidates = {(w, s): candidate_builds(D, w, s)
                for w in WANTS for s in STAGES}
  fns = {_label(c): chain(b) for c, b in candidates.items()}
  fns["sdpa"] = library
  times = _abba(fns)
  sdpa_ms = times.pop("sdpa")

  alone = {}
  for kernel in KERNELS:
    builds = sorted({b[kernel] for b in candidates.values()})
    if kernel == "fwd":
      make = lambda b: lambda: fa.flash_fwd_cuda(q, k, v, True, build=b)  # noqa: E731
    elif kernel == "dkv":
      make = lambda b: lambda: fa.flash_bwd_dkv_cuda(  # noqa: E731
          q, k, v, dout, lse, delta, True, build=b)
    else:
      make = lambda b: lambda: fa.flash_bwd_dq_cuda(  # noqa: E731
          q, k, v, dout, lse, delta, True, build=b)
    alone[kernel] = _abba({_label(b): make(b) for b in builds})

  best = min(times, key=times.get)
  default = _label(DEFAULT)
  return {"S": S, "D": D, "batch": B, "heads": H,
          "times_ms": times, "sdpa_ms": sdpa_ms,
          "builds": {_label(c): {k: _label(b[k]) for k in KERNELS}
                     for c, b in candidates.items()},
          "kernel_ms": alone, "default": default, "best": best,
          "gain_vs_default": times[default] / times[best]}


def sweep(shapes: Sequence[Tuple[int, int, int, int]]) -> List[dict]:
  """Rows of ``sweep_shape`` over ``(S, D, batch, heads)`` shapes, each
  printed as one JSON line."""
  if not torch.cuda.is_available():
    raise RuntimeError("flash_autotune times the CUDA kernels: it needs a "
                       "card (torch.cuda.is_available() is false)")
  torch.backends.cuda.matmul.allow_tf32 = False
  rows = []
  for seed, (S, D, B, H) in enumerate(shapes):
    row = sweep_shape(S, D, B, H, seed)
    print(json.dumps(row), flush=True)
    rows.append(row)
    torch.cuda.empty_cache()
  return rows


def table_entries(rows: Sequence[dict]) -> Dict[str, dict]:
  """The block-table entries the rows earn: a shape whose best candidate
  is not the default's and beats it by more than ``MIN_GAIN``."""
  entries = {}
  for row in rows:
    if row["best"] != row["default"] and row["gain_vs_default"] > MIN_GAIN:
      want, stages = (int(x) for x in row["best"].split("x"))
      entries[f"{row['S']}:{row['D']}:2"] = {"want": want, "stages": stages}
  return entries


def write_table(rows: Sequence[dict], path: str = fa._BLOCK_TABLE_PATH,
                device: Optional[str] = None) -> dict:
  """Merges the rows' entries into the table at ``path`` for ``device``
  (default: this card): that card's entries for shapes not in ``rows``
  stay, every swept shape is decided anew.  Returns the summary."""
  device = device or torch.cuda.get_device_name()
  swept = {f"{row['S']}:{row['D']}:2" for row in rows}
  kept = {}
  try:
    with open(path) as f:
      raw = json.load(f)
    if raw.get("device") == device and isinstance(raw.get("entries"), dict):
      kept = {key: value for key, value in raw["entries"].items()
              if key not in swept}
  except (OSError, ValueError, AttributeError):
    pass
  new = table_entries(rows)
  with open(path, "w") as f:
    json.dump({"device": device, "entries": {**kept, **new}}, f, indent=1,
              sort_keys=True)
    f.write("\n")
  return {"metric": "flash_autotune", "value": len(new),
          "unit": "tuned_entries",
          "detail": {"new_entries": new, "kept_entries": kept,
                     "table_path": path, "device": device,
                     "rows": len(rows)}}


def _shapes(spec: Optional[str]):
  if not spec:
    return SWEEP
  by_key = {(S, D): (S, D, B, H) for S, D, B, H in SWEEP}
  picked = []
  for item in spec.split(","):
    key = tuple(int(x) for x in item.split(":"))
    if key not in by_key:
      raise ValueError(f"--shapes: {item} is not a shape of the sweep "
                       f"({sorted(by_key)})")
    picked.append(by_key[key])
  return picked


def main(argv: Optional[Sequence[str]] = None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--shapes", default=None,
                      help="S:D,... of the sweep to time (default: all)")
  args = parser.parse_args(argv)
  rows = sweep(_shapes(args.shapes))
  print(json.dumps(write_table(rows)), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
