"""The auto-parallel planner: stage search and the collective-matmul
crossover (port of ``easyparallellibrary_tpu/parallel/planner.py``).

:class:`AutoStageGenerator` searches the stage boundaries of an ordered
block list, as the reference's generator does with its three policies:
``balance_param`` (contiguous min-max by parameter count),
``balance_flops`` (by per-block FLOPs, when given) and
``repeated_layers`` (cut at the dominant repeated family's members).
Its cost-model search counts each block's FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, where the JAX package asks
XLA's cost analysis: the counter sees the matrix products (and
attention), not the elementwise work, which for blocks of one structure
gives the same partition.

The overlap half: the canonical overlap-site names, and the analytic
crossover that decides whether a collective next to a matrix product
runs as the fused collective or as the chunked ring of
``communicators/overlap.py`` (``communication.overlap = "auto"``).  The
cost-model twin (``plan_collective_matmul_from_cost``) stays with
ROADMAP.md Queue 1 item 12.

The model's constants are for this card, not measured by the port: the
link rate is NVLink's 450 GB/s each way (NVIDIA's H100 SXM data sheet),
the peak rate the card's bf16 tensor-core figure
(``profiler.flops.peak_flops_per_chip``), and the per-hop latency and
per-chunk cost are modelled.  A measured per-site byte count
(``observability.device.record_site_bytes``) replaces the analytic wire
bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from easyparallellibrary_tpu_torch.parallel.partitioner import (
    find_repeated_blocks, partition_stages)
from easyparallellibrary_tpu_torch.utils.pytree import tree_param_count


class AutoStageGenerator:
  """Search the stage assignment of an ordered block list (the
  reference's ``AutoStageGenerator``).  ``policy`` / ``num_stages``
  default to ``auto.stage_policy`` / ``pipeline.num_stages``."""

  def __init__(self, policy: Optional[str] = None,
               num_stages: Optional[int] = None):
    from easyparallellibrary_tpu_torch.env import Env
    cfg = Env.get().config
    self.policy = policy or cfg.auto.stage_policy
    self.num_stages = num_stages or cfg.pipeline.num_stages

  def search(self, block_names: Sequence[str],
             block_params: Optional[Dict[str, int]] = None,
             block_flops: Optional[Dict[str, float]] = None
             ) -> List[List[str]]:
    """``num_stages`` lists of block names, in order."""
    names = list(block_names)
    if self.num_stages <= 1:
      return [names]
    if self.policy == "balance_flops" and block_flops:
      return partition_stages(names, self.num_stages, block_flops)
    if self.policy == "repeated_layers":
      # The dominant family sets the cuts, at the positions of its
      # members in the whole list, so blocks between them stay with
      # their neighbours.
      family = max(find_repeated_blocks(names).values(), key=len)
      if len(family) >= self.num_stages:
        fam_stages = partition_stages(family, self.num_stages, block_params)
        cuts = [names.index(s[0]) for s in fam_stages]
        cuts[0] = 0
        cuts.append(len(names))
        return [names[cuts[s]:cuts[s + 1]] for s in range(self.num_stages)]
      from easyparallellibrary_tpu_torch.utils.logging import get_logger
      get_logger().warning(
          "repeated_layers policy found only %d repeated blocks for %d "
          "stages; falling back to balance_param", len(family),
          self.num_stages)
    return partition_stages(names, self.num_stages, block_params or {})

  def search_from_params(self, params_by_block: Dict[str, dict]
                         ) -> List[List[str]]:
    """Stage search weighted by each block's parameter count."""
    weights = {name: float(tree_param_count(tree))
               for name, tree in params_by_block.items()}
    return self.search(list(params_by_block), block_params=weights)

  def search_from_cost_model(self, apply_fns: Dict[str, Callable],
                             *sample_args) -> List[List[str]]:
    """Stage search weighted by each block's FLOPs on ``sample_args``,
    counted by ``FlopCounterMode`` (a block it counts no FLOPs for
    weighs 1), whatever the instance's policy."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = {}
    for name, fn in apply_fns.items():
      counter = FlopCounterMode(display=False)
      with counter:
        fn(*sample_args)
      flops[name] = float(counter.get_total_flops()) or 1.0
    if self.num_stages <= 1:
      return [list(apply_fns)]
    return partition_stages(list(apply_fns), self.num_stages, flops)

SITE_ROW_DENSE = "layers/row_dense"
SITE_GATHER_MATMUL = "distributed_ops/gather_matmul"
SITE_MATMUL_SCATTER = "distributed_ops/matmul_scatter"
SITE_ZERO1_REDUCE_SCATTER = "pipeline_smap/zero1_reduce_scatter"
OVERLAP_SITES = (SITE_ROW_DENSE, SITE_GATHER_MATMUL,
                 SITE_MATMUL_SCATTER, SITE_ZERO1_REDUCE_SCATTER)

DEFAULT_LINK_BYTES_PER_S = 450e9
DEFAULT_STEP_LATENCY_US = 2.0
DEFAULT_CHUNK_OVERHEAD_US = 1.0


@dataclasses.dataclass(frozen=True)
class OverlapDecision:
  """Outcome of the analytic collective-matmul crossover model."""
  enabled: bool
  num_chunks: int          # ring chunk count when enabled (1 otherwise)
  fused_us: float          # modeled serialized (fused) time
  overlapped_us: float     # modeled time at `num_chunks`
  comm_us: float           # wire time of the collective alone
  matmul_us: float         # matmul time alone


def _divisors_desc(n: int) -> List[int]:
  return [d for d in range(n, 1, -1) if n % d == 0]


def plan_collective_matmul(kind: str, *, m: int, k: int, n_out: int,
                           axis_size: int, dtype_bytes: int = 2,
                           num_chunks: int = 0,
                           peak_flops: Optional[float] = None,
                           link_bytes_per_s: float = DEFAULT_LINK_BYTES_PER_S,
                           step_latency_us: float = DEFAULT_STEP_LATENCY_US,
                           chunk_overhead_us: float =
                           DEFAULT_CHUNK_OVERHEAD_US,
                           measured_collective_bytes: Optional[float] =
                           None) -> OverlapDecision:
  """Analytic crossover for one decomposed collective-matmul site, the
  JAX model unchanged: ``T_fused = T_comm + T_mm`` against
  ``T_overlap(K) = max + min / K + (n - 1) * step_latency +
  K * chunk_overhead``; overlap is on iff the best divisor K of the axis
  size (or the pinned ``num_chunks``) beats the fused time.  Dims are
  per rank."""
  if kind not in ("all_gather_matmul", "matmul_reduce_scatter",
                  "reduce_scatter"):
    raise ValueError(f"unknown collective-matmul kind {kind!r}")
  n = axis_size
  if n <= 1:
    return OverlapDecision(False, 1, 0.0, 0.0, 0.0, 0.0)
  if peak_flops is None:
    from easyparallellibrary_tpu_torch.profiler.flops import _GUESS
    peak_flops = _GUESS
  if kind == "all_gather_matmul":
    wire_bytes = (n - 1) * m * k * dtype_bytes
    flops = 2.0 * (n * m) * k * n_out
  elif kind == "matmul_reduce_scatter":
    wire_bytes = (n - 1) * (m / n) * n_out * dtype_bytes
    flops = 2.0 * m * k * n_out
  else:  # reduce_scatter: the hidden work is the neighbours' adds
    wire_bytes = (n - 1) * (m / n) * k * dtype_bytes
    flops = float(m * k)
  if measured_collective_bytes is not None and measured_collective_bytes > 0:
    wire_bytes = float(measured_collective_bytes)
  comm_us = wire_bytes / link_bytes_per_s * 1e6
  matmul_us = flops / peak_flops * 1e6
  fused_us = comm_us + matmul_us
  if num_chunks > 1:
    ks = ([k_ for k_ in _divisors_desc(n) if k_ <= num_chunks] or [n])[:1]
  else:
    ks = _divisors_desc(n)
  best_k, best_t = 1, float("inf")
  for K in ks:
    t = (max(comm_us, matmul_us) + min(comm_us, matmul_us) / K
         + (n - 1) * step_latency_us + K * chunk_overhead_us)
    if t < best_t:
      best_k, best_t = K, t
  enabled = best_t < fused_us
  return OverlapDecision(enabled, best_k if enabled else 1,
                         fused_us, best_t, comm_us, matmul_us)
