"""ParallelPlan — the lowered form of the recorded strategy scopes.

This is the analog of the *decision layer* of the reference's parallel
driver (`Parallel.do_parallelism`, epl/parallel/parallel.py:211-231): it
reads the taskgraphs recorded by `replicate`/`split` scopes plus the
`Config` and decides the mesh axis sizes — which in GSPMD replaces all of
the reference's graph cloning:

  * number of pipeline stages  ← count of distinct `replicate` scopes
    (or `pipeline.num_stages` for auto partitioning)
  * tensor-parallel width      ← max `split(device_count)`
  * sequence-parallel width    ← `sequence.axis_size`
  * data-parallel width        ← inferred from leftover devices by the
    cluster layout (reference epl/cluster.py:146-159)
"""

from __future__ import annotations

from typing import Dict, Optional

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.env import Env


class ParallelPlan:
  def __init__(self, taskgraphs, config, expert_parallel: int = 1):
    self.taskgraphs = list(taskgraphs)
    self.config = config
    self.expert_parallel = expert_parallel

  # -- derived sizes -------------------------------------------------------

  @property
  def replicate_taskgraphs(self):
    return [t for t in self.taskgraphs if t.kind == "replicate"]

  @property
  def split_taskgraphs(self):
    return [t for t in self.taskgraphs if t.kind == "split"]

  @property
  def num_stages(self) -> int:
    """Consecutive distinct replicate scopes = pipeline stages.

    With `auto.auto_parallel`, the configured `pipeline.num_stages` wins
    (reference epl/parallel/hooks.py:129-135).
    """
    if self.config.auto.auto_parallel and self.config.pipeline.num_stages > 1:
      return self.config.pipeline.num_stages
    n = len(self.replicate_taskgraphs)
    return max(n, 1)

  @property
  def model_parallel(self) -> int:
    counts = [t.num_device_per_replica for t in self.split_taskgraphs
              if t.strategy.device_count]
    if counts:
      return max(counts)
    if self.split_taskgraphs:
      # `split()` with no count means "the whole model axis": every device
      # left over after stage/seq/expert goes to tensor parallelism.
      cluster = Env.get().cluster
      if cluster is not None:
        fixed = self.num_stages * self.seq_parallel * self.expert_parallel
        return max(1, cluster.num_devices // fixed)
    return 1

  @property
  def seq_parallel(self) -> int:
    return max(1, self.config.sequence.axis_size) \
        if self.config.sequence.parallelism else 1

  @property
  def pipeline_enabled(self) -> bool:
    """Reference: Graph.pipeline_enabled (epl/ir/graph.py:918-923)."""
    return self.num_stages > 1

  @property
  def num_micro_batch(self) -> int:
    return self.config.pipeline.num_micro_batch

  def mesh_request(self) -> Dict[str, int]:
    """Axis sizes to request from the cluster layout (data inferred)."""
    return {
        constants.STAGE_AXIS: self.num_stages,
        constants.SEQ_AXIS: self.seq_parallel,
        constants.EXPERT_AXIS: self.expert_parallel,
        constants.MODEL_AXIS: self.model_parallel,
    }

  def build_mesh(self, cluster=None):
    cluster = cluster or Env.get().cluster
    if cluster is None:
      raise RuntimeError("epl.init() must run before building the mesh")
    return cluster.build_mesh(**self.mesh_request())

  def __repr__(self):
    return (f"ParallelPlan(stages={self.num_stages}, "
            f"model={self.model_parallel}, seq={self.seq_parallel}, "
            f"expert={self.expert_parallel}, "
            f"micro_batches={self.num_micro_batch})")

  def format(self) -> str:
    """Human-readable plan dump (reference: Graph.format,
    epl/ir/graph.py:587-598 and Taskgraph pretty-printer,
    ir/taskgraph.py:485-529)."""
    lines = [repr(self)]
    for tg in self.taskgraphs:
      strat = tg.strategy
      lines.append(
          f"  taskgraph[{tg.index}] kind={tg.kind} "
          f"devices/replica={tg.num_device_per_replica} "
          f"name={strat.name!r} site={strat.identity.split('|')[0]}")
    cluster = Env.get().cluster
    if cluster is not None and cluster.built_mesh is not None:
      lines.append("  mesh: " + ", ".join(
          f"{n}={s}" for n, s in cluster.built_mesh.shape.items()))
    cfg = self.config
    lines.append(
        f"  features: zero={cfg.zero.level or '-'} "
        f"gc={cfg.gradient_checkpoint.type or '-'} "
        f"amp={cfg.amp.level or '-'} offload={cfg.offload.level or '-'} "
        f"schedule={cfg.pipeline.strategy}")
    return "\n".join(lines)


def current_plan(expert_parallel: int = 1) -> ParallelPlan:
  """Lower the currently-recorded scopes into a plan."""
  env = Env.get()
  return ParallelPlan(env.strategy_context.taskgraphs, env.config,
                      expert_parallel=expert_parallel)
