from easyparallellibrary_tpu_torch.ir.taskgraph import Taskgraph
from easyparallellibrary_tpu_torch.ir.plan import ParallelPlan, current_plan

__all__ = ["Taskgraph", "ParallelPlan", "current_plan"]
