from easyparallellibrary_tpu_torch.strategies.base import ParallelStrategy
from easyparallellibrary_tpu_torch.strategies.context import StrategyContext
from easyparallellibrary_tpu_torch.strategies.replicate import Replicate, replicate
from easyparallellibrary_tpu_torch.strategies.split import Split, split

__all__ = [
    "ParallelStrategy", "StrategyContext", "Replicate", "replicate",
    "Split", "split",
]
