"""The train step of the PyTorch port: one process per rank, the
gradient collectives written out (``api``), explicit data parallelism
(``explicit``) and the overlap planner (``planner``)."""

from easyparallellibrary_tpu_torch.parallel.api import (
    MutableTrainState, TrainState, create_sharded_train_state, local_batch,
    make_mutable_train_step, make_train_step, param_specs, parallelize,
    state_shardings)
from easyparallellibrary_tpu_torch.parallel.explicit import (
    make_explicit_dp_train_step)
from easyparallellibrary_tpu_torch.parallel.metrics import (
    merge_shard_metrics)

__all__ = ["MutableTrainState", "make_mutable_train_step", "TrainState", "create_sharded_train_state", "local_batch",
           "make_train_step", "param_specs", "parallelize",
           "state_shardings", "make_explicit_dp_train_step",
           "merge_shard_metrics"]
