"""The train step of the PyTorch port."""

from easyparallellibrary_tpu_torch.parallel.api import (
    TrainState, create_sharded_train_state, make_train_step, parallelize)

__all__ = ["TrainState", "create_sharded_train_state", "make_train_step",
           "parallelize"]
