"""The system under test, built through the port's public API as its
users build a data-parallel training job on one card:

    epl.init -> with epl.replicate(1): model -> build_mesh ->
    create_sharded_train_state -> parallelize(train step)

with the configuration's AdamW.  A family supplies the model and its
train step; nothing here reads the port's internals.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


class Program:
  """One model and its parallelized train step; :meth:`state` makes a
  fresh train state from given weights (the step is built with the
  first state's shardings and kept)."""

  def __init__(self, make_model: Callable, make_step: Callable,
               optimizer: dict, device):
    import easyparallellibrary_tpu_torch as epl
    from easyparallellibrary_tpu_torch.ops.adamw import adamw
    epl.init(device=device)
    with epl.replicate(1):
      self.model = make_model()
    self.mesh = epl.current_plan().build_mesh()
    self.tx = adamw(optimizer["learning_rate"], b1=optimizer["b1"],
                    b2=optimizer["b2"], eps=optimizer["eps"],
                    weight_decay=optimizer["weight_decay"])
    self._make_step = make_step
    self.step = None

  def shapes(self) -> Dict[str, tuple]:
    """The model's parameters, name -> shape, in its order."""
    return {n: tuple(p.shape) for n, p in self.model.named_parameters()}

  def state(self, params: Dict[str, torch.Tensor]):
    from easyparallellibrary_tpu_torch.parallel import (
        TrainState, create_sharded_train_state, parallelize)
    state, shardings = create_sharded_train_state(
        lambda: TrainState.create(apply_fn=self.model, params=params,
                                  tx=self.tx), self.mesh)
    if self.step is None:
      self.step = parallelize(self._make_step(self.model), self.mesh,
                              shardings)
    return state
