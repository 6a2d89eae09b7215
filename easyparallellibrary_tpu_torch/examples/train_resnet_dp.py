"""ResNet data-parallel training with an optionally split classifier head
(port of ``examples/train_resnet_dp.py``).

  python -m easyparallellibrary_tpu_torch.examples.train_resnet_dp
  python -m easyparallellibrary_tpu_torch.examples.train_resnet_dp \\
      --split-head 2                      # the head over 2 ranks
  python -m easyparallellibrary_tpu_torch.examples.train_resnet_dp --dp 2

The JAX script fills the data axis with every device of its host; the
port runs one process a rank, so ``--dp`` says how many data ranks to
start (the example starts ``split_head x dp`` ranks itself, or joins a
launcher's group).  ``--stage-sizes``, ``--filters`` and
``--image-size`` shrink the network and the images (default ResNet-50
on 64 x 64 images, as the JAX script).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def _parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      prog="python -m easyparallellibrary_tpu_torch.examples.train_resnet_dp")
  p.add_argument("--split-head", type=int, default=0,
                 help="shard the classifier over N ranks")
  p.add_argument("--dp", type=int, default=1, help="data-parallel ranks")
  p.add_argument("--classes", type=int, default=1000)
  p.add_argument("--batch", type=int, default=32)
  p.add_argument("--steps", type=int, default=10)
  p.add_argument("--stage-sizes", default="3,4,6,3")
  p.add_argument("--filters", type=int, default=64)
  p.add_argument("--image-size", type=int, default=64)
  p.add_argument("--device", default=None,
                 help="default: the GPU; 'cpu' to ask for the CPU")
  p.add_argument("--backend", default=None)
  return p


def _world(args) -> int:
  return max(1, args.split_head) * max(1, args.dp)


def _rank_main(argv: List[str]):
  import torch

  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch import ops
  from easyparallellibrary_tpu_torch.examples._ranks import is_leader
  from easyparallellibrary_tpu_torch.models.resnet import (
      ResNet, ResNetConfig)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel import (
      TrainState, create_sharded_train_state, make_train_step, parallelize)
  from easyparallellibrary_tpu_torch.weights import (
      init_params, local_params)

  args = _parser().parse_args(argv)
  env = epl.init(device=args.device, backend=args.backend)
  split = args.split_head > 1
  if split:
    with epl.split(args.split_head):
      pass
  mesh = epl.current_plan().build_mesh()
  if is_leader():
    print("mesh:", dict(mesh.shape))

  gpu = env.cluster.devices[0].type == "cuda"
  cfg = ResNetConfig(
      stage_sizes=tuple(int(s) for s in args.stage_sizes.split(",")),
      num_filters=args.filters, num_classes=args.classes,
      dtype=torch.bfloat16 if gpu else torch.float32)
  if split:
    with epl.split(args.split_head):
      model = ResNet(cfg)
  else:
    model = ResNet(cfg)
  local = local_params(model, init_params(cfg, 0, device=mesh.device), mesh)
  r = np.random.RandomState(0)
  x = r.randn(args.batch, args.image_size, args.image_size,
              3).astype(np.float32)
  y = r.randint(0, args.classes, (args.batch,))

  def loss_fn(params, batch, rng):
    del rng
    logits = torch.func.functional_call(
        model, params, (batch["x"],),
        {"gather_logits": False} if split else {})
    loss = ops.distributed_sparse_softmax_cross_entropy_with_logits(
        batch["y"].long(), logits, vocab_size=args.classes)
    preds = ops.distributed_argmax(logits, vocab_size=args.classes)
    acc = ops.distributed_equal(preds, batch["y"]).float().mean()
    return loss.mean(), {"accuracy": acc}

  # optax.adam(1e-3): AdamW without decay.
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(1e-3, weight_decay=0.0)), mesh)
  step = parallelize(make_train_step(loss_fn), mesh, shardings)
  losses, accs = [], []
  for i in range(args.steps):
    state, m = step(state, {"x": x, "y": y}, None)
    losses.append(float(m["loss"]))
    accs.append(float(m["accuracy"]))
    if is_leader():
      print(f"step {i}: loss {losses[-1]:.4f} acc {accs[-1]:.3f}")
  return {"losses": losses, "accuracy": accs, "mesh": dict(mesh.shape)}


def main(argv: Optional[List[str]] = None):
  import sys

  from easyparallellibrary_tpu_torch.examples import _ranks
  from easyparallellibrary_tpu_torch.examples import train_resnet_dp as this
  argv = list(sys.argv[1:] if argv is None else argv)
  return _ranks.run(this._rank_main, argv, _world(_parser().parse_args(argv)))


if __name__ == "__main__":
  main()
