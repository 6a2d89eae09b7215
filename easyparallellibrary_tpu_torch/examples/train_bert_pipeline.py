"""BERT 2-stage pipeline pretraining (port of
``examples/train_bert_pipeline.py``: BERT under two replicate scopes with
``num_micro_batch=4``).

  python -m easyparallellibrary_tpu_torch.examples.train_bert_pipeline

One rank a stage: the example starts ``--stages`` ranks itself (or joins
a launcher's group).  ``--device cpu`` runs on the CPU over gloo;
``--backend gloo`` puts several ranks on one card.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def _parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      prog="python -m easyparallellibrary_tpu_torch.examples."
           "train_bert_pipeline")
  p.add_argument("--stages", type=int, default=2)
  p.add_argument("--micro", type=int, default=4)
  p.add_argument("--layers", type=int, default=4)
  p.add_argument("--d-model", type=int, default=256)
  p.add_argument("--heads", type=int, default=8)
  p.add_argument("--vocab", type=int, default=8192)
  p.add_argument("--seq-len", type=int, default=128)
  p.add_argument("--batch", type=int, default=16)
  p.add_argument("--steps", type=int, default=10)
  p.add_argument("--device", default=None,
                 help="default: the GPU; 'cpu' to ask for the CPU")
  p.add_argument("--backend", default=None)
  return p


def _rank_main(argv: List[str]):
  import torch

  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.examples._ranks import is_leader
  from easyparallellibrary_tpu_torch.models.bert import (
      Bert, BertConfig, make_bert_train_step)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.weights import (
      init_params, local_params, stack_stages)

  args = _parser().parse_args(argv)
  env = epl.init(epl.Config({"pipeline.num_micro_batch": args.micro}),
                 device=args.device, backend=args.backend)
  for i in range(args.stages):
    with epl.replicate(1, name=f"stage{i}"):
      pass
  mesh = epl.current_plan().build_mesh()
  if is_leader():
    print("mesh:", dict(mesh.shape))

  gpu = env.cluster.devices[0].type == "cuda"
  flat = dict(vocab_size=args.vocab, num_layers=args.layers,
              num_heads=args.heads, d_model=args.d_model,
              d_ff=4 * args.d_model, max_seq_len=args.seq_len,
              dtype=torch.bfloat16 if gpu else torch.float32)
  cfg = BertConfig(**flat, pipeline_stages=args.stages,
                   num_micro_batch=args.micro)
  model = Bert(cfg)
  whole = init_params(BertConfig(**flat), seed=0, device=mesh.device)
  if args.stages > 1:
    whole = stack_stages(whole, cfg)
  local = local_params(model, whole, mesh)

  r = np.random.RandomState(0)
  ids = r.randint(0, cfg.vocab_size, (args.batch, cfg.max_seq_len))
  batch = {"ids": ids, "labels": ids,
           "mask": (r.rand(args.batch, cfg.max_seq_len) < 0.15).astype(
               np.float32)}
  # optax.adamw(1e-4): weight decay 1e-4.
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(1e-4, weight_decay=1e-4)), mesh)
  step = parallelize(make_bert_train_step(model), mesh, shardings)
  losses = []
  for i in range(args.steps):
    state, m = step(state, batch, None)
    losses.append(float(m["loss"]))
    if is_leader():
      print(f"step {i}: mlm loss {losses[-1]:.4f}")
  return {"losses": losses, "mesh": dict(mesh.shape)}


def main(argv: Optional[List[str]] = None):
  import sys

  from easyparallellibrary_tpu_torch.examples import _ranks
  from easyparallellibrary_tpu_torch.examples import (
      train_bert_pipeline as this)
  argv = list(sys.argv[1:] if argv is None else argv)
  return _ranks.run(this._rank_main, argv,
                    max(1, _parser().parse_args(argv).stages))


if __name__ == "__main__":
  main()
