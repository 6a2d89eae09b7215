"""Train GPT with any parallelism mix the port supports — config-driven
example (port of ``examples/train_gpt.py``).

Usage (one process per rank: a mix of N ranks starts them itself, or
runs under ``python -m easyparallellibrary_tpu_torch.utils.launcher
--num_workers N -- ...``):

  python -m easyparallellibrary_tpu_torch.examples.train_gpt          # one rank
  python -m easyparallellibrary_tpu_torch.examples.train_gpt --tp 2   # TP
  python -m easyparallellibrary_tpu_torch.examples.train_gpt --pp 2 --micro 4
  python -m easyparallellibrary_tpu_torch.examples.train_gpt --tp 2 --pp 2 \\
      --micro 4 --zero v1
  python -m easyparallellibrary_tpu_torch.examples.train_gpt --experts 8
  python -m easyparallellibrary_tpu_torch.examples.train_gpt --seq ring \\
      --seq-size 2                                    # ring attention
  python -m easyparallellibrary_tpu_torch.examples.train_gpt --pp 2 \\
      --micro 8 --engine smap --interleave 2 --layers 8  # interleaved 1F1B

``--device cpu`` runs on the CPU (gloo between ranks); on the GPU each
rank takes ``cuda:(rank % device_count)`` and the group is NCCL unless
``--backend gloo`` (two ranks on one card need gloo).  Attention is the
flash kernels on the GPU (``attn_impl="pallas_flash"``) and the plain
version on the CPU, ring / Ulysses under ``--seq``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def _parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      prog="python -m easyparallellibrary_tpu_torch.examples.train_gpt")
  p.add_argument("--tp", type=int, default=1)
  p.add_argument("--pp", type=int, default=1)
  p.add_argument("--micro", type=int, default=1)
  p.add_argument("--zero", default="")
  p.add_argument("--experts", type=int, default=0)
  p.add_argument("--seq", default="", choices=["", "ring", "ulysses"])
  p.add_argument("--seq-size", type=int, default=1)
  p.add_argument("--engine", default="", choices=["", "vmap", "smap"],
                 help="pipeline engine (smap = per-rank stage programs; "
                      "with --interleave K > 1 the schedule becomes "
                      "Megatron-interleaved 1F1B)")
  p.add_argument("--interleave", type=int, default=1)
  p.add_argument("--layers", type=int, default=4)
  p.add_argument("--d-model", type=int, default=256)
  p.add_argument("--heads", type=int, default=8)
  p.add_argument("--vocab", type=int, default=4096)
  p.add_argument("--seq-len", type=int, default=256)
  p.add_argument("--batch", type=int, default=16)
  p.add_argument("--steps", type=int, default=20)
  p.add_argument("--ckpt", default="")
  p.add_argument("--device", default=None,
                 help="default: the GPU; 'cpu' to ask for the CPU")
  p.add_argument("--backend", default=None,
                 help="process-group backend (default: nccl on the GPU, "
                      "gloo on the CPU)")
  return p


def world_size(args) -> int:
  """Ranks the mix needs: stage x model x seq x expert (data 1)."""
  ep = min(args.experts, 2) if args.experts else 1
  return args.pp * args.tp * (args.seq_size if args.seq else 1) * ep


def _rank_main(argv: List[str]):
  import torch

  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.examples._ranks import is_leader
  from easyparallellibrary_tpu_torch.models.gpt import (
      GPT, GPTConfig, gpt_flops_per_token, make_gpt_train_step)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.profiler import StepProfiler
  from easyparallellibrary_tpu_torch.runtime.saver import (
      params_tree, save_checkpoint)
  from easyparallellibrary_tpu_torch.utils import prng
  from easyparallellibrary_tpu_torch.weights import (
      init_params, local_params, stack_stages)

  args = _parser().parse_args(argv)
  env = epl.init(epl.Config({
      "pipeline.num_micro_batch": args.micro,
      "pipeline.engine": args.engine,
      "zero.level": args.zero,
      "sequence.parallelism": args.seq,
      "sequence.axis_size": args.seq_size,
  }), device=args.device, backend=args.backend)
  gpu = env.cluster.devices[0].type == "cuda"
  flat = dict(
      vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
      d_model=args.d_model, d_ff=4 * args.d_model, max_seq_len=args.seq_len,
      dtype=torch.bfloat16 if gpu else torch.float32,
      num_experts=args.experts, seq_parallel=bool(args.seq),
      attn_impl=args.seq or ("pallas_flash" if gpu else "xla"))
  # Annotations: consecutive replicate scopes = stages; split = TP.
  # Scopes opened in a loop share a call site, so each stage needs a
  # distinct name (an unnamed loop would collapse into one stage).
  for i in range(args.pp):
    with epl.replicate(1, name=f"stage{i}"):
      pass
  if args.tp > 1:
    with epl.split(args.tp):
      pass
  plan = epl.current_plan(
      expert_parallel=min(args.experts, 2) if args.experts else 1)
  mesh = plan.build_mesh()
  if is_leader():
    print("mesh:", dict(mesh.shape))
  # The model is built after the mesh: its layers read the model, stage
  # and seq axes when built.
  cfg = GPTConfig(**flat, tensor_parallel=args.tp > 1,
                  pipeline_stages=args.pp, num_micro_batch=args.micro,
                  pipeline_interleave=args.interleave)
  model = GPT(cfg)
  # The whole weights from a seed (the flat layout), then this rank's
  # slice in the model's layout.
  whole = init_params(GPTConfig(**flat), seed=0, device=mesh.device)
  if args.pp > 1:
    whole = stack_stages(whole, cfg)
  local = local_params(model, whole, mesh)

  ids = np.random.RandomState(0).randint(
      0, cfg.vocab_size, (args.batch, cfg.max_seq_len + 1))
  batch = {"ids": ids}
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(3e-4)), mesh)
  # make_gpt_train_step dispatches on the Config: pipeline engine
  # (vmap/smap), schedule policy, grouped apply, AMP.
  step = parallelize(make_gpt_train_step(model), mesh, shardings)

  tokens_per_step = args.batch * cfg.max_seq_len
  prof = StepProfiler(
      flops_per_step=gpt_flops_per_token(cfg, cfg.max_seq_len)
      * tokens_per_step,
      tokens_per_step=tokens_per_step)
  rng = prng.prng_key(1)
  losses = []
  for i in range(args.steps):
    state, metrics = step(state, batch, prng.host_fold_in(rng, i))
    prof.tick()
    losses.append(float(metrics["loss"]))
    if i % 5 == 0 and is_leader():
      print(f"step {i}: loss {losses[-1]:.4f}")
  summary = prof.summary()
  if is_leader():
    print("profile:", summary)
  if args.ckpt:
    # The bare params tree, as the JAX script saves it: every rank takes
    # part, each parameter gathered to its logical shape by its layout.
    save_checkpoint(args.ckpt, params_tree(state.params, shardings),
                    step=args.steps)
    if is_leader():
      print("checkpoint saved to", args.ckpt)
  return {"losses": losses, "profile": summary, "mesh": dict(mesh.shape)}


def main(argv: Optional[List[str]] = None):
  import sys

  from easyparallellibrary_tpu_torch.examples import _ranks
  from easyparallellibrary_tpu_torch.examples import train_gpt as this
  argv = list(sys.argv[1:] if argv is None else argv)
  return _ranks.run(this._rank_main, argv, world_size(_parser().parse_args(
      argv)))


if __name__ == "__main__":
  main()
