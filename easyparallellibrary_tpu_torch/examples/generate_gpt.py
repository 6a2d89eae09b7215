"""Autoregressive decoding example — KV cache and sampling controls (port
of ``examples/generate_gpt.py``).

  python -m easyparallellibrary_tpu_torch.examples.generate_gpt   # greedy
  python -m easyparallellibrary_tpu_torch.examples.generate_gpt \\
      --temperature 0.8 --top-k 40
  python -m easyparallellibrary_tpu_torch.examples.generate_gpt \\
      --temperature 0.9 --top-p 0.95
  python -m easyparallellibrary_tpu_torch.examples.generate_gpt --paged

Loads a checkpoint if ``--checkpoint-dir`` has one (e.g. from
``examples.train_gpt --ckpt``), otherwise decodes from weights drawn
from ``--seed``.  One prefill over the prompt fills each layer's K/V
cache, then one forward per generated token (``models.gpt.generate``).
``--paged`` serves the prompt through the paged serving engine instead
(greedy; the paged-attention kernel on the GPU).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None):
  import torch

  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.gpt import (
      GPT, GPTConfig, generate)
  from easyparallellibrary_tpu_torch.utils import prng
  from easyparallellibrary_tpu_torch.utils.device import resolve_device
  from easyparallellibrary_tpu_torch.weights import init_params

  ap = argparse.ArgumentParser(
      prog="python -m easyparallellibrary_tpu_torch.examples.generate_gpt")
  ap.add_argument("--temperature", type=float, default=0.0)
  ap.add_argument("--top-k", type=int, default=0)
  ap.add_argument("--top-p", type=float, default=1.0)
  ap.add_argument("--max-new-tokens", type=int, default=32)
  ap.add_argument("--checkpoint-dir", default="")
  ap.add_argument("--seed", type=int, default=0)
  # Model shape flags mirror train_gpt so a checkpoint from there loads
  # here unchanged.
  ap.add_argument("--layers", type=int, default=4)
  ap.add_argument("--d-model", type=int, default=256)
  ap.add_argument("--heads", type=int, default=8)
  ap.add_argument("--vocab", type=int, default=4096)
  ap.add_argument("--seq-len", type=int, default=256)
  ap.add_argument("--paged", action="store_true",
                  help="serve through the paged engine (greedy)")
  ap.add_argument("--device", default=None,
                  help="default: the GPU; 'cpu' to ask for the CPU")
  args = ap.parse_args(argv)

  epl.init(device=args.device)
  device = resolve_device(args.device)
  cfg = GPTConfig(vocab_size=args.vocab, num_layers=args.layers,
                  num_heads=args.heads, d_model=args.d_model,
                  d_ff=4 * args.d_model, max_seq_len=args.seq_len,
                  dtype=torch.float32)
  model = GPT(cfg)
  prompt = np.random.RandomState(args.seed).randint(
      0, cfg.vocab_size, (1, 8))
  params = init_params(cfg, 0, device=device)

  if args.checkpoint_dir:
    from easyparallellibrary_tpu_torch.runtime.saver import (
        latest_step, restore_params)
    if latest_step(args.checkpoint_dir) is not None:
      params, step = restore_params(args.checkpoint_dir, target=params,
                                    device=device)
      print(f"restored checkpoint at step {step}")

  if args.paged:
    from easyparallellibrary_tpu_torch.serving import (
        ContinuousBatchingEngine, Request)
    eng = ContinuousBatchingEngine(model, params, device=device, paged=True,
                                   num_slots=2, prefill_chunk=8,
                                   block_size=8)
    try:
      eng.submit(Request(uid="example", prompt=prompt[0].astype(np.int32),
                         max_new_tokens=args.max_new_tokens))
      done = eng.run()
    finally:
      eng.close()
    new = [int(t) for t in done["example"][prompt.shape[1]:]]
  else:
    out = generate(model, params,
                   torch.from_numpy(prompt).to(device),
                   args.max_new_tokens, temperature=args.temperature,
                   top_k=args.top_k, top_p=args.top_p,
                   rng=prng.prng_key(args.seed))
    new = out[0, prompt.shape[1]:].cpu().tolist()
  print("prompt:   ", prompt[0].tolist())
  print("generated:", new)
  return {"prompt": prompt[0].tolist(), "generated": new}


if __name__ == "__main__":
  main()
