"""PyTorch/CUDA port of easyparallellibrary_tpu.

A package beside the JAX one, mirroring its module paths; the JAX
package stays the reference the port is tested against.  Ported so far:

* the paged serving path (``serving.ContinuousBatchingEngine`` over
  ``models.gpt.GPT``), with paged attention as a hand-written CUDA kernel
  for Hopper (``kernels/csrc/paged_attention.cu``);
* tensor, data and ZeRO-1 parallelism on ``torch.distributed``, one
  process per rank (``cluster.Mesh``, ``communicators/``,
  ``utils/launcher.py``);
* the training step of ``bench.py``: the annotation
  surface below, ``parallel.create_sharded_train_state`` /
  ``make_train_step`` / ``parallelize``, ``models.gpt.gpt_loss`` with
  remat and the chunked tied cross-entropy, AdamW, and flash attention as
  three hand-written CUDA kernels (``kernels/csrc/flash_attention.cu``).

ROADMAP.md lists what is still to port.  Typical use::

    import easyparallellibrary_tpu_torch as epl

    epl.init()                      # device="cpu" to run on the CPU
    with epl.replicate(1):
        model = GPT(cfg)
    mesh = epl.current_plan().build_mesh()

Importing the package is cheap: no kernel is built until first use.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.cluster import Cluster
from easyparallellibrary_tpu_torch.config import Config
from easyparallellibrary_tpu_torch.constants import GraphKeys
from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.ir import (
    ParallelPlan, Taskgraph, current_plan)
from easyparallellibrary_tpu_torch.strategies import (
    ParallelStrategy, Replicate, Split, replicate, split)

__version__ = "0.1.0"


def init(config: Optional[Config] = None, devices=None,
         layout: str = "auto", device=None,
         backend: Optional[str] = None) -> Env:
  """Initialize the framework: reset the global Env, install the config
  and enumerate the ranks into a :class:`Cluster`.  Under a launcher
  (``WORLD_SIZE > 1`` in the environment) this first starts the default
  process group (``utils.launcher.init_distributed``: ``nccl`` for the
  GPU, ``gloo`` for ``device="cpu"``, or ``backend``); each process
  holds one device, the current GPU unless ``device="cpu"``."""
  import os
  if layout not in ("auto", "all"):
    raise ValueError(f"unknown layout {layout!r}; expected 'auto' or 'all'")
  if int(os.environ.get("WORLD_SIZE", "1")) > 1:
    from easyparallellibrary_tpu_torch.utils.launcher import (
        init_distributed)
    device = init_distributed(backend=backend, device=device)
  env = Env.get()
  env.init(config)
  env.cluster = Cluster(devices=devices, device=device, layout=layout)
  return env


def set_default_strategy(strategy: Optional[ParallelStrategy]):
  Env.get().strategy_context.set_default(strategy)


def add_to_collection(value, key: str):
  """Register a metric for merging into the train step's metrics."""
  Env.get().add_to_collection(value, key)


def barrier(name: str = "epl_barrier"):
  """Synchronize all processes of the default group (a no-op without
  one)."""
  del name
  import torch.distributed as dist
  if dist.is_available() and dist.is_initialized():
    dist.barrier()


__all__ = [
    "Config", "Env", "Cluster", "GraphKeys", "ParallelPlan", "Taskgraph",
    "ParallelStrategy", "Replicate", "Split", "replicate", "split",
    "init", "set_default_strategy", "add_to_collection", "barrier",
    "current_plan", "constants",
]
