"""PyTorch/CUDA port of easyparallellibrary_tpu.

A package beside the JAX one, mirroring its module paths; the JAX
package stays the reference the port is tested against.  Ported so far:

* the paged serving path (``serving.ContinuousBatchingEngine`` over
  ``models.gpt.GPT``), with paged attention as a hand-written CUDA kernel
  for Hopper (``kernels/csrc/paged_attention.cu``);
* the training step of ``bench.py`` on one device: the annotation
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
         layout: str = "auto", device=None) -> Env:
  """Initialize the framework: reset the global Env, install the config
  and enumerate the devices into a :class:`Cluster` (one device: the
  current GPU, or the CPU when ``device="cpu"``).  On one device the
  ``auto`` and ``all`` layouts give the same mesh."""
  if layout not in ("auto", "all"):
    raise ValueError(f"unknown layout {layout!r}; expected 'auto' or 'all'")
  env = Env.get()
  env.init(config)
  env.cluster = Cluster(devices=devices, device=device)
  return env


def set_default_strategy(strategy: Optional[ParallelStrategy]):
  Env.get().strategy_context.set_default(strategy)


def add_to_collection(value, key: str):
  """Register a metric for merging into the train step's metrics."""
  Env.get().add_to_collection(value, key)


def barrier(name: str = "epl_barrier"):
  """Synchronize all processes: a no-op, the port runs one process."""
  del name


__all__ = [
    "Config", "Env", "Cluster", "GraphKeys", "ParallelPlan", "Taskgraph",
    "ParallelStrategy", "Replicate", "Split", "replicate", "split",
    "init", "set_default_strategy", "add_to_collection", "barrier",
    "current_plan", "constants",
]
