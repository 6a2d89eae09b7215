"""How an example reaches its ranks: in this process when it needs one
rank or a launcher already started the group, else on ``world`` ranks
of ``utils.launcher.spawn`` (each calls ``rank_main(argv)``)."""

from __future__ import annotations

import os
from typing import Any, Callable, List

# Deadline of a spawned example group (a rank that fails ends it sooner).
SPAWN_TIMEOUT_S = 600.0


def _rank_entry(rank: int, world: int, rank_main: Callable, argv: List[str]):
  del world
  if "--device" in argv and argv[argv.index("--device") + 1] == "cpu":
    import torch
    # Several CPU ranks at once: one intra-op thread each.
    torch.set_num_threads(1)
  out = rank_main(argv)
  return out if rank == 0 else None


def run(rank_main: Callable[[List[str]], Any], argv: List[str],
        world: int) -> Any:
  """``rank_main(argv)`` on ``world`` ranks; rank 0's return."""
  if world <= 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1:
    return rank_main(argv)
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  return spawn(_rank_entry, world, (rank_main, list(argv)),
               timeout_s=SPAWN_TIMEOUT_S)[0]


def is_leader() -> bool:
  import torch.distributed as dist
  return not dist.is_initialized() or dist.get_rank() == 0
