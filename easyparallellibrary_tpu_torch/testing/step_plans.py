"""Engine step plans from the real scheduler, without a model: the
paged-attention inputs that speculative decoding and prefix caching
give the kernel (a speculative step, a draft model's rollout, a
warm-prefix step).  ``tests/test_torch_paged_attention.py``,
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the tiled
kernel's planner and the kernel to the plain version on them."""

from __future__ import annotations

import numpy as np

WARM_HEAD = 256     # tokens of the shared head of a warm-prefix step


def scheduled_step(seed: int, *, num_slots: int = 8, chunk: int = 128,
                   block_size: int = 16, max_seq_len: int = 1024,
                   spec_k: int = 4, warm: bool = False):
  """One step plan of the port's ``FCFSScheduler`` (``spec_k`` drafts,
  token budget ``num_slots + 2 * chunk``), its draft runs partly filled
  as a drafter fills them.  ``num_slots - 1`` requests of 200-519
  prompt tokens are driven (random commits) until all decode; then one
  more is admitted, so the plan holds their decode tokens and draft
  runs, its prefill chunk, and padding.  ``warm``: the prefix cache is
  on and the last request shares the first one's ``WARM_HEAD``-token
  head, so it is admitted warm and its chunk starts at position
  ``WARM_HEAD`` over blocks that the first slot's table also holds.
  Returns the plan; ``plan.block_tables[plan.slot_ids]`` and
  ``plan.positions`` are the kernel's tables and positions."""
  from easyparallellibrary_tpu_torch.serving import FCFSScheduler, Request
  r = np.random.RandomState(seed)
  mb = max_seq_len // block_size
  sched = FCFSScheduler(num_slots=num_slots, prefill_chunk=chunk,
                        max_seq_len=max_seq_len, spec_k=spec_k,
                        block_size=block_size,
                        num_blocks=num_slots * mb + 1,
                        token_budget=num_slots + 2 * chunk,
                        prefix_cache=warm)
  head = r.randint(0, 100, (WARM_HEAD,)).astype(np.int32)
  for i, n in enumerate(r.randint(200, 520, num_slots - 1)):
    prompt = r.randint(0, 100, (n,)).astype(np.int32)
    if warm and i == 0:
      prompt = np.concatenate([head, prompt[:40]])
    sched.submit(Request(uid=i, prompt=prompt, max_new_tokens=100))
  while True:
    sched.plan_step()
    sched.commit(r.randint(0, 100, (num_slots,)))
    if all(not s.prefilling for s in sched.active.values()):
      break
  tail = r.randint(0, 100, (150,)).astype(np.int32)
  sched.submit(Request(uid="last", prompt=np.concatenate([head, tail])
                       if warm else tail, max_new_tokens=10))
  plan = sched.plan_step()
  for slot in np.nonzero(plan.draft_cap)[0]:
    n, b = r.randint(0, plan.draft_cap[slot] + 1), plan.draft_base[slot]
    plan.tokens[b:b + n] = r.randint(0, 100, (n,))
    plan.valid[b:b + n] = True
  return plan


def rollout_positions(plan, k: int, cross: int = 0) -> np.ndarray:
  """A draft model's rollout after ``plan``: call ``j`` (0..k-1) feeds
  token ``s`` of slot ``s`` at ``pos0[s] + j``, ``pos0`` one past each
  slot's last scheduled position.  ``cross`` > 0 moves slot 0's calls
  to ``cross - 2 ..``, across position ``cross`` (a split boundary of
  the tiled kernel).  Returns int32 ``[k, num_slots]``."""
  last = np.clip(plan.base_idx + plan.num_valid - 1, 0, None)
  pos0 = plan.positions[last].astype(np.int64) + 1
  if cross:
    pos0[0] = cross - 2
  return (pos0[None, :] + np.arange(k)[:, None]).astype(np.int32)
