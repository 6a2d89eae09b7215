"""Collective-matmul rings (port of
``easyparallellibrary_tpu/communicators/overlap.py``).

The JAX module decomposes a gather -> matmul or matmul -> scatter
adjacency into a ring of ``lax.ppermute`` steps interleaved with partial
products (Wang et al., ASPLOS'23), so XLA's scheduler can hide each hop
under a chunk of the product.  Here each hop is a send/recv pair
(``collectives.ppermute``, ``batch_isend_irecv`` underneath, staged
through host memory on a gloo group over CUDA tensors), written in the
same order: the next window's product is issued before the current
window's hops.  Every op is differentiable.

* :func:`all_gather_matmul`: ``all_gather(x) @ w``, row blocks from the
  same product as the fused one: bit-exact.
* :func:`matmul_reduce_scatter`: ``reduce_scatter(x @ w)``, the
  accumulator riding the ring: equal up to the order of the sums.
* :func:`reduce_scatter`: the matmul-free ring.

``num_chunks`` K divides the axis size n (K = n: fully interleaved;
K <= 1: the fused collective).  :func:`resolve_num_chunks` applies the
``communication.overlap`` policy (``off``, ``on``, or ``auto`` through
``parallel.planner.plan_collective_matmul``).
"""

from __future__ import annotations

from typing import Optional

import torch

from easyparallellibrary_tpu_torch.communicators import collectives


def ring_step(x, axis_name: str, n: Optional[int] = None):
  """One ring hop: rank d's value moves to d + 1."""
  if n is None:
    n = collectives.axis_size(axis_name)
  return collectives.ppermute(x, axis_name,
                              [(i, (i + 1) % n) for i in range(n)])


def normalize_chunks(num_chunks: int, axis_n: int) -> int:
  """0/1 -> fused; else the largest divisor of ``axis_n`` at most the
  request."""
  if num_chunks <= 1 or axis_n <= 1:
    return 1
  k = min(num_chunks, axis_n)
  while axis_n % k:
    k -= 1
  return k


def all_gather_matmul(x, w, axis_name: str, num_chunks: int = 0):
  """``all_gather(x, axis=0) @ w`` (``x`` this rank's ``[m, k]`` rows,
  ``w`` ``[k, N]``); returns ``[n * m, N]``."""
  if x.dim() != 2 or w.dim() != 2:
    raise ValueError(f"all_gather_matmul wants rank-2 operands; got "
                     f"{tuple(x.shape)} @ {tuple(w.shape)}")
  n = collectives.axis_size(axis_name)
  K = normalize_chunks(num_chunks, n)
  if K <= 1:
    return torch.matmul(collectives.all_gather(x, axis_name, axis=0), w)
  c = n // K
  m = x.shape[0]
  d = collectives.axis_index(axis_name)
  blocks = [None] * n
  buf = x
  t = 0
  for _ in range(K):
    window = []
    for j in range(c):
      if t > 0:
        buf = ring_step(buf, axis_name, n)
      window.append(((d - t) % n, buf))
      t += 1
    part = torch.matmul(torch.cat([b for _, b in window], dim=0), w)
    for j, (src, _) in enumerate(window):
      blocks[src] = part[j * m:(j + 1) * m]
  return torch.cat(blocks, dim=0)


def matmul_reduce_scatter(x, w, axis_name: str, num_chunks: int = 0):
  """``reduce_scatter(x @ w, axis=0)`` (``x`` ``[M, k_loc]``, ``w``
  ``[k_loc, N]``); returns this rank's ``[M / n, N]`` block.  At ring
  step t rank d adds its contribution to block ``(d - 1 - t) mod n`` and
  forwards it; after n - 1 hops block d's sum is home."""
  if x.dim() != 2 or w.dim() != 2:
    raise ValueError(f"matmul_reduce_scatter wants rank-2 operands; got "
                     f"{tuple(x.shape)} @ {tuple(w.shape)}")
  n = collectives.axis_size(axis_name)
  K = normalize_chunks(num_chunks, n)
  if K <= 1:
    return collectives.reduce_scatter(torch.matmul(x, w), axis_name, axis=0)
  M = x.shape[0]
  if M % n:
    raise ValueError(f"matmul_reduce_scatter needs rows ({M}) divisible "
                     f"by the axis size ({n})")
  c = n // K
  mb = M // n
  d = collectives.axis_index(axis_name)

  def window_matmul(g):
    rows = [x[((d - 1 - (g * c + j)) % n) * mb:][:mb] for j in range(c)]
    return torch.matmul(torch.cat(rows, dim=0), w).reshape(c, mb, -1)

  part = window_matmul(0)
  acc = part[0]
  for g in range(K - 1):
    part_next = window_matmul(g + 1)     # issued before this window's hops
    for j in range(1, c):
      acc = ring_step(acc, axis_name, n) + part[j]
    acc = ring_step(acc, axis_name, n) + part_next[0]
    part = part_next
  for j in range(1, c):
    acc = ring_step(acc, axis_name, n) + part[j]
  return acc


def reduce_scatter(x, axis_name: str, axis: int = 0, num_chunks: int = 0):
  """Ring ``reduce_scatter(x, axis)``; ``num_chunks`` switches between
  the fused collective (<= 1) and the full n-step ring (>= 2)."""
  n = collectives.axis_size(axis_name)
  K = normalize_chunks(num_chunks, n)
  if K <= 1:
    return collectives.reduce_scatter(x, axis_name, axis=axis)
  if x.shape[axis] % n:
    raise ValueError(f"reduce_scatter dim {axis} ({x.shape[axis]}) must "
                     f"divide the axis size ({n})")
  xm = x.movedim(axis, 0)
  mb = xm.shape[0] // n
  d = collectives.axis_index(axis_name)

  def block(t):
    b = (d - 1 - t) % n
    return xm[b * mb:(b + 1) * mb]

  acc = block(0)
  for t in range(1, n):
    acc = ring_step(acc, axis_name, n) + block(t)
  return acc.movedim(0, axis)


def resolve_num_chunks(kind: str, axis_n: int, *, m: int, k: int,
                       n_out: int, dtype=torch.bfloat16, config=None,
                       measured_collective_bytes=None,
                       site: Optional[str] = None) -> int:
  """The chunk count the ``communication.overlap`` policy picks for one
  site: 1 = fused, >= 2 = ring.  ``auto`` registers ``site`` with the
  device introspector and takes its measured per-site bytes when there
  are any (``observability.device``), else the analytic bytes."""
  if axis_n <= 1:
    return 1
  if config is None:
    from easyparallellibrary_tpu_torch.env import Env
    config = Env.get().config
  comm = config.communication
  if comm.overlap == "off":
    return 1
  requested = comm.overlap_chunks
  if comm.overlap == "on":
    return normalize_chunks(requested if requested > 1 else axis_n, axis_n)
  itemsize = torch.empty((), dtype=dtype).element_size()
  if site is not None:
    from easyparallellibrary_tpu_torch.observability import device as dev_lib
    dev_lib.register_site(site, kind=kind, axis_n=axis_n, m=m, k=k,
                          n_out=n_out, dtype_bytes=itemsize)
    if measured_collective_bytes is None:
      measured_collective_bytes = dev_lib.measured_collective_bytes(site)
  from easyparallellibrary_tpu_torch.parallel.planner import (
      plan_collective_matmul)
  decision = plan_collective_matmul(
      kind, m=m, k=k, n_out=n_out, axis_size=axis_n,
      dtype_bytes=itemsize, num_chunks=requested,
      measured_collective_bytes=measured_collective_bytes)
  return decision.num_chunks if decision.enabled else 1
