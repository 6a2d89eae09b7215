"""Named-axis collectives on ``torch.distributed`` (port of
``easyparallellibrary_tpu/communicators/collectives.py``).

The JAX wrappers run inside ``shard_map`` regions, where a name like
``"model"`` is a mesh axis of the one program.  Here every rank is its
own process, and a name resolves to the process group of this rank's
mesh axis (``cluster.Mesh.group``; the ambient mesh of ``epl.init``
unless ``mesh=`` is given).  An axis of size 1 has no group, and every
collective over it is the identity.

The ones on a gradient path are differentiable
(``torch.autograd.Function``):

* ``all_reduce`` SUM: backward is the identity (MEAN divides by n), the
  convention of explicit tensor parallelism, where every rank holds the
  same replicated loss (the row-parallel layers and the vocab-parallel
  cross entropy rely on it).  JAX differentiates a ``shard_map`` body as
  the sum of the ranks' objectives, so its psum's backward sums;
* ``all_gather`` and ``reduce_scatter``: each the other's backward;
* ``all_to_all`` and ``ppermute``: backward runs the inverse exchange.

Backends.  NCCL takes CUDA tensors; gloo takes CPU tensors, and only
some collectives on CUDA tensors (send / recv and reduce fail there,
measured on an H100 with torch 2.11).  So a CUDA tensor on a gloo group
is staged through host memory around each collective
(:func:`_host_staged`), in the open and on every op, rather than per op
as gloo happens to support it.  ``reduce`` is an ``all_reduce`` with the
non-roots zeroed and ``broadcast`` returns the root's value on every
rank, the JAX semantics; PROD gathers and multiplies, as in JAX.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

# Reduce ops (the JAX package's vocabulary).
SUM = "sum"
PROD = "prod"
MAX = "max"
MIN = "min"
MEAN = "mean"

_OPS = {SUM: dist.ReduceOp.SUM, MAX: dist.ReduceOp.MAX,
        MIN: dist.ReduceOp.MIN, MEAN: dist.ReduceOp.SUM}


def _mesh(mesh=None):
  if mesh is not None:
    return mesh
  from easyparallellibrary_tpu_torch.env import Env
  cluster = Env.get().cluster
  if cluster is None or cluster.built_mesh is None:
    return None
  return cluster.built_mesh


def group_of(axis_name: str, mesh=None):
  """The process group of ``axis_name`` on this rank (None: size 1)."""
  m = _mesh(mesh)
  return None if m is None else m.group(axis_name)


def axis_size(axis_name: str, mesh=None) -> int:
  m = _mesh(mesh)
  return 1 if m is None else m.axis_size(axis_name)


def axis_index(axis_name: str, mesh=None) -> int:
  m = _mesh(mesh)
  return 0 if m is None else m.axis_index(axis_name)


# Bytes this process copied from the card to host memory to hand them to
# gloo (``chip_smoke.py`` reads it a step; set it to 0 to start a count).
staged_bytes = 0


def _host_staged(group, x: torch.Tensor) -> bool:
  return x.is_cuda and dist.get_backend(group) == "gloo"


def _wire(group, x: torch.Tensor) -> torch.Tensor:
  """The contiguous buffer a collective runs on: ``x`` itself, or a host
  copy for a CUDA tensor on a gloo group."""
  global staged_bytes
  x = x.contiguous()
  if _host_staged(group, x):
    staged_bytes += x.numel() * x.element_size()
    return x.cpu()
  return x


# --------------------------------------------------------------- raw ops

def _raw_all_reduce(x, group, op: str):
  buf = _wire(group, x)
  if buf is x:
    buf = x.clone()
  dist.all_reduce(buf, op=_OPS[op], group=group)
  if op == MEAN:
    buf = buf / dist.get_world_size(group)
  return buf.to(x.device)


def _raw_all_gather(x, group, axis: int):
  """Concatenate every rank's ``x`` along ``axis`` (rank order)."""
  n = dist.get_world_size(group)
  moved = _wire(group, x.movedim(axis, 0))
  out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                    dtype=moved.dtype, device=moved.device)
  dist.all_gather_into_tensor(out, moved, group=group)
  return out.to(x.device).movedim(0, axis)


def _raw_reduce_scatter(x, group, axis: int):
  """Sum over ranks, then keep this rank's block of ``axis``."""
  n = dist.get_world_size(group)
  if x.shape[axis] % n:
    raise ValueError(f"reduce_scatter dim {axis} ({x.shape[axis]}) must "
                     f"divide the axis size ({n})")
  moved = _wire(group, x.movedim(axis, 0))
  out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                    dtype=moved.dtype, device=moved.device)
  dist.reduce_scatter_tensor(out, moved, group=group)
  return out.to(x.device).movedim(0, axis)


def _raw_all_to_all(x, group, split_axis: int, concat_axis: int):
  n = dist.get_world_size(group)
  if x.shape[split_axis] % n:
    raise ValueError(f"all_to_all split dim {split_axis} "
                     f"({x.shape[split_axis]}) must divide the axis size "
                     f"({n})")
  send = _wire(group, x.movedim(split_axis, 0))
  recv = torch.empty_like(send)
  dist.all_to_all_single(recv, send, group=group)
  recv = recv.to(x.device)
  # recv holds n blocks along dim 0, block j from rank j.
  blocks = recv.chunk(n, dim=0)
  blocks = [b.movedim(0, split_axis) for b in blocks]
  return torch.cat(blocks, dim=concat_axis)


def _raw_ppermute(x, group, perm: Sequence[Tuple[int, int]]):
  """Each ``(src, dst)`` pair sends ``src``'s value to ``dst`` (group
  ranks); a rank no pair sends to gets zeros, as ``lax.ppermute``."""
  me = dist.get_rank(group)
  buf = _wire(group, x)
  out = torch.zeros_like(buf)
  ops = []
  for src, dst in perm:
    if src == me and dst == me:
      out.copy_(buf)
    elif src == me:
      ops.append(dist.P2POp(dist.isend, buf, dist.get_global_rank(group,
                                                                  dst),
                            group))
    elif dst == me:
      ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group,
                                                                  src),
                            group))
  if ops:
    for work in dist.batch_isend_irecv(ops):
      work.wait()
  return out.to(x.device)


# ------------------------------------------------------------- autograd

class _AllReduce(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, op):
    ctx.scale = (1.0 / dist.get_world_size(group)) if op == MEAN else 1.0
    return _raw_all_reduce(x, group, op)

  @staticmethod
  def backward(ctx, g):
    return (g if ctx.scale == 1.0 else g * ctx.scale), None, None


class _AllGather(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, axis):
    ctx.group, ctx.axis = group, axis
    return _raw_all_gather(x, group, axis)

  @staticmethod
  def backward(ctx, g):
    return _raw_reduce_scatter(g, ctx.group, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, axis):
    ctx.group, ctx.axis = group, axis
    return _raw_reduce_scatter(x, group, axis)

  @staticmethod
  def backward(ctx, g):
    return _raw_all_gather(g, ctx.group, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, split_axis, concat_axis):
    ctx.group, ctx.axes = group, (split_axis, concat_axis)
    return _raw_all_to_all(x, group, split_axis, concat_axis)

  @staticmethod
  def backward(ctx, g):
    split_axis, concat_axis = ctx.axes
    return (_raw_all_to_all(g, ctx.group, concat_axis, split_axis), None,
            None, None)


class _Ppermute(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, perm):
    ctx.group, ctx.perm = group, perm
    return _raw_ppermute(x, group, perm)

  @staticmethod
  def backward(ctx, g):
    inverse = tuple((dst, src) for src, dst in ctx.perm)
    return _raw_ppermute(g, ctx.group, inverse), None, None


# ------------------------------------------------------------ public API

def all_reduce(x, axis_name: str, op: str = SUM, mesh=None):
  """All-reduce over a mesh axis.  SUM/MEAN are differentiable; MAX/MIN
  carry no gradient; PROD gathers and multiplies."""
  group = group_of(axis_name, mesh)
  if op not in _OPS and op != PROD:
    raise ValueError(f"Unknown reduce op {op!r}; one of "
                     f"{sorted(list(_OPS) + [PROD])}")
  if group is None:
    return x
  if op == PROD:
    return all_gather(x[None], axis_name, axis=0, mesh=mesh).prod(dim=0)
  if op in (MAX, MIN):
    return _raw_all_reduce(x.detach(), group, op)
  return _AllReduce.apply(x, group, op)


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = True,
               mesh=None):
  """Every rank's shard concatenated along ``axis`` (``tiled``), or
  stacked on a new leading ``axis`` (not tiled), in axis order."""
  group = group_of(axis_name, mesh)
  if not tiled:
    x = x.unsqueeze(axis)
  if group is None:
    return x
  return _AllGather.apply(x, group, axis % x.dim())


def reduce_scatter(x, axis_name: str, axis: int = 0, op: str = SUM,
                   mesh=None):
  """Sum over the axis, then this rank's block of dim ``axis``."""
  if op not in (SUM, MEAN):
    raise ValueError("reduce_scatter supports sum/mean")
  group = group_of(axis_name, mesh)
  if group is None:
    return x
  out = _ReduceScatter.apply(x, group, axis % x.dim())
  if op == MEAN:
    out = out / dist.get_world_size(group)
  return out


def reduce(x, axis_name: str, root: int = 0, op: str = SUM, mesh=None):
  """Reduce to ``root``; the other ranks get zeros (an all-reduce, then
  a mask, as the JAX package's)."""
  summed = all_reduce(x, axis_name, op=op, mesh=mesh)
  if axis_index(axis_name, mesh) == root:
    return summed
  return torch.zeros_like(summed)


def broadcast(x, axis_name: str, root: int = 0, mesh=None):
  """``root``'s value (its index along the axis) on every rank."""
  group = group_of(axis_name, mesh)
  if group is None:
    return x
  buf = _wire(group, x)
  if buf is x:
    buf = x.clone()
  dist.broadcast(buf, dist.get_global_rank(group, root), group=group)
  return buf.to(x.device)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int,
               tiled: bool = True, mesh=None):
  """Split ``split_axis`` into n blocks, send block j to rank j, and
  concatenate the received blocks along ``concat_axis`` in rank
  order."""
  if not tiled:
    raise ValueError("all_to_all: only tiled=True is ported")
  group = group_of(axis_name, mesh)
  if group is None:
    return x
  return _AllToAll.apply(x, group, split_axis % x.dim(),
                         concat_axis % x.dim())


def ppermute(x, axis_name: str, perm: Sequence[Tuple[int, int]], mesh=None):
  """Point-to-point permutation over the axis: each ``(src, dst)`` pair
  (axis indices) moves ``src``'s value to ``dst``."""
  group = group_of(axis_name, mesh)
  perm = tuple((int(s), int(d)) for s, d in perm)
  if group is None:
    return x if (0, 0) in perm else torch.zeros_like(x)
  return _Ppermute.apply(x, group, perm)


def ring_shift(x, axis_name: str, shift: int = 1, mesh=None):
  """Rotate values around the axis ring: rank i -> rank (i + shift) % n."""
  n = axis_size(axis_name, mesh)
  return ppermute(x, axis_name, [(i, (i + shift) % n) for i in range(n)],
                  mesh=mesh)
