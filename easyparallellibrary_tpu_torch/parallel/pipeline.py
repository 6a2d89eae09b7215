"""Pipeline parallelism over the ``stage`` axis: one executor per rank,
driven by an action table (port of
``easyparallellibrary_tpu/parallel/pipeline.py``).

The JAX package runs a pipeline as one SPMD program: stacked stage
parameters, a rolling activation buffer moved by ``jnp.roll`` (a
collective-permute), a tick that applies every stage at once, and
autodiff through the ticks for the backward (the GPipe order).  Its two
other engines (``schedule_1f1b.py``, ``pipeline_smap.py``) write the
backward by hand.  The port runs one process per rank, each holding one
stage, so the three engines become one per-rank executor,
:class:`Pipeline`, and the schedules become tables (:class:`Tick`):

* at each tick, every rank looks up its forward and its backward action
  (virtual stage ``v = chunk * S + rank``, micro-batch ``m``), and the
  tick-global boundary actions: the feed (the embedding of the
  micro-batch virtual stage 0 starts), the emit (head and loss of the
  micro-batch leaving virtual stage ``V - 1``) and the feed's backward;
* a stage output goes to the rank of ``v + 1`` and an input cotangent to
  the rank of ``v - 1``, both at the end of the tick (one hop on the
  ring, arriving for the next tick, as in the JAX tables);
* each micro-batch's backward is driven explicitly
  (``torch.autograd.backward(stage_out, grad_tensors=cotangent)``), so
  no autograd graph spans two ranks: the ranks' graphs differ (stage 0
  holds the embedding, the last stage the loss), and letting autograd
  order their sends could deadlock;
* a bubble tick, or a masked slot of an uneven stage, is a real skip;
* under stage remat (the 1F1B schedules) a stage's forward runs without
  a graph, keeps its input, and runs again in its backward.

Every rank walks the same table, so every collective of a tick (the
feed's, the emit's, the hops) is issued in the same order on every rank
of the stage group: the port's form of the JAX engines' rule that a
collective is gated only by tick-global predicates.

The boundary layout is the caller's: with ``collective_boundary`` (the
``smap`` engine) every rank runs the feed, the emit and the feed's
backward, each a collective over the stage axis; otherwise (``""`` /
``vmap``) stage 0 feeds and the last stage emits, alone.

:func:`gpipe_schedule` is the GPipe table (chained passes of ``S`` ranks
for ``K`` chunks a rank, the circular placement), and
:func:`bubble_fraction` the textbook ``(S-1)/(M+S-1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives

Op = Optional[Tuple[int, int]]          # (chunk, micro-batch) or None


@dataclasses.dataclass(frozen=True)
class Tick:
  """One tick of a schedule: each rank's forward and backward action
  (``(chunk, micro_batch)`` or None) and the tick-global boundary
  actions (a micro-batch index or None)."""
  fwd: Tuple[Op, ...]
  bwd: Tuple[Op, ...]
  feed: Optional[int] = None
  emit: Optional[int] = None
  feed_bwd: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PipeSchedule:
  """A whole schedule: ``ticks`` over ``S`` ranks with ``K`` chunks a
  rank and ``M`` micro-batches; ``remat_stage`` recomputes each stage in
  its backward."""
  name: str
  S: int
  K: int
  M: int
  ticks: Tuple[Tick, ...]
  remat_stage: bool

  @property
  def busy_slots(self) -> int:
    return sum(op is not None for t in self.ticks for op in t.fwd + t.bwd)

  def launches_per_rank(self, layers_per_rank: int) -> Dict[str, int]:
    """Attention-kernel launches a rank makes in one step: a forward
    per layer and micro-batch (two under stage remat), one dK/dV and one
    dQ per layer and micro-batch."""
    n = layers_per_rank * self.M
    return {"fwd": n * (2 if self.remat_stage else 1), "dkv": n, "dq": n}


def make_ticks(S: int, K: int, fwd_rows: Sequence[Sequence[Op]],
               bwd_rows: Sequence[Sequence[Op]]) -> Tuple[Tick, ...]:
  """Ticks from per-tick rows of forward and backward actions, with the
  boundary actions derived: the feed where rank 0 runs virtual stage 0
  forward, the emit where rank ``S - 1`` runs virtual stage ``V - 1``
  forward, the feed's backward where rank 0 runs virtual stage 0
  backward."""
  ticks = []
  for f, b in zip(fwd_rows, bwd_rows):
    feed = f[0][1] if f[0] is not None and f[0][0] == 0 else None
    emit = (f[S - 1][1] if f[S - 1] is not None and f[S - 1][0] == K - 1
            else None)
    fb = b[0][1] if b[0] is not None and b[0][0] == 0 else None
    ticks.append(Tick(tuple(f), tuple(b), feed, emit, fb))
  return tuple(ticks)


def gpipe_schedule(S: int, M: int, K: int = 1,
                   remat_stage: bool = False) -> PipeSchedule:
  """GPipe: ``K`` chained passes, pass ``k`` running chunk ``k`` of every
  rank, forward of micro-batch ``m`` on rank ``s`` at tick
  ``k (M + S - 1) + m + s``; then every backward, in the reverse order
  of the forwards (the order autodiff through the forward ticks
  gives)."""
  if S < 2:
    raise ValueError("a pipeline needs at least 2 stages")
  span = M + S - 1
  T = K * span
  fwd = [[None] * S for _ in range(T)]
  for k in range(K):
    for m in range(M):
      for s in range(S):
        fwd[k * span + m + s][s] = (k, m)
  idle = [[None] * S for _ in range(T)]
  rows_f = fwd + idle
  rows_b = idle + [list(r) for r in reversed(fwd)]
  return PipeSchedule("gpipe", S, K, M, make_ticks(S, K, rows_f, rows_b),
                      remat_stage)


def bubble_fraction(num_stages: int, num_micro_batch: int) -> float:
  """GPipe bubble: (S-1)/(M+S-1)."""
  return (num_stages - 1) / (num_micro_batch + num_stages - 1)


# ------------------------------------------------------------ transport

# Payload bytes this process sent on stage hops (``chip_smoke.py`` reads
# it a step; set it to 0 to start a count).
hop_bytes = 0


class StageLink:
  """The hops between the ranks of one stage group: one batch of sends
  and receives a tick, each payload a compute-dtype activation.  A CUDA
  payload on a gloo group is staged through host memory
  (``collectives._wire``); the module's ``hop_bytes`` counts the payload
  bytes this rank sent."""

  def __init__(self, mesh=None):
    import torch.distributed as dist
    self.group = collectives.group_of(constants.STAGE_AXIS, mesh)
    self.size = collectives.axis_size(constants.STAGE_AXIS, mesh)
    self.rank = collectives.axis_index(constants.STAGE_AXIS, mesh)
    self._global = ([dist.get_global_rank(self.group, i)
                     for i in range(self.size)] if self.group else None)

  def exchange(self, sends, recvs, shape, dtype, device):
    """``sends``: ``[(dst, tag, tensor)]``; ``recvs``: ``[(src, tag)]``.
    Returns the received tensors on ``device``, in ``recvs``' order.
    Tags keep two payloads between one pair of ranks apart."""
    import torch.distributed as dist
    global hop_bytes
    if not sends and not recvs:
      return []
    ops, bufs = [], []
    for dst, tag, t in sends:
      buf = collectives._wire(self.group, t)
      hop_bytes += buf.numel() * buf.element_size()
      ops.append(dist.P2POp(dist.isend, buf, self._global[dst], self.group,
                            tag))
    staged = device.type == "cuda" and \
        dist.get_backend(self.group) == "gloo"
    for src, tag in recvs:
      buf = torch.empty(shape, dtype=dtype,
                        device="cpu" if staged else device)
      bufs.append(buf)
      ops.append(dist.P2POp(dist.irecv, buf, self._global[src], self.group,
                            tag))
    for work in dist.batch_isend_irecv(ops):
      work.wait()
    return [b.to(device) for b in bufs]


_FWD_TAG, _BWD_TAG = 1, 2


# ------------------------------------------------------------- executor


class Pipeline:
  """The per-rank executor of a :class:`PipeSchedule`.

  Contracts (``m`` a micro-batch index, ``mb`` its batch dict):

  * ``feed_fn(mb) -> x``: the embedding, with its autograd graph to the
    parameters.  Run by rank 0 alone, or by every rank at the same tick
    with ``collective_boundary`` (then only rank 0's result enters the
    stage, and every rank's graph takes rank 0's cotangent in the
    feed's backward, broadcast over the stage axis);
  * ``stage_fn(chunk, x, m) -> y`` (or ``(y, aux)``, a differentiable
    fp32 auxiliary loss of the chunk, such as MoE load balancing): this
    rank's chunk, shape-preserving, with no stage-axis collective;
  * ``emit_fn(y, mb) -> loss``: head and mean loss of one micro-batch.
    Run by the last rank alone, or by every rank with
    ``collective_boundary`` on the last rank's output (broadcast), where
    it may hold stage-axis collectives.

  Calling it, ``pipe(mbs, loss_scale)``, walks the table: the
  parameters' ``.grad`` accumulate the gradients of ``loss_scale *
  (mean_m loss_m + stage_aux_weight * sum_{s,m} aux / M)`` (JAX's
  ``stage_aux_weight`` objective), and it returns ``mean_m loss_m`` on
  the ranks that emitted (zero elsewhere).  With a ``stage_aux_weight``
  (None: the stages return no aux), ``stage_aux_loss`` is then
  ``sum_{s,m} aux / M``, summed over the stage axis.
  """

  def __init__(self, schedule: PipeSchedule, feed_fn: Callable,
               stage_fn: Callable, emit_fn: Callable, *,
               act_shape: Sequence[int], act_dtype: torch.dtype,
               device, collective_boundary: bool = False, mesh=None,
               stage_aux_weight: Optional[float] = None):
    self.schedule = schedule
    self.stage_aux_weight = stage_aux_weight
    self.stage_aux_loss = None
    self.feed_fn, self.stage_fn, self.emit_fn = feed_fn, stage_fn, emit_fn
    self.act_shape, self.act_dtype = tuple(act_shape), act_dtype
    self.device = torch.device(device)
    self.collective = collective_boundary
    self.link = StageLink(mesh)
    if self.link.size != schedule.S:
      raise ValueError(f"schedule for {schedule.S} stages on a stage axis "
                       f"of {self.link.size}")

  def _zeros(self):
    return torch.zeros(self.act_shape, dtype=self.act_dtype,
                       device=self.device)

  def __call__(self, mbs: List[dict], loss_scale=None) -> torch.Tensor:
    sched = self.schedule
    S, K, M = sched.S, sched.K, sched.M
    V = S * K
    me = self.link.rank
    seed = 1.0 if loss_scale is None else loss_scale
    inbuf: Dict[tuple, torch.Tensor] = {}
    cot: Dict[tuple, torch.Tensor] = {}
    res: Dict[tuple, tuple] = {}
    feeds: Dict[int, torch.Tensor] = {}
    last_out: Dict[int, torch.Tensor] = {}
    feed_ct: Dict[int, torch.Tensor] = {}
    loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=self.device)
    aux_seed = None
    if self.stage_aux_weight is not None:
      aux_seed = torch.tensor(self.stage_aux_weight / M, device=self.device) \
          * seed

    def run_stage(j, x, m):
      out = self.stage_fn(j, x, m)
      return out if isinstance(out, tuple) else (out, None)

    for tick in sched.ticks:
      if tick.feed is not None and (self.collective or me == 0):
        x = self.feed_fn(mbs[tick.feed])
        feeds[tick.feed] = x
        if me == 0:
          inbuf[(0, tick.feed)] = x.detach()
      sends = []
      op = tick.fwd[me]
      if op is not None:
        j, m = op
        v = j * S + me
        x = inbuf.pop((v, m))
        if sched.remat_stage:
          with torch.no_grad():
            y, aux = run_stage(j, x, m)
          res[(v, m)] = (x,)
        else:
          x = x.requires_grad_(True)
          y, aux = run_stage(j, x, m)
          res[(v, m)] = (x, y, aux)
          y = y.detach()
        if aux is not None:
          aux_sum = aux_sum + aux.detach().float()
        if v == V - 1:
          last_out[m] = y
        else:
          sends.append(((me + 1) % S, _FWD_TAG, y))
      if tick.emit is not None:
        m = tick.emit
        y = last_out.pop(m, None)
        if self.collective:
          y = collectives.broadcast(y if me == S - 1 else self._zeros(),
                                    constants.STAGE_AXIS, root=S - 1)
        if y is not None:
          y = y.detach().requires_grad_(True)
          loss = self.emit_fn(y, mbs[m])
          torch.autograd.backward(loss * (seed / M))
          loss_sum = loss_sum + loss.detach().float()
          if me == S - 1:
            cot[(V - 1, m)] = y.grad
      op = tick.bwd[me]
      if op is not None:
        j, m = op
        v = j * S + me
        saved = res.pop((v, m))
        if sched.remat_stage:
          x = saved[0].requires_grad_(True)
          y, aux = run_stage(j, x, m)
        else:
          x, y, aux = saved
        outs, cots = [y], [cot.pop((v, m))]
        if aux is not None and aux_seed is not None:
          outs.append(aux)
          cots.append(aux_seed)
        torch.autograd.backward(outs, grad_tensors=cots)
        if v > 0:
          sends.append(((me - 1) % S, _BWD_TAG, x.grad))
        else:
          feed_ct[m] = x.grad
      if tick.feed_bwd is not None and (self.collective or me == 0):
        m = tick.feed_bwd
        ct = feed_ct.pop(m, None)
        if self.collective:
          ct = collectives.broadcast(ct if me == 0 else self._zeros(),
                                     constants.STAGE_AXIS, root=0)
        torch.autograd.backward(feeds.pop(m), grad_tensors=ct)
      self._hop(tick, sends, inbuf, cot)
    if res or inbuf or cot or feeds:
      raise RuntimeError(f"schedule {sched.name!r} left work undone on "
                         f"stage {me}")
    if self.stage_aux_weight is not None:
      self.stage_aux_loss = collectives.all_reduce(
          aux_sum, constants.STAGE_AXIS) / M
    return loss_sum / M

  def _hop(self, tick: Tick, sends, inbuf, cot):
    """End of tick: each output this tick produced moves one hop; the
    table says every rank what it receives."""
    S, K = self.schedule.S, self.schedule.K
    V = S * K
    me = self.link.rank
    recvs, keys = [], []
    src = (me - 1) % S
    op = tick.fwd[src]
    if op is not None and op[0] * S + src < V - 1:
      recvs.append((src, _FWD_TAG))
      keys.append((inbuf, (op[0] * S + src + 1, op[1])))
    src = (me + 1) % S
    op = tick.bwd[src]
    if op is not None and op[0] * S + src > 0:
      recvs.append((src, _BWD_TAG))
      keys.append((cot, (op[0] * S + src - 1, op[1])))
    got = self.link.exchange(sends, recvs, self.act_shape, self.act_dtype,
                             self.device)
    for (store, key), t in zip(keys, got):
      store[key] = t
