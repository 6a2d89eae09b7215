"""Host offload of the optimizer state (port of
``easyparallellibrary_tpu/runtime/offload.py``).

The JAX package places the optimizer state in the chip's host memory
(``memory_kind="pinned_host"``) and lets XLA stream it around the update.
Here :func:`offload_to_host` wraps a train state's AdamW in
:class:`HostOffloadOptimizer`: both moments (``exp_avg``,
``exp_avg_sq``) live in pinned host memory, parameters and gradients
stay on the card.  Each step streams the moments through two device
buffers of at most ``bucket_mb`` (or the largest parameter's moments):
bucket ``i + 1`` is copied in on one side stream while bucket ``i`` is
stepped on the compute stream by the optimizer's own (fused) kernel and
copied back on another, so the update is bit-equal to the same optimizer
without offload and the card holds two buckets of moments instead of
all of them.

The step never waits on the host: a reader of the host moments (the
saver, through ``state``) waits for the last copy back first.  On a CPU
state host and device are one, so :func:`offload_to_host` changes
nothing there (the JAX package's CPU behaviour); the wrapper itself
also runs on the CPU, with synchronous copies.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from easyparallellibrary_tpu_torch.utils.logging import get_logger

HOST_MEMORY_KIND = "pinned_host"
# Moments per device buffer (two buffers): a bucket is raised to the
# largest parameter's two moments when that is more.
DEFAULT_BUCKET_MB = 256

_MOMENTS = ("exp_avg", "exp_avg_sq")


class HostOffloadOptimizer:
  """``opt`` (a torch AdamW, fused or not) with its moments in host
  memory, stepped bucket by bucket through device buffers (module
  docstring).  Everything else — ``param_groups`` (the learning-rate
  backoff scales them), ``found_inf`` (the sentinel's skip),
  ``inject_hyperparams`` — is ``opt``'s.  The host moments are pinned
  when the parameters are on the card."""

  def __init__(self, opt: torch.optim.Optimizer,
               bucket_mb: float = DEFAULT_BUCKET_MB):
    params = [p for g in opt.param_groups for p in g["params"]]
    if not params:
      raise ValueError("HostOffloadOptimizer: the optimizer has no "
                       "parameters")
    dtypes = {p.dtype for p in params}
    devices = {p.device for p in params}
    if len(dtypes) != 1 or len(devices) != 1:
      raise ValueError(f"HostOffloadOptimizer streams one dtype on one "
                       f"device; got {sorted(map(str, dtypes))} on "
                       f"{sorted(map(str, devices))}")
    object.__setattr__(self, "opt", opt)
    self.device = params[0].device
    self.dtype = params[0].dtype
    self.pin = self.device.type == "cuda"
    self.found_inf = None
    self.grad_scale = None
    self._params = params
    self._host: Dict[torch.Tensor, tuple] = {}
    self._ensure_host_state()
    # Contiguous buckets by bytes of both moments.
    item = torch.empty((), dtype=self.dtype).element_size()
    limit = max(int(bucket_mb * 2 ** 20) // (2 * item),
                max(p.numel() for p in params))
    self._buckets: List[List[torch.Tensor]] = []
    cur, size = [], 0
    for p in params:
      if cur and size + p.numel() > limit:
        self._buckets.append(cur)
        cur, size = [], 0
      cur.append(p)
      size += p.numel()
    self._buckets.append(cur)
    numel = max(sum(p.numel() for p in b) for b in self._buckets)
    # Two buffers, each [2, numel]: exp_avg and exp_avg_sq of a bucket.
    self._bufs = [torch.empty((2, numel), dtype=self.dtype,
                              device=self.device) for _ in range(2)]
    self.bucket_bytes = 2 * numel * item
    cuda = self.device.type == "cuda"
    self._h2d = torch.cuda.Stream(self.device) if cuda else None
    self._d2h = torch.cuda.Stream(self.device) if cuda else None
    self._copied_back: Optional[torch.cuda.Event] = None

  # -------------------------------------------------- the optimizer's face

  def __getattr__(self, name):
    if name == "opt":
      raise AttributeError(name)
    return getattr(self.opt, name)

  @property
  def state(self):
    """The optimizer state, host moments complete: waits for the last
    step's copies back (only a reader of the moments pays it)."""
    if self._copied_back is not None:
      self._copied_back.synchronize()
      self._copied_back = None
    return self.opt.state

  @property
  def num_buckets(self) -> int:
    return len(self._buckets)

  def _ensure_host_state(self) -> None:
    """Moments on the host for every parameter (created as zeros, as
    the optimizer's first step would, or moved off the device after a
    restore rebuilt them there); the per-parameter step where the
    optimizer keeps it."""
    st_all = self.opt.state
    if len(self._host) == len(self._params) and all(
        st_all.get(p, {}).get("exp_avg") is m
        and st_all[p].get("exp_avg_sq") is v
        for p, (m, v) in self._host.items()):
      return
    on_device = any(g.get("fused") or g.get("capturable")
                    for g in self.opt.param_groups)
    for p in self._params:
      st = st_all[p]
      if "step" not in st:
        st["step"] = torch.zeros(
            (), dtype=torch.float32,
            device=p.device if on_device else "cpu")
      for key in _MOMENTS:
        cur = st.get(key)
        if cur is not None and cur.device.type == "cpu" and (
            cur.is_pinned() or not self.pin):
          continue
        # The parameter's layout (a transposed view stays one): the
        # optimizer's kernels walk a moment as they walk its parameter.
        host = torch.empty_like(p, device="cpu", pin_memory=self.pin)
        if cur is None:
          host.zero_()
        else:
          host.copy_(cur)
        st[key] = host
      self._host[p] = (st["exp_avg"], st["exp_avg_sq"])

  # ----------------------------------------------------------------- step

  def _views(self, buf: torch.Tensor, bucket) -> List[List[torch.Tensor]]:
    """Each parameter's two moments as views of ``buf``, in the
    parameter's layout (the host moments' too)."""
    out, off = [[], []], 0
    for p in bucket:
      n = p.numel()
      stride = torch.empty_like(p, device="meta").stride()
      for k in range(2):
        out[k].append(buf[k, off:off + n].as_strided(
            p.shape, stride, buf.storage_offset() + k * buf.stride(0) + off))
      off += n
    return out

  @torch.no_grad()
  def step(self, closure=None):
    if closure is not None:
      raise ValueError("HostOffloadOptimizer.step takes no closure")
    # No wait on the host: the copies in follow the last step's copies
    # back on the side streams.
    self._ensure_host_state()
    st = self.opt.state
    live = [b for b in self._buckets if any(p.grad is not None for p in b)]
    grads = {p: p.grad for p in self._params}
    opt = self.opt
    opt.found_inf, opt.grad_scale = self.found_inf, self.grad_scale
    cuda = self._h2d is not None
    main = torch.cuda.current_stream(self.device) if cuda else None
    if cuda:
      # This step's copies in read what the last step copied back, into
      # buffers free once those copies are done: they may start while
      # the compute stream still runs the backward.
      self._h2d.wait_stream(self._d2h)
    ready: Dict[int, object] = {}
    freed: Dict[int, object] = {}

    def on(stream):
      return torch.cuda.stream(stream) if cuda else contextlib.nullcontext()

    def copy_in(i):
      k = i % 2
      views = self._views(self._bufs[k], live[i])
      with on(self._h2d):
        if k in freed:
          self._h2d.wait_event(freed.pop(k))
        for m, key in enumerate(_MOMENTS):
          for v, p in zip(views[m], live[i]):
            v.copy_(st[p][key], non_blocking=cuda)
        if cuda:
          ready[i] = self._h2d.record_event()

    try:
      for i in range(min(2, len(live))):
        copy_in(i)
      for i, bucket in enumerate(live):
        k = i % 2
        views = self._views(self._bufs[k], bucket)
        members = {id(p) for p in bucket}
        if cuda:
          main.wait_event(ready.pop(i))
        hosts = {}
        for p in self._params:
          if id(p) in members:
            hosts[p] = (st[p]["exp_avg"], st[p]["exp_avg_sq"])
          else:
            p.grad = None
        for j, p in enumerate(bucket):
          st[p]["exp_avg"], st[p]["exp_avg_sq"] = views[0][j], views[1][j]
        opt.step()
        for p, (m, v) in hosts.items():
          st[p]["exp_avg"], st[p]["exp_avg_sq"] = m, v
        for p in self._params:
          p.grad = grads[p]
        with on(self._d2h):
          if cuda:
            self._d2h.wait_event(main.record_event())
          for j, p in enumerate(bucket):
            hosts[p][0].copy_(views[0][j], non_blocking=cuda)
            hosts[p][1].copy_(views[1][j], non_blocking=cuda)
          if cuda:
            freed[k] = self._d2h.record_event()
        if i + 2 < len(live):
          copy_in(i + 2)
    finally:
      for p in self._params:
        p.grad = grads[p]
      opt.found_inf = opt.grad_scale = None
    if cuda:
      self._copied_back = self._d2h.record_event()
    return None


def offload_to_host(state, what: str = "opt_state"):
  """``state`` with its optimizer moments in pinned host memory
  (``what="opt_state"``, the JAX package's default: the reference's
  ``offload.level = "v0"``).  On a CPU state there is no other memory:
  a warning, and the state unchanged.  ``"params"`` / ``"all"`` raise:
  the port's forward and backward run on the card's parameters."""
  if what != "opt_state":
    raise ValueError(
        f"offload_to_host(what={what!r}): the port offloads the optimizer "
        f"state only (what='opt_state'); parameters and gradients stay on "
        f"the card")
  opt = state.opt_state
  if isinstance(opt, HostOffloadOptimizer):
    return state
  device = next(iter(state.params.values())).device
  if device.type != "cuda":
    get_logger().warning(
        "offload requested but the state lives on %s: host and device "
        "are one; state unchanged", device)
    return state
  wrapped = HostOffloadOptimizer(opt)
  get_logger().info(
      "offload: AdamW moments in %s memory, streamed in %d bucket(s) of "
      "<= %.0f MB through two device buffers", HOST_MEMORY_KIND,
      wrapped.num_buckets, wrapped.bucket_bytes / 2 ** 20)
  return state.replace(opt_state=wrapped)
