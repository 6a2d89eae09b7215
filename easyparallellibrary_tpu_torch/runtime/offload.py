"""Host offload of the optimizer state and the parameters (port of
``easyparallellibrary_tpu/runtime/offload.py``).

The JAX package places the optimizer state, the parameters or both in
the chip's host memory (``memory_kind="pinned_host"``) and lets XLA
stream them around the ops that need them.  Here
:func:`offload_to_host` does it by hand:

* ``what="opt_state"`` (the default; the reference's ``offload.level =
  "v0"``): the AdamW moments (``exp_avg``, ``exp_avg_sq``) live in
  pinned host memory, parameters and gradients stay on the card.
* ``what="params"``: every block's parameters (the model's ``block_<i>``
  children) live in pinned host memory as the optimizer's leaves; the
  embeddings, the final norm and the head stay on the card.
  :class:`ParamStreamer` copies a block's parameters to the card when
  the block's forward starts and drops them when it ends, so they are on
  the card around that block's forward, and again around its backward
  where the block is recomputed (``remat``, bench.py's step); without
  remat the ops keep what they save for the backward.  Each copy's
  backward returns its gradient to the host parameter.
* ``what="all"``: both.

:class:`HostOffloadOptimizer` runs the update: the streamed fields of a
parameter (its moments, its value and gradient, or all four) go through
two flat device buffers of at most ``bucket_mb`` (or the largest
parameter's fields): bucket ``i + 1`` is copied in on one side stream while bucket
``i`` is stepped on the compute stream by the optimizer's own (fused)
kernel and copied back on another, so the update is bit-equal to the
same optimizer without offload, and the card holds two buckets instead
of all of them.  A parameter with nothing streamed is stepped in place.

The moments' step never waits on the host: a reader of the host moments
(the saver, through ``state``) waits for the last copy back first.
Streamed parameters are read by the next forward on the compute stream
and by the saver on the host, so a step that streams parameters ends by
waiting for its copies back.  On a CPU state host and device are one, so
:func:`offload_to_host` changes nothing there (the JAX package's CPU
behaviour); the classes themselves also run on the CPU, with
synchronous copies.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional

import torch

from easyparallellibrary_tpu_torch.utils.logging import get_logger

HOST_MEMORY_KIND = "pinned_host"
# Streamed fields per device buffer (two buffers): a bucket is raised to
# the largest parameter's fields when that is more.
DEFAULT_BUCKET_MB = 256

_MOMENTS = ("exp_avg", "exp_avg_sq")
_WHAT = ("opt_state", "params", "all")


class HostOffloadOptimizer:
  """``opt`` (a torch AdamW, fused or not) with its moments
  (``moments=True``) and the parameters in ``offloaded`` in host memory,
  stepped bucket by bucket through device buffers (module docstring).
  Everything else — ``param_groups`` (the learning-rate backoff scales
  them), ``found_inf`` (the sentinel's skip), ``inject_hyperparams`` —
  is ``opt``'s.  ``device`` is where the update runs (default: the
  parameters' device); host tensors are pinned when it is the card."""

  def __init__(self, opt: torch.optim.Optimizer,
               bucket_mb: float = DEFAULT_BUCKET_MB, moments: bool = True,
               offloaded: Iterable[torch.Tensor] = (), device=None):
    params = [p for g in opt.param_groups for p in g["params"]]
    if not params:
      raise ValueError("HostOffloadOptimizer: the optimizer has no "
                       "parameters")
    offloaded_ids = {id(p) for p in offloaded}
    dtypes = {p.dtype for p in params}
    resident = {p.device for p in params if id(p) not in offloaded_ids}
    if device is None:
      device = (next(iter(resident)) if resident
                else torch.device("cuda", torch.cuda.current_device()))
    device = torch.device(device)
    if len(dtypes) != 1 or resident - {device}:
      raise ValueError(f"HostOffloadOptimizer streams one dtype, its "
                       f"resident parameters on one device; got "
                       f"{sorted(map(str, dtypes))} on "
                       f"{sorted(map(str, resident))}")
    object.__setattr__(self, "opt", opt)
    self.device = device
    self.dtype = params[0].dtype
    self.pin = self.device.type == "cuda"
    self.moments = bool(moments)
    self.found_inf = None
    self.grad_scale = None
    self._params = params
    self._offloaded = offloaded_ids
    self._host: Dict[torch.Tensor, tuple] = {}
    self._ensure_host_state()
    item = torch.empty((), dtype=self.dtype).element_size()
    streamed = [p for p in params if self._fields(p)]
    self._direct = [p for p in params if not self._fields(p)]
    self.nfields = max((len(self._fields(p)) for p in streamed), default=0)

    def size(p):
      return p.numel() * len(self._fields(p))

    # Contiguous buckets by the elements of their streamed fields.
    self._buckets: List[List[torch.Tensor]] = []
    if streamed:
      limit = max(int(bucket_mb * 2 ** 20) // item,
                  max(size(p) for p in streamed))
      cur, total = [], 0
      for p in streamed:
        if cur and total + size(p) > limit:
          self._buckets.append(cur)
          cur, total = [], 0
        cur.append(p)
        total += size(p)
      self._buckets.append(cur)
    numel = max((sum(size(p) for p in b) for b in self._buckets), default=0)
    # Two flat buffers: a bucket's fields one after another.
    self._bufs = [torch.empty((numel,), dtype=self.dtype, device=self.device)
                  for _ in range(2 if streamed else 0)]
    self.bucket_bytes = numel * item
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

  def _fields(self, p) -> tuple:
    """What of ``p`` streams: its value and gradient when it lives on the
    host, its moments when they do."""
    return ((("param", "grad") if id(p) in self._offloaded else ())
            + (_MOMENTS if self.moments else ()))

  def _ensure_host_state(self) -> None:
    """Moments where they belong for every parameter (created as zeros,
    as the optimizer's first step would, on the host when offloaded and
    on the device otherwise, or moved after a restore rebuilt them
    elsewhere); the per-parameter step where the optimizer keeps it."""
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
            device=self.device if on_device else "cpu")
      for key in _MOMENTS:
        cur = st.get(key)
        if self.moments:
          if cur is not None and cur.device.type == "cpu" and (
              cur.is_pinned() or not self.pin):
            continue
          # The parameter's layout (a transposed view stays one): the
          # optimizer's kernels walk a moment as they walk its parameter.
          new = torch.empty_like(p, device="cpu", pin_memory=self.pin)
        else:
          if cur is not None and cur.device == self.device:
            continue
          new = torch.empty_like(p, device=self.device)
        if cur is None:
          new.zero_()
        else:
          new.copy_(cur)
        st[key] = new
      self._host[p] = (st["exp_avg"], st["exp_avg_sq"])

  # ----------------------------------------------------------------- step

  def _views(self, buf: torch.Tensor, bucket) -> List[Dict[str, torch.Tensor]]:
    """Each parameter's streamed fields as views of ``buf``, one after
    another, in the parameter's layout (the host tensors' too)."""
    out, off = [], 0
    for p in bucket:
      n = p.numel()
      stride = torch.empty_like(p, device="meta").stride()
      views = {}
      for field in self._fields(p):
        views[field] = buf.as_strided(p.shape, stride,
                                      buf.storage_offset() + off)
        off += n
      out.append(views)
    return out

  @torch.no_grad()
  def step(self, closure=None):
    if closure is not None:
      raise ValueError("HostOffloadOptimizer.step takes no closure")
    self._ensure_host_state()
    st = self.opt.state
    grads = {p: p.grad for p in self._params}
    opt = self.opt
    opt.found_inf, opt.grad_scale = self.found_inf, self.grad_scale
    cuda = self._h2d is not None
    main = torch.cuda.current_stream(self.device) if cuda else None

    def on(stream):
      return torch.cuda.stream(stream) if cuda else contextlib.nullcontext()

    def only(members):
      """Hide every gradient but ``members``' from the optimizer."""
      for p in self._params:
        if id(p) not in members:
          p.grad = None

    try:
      if self._direct and any(grads[p] is not None for p in self._direct):
        only({id(p) for p in self._direct})
        opt.step()
        for p in self._params:
          p.grad = grads[p]
      live = [b for b in self._buckets
              if any(grads[p] is not None for p in b)]
      if cuda and live:
        # This step's copies in read what the last step copied back,
        # into buffers free once those copies are done: they may start
        # while the compute stream still runs the backward.
        self._h2d.wait_stream(self._d2h)
      ready: Dict[int, object] = {}
      freed: Dict[int, object] = {}

      def source(p, field):
        if field == "param":
          return p.data
        if field == "grad":
          return grads[p]
        return st[p][field]

      def copy_in(i):
        k = i % 2
        views = self._views(self._bufs[k], live[i])
        with on(self._h2d):
          if k in freed:
            self._h2d.wait_event(freed.pop(k))
          for v, p in zip(views, live[i]):
            for field, view in v.items():
              if field == "grad" and grads[p] is None:
                continue
              view.copy_(source(p, field), non_blocking=cuda)
          if cuda:
            ready[i] = self._h2d.record_event()

      for i in range(min(2, len(live))):
        copy_in(i)
      for i, bucket in enumerate(live):
        k = i % 2
        views = self._views(self._bufs[k], bucket)
        if cuda:
          main.wait_event(ready.pop(i))
        only({id(p) for p in bucket})
        hosts = {}
        for v, p in zip(views, bucket):
          hosts[p] = {f: source(p, f) for f in v if f != "grad"}
          if "param" in v:
            p.data = v["param"]
            p.grad = v["grad"] if grads[p] is not None else None
          for key in _MOMENTS:
            if key in v:
              st[p][key] = v[key]
        opt.step()
        for p, host in hosts.items():
          if "param" in host:
            p.data = host["param"]
          for key in _MOMENTS:
            if key in host:
              st[p][key] = host[key]
        for p in self._params:
          p.grad = grads[p]
        with on(self._d2h):
          if cuda:
            self._d2h.wait_event(main.record_event())
          for v, p in zip(views, bucket):
            for field, host in hosts[p].items():
              host.copy_(v[field], non_blocking=cuda)
          if cuda:
            freed[k] = self._d2h.record_event()
        if i + 2 < len(live):
          copy_in(i + 2)
    finally:
      for p in self._params:
        p.grad = grads[p]
      opt.found_inf = opt.grad_scale = None
    if cuda and live:
      self._copied_back = self._d2h.record_event()
      if self._offloaded:
        # The next forward reads the updated host parameters on the
        # compute stream, and the saver on the host.
        main.wait_stream(self._d2h)
        self._copied_back.synchronize()
        self._copied_back = None
    return None


# ---------------------------------------------------------- the forward


class _StreamIn(torch.autograd.Function):
  """A host parameter's copy on ``device`` (always a copy, so the host
  leaf is never aliased); its backward hands the gradient to the host."""

  @staticmethod
  def forward(ctx, host, device):
    ctx.host_device = host.device
    return host.to(device, non_blocking=True, copy=True)

  @staticmethod
  def backward(ctx, grad):
    return grad.to(ctx.host_device), None


def block_names(model) -> List[str]:
  """The model's ``block_<i>`` children, the units a parameter offload
  streams."""
  return [name for name, _ in model.named_children()
          if name.startswith("block_")]


class ParamStreamer:
  """Streams the host parameters of ``model``'s blocks to ``device``
  around each block's forward (module docstring): a forward pre-hook on
  each ``block_<i>`` puts ``device`` copies of its host (CPU) parameters
  in the parameters' places, a forward hook puts the host tensors back.  Under
  ``torch.func.functional_call`` the places are the call's tensors, so
  the hooks act on whatever the step passes in."""

  def __init__(self, model, device):
    self.device = torch.device(device)
    self.streamed_bytes = 0
    self._handles = []
    for name in block_names(model):
      block = getattr(model, name)
      self._handles.append(block.register_forward_pre_hook(self._pre))
      self._handles.append(block.register_forward_hook(self._post))
    self._swapped: List[list] = []

  def _pre(self, block, args):
    swaps = []
    for mod in block.modules():
      for pname, t in list(mod._parameters.items()):
        if t is not None and t.device.type == "cpu":
          mod._parameters[pname] = _StreamIn.apply(t, self.device)
          swaps.append((mod, pname, t))
          self.streamed_bytes += t.numel() * t.element_size()
    self._swapped.append(swaps)

  def _post(self, block, args, output):
    for mod, pname, host in self._swapped.pop():
      mod._parameters[pname] = host
    return output

  def remove(self) -> None:
    for h in self._handles:
      h.remove()
    self._handles = []


def offload_to_host(state, what: str = "opt_state",
                    bucket_mb: float = DEFAULT_BUCKET_MB):
  """``state`` with its optimizer moments (``what="opt_state"``, the JAX
  package's default: the reference's ``offload.level = "v0"``), its
  blocks' parameters (``"params"``) or both (``"all"``) in pinned host
  memory (module docstring).  On a CPU state there is no other memory: a
  warning, and the state unchanged."""
  if what not in _WHAT:
    raise ValueError(f"offload_to_host(what={what!r}): what must be one of "
                     f"{_WHAT}")
  opt = state.opt_state
  if isinstance(opt, HostOffloadOptimizer):
    return state
  device = next(iter(state.params.values())).device
  if device.type != "cuda":
    get_logger().warning(
        "offload requested but the state lives on %s: host and device "
        "are one; state unchanged", device)
    return state
  offloaded = []
  if what in ("params", "all"):
    model = state.apply_fn
    blocks = block_names(model)
    if not blocks or getattr(model.cfg, "pipeline_stages", 1) > 1:
      raise ValueError(
          "offload_to_host(what='params'|'all') streams a model's "
          "block_<i> children; this model has none (a pipelined model "
          "keeps its blocks stacked a stage)")
    prefixes = tuple(f"{b}." for b in blocks)
    for name, p in state.params.items():
      if name.startswith(prefixes):
        # Move the leaf's storage (the optimizer and the state keep the
        # same tensor objects).
        p.data = p.data.to("cpu").pin_memory()
        offloaded.append(p)
  wrapped = HostOffloadOptimizer(opt, bucket_mb=bucket_mb,
                                 moments=what in ("opt_state", "all"),
                                 offloaded=offloaded, device=device)
  if offloaded:
    wrapped.streamer = ParamStreamer(state.apply_fn, device)
  get_logger().info(
      "offload (%s): %d parameters in %s memory; the update streamed in %d "
      "bucket(s) of <= %.0f MB through two device buffers", what,
      len(offloaded), HOST_MEMORY_KIND, wrapped.num_buckets,
      wrapped.bucket_bytes / 2 ** 20)
  return state.replace(opt_state=wrapped)
