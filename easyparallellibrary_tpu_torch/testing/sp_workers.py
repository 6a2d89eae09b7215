"""Rank programs for the MoE, sequence-parallel and pipeline-ZeRO parity
tests and ``chip_smoke.py`` phase 23.

Each function runs on one rank of ``utils.launcher.spawn``
(``fn(rank, world_size, *args)``), numpy in and numpy out, and imports
nothing of JAX.  Whole arrays go in; each rank takes its slice (its
tokens over ``seq``, its rows over ``expert`` under the a2a MoE, its
experts and tensor-parallel blocks) and returns its slice's results
with its mesh coordinates.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch.testing.tp_workers import (
    gpt_config, setup, to_numpy, to_torch)

AXES = ("stage", "data", "seq", "expert", "model")


def _coords(mesh) -> dict:
  return {a: mesh.axis_index(a) for a in AXES}


def attention(rank, world, mesh_shape: str, config: dict, impl: str,
              causal: bool, q, k, v, dout, num_blocks: Optional[int] = None,
              manual: bool = False, device: str = "cpu",
              backend: Optional[str] = None):
  """Ring (``impl="ring"``) or Ulysses attention of this rank's token
  slice of the global ``[B, S, H, D]`` q, k, v, and the gradients of
  ``sum(out * dout)`` (each rank's own slice of ``dout``): the local
  output and dq, dk, dv, and the flash forward's calls (the plain
  version's on the CPU, the kernel's launches on the card)."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.sequence import (
      ring_attention, ulysses_attention)
  mesh = setup(mesh_shape, device=device, backend=backend, config=config)
  n, i = mesh.axis_size("seq"), mesh.axis_index("seq")
  s = q.shape[1] // n

  def local(a, grad=True):
    t = torch.from_numpy(np.ascontiguousarray(a[:, i * s:(i + 1) * s]))
    return t.to(mesh.device).requires_grad_(grad)

  ql, kl, vl = local(q), local(k), local(v)
  fa.reset_counts()
  if impl == "ring":
    out = ring_attention(ql, kl, vl, causal=causal, num_blocks=num_blocks,
                         manual=manual)
  else:
    out = ulysses_attention(ql, kl, vl, causal=causal, manual=manual)
  calls = (fa.flash_fwd_cuda.launches if mesh.device.type == "cuda"
           else fa.flash_fwd_reference.calls)
  (out * local(dout, False)).sum().backward()
  return {"out": to_numpy(out), "dq": to_numpy(ql.grad),
          "dk": to_numpy(kl.grad), "dv": to_numpy(vl.grad),
          "fwd_calls": calls, "coords": _coords(mesh)}


def _moe_params(params: Dict[str, np.ndarray], mesh, cfg):
  """This rank's router (whole) and its experts' slices."""
  ep, e = mesh.axis_size("expert"), mesh.axis_index("expert")
  tp = mesh.axis_size("model") if cfg.tensor_parallel else 1
  m = mesh.axis_index("model")
  el, fl = cfg.num_experts // ep, cfg.d_ff // tp
  wi = params["wi"][e * el:(e + 1) * el, :, m * fl:(m + 1) * fl]
  wo = params["wo"][e * el:(e + 1) * el, m * fl:(m + 1) * fl]
  return {k: torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
          for k, a in (("router_kernel", params["router_kernel"]),
                       ("wi", wi), ("wo", wo))}


def moe_layer(rank, world, mesh_shape: str, cfg_kwargs: dict, impl: str,
              top_k: int, params: Dict[str, np.ndarray], x, dout,
              aux_weight: float):
  """One ``MoEMLP`` on this rank: the a2a path on this rank's rows of
  ``x [B, S, D]`` (split over ``expert``), the einsum path on this
  rank's rows over ``data`` and tokens over ``seq`` (every token where
  neither splits them), routed as one group with the other ranks'.  The
  objective is JAX's ``sum(out * dout) + aux_weight * aux`` written as a
  mean over the ranks that split the tokens, its gradients reduced as
  the train step reduces them (``parallel.api._reduce_grads``).  Returns
  the rank's output block, the aux loss, the tokens it dropped, the
  gradients of its parameter slices and of its block of ``x`` (of the
  global objective)."""
  from torch.func import functional_call

  from easyparallellibrary_tpu_torch.models.moe import MoEMLP
  from easyparallellibrary_tpu_torch.parallel.api import _reduce_grads
  mesh = setup(mesh_shape)
  cfg = gpt_config(cfg_kwargs,
                   tensor_parallel=mesh.axis_size("model") > 1)
  layer = MoEMLP(cfg, top_k=top_k, impl=impl, device="meta")
  p = _moe_params(params, mesh, cfg)
  row_axis = "expert" if impl == "a2a" else "data"
  splits = [a for a in (row_axis, "seq") if mesh.axis_size(a) > 1]
  if impl == "einsum":
    layer.split_axes = tuple(splits)
  block = [slice(None), slice(None)]
  for dim, axis in enumerate((row_axis, "seq")):
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    size = x.shape[dim] // n
    block[dim] = slice(i * size, (i + 1) * size)
  block = tuple(block)
  xl = torch.from_numpy(np.ascontiguousarray(x[block])).requires_grad_(True)
  out, aux = functional_call(layer, p, (xl,))
  scale = int(np.prod([mesh.axis_size(a) for a in splits]))
  obj = (out * torch.from_numpy(np.ascontiguousarray(dout[block]))
         ).sum() * scale + aux_weight * aux
  obj.backward()
  specs = {k: v for k, v in layer.param_specs().items()}
  _reduce_grads(p, mean_axes=tuple(splits), specs=specs)
  return {"out": to_numpy(out), "aux": float(aux),
          "dropped": int(layer.last_dropped),
          "grads": to_numpy({k: t.grad for k, t in p.items()}),
          "dx": to_numpy(xl.grad) / scale, "coords": _coords(mesh)}


def dispatch(rank, world, mesh_shape: str, probs, top_k: int,
             capacity: int):
  """``models.moe._top_k_dispatch`` of this rank's block of the global
  router probabilities ``probs [B, S, E]`` (its rows over ``data``, its
  tokens over ``seq``), routed as one group with the other ranks' at
  ``capacity``: its dispatch, combine and choice masks, and its
  coordinates."""
  from easyparallellibrary_tpu_torch.models.moe import _top_k_dispatch
  mesh = setup(mesh_shape)
  axes = tuple(a for a in ("data", "seq") if mesh.axis_size(a) > 1)
  block = []
  for dim, axis in enumerate(("data", "seq")):
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    size = probs.shape[dim] // n
    block.append(slice(i * size, (i + 1) * size))
  local = torch.from_numpy(np.ascontiguousarray(probs[tuple(block)]))
  rows, length, E = local.shape
  masks = _top_k_dispatch(local.reshape(rows * length, E), top_k, E,
                          capacity, torch.float32, rows=rows, axes=axes)
  return {"masks": [m.reshape(rows, length, *m.shape[1:]).numpy()
                    for m in masks], "coords": _coords(mesh)}


def whole_masks(ranks):
  """The :func:`dispatch` ranks' blocks put back into the global batch's
  ``[B, S, ...]`` masks (rows over data, tokens over seq)."""
  ranks = sorted(ranks, key=lambda r: (r["coords"]["data"],
                                       r["coords"]["seq"]))
  n_seq = 1 + max(r["coords"]["seq"] for r in ranks)
  out = []
  for i in range(3):
    rows = [np.concatenate([r["masks"][i] for r in ranks[j:j + n_seq]],
                           axis=1) for j in range(0, len(ranks), n_seq)]
    out.append(np.concatenate(rows))
  return out


def gpt_grads(rank, world, mesh_shape: str, config: dict, cfg_kwargs: dict,
              params: Dict[str, np.ndarray], ids):
  """``gpt_loss`` of the (non-pipelined) GPT on ``mesh_shape`` and its
  gradients, reduced as the train step reduces them
  (``parallel.api.reduce_gradients``): the mean loss, the metrics and
  the rank's parameter slices' gradients."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT, gpt_loss
  from easyparallellibrary_tpu_torch.parallel.api import (
      local_batch, mean_loss, reduce_gradients)
  from easyparallellibrary_tpu_torch.weights import shard_params
  mesh = setup(mesh_shape, config=config)
  model = GPT(gpt_config(cfg_kwargs,
                         tensor_parallel=mesh.axis_size("model") > 1))
  local = shard_params(to_torch(params, mesh.device), model)
  for t in local.values():
    t.requires_grad_(True)
  loss, metrics = gpt_loss(model, local,
                           local_batch({"ids": ids}, mesh))
  loss.backward()
  reduce_gradients(local, "mean", model=model)
  return {"loss": float(mean_loss(loss, model)),
          "metrics": {k: float(v) for k, v in metrics.items()},
          "grads": to_numpy({k: t.grad for k, t in local.items()}),
          "coords": _coords(mesh)}


def raises(rank, world):
  """The message of each refused sequence-parallel call on a ``seq``
  axis of ``world`` ranks (empty when nothing was raised): Ulysses over
  heads the axis does not divide, the einsum ring inside a stage
  program, ring blocks that do not divide the sequence, and the smap
  engine's guard on Ulysses heads."""
  from easyparallellibrary_tpu_torch.parallel.pipeline_smap import (
      seq_manual_mode)
  from easyparallellibrary_tpu_torch.sequence import (
      ring_attention, ulysses_attention)
  setup(f"seq:{world}", config={"sequence.ring_impl": "einsum"})
  x = torch.zeros(1, 4, world + 1, 8)
  y = torch.zeros(1, 4, 2 * world, 8)
  calls = {"ulysses_heads": lambda: ulysses_attention(x, x, x),
           "ring_manual_einsum": lambda: ring_attention(y, y, y,
                                                        manual=True),
           "ring_blocks": lambda: ring_attention(y, y, y, num_blocks=3),
           "smap_ulysses": lambda: seq_manual_mode("ulysses", world + 1),
           "smap_einsum_ring": lambda: seq_manual_mode("ring", 4)}
  out = {}
  for key, fn in calls.items():
    try:
      fn()
      out[key] = ""
    except ValueError as e:
      out[key] = str(e)
  return out


def suite(rank, world, cases):
  """Several of the parity programs in one group of ranks (each rank
  started once): ``cases`` is ``[(name, args)]``, ``name`` one of
  ``attention``, ``moe_layer``, ``dispatch``, ``gpt_grads``, ``raises``
  and ``pp_workers``' ``grads`` / ``train``.  Returns each case's
  result, in order."""
  from easyparallellibrary_tpu_torch.testing import pp_workers
  programs = {"attention": attention, "moe_layer": moe_layer,
              "dispatch": dispatch, "gpt_grads": gpt_grads, "raises": raises,
              "grads": pp_workers.grads, "train": pp_workers.train}
  return [programs[name](rank, world, *args) for name, args in cases]


# ------------------------------------------------------- the card's phase


def long_context_params(flat, max_seq_len: int, seed: int):
  """A GPT's weights at a longer ``max_seq_len`` from ``flat`` (a
  shorter one's, on the host): the position table's first rows kept, the
  rest drawn ``normal(0.02)`` from ``seed``."""
  wpe = flat["wpe"]
  extra = np.random.default_rng(seed).standard_normal(
      (max_seq_len - wpe.shape[0], wpe.shape[1]), dtype=np.float32) * 0.02
  out = dict(flat)
  out["wpe"] = torch.cat([wpe, torch.from_numpy(extra).to(wpe.device)])
  return out


def _train_run(mesh, model, local, batch, steps: int, dev):
  """``steps`` AdamW(3e-4, wd 0.01) steps of ``model`` from ``local``
  through ``create_sharded_train_state`` and ``parallelize(
  make_gpt_train_step(model))``: the losses, each step's ms, the MoE
  tokens dropped at step 1, the peak memory, K1's launches and the plain
  versions' calls over the steps, the bytes staged through the host a
  step, the optimizer's moment bytes (all, and the expert weights'),
  and the state."""
  import time

  from easyparallellibrary_tpu_torch.communicators import collectives
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.models.gpt import make_gpt_train_step
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel.api import (
      TrainState, create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.runtime.zero import moment_bytes
  torch.backends.cuda.matmul.allow_tf32 = False
  state, shardings = create_sharded_train_state(
      lambda: TrainState.create(apply_fn=model, params=local,
                                tx=adamw(3e-4, weight_decay=0.01)), mesh)
  run = parallelize(make_gpt_train_step(model), mesh, shardings)
  moe = [m for m in model.modules() if hasattr(m, "last_dropped")]
  data = {"ids": torch.from_numpy(np.asarray(batch))}
  torch.cuda.synchronize(dev)
  torch.cuda.reset_peak_memory_stats(dev)
  fa.reset_counts()
  collectives.staged_bytes = 0
  losses, ms, dropped = [], [], None
  for i in range(steps):
    t0 = time.perf_counter()
    state, m = run(state, data, None)
    losses.append(float(m["loss"]))
    torch.cuda.synchronize(dev)
    ms.append((time.perf_counter() - t0) * 1e3)
    if i == 0 and moe:
      dropped = int(sum(int(x.last_dropped) for x in moe))
  experts = {id(p) for n, p in state.params.items()
             if n.endswith(("moe.wi", "moe.wo"))}
  owners = state.zero.owners if state.zero is not None else state.params
  expert_owner = {id(owners[n]) for n, p in state.params.items()
                  if id(p) in experts}
  ex_bytes = sum(v.numel() * v.element_size()
                 for p, st in state.opt_state.state.items()
                 if id(p) in expert_owner
                 for v in st.values() if torch.is_tensor(v) and v.dim())
  return {"losses": losses, "step_ms": ms, "dropped_step1": dropped,
          "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "launches": {"fwd": fa.flash_fwd_cuda.launches,
                       "dkv": fa.flash_bwd_dkv_cuda.launches,
                       "dq": fa.flash_bwd_dq_cuda.launches},
          "plain_calls": fa.flash_fwd_reference.calls
          + fa.flash_bwd_dkv_reference.calls + fa.flash_bwd_dq_reference.calls,
          "staged_bytes_per_step": collectives.staged_bytes / steps,
          "moment_bytes": moment_bytes(state.opt_state),
          "expert_moment_bytes": ex_bytes}, state


def moe_forward_probe(model, params, ids):
  """One forward of ``gpt_loss`` of the GPT-MoE ``model`` from
  ``params`` on ``ids`` (this rank's rows of it), no gradient: each MoE
  block's output (on the host), the tokens each dropped, the aux loss
  and the cross-entropy (the loss less the weighted aux)."""
  from easyparallellibrary_tpu_torch.models.gpt import gpt_loss
  from easyparallellibrary_tpu_torch.models.moe import MoEMLP
  moe = [m for m in model.modules() if isinstance(m, MoEMLP)]
  outs = []
  hooks = [m.register_forward_hook(
      lambda mod, args, out: outs.append(out[0].detach().cpu()))
           for m in moe]
  try:
    with torch.no_grad():
      loss, metrics = gpt_loss(model, params, {"ids": ids})
  finally:
    for h in hooks:
      h.remove()
  aux = float(metrics["moe_aux_loss"])
  return {"outs": outs, "dropped": [int(m.last_dropped) for m in moe],
          "aux": aux, "ce": float(loss) - model.cfg.moe_aux_weight * aux}


def _per_source_check(got, want):
  """The a2a rank's :func:`moe_forward_probe` against the one-card einsum
  run's on the same rows: each MoE block's output error (normalized L2
  and max abs, fp32), the drops of both, and the cross-entropy's
  relative gap."""
  rel, mx = [], []
  for a, b in zip(got["outs"], want["outs"]):
    a, b = a.float(), b.float()
    rel.append(float((a - b).norm() / b.norm()))
    mx.append(float((a - b).abs().max()))
  return {"out_rel_l2": rel, "out_max_abs": mx,
          "dropped": got["dropped"], "dropped_ref": want["dropped"],
          "ce": got["ce"], "ce_ref": want["ce"],
          "ce_rel": abs(got["ce"] - want["ce"]) / abs(want["ce"])}


def chip_moe_a2a(rank, world, backend: str, spec: dict,
                 device: str = "cuda"):
  """Phase 23b on a rank: the GPT-MoE of ``spec["cfg"]`` as
  ``moe_impl="a2a"`` on ``expert:world`` from the whole weights saved at
  ``spec["weights"]`` (``torch.save``; this rank's cut of them),
  ``spec["steps"]`` steps on ``spec["batch"]`` (this rank's rows of
  it).  First one forward held against the one-card einsum run on this
  rank's rows alone (``spec["reference"]``, by expert rank: its
  capacity is this rank's per-source one, so the routing is the same;
  :func:`_per_source_check`)."""
  import gc

  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.weights import shard_params
  mesh = setup(f"expert:{world}", device=device, backend=backend)
  dev = mesh.device
  model = GPT(gpt_config(dict(spec["cfg"], moe_impl="a2a")))
  whole = torch.load(spec["weights"], map_location="cpu", mmap=True)
  local = {k: v.to(dev) for k, v in shard_params(whole, model).items()}
  del whole
  ids = torch.from_numpy(np.asarray(spec["batch"])).to(dev)
  want = torch.load(spec["reference"], map_location="cpu")[
      mesh.axis_index("expert")]
  check = _per_source_check(moe_forward_probe(model, local, ids), want)
  del want
  out, state = _train_run(mesh, model, local, spec["batch"], spec["steps"],
                          dev)
  out["per_source"] = check
  del state, local
  gc.collect()
  torch.cuda.empty_cache()
  out["coords"] = _coords(mesh)
  return out


def chip_sequence(rank, world, backend: str, spec: dict, device: str = "cuda",
                  flat=None):
  """Phase 23c on a rank: ``spec["runs"]`` (``[(name, attn_impl,
  ring_layout)]``) each train ``spec["cfg"]`` on ``seq:world`` with
  ``seq_parallel=True`` from ``flat`` (``init_params(spec["seed"])`` of
  GPT-350M, drawn here when None) at ``spec["cfg"]``'s ``max_seq_len``
  (:func:`long_context_params`), ``spec["steps"]`` steps on
  ``spec["batch"]``.  Per run: :func:`_train_run`'s record and K1's
  launch formula (``sequence.ring_attention.launches_per_layer`` a layer
  for the ring, one launch a layer for Ulysses)."""
  import gc

  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.sequence.ring_attention import (
      _zigzag_applies, launches_per_layer)
  from easyparallellibrary_tpu_torch.weights import init_params
  cfg_kwargs = spec["cfg"]
  if flat is None:
    flat = init_params(gpt_config(dict(cfg_kwargs, max_seq_len=1024)),
                       spec["seed"], device="cpu")
  params = long_context_params(flat, cfg_kwargs["max_seq_len"],
                               spec["wpe_seed"])
  out = {}
  for name, attn, layout in spec["runs"]:
    mesh = setup(f"seq:{world}", device=device, backend=backend, config={
        "sequence.ring_impl": "flash", "sequence.ring_layout": layout,
        "sequence.ulysses_impl": "flash"})
    dev = mesh.device
    cfg = gpt_config(dict(cfg_kwargs, attn_impl=attn, seq_parallel=True))
    model = GPT(cfg)
    local = {k: v.to(dev) for k, v in params.items()}
    rec, state = _train_run(mesh, model, local, spec["batch"],
                            spec["steps"], dev)
    n, i = mesh.axis_size("seq"), mesh.axis_index("seq")
    s_loc = cfg.max_seq_len // n
    if attn == "ring":
      zigzag = _zigzag_applies(True, n, s_loc, cfg.d_model // cfg.num_heads,
                               cfg.dtype, False)
      per_layer = launches_per_layer(n, i, True, zigzag)
      rec["zigzag"] = zigzag
    else:
      per_layer = 1
    rec["formula"] = per_layer * cfg.num_layers * spec["steps"]
    out[name] = rec
    del state, local, model
    gc.collect()
    torch.cuda.empty_cache()
  return {"runs": out, "coords": _coords(mesh)}


def chip_pipeline_zero(rank, world, backend: str, spec: dict,
                       device: str = "cuda"):
  """Phase 23d on a rank of ``stage:2,data:2``: ``spec["cfg"]`` pipelined
  over 2 stages of ``spec["M"]`` micro-batches on the smap 1F1B engine
  without ZeRO, then under ``zero.level`` v1 and v0, each from
  ``init_params(spec["seed"])`` for ``spec["steps"]`` steps on
  ``spec["batch"]``.  Per run: :func:`_train_run`'s record and the
  schedule's launch formula."""
  import gc

  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.weights import (
      init_params, shard_params, stack_stages)
  flat = init_params(gpt_config(spec["cfg"]), spec["seed"], device="cpu")
  out = {}
  for level in ("", "v1", "v0"):
    mesh = setup("stage:2,data:2", device=device, backend=backend, config={
        "pipeline.engine": "smap", "pipeline.strategy": "PreferBackward",
        "zero.level": level})
    dev = mesh.device
    cfg = gpt_config(dict(spec["cfg"], pipeline_stages=2,
                          num_micro_batch=spec["M"]))
    model = GPT(cfg)
    local = {k: v.to(dev) for k, v in shard_params(
        stack_stages(flat, cfg), model).items()}
    rec, state = _train_run(mesh, model, local, spec["batch"],
                            spec["steps"], dev)
    from easyparallellibrary_tpu_torch.parallel.schedule_1f1b import (
        one_f_one_b_schedule)
    sched = one_f_one_b_schedule(2, spec["M"])
    rec["formula"] = {k: v * spec["steps"] for k, v in
                      sched.launches_per_rank(cfg.num_layers // 2).items()}
    out[level or "none"] = rec
    del state, local, model
    gc.collect()
    torch.cuda.empty_cache()
  return {"runs": out, "coords": _coords(mesh)}
