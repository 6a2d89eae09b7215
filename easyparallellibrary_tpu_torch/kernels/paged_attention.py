"""Paged attention over a flat token batch: two Hopper CUDA builds, the
query-tile planner of the slot-tiled build, and the plain version.

Port of ``easyparallellibrary_tpu/kernels/paged_attention.py``.  Each
token of one flat serving batch attends its own causal prefix through
its slot's block table (shapes below).  The functions:

* :func:`paged_attention_reference` — plain PyTorch, numerically the
  mirror of the JAX reference (``-1e9`` mask, fp32 softmax, probabilities
  cast back to the input dtype before the V product).  The CPU path, and
  the oracle both builds are held against on the card.
* :func:`paged_attention_tiled_cuda` — the slot-tiled kernel of
  ``csrc/paged_attention.cu`` (bf16, head dim 64 or 128): one CTA per
  (query tile, head, context split), tensor-core products, split
  contexts combined in the same launch.  It takes a :class:`PagedTiles`
  plan (:func:`plan_tiles`).
* :func:`paged_attention_warp_cuda` — the warp kernel of the same source
  (one warp per token and head), for fp32, for fp16, and for bf16 at the
  other head dims.
* :func:`paged_attention_mixed_cuda` — the warp kernel built for an fp16
  query over bf16 pools (amp O1 computing in fp16 over a bf16 model
  config), with an fp32 output: the promoted type the JAX reference's
  einsums compute in.
* :func:`paged_attention_cuda` — the CUDA entry: it checks the
  arguments and launches the build that takes them (the tiled build for
  bf16 at head dims 64 and 128, the mixed build for fp16 q over bf16
  pools, the warp build otherwise).  An fp16 call runs the warp build's
  fp16 instantiation.
* :func:`paged_attention` — the dispatcher: a CPU tensor goes to the
  plain version, a CUDA tensor to :func:`paged_attention_cuda`.  A CUDA
  tensor never reaches the plain version through it.

Each wrapper keeps a plain integer count of its launches (``.launches``
on the four CUDA functions; ``paged_attention_cuda`` counts every
launch, the three builds their own) and the plain version of its calls
(``paged_attention_reference.calls``), so a run can show which one its
main path went through.  Under a cost count the dispatcher books the
formula of ``kernels/_cost.py`` whichever of the two runs.

Shapes (one flat token batch, serving/engine.py):

* ``q``                 ``[T, H, hd]``  this step's query rows
* ``k_pages/v_pages``   ``[NB, bs, H, hd]`` the paged cache pool
* ``tables_tok``        ``[T, MB]`` int32, each token's slot block table
* ``positions``         ``[T]`` int32, each token's absolute position

Token ``t`` attends virtual rows ``j <= positions[t]``, row ``j``
resolved through ``tables_tok[t, j // bs]`` to pool row
``table_entry * bs + j % bs``.

Query tiles.  A tile is a run of at most :data:`TILE_ROWS` flat tokens
that share one block-table row, with positions that rise by one from
token to token (a slot's prefill chunk cut into tiles, one decode token,
or a slot's speculative draft run) or stay equal (padding: slot 0,
position 0, which an engine step holds up to ``token_budget`` of).  The
kernel reads the table row of a tile's first token for all its rows and
masks each row by its own position, so a run is a tile only if every
token in it belongs to that slot.  The engine knows the runs from its
step plan (:func:`tile_runs_from_plan`, decode tokens, prefill chunks
and draft runs) and plans them once per step; a draft model's one-token-
per-slot rollouts are one-row tiles (:func:`one_row_runs`); a direct
call without a plan derives them from the tables and positions
(:func:`tile_runs_from_tokens`).  Every tiling of the batch into such
runs gives the same output, and so does every split plan whose last
split ends at the tile's context end: a split whose keys all lie past a
row's position adds nothing to that row.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from easyparallellibrary_tpu_torch.kernels import _cost

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The one mix of query and pool types the kernels take (q, pools).
MIXED_DTYPES = (torch.float16, torch.bfloat16)
_MAX_HEAD_DIM = 256
TILE_ROWS = 64             # rows of a query tile, at most (the kernel's)
TILED_HEAD_DIMS = (64, 128)
_ITEM_FIELDS = 8           # int32 per work item (csrc: tiled::Item)


def paged_attention_reference(q, k_pages, v_pages, tables_tok, positions):
  """Dense-gather plain version: gather every table row, mask rows past
  each token's position with ``-1e9``, softmax in fp32.  A ``q`` of
  another float type than the pools (amp O1 computes in a narrower type
  than the model config's caches) is multiplied in the promoted type, as
  ``jnp.einsum`` promotes."""
  paged_attention_reference.calls += 1
  T, H, hd = q.shape
  bs = k_pages.shape[1]
  MB = tables_tok.shape[1]
  L = MB * bs
  dtype = q.dtype
  # sqrt(hd) in fp32, rounded to the dtype, as jnp.sqrt(hd).astype(dtype).
  scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=q.device)).to(dtype)
  tables = tables_tok.long()
  kk = k_pages[tables].reshape(T, L, H, hd)
  vv = v_pages[tables].reshape(T, L, H, hd)
  qk_type = torch.promote_types(dtype, kk.dtype)
  logits = torch.einsum("thd,tlhd->thl", q.to(qk_type),
                        kk.to(qk_type)) * scale
  valid = (torch.arange(L, device=q.device)[None, None, :]
           <= positions.long()[:, None, None])
  logits = torch.where(valid, logits,
                       torch.tensor(-1e9, dtype=logits.dtype,
                                    device=q.device))
  probs = torch.softmax(logits.float(), dim=-1)
  pv_type = torch.promote_types(dtype, vv.dtype)
  return torch.einsum("thl,tlhd->thd", probs.to(dtype).to(pv_type),
                      vv.to(pv_type))


paged_attention_reference.calls = 0


# ------------------------------------------------------------ tile plan --


@dataclasses.dataclass
class PagedTiles:
  """One step's query tiles as the tiled kernel's work items.

  ``items`` int32 ``[n_items, 8]`` on the device: one row per
  context split of a tile (first token, rows, first key, end key or -1
  for the tile's context end, split index, splits, first scratch slot,
  0).  ``counters`` int32 ``[n_items * H]`` zeros on the device: the
  kernel's per-(tile, head) arrival counts, which each launch leaves at
  zero, so one plan serves every layer of a step (launched on one
  stream).  ``partial_rows``: scratch slots (row x split) of the split
  tiles.
  """
  items: torch.Tensor
  counters: torch.Tensor
  partial_rows: int


def _cut(runs, start: int, end: int) -> None:
  for off in range(start, end, TILE_ROWS):
    runs.append((off, min(TILE_ROWS, end - off)))


def tile_runs_from_plan(base_idx, num_valid, T: int, draft_base=None,
                        draft_cap=None) -> np.ndarray:
  """Tiles from a step plan: slot ``s`` holds flat tokens ``base_idx[s]
  ..`` of consecutive positions, ``num_valid[s]`` of them, and its draft
  run, ``draft_cap[s]`` tokens from ``draft_base[s]`` at the positions
  after its decode token (whether or not the drafter filled them);
  every other flat token is padding (slot 0, position 0).  Each slot's
  runs and each run of padding are cut into tiles of at most
  :data:`TILE_ROWS`."""
  runs, covered = [], np.zeros((T,), bool)
  starts = [np.asarray(base_idx)]
  counts = [np.asarray(num_valid)]
  if draft_cap is not None:
    starts.append(np.asarray(draft_base))
    counts.append(np.asarray(draft_cap))
  for start, n in zip(np.concatenate(starts), np.concatenate(counts)):
    start, n = int(start), int(n)
    _cut(runs, start, start + n)
    covered[start:start + n] = True
  t = 0
  while t < T:                          # the runs of padding
    end = t
    while end < T and not covered[end]:
      end += 1
    _cut(runs, t, end)
    t = end + 1
  return np.asarray(runs, np.int64).reshape(-1, 2)


def one_row_runs(n: int) -> np.ndarray:
  """``n`` one-row tiles: a batch of one token per slot (a draft
  model's rollout), token ``s`` in slot ``s``."""
  return np.stack([np.arange(n), np.ones((n,), np.int64)], axis=1)


def tile_runs_from_tokens(tables_tok, positions) -> np.ndarray:
  """Tiles derived from the batch itself: maximal runs of flat tokens
  with one table row whose positions rise by one throughout or stay
  equal throughout, cut at :data:`TILE_ROWS`."""
  tables_tok = np.asarray(tables_tok)
  positions = np.asarray(positions).astype(np.int64)
  T = positions.shape[0]
  step = np.diff(positions)
  same_row = (tables_tok[1:] == tables_tok[:-1]).all(axis=1)
  runs, start = [], 0
  for t in range(1, T + 1):
    if t < T and same_row[t - 1] and step[t - 1] in (0, 1) and (
        t - start < 2 or step[t - 1] == step[t - 2]):
      continue
    _cut(runs, start, t)
    start = t
  return np.asarray(runs, np.int64).reshape(-1, 2)


def split_keys(rows: int) -> int:
  """Keys per context split of a tile of ``rows`` rows.  A decode tile's
  CTA does little per key, so its split is long (256 keys) to spread the
  CTA's fixed cost (table, positions, partials); a prefill tile's is
  short (128 keys), to spread its heavier work over more CTAs.  Chosen
  from several policies timed on an H100 at an engine step with prefill
  chunks and at a decode-only step, where it was the fastest."""
  return 256 if rows <= 16 else 128


def work_items(runs, positions, MB: int, bs: int):
  """The kernel's work items for ``runs`` (``[n, 2]``): each tile's
  context, keys ``0 .. min(max position, MB * bs - 1)``, cut into splits
  of :func:`split_keys`.  Returns ``(items int32 [n_items, 8],
  partial_rows)``."""
  positions = np.asarray(positions).astype(np.int64)
  items, partial_rows = [], 0
  for t0, n in np.asarray(runs).reshape(-1, 2):
    t0, n = int(t0), int(n)
    ctx = min(int(positions[t0:t0 + n].max()), MB * bs - 1) + 1
    keys = split_keys(n)
    splits = max(1, -(-ctx // keys))
    prow = partial_rows if splits > 1 else -1
    if splits > 1:
      partial_rows += n * splits
    for i in range(splits):
      end = -1 if i == splits - 1 else (i + 1) * keys
      items.append((t0, n, i * keys, end, i, splits, prow, 0))
  return (np.asarray(items, np.int32).reshape(-1, _ITEM_FIELDS),
          partial_rows)


def plan_tiles(runs, positions, MB: int, bs: int, H: int,
               device) -> PagedTiles:
  """A :class:`PagedTiles` plan for ``runs`` on ``device``: one
  host-to-device copy of the items and one zeroed counter buffer."""
  items, partial_rows = work_items(runs, positions, MB, bs)
  return PagedTiles(
      items=torch.from_numpy(items).to(device),
      counters=torch.zeros((items.shape[0] * H,), dtype=torch.int32,
                           device=device),
      partial_rows=partial_rows)


def takes_tiles(dtype, hd: int) -> bool:
  """Whether the tiled build (which needs a tile plan) takes this call."""
  return dtype == torch.bfloat16 and hd in TILED_HEAD_DIMS


def needs_tiles(k_pages, q_dtype=None) -> bool:
  """Whether a call over this pool launches the tiled build: a CUDA pool
  of a dtype and head dim it takes, read by a query of the same dtype
  (``q_dtype``, when the caller knows it; an fp16 query over bf16 pools
  runs the mixed build)."""
  return (k_pages.is_cuda and takes_tiles(k_pages.dtype, k_pages.shape[-1])
          and (q_dtype is None or q_dtype == k_pages.dtype))


# ------------------------------------------------------------- wrappers --


def _library():
  from easyparallellibrary_tpu_torch.kernels import _build
  lib = _build.load("paged_attention")
  if lib.epl_paged_attention.argtypes is None:
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.epl_paged_attention.argtypes = [p] * 6 + [i] * 7 + [f, p]
    lib.epl_paged_attention.restype = i
    lib.epl_paged_attention_mixed.argtypes = [p] * 6 + [i] * 6 + [f, p]
    lib.epl_paged_attention_mixed.restype = i
    lib.epl_paged_attention_tiled.argtypes = ([p] * 6 + [i, p, i, p, p]
                                              + [i] * 6 + [f, p])
    lib.epl_paged_attention_tiled.restype = i
    lib.epl_cuda_error_string.argtypes = [i]
    lib.epl_cuda_error_string.restype = ctypes.c_char_p
  return lib


def _check_args(q, k_pages, v_pages, tables_tok, positions):
  tensors = (q, k_pages, v_pages, tables_tok, positions)
  if any(not x.is_cuda for x in tensors):
    raise ValueError("paged_attention_cuda needs CUDA tensors; got "
                     f"{[str(x.device) for x in tensors]}")
  if any(x.device != q.device for x in tensors):
    raise ValueError("paged_attention_cuda: all tensors must be on one "
                     "device")
  if q.dtype not in _DTYPE_CODES:
    raise ValueError(f"paged_attention_cuda supports float32, bfloat16 and "
                     f"float16; got {q.dtype}")
  if k_pages.dtype != v_pages.dtype or (
      k_pages.dtype != q.dtype and (q.dtype, k_pages.dtype) != MIXED_DTYPES):
    raise ValueError("paged_attention_cuda: q and the pools must share "
                     "one dtype, or be an fp16 q over bf16 pools; got "
                     f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
  if tables_tok.dtype != torch.int32 or positions.dtype != torch.int32:
    raise ValueError("paged_attention_cuda: tables_tok and positions must "
                     "be int32")
  if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
    raise ValueError(f"paged_attention_cuda: bad ranks/shapes q "
                     f"{tuple(q.shape)}, pools {tuple(k_pages.shape)} / "
                     f"{tuple(v_pages.shape)}")
  T, H, hd = q.shape
  if k_pages.shape[2:] != (H, hd):
    raise ValueError(f"paged_attention_cuda: pool heads/dims "
                     f"{tuple(k_pages.shape[2:])} != q's {(H, hd)}")
  if tables_tok.dim() != 2 or tables_tok.shape[0] != T \
      or positions.shape != (T,):
    raise ValueError(f"paged_attention_cuda: tables_tok "
                     f"{tuple(tables_tok.shape)} / positions "
                     f"{tuple(positions.shape)} do not match T={T}")
  if hd % 8 or not 0 < hd <= _MAX_HEAD_DIM:
    raise ValueError(f"paged_attention_cuda: head dim {hd} must be a "
                     f"multiple of 8 in [8, {_MAX_HEAD_DIM}]")
  for x in tensors:
    if not x.is_contiguous():
      raise ValueError("paged_attention_cuda needs contiguous tensors")
  for x in (q, k_pages, v_pages):
    if x.data_ptr() % 16:
      raise ValueError("paged_attention_cuda needs 16-byte aligned q and "
                       "pools (the kernels load 16 bytes per lane)")


def _raise_on(lib, err, name):
  if err != 0:
    raise RuntimeError(
        f"{name} kernel launch failed: cudaError {err} "
        f"({lib.epl_cuda_error_string(err).decode()})")


def _one_dtype(name, q, k_pages):
  if k_pages.dtype != q.dtype:
    raise ValueError(f"{name} takes q and pools of one dtype; got "
                     f"{q.dtype} over {k_pages.dtype}")


def paged_attention_warp_cuda(q, k_pages, v_pages, tables_tok, positions):
  """The warp build on the current stream (any supported dtype and head
  dim, q and the pools of one dtype); returns ``[T, H, hd]`` in ``q``'s
  dtype."""
  _check_args(q, k_pages, v_pages, tables_tok, positions)
  _one_dtype("paged_attention_warp_cuda", q, k_pages)
  lib = _library()
  T, H, hd = q.shape
  NB, bs = k_pages.shape[:2]
  out = torch.empty_like(q)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.epl_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables_tok.data_ptr(), positions.data_ptr(), out.data_ptr(),
        T, H, hd, NB, bs, tables_tok.shape[1], _DTYPE_CODES[q.dtype],
        1.0 / math.sqrt(hd), stream)
  _raise_on(lib, err, "paged_attention (warp build)")
  paged_attention_warp_cuda.launches += 1
  return out


def paged_attention_mixed_cuda(q, k_pages, v_pages, tables_tok, positions):
  """The mixed build on the current stream: an fp16 ``q`` over bf16
  pools (any supported head dim); returns ``[T, H, hd]`` in fp32, the
  type the JAX reference promotes these einsums to.  p is rounded to
  fp16 before the V product, as the reference's ``probs.astype(q.dtype)``
  does."""
  _check_args(q, k_pages, v_pages, tables_tok, positions)
  if (q.dtype, k_pages.dtype) != MIXED_DTYPES:
    raise ValueError(f"paged_attention_mixed_cuda takes an fp16 q over "
                     f"bf16 pools; got {q.dtype} over {k_pages.dtype}")
  lib = _library()
  T, H, hd = q.shape
  NB, bs = k_pages.shape[:2]
  out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.epl_paged_attention_mixed(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables_tok.data_ptr(), positions.data_ptr(), out.data_ptr(),
        T, H, hd, NB, bs, tables_tok.shape[1], 1.0 / math.sqrt(hd), stream)
  _raise_on(lib, err, "paged_attention (mixed build)")
  paged_attention_mixed_cuda.launches += 1
  return out


def paged_attention_tiled_cuda(q, k_pages, v_pages, tables_tok, positions,
                               tiles: PagedTiles):
  """The slot-tiled build on the current stream (bf16, head dim 64 or
  128) over the work items of ``tiles``; returns ``[T, H, hd]``."""
  _check_args(q, k_pages, v_pages, tables_tok, positions)
  _one_dtype("paged_attention_tiled_cuda", q, k_pages)
  T, H, hd = q.shape
  if not takes_tiles(q.dtype, hd):
    raise ValueError(f"paged_attention_tiled_cuda takes bfloat16 at head "
                     f"dims {TILED_HEAD_DIMS}; got {q.dtype}, {hd}")
  items, counters = tiles.items, tiles.counters
  if (items.device != q.device or counters.device != q.device
      or items.dtype != torch.int32 or counters.dtype != torch.int32
      or items.dim() != 2 or items.shape[1] != _ITEM_FIELDS
      or counters.numel() < items.shape[0] * H
      or not items.is_contiguous()):
    raise ValueError("paged_attention_tiled_cuda: tiles were not planned "
                     f"for this batch (H={H}) on {q.device}")
  lib = _library()
  NB, bs = k_pages.shape[:2]
  out = torch.empty_like(q)
  partial = torch.empty((tiles.partial_rows * H * (hd + 2),),
                        dtype=torch.float32, device=q.device)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.epl_paged_attention_tiled(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables_tok.data_ptr(), positions.data_ptr(), items.data_ptr(),
        items.shape[0], partial.data_ptr() if partial.numel() else None,
        tiles.partial_rows, counters.data_ptr(), out.data_ptr(), T, H, hd,
        NB, bs, tables_tok.shape[1], 1.0 / math.sqrt(hd), stream)
  _raise_on(lib, err, "paged_attention (tiled build)")
  paged_attention_tiled_cuda.launches += 1
  return out


def paged_attention_cuda(q, k_pages, v_pages, tables_tok, positions,
                         tiles: Optional[PagedTiles] = None):
  """The CUDA entry: the tiled build for bf16 at head dims 64 and 128
  (planning the tiles from the batch when ``tiles`` is None, which reads
  the tables and positions back to the host), the warp build otherwise.
  A narrower ``q`` over fp32 pools (amp O1 over an fp32 model config)
  is read in fp32, an exact cast: the fp32 build then keeps p in fp32,
  as the Pallas kernel's ``p.astype(v.dtype)`` does, and the output is
  fp32, the promoted type the plain version returns too.  An fp16 ``q``
  over bf16 pools (amp O1 in fp16 over a bf16 model config) runs the
  mixed build (``tiles`` unused), whose output is fp32, the promoted
  type.  Raises on any other mix of dtypes, on arguments the kernels do
  not take and on a refused launch."""
  if k_pages.dtype == torch.float32 and q.dtype != torch.float32:
    q = q.float()
  _check_args(q, k_pages, v_pages, tables_tok, positions)
  T, H, hd = q.shape
  if q.dtype != k_pages.dtype:
    out = paged_attention_mixed_cuda(q, k_pages, v_pages, tables_tok,
                                     positions)
  elif takes_tiles(q.dtype, hd):
    if tiles is None:
      pos = positions.cpu().numpy()
      runs = tile_runs_from_tokens(tables_tok.cpu().numpy(), pos)
      tiles = plan_tiles(runs, pos, tables_tok.shape[1], k_pages.shape[1],
                         H, q.device)
    out = paged_attention_tiled_cuda(q, k_pages, v_pages, tables_tok,
                                     positions, tiles)
  else:
    out = paged_attention_warp_cuda(q, k_pages, v_pages, tables_tok,
                                    positions)
  paged_attention_cuda.launches += 1
  return out


paged_attention_cuda.launches = 0
paged_attention_warp_cuda.launches = 0
paged_attention_mixed_cuda.launches = 0
paged_attention_tiled_cuda.launches = 0


def reset_counts():
  """Set every launch and call count of this module to 0."""
  for fn in (paged_attention_cuda, paged_attention_warp_cuda,
             paged_attention_mixed_cuda, paged_attention_tiled_cuda):
    fn.launches = 0
  paged_attention_reference.calls = 0


# The JAX hook's names: "pallas" is the port's kernels; the JAX
# package's "interpret" (the Pallas kernel on its interpreter) has no
# counterpart, since a CUDA kernel has no interpreter.
IMPLS = ("pallas", "reference")
_IMPL_OVERRIDE = [None]


def set_paged_attention_impl(impl: Optional[str]) -> None:
  """Pin the dispatcher of :func:`paged_attention` (``None`` restores
  the device rule), the JAX package's test and benchmark hook.
  ``"pallas"`` pins the kernels and ``"reference"`` the plain version;
  a tensor on a device the pinned one does not run on raises (neither
  ever stands in for the other)."""
  if impl is not None and impl not in IMPLS:
    raise ValueError(f"impl must be one of {IMPLS} or None; got {impl!r}")
  _IMPL_OVERRIDE[0] = impl


def paged_attention(q, k_pages, v_pages, tables_tok, positions,
                    tiles: Optional[PagedTiles] = None):
  """Paged gather-attend over a flat token batch (module docstring):
  the kernels for CUDA tensors, the plain version for CPU tensors (which
  needs no tile plan and ignores one)."""
  pinned = _IMPL_OVERRIDE[0]
  if pinned is not None and pinned != ("pallas" if q.is_cuda
                                       else "reference"):
    raise ValueError(f"paged_attention is pinned to {pinned!r} "
                     f"(set_paged_attention_impl), which does not run on "
                     f"{q.device}")
  if q.is_cuda:
    impl, args = paged_attention_cuda, (q, k_pages, v_pages, tables_tok,
                                        positions, tiles)
  elif q.device.type == "cpu":
    impl, args = paged_attention_reference, (q, k_pages, v_pages,
                                             tables_tok, positions)
  else:
    raise ValueError(f"paged_attention: no implementation for device "
                     f"{q.device}")
  return _cost.kernel_call(
      "paged_attention",
      _cost.paged_flops(q.shape, tables_tok.shape, k_pages.shape[1]), impl,
      *args)
