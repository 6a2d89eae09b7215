"""Sharded, crash-consistent checkpoints (port of
``easyparallellibrary_tpu/runtime/saver.py``).

The on-disk format is the JAX package's, byte for byte in meaning, so a
checkpoint written by either package restores in the other:

* one ``step_NNNNNNNN`` directory per checkpoint under the root, staged
  in ``step_N.tmp`` and committed with one atomic rename; corrupt
  candidates are quarantined as ``step_N.corrupt`` and the restore falls
  back down the chain; a root holding ``index.json`` itself is the
  legacy flat layout;
* leaves in ``.npz`` shards of at most ``shard_mb``, listed in
  ``index.json`` with each shard's size and sha256 and the
  ``params_fingerprint`` over them;
* leaf names are the JAX tree's paths.  A train state is written as the
  JAX package's ``fit`` writes it (:func:`state_tree`): ``params/<path>``
  with Dense kernels ``[in, out]`` (the port holds ``[out, in]``), and
  optax's Adam state ``opt_state/0/count`` (one int32), ``opt_state/0/
  mu/<path>`` and ``opt_state/0/nu/<path>``.  torch's AdamW keeps one
  ``step`` per parameter: one count is written, and on restore it goes
  into every parameter's ``step``.  An optimizer built through
  ``ops.adamw.inject_hyperparams`` is written as optax's
  ``inject_hyperparams`` state (the learning rate included).

bf16 leaves: the JAX package stores them through ``ml_dtypes`` as the
2-byte void type ``V2`` with ``"dtype": "bfloat16"`` in the index.  The
port writes and reads the same bytes without ``ml_dtypes``: a bf16
tensor is written as its 16-bit pattern viewed as ``V2``, and a ``V2``
leaf whose index says ``bfloat16`` is read back as those bits.

Shards are written, checksummed, verified and read by a pool of host
threads (``_IO_WORKERS``; numpy's zip writes, ``hashlib`` and file IO
release the GIL), at most two shards per thread in flight, so host
memory stays bounded while a multi-GB checkpoint moves at the host's
rate rather than one core's.  The JAX package's orbax path is
``torch.distributed.checkpoint`` here (:func:`save_checkpoint_orbax`,
:func:`restore_checkpoint_orbax`): a format of its own, read only by
itself.

A sharded state.  A JAX array carries its sharding and the JAX saver
gathers it (``process_allgather``); a torch tensor is only this rank's
block, so the save takes each leaf's layout: ``shardings=`` (``{path:
spec}`` in the tree's own layout), or leaves wrapped as :class:`Sharded`
(:func:`state_tree` / :func:`params_tree` with the state's layouts,
``parallel.api.state_shardings``).  Every rank calls the save; each
sharded leaf is all-gathered over the axes of its spec (``model`` for
the column, row and vocab layers, ``data`` on a ZeRO owner dim,
``stage`` for stacked or stage-resident leaves, ``expert``), bucket by
bucket (<= ``shard_mb`` of whole leaves), trimmed to its logical shape
(``parallel.api.LeafSpec``: the pad past it is attested zeros), and only
process 0 writes.  Under a process group a leaf without a layout is an
error: it is never written as one rank's copy.  A restore with
``shardings=`` reads each logical leaf on every rank, re-pads the
attested pad with zeros and keeps this rank's block, so a checkpoint
restores under any layout (:func:`_slice_to_shape`'s coverage rule is
the JAX one).
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from easyparallellibrary_tpu_torch import constants
from easyparallellibrary_tpu_torch.communicators import collectives
from easyparallellibrary_tpu_torch.observability import trace as trace_lib
from easyparallellibrary_tpu_torch.utils.device import (
    process_count, process_index, resolve_device)
from easyparallellibrary_tpu_torch.utils.logging import get_logger

INDEX_FILE = "index.json"
TMP_SUFFIX = ".tmp"
CORRUPT_SUFFIX = ".corrupt"
_STEP_DIR_RE = re.compile(r"^step_(\d+)$")
_BF16 = "bfloat16"
_IO_WORKERS = max(1, min(8, os.cpu_count() or 1))


class NoValidCheckpointError(FileNotFoundError):
  """Candidates existed but every one failed validation.  Distinct from
  a plain FileNotFoundError (empty/missing directory — a fresh run) so
  callers can fail loudly instead of silently restarting from step 0."""


def _step_dir_name(step: int) -> str:
  return f"step_{step:08d}"


def _sha256_file(path: str) -> str:
  h = hashlib.sha256()
  with open(path, "rb") as f:
    for chunk in iter(lambda: f.read(1 << 20), b""):
      h.update(chunk)
  return h.hexdigest()


def _fsync_path(path: str, is_dir: bool = False):
  """Best-effort fsync of a file or directory entry (directory fsync is
  what makes the rename-commit durable on POSIX)."""
  try:
    fd = os.open(path, os.O_RDONLY | (os.O_DIRECTORY if is_dir else 0))
  except (OSError, AttributeError):  # pragma: no cover - platform specific
    return
  try:
    os.fsync(fd)
  except OSError:  # pragma: no cover
    pass
  finally:
    os.close(fd)


def _write_shard(fpath: str, arrays: Dict[str, np.ndarray]) -> Tuple[int, str]:
  """Write one ``.npz`` shard, fsynced; returns its size and the sha256
  of exactly the bytes written (what verification re-reads)."""
  buf = io.BytesIO()
  np.savez(buf, **arrays)
  view = buf.getbuffer()
  with open(fpath, "wb") as f:
    f.write(view)
    f.flush()
    os.fsync(f.fileno())
  return len(view), hashlib.sha256(view).hexdigest()


def _load_shard(spath: str, names: Iterable[str]) -> Dict[str, np.ndarray]:
  with np.load(spath) as z:
    return {n: z[n] for n in names}


def _write_index(directory: str, index: Dict[str, Any]):
  """Write index.json via temp-file + atomic replace."""
  final = os.path.join(directory, INDEX_FILE)
  tmp = final + TMP_SUFFIX
  with open(tmp, "w") as f:
    json.dump(index, f, indent=1)
    f.flush()
    os.fsync(f.fileno())
  os.replace(tmp, final)


def _is_leader() -> bool:
  return process_index() == 0


# What the last save on this process did (``chip_smoke.py`` reads it):
# seconds, bytes of leaves gathered over a mesh axis through host memory,
# and the most bytes of shard arrays it held at once.
last_save: Dict[str, float] = {}


def params_fingerprint(index: Dict[str, Any]) -> str:
  """Deterministic content fingerprint of a checkpoint from its index:
  sha256 over the sorted leaf records (path, stored shape, dtype) plus
  each leaf's covering shard checksum.  Recorded in ``index.json`` at
  save time and recomputed by :func:`verify_checkpoint`, so a leaves
  table mixed with another save's shards is rejected."""
  h = hashlib.sha256()
  shard_digest: Dict[str, str] = {}
  for entry in index.get("shards", []):
    if isinstance(entry, dict):
      shard_digest[str(entry.get("file", ""))] = str(
          entry.get("sha256") or "")
  for path in sorted(index.get("leaves", {})):
    info = index["leaves"][path]
    h.update(path.encode())
    h.update(repr(tuple(info.get("shape", ()))).encode())
    h.update(str(info.get("dtype", "")).encode())
    h.update(shard_digest.get(str(info.get("shard", "")), "").encode())
    h.update(b"\x00")
  return h.hexdigest()


def checkpoint_fingerprint(directory: str) -> Tuple[str, int]:
  """``(fingerprint, step)`` of the newest VALID checkpoint under
  ``directory``."""
  for path in _walk_valid_checkpoints(directory):
    with open(os.path.join(path, INDEX_FILE)) as f:
      index = json.load(f)
    fp = index.get("params_fingerprint") or params_fingerprint(index)
    return str(fp), int(index.get("step") or 0)
  raise FileNotFoundError(f"no valid checkpoint under {directory!r}")


def _candidate_dirs(directory: str) -> List[str]:
  """Checkpoint candidates, newest first: the ``step_N`` children, and
  the root itself when it holds ``index.json`` (the legacy flat layout),
  ranked into the chain by its recorded step.  Staging (``.tmp``) and
  quarantined (``.corrupt``) dirs are never candidates."""
  try:
    names = os.listdir(directory)
  except (FileNotFoundError, NotADirectoryError):
    return []
  ranked: List[Tuple[int, str]] = []
  for name in names:
    m = _STEP_DIR_RE.match(name)
    if m and os.path.isdir(os.path.join(directory, name)):
      ranked.append((int(m.group(1)), os.path.join(directory, name)))
  if INDEX_FILE in names:
    if not ranked:
      return [directory]
    try:
      with open(os.path.join(directory, INDEX_FILE)) as f:
        flat_step = json.load(f).get("step")
      flat_step = int(flat_step) if flat_step is not None else -1
    except (OSError, ValueError, TypeError):
      flat_step = -1  # unparsable: last resort in the chain
    ranked.append((flat_step, directory))
  return [p for _, p in sorted(ranked, key=lambda t: t[0], reverse=True)]


def has_quarantined(directory: str) -> bool:
  """Whether the checkpoint root holds quarantined (``*.corrupt``)
  checkpoints."""
  try:
    return any(CORRUPT_SUFFIX in name for name in os.listdir(directory))
  except (FileNotFoundError, NotADirectoryError):
    return False


def verify_checkpoint(path: str) -> Tuple[bool, str]:
  """Validate one checkpoint dir: index parses, every shard exists, and
  recorded sizes/sha256 checksums and the fingerprint match.  Returns
  ``(ok, reason)``."""
  from easyparallellibrary_tpu_torch.utils.retry import retry_call
  try:
    with open(os.path.join(path, INDEX_FILE)) as f:
      index = json.load(f)
  except FileNotFoundError:
    return False, "missing index.json"
  except (json.JSONDecodeError, OSError, UnicodeDecodeError, ValueError) as e:
    return False, f"unparsable index.json ({e})"
  if not isinstance(index, dict) or "leaves" not in index:
    return False, "malformed index.json (no leaves)"
  try:
    to_hash = []
    for entry in index.get("shards", []):
      if isinstance(entry, str):  # pre-checksum index format
        fname, nbytes, digest = entry, None, None
      else:
        fname = entry.get("file", "")
        nbytes, digest = entry.get("bytes"), entry.get("sha256")
      fpath = os.path.join(path, fname)
      if not os.path.isfile(fpath):
        return False, f"missing shard {fname}"
      if nbytes is not None and os.path.getsize(fpath) != nbytes:
        return False, (f"shard {fname}: size {os.path.getsize(fpath)} != "
                       f"recorded {nbytes} (truncated?)")
      if digest is not None:
        to_hash.append((fname, fpath, digest))
    # Transient read errors are retried before a shard is judged;
    # FileNotFoundError stays permanent (a vanished shard IS invalid).
    with ThreadPoolExecutor(_IO_WORKERS) as pool:
      digests = list(pool.map(
          lambda t: retry_call(_sha256_file, t[1],
                               what=f"checksum read {t[0]}"), to_hash))
    for (fname, _, want), got in zip(to_hash, digests):
      if got != want:
        return False, f"shard {fname}: sha256 mismatch (corrupted)"
  except OSError as e:
    return False, f"shard disappeared during validation ({e})"
  recorded = index.get("params_fingerprint")
  if recorded is not None and recorded != params_fingerprint(index):
    return False, "params fingerprint mismatch (index edited or mixed)"
  return True, ""


def _quarantine(path: str):
  """Rename a corrupt checkpoint dir out of the chain (leader only;
  best-effort)."""
  if not _is_leader():
    return
  target = path + CORRUPT_SUFFIX
  n = 0
  while os.path.exists(target):
    n += 1
    target = f"{path}{CORRUPT_SUFFIX}.{n}"
  try:
    os.replace(path, target)
    get_logger().warning("quarantined corrupt checkpoint %s -> %s",
                         path, target)
    trace_lib.get_tracer().instant(
        "checkpoint/quarantine", cat="checkpoint", track="checkpoint",
        args={"path": path})
  except OSError as e:  # pragma: no cover - racing cleanup
    get_logger().warning("could not quarantine %s: %s", path, e)


def _apply_retention(directory: str, keep_last: int):
  """Delete committed checkpoints beyond the newest ``keep_last``, plus
  stale staging dirs a crashed save left behind (leader only)."""
  if not _is_leader():
    return
  try:
    names = os.listdir(directory)
  except FileNotFoundError:
    return
  for name in names:
    if name.endswith(TMP_SUFFIX) and _STEP_DIR_RE.match(
        name[:-len(TMP_SUFFIX)]):
      shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
      get_logger().info("removed stale checkpoint staging dir %s", name)
  if keep_last <= 0:
    return
  for path in _candidate_dirs(directory)[keep_last:]:
    if path == directory:
      continue  # never rmtree the root (a legacy flat candidate)
    shutil.rmtree(path, ignore_errors=True)
    get_logger().info("retention (keep_last=%d): removed %s",
                      keep_last, path)


# ------------------------------------------------------- leaf encoding --


def _sorted_leaves(tree) -> List[Tuple[str, Any]]:
  """``[(path, leaf)]`` with dict keys sorted at every level, the order
  in which the JAX package flattens the same tree (so both packages
  bucket leaves into shards alike)."""

  def walk(node, prefix):
    if isinstance(node, dict):
      for key in sorted(node, key=str):
        yield from walk(node[key], prefix + (key,))
    elif isinstance(node, (list, tuple)):
      for i, value in enumerate(node):
        yield from walk(value, prefix + (i,))
    elif node is not None:
      yield "/".join(str(p) for p in prefix), node

  return list(walk(tree, ()))


def _dtype_name(leaf) -> str:
  dtype = getattr(leaf, "dtype", None)
  if isinstance(dtype, torch.dtype):
    return str(dtype).replace("torch.", "")
  return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
  """One leaf as the numpy array the shard stores: a bf16 tensor as its
  bit pattern in the JAX package's ``V2`` storage type."""
  if isinstance(leaf, torch.Tensor):
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
      return t.contiguous().view(torch.int16).cpu().numpy().view("V2")
    return t.contiguous().cpu().numpy()
  return np.asarray(leaf)


def _from_host(value: np.ndarray, dtype_name: str) -> torch.Tensor:
  """A stored array as a CPU tensor; a ``V2`` leaf that the index names
  ``bfloat16`` is read back as those bits."""
  # ``ascontiguousarray`` makes a 0-d array 1-d: keep the leaf's shape.
  value = np.ascontiguousarray(value).reshape(value.shape)
  if dtype_name == _BF16 or value.dtype.kind == "V":
    if value.dtype.itemsize != 2:
      raise ValueError(f"cannot read a {value.dtype} leaf as {dtype_name}")
    return torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
  return torch.from_numpy(value)


def _leaf_nbytes(leaf) -> int:
  from easyparallellibrary_tpu_torch.utils.pytree import leaf_bytes
  return leaf_bytes(leaf)


# ------------------------------------------------------- leaf layouts --


class Sharded:
  """A leaf of a tree to save with its layout: ``value`` is this rank's
  block and ``layout`` its spec (``parallel.api.LeafSpec``, or a plain
  tuple for an exact tiling), both in the tree's layout.  ``()`` is a
  replicated leaf."""

  __slots__ = ("value", "layout")

  def __init__(self, value, layout=()):
    self.value = value
    self.layout = _as_layout(layout)


def _as_layout(spec):
  from easyparallellibrary_tpu_torch.parallel.api import LeafSpec
  if isinstance(spec, LeafSpec):
    return spec
  return LeafSpec(tuple(spec or ()))


def _axes_of(entry) -> Tuple[str, ...]:
  if entry is None:
    return ()
  return (entry,) if isinstance(entry, str) else tuple(entry)


def _permuted(layout, perm):
  """``layout`` of a leaf whose dims are permuted by ``perm`` (dim ``i``
  of the result is dim ``perm[i]`` of the leaf)."""
  from easyparallellibrary_tpu_torch.parallel.api import LeafSpec
  layout = _as_layout(layout)
  if perm is None or not layout:
    return layout
  spec = tuple(layout) + (None,) * (len(perm) - len(layout))
  logical = layout.logical_shape
  return LeafSpec([spec[i] for i in perm],
                  None if logical is None else [logical[i] for i in perm],
                  {perm.index(d): g for d, g in layout.groups.items()})


def _shards(entry, mesh=None) -> Tuple[int, int]:
  """``(n, i)``: the blocks a dim is cut into over its axes and this
  rank's index among them (row-major, outermost axis first)."""
  n, i = 1, 0
  for axis in _axes_of(entry):
    size = collectives.axis_size(axis, mesh)
    n, i = n * size, i * size + collectives.axis_index(axis, mesh)
  return n, i


def _gather(value, layout, mesh=None) -> torch.Tensor:
  """The whole leaf, on the host, from every rank's block of it: an
  all-gather over each axis of each dim (innermost axis first, so a dim
  split over ``(stage, model)`` comes out stage-major; a grouped dim
  gathers inside each group), then trimmed to the logical shape.
  Counts the bytes it gathers in ``last_save``."""
  import torch.distributed as dist
  t = value.detach() if isinstance(value, torch.Tensor) \
      else torch.as_tensor(np.asarray(value))
  cut = [(d, entry) for d, entry in enumerate(layout)
         if _shards(entry, mesh)[0] > 1]
  if cut:
    bf16 = t.dtype == torch.bfloat16
    if bf16:
      t = t.view(torch.int16)
    groups = [collectives.group_of(a, mesh) for _, e in cut
              for a in _axes_of(e)]
    if t.is_cuda and any(g is not None and dist.get_backend(g) == "gloo"
                         for g in groups):
      t = t.cpu()
    for d, entry in cut:
      g = layout.groups.get(d, 1)
      for axis in reversed(_axes_of(entry)):
        if g > 1:
          t = collectives.all_gather(t.unflatten(d, (g, -1)), axis,
                                     axis=d + 1, mesh=mesh).flatten(d, d + 1)
        else:
          t = collectives.all_gather(t, axis, axis=d, mesh=mesh)
    t = t.cpu()
    if bf16:
      t = t.view(torch.bfloat16)
    last_save["gathered_bytes"] = last_save.get("gathered_bytes", 0) + \
        t.numel() * t.element_size()
  logical = layout.logical_shape
  if logical is not None and tuple(t.shape) != tuple(logical):
    t = t[tuple(slice(0, n) for n in logical)]
  return t


def _whole_nbytes(value, layout, mesh=None) -> int:
  """Bytes of the whole leaf a rank's block gathers into."""
  n = 1
  for entry in layout:
    n *= _shards(entry, mesh)[0]
  return _leaf_nbytes(value) * n


def _narrow(value: np.ndarray, layout, mesh=None, local_shape=None,
            offsets=None) -> np.ndarray:
  """This rank's block of the stored leaf ``value`` by ``layout``: the
  whole target (``local_shape`` times the blocks of each dim; without
  it, ``value`` rounded up to an even tiling) is cut from ``value`` by
  :func:`_slice_to_shape` (``offsets``; the attested pad past
  ``layout.logical_shape`` re-padded with zeros), then this rank's
  block of each split dim is kept (inside each group of a grouped
  dim)."""
  from easyparallellibrary_tpu_torch.ops.layers import _round_up
  cuts = {d: _shards(entry, mesh) for d, entry in enumerate(layout)}
  cuts = {d: ni for d, ni in cuts.items() if ni[0] > 1}
  if local_shape is not None:
    full = [s * cuts.get(d, (1, 0))[0] for d, s in enumerate(local_shape)]
  else:
    full = list(value.shape)
    for d, (n, _) in cuts.items():
      g = layout.groups.get(d, 1)
      full[d] = g * _round_up(-(-full[d] // g), n)
  if value.dtype.kind == "V":           # bf16 bits: pad and cut as int16
    value = value.view(np.int16)
  value = _slice_to_shape(value, tuple(full), offsets,
                          logical_shape=layout.logical_shape)
  for d, (n, i) in cuts.items():
    g = layout.groups.get(d, 1)
    shape = value.shape
    grouped = value.reshape(shape[:d] + (g, shape[d] // g) + shape[d + 1:])
    size = grouped.shape[d + 1] // n
    grouped = grouped[(slice(None),) * (d + 1) + (slice(i * size,
                                                          (i + 1) * size),)]
    value = grouped.reshape(shape[:d] + (g * size,) + shape[d + 1:])
  return value


def _resolve_layouts(flat, shardings) -> List[Tuple[str, Any, Any]]:
  """``[(path, value, layout)]`` of a flattened tree: a :class:`Sharded`
  leaf's own layout, else ``shardings[path]``, else None (written as it
  is), which under a process group is refused."""
  out, missing = [], []
  for path, leaf in flat:
    if isinstance(leaf, Sharded):
      out.append((path, leaf.value, leaf.layout))
    elif shardings is not None and path in shardings:
      out.append((path, leaf, _as_layout(shardings[path])))
    else:
      out.append((path, leaf, None))
      missing.append(path)
  if missing and process_count() > 1:
    raise ValueError(
        f"save under a process group of {process_count()} ranks: "
        f"{len(missing)} leaves have no layout ({missing[:3]}); pass "
        f"shardings= or a tree of Sharded leaves (state_tree(state, "
        f"shardings)) so each leaf is gathered, never written as one "
        f"rank's copy")
  return out


# -------------------------------------------------------------- save --


def save_checkpoint(directory: str, tree, step: Optional[int] = None,
                    shard_mb: Optional[int] = None,
                    keep_last: Optional[int] = None,
                    atomic: Optional[bool] = None,
                    shardings: Optional[Dict[str, Any]] = None) -> str:
  """Write ``tree`` (nested dicts / lists / tuples of tensors or arrays)
  as checkpoint ``directory/step_N`` and return the committed path.

  Leaves are fetched and written bucket by bucket (<= ``shard_mb``,
  default 50 MB, of whole leaves), so host memory stays bounded.  With
  ``atomic`` (default ``resilience.atomic_checkpoints``) the checkpoint
  is staged in ``step_N.tmp`` — per-shard sha256 in the index,
  everything fsynced — and committed by one directory rename.
  ``keep_last`` (default ``resilience.keep_last``; 0 keeps all) prunes
  older checkpoints after the commit.  A train state goes through
  :func:`state_tree` first.

  Sharded leaves (module docstring): each :class:`Sharded` leaf, or each
  path of ``shardings`` (``{path: spec}``), is gathered over its spec's
  axes and stored at its logical shape.  Every rank must call this with
  the same tree; process 0 writes, and the ranks meet at a barrier
  before it returns.  Under a process group every leaf needs a layout.
  """
  import time

  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.utils.retry import retry_call
  t_start = time.perf_counter()
  laid = _resolve_layouts(_sorted_leaves(tree), shardings)
  res = Env.get().config.resilience
  if atomic is None:
    atomic = res.atomic_checkpoints
  if keep_last is None:
    keep_last = res.keep_last
  is_leader = _is_leader()
  limit = (shard_mb or constants.DEFAULT_SAVE_SHARD_MB) * 1024 * 1024
  last_save.clear()
  last_save.update(gathered_bytes=0, host_peak_bytes=0)

  step_num = 0 if step is None else int(step)
  final_dir = os.path.join(directory, _step_dir_name(step_num))
  write_dir = final_dir + TMP_SUFFIX if atomic else final_dir
  if is_leader:
    os.makedirs(directory, exist_ok=True)
    if os.path.isdir(write_dir):
      shutil.rmtree(write_dir)
    os.makedirs(write_dir)

  index: Dict[str, Any] = {"step": step, "format": 2, "leaves": {},
                           "shards": []}
  bucket: List[Tuple[str, Any, Any]] = []
  bucket_bytes = 0
  shard_id = 0
  written: List[Tuple[str, Any]] = []     # (file, future), shard order
  in_flight: collections.deque = collections.deque()  # (future, bytes)

  def flush(pool):
    nonlocal bucket, bucket_bytes, shard_id
    if not bucket:
      return
    fname = f"shard_{shard_id:05d}.npz"
    arrays = {}
    for path, value, layout in bucket:
      if layout is not None:
        value = _gather(value, layout)   # every rank takes part
      if not is_leader:
        continue
      arrays[path] = _to_host(value)
      index["leaves"][path] = {"shard": fname,
                               "shape": list(arrays[path].shape),
                               "dtype": _dtype_name(value)}
    if is_leader:
      while len(in_flight) >= 2 * _IO_WORKERS:   # bound host memory
        in_flight.popleft()[0].result()
      while in_flight and in_flight[0][0].done():
        in_flight.popleft()
      nbytes = sum(a.nbytes for a in arrays.values())
      held = nbytes + sum(b for _, b in in_flight)
      last_save["host_peak_bytes"] = max(last_save["host_peak_bytes"], held)
      future = pool.submit(retry_call, _write_shard,
                           os.path.join(write_dir, fname), arrays,
                           what=f"checkpoint shard write {fname}")
      written.append((fname, future))
      in_flight.append((future, nbytes))
    shard_id += 1
    bucket, bucket_bytes = [], 0

  tracer = trace_lib.get_tracer()
  with tracer.span("checkpoint/stage", cat="checkpoint",
                   track="checkpoint", args={"step": step_num}), \
      ThreadPoolExecutor(_IO_WORKERS) as pool:
    for path, value, layout in laid:
      nbytes = (_leaf_nbytes(value) if layout is None
                else _whole_nbytes(value, layout))
      if bucket and bucket_bytes + nbytes > limit:
        flush(pool)
      bucket.append((path, value, layout))
      bucket_bytes += nbytes
    flush(pool)
    for fname, future in written:
      nbytes, digest = future.result()
      index["shards"].append({"file": fname, "bytes": nbytes,
                              "sha256": digest})
    if is_leader:
      index["params_fingerprint"] = params_fingerprint(index)
      retry_call(lambda: _write_index(write_dir, index),
                 what="checkpoint index write")
      _fsync_path(write_dir, is_dir=True)

  with tracer.span("checkpoint/commit", cat="checkpoint",
                   track="checkpoint", args={"step": step_num}):
    if is_leader:
      if atomic:
        if os.path.isdir(final_dir):
          shutil.rmtree(final_dir)
        os.replace(write_dir, final_dir)
      _fsync_path(directory, is_dir=True)
      get_logger().info("saved checkpoint: %s (%d leaves, %d shards)",
                        final_dir, len(index["leaves"]), shard_id)
      _apply_retention(directory, keep_last)
  if process_count() > 1:
    import torch.distributed as dist
    dist.barrier()
  last_save["seconds"] = time.perf_counter() - t_start
  return final_dir


# ----------------------------------------------------------- restore --


def _apply_assign_map(path: str, assign_map: Optional[Dict[str, str]]
                      ) -> str:
  """Regex rename, first match wins."""
  if not assign_map:
    return path
  for pattern, repl in assign_map.items():
    new, n = re.subn(pattern, repl, path)
    if n:
      return new
  return path


def _slice_to_shape(value: np.ndarray, shape: Tuple[int, ...],
                    offsets: Optional[Tuple[int, ...]] = None,
                    logical_shape: Optional[Tuple[int, ...]] = None
                    ) -> np.ndarray:
  """begin/size slicing at load: a stored value larger than the target
  is cut to ``shape`` at ``offsets`` (default the origin).  With
  ``logical_shape`` (a target attesting that its region past that shape
  is padding) a stored value of exactly the logical shape is zero-padded
  up to the target; a stored value that does not cover the whole
  logical region is refused, never zero-filled (JAX ``_slice_to_shape``)."""
  if tuple(value.shape) == tuple(shape):
    return value
  if len(value.shape) != len(shape):
    raise ValueError(f"rank mismatch restoring {value.shape} -> {shape}")
  if logical_shape is not None and any(
      v < s for v, s in zip(value.shape, shape)):
    if tuple(value.shape) != tuple(logical_shape):
      raise ValueError(
          f"stored shape {tuple(value.shape)} does not match the target's "
          f"attested logical shape {tuple(logical_shape)}; refusing to "
          f"zero-pad into the logical region (padded target {tuple(shape)})")
    value = np.pad(value, [(0, max(0, s - v))
                           for v, s in zip(value.shape, shape)])
    if tuple(value.shape) == tuple(shape):
      return value
  offsets = offsets or (0,) * len(shape)
  if any(o + s > v for o, s, v in zip(offsets, shape, value.shape)):
    raise ValueError(
        f"slice {offsets}+{shape} out of bounds for stored {value.shape}")
  return value[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


def _walk_valid_checkpoints(directory: str):
  """Yield checksum-VALID checkpoint candidates under ``directory``,
  newest first, quarantining the corrupt ones.  Raises
  FileNotFoundError when no candidate exists at all, and
  :class:`NoValidCheckpointError` when the consumer exhausts a chain
  whose candidates all failed validation."""
  candidates = _candidate_dirs(directory)
  if not candidates:
    raise FileNotFoundError(
        f"no checkpoint found under {directory!r} (no index.json and no "
        f"step_N subdirectories)")
  log = get_logger()
  for path in candidates:
    ok, reason = verify_checkpoint(path)
    if ok:
      yield path
      continue
    log.warning("checkpoint %s failed validation (%s); falling back to "
                "the previous checkpoint", path, reason)
    if path != directory:
      _quarantine(path)
  raise NoValidCheckpointError(
      f"no VALID checkpoint under {directory!r}: all {len(candidates)} "
      f"candidate(s) failed validation (corrupt ones quarantined as "
      f"*{CORRUPT_SUFFIX})")


class _Reader:
  """Leaf reads from one validated checkpoint dir.  :meth:`load` reads
  the leaves a restore needs, shard by shard on the IO threads; a leaf
  it did not load is read on demand."""

  def __init__(self, directory: str):
    with open(os.path.join(directory, INDEX_FILE)) as f:
      self.index = json.load(f)
    self.directory = directory
    self._cache: Dict[str, Any] = {}
    self._arrays: Dict[str, np.ndarray] = {}

  def load(self, paths: Iterable[str]):
    from easyparallellibrary_tpu_torch.utils.retry import retry_call
    by_shard: Dict[str, List[str]] = {}
    for p in paths:
      info = self.index["leaves"].get(p)
      if info is not None and p not in self._arrays:
        by_shard.setdefault(info["shard"], []).append(p)
    with ThreadPoolExecutor(_IO_WORKERS) as pool:
      for arrays in pool.map(
          lambda kv: retry_call(_load_shard,
                                os.path.join(self.directory, kv[0]), kv[1],
                                what=f"checkpoint shard read {kv[0]}"),
          by_shard.items()):
        self._arrays.update(arrays)

  @property
  def step(self):
    return self.index.get("step")

  def has(self, path: str) -> bool:
    return path in self.index["leaves"]

  def raw(self, path: str) -> np.ndarray:
    from easyparallellibrary_tpu_torch.utils.retry import retry_call
    if path in self._arrays:
      return self._arrays[path]
    info = self.index["leaves"].get(path)
    if info is None:
      raise KeyError(
          f"checkpoint {self.directory} has no tensor '{path}'; "
          f"available: {sorted(self.index['leaves'])[:8]}...")
    shard = info["shard"]
    if shard not in self._cache:
      spath = os.path.join(self.directory, shard)
      self._cache[shard] = retry_call(lambda: np.load(spath),
                                      what=f"checkpoint shard read {shard}")
    return self._cache[shard][path]

  def tensor(self, path: str, shape=None, offsets=None,
             layout=None) -> torch.Tensor:
    """The leaf at ``path``: cut to ``shape`` (at ``offsets``), or, with
    ``layout``, this rank's block of that shape (:func:`_narrow`)."""
    value = self.raw(path)
    if layout is not None:
      value = _narrow(value, layout, local_shape=shape, offsets=offsets)
    elif shape is not None:
      value = _slice_to_shape(value, tuple(shape), offsets)
    return _from_host(value, str(self.index["leaves"][path].get("dtype")))


def restore_checkpoint(directory: str, target=None,
                       shardings: Optional[Dict[str, Any]] = None,
                       assign_map: Optional[Dict[str, str]] = None,
                       slice_offsets: Optional[Dict[str, Tuple[int, ...]]]
                       = None, device=None):
  """Restore the newest VALID checkpoint under ``directory`` (one
  checkpoint, or a root of ``step_N`` dirs walked newest first with
  corrupt candidates quarantined).

  * ``target`` (optional): a tree of tensors giving structure, shapes
    and dtypes; loaded values are sliced to each leaf's shape
    (``slice_offsets`` by path), cast to its dtype and placed on
    ``device`` (default: each target leaf's device).  Without it, returns
    ``{path: tensor}`` on ``device`` (default the GPU).
  * ``shardings``: ``{path: spec}`` (``parallel.api.LeafSpec``) in the
    stored layout; each such leaf is this rank's block of the stored
    logical leaf (the target leaf's shape is the block's), the attested
    pad re-padded with zeros.
  * ``assign_map``: ``{regex: replacement}`` applied to the target's
    paths to find the checkpoint's names.

  Returns ``(tree, step)``, ``step`` from the checkpoint restored.
  """
  with trace_lib.get_tracer().span("checkpoint/restore",
                                   cat="checkpoint", track="checkpoint"):
    for path in _walk_valid_checkpoints(directory):
      return _restore_from(path, target, assign_map, slice_offsets,
                           device=device, shardings=shardings)


def _restore_from(directory: str, target=None,
                  assign_map: Optional[Dict[str, str]] = None,
                  slice_offsets: Optional[Dict[str, Tuple[int, ...]]] = None,
                  leaf_filter=None, device=None, shardings=None):
  from easyparallellibrary_tpu_torch.utils.pytree import (
      tree_paths_and_leaves)
  reader = _Reader(directory)
  layouts = {p: _as_layout(s) for p, s in (shardings or {}).items()}
  if target is None:
    dev = resolve_device(device)
    names = [p for p in reader.index["leaves"]
             if leaf_filter is None or leaf_filter(p)]
    reader.load(names)
    return {p: reader.tensor(p, layout=layouts.get(p)).to(dev)
            for p in names}, reader.step
  reader.load(_apply_assign_map(p, assign_map)
              for p, _ in tree_paths_and_leaves(target))
  dev = None if device is None else resolve_device(device)
  offsets = slice_offsets or {}

  def load(path, leaf):
    value = reader.tensor(_apply_assign_map(path, assign_map),
                          tuple(leaf.shape), offsets.get(path),
                          layout=layouts.get(path))
    return value.to(device=dev if dev is not None
                    else getattr(leaf, "device", "cpu"), dtype=leaf.dtype)

  def walk(node, prefix):
    if isinstance(node, dict):
      return {k: walk(v, prefix + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
      return type(node)(walk(v, prefix + (i,)) for i, v in enumerate(node))
    if node is None:
      return None
    return load("/".join(str(p) for p in prefix), node)

  return walk(target, ()), reader.step


def peek_leaf_shapes(directory: str
                     ) -> Tuple[Dict[str, Tuple[int, ...]], int]:
  """Leaf name -> stored shape of the newest VALID checkpoint, from its
  index alone (no shard data is read).  Returns ``({path: shape},
  step)``."""
  for path in _walk_valid_checkpoints(directory):
    with open(os.path.join(path, INDEX_FILE)) as f:
      index = json.load(f)
    shapes = {p: tuple(info.get("shape", ()))
              for p, info in index["leaves"].items()}
    return shapes, int(index.get("step", 0))
  raise FileNotFoundError(f"no valid checkpoint under {directory!r}")


def latest_step(directory: str) -> Optional[int]:
  """Step of the newest VALID checkpoint under ``directory``, or None."""
  try:
    for path in _walk_valid_checkpoints(directory):
      try:
        with open(os.path.join(path, INDEX_FILE)) as f:
          return json.load(f).get("step")
      except (OSError, ValueError):  # pragma: no cover - raced deletion
        continue
  except (FileNotFoundError, NoValidCheckpointError):
    return None
  return None


# ------------------------------------------ the JAX layout of a state --


def _is_kernel(path: str) -> bool:
  return path.rsplit("/", 1)[-1] == "kernel"


def _stored_perm(path: str, ndim: int) -> Optional[Tuple[int, ...]]:
  """How a port leaf's dims map to the JAX layout's (dim ``i`` stored is
  dim ``perm[i]`` of the port's): Dense kernels ``[out, in]`` ->
  ``[in, out]`` (a pipelined model's stacked ``[S, out, in]`` -> ``[S,
  in, out]``), Conv kernels ``[out, in, kh, kw]`` -> HWIO; None: as is."""
  if not _is_kernel(path):
    return None
  return {2: (1, 0), 3: (0, 2, 1), 4: (2, 3, 1, 0)}.get(ndim)


def _stored(path: str, t: torch.Tensor) -> torch.Tensor:
  """A port leaf in the JAX layout (a view)."""
  perm = _stored_perm(path, t.dim())
  t = t.detach()
  return t if perm is None else t.permute(perm)


def _stored_shape(path: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
  """The JAX layout's shape of a port leaf of ``shape``."""
  perm = _stored_perm(path, len(shape))
  return tuple(shape) if perm is None else tuple(shape[i] for i in perm)


def _from_stored(path: str, value: torch.Tensor) -> torch.Tensor:
  """The inverse of :func:`_stored`."""
  perm = _stored_perm(path, value.dim())
  return value if perm is None else value.permute(
      tuple(int(i) for i in np.argsort(perm)))


def _laid(path: str, value: torch.Tensor, layouts, key: str = ""):
  """A port leaf as the saver takes it: in the JAX layout, wrapped as
  :class:`Sharded` with ``layouts[key]`` (permuted alike; replicated
  without a key) when ``layouts`` are given."""
  stored = _stored(path, value)
  if layouts is None:
    return stored
  return Sharded(stored, _permuted(layouts.get(key, ()) if key else (),
                                   _stored_perm(path, value.dim())))


def model_state_tree(model_state: Dict[str, torch.Tensor],
                     shardings=None) -> Dict[str, Any]:
  """A :class:`~easyparallellibrary_tpu_torch.parallel.api.
  MutableTrainState`'s ``model_state`` as the JAX package holds it:
  ``{"batch_stats": {jax_path: leaf}}`` (replicated, or
  ``shardings["model_state/<name>"]``, when ``shardings`` are given)."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
  return {"batch_stats": {
      jax_path(n): _laid(jax_path(n), t, shardings, f"model_state/{n}")
      for n, t in model_state.items()}}


def params_tree(params: Dict[str, torch.Tensor], shardings=None
                ) -> Dict[str, Any]:
  """The port's parameter dict as the JAX package's params tree:
  ``{jax_path: leaf}`` with Dense kernels transposed (views).  With
  ``shardings`` (``{name: spec}``, ``parallel.api.param_specs``) each
  leaf is :class:`Sharded` by its spec, for a save under a process
  group."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
  return {jax_path(name): _laid(jax_path(name), p, shardings, name)
          for name, p in params.items()}


def _adam_state(opt: torch.optim.Optimizer, p: torch.Tensor):
  st = opt.state.get(p, {})
  if "exp_avg" not in st:
    return None
  return st


def _owner(state, name: str) -> torch.Tensor:
  """The tensor the optimizer steps for parameter ``name``: a ZeRO
  state's owner slice, else the parameter."""
  zero = getattr(state, "zero", None)
  return zero.owners[name] if zero is not None else state.params[name]


def state_tree(state, shardings=None) -> Dict[str, Any]:
  """What ``fit`` checkpoints, laid out as the JAX package's ``fit``
  writes it: ``{"params": ..., "opt_state": ({"count", "mu", "nu"},)}``
  — optax's Adam state; for an optimizer built through
  ``ops.adamw.inject_hyperparams``, ``inject_hyperparams``' state around
  it, the learning rate included.  Before the first step the moments
  are zeros and the count 0, as ``tx.init`` makes them.  A ZeRO state's
  moments are its owner slices'.  With ``shardings`` (the state's
  layouts, ``parallel.api.state_shardings``: the moments of a ZeRO
  state under ``opt_state/<name>``) every leaf is :class:`Sharded`, so
  :func:`save_checkpoint` gathers them under a process group."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
  opt = state.opt_state
  zero = getattr(state, "zero", None) is not None
  mu, nu, count = {}, {}, None
  for name in state.params:
    path = jax_path(name)
    owner = _owner(state, name)
    key = f"opt_state/{name}" if zero else name
    st = _adam_state(opt, owner)
    if st is None:
      zeros = torch.zeros_like(owner)
      mu[path] = nu[path] = _laid(path, zeros, shardings, key)
      continue
    mu[path] = _laid(path, st["exp_avg"], shardings, key)
    nu[path] = _laid(path, st["exp_avg_sq"], shardings, key)
    if count is None:
      count = st["step"]
  if count is None:
    count = torch.zeros((), dtype=torch.int32)
  count = _laid("count", torch.as_tensor(count).detach().reshape(()).to(
      torch.int32), shardings)
  params = params_tree(state.params, shardings)
  adam = {"count": count, "mu": mu, "nu": nu}
  extra = {}
  if getattr(state, "model_state", None):
    extra["model_state"] = model_state_tree(state.model_state, shardings)
  if not getattr(opt, "inject_hyperparams", False):
    return {"params": params, "opt_state": (adam,), **extra}
  # optax.inject_hyperparams(optax.adamw)'s state: the hyperparameters
  # beside the inner chain's Adam state (its EmptyStates hold no leaf).
  group = opt.param_groups[0]
  hyper = {"b1": group["betas"][0], "b2": group["betas"][1],
           "eps": group["eps"], "eps_root": 0.0,
           "learning_rate": group["lr"],
           "weight_decay": group["weight_decay"]}
  hyper = {k: _laid(k, torch.as_tensor(float(v), dtype=torch.float32),
                    shardings)
           for k, v in hyper.items()}
  return {"params": params,
          "opt_state": {"count": count, "hyperparams": hyper,
                        "inner_state": (adam,)}, **extra}


def _fill_adam_state(opt: torch.optim.Optimizer, p: torch.Tensor,
                     mu: torch.Tensor, nu: torch.Tensor, count: int):
  """Set one parameter's AdamW state, creating it on a fresh optimizer
  (the per-parameter ``step`` in the form the optimizer's group wants:
  a float32 tensor on the parameter's device when fused or capturable,
  else on the CPU)."""
  group = next(g for g in opt.param_groups
               if any(q is p for q in g["params"]))
  on_device = group.get("fused") or group.get("capturable")
  st = opt.state[p]
  if "exp_avg" not in st:
    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    st["exp_avg_sq"] = torch.zeros_like(
        p, memory_format=torch.preserve_format)
  with torch.no_grad():
    st["exp_avg"].copy_(mu)
    st["exp_avg_sq"].copy_(nu)
  st["step"] = torch.tensor(float(count), dtype=torch.float32,
                            device=p.device if on_device else "cpu")


def restore_train_state(directory: str, state, after_step: int = -1,
                        assign_map: Optional[Dict[str, str]] = None,
                        shardings: Optional[Dict[str, Any]] = None):
  """Restore the newest VALID checkpoint under ``directory`` INTO the
  live ``state`` (parameters, both moments and every parameter's
  ``step``, written in place on the parameters' device; every group's
  learning rate too, from a checkpoint of an ``inject_hyperparams``
  state) when its step is above ``after_step``; sets ``state.step``.
  Each leaf is this rank's block of the stored logical leaf by the
  state's layouts (``shardings``, default ``parallel.api.
  state_shardings(state)``; a ZeRO state's moments by ``opt_state/
  <name>`` into its owner slices, which also take the restored
  parameters' values).  Returns ``(state, step)``, ``step`` None when the
  chain is empty (FileNotFoundError and :class:`NoValidCheckpointError`
  propagate as from :func:`restore_checkpoint`).  A checkpoint at or
  below ``after_step`` is validated but not read."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
  from easyparallellibrary_tpu_torch.parallel.api import state_shardings
  layouts = state_shardings(state) if shardings is None else shardings
  zero = getattr(state, "zero", None)
  with trace_lib.get_tracer().span("checkpoint/restore",
                                   cat="checkpoint", track="checkpoint"):
    for path in _walk_valid_checkpoints(directory):
      reader = _Reader(path)
      rstep = int(reader.step) if reader.step is not None else 0
      if rstep <= after_step:
        return state, rstep
      # optax's plain adamw state, or inject_hyperparams' (the Adam
      # state one level down, the learning rate beside it).
      adam = next((a for a in ("opt_state/0/", "opt_state/inner_state/0/")
                   if reader.has(a + "count")), None)
      has_opt = adam is not None
      count = int(reader.raw(adam + "count")) if has_opt else 0
      prefixes = ("params/",) + ((adam + "mu/", adam + "nu/")
                                 if has_opt else ())
      reader.load(_apply_assign_map(f"{prefix}{jax_path(name)}", assign_map)
                  for prefix in prefixes for name in state.params)

      model_state = getattr(state, "model_state", None) or {}
      reader.load(_apply_assign_map(f"model_state/batch_stats/"
                                    f"{jax_path(name)}", assign_map)
                  for name in model_state)

      def load(prefix, name, live, key):
        jpath = jax_path(name)
        ck = _apply_assign_map(f"{prefix}{jpath}", assign_map)
        perm = _stored_perm(jpath, live.dim())
        value = reader.tensor(ck, _stored_shape(jpath, tuple(live.shape)),
                              layout=_permuted(layouts.get(key, ()), perm))
        return _from_stored(jpath, value.to(live.device, live.dtype))

      for name, t in model_state.items():
        with torch.no_grad():
          t.copy_(load("model_state/batch_stats/", name, t,
                       f"model_state/{name}"))

      opt = state.opt_state
      for name, p in state.params.items():
        with torch.no_grad():
          p.copy_(load("params/", name, p, name))
        owner = _owner(state, name)
        if owner is not p:
          d, dp = zero.dims[name], zero.dp
          block = p.shape[d] // dp
          idx = int(collectives.axis_index(constants.DATA_AXIS))
          with torch.no_grad():
            owner.copy_(p.narrow(d, idx * block, block))
        if has_opt:
          key = f"opt_state/{name}" if zero is not None else name
          _fill_adam_state(opt, owner, load(adam + "mu/", name, owner, key),
                           load(adam + "nu/", name, owner, key), count)
        else:
          opt.state.pop(owner, None)
      if reader.has("opt_state/hyperparams/learning_rate"):
        lr = float(reader.raw("opt_state/hyperparams/learning_rate"))
        for group in opt.param_groups:
          group["lr"] = lr
      state.step = rstep
      return state, rstep


def restore_params(directory: str, target=None, device=None,
                   assign_map: Optional[Dict[str, str]] = None,
                   shardings: Optional[Dict[str, Any]] = None):
  """Params-only restore for serving: the newest VALID checkpoint's
  model parameters as the port's state dict (``{name: tensor}``, Dense
  kernels ``[out, in]``) on ``device`` (default the GPU).  Optimizer
  moments and counters are never read.

  Works on a train-state checkpoint (leaves under ``params/``, the
  layout of ``fit``) and on a bare params tree.  ``target`` (a port
  state dict) restricts the load to its names, slices to its shapes and
  casts to its dtypes; ``shardings`` (``{name: spec}``, ``parallel.api.
  param_specs`` of the serving model) makes each such parameter this
  rank's block of the stored logical leaf (a tensor-parallel engine's
  slices of a checkpoint written at any layout).  Explicit
  ``assign_map`` patterns win over the automatic ``params/`` prefix and
  map JAX paths to full checkpoint names.  Returns ``(params, step)``."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
  from easyparallellibrary_tpu_torch.weights import _torch_name
  dev = resolve_device(device)
  prefix = "params/"
  layouts = shardings or {}
  for path in _walk_valid_checkpoints(directory):
    reader = _Reader(path)
    prefixed = any(p.startswith(prefix) for p in reader.index["leaves"])
    amap = dict(assign_map) if assign_map else {}
    if prefixed:
      amap.setdefault("^", prefix)
    if target is None:
      names = [p[len(prefix):] if prefixed else p
               for p in reader.index["leaves"]
               if not prefixed or p.startswith(prefix)]
      wanted = {_torch_name(p): (p, None, None) for p in names}
    else:
      wanted = {}
      for name, leaf in target.items():
        jpath = jax_path(name)
        wanted[name] = (jpath, tuple(leaf.shape), leaf.dtype)
    reader.load(_apply_assign_map(jpath, amap)
                for jpath, _, _ in wanted.values())
    out = {}
    for name, (jpath, shape, dtype) in wanted.items():
      ck = _apply_assign_map(jpath, amap)
      ndim = len(shape) if shape is not None else reader.raw(ck).ndim
      perm = _stored_perm(jpath, ndim)
      layout = layouts.get(name)
      value = reader.tensor(
          ck, None if shape is None else _stored_shape(jpath, shape),
          layout=None if layout is None else _permuted(layout, perm))
      value = _from_stored(jpath, value).contiguous()
      out[name] = value.to(device=dev, dtype=dtype or value.dtype)
    return out, reader.step
  raise FileNotFoundError(f"no valid checkpoint under {directory!r}")


# ----------------------------------------------------------------- orbax --
#
# The JAX package's second, optional path writes orbax checkpoints; the
# port's counterpart is torch.distributed.checkpoint (DCP).  The two
# formats are not each other's: the native step_N format above is the one
# both packages read.  DCP takes one tensor a key from every rank and
# writes one copy of the keys it holds as replicated, so under a process
# group each leaf is first gathered to its whole (the native path's
# layouts): distinct shards never pass for copies.


def _dcp_path(directory: str, step: int) -> str:
  return os.path.join(os.path.abspath(directory), f"step_{int(step)}")


@contextlib.contextmanager
def _dcp_quiet():
  """DCP's warning that it runs in one process without a process group:
  a design of this path, not a fault."""
  import warnings
  with warnings.catch_warnings():
    warnings.filterwarnings("ignore", message=".*single process.*")
    yield


def save_checkpoint_orbax(directory: str, tree, step: int = 0,
                          shardings: Optional[Dict[str, Any]] = None) -> str:
  """Save ``tree`` (nested dicts / lists / tuples of tensors or arrays)
  with DCP's file-system writer under ``directory/step_<step>``, one
  entry per leaf path (``"opt_state/0/mu/wte/embedding"``), and return
  the path.  Under a process group every rank calls it and every leaf
  needs a layout (``shardings`` or :class:`Sharded` leaves, as for
  :func:`save_checkpoint`): it is stored whole, at its logical shape."""
  import torch.distributed.checkpoint as dcp
  path = _dcp_path(directory, step)
  flat = {}
  for name, value, layout in _resolve_layouts(_sorted_leaves(tree),
                                              shardings):
    if layout is not None:
      value = _gather(value, layout)
    flat[name] = (value.detach() if isinstance(value, torch.Tensor)
                  else torch.as_tensor(np.asarray(value)))
  with trace_lib.get_tracer().span("checkpoint/save_dcp", cat="checkpoint",
                                   track="checkpoint"):
    with _dcp_quiet():
      dcp.save(flat, checkpoint_id=path)
  get_logger().info("saved DCP checkpoint: %s (%d leaves)", path, len(flat))
  return path


def restore_checkpoint_orbax(directory: str, step: int, target=None,
                             device=None,
                             shardings: Optional[Dict[str, Any]] = None):
  """Read a :func:`save_checkpoint_orbax` checkpoint.  With ``target``
  (a tree of tensors) the result has its structure, each leaf in the
  target leaf's dtype on its device; without, ``{path: tensor}`` on
  ``device`` (default the GPU).  ``shardings`` (``{path: spec}``): each
  such leaf is this rank's block of the stored whole."""
  import torch.distributed.checkpoint as dcp
  path = _dcp_path(directory, step)
  if not os.path.isfile(os.path.join(path, ".metadata")):
    raise FileNotFoundError(
        f"{path!r} is no DCP checkpoint: this path reads what "
        f"save_checkpoint_orbax wrote, not orbax's format; the native "
        f"step_N format is the one both packages read")
  meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
  flat = {name: torch.empty(m.size, dtype=m.properties.dtype)
          for name, m in meta.items()}
  with trace_lib.get_tracer().span("checkpoint/restore_dcp",
                                   cat="checkpoint", track="checkpoint"):
    with _dcp_quiet():
      dcp.load(flat, checkpoint_id=path)
  layouts = {p: _as_layout(s) for p, s in (shardings or {}).items()}

  def block(name, local_shape=None):
    value = flat[name]
    if name not in layouts:
      return value
    bf16 = value.dtype == torch.bfloat16
    host = (value.view(torch.int16) if bf16 else value).numpy()
    out = torch.from_numpy(np.ascontiguousarray(
        _narrow(host, layouts[name], local_shape=local_shape)))
    return out.view(torch.bfloat16) if bf16 else out

  if target is None:
    dev = resolve_device(device)
    return {name: block(name).to(dev) for name in flat}

  def walk(node, prefix):
    if isinstance(node, dict):
      return {k: walk(v, prefix + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
      return type(node)(walk(v, prefix + (i,)) for i, v in enumerate(node))
    if node is None:
      return None
    name = "/".join(str(p) for p in prefix)
    if name not in flat:
      raise KeyError(f"DCP checkpoint {path!r} has no leaf {name!r}")
    value = block(name, tuple(node.shape))
    if tuple(value.shape) != tuple(node.shape):
      raise ValueError(f"leaf {name!r}: checkpoint shape "
                       f"{tuple(value.shape)}, target {tuple(node.shape)}")
    return value.to(device=getattr(node, "device", "cpu"), dtype=node.dtype)

  return walk(target, ())
