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
rate rather than one core's.  Only process 0 (the ``torch.distributed``
rank) writes; every process can restore.  The JAX package's orbax path
is ``torch.distributed.checkpoint`` here (:func:`save_checkpoint_orbax`,
:func:`restore_checkpoint_orbax`): a format of its own, read only by
itself.
"""

from __future__ import annotations

import collections
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
  if dtype_name == _BF16 or value.dtype.kind == "V":
    if value.dtype.itemsize != 2:
      raise ValueError(f"cannot read a {value.dtype} leaf as {dtype_name}")
    return torch.from_numpy(
        np.ascontiguousarray(value).view(np.int16)).view(torch.bfloat16)
  return torch.from_numpy(np.ascontiguousarray(value))


def _leaf_nbytes(leaf) -> int:
  from easyparallellibrary_tpu_torch.utils.pytree import leaf_bytes
  return leaf_bytes(leaf)


# -------------------------------------------------------------- save --


def save_checkpoint(directory: str, tree, step: Optional[int] = None,
                    shard_mb: Optional[int] = None,
                    keep_last: Optional[int] = None,
                    atomic: Optional[bool] = None) -> str:
  """Write ``tree`` (nested dicts / lists / tuples of tensors or arrays)
  as checkpoint ``directory/step_N`` and return the committed path.

  Leaves are fetched and written bucket by bucket (<= ``shard_mb``,
  default 50 MB), so host memory stays bounded.  With ``atomic``
  (default ``resilience.atomic_checkpoints``) the checkpoint is staged
  in ``step_N.tmp`` — per-shard sha256 in the index, everything fsynced
  — and committed by one directory rename.  ``keep_last`` (default
  ``resilience.keep_last``; 0 keeps all) prunes older checkpoints after
  the commit.  A train state goes through :func:`state_tree` first.
  """
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.utils.retry import retry_call
  res = Env.get().config.resilience
  if atomic is None:
    atomic = res.atomic_checkpoints
  if keep_last is None:
    keep_last = res.keep_last
  is_leader = _is_leader()
  limit = (shard_mb or constants.DEFAULT_SAVE_SHARD_MB) * 1024 * 1024

  step_num = 0 if step is None else int(step)
  final_dir = os.path.join(directory, _step_dir_name(step_num))
  write_dir = final_dir + TMP_SUFFIX if atomic else final_dir
  if is_leader:
    os.makedirs(directory, exist_ok=True)
    if os.path.isdir(write_dir):
      shutil.rmtree(write_dir)
    os.makedirs(write_dir)

  flat = _sorted_leaves(tree)
  index: Dict[str, Any] = {"step": step, "format": 2, "leaves": {},
                           "shards": []}
  bucket: List[Tuple[str, Any]] = []
  bucket_bytes = 0
  shard_id = 0
  written: List[Tuple[str, Any]] = []     # (file, future), shard order
  in_flight: collections.deque = collections.deque()

  def flush(pool):
    nonlocal bucket, bucket_bytes, shard_id
    if not bucket:
      return
    fname = f"shard_{shard_id:05d}.npz"
    arrays = {}
    for path, leaf in bucket:
      arrays[path] = _to_host(leaf)
      index["leaves"][path] = {"shard": fname,
                               "shape": list(arrays[path].shape),
                               "dtype": _dtype_name(leaf)}
    if is_leader:
      while len(in_flight) >= 2 * _IO_WORKERS:   # bound host memory
        in_flight.popleft().result()
      future = pool.submit(retry_call, _write_shard,
                           os.path.join(write_dir, fname), arrays,
                           what=f"checkpoint shard write {fname}")
      written.append((fname, future))
      in_flight.append(future)
    shard_id += 1
    bucket, bucket_bytes = [], 0

  tracer = trace_lib.get_tracer()
  with tracer.span("checkpoint/stage", cat="checkpoint",
                   track="checkpoint", args={"step": step_num}), \
      ThreadPoolExecutor(_IO_WORKERS) as pool:
    for path, leaf in flat:
      nbytes = _leaf_nbytes(leaf)
      if bucket and bucket_bytes + nbytes > limit:
        flush(pool)
      bucket.append((path, leaf))
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
                    offsets: Optional[Tuple[int, ...]] = None
                    ) -> np.ndarray:
  """begin/size slicing at load: a stored value larger than the target
  is cut to ``shape`` at ``offsets`` (default the origin)."""
  if tuple(value.shape) == tuple(shape):
    return value
  if len(value.shape) != len(shape):
    raise ValueError(f"rank mismatch restoring {value.shape} -> {shape}")
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

  def tensor(self, path: str, shape=None, offsets=None) -> torch.Tensor:
    value = self.raw(path)
    if shape is not None:
      value = _slice_to_shape(value, tuple(shape), offsets)
    return _from_host(value, str(self.index["leaves"][path].get("dtype")))


def restore_checkpoint(directory: str, target=None,
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
  * ``assign_map``: ``{regex: replacement}`` applied to the target's
    paths to find the checkpoint's names.

  Returns ``(tree, step)``, ``step`` from the checkpoint restored.
  """
  with trace_lib.get_tracer().span("checkpoint/restore",
                                   cat="checkpoint", track="checkpoint"):
    for path in _walk_valid_checkpoints(directory):
      return _restore_from(path, target, assign_map, slice_offsets,
                           device=device)


def _restore_from(directory: str, target=None,
                  assign_map: Optional[Dict[str, str]] = None,
                  slice_offsets: Optional[Dict[str, Tuple[int, ...]]] = None,
                  leaf_filter=None, device=None):
  from easyparallellibrary_tpu_torch.utils.pytree import (
      tree_paths_and_leaves)
  reader = _Reader(directory)
  if target is None:
    dev = resolve_device(device)
    names = [p for p in reader.index["leaves"]
             if leaf_filter is None or leaf_filter(p)]
    reader.load(names)
    return {p: reader.tensor(p).to(dev) for p in names}, reader.step
  reader.load(_apply_assign_map(p, assign_map)
              for p, _ in tree_paths_and_leaves(target))
  dev = None if device is None else resolve_device(device)
  offsets = slice_offsets or {}

  def load(path, leaf):
    value = reader.tensor(_apply_assign_map(path, assign_map),
                          tuple(leaf.shape), offsets.get(path))
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


def _stored(path: str, t: torch.Tensor) -> torch.Tensor:
  """A port leaf in the JAX layout: Dense kernels ``[out, in]`` ->
  ``[in, out]``, Conv kernels ``[out, in, kh, kw]`` -> HWIO."""
  t = t.detach()
  if _is_kernel(path) and t.dim() == 2:
    return t.t()
  if _is_kernel(path) and t.dim() == 4:
    return t.permute(2, 3, 1, 0)
  return t


def _stored_shape(path: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
  """The JAX layout's shape of a port leaf of ``shape``."""
  if _is_kernel(path) and len(shape) == 2:
    return shape[::-1]
  if _is_kernel(path) and len(shape) == 4:
    return (shape[2], shape[3], shape[1], shape[0])
  return shape


def _from_stored(path: str, value: torch.Tensor) -> torch.Tensor:
  """The inverse of :func:`_stored`."""
  if _is_kernel(path) and value.dim() == 2:
    return value.t()
  if _is_kernel(path) and value.dim() == 4:
    return value.permute(3, 2, 0, 1)
  return value


def model_state_tree(model_state: Dict[str, torch.Tensor]
                     ) -> Dict[str, Any]:
  """A :class:`~easyparallellibrary_tpu_torch.parallel.api.
  MutableTrainState`'s ``model_state`` as the JAX package holds it:
  ``{"batch_stats": {jax_path: leaf}}``."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
  return {"batch_stats": {jax_path(n): t.detach()
                          for n, t in model_state.items()}}


def params_tree(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """The port's parameter dict as the JAX package's params tree:
  ``{jax_path: leaf}`` with Dense kernels transposed (views)."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
  out = {}
  for name, p in params.items():
    path = jax_path(name)
    out[path] = _stored(path, p)
  return out


def _adam_state(opt: torch.optim.Optimizer, p: torch.Tensor):
  st = opt.state.get(p, {})
  if "exp_avg" not in st:
    return None
  return st


def state_tree(state) -> Dict[str, Any]:
  """What ``fit`` checkpoints, laid out as the JAX package's ``fit``
  writes it: ``{"params": ..., "opt_state": ({"count", "mu", "nu"},)}``
  — optax's Adam state; for an optimizer built through
  ``ops.adamw.inject_hyperparams``, ``inject_hyperparams``' state around
  it, the learning rate included.  Before the first step the moments
  are zeros and the count 0, as ``tx.init`` makes them."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
  opt = state.opt_state
  mu, nu, count = {}, {}, None
  for name, p in state.params.items():
    path = jax_path(name)
    st = _adam_state(opt, p)
    if st is None:
      zeros = torch.zeros_like(_stored(path, p))
      mu[path], nu[path] = zeros, zeros
      continue
    mu[path] = _stored(path, st["exp_avg"])
    nu[path] = _stored(path, st["exp_avg_sq"])
    if count is None:
      count = st["step"]
  if count is None:
    count = torch.zeros((), dtype=torch.int32)
  count = torch.as_tensor(count).detach().reshape(()).to(torch.int32)
  adam = {"count": count, "mu": mu, "nu": nu}
  extra = {}
  if getattr(state, "model_state", None):
    extra["model_state"] = model_state_tree(state.model_state)
  if not getattr(opt, "inject_hyperparams", False):
    return {"params": params_tree(state.params), "opt_state": (adam,),
            **extra}
  # optax.inject_hyperparams(optax.adamw)'s state: the hyperparameters
  # beside the inner chain's Adam state (its EmptyStates hold no leaf).
  group = opt.param_groups[0]
  hyper = {"b1": group["betas"][0], "b2": group["betas"][1],
           "eps": group["eps"], "eps_root": 0.0,
           "learning_rate": group["lr"],
           "weight_decay": group["weight_decay"]}
  hyper = {k: torch.as_tensor(float(v), dtype=torch.float32)
           for k, v in hyper.items()}
  return {"params": params_tree(state.params),
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
                        assign_map: Optional[Dict[str, str]] = None):
  """Restore the newest VALID checkpoint under ``directory`` INTO the
  live ``state`` (parameters, both moments and every parameter's
  ``step``, written in place on the parameters' device; every group's
  learning rate too, from a checkpoint of an ``inject_hyperparams``
  state) when its step is above ``after_step``; sets ``state.step``.  Returns ``(state,
  step)``, ``step`` None when the chain is empty (FileNotFoundError and
  :class:`NoValidCheckpointError` propagate as from
  :func:`restore_checkpoint`).  A checkpoint at or below
  ``after_step`` is validated but not read."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
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

      def load(prefix, name, live):
        jpath = jax_path(name)
        ck = _apply_assign_map(f"{prefix}{jpath}", assign_map)
        shape = _stored_shape(jpath, tuple(live.shape))
        value = reader.tensor(ck, shape).to(live.device, live.dtype)
        return _from_stored(jpath, value)

      for name, t in model_state.items():
        with torch.no_grad():
          t.copy_(load("model_state/batch_stats/", name, t))

      opt = state.opt_state
      for name, p in state.params.items():
        with torch.no_grad():
          p.copy_(load("params/", name, p))
        if has_opt:
          _fill_adam_state(opt, p, load(adam + "mu/", name, p),
                           load(adam + "nu/", name, p), count)
        else:
          opt.state.pop(p, None)
      if reader.has("opt_state/hyperparams/learning_rate"):
        lr = float(reader.raw("opt_state/hyperparams/learning_rate"))
        for group in opt.param_groups:
          group["lr"] = lr
      state.step = rstep
      return state, rstep


def restore_params(directory: str, target=None, device=None,
                   assign_map: Optional[Dict[str, str]] = None):
  """Params-only restore for serving: the newest VALID checkpoint's
  model parameters as the port's state dict (``{name: tensor}``, Dense
  kernels ``[out, in]``) on ``device`` (default the GPU).  Optimizer
  moments and counters are never read.

  Works on a train-state checkpoint (leaves under ``params/``, the
  layout of ``fit``) and on a bare params tree.  ``target`` (a port
  state dict) restricts the load to its names, slices to its shapes and
  casts to its dtypes; explicit ``assign_map`` patterns win over the
  automatic ``params/`` prefix and map JAX paths to full checkpoint
  names.  Returns ``(params, step)``."""
  from easyparallellibrary_tpu_torch.ops.adamw import jax_path
  from easyparallellibrary_tpu_torch.weights import _torch_name
  dev = resolve_device(device)
  prefix = "params/"
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
      stored_shape = None if shape is None else _stored_shape(jpath, shape)
      value = reader.tensor(_apply_assign_map(jpath, amap), stored_shape)
      value = _from_stored(jpath, value).contiguous()
      out[name] = value.to(device=dev, dtype=dtype or value.dtype)
    return out, reader.step
  raise FileNotFoundError(f"no valid checkpoint under {directory!r}")


# ----------------------------------------------------------------- orbax --
#
# The JAX package's second, optional path writes orbax checkpoints; the
# port's counterpart is torch.distributed.checkpoint (DCP), in one process
# with no process group.  The two formats are not each other's: the
# native step_N format above is the one both packages read.


def _dcp_path(directory: str, step: int) -> str:
  return os.path.join(os.path.abspath(directory), f"step_{int(step)}")


def save_checkpoint_orbax(directory: str, tree, step: int = 0) -> str:
  """Save ``tree`` (nested dicts / lists / tuples of tensors or arrays)
  with DCP's file-system writer under ``directory/step_<step>``, one
  entry per leaf path (``"opt_state/0/mu/wte/embedding"``), and return
  the path."""
  import warnings

  import torch.distributed.checkpoint as dcp
  path = _dcp_path(directory, step)
  flat = {name: (leaf.detach() if isinstance(leaf, torch.Tensor)
                 else torch.as_tensor(np.asarray(leaf)))
          for name, leaf in _sorted_leaves(tree)}
  with trace_lib.get_tracer().span("checkpoint/save_dcp", cat="checkpoint",
                                   track="checkpoint"):
    with warnings.catch_warnings():
      # One process without a process group is this path's design.
      warnings.filterwarnings("ignore", message=".*single process.*")
      dcp.save(flat, checkpoint_id=path)
  get_logger().info("saved DCP checkpoint: %s (%d leaves)", path, len(flat))
  return path


def restore_checkpoint_orbax(directory: str, step: int, target=None,
                             device=None):
  """Read a :func:`save_checkpoint_orbax` checkpoint.  With ``target``
  (a tree of tensors) the result has its structure, each leaf in the
  target leaf's dtype on its device; without, ``{path: tensor}`` on
  ``device`` (default the GPU)."""
  import warnings

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
    with warnings.catch_warnings():
      warnings.filterwarnings("ignore", message=".*single process.*")
      dcp.load(flat, checkpoint_id=path)
  if target is None:
    dev = resolve_device(device)
    return {name: t.to(dev) for name, t in flat.items()}

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
    value = flat[name]
    if tuple(value.shape) != tuple(node.shape):
      raise ValueError(f"leaf {name!r}: checkpoint shape "
                       f"{tuple(value.shape)}, target {tuple(node.shape)}")
    return value.to(device=getattr(node, "device", "cpu"), dtype=node.dtype)

  return walk(target, ())
