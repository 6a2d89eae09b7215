"""Record files and the record reader (port of
``easyparallellibrary_tpu/io/dataloader.py``).

The record format is the JAX package's: each record is a uint64
little-endian length and its payload.  The native reader is host C++
(``io/csrc/epl_tpu_io.cc``, a copy of the JAX package's
``csrc/epl_tpu_io.cc``) bound with ctypes: a thread pool that reads
ahead into a bounded queue in a deterministic order.  It is built at
first use with the host C++ compiler into the package's ``_build/``
directory, keyed by a hash of the source, as ``kernels/_build.py``
builds the CUDA sources.  ``use_native=True`` raises when the build or
the load fails; ``use_native=None`` takes the native reader when it
loads, else the Python reader (logged once).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

from easyparallellibrary_tpu_torch.env import Env
from easyparallellibrary_tpu_torch.utils.logging import get_logger

SOURCE = Path(__file__).resolve().parent / "csrc" / "epl_tpu_io.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_LIB = None
_LIB_ERROR: Optional[BaseException] = None
_LOCK = threading.Lock()


class NativeIOBuildError(RuntimeError):
  """The native reader could not be built or loaded."""


def library_path() -> Path:
  digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
  digest.update(SOURCE.read_bytes())
  return BUILD_DIR / f"libepl_tpu_io-{digest.hexdigest()[:16]}.so"


def _find_cxx() -> str:
  for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
    if cand and shutil.which(cand):
      return shutil.which(cand)
  raise NativeIOBuildError(
      "no host C++ compiler found ($CXX, g++, c++ or clang++) to build "
      "the native record reader")


def _build() -> Path:
  out = library_path()
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  # A private name, renamed when complete: another process never loads
  # a half-written library.
  tmp = out.with_suffix(f".{os.getpid()}.tmp")
  proc = subprocess.run([_find_cxx(), *CXX_FLAGS, str(SOURCE), "-o",
                         str(tmp)], capture_output=True, text=True)
  if proc.returncode != 0:
    raise NativeIOBuildError(
        f"building {SOURCE.name} failed (exit {proc.returncode}):\n"
        f"{proc.stdout}{proc.stderr}")
  os.replace(tmp, out)
  return out


def _bind(lib):
  lib.epl_reader_create.restype = ctypes.c_void_p
  lib.epl_reader_create.argtypes = [
      ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int]
  lib.epl_reader_create_at.restype = ctypes.c_void_p
  lib.epl_reader_create_at.argtypes = [
      ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64]
  lib.epl_reader_next.restype = ctypes.c_int64
  lib.epl_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int64]
  lib.epl_reader_pending_size.restype = ctypes.c_int64
  lib.epl_reader_pending_size.argtypes = [ctypes.c_void_p]
  lib.epl_reader_destroy.argtypes = [ctypes.c_void_p]
  lib.epl_writer_create.restype = ctypes.c_void_p
  lib.epl_writer_create.argtypes = [ctypes.c_char_p]
  lib.epl_writer_write.restype = ctypes.c_int
  lib.epl_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int64]
  lib.epl_writer_close.argtypes = [ctypes.c_void_p]
  return lib


def load_native():
  """The native library, built first if needed; raises
  :class:`NativeIOBuildError` when it cannot be built or loaded (the
  failure is remembered: later calls raise it again without a rebuild)."""
  global _LIB, _LIB_ERROR
  with _LOCK:
    if _LIB is not None:
      return _LIB
    if _LIB_ERROR is not None:
      raise NativeIOBuildError(str(_LIB_ERROR)) from _LIB_ERROR
    try:
      _LIB = _bind(ctypes.CDLL(str(_build())))
    except (OSError, subprocess.SubprocessError, NativeIOBuildError) as e:
      _LIB_ERROR = e
      raise NativeIOBuildError(
          f"native record reader unavailable: {e}") from e
    return _LIB


def _lib_or_none():
  first_failure = _LIB_ERROR is None
  try:
    return load_native()
  except NativeIOBuildError as e:
    if first_failure:
      get_logger().info("native IO library unavailable (%s); using the "
                        "python reader", str(e).splitlines()[0])
    return None


def native_io_available() -> bool:
  """Whether the native reader builds and loads here."""
  return _lib_or_none() is not None


def _resolve(use_native: Optional[bool]):
  if use_native is False:
    return None
  if use_native is True:
    return load_native()
  return _lib_or_none()


def write_records(path: str, records: Sequence[bytes],
                  use_native: Optional[bool] = None):
  """Write a length-prefixed record file (uint64 LE + payload)."""
  lib = _resolve(use_native)
  if lib is not None:
    w = lib.epl_writer_create(path.encode())
    if not w:
      raise IOError(f"cannot open {path} for writing")
    try:
      for rec in records:
        if lib.epl_writer_write(w, rec, len(rec)) != 0:
          raise IOError(f"short write to {path}")
    finally:
      lib.epl_writer_close(w)
    return
  with open(path, "wb") as f:
    for rec in records:
      f.write(struct.pack("<Q", len(rec)))
      f.write(rec)


def _python_reader(files: List[str],
                   skip_records: int = 0) -> Iterator[bytes]:
  from easyparallellibrary_tpu_torch.utils.retry import retry_call
  skip = skip_records
  for fname in files:
    # The open is the transient-failure hot spot on network filesystems
    # (resilience.io_retries bounds the retries; FileNotFoundError stays
    # a hard error).
    with retry_call(open, fname, "rb",
                    what=f"record file open {fname}") as f:
      size = os.fstat(f.fileno()).st_size
      while True:
        header = f.read(8)
        if not header:
          break
        if len(header) != 8:
          raise IOError(f"truncated record header in {fname}")
        (length,) = struct.unpack("<Q", header)
        if skip > 0:
          # Resume: seek past skipped payloads without reading them; a
          # seek never fails past EOF, so truncation is found by position.
          f.seek(length, 1)
          if f.tell() > size:
            raise IOError(f"truncated record in {fname}")
          skip -= 1
          continue
        payload = f.read(length)
        if len(payload) != length:
          raise IOError(f"truncated record in {fname}")
        yield payload
  if skip > 0:
    get_logger().warning(
        "skip_records exhausted the input: %d records remained to skip "
        "after reading all %d files (resume offset beyond dataset?)",
        skip, len(files))


class RecordReader:
  """Iterate records from ``files``, restricted to this worker's shard
  (``shard_index`` of ``num_shards``; with ``io.slicing``, the
  ``torch.distributed`` rank of the world size).  ``skip_records``
  starts the deterministic stream that many records in (resume).  The
  native and the Python reader give the same records in the same
  order."""

  def __init__(self, files: Sequence[str], shard_index: Optional[int] = None,
               num_shards: Optional[int] = None,
               num_threads: Optional[int] = None,
               prefetch_records: int = 256,
               use_native: Optional[bool] = None,
               skip_records: int = 0):
    cfg = Env.get().config
    self.files = list(files)
    if num_shards is None:
      if cfg.io.slicing:
        from easyparallellibrary_tpu_torch.utils.device import (
            process_count, process_index)
        num_shards = process_count()
        if shard_index is None:
          shard_index = process_index()
      else:
        num_shards = 1
    self.shard_index = shard_index or 0
    self.num_shards = max(1, num_shards)
    self.num_threads = num_threads or cfg.io.num_threads
    self.prefetch_records = prefetch_records
    self.skip_records = max(0, int(skip_records))
    self._lib = _resolve(use_native)
    self._native = self._lib is not None

  def _shard(self) -> List[str]:
    from easyparallellibrary_tpu_torch.io.sharding import shard_files
    return shard_files(self.files, self.num_shards, self.shard_index)

  def __iter__(self) -> Iterator[bytes]:
    if not self._native:
      yield from _python_reader(self._shard(), self.skip_records)
      return
    lib = self._lib
    # Sliced in Python (one policy for both readers); the native reader
    # gets the sliced list as its single shard.
    mine = self._shard()
    c_files = (ctypes.c_char_p * len(mine))(*[f.encode() for f in mine])
    handle = lib.epl_reader_create_at(
        c_files, len(mine), 0, 1, self.num_threads, self.prefetch_records,
        self.skip_records)
    cap = 1 << 16
    buf = ctypes.create_string_buffer(cap)
    try:
      while True:
        n = lib.epl_reader_next(handle, buf, cap)
        if n == -1:
          break
        if n == -2:
          cap = max(lib.epl_reader_pending_size(handle), cap * 2)
          buf = ctypes.create_string_buffer(cap)
          continue
        yield buf.raw[:n]
    finally:
      lib.epl_reader_destroy(handle)
