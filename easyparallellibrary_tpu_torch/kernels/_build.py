"""Build and load the port's CUDA kernels.

Each kernel source ``csrc/<name>.cu`` exposes a plain ``extern "C"``
interface and is compiled by ``nvcc`` into its own shared library, which
is loaded with ctypes.  Nothing is built at import time: a kernel is
built at its first use (or by :func:`build`), into ``BUILD_DIR``, under
a file name keyed by a hash of its source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited source or header
never loads a stale library.  The tensor-map encoder that TMA needs
(``cuTensorMapEncodeTiled``, in libcuda) is looked up at run time
through the CUDA runtime, so the libraries link nothing beyond what
``nvcc -shared`` links.

There is no fallback: a missing ``nvcc``, a failed compile or a failed
load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

KERNELS = ("paged_attention", "flash_attention")
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class NvccNotFoundError(RuntimeError):
  """No CUDA compiler: the kernels cannot be built on this machine."""


class KernelBuildError(RuntimeError):
  """nvcc refused a kernel source."""


def find_nvcc() -> str:
  """``nvcc`` from ``$CUDA_HOME/bin``, the ``PATH``, or the default CUDA
  install, in that order; raises :class:`NvccNotFoundError`."""
  candidates: List[str] = []
  if os.environ.get("CUDA_HOME"):
    candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
  on_path = shutil.which("nvcc")
  if on_path:
    candidates.append(on_path)
  candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
  for path in candidates:
    if os.path.isfile(path) and os.access(path, os.X_OK):
      return path
  raise NvccNotFoundError(
      "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
      f"{DEFAULT_CUDA_HOME}/bin): the port's CUDA kernels are built from "
      "source on the machine with the GPU")


def library_path(name: str) -> Path:
  """Where kernel ``name``'s library is built: keyed by a hash of its
  source, every header under ``csrc/`` (a source may include any of
  them) and the compiler flags."""
  digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
    digest.update(path.name.encode() + b"\0" + path.read_bytes())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
  """Compile every named kernel that is not built yet, one ``nvcc`` per
  source, all started together.  Returns each compiled kernel's compiler
  report (``-Xptxas -v``: registers, shared memory, spills)."""
  todo = [name for name in dict.fromkeys(names)
          if not library_path(name).exists()]
  if not todo:
    return {}
  nvcc = find_nvcc()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs = {}
  for name in todo:
    # Compile to a private name and rename, so that another process
    # never loads a half-written library.
    tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
    procs[name] = (tmp, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  reports, failed = {}, []
  for name, (tmp, proc) in procs.items():
    out, _ = proc.communicate()
    if proc.returncode != 0:
      failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
      continue
    os.replace(tmp, library_path(name))
    reports[name] = out
  if failed:
    raise KernelBuildError("kernel build failed: " + "\n".join(failed))
  return reports


def loaded_count() -> int:
  """How many kernel libraries this process has loaded.  A library is
  built (tens of seconds of ``nvcc``) or loaded at its first use, so a
  count that grows in the middle of serving is a stall: the serving
  engine's compile sentinel watches it (observability/slo.py)."""
  with _LOCK:
    return len(_LIBS)


def load(name: str) -> ctypes.CDLL:
  """The loaded library of kernel ``name``, built first if needed."""
  with _LOCK:
    lib = _LIBS.get(name)
    if lib is None:
      build([name])
      lib = ctypes.CDLL(str(library_path(name)))
      _LIBS[name] = lib
    return lib
