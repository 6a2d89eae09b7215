"""The PyTorch port's paged attention against the JAX package's.

On the CPU the port's dispatcher runs the plain version, which is held
against the JAX reference and against the Pallas kernel in interpreter
mode (the JAX package's own CPU vehicle for it).  The CUDA kernel itself
runs only on the card: tests/test_torch_gpu.py holds it against the
plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyparallellibrary_tpu.kernels.paged_attention import (
    paged_attention_pallas, paged_attention_reference as jax_reference)
from easyparallellibrary_tpu_torch.kernels import _build
from easyparallellibrary_tpu_torch.kernels import paged_attention as pa

# Tiny shapes: one intra-op thread is enough, and it leaves the cores
# to the test suite's other worker processes.
torch.set_num_threads(1)


def _case(seed=0, T=6, H=4, hd=16, NB=9, bs=8, MB=4):
  """The JAX test's ``_parity_case`` draw (tests/test_serving_paged.py),
  as numpy arrays."""
  r = np.random.RandomState(seed)
  q = r.randn(T, H, hd).astype(np.float32)
  kp = r.randn(NB, bs, H, hd).astype(np.float32)
  vp = r.randn(NB, bs, H, hd).astype(np.float32)
  tables = r.randint(0, NB, (T, MB)).astype(np.int32)
  positions = r.randint(0, MB * bs, (T,)).astype(np.int32)
  return q, kp, vp, tables, positions


def _torch(args, device="cpu"):
  return [torch.from_numpy(a).to(device) for a in args]


@pytest.mark.parametrize("shape", [
    dict(seed=0),
    dict(seed=3, T=11, H=2, hd=64, NB=17, bs=4, MB=8),
])
def test_plain_version_matches_jax_reference_fp32(shape):
  args = _case(**shape)
  want = np.asarray(jax_reference(*[jnp.asarray(a) for a in args]))
  got = pa.paged_attention_reference(*_torch(args)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_plain_version_matches_pallas_interpret():
  args = _case()
  want = np.asarray(paged_attention_pallas(
      *[jnp.asarray(a) for a in args], interpret=True))
  got = pa.paged_attention_reference(*_torch(args)).numpy()
  # The JAX test's own kernel-vs-reference tolerance.
  np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_dispatcher_sends_cpu_tensors_to_the_plain_version():
  args = _torch(_case())
  calls, launches = (pa.paged_attention_reference.calls,
                     pa.paged_attention_cuda.launches)
  out = pa.paged_attention(*args)
  assert out.shape == args[0].shape and out.dtype == torch.float32
  assert pa.paged_attention_reference.calls == calls + 1
  assert pa.paged_attention_cuda.launches == launches


def test_cuda_wrapper_refuses_cpu_tensors():
  launches = pa.paged_attention_cuda.launches
  with pytest.raises(ValueError, match="CUDA tensors"):
    pa.paged_attention_cuda(*_torch(_case()))
  assert pa.paged_attention_cuda.launches == launches


def test_build_raises_named_error_without_nvcc(monkeypatch, tmp_path):
  monkeypatch.delenv("CUDA_HOME", raising=False)
  monkeypatch.setenv("PATH", str(tmp_path))
  monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(_build, "_LIBS", {})
  with pytest.raises(_build.NvccNotFoundError, match="nvcc not found"):
    _build.load("paged_attention")
  assert not (tmp_path / "build").exists()


def test_build_raises_compiler_report_when_nvcc_fails(monkeypatch, tmp_path):
  nvcc = tmp_path / "cuda" / "bin" / "nvcc"
  nvcc.parent.mkdir(parents=True)
  nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here'\nexit 3\n")
  nvcc.chmod(0o755)
  monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(_build, "_LIBS", {})
  with pytest.raises(_build.KernelBuildError,
                     match=r"(?s)nvcc exit 3.*no sm_90a here"):
    _build.load("paged_attention")
  assert not _build.library_path("paged_attention").exists()
  assert "paged_attention" not in _build._LIBS


def test_library_name_follows_source_headers_and_flags(monkeypatch,
                                                       tmp_path):
  """A kernel source may include any header under csrc/, so an edited
  header, like an edited source or another flag, names another library:
  a build never loads a stale one."""
  csrc = tmp_path / "csrc"
  csrc.mkdir()
  (csrc / "k.cu").write_text('#include "h.cuh"\n')
  (csrc / "h.cuh").write_text("// v1\n")
  monkeypatch.setattr(_build, "CSRC_DIR", csrc)
  names = [_build.library_path("k")]
  assert _build.library_path("k") == names[0]
  (csrc / "h.cuh").write_text("// v2\n")
  names.append(_build.library_path("k"))
  (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
  names.append(_build.library_path("k"))
  monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
  names.append(_build.library_path("k"))
  assert len(set(names)) == 4, names
  assert all(p.name.startswith("libk-") for p in names)
