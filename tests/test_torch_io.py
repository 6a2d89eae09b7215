"""The port's input pipeline against the JAX package's: the record
format both ways, the Python reader and the port's native one (built
here with the host C++ compiler), ``skip_records``, truncation, file
sharding, and the prefetcher's order and depth.
"""

import os

import jax
import numpy as np
import pytest
import torch

import easyparallellibrary_tpu as jepl
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu.io import dataloader as jio
from easyparallellibrary_tpu.io import device as jdevice
from easyparallellibrary_tpu.io import sharding as jsharding
from easyparallellibrary_tpu_torch.io import dataloader as tio
from easyparallellibrary_tpu_torch.io import device as tdevice
from easyparallellibrary_tpu_torch.io import sharding as tsharding

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_port_env():
  tepl.init(device="cpu")
  yield
  tepl.Env.get().reset()


def _records(n, seed=0):
  r = np.random.RandomState(seed)
  return [r.bytes(int(r.randint(0, 300))) for _ in range(n)] + [b"",
                                                                 b"x" * 70000]


def _write_files(tmp_path, writer, count=3, per_file=5, **kw):
  files, everything = [], []
  for i in range(count):
    recs = _records(per_file, seed=i)
    path = str(tmp_path / f"part_{i}.rec")
    writer(path, recs, **kw)
    files.append(path)
    everything += recs
  return files, everything


def test_native_reader_builds_here():
  assert tio.native_io_available()
  assert tio.library_path().exists()


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_port_reads_records_the_jax_package_wrote(tmp_path, native):
  files, want = _write_files(tmp_path, jio.write_records, use_native=False)
  got = list(tio.RecordReader(files, use_native=native))
  assert got == want
  assert got == list(jio.RecordReader(files, use_native=False))


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_jax_package_reads_records_the_port_wrote(tmp_path, native):
  files, want = _write_files(tmp_path, tio.write_records, use_native=native)
  assert list(jio.RecordReader(files, use_native=False)) == want
  (tmp_path / "jax").mkdir()
  theirs, _ = _write_files(tmp_path / "jax", jio.write_records,
                           use_native=False)
  for mine, ref in zip(files, theirs):          # byte for byte
    assert open(mine, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("skip", [0, 1, 6, 13, 21, 40])
def test_skip_records_equals_the_slice(tmp_path, skip, native):
  files, want = _write_files(tmp_path, jio.write_records, use_native=False)
  got = list(tio.RecordReader(files, use_native=native, skip_records=skip))
  assert got == want[skip:]
  assert got == list(jio.RecordReader(files, use_native=False,
                                      skip_records=skip))


@pytest.mark.parametrize("where", ["payload", "header"])
def test_truncation_is_detected_as_in_jax(tmp_path, where):
  """The Python reader raises on a truncated record, reading or skipping
  (the JAX package's reader does the same); the native reader, like the
  JAX package's native source, stops after the last whole record."""
  path = str(tmp_path / "t.rec")
  jio.write_records(path, [b"a" * 40, b"b" * 40], use_native=False)
  size = os.path.getsize(path)
  with open(path, "r+b") as f:
    f.truncate(size - 10 if where == "payload" else 48 + 4)
  for skip in (0, 1):
    with pytest.raises(IOError, match="truncated"):
      list(tio.RecordReader([path], use_native=False, skip_records=skip))
    with pytest.raises(IOError, match="truncated"):
      list(jio.RecordReader([path], use_native=False, skip_records=skip))
  assert list(tio.RecordReader([path], use_native=True)) == [b"a" * 40]


def test_shard_index_slices_the_files_as_jax(tmp_path):
  files, _ = _write_files(tmp_path, jio.write_records, count=5, per_file=2,
                          use_native=False)
  for shards in (1, 2, 3):
    for i in range(shards):
      got = list(tio.RecordReader(files, shard_index=i, num_shards=shards,
                                  use_native=True))
      want = list(jio.RecordReader(files, shard_index=i, num_shards=shards,
                                   use_native=False))
      assert got == want


@pytest.mark.parametrize("n,shards", [(8, 2), (7, 3), (3, 3), (10, 4),
                                      (1, 1), (5, 2)])
@pytest.mark.parametrize("unbalanced,drop_last", [(True, False),
                                                  (False, True),
                                                  (False, False)])
def test_shard_files_matches_jax(n, shards, unbalanced, drop_last):
  files = [f"f{i}" for i in range(n)]
  for i in range(shards):
    kw = dict(unbalanced=unbalanced, drop_last=drop_last)
    try:
      want = jsharding.shard_files(files, shards, i, **kw)
    except ValueError as e:
      with pytest.raises(ValueError, match=str(e)[:20]):
        tsharding.shard_files(files, shards, i, **kw)
      continue
    assert tsharding.shard_files(files, shards, i, **kw) == want
  assert tsharding.shard_batch_dim(12, 3, 1) == \
      jsharding.shard_batch_dim(12, 3, 1)
  with pytest.raises(ValueError):
    tsharding.shard_batch_dim(10, 3, 0)


def test_use_native_true_raises_when_the_build_fails(tmp_path, monkeypatch):
  bad = tmp_path / "broken.cc"
  bad.write_text("this is not C++")
  monkeypatch.setattr(tio, "SOURCE", bad)
  monkeypatch.setattr(tio, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(tio, "_LIB", None)
  monkeypatch.setattr(tio, "_LIB_ERROR", None)
  with pytest.raises(tio.NativeIOBuildError, match="failed"):
    tio.RecordReader([], use_native=True)
  # The failure is remembered; None falls back to the Python reader.
  with pytest.raises(tio.NativeIOBuildError):
    tio.load_native()
  assert tio.RecordReader([], use_native=None)._native is False
  assert not tio.native_io_available()


class _Counting:
  """A host iterator that counts how many batches were pulled."""

  def __init__(self, n):
    self.n, self.pulled = n, 0

  def __iter__(self):
    return self

  def __next__(self):
    if self.pulled >= self.n:
      raise StopIteration
    self.pulled += 1
    return {"x": np.full((2, 3), self.pulled, np.float32),
            "i": np.arange(2, dtype=np.int32) + self.pulled}


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetcher_order_and_depth_match_jax(depth):
  jepl.init(devices=jax.devices()[:1])
  mesh = jepl.current_plan().build_mesh()
  jsrc, tsrc = _Counting(6), _Counting(6)
  jpre = jdevice.DevicePrefetcher(jsrc, mesh, depth=depth)
  tpre = tdevice.DevicePrefetcher(tsrc, tepl.current_plan().build_mesh(),
                                  depth=depth)
  got, want, pulled = [], [], []
  for jb, tb in zip(jpre, tpre):
    want.append(np.asarray(jb["x"]))
    got.append(tb["x"].numpy())
    assert isinstance(tb["i"], torch.Tensor) and tb["i"].dtype == torch.int32
    pulled.append((tsrc.pulled, jsrc.pulled))
  assert len(got) == len(want) == 6
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a, b)
  assert all(t == j for t, j in pulled), pulled
  assert pulled[0][0] == min(6, depth + 1)
  with pytest.raises(StopIteration):
    next(tpre)


def test_prefetcher_depth_defaults_to_io_prefetch():
  tepl.init(tepl.Config({"io.prefetch": 3}), device="cpu")
  src = _Counting(10)
  pre = tdevice.DevicePrefetcher(src, device="cpu")
  next(pre)
  assert src.pulled == 4


def test_global_batch_puts_the_batch_on_the_mesh_device():
  mesh = tepl.current_plan().build_mesh()
  out = tdevice.global_batch({"x": np.ones((2, 2), np.float32)}, mesh)
  assert out["x"].device == mesh.device and out["x"].dtype == torch.float32
