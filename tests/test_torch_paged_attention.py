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


# ------------------------------------------------------ query-tile plan --


def _step_plan(seed, T=96, slots=6, MB=32, bs=8):
  """A random engine step as ``FCFSScheduler._plan_flat`` lays it out:
  decode slots first (one token each), then prefill chunks of
  consecutive positions (some longer than a tile), the rest padding
  (slot 0, position 0); every slot its own distinct blocks.  Returns
  ``(base_idx, num_valid, tables_tok, positions)`` as numpy arrays."""
  r = np.random.RandomState(seed)
  L = MB * bs
  blocks = 1 + r.permutation(slots * MB)
  tables = np.zeros((slots, MB), np.int32)
  base_idx = np.zeros((slots,), np.int32)
  num_valid = np.zeros((slots,), np.int32)
  slot_ids = np.zeros((T,), np.int32)
  positions = np.zeros((T,), np.int32)
  order = r.permutation(slots)
  decoding = order[:r.randint(0, slots + 1)]
  pos = 0
  for s in list(decoding) + [s for s in order if s not in decoding]:
    if s in decoding:
      first, n = r.randint(1, L), 1
    else:
      n = min(r.randint(1, 100), T - pos, L)
      first = r.randint(0, L - n + 1) if n > 0 else 0
    if n <= 0:
      continue
    base_idx[s], num_valid[s] = pos, n
    slot_ids[pos:pos + n] = s
    positions[pos:pos + n] = np.arange(first, first + n)
    live = (first + n - 1) // bs + 1
    tables[s, :live] = blocks[s * MB:s * MB + live]
    pos += n
  return base_idx, num_valid, tables[slot_ids], positions


def _check_runs(runs, tables_tok, positions):
  """Brute force: every flat token lies in exactly one run; a run has
  one table row, 1..TILE_ROWS rows and consecutive positions, or, if it
  is padding, position 0 throughout."""
  T = positions.shape[0]
  hits = np.zeros((T,), int)
  for t0, n in runs:
    assert 1 <= n <= pa.TILE_ROWS and 0 <= t0 and t0 + n <= T
    padding = n > 1 and positions[t0] == positions[t0 + 1] == 0
    for t in range(t0, t0 + n):
      hits[t] += 1
      np.testing.assert_array_equal(tables_tok[t], tables_tok[t0])
      assert positions[t] == (0 if padding else positions[t0] + (t - t0))
  np.testing.assert_array_equal(hits, np.ones((T,), int))


@pytest.mark.parametrize("seed", range(8))
def test_tile_planner_covers_every_token_once(seed):
  base_idx, num_valid, tables_tok, positions = _step_plan(seed)
  from_plan = pa.tile_runs_from_plan(base_idx, num_valid, len(positions))
  from_tokens = pa.tile_runs_from_tokens(tables_tok, positions)
  _check_runs(from_plan, tables_tok, positions)
  _check_runs(from_tokens, tables_tok, positions)
  # Slots own distinct blocks, so the batch shows the plan's runs.
  assert sorted(map(tuple, from_plan)) == sorted(map(tuple, from_tokens))


@pytest.mark.parametrize("seed", range(4))
def test_work_items_split_each_context_once(seed):
  """Each tile's splits cover keys 0 .. context - 1 once, start on a
  64-key stage, and own disjoint scratch slots."""
  MB, bs = 32, 8
  base_idx, num_valid, tables_tok, positions = _step_plan(seed, MB=MB,
                                                          bs=bs)
  runs = pa.tile_runs_from_plan(base_idx, num_valid, len(positions))
  items, partial_rows = pa.work_items(runs, positions, MB, bs)
  slots, i = [], 0
  for t0, n in runs:
    ctx = min(positions[t0:t0 + n].max(), MB * bs - 1) + 1
    splits = items[i, 5]
    group = items[i:i + splits]
    assert (group[:, 0] == t0).all() and (group[:, 1] == n).all()
    np.testing.assert_array_equal(group[:, 4], np.arange(splits))
    ends = [e if e >= 0 else ctx for e in group[:, 3]]
    np.testing.assert_array_equal(group[1:, 2], ends[:-1])
    assert group[0, 2] == 0 and ends[-1] == ctx and group[-1, 3] == -1
    assert (group[:, 2] % 64 == 0).all()
    if splits > 1:
      slots.extend(range(group[0, 6], group[0, 6] + n * splits))
    i += splits
  assert i == len(items)
  assert sorted(slots) == list(range(partial_rows))


def _emulate_tiled(q, kp, vp, tables, positions, items):
  """What the tiled kernel computes for each work item, in fp32 on the
  CPU: a split's (m, l, acc) over its keys, then every tile's splits
  combined.  Holds the planner's splits to the plain version."""
  T, H, hd = q.shape
  bs, MB = kp.shape[1], tables.shape[1]
  scale = 1.0 / np.sqrt(hd)
  out = torch.zeros_like(q)
  parts = {}
  for t0, n, k0, k1, split, splits, _, _ in items.tolist():
    pos = torch.clamp(positions[t0:t0 + n].long(), max=MB * bs - 1)
    ctx = int(pos.max()) + 1
    k1 = ctx if k1 < 0 else min(k1, ctx)
    j = torch.arange(k0, max(k1, k0))
    blk = tables[t0].long()[j // bs]
    blk = torch.where((blk < 0) | (blk >= kp.shape[0]), 0, blk)
    k, v = kp[blk, j % bs], vp[blk, j % bs]                  # [keys, H, hd]
    s = torch.einsum("rhd,khd->rhk", q[t0:t0 + n], k) * scale
    s = torch.where(j[None, None, :] <= pos[:, None, None], s,
                    torch.tensor(-np.inf))
    m = s.amax(-1, keepdim=True) if len(j) else torch.full((n, H, 1),
                                                           -np.inf)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    parts.setdefault(t0, []).append(
        (m, p.sum(-1, keepdim=True), torch.einsum("rhk,khd->rhd", p, v)))
    if split == splits - 1:
      ms = torch.stack([a for a, _, _ in parts[t0]])
      big = ms.amax(0)
      w = torch.exp(ms - big)
      l = (w * torch.stack([b for _, b, _ in parts[t0]])).sum(0)
      acc = (w * torch.stack([c for _, _, c in parts[t0]])).sum(0)
      out[t0:t0 + n] = acc / torch.clamp_min(l, 1e-30)
  return out


@pytest.mark.parametrize("seed", range(3))
def test_split_tiles_with_plan_or_derived_tiles_match_plain_version(seed):
  """The tiled kernel's arithmetic (per-split partials, combined) over
  the engine's planned tiles and over tiles derived from the batch: both
  equal the plain version, fp32; the dispatcher on the CPU takes a plan
  and gives the plain version's answer."""
  T, H, hd, MB, bs = 96, 2, 16, 64, 8
  base_idx, num_valid, tables_tok, positions = _step_plan(seed, T=T,
                                                          MB=MB, bs=bs)
  r = np.random.RandomState(seed + 10)
  NB = 6 * MB + 1
  q, kp, vp = [torch.from_numpy(r.randn(*s).astype(np.float32))
               for s in ((T, H, hd), (NB, bs, H, hd), (NB, bs, H, hd))]
  tables, pos = torch.from_numpy(tables_tok), torch.from_numpy(positions)
  want = pa.paged_attention_reference(q, kp, vp, tables, pos)
  for runs in (pa.tile_runs_from_plan(base_idx, num_valid, T),
               pa.tile_runs_from_tokens(tables_tok, positions)):
    items, _ = pa.work_items(runs, positions, MB, bs)
    assert (items[:, 5] > 1).any()        # some context is split
    got = _emulate_tiled(q, kp, vp, tables, pos, items)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    tiles = pa.plan_tiles(runs, positions, MB, bs, H, "cpu")
    assert tiles.counters.shape == (len(items) * H,)
    assert not tiles.counters.any()
    torch.testing.assert_close(
        pa.paged_attention(q, kp, vp, tables, pos, tiles), want)


def test_tiled_build_takes_bf16_at_head_dims_64_and_128_only():
  assert pa.takes_tiles(torch.bfloat16, 64)
  assert pa.takes_tiles(torch.bfloat16, 128)
  assert not pa.takes_tiles(torch.float32, 64)
  assert not pa.takes_tiles(torch.bfloat16, 32)
