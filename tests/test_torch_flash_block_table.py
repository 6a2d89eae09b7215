"""K1's block table: the port of the JAX package's autotune table
(``set_block_want``, ``flash_block_table.json``) and the tile builds it
selects (``flash_tile``).

The JAX test of the table runs verbatim against the port; a table in the
JAX package's format is read by both loaders alike; an entry applies only
on the device it names.  The kernels' tile builds change the order in
which the online softmax and the gradient sums visit the keys and
queries, so a plain emulation of that order at each inner tile (fp32) is
held against the JAX Pallas kernels in interpret mode at the same block
widths, at the JAX flash tests' tolerances (forward rtol 2e-5 / atol
2e-6, gradients 5e-4 / 1e-5).  On the card the builds themselves are held
against the plain versions (tests/test_torch_gpu.py, chip_smoke.py
phase 27).
"""

import importlib
import json
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyparallellibrary_tpu_torch.kernels import flash_attention as tfa
from easyparallellibrary_tpu_torch.kernels import flash_autotune

jfa = importlib.import_module("easyparallellibrary_tpu.kernels.flash_attention")

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fresh_table(monkeypatch, tmp_path):
  """The port's table unread, at a path of the test's own, on a card
  named ``CARD``; returns the path."""
  path = tmp_path / "flash_block_table.json"
  monkeypatch.setattr(tfa, "_BLOCK_TABLE", None)
  monkeypatch.setattr(tfa, "_BLOCK_STAGES", {})
  monkeypatch.setattr(tfa, "_BLOCK_TABLE_PATH", str(path))
  monkeypatch.setattr(tfa, "_device_kind", lambda: CARD)
  return path


def _write(path, device, entries):
  path.write_text(json.dumps({"device": device, "entries": entries},
                             indent=1))


# ------------------------------------------------------------- the table --


def test_block_autotune_table_overrides_heuristic():
  """JAX tests/test_flash_attention.py's test, verbatim against the
  port: _default_block consults the (S, d, itemsize) table and keeps the
  512/1024 heuristic for unswept shapes."""
  fa = importlib.import_module(
      "easyparallellibrary_tpu_torch.kernels.flash_attention")
  try:
    assert fa._default_block(4096, d=64) == 512        # resident regime
    assert fa._default_block(16384, d=64) == 1024      # streaming regime
    fa.set_block_want(4096, 64, 2, 2048)
    assert fa._default_block(4096, d=64) == 2048       # tuned override
    assert fa._default_block(4096, d=64, itemsize=4) == 512  # other key
    # Explicit want still wins over the table.
    assert fa._default_block(4096, 256, d=64) == 256
  finally:
    fa._BLOCK_TABLE.pop((4096, 64, 2), None)


def test_importing_the_module_reads_no_table_and_asks_cuda_nothing():
  """The table is read at its first use, not at import (reading it asks
  CUDA for the card's name)."""
  code = ("import torch\n"
          "calls = []\n"
          "torch.cuda.get_device_name = lambda *a: calls.append(a)\n"
          "from easyparallellibrary_tpu_torch.kernels import "
          "flash_attention as fa\n"
          "assert fa._BLOCK_TABLE is None and calls == [], calls\n")
  subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_table_applies_only_on_the_card_it_names(fresh_table, monkeypatch):
  _write(fresh_table, CARD, {"4096:64:2": 2048, "1024:64:2": 128})
  asked = []
  monkeypatch.setattr(tfa, "_device_kind",
                      lambda: asked.append(1) or CARD)
  assert asked == []
  assert tfa._default_block(4096, d=64) == 2048
  assert tfa.flash_tile("fwd", 1024, 64, torch.bfloat16) == (128, 2)
  assert asked == [1]                       # read once, lazily
  for foreign in ("NVIDIA H200", None):     # another card; the CPU
    monkeypatch.setattr(tfa, "_BLOCK_TABLE", None)
    monkeypatch.setattr(tfa, "_device_kind", lambda d=foreign: d)
    assert tfa._default_block(4096, d=64) == 512
    assert tfa.flash_tile("fwd", 1024, 64, torch.bfloat16) == \
        tfa.DEFAULT_BUILD


def test_the_cpu_reads_no_entry_of_the_committed_table(monkeypatch):
  """On the CPU (no card) the committed table names another device, so
  every shape keeps the heuristic and the default build."""
  monkeypatch.setattr(tfa, "_BLOCK_TABLE", None)
  monkeypatch.setattr(tfa, "_BLOCK_STAGES", {})
  assert not torch.cuda.is_available()
  assert tfa._ensure_block_table() == {}
  assert tfa.flash_tile("dkv", 1024, 64, torch.bfloat16) == tfa.DEFAULT_BUILD


@pytest.mark.parametrize("content", [
    "not json", json.dumps([1, 2]), json.dumps({"device": CARD}),
    json.dumps({"device": CARD, "entries": {"1024:64": 128}}),
    json.dumps({"device": CARD, "entries": {"1024:64:2": "wide"}}),
    json.dumps({"device": CARD, "entries": {"1024:64:2": {"stages": 3}}}),
])
def test_a_malformed_table_falls_back_to_the_heuristic(fresh_table, content):
  fresh_table.write_text(content)
  assert tfa._default_block(1024, d=64) == 512
  assert tfa.flash_tile("fwd", 1024, 64, torch.bfloat16) == tfa.DEFAULT_BUILD


def test_a_missing_table_falls_back_to_the_heuristic(fresh_table):
  assert not fresh_table.exists()
  assert tfa._ensure_block_table() == {}


def test_both_loaders_read_a_jax_format_table_alike(fresh_table,
                                                    monkeypatch):
  """One file in the JAX package's format ({"device", "entries":
  {"S:d:itemsize": want}}) read by the JAX loader on its CPU device and by
  the port's on a device of the same name: the same entries, the same
  default blocks."""
  entries = {"4096:64:2": 2048, "2048:128:2": 256, "8192:64:4": 512}
  _write(fresh_table, "cpu", entries)
  monkeypatch.setattr(tfa, "_device_kind", lambda: "cpu")
  monkeypatch.setattr(jfa, "_BLOCK_TABLE", None)
  monkeypatch.setattr(jfa, "_BLOCK_TABLE_PATH", str(fresh_table))
  assert jax.devices()[0].device_kind == "cpu"
  want = {tuple(int(x) for x in k.split(":")): v for k, v in entries.items()}
  assert jfa._ensure_block_table() == want
  assert tfa._ensure_block_table() == want
  for S in (1024, 2048, 4096, 8192, 16384):
    for d in (64, 128):
      for itemsize in (2, 4):
        assert tfa._default_block(S, d=d, itemsize=itemsize) == \
            jfa._default_block(S, d=d, itemsize=itemsize), (S, d, itemsize)


def test_an_entry_may_carry_a_stage_depth(fresh_table):
  _write(fresh_table, CARD, {"1024:64:2": {"want": 128, "stages": 3},
                             "2048:64:2": {"want": 32}})
  assert [tfa.flash_tile(k, 1024, 64, torch.float16) for k in
          ("fwd", "dkv", "dq")] == [(128, 3), (64, 3), (128, 3)]
  assert [tfa.flash_tile(k, 2048, 64, torch.bfloat16) for k in
          ("fwd", "dkv", "dq")] == [(64, 2), (32, 2), (64, 2)]
  assert tfa._default_block(1024, d=64) == 128
  tfa.set_block_want(1024, 64, 2, 0)        # back to the defaults
  assert tfa.flash_tile("fwd", 1024, 64, torch.bfloat16) == tfa.DEFAULT_BUILD


# ------------------------------------------------------ the tile builds --

# (want, stages) -> the (tile, stages) of fwd, dkv, dq at D = 64 and 128
# (dK/dV at D = 128 has the one build).
RESOLVED = {
    (16, None): {64: [(64, 2), (32, 2), (64, 2)],
                 128: [(64, 2), (64, 2), (64, 2)]},
    (32, 3): {64: [(64, 3), (32, 3), (64, 3)],
              128: [(64, 3), (64, 2), (64, 3)]},
    (48, None): {64: [(64, 2), (32, 2), (64, 2)],
                 128: [(64, 2), (64, 2), (64, 2)]},
    (64, None): {64: [(64, 2), (64, 2), (64, 2)],
                 128: [(64, 2), (64, 2), (64, 2)]},
    (100, 3): {64: [(64, 3), (64, 3), (64, 3)],
               128: [(64, 3), (64, 2), (64, 3)]},
    (128, None): {64: [(128, 2), (64, 2), (128, 2)],
                  128: [(128, 2), (64, 2), (128, 2)]},
    (128, 3): {64: [(128, 3), (64, 3), (128, 3)],
               128: [(128, 3), (64, 2), (128, 2)]},
    (2048, 4): {64: [(128, 3), (64, 3), (128, 3)],
                128: [(128, 3), (64, 2), (128, 2)]},
}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("want,stages", sorted(RESOLVED, key=str))
def test_flash_tile_takes_the_largest_build_below_the_want(
    fresh_table, want, stages, D):
  """An entry's ``want`` takes each kernel to its largest inner tile <=
  it (the smallest when none is), at the entry's ring depth where that
  tile has it, else the deepest below it (dQ at D = 128 with 128-key
  tiles has two stages only, dK/dV at D = 128 one build)."""
  tfa.set_block_want(1024, D, 2, want, stages)
  got = [tfa.flash_tile(k, 1024, D, torch.bfloat16) for k in
         ("fwd", "dkv", "dq")]
  assert got == RESOLVED[want, stages][D]
  for kernel, build in zip(("fwd", "dkv", "dq"), got):
    assert build in tfa.WGMMA_BUILDS[kernel, D]


def test_no_entry_leaves_todays_build_and_cuda_cores_keep_theirs(
    fresh_table):
  tfa.set_block_want(1024, 32, 2, 128, 3)   # bf16 D 32: the CUDA cores
  tfa.set_block_want(1024, 64, 4, 128, 3)   # fp32
  for kernel in ("fwd", "dkv", "dq"):
    assert tfa.flash_tile(kernel, 1024, 64, torch.bfloat16) == (64, 2)
    assert tfa.flash_tile(kernel, 512, 128, torch.float16) == (64, 2)
    assert tfa.flash_tile(kernel, 1024, 32, torch.bfloat16) == \
        tfa.CUDA_CORE_BUILD
    assert tfa.flash_tile(kernel, 1024, 64, torch.float32) == \
        tfa.CUDA_CORE_BUILD
  assert tfa.DEFAULT_BUILD in tfa.WGMMA_BUILDS["dkv", 64]
  with pytest.raises(ValueError, match="kernel"):
    tfa.flash_tile("bwd", 1024, 64, torch.bfloat16)


def test_the_wrappers_refuse_cpu_tensors_before_resolving_a_build():
  x = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="CUDA"):
    tfa.flash_fwd_cuda(x, x, x, True, build=(128, 3))
  assert tfa.flash_fwd_cuda.by_tile == {}


# -------------------------------------- the kernels' order at each tile --

LOG2E = 1.4426950408889634


def _scores2(q, k, k0, kt, causal):
  """Scores of one KV tile times scale * log2 e (fp32), masked as the
  kernels mask: -1e30 above the diagonal."""
  D = q.shape[-1]
  s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k0 + kt])
  s2 = s * ((1.0 / math.sqrt(D)) * LOG2E)
  if causal:
    rows = torch.arange(q.shape[2])[:, None]
    cols = torch.arange(k0, k0 + kt)[None, :]
    s2 = torch.where(cols <= rows, s2, torch.tensor(-1e30))
  return s2


def emulate_fwd(q, k, v, causal, kt):
  """The wgmma forward's arithmetic at KV tile ``kt``, fp32, ``[B, H, S,
  D]``: per tile a running max m of the base-2 scores, p = 2^(s - m),
  the denominator and accumulator rescaled by 2^(m_old - m); tiles past
  a row's diagonal are skipped (their p would be 0); lse = (m + log2 l)
  ln 2."""
  S = q.shape[2]
  m = torch.full(q.shape[:3], -1e30)
  l = torch.zeros(q.shape[:3])
  acc = torch.zeros_like(q)
  for k0 in range(0, k.shape[2], kt):
    if causal and k0 > S - 1:
      break
    s2 = _scores2(q, k, k0, kt, causal)
    m_new = torch.maximum(m, s2.amax(-1))
    corr = torch.exp2(m - m_new)
    p = torch.exp2(s2 - m_new[..., None])
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + p @ v[:, :, k0:k0 + kt]
    m = m_new
  l_safe = l.clamp_min(1e-30)
  return acc / l_safe[..., None], (m + torch.log2(l_safe)) / LOG2E


def emulate_bwd(q, k, v, dout, lse, delta, causal, qt, kt):
  """dK/dV summed over Q tiles of ``qt`` rows, dQ over KV tiles of
  ``kt`` keys, as the two kernels do (fp32); p = 2^(s - lse log2 e)."""
  D = q.shape[-1]
  scale = 1.0 / math.sqrt(D)
  lse2 = lse * LOG2E
  dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)
  for q0 in range(0, q.shape[2], qt):
    sl = slice(q0, q0 + qt)
    s2 = _scores2(q[:, :, sl], k, 0, k.shape[2], False)
    if causal:
      rows = torch.arange(q0, q0 + qt)[:, None]
      s2 = torch.where(torch.arange(k.shape[2])[None, :] <= rows, s2,
                       torch.tensor(-1e30))
    p = torch.exp2(s2 - lse2[:, :, sl, None])
    dp = dout[:, :, sl] @ v.transpose(-1, -2)
    ds = p * (dp - delta[:, :, sl, None])
    dv += p.transpose(-1, -2) @ dout[:, :, sl]
    dk += ds.transpose(-1, -2) @ q[:, :, sl]
  for k0 in range(0, k.shape[2], kt):
    s2 = _scores2(q, k, k0, kt, causal)
    p = torch.exp2(s2 - lse2[..., None])
    dp = dout @ v[:, :, k0:k0 + kt].transpose(-1, -2)
    dq += (p * (dp - delta[..., None])) @ k[:, :, k0:k0 + kt]
  return dq * scale, dk * scale, dv


def _arrays(seed, B=2, S=256, H=2, D=32):
  r = np.random.RandomState(seed)
  return [r.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def _heads_first(a):
  return torch.from_numpy(a).transpose(1, 2).contiguous()


# The three tile triples the block table's wants 32, 64 and 128 name
# (fwd KV tile, dK/dV Q tile, dQ KV tile), as JAX's (block_q, block_k):
# dK/dV walks block_q rows, the forward and dQ block_k keys.
TILE_CASES = [(32, 64), (64, 64), (64, 128)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("block_q,block_k", TILE_CASES)
def test_tile_order_matches_jax_at_each_tile(block_q, block_k, causal):
  arrays = _arrays(7)
  q, k, v = map(_heads_first, arrays)
  out, lse = emulate_fwd(q, k, v, causal, block_k)
  want_out, want_lse = jfa.flash_attention_lse(
      *map(jnp.asarray, arrays), causal=causal, block_q=block_q,
      block_k=block_k)
  np.testing.assert_allclose(out.transpose(1, 2).numpy(),
                             np.asarray(want_out), **FWD_TOL)
  np.testing.assert_allclose(lse.transpose(1, 2).numpy(),
                             np.asarray(want_lse), **FWD_TOL)

  # d mean(o^2) / do = 2 o / size: the cotangent both backward passes see.
  dout = 2.0 * out / out.numel()
  delta = (dout * out).sum(-1)
  got = emulate_bwd(q, k, v, dout, lse, delta, causal, block_q, block_k)
  want = jax.grad(lambda a, b, c: jnp.mean(jfa.flash_attention(
      a, b, c, causal=causal, block_q=block_q, block_k=block_k) ** 2),
                  argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
  for name, g, w in zip(("dq", "dk", "dv"), got, want):
    np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                               err_msg=name, **GRAD_TOL)


# ----------------------------------------------------------- the sweep --


def _row(S, D, times, default="64x2"):
  best = min(times, key=times.get)
  return {"S": S, "D": D, "times_ms": times, "default": default,
          "best": best, "gain_vs_default": times[default] / times[best]}


def test_the_sweep_keeps_only_winners_past_three_percent():
  rows = [_row(1024, 64, {"64x2": 1.0, "128x3": 0.95}),     # 5.3%: kept
          _row(2048, 64, {"64x2": 1.0, "128x2": 0.98}),     # 2.0%: not
          _row(4096, 64, {"64x2": 0.9, "32x3": 1.0})]       # default wins
  assert flash_autotune.table_entries(rows) == {
      "1024:64:2": {"want": 128, "stages": 3}}


def test_the_sweep_rewrites_swept_shapes_and_keeps_the_rest(tmp_path):
  path = tmp_path / "table.json"
  _write(path, CARD, {"1024:64:2": {"want": 32, "stages": 2},
                      "8192:128:2": 128})
  rows = [_row(1024, 64, {"64x2": 1.0, "32x2": 0.999})]
  summary = flash_autotune.write_table(rows, str(path), device=CARD)
  assert json.loads(path.read_text()) == {
      "device": CARD, "entries": {"8192:128:2": 128}}
  assert summary["value"] == 0 and summary["detail"]["kept_entries"] == {
      "8192:128:2": 128}
  # Another card's table is replaced, not merged.
  rows = [_row(2048, 64, {"64x2": 1.0, "128x3": 0.5})]
  flash_autotune.write_table(rows, str(path), device="another card")
  assert json.loads(path.read_text()) == {
      "device": "another card",
      "entries": {"2048:64:2": {"want": 128, "stages": 3}}}


def test_the_sweep_raises_without_a_card_and_checks_its_shapes():
  with pytest.raises(RuntimeError, match="card"):
    flash_autotune.main([])
  assert flash_autotune._shapes("1024:64,8192:128") == [
      (1024, 64, 8, 16), (8192, 128, 1, 16)]
  with pytest.raises(ValueError, match="not a shape"):
    flash_autotune._shapes("1000:64")
  assert {flash_autotune._label(c) for c in (
      (w, s) for w in flash_autotune.WANTS for s in flash_autotune.STAGES)
  } >= {"64x2"} and flash_autotune.DEFAULT == tfa.DEFAULT_BUILD
