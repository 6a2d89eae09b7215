"""The PyTorch port on the card: each CUDA kernel against its plain
version, and the engine's greedy streams against ``generate``.

Marked ``gpu``; every test skips itself where no CUDA device is present.
This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from easyparallellibrary_tpu_torch.kernels import paged_attention as pa


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


def _case(device, dtype, seed, T, H, hd, NB, bs, MB):
  """The JAX package's ``_parity_case`` draw (tests/test_serving_paged.py)
  on ``device``."""
  r = np.random.RandomState(seed)
  floats = [torch.from_numpy(r.randn(*s).astype(np.float32)).to(device,
                                                                 dtype)
            for s in ((T, H, hd), (NB, bs, H, hd), (NB, bs, H, hd))]
  tables = torch.from_numpy(r.randint(0, NB, (T, MB)).astype(np.int32))
  positions = torch.from_numpy(r.randint(0, MB * bs, (T,)).astype(np.int32))
  return (*floats, tables.to(device), positions.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [
    dict(seed=1, T=16, H=8, hd=64, NB=17, bs=16, MB=8),
    dict(seed=2, T=5, H=3, hd=24, NB=9, bs=8, MB=4),
    dict(seed=4, T=7, H=2, hd=256, NB=9, bs=8, MB=4),
    dict(seed=5, T=3, H=1, hd=8, NB=5, bs=2, MB=3),
])
def test_paged_attention_kernel_matches_plain_version(cuda, dtype, tol,
                                                      shape):
  args = _case(cuda, dtype, **shape)
  launches = pa.paged_attention_cuda.launches
  got = pa.paged_attention(*args)
  torch.cuda.synchronize()
  assert pa.paged_attention_cuda.launches == launches + 1
  want = pa.paged_attention_reference(*args)
  torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_engine_greedy_streams_match_generate_on_the_card(cuda):
  from easyparallellibrary_tpu_torch.models.gpt import generate
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  torch.backends.cuda.matmul.allow_tf32 = False
  model, params = tiny_gpt(seed=3, device=cuda)
  r = np.random.RandomState(0)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32) for n in (5, 3, 9, 1)]
  eng = ContinuousBatchingEngine(model, params, num_slots=2,
                                 prefill_chunk=4, paged=True, block_size=4)
  launches = pa.paged_attention_cuda.launches
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
  out = eng.run()
  assert pa.paged_attention_cuda.launches - launches == 2 * eng.steps
  for i, p in enumerate(prompts):
    want = generate(model, params, torch.from_numpy(p[None]).long().to(cuda),
                    6)[0].cpu().numpy()
    np.testing.assert_array_equal(out[i], want, err_msg=f"req {i}")


def _flash_case(device, dtype, seed, B, H, S, Skv, D):
  """q, k, v, dout ``[B, H, S|Skv, D]`` from a numpy seed."""
  r = np.random.RandomState(seed)
  q, k, v, dout = [
      torch.from_numpy(r.randn(B, H, n, D).astype(np.float32)).to(device,
                                                                  dtype)
      for n in (S, Skv, Skv, S)]
  return q, k, v, dout


# fp32: the JAX tests' tolerances (rtol, atol).  bf16: chip_smoke.py's
# normalized limits (||got - want|| / ||want||, max|got - want| /
# max|want|), which say how they were set.
FLASH_FP32_TOL = dict(fwd=(2e-5, 2e-6), grad=(5e-4, 1e-5))
FLASH_BF16_LIMIT = dict(fwd=(5e-3, 1e-2), grad=(5e-4, 1e-2))


def _assert_flash_close(got, want, kind, name):
  if got.dtype == torch.float32:
    rtol, atol = FLASH_FP32_TOL[kind]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return
  diff, ref = got.float() - want.float(), want.float()
  rel_l2 = (diff.norm() / ref.norm()).item()
  max_rel = (diff.abs().max() / ref.abs().max()).item()
  limit = FLASH_BF16_LIMIT[kind]
  assert rel_l2 <= limit[0] and max_rel <= limit[1], (name, rel_l2, max_rel)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,H,S,Skv,D", [
    (2, 3, 200, 200, 8),
    (2, 2, 128, 128, 32),
    (2, 3, 200, 200, 64),
    (1, 2, 128, 192, 128),
    (1, 2, 96, 96, 256),
])
def test_flash_kernels_match_plain_versions(cuda, dtype, causal, B, H, S,
                                            Skv, D):
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v, dout = _flash_case(cuda, dtype, 7, B, H, S, Skv, D)
  launches = fa.flash_fwd_cuda.launches
  out, lse = fa.flash_fwd(q, k, v, causal)
  torch.cuda.synchronize()
  assert fa.flash_fwd_cuda.launches == launches + 1
  want_out, want_lse = fa.flash_fwd_reference(q, k, v, causal)
  assert out.dtype == dtype
  _assert_flash_close(out, want_out, "fwd", "out")
  torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-6)
  delta = (dout.float() * want_out.float()).sum(-1)
  dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal)
  dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal)
  torch.cuda.synchronize()
  want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, want_lse,
                                                delta, causal)
  want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                      causal)
  for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                          ("dv", dv, want_dv)):
    assert got.dtype == dtype
    _assert_flash_close(got, want, "grad", name)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_ragged_tail_reads_nothing_of_the_next_head(cuda, causal, D):
  """bf16 at S = 200, where the last tile of each head runs past S.  The
  wgmma kernels read their tiles through 3-D TMA maps, so the rows past
  S arrive as zeros and never as the next head's rows.  Here the next
  head's q, k, v and dO are 1e3 times larger: a leak into head 0's tail
  would show in head 0's outputs, which must still match the plain
  versions."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  q, k, v, dout = _flash_case(cuda, torch.bfloat16, 11, 2, 2, 200, 200, D)
  for x in (q, k, v, dout):
    x[:, 1] *= 1e3
  out, lse = fa.flash_fwd(q, k, v, causal)
  want_out, want_lse = fa.flash_fwd_reference(q, k, v, causal)
  delta = (dout.float() * want_out.float()).sum(-1)
  dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal)
  want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, want_lse,
                                                delta, causal)
  dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal)
  want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                      causal)
  torch.cuda.synchronize()
  for got in (out, lse, dk, dv, dq):
    assert bool(torch.isfinite(got).all())
  _assert_flash_close(out[:, 0], want_out[:, 0], "fwd", "out, head 0")
  torch.testing.assert_close(lse[:, 0], want_lse[:, 0], rtol=2e-5,
                             atol=2e-6)
  _assert_flash_close(dk[:, 0], want_dk[:, 0], "grad", "dk, head 0")
  _assert_flash_close(dv[:, 0], want_dv[:, 0], "grad", "dv, head 0")
  _assert_flash_close(dq[:, 0], want_dq[:, 0], "grad", "dq, head 0")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_dq_launches_are_bit_identical(cuda, causal, D):
  """dQ is its own kernel with no atomics: two launches on the same
  inputs give the same bits."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  q, k, v, dout = _flash_case(cuda, torch.bfloat16, 13, 2, 4, 320, 320, D)
  out, lse = fa.flash_fwd(q, k, v, causal)
  delta = (dout.float() * out.float()).sum(-1)
  first = fa.flash_bwd_dq(q, k, v, dout, lse, delta, causal)
  second = fa.flash_bwd_dq(q, k, v, dout, lse, delta, causal)
  torch.cuda.synchronize()
  assert torch.equal(first, second)


def _paged_step(device, dtype, seed, slots, T, H, hd, bs, MB, NB=None):
  """A paged-attention batch laid out as the engine's scheduler lays out
  a step: ``slots`` lists each slot's (first position, tokens), in flat
  order, each slot with its own distinct blocks; the rest of the T flat
  tokens are padding (slot 0, position 0).  Returns the kernel inputs
  and the plan's tile runs."""
  r = np.random.RandomState(seed)
  NB = NB or len(slots) * MB + 1
  blocks = 1 + r.permutation(NB - 1)
  tables = np.zeros((len(slots), MB), np.int32)
  slot_ids = np.zeros((T,), np.int32)
  positions = np.zeros((T,), np.int32)
  base_idx = np.zeros((len(slots),), np.int32)
  num_valid = np.zeros((len(slots),), np.int32)
  pos = 0
  for s, (first, n) in enumerate(slots):
    base_idx[s], num_valid[s] = pos, n
    slot_ids[pos:pos + n] = s
    positions[pos:pos + n] = np.arange(first, first + n)
    live = (first + n - 1) // bs + 1
    tables[s, :live] = blocks[s * MB:s * MB + live]
    pos += n
  floats = [torch.from_numpy(r.randn(*shape).astype(np.float32)).to(device,
                                                                     dtype)
            for shape in ((T, H, hd), (NB, bs, H, hd), (NB, bs, H, hd))]
  tables_tok = torch.from_numpy(tables[slot_ids]).to(device)
  args = (*floats, tables_tok, torch.from_numpy(positions).to(device))
  return args, pa.tile_runs_from_plan(base_idx, num_valid, T)


PAGED_STEPS = {
    # chip_smoke.py's engine_step: 6 decode slots, two 128-token chunks.
    "engine_step": dict(slots=[(70, 1), (543, 1), (300, 1), (64, 1),
                               (129, 1), (401, 1), (384, 128), (0, 128)],
                        T=264, H=16, bs=16, MB=64),
    # A chunk of 40 tokens from position 10 crosses block boundaries.
    "chunk_across_blocks": dict(slots=[(10, 40), (33, 1)], T=48, H=4,
                                bs=16, MB=8),
    # A decode token at the last position the table holds.
    "decode_at_last_row": dict(slots=[(8 * 16 - 1, 1), (5, 1)], T=4, H=4,
                               bs=16, MB=8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("step", sorted(PAGED_STEPS))
def test_paged_tiled_kernel_matches_plain_version(cuda, step, hd):
  """bf16 at head dims 64 and 128 runs the slot-tiled build, over the
  scheduler plan's tiles and over tiles derived from the batch."""
  args, runs = _paged_step(cuda, torch.bfloat16, 3, hd=hd,
                           **PAGED_STEPS[step])
  q, kp = args[0], args[1]
  pos = args[4].cpu().numpy()
  tiles = pa.plan_tiles(runs, pos, args[3].shape[1], kp.shape[1],
                        q.shape[1], cuda)
  launches = pa.paged_attention_tiled_cuda.launches
  outs = [pa.paged_attention(*args, tiles), pa.paged_attention(*args)]
  torch.cuda.synchronize()
  assert pa.paged_attention_tiled_cuda.launches == launches + 2
  assert not tiles.counters.any()          # each launch leaves them at 0
  want = pa.paged_attention_reference(*args)
  for got in outs:
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _plan_case(device, seed, kind, hd, H=4):
  """The tiled kernel's inputs at a step of the real scheduler
  (``testing.step_plans``, 8 slots, chunk 128, bs 16, k = 4): q and the
  pools random in bf16, and a list of ``(tables, positions, tiles)``
  calls: one for a speculative or a warm-prefix step (tiles from the
  planner with the plan's draft runs), four for a draft model's rollout
  (one-row tiles planned once from the last call, slot 0 crossing
  position 256)."""
  from easyparallellibrary_tpu_torch.testing import step_plans
  plan = step_plans.scheduled_step(seed, warm=kind == "warm_prefix")
  MB = plan.block_tables.shape[1]
  NB = 8 * MB + 1
  if kind == "rollout":
    calls = step_plans.rollout_positions(plan, 4, cross=256)
    tables = plan.block_tables
    runs = pa.one_row_runs(len(tables))
    plan_pos = calls[-1]
  else:
    calls = [plan.positions]
    tables = plan.block_tables[plan.slot_ids]
    runs = pa.tile_runs_from_plan(plan.base_idx, plan.num_valid,
                                  len(plan.positions), plan.draft_base,
                                  plan.draft_cap)
    plan_pos = plan.positions
  tiles = pa.plan_tiles(runs, plan_pos, MB, 16, H, device)
  r = np.random.RandomState(seed)
  floats = [torch.from_numpy(r.randn(*shape).astype(np.float32)).to(
      device, torch.bfloat16) for shape in ((len(tables), H, hd),
                                            (NB, 16, H, hd), (NB, 16, H, hd))]
  tables = torch.from_numpy(tables).to(device)
  return floats, [(tables, torch.from_numpy(p).to(device), tiles)
                  for p in calls]


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kind", ["speculative", "warm_prefix", "rollout"])
def test_paged_tiled_kernel_on_speculative_and_warm_prefix_plans(cuda, kind,
                                                                 hd):
  """The tiled build over the planner's tiles of a speculative step
  (decode tokens, draft runs, a prefill chunk, padding), of a
  warm-prefix step (a chunk from position 256 over shared blocks) and of
  a draft model's rollout calls (one plan for all four) equals the
  plain version (bf16, rtol = atol = 2e-2)."""
  (q, kp, vp), calls = _plan_case(cuda, 7, kind, hd)
  for tables, positions, tiles in calls:
    launches = pa.paged_attention_tiled_cuda.launches
    got = pa.paged_attention(q, kp, vp, tables, positions, tiles)
    torch.cuda.synchronize()
    assert pa.paged_attention_tiled_cuda.launches == launches + 1
    assert not tiles.counters.any()
    want = pa.paged_attention_reference(q, kp, vp, tables, positions)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
def test_speculative_engine_streams_match_the_plain_engine_on_the_card(
    cuda):
  """Small width, fp32: the n-gram drafter and a self-draft model, with
  the prefix cache on, give the non-speculative engine's greedy
  streams."""
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, DraftModelDrafter, NgramDrafter, Request)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  torch.backends.cuda.matmul.allow_tf32 = False
  model, params = tiny_gpt(seed=3, max_seq_len=64, device=cuda)
  r = np.random.RandomState(0)
  head = r.randint(0, 64, (8,)).astype(np.int32)
  prompts = [np.concatenate([head, np.tile(r.randint(0, 64, (n,)), 2)])
             .astype(np.int32) for n in (5, 3, 9, 1, 6)]

  def run(**kw):
    eng = ContinuousBatchingEngine(model, params, num_slots=3,
                                   prefill_chunk=8, paged=True,
                                   block_size=4, **kw)
    for i, p in enumerate(prompts):
      eng.submit(Request(uid=i, prompt=p, max_new_tokens=12))
    return eng, eng.run()

  _, want = run()
  for kw in (dict(drafter=NgramDrafter(k=4), prefix_cache=True),
             dict(drafter=DraftModelDrafter(model, params, k=4))):
    eng, got = run(**kw)
    assert eng.steps < sum(12 for _ in prompts)
    for i in range(len(prompts)):
      np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")


@pytest.mark.gpu
def test_paged_tiled_kernel_reads_null_block_for_bad_table_entries(cuda):
  """Table entries at or past NB, and negative ones, read the null
  block 0, as the plain version's gather of a clamped index would not:
  the plain version gets the corrected table."""
  args, runs = _paged_step(cuda, torch.bfloat16, 4, slots=[(0, 50),
                                                           (90, 1)],
                           T=52, H=4, hd=64, bs=16, MB=8)
  q, kp, vp, tables, positions = args
  bad = tables.clone()
  NB = kp.shape[0]
  bad[:50, 1] = NB
  bad[50, 2] = NB + 7
  bad[50, 3] = -3
  fixed = torch.where((bad < 0) | (bad >= NB), 0, bad)
  got = pa.paged_attention(q, kp, vp, bad, positions)
  want = pa.paged_attention_reference(q, kp, vp, fixed, positions)
  torch.cuda.synchronize()
  torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                             atol=2e-2)


@pytest.mark.gpu
def test_paged_tiled_refused_launch_raises(cuda):
  """65536 heads exceed the tiled grid's y dimension: the launch is
  refused, the wrapper raises, and nothing is counted."""
  H = 65536
  args, runs = _paged_step(cuda, torch.bfloat16, 5, slots=[(0, 1)], T=1,
                           H=H, hd=64, bs=1, MB=4, NB=2)
  launches = pa.paged_attention_tiled_cuda.launches
  with pytest.raises(RuntimeError, match="launch failed"):
    pa.paged_attention(*args)
  assert pa.paged_attention_tiled_cuda.launches == launches


@pytest.mark.gpu
def test_training_step_on_the_card_matches_the_cpu(cuda):
  """A tiny GPT with the flash kernels under ``dots_flash`` remat, fp32:
  two AdamW steps on the card launch each kernel once per layer per step
  and give the losses of the same steps on the CPU (plain versions)."""
  from easyparallellibrary_tpu_torch import bench
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = bench.bench_config(torch.device("cuda"), vocab_size=64,
                           num_layers=2, num_heads=4, d_model=64, d_ff=128,
                           max_seq_len=128, loss_chunk=32,
                           dtype=torch.float32)[0]
  losses = {}
  for device in ("cpu", "cuda"):
    state, step, batch, rng, _ = bench.build_training(cfg, 2, device)
    fa.reset_counts()
    losses[device] = []
    for _ in range(2):
      state, metrics = step(state, batch, rng)
      losses[device].append(metrics["loss"].item())
  assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
          fa.flash_bwd_dq_cuda.launches) == (4, 4, 4)
  assert (fa.flash_fwd_reference.calls, fa.flash_bwd_dkv_reference.calls,
          fa.flash_bwd_dq_reference.calls) == (0, 0, 0)
  np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


@pytest.mark.gpu
def test_bf16_training_step_flash_matches_dense_on_the_card(cuda):
  """bf16 at head dim 64, where the kernels take the tensor cores: three
  AdamW steps with the flash kernels against the same steps with dense
  attention.  Both round to bf16 in other places, so the losses agree
  to rtol 2e-4 (about 6 times the 3.5e-5 an H100 shows), not bit for
  bit."""
  from easyparallellibrary_tpu_torch import bench
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  losses = {}
  for attn in ("pallas_flash", "xla"):
    cfg = bench.bench_config(torch.device("cuda"), vocab_size=256,
                             num_layers=2, num_heads=2, d_model=128,
                             d_ff=256, max_seq_len=256, loss_chunk=64,
                             attn_impl=attn)[0]
    state, step, batch, rng, _ = bench.build_training(cfg, 2, cuda)
    fa.reset_counts()
    losses[attn] = []
    for _ in range(3):
      state, metrics = step(state, batch, rng)
      losses[attn].append(metrics["loss"].item())
    want = 6 if attn == "pallas_flash" else 0
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
            fa.flash_bwd_dq_cuda.launches) == (want,) * 3
  assert np.isfinite(losses["pallas_flash"]).all()
  np.testing.assert_allclose(losses["pallas_flash"], losses["xla"],
                             rtol=2e-4)


# fp16: the kernels and the plain versions round p (and dS) at the same
# points from scores summed in another order, as in bf16, so the outputs
# are held by normalized error too.  chip_smoke.py's FLASH_FP16_LIMIT and
# PAGED_FP16_LIMIT say how the limits were set.
FLASH_FP16_LIMIT = dict(fwd=(1e-3, 2e-3), grad=(2e-4, 2e-3))
PAGED_FP16_LIMIT = (1e-3, 2e-3)


def _assert_normalized_close(got, want, limit, name):
  diff, ref = got.float() - want.float(), want.float()
  rel_l2 = (diff.norm() / ref.norm()).item()
  max_rel = (diff.abs().max() / ref.abs().max()).item()
  assert rel_l2 <= limit[0] and max_rel <= limit[1], (name, rel_l2, max_rel)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,H,S,Skv,D", [
    (2, 3, 200, 200, 8),
    (2, 2, 128, 128, 32),
    (2, 3, 200, 200, 64),
    (1, 2, 128, 192, 128),
    (1, 2, 96, 96, 256),
    (1, 1, 1, 1, 64),
])
def test_flash_fp16_kernels_match_plain_versions(cuda, causal, B, H, S, Skv,
                                                 D):
  """The fp16 builds (the CUDA-core kernels instantiated for __half) at
  ragged lengths, a key length past the query length, a one-token
  sequence and head dims 8 to 256."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  q, k, v, dout = _flash_case(cuda, torch.float16, 17, B, H, S, Skv, D)
  launches = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
              fa.flash_bwd_dq_cuda.launches)
  out, lse = fa.flash_fwd(q, k, v, causal)
  want_out, want_lse = fa.flash_fwd_reference(q, k, v, causal)
  delta = (dout.float() * want_out.float()).sum(-1)
  dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal)
  dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal)
  torch.cuda.synchronize()
  assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
          fa.flash_bwd_dq_cuda.launches) == tuple(n + 1 for n in launches)
  want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, want_lse,
                                                delta, causal)
  want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                      causal)
  assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.float16
  _assert_normalized_close(out, want_out, FLASH_FP16_LIMIT["fwd"], "out")
  torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-6)
  for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                          ("dv", dv, want_dv)):
    _assert_normalized_close(got, want, FLASH_FP16_LIMIT["grad"], name)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    dict(seed=1, T=16, H=8, hd=64, NB=17, bs=16, MB=8),
    dict(seed=2, T=5, H=3, hd=24, NB=9, bs=8, MB=4),
    dict(seed=3, T=9, H=4, hd=128, NB=13, bs=16, MB=6),
    dict(seed=4, T=7, H=2, hd=256, NB=9, bs=8, MB=4),
    dict(seed=5, T=3, H=1, hd=8, NB=5, bs=2, MB=3),
])
def test_paged_fp16_warp_build_matches_plain_version(cuda, shape):
  """fp16 runs the warp build at every head dim, 64 and 128 included
  (the tiled build stays bf16-only)."""
  args = _case(cuda, torch.float16, **shape)
  launches = (pa.paged_attention_warp_cuda.launches,
              pa.paged_attention_tiled_cuda.launches)
  got = pa.paged_attention(*args)
  torch.cuda.synchronize()
  assert (pa.paged_attention_warp_cuda.launches,
          pa.paged_attention_tiled_cuda.launches) == (launches[0] + 1,
                                                      launches[1])
  assert got.dtype == torch.float16
  want = pa.paged_attention_reference(*args)
  _assert_normalized_close(got, want, PAGED_FP16_LIMIT, "paged fp16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16],
                         ids=["fp32", "fp16"])
def test_nan_inputs_give_nan_outputs(cuda, dtype):
  """``fmaxf`` drops a NaN operand, so a running max alone would hide
  one; the NaN must still reach the output through p, in the flash
  forward and in the paged warp build, for the serving engine's
  finiteness verdict to see a poisoned step on the card."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  q, k, v, _ = _flash_case(cuda, dtype, 19, 1, 2, 64, 64, 64)
  q[0, 0, 5] = float("nan")          # one query row of head 0
  k[0, 1, 3] = float("nan")          # one key row of head 1
  out, _ = fa.flash_fwd(q, k, v, True)
  torch.cuda.synchronize()
  assert bool(torch.isnan(out[0, 0, 5]).all())
  assert bool(torch.isnan(out[0, 1, 3:]).all())    # every row that sees k 3
  assert bool(torch.isfinite(out[0, 1, :3]).all())
  args = list(_case(cuda, dtype, seed=6, T=4, H=2, hd=64, NB=5, bs=8, MB=4))
  args[0][2, 1] = float("nan")
  got = pa.paged_attention(*args)
  torch.cuda.synchronize()
  assert bool(torch.isnan(got[2, 1]).all())
  assert bool(torch.isfinite(got[:2]).all())


@pytest.mark.gpu
def test_paged_fp16_query_over_fp32_pools_runs_the_fp32_build(cuda):
  """amp O1 over an fp32 model config: an fp16 query over fp32 pools is
  read in fp32 (an exact cast) by the fp32 warp build, and the output
  is fp32, as the plain version's promoted result is.  The plain version
  rounds p to the query's fp16 before the V product, the kernel keeps it
  in fp32 (the Pallas kernel's ``p.astype(v.dtype)``): held to fp16's
  resolution, rtol = atol = 2e-3."""
  q, kp, vp, tables, positions = _case(cuda, torch.float32, seed=7, T=9,
                                       H=4, hd=64, NB=13, bs=16, MB=6)
  q = q.half()
  launches = pa.paged_attention_warp_cuda.launches
  got = pa.paged_attention(q, kp, vp, tables, positions)
  torch.cuda.synchronize()
  assert pa.paged_attention_warp_cuda.launches == launches + 1
  want = pa.paged_attention_reference(q, kp, vp, tables, positions)
  assert got.dtype == want.dtype == torch.float32
  torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
  with pytest.raises(ValueError, match="one dtype"):
    pa.paged_attention(q, kp.bfloat16(), vp.bfloat16(), tables, positions)


@pytest.mark.gpu
def test_contiguous_engine_greedy_streams_match_generate_on_the_card(cuda):
  """The default serving layout on the card: staggered greedy streams
  equal ``generate`` (fp32, no TF32), with no paged-attention launch
  (the slot layout's attention is dense) and the cursors advanced on the
  card."""
  from easyparallellibrary_tpu_torch.models.gpt import generate
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  torch.backends.cuda.matmul.allow_tf32 = False
  model, params = tiny_gpt(seed=3, device=cuda)
  r = np.random.RandomState(0)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32) for n in (5, 3, 9, 1)]
  eng = ContinuousBatchingEngine(model, params, num_slots=2,
                                 prefill_chunk=4)
  assert not eng.paged and eng._cursors.is_cuda
  launches = pa.paged_attention_cuda.launches
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
  out = eng.run()
  assert pa.paged_attention_cuda.launches == launches
  for i, p in enumerate(prompts):
    want = generate(model, params, torch.from_numpy(p[None]).long().to(cuda),
                    6)[0].cpu().numpy()
    np.testing.assert_array_equal(out[i], want, err_msg=f"req {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_nan_step_is_retried_exactly_on_the_card(cuda, paged):
  """A NaN step on the card: the verdict computed there sees the NaN
  logits (the kernels propagate NaN), the step is retried in place, and
  the streams equal ``generate``; right after the bad step the poisoned
  rows read back as zero."""
  from easyparallellibrary_tpu_torch.models.gpt import generate
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.chaos import NaNLogitsInjector
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  torch.backends.cuda.matmul.allow_tf32 = False
  model, params = tiny_gpt(seed=5, device=cuda)
  r = np.random.RandomState(1)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32) for n in (5, 7)]
  kw = dict(paged=True, block_size=4) if paged else dict(paged=False)
  eng = ContinuousBatchingEngine(model, params, num_slots=2,
                                 prefill_chunk=4, resilience=True, **kw)
  inj = NaNLogitsInjector(eng, bad_calls=(3,))
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
  while not inj.poisoned:
    eng.step()
  for layer in eng._kv.values():
    for leaf in layer["attn"].values():
      assert bool(torch.isfinite(leaf).all())
      if paged:
        assert not leaf[0].any()                  # the null block
      else:
        for slot, cur in enumerate(eng._cursors.cpu().numpy()):
          assert not leaf[slot, int(cur):].any()
  out = eng.run()
  assert eng.stats.bad_steps == 1 and eng.stats.step_retries == 2
  for i, p in enumerate(prompts):
    want = generate(model, params, torch.from_numpy(p[None]).long().to(cuda),
                    6)[0].cpu().numpy()
    np.testing.assert_array_equal(out[i], want, err_msg=f"req {i}")
