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
  _check_ragged_tail(cuda, torch.bfloat16, 1e3, causal, D,
                     _assert_flash_close)


def _check_ragged_tail(device, dtype, factor, causal, D, close):
  """Head 1 of [2, 2, 200, D] inputs scaled by ``factor``; every output
  finite, head 0's against its plain version by ``close(got, want,
  kind, name)``."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  q, k, v, dout = _flash_case(device, dtype, 11, 2, 2, 200, 200, D)
  for x in (q, k, v, dout):
    x[:, 1] *= factor
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
  close(out[:, 0], want_out[:, 0], "fwd", "out, head 0")
  torch.testing.assert_close(lse[:, 0], want_lse[:, 0], rtol=2e-5,
                             atol=2e-6)
  close(dk[:, 0], want_dk[:, 0], "grad", "dk, head 0")
  close(dv[:, 0], want_dv[:, 0], "grad", "dv, head 0")
  close(dq[:, 0], want_dq[:, 0], "grad", "dq, head 0")


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


def _plan_case(device, seed, kind, hd, H=4, q_dtype=torch.bfloat16,
               kv_dtype=torch.bfloat16):
  """The tiled kernel's inputs at a step of the real scheduler
  (``testing.step_plans``, 8 slots, chunk 128, bs 16, k = 4): q and the
  pools random in ``q_dtype`` / ``kv_dtype``, and a list of ``(tables,
  positions, tiles)``
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
      device, dtype) for shape, dtype in (((len(tables), H, hd), q_dtype),
                                          ((NB, 16, H, hd), kv_dtype),
                                          ((NB, 16, H, hd), kv_dtype))]
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
PAGED_MIXED_LIMIT = (1e-3, 2e-3)


def _assert_normalized_close(got, want, limit, name):
  diff, ref = got.float() - want.float(), want.float()
  rel_l2 = (diff.norm() / ref.norm()).item()
  max_rel = (diff.abs().max() / ref.abs().max()).item()
  assert rel_l2 <= limit[0] and max_rel <= limit[1], (name, rel_l2, max_rel)


def _build_of(args):
  """The build the dispatcher's rule gives a call: a tiled build's name
  (``pa.TILED_BUILDS``), or ``"warp"`` / ``"mixed"`` for the warp builds."""
  q, kp = args[0], args[1]
  if pa.takes_tiles(q.dtype, kp.dtype, q.shape[-1]):
    return pa.TILED_BUILDS[q.dtype, kp.dtype]
  return "mixed" if q.dtype != kp.dtype else "warp"


def _paged_counts():
  return dict(pa.paged_attention_tiled_cuda.by_build,
              tiled=pa.paged_attention_tiled_cuda.launches,
              warp=pa.paged_attention_warp_cuda.launches,
              mixed=pa.paged_attention_mixed_cuda.launches)


def _counted(before, build):
  """``before`` with one launch of ``build`` added (and the tiled total
  for a tiled build)."""
  after = dict(before)
  after[build] += 1
  if build in pa.TILED_BUILDS.values():
    after["tiled"] += 1
  return after


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,H,S,Skv,D", [
    (2, 3, 200, 200, 8),
    (2, 2, 128, 128, 32),
    (2, 3, 200, 200, 64),
    (1, 2, 128, 192, 128),
    (1, 2, 96, 96, 256),
    (1, 1, 1, 1, 64),
    (2, 16, 1024, 1024, 64),
])
def test_flash_fp16_kernels_match_plain_versions(cuda, causal, B, H, S, Skv,
                                                 D):
  """The fp16 builds at ragged lengths, a key length past the query
  length, a one-token sequence, head dims 8 to 256 and the training
  shape (batch cut to 2): the forward, dK/dV and dQ on the wgmma builds
  at head dims 64 and 128, every other head dim on the CUDA-core
  kernels, as ``flash_route`` reports."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  tensor_cores = D in (64, 128)
  assert [fa.flash_route(k, torch.float16, D) for k in ("fwd", "dkv", "dq")
          ] == ["wgmma" if tensor_cores else "cuda_cores"] * 3, D
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
  grads = [("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)]
  if Skv == 1:
    # One key: the softmax has no gradient with respect to its only
    # score, so the exact dS, dK and dQ are 0, and dS = p (dP - delta) is
    # the difference of two fp32 sums of the same D products of dO and
    # V, taken in other orders by the wgmma builds and by the plain
    # version.  The plain version is then no reference for dK and dQ:
    # both builds' are held to 0 within that rounding, 2 D 2^-24
    # max(sum |dO V|) over sqrt(D), times max|q| (dK) or max|k| (dQ),
    # with fp16's relative and subnormal rounding of dS and of the
    # gradient on top.
    terms = (dout.float() * v.float()).abs().sum(-1).max()
    noise = 2 * D * 2.0 ** -24 * terms * (1 + 2.0 ** -10) / D ** 0.5
    for name, got, other in (("dk", dk, q), ("plain dk", want_dk, q),
                             ("dq", dq, k), ("plain dq", want_dq, k)):
      bound = (noise * other.float().abs().max() + 2.0 ** -24).item()
      assert got.float().abs().max().item() <= bound, (name, bound)
    grads = [g for g in grads if g[0] == "dv"]
  for name, got, want in grads:
    _assert_normalized_close(got, want, FLASH_FP16_LIMIT["grad"], name)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_fp16_ragged_tail_reads_nothing_of_the_next_head(cuda, causal,
                                                              D):
  """The fp16 wgmma builds (forward, dK/dV) read their tiles through
  FLOAT16 TMA maps: at S = 200 the rows past S arrive as zeros, not as
  the next head's.  The next head is 10 times larger (1e3 would take its
  own dK past fp16's range)."""
  def close(got, want, kind, name):
    _assert_normalized_close(got, want, FLASH_FP16_LIMIT[kind], name)
  _check_ragged_tail(cuda, torch.float16, 10.0, causal, D, close)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    dict(seed=1, T=16, H=8, hd=64, NB=17, bs=16, MB=8),
    dict(seed=2, T=5, H=3, hd=24, NB=9, bs=8, MB=4),
    dict(seed=3, T=9, H=4, hd=128, NB=13, bs=16, MB=6),
    dict(seed=4, T=7, H=2, hd=256, NB=9, bs=8, MB=4),
    dict(seed=5, T=3, H=1, hd=8, NB=5, bs=2, MB=3),
])
def test_paged_fp16_warp_build_matches_plain_version(cuda, shape):
  """fp16 runs the tiled build at head dims 64 and 128 and the warp
  build at every other head dim, each call counted on its build
  alone."""
  args = _case(cuda, torch.float16, **shape)
  before = _paged_counts()
  got = pa.paged_attention(*args)
  torch.cuda.synchronize()
  assert _paged_counts() == _counted(before, _build_of(args))
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
  resolution, rtol = atol = 2e-3.  amp O1 in fp16 over a bf16 config
  (fp16 q over bf16 pools, which once raised here) runs the tiled
  build's mixed instantiation at an engine step of the real scheduler
  (head dim 64), held to its plain version by ``PAGED_MIXED_LIMIT``; any
  other mix of types still raises."""
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
  args = _engine_step_mixed(cuda, seed=7)
  before = _paged_counts()
  got = pa.paged_attention(*args)
  torch.cuda.synchronize()
  assert _paged_counts() == _counted(before, "fp16_bf16")
  want = pa.paged_attention_reference(*args)
  assert got.dtype == want.dtype == torch.float32
  _assert_normalized_close(got, want, PAGED_MIXED_LIMIT, "engine_step")
  with pytest.raises(ValueError, match="one dtype"):
    pa.paged_attention(q.bfloat16(), kp.half(), vp.half(), tables,
                       positions)
  with pytest.raises(ValueError, match="fp16 q over"):
    pa.paged_attention_mixed_cuda(q, kp.half(), vp.half(), tables,
                                  positions)


def _engine_step_mixed(device, seed, H=16, hd=64):
  """An engine step of the real scheduler (``testing.step_plans``, no
  drafts: decode tokens, a prefill chunk, padding) with an fp16 query
  over bf16 pools."""
  from easyparallellibrary_tpu_torch.testing import step_plans
  plan = step_plans.scheduled_step(seed, spec_k=0)
  NB = 8 * plan.block_tables.shape[1] + 1
  r = np.random.RandomState(seed)
  q = torch.from_numpy(r.randn(len(plan.positions), H, hd).astype(
      np.float32)).to(device, torch.float16)
  kp, vp = [torch.from_numpy(r.randn(NB, 16, H, hd).astype(np.float32)).to(
      device, torch.bfloat16) for _ in range(2)]
  tables = torch.from_numpy(plan.block_tables[plan.slot_ids]).to(device)
  return q, kp, vp, tables, torch.from_numpy(plan.positions).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    dict(seed=1, T=16, H=8, hd=64, NB=17, bs=16, MB=8),
    dict(seed=2, T=5, H=3, hd=24, NB=9, bs=8, MB=4),
    dict(seed=3, T=9, H=4, hd=128, NB=13, bs=16, MB=6),
    dict(seed=4, T=7, H=2, hd=256, NB=9, bs=8, MB=4),
    dict(seed=5, T=3, H=1, hd=8, NB=5, bs=2, MB=3),
    dict(seed=6, T=1, H=1, hd=64, NB=2, bs=16, MB=1),
])
def test_paged_mixed_build_matches_plain_version(cuda, shape):
  """fp16 q over bf16 pools (fp32 out) at ragged head dims 8 to 256, one
  token, a one-block table: the tiled build's mixed instantiation at
  head dims 64 and 128, the mixed warp build elsewhere, each call
  counted on its build alone; a NaN in q gives NaN in that token's
  output row and nowhere else."""
  q, kp, vp, tables, positions = _case(cuda, torch.float32, **shape)
  args = (q.half(), kp.bfloat16(), vp.bfloat16(), tables, positions)
  before = _paged_counts()
  got = pa.paged_attention(*args)
  torch.cuda.synchronize()
  assert _paged_counts() == _counted(before, _build_of(args))
  want = pa.paged_attention_reference(*args)
  assert got.dtype == torch.float32
  _assert_normalized_close(got, want, PAGED_MIXED_LIMIT, "paged mixed")
  args[0][0, 0] = float("nan")
  got = pa.paged_attention(*args)
  torch.cuda.synchronize()
  assert bool(torch.isnan(got[0, 0]).all())
  assert bool(torch.isfinite(got[1:]).all()) and bool(
      torch.isfinite(got[0, 1:]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kind", ["speculative", "warm_prefix", "rollout"])
@pytest.mark.parametrize("build", ["fp16", "fp16_bf16"])
def test_paged_tiled_fp16_and_mixed_builds_on_scheduler_plans(cuda, build,
                                                              kind, hd):
  """The tiled build's fp16 and mixed (fp16 q over bf16 pools, fp32 out)
  instantiations over the planner's tiles of a speculative step, a
  warm-prefix step and a draft model's rollout calls: each call counted
  on its build, the plan's counters left at 0, and the output held by
  ``PAGED_FP16_LIMIT`` / ``PAGED_MIXED_LIMIT`` to the plain version
  over the pools read in fp32 (exact): scores and the V product in fp32
  as the kernels (and the Pallas kernel) take them, p rounded to the
  query's fp16.  For the mixed build that is its plain version; the
  fp16 plain version rounds the scores to fp16 as well, which at head
  dim 128 over the rollout's 8 rows alone comes near the limit (the warp
  fp16 build reads the same there)."""
  q_dtype, kv_dtype = {"fp16": (torch.float16, torch.float16),
                       "fp16_bf16": pa.MIXED_DTYPES}[build]
  (q, kp, vp), calls = _plan_case(cuda, 8, kind, hd, q_dtype=q_dtype,
                                  kv_dtype=kv_dtype)
  limit = PAGED_FP16_LIMIT if build == "fp16" else PAGED_MIXED_LIMIT
  for tables, positions, tiles in calls:
    before = _paged_counts()
    got = pa.paged_attention(q, kp, vp, tables, positions, tiles)
    torch.cuda.synchronize()
    assert _paged_counts() == _counted(before, build)
    assert not tiles.counters.any()
    want = pa.paged_attention_reference(q, kp.float(), vp.float(), tables,
                                        positions)
    assert got.dtype == torch.promote_types(q_dtype, kv_dtype)
    assert bool(torch.isfinite(got).all())
    _assert_normalized_close(got, want, limit, f"{build} {kind}")


@pytest.mark.gpu
def test_paged_route_is_the_dispatchers_rule(cuda):
  """The library's own gate (``paged_route``, from the constant the
  tiled entry reads) gives every (query, pool) type pair and head dim
  the build ``takes_tiles`` routes it to."""
  dtypes = (torch.float32, torch.bfloat16, torch.float16)
  for q_dtype in dtypes:
    for kv_dtype in dtypes:
      for hd in (8, 32, 64, 128, 256):
        want = "tiled" if pa.takes_tiles(q_dtype, kv_dtype, hd) else "warp"
        if kv_dtype != torch.float32 and q_dtype != kv_dtype and (
            (q_dtype, kv_dtype) != pa.MIXED_DTYPES):
          with pytest.raises(ValueError, match="no build"):
            pa.paged_route(q_dtype, kv_dtype, hd)
          continue
        assert pa.paged_route(q_dtype, kv_dtype, hd) == want, (
            q_dtype, kv_dtype, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("build", ["fp16", "fp16_bf16"])
def test_paged_tiled_fp16_refused_launch_raises(cuda, build):
  """The fp16 and mixed tiled builds raise on a refused launch (65536
  heads exceed the grid's y dimension) and count nothing: no warp build
  stands in."""
  H = 65536
  args, runs = _paged_step(cuda, torch.float16, 5, slots=[(0, 1)], T=1,
                           H=H, hd=64, bs=1, MB=4, NB=2)
  if build == "fp16_bf16":
    args = (args[0], args[1].bfloat16(), args[2].bfloat16(), *args[3:])
  before = _paged_counts()
  with pytest.raises(RuntimeError, match="launch failed"):
    pa.paged_attention(*args)
  assert _paged_counts() == before


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


# --------------------------------------------------- serving observability


def _traced_paged_run(device, traced, tmp_path):
  """Staggered greedy requests through the paged engine (n-gram drafter,
  prefix cache) with observability fully on or off, under
  ``torch.cuda.set_sync_debug_mode("warn")``; returns the streams, the
  engine and the count of synchronising calls."""
  import warnings
  from easyparallellibrary_tpu_torch.config import Config
  from easyparallellibrary_tpu_torch.env import Env
  from easyparallellibrary_tpu_torch.observability import (
      device as device_lib, slo, trace)
  from easyparallellibrary_tpu_torch.observability.registry import (
      MetricRegistry)
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, NgramDrafter, Request)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  for mod in (trace, slo, device_lib):
    mod.reset()
  Env.get().reset(Config({"observability": {
      "enabled": True, "slo": {"enabled": True},
      "device": {"enabled": True}}}) if traced else None)
  torch.backends.cuda.matmul.allow_tf32 = False
  model, params = tiny_gpt(seed=3, device=device)
  r = np.random.RandomState(4)
  shared = np.arange(1, 9, dtype=np.int32)
  prompts = [np.concatenate([shared, np.tile(r.randint(0, 64, (n,)), 2)])
             .astype(np.int32) for n in (3, 1, 6, 2)]
  eng = ContinuousBatchingEngine(
      model, params, device=device, num_slots=2, prefill_chunk=8,
      paged=True, block_size=4,
      prefix_cache=True, drafter=NgramDrafter(k=4),
      registry=MetricRegistry() if traced else None)
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
      out = eng.run()
    finally:
      torch.cuda.set_sync_debug_mode("default")
  syncs = sum("synchroniz" in str(w.message) for w in caught)
  path = trace.get_tracer().export(str(tmp_path / "t.json")) if traced \
      else None
  for mod in (trace, slo, device_lib):
    mod.reset()
  Env.get().reset()
  return out, eng, syncs, path


@pytest.mark.gpu
def test_traced_engine_on_the_card_validates_and_equals_untraced(
    cuda, tmp_path):
  """Observability fully on, on the card: the trace validates with every
  request's lifecycle, the streams equal the untraced run's, the HBM
  gauges read the card, and the cost card shows the pools written in
  place."""
  from easyparallellibrary_tpu_torch.observability import report, trace
  want, _, _, _ = _traced_paged_run(cuda, False, tmp_path)
  got, eng, _, path = _traced_paged_run(cuda, True, tmp_path)
  for i in want:
    np.testing.assert_array_equal(got[i], want[i])
  events = trace.validate_trace(path)
  spans, unmatched = report.pair_spans(events)
  assert unmatched == 0
  assert sorted(sp["args"]["uid"] for sp in spans
                if sp["cat"] == "serving.request") == ["0", "1", "2", "3"]
  latest = eng.registry.latest()
  assert 0 < latest["observability/device/hbm_frac"] < 1
  assert latest["observability/device/hbm_bytes_limit"] > 0
  card = eng._introspector.card("serving/fused_step")
  assert card.donation_verified and card.peak_hbm_bytes > 0
  assert eng._compile_sentinel.recompiles == 0


@pytest.mark.gpu
def test_tracing_adds_no_synchronising_call(cuda, tmp_path):
  """The step keeps its one device-to-host fetch: the same load makes
  as many synchronising calls traced as untraced
  (``torch.cuda.set_sync_debug_mode("warn")``)."""
  _traced_paged_run(cuda, False, tmp_path)        # warm: kernels loaded
  want, _, off, _ = _traced_paged_run(cuda, False, tmp_path)
  got, eng, on, _ = _traced_paged_run(cuda, True, tmp_path)
  for i in want:
    np.testing.assert_array_equal(got[i], want[i])
  assert on == off > 0, (on, off, eng.steps)


# -------------------------------------------- the training runtime (slice 8)


def _tiny_training(device, config=None):
  """A tiny GPT under the trainer with the sentinel on, on ``device``."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.models.gpt import (
      GPT, GPTConfig, gpt_loss)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel import (
      create_sharded_train_state, parallelize)
  from easyparallellibrary_tpu_torch.runtime.trainer import (
      build_train_step, create_train_state)
  from easyparallellibrary_tpu_torch.weights import init_params
  epl.init(config or epl.Config({"resilience.max_bad_steps": 2}),
           device=device)
  cfg = GPTConfig(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
                  d_ff=64, max_seq_len=16, dtype=torch.bfloat16,
                  attn_impl="pallas_flash")
  with epl.replicate(1):
    model = GPT(cfg)
  mesh = epl.current_plan().build_mesh()
  state, sh = create_sharded_train_state(
      lambda: create_train_state(model, init_params(cfg, 0, device=device),
                                 adamw(1e-3, weight_decay=0.01)), mesh)

  def loss_fn(p, b, rng):
    loss, aux = gpt_loss(model, p, b, rng)
    return loss * b["weight"].mean(), aux

  return model, state, parallelize(build_train_step(loss_fn), mesh, sh), mesh


def _token_batches(n, seed=0):
  r = np.random.RandomState(seed)
  return [{"ids": r.randint(0, 64, (4, 17)).astype(np.int32),
           "weight": np.ones(4, np.float32)} for _ in range(n)]


@pytest.mark.gpu
def test_fit_saves_and_resumes_on_the_card(cuda, tmp_path):
  """A tiny fit on the card checkpoints at step 3; a fresh state resumes
  there and ends bit-equal to the uninterrupted run."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.runtime import saver
  from easyparallellibrary_tpu_torch.runtime.loop import fit
  batches = _token_batches(6)

  def data(start_step=0):
    return batches[start_step:]

  _, state, step, _ = _tiny_training(cuda)
  fa.reset_counts()
  state, _ = fit(step, state, data, num_steps=6, log_every=0)
  assert fa.flash_fwd_cuda.launches == 2 * 6
  ckpt = str(tmp_path / "ck")
  _, a, step_a, _ = _tiny_training(cuda)
  fit(step_a, a, data, num_steps=3, checkpoint_dir=ckpt, checkpoint_every=3,
      log_every=0)
  _, b, step_b, _ = _tiny_training(cuda)
  b, _ = fit(step_b, b, data, num_steps=6, checkpoint_dir=ckpt, log_every=0)
  assert saver.latest_step(ckpt) == 3 and int(b.step) == 6
  for name, p in state.params.items():
    assert torch.equal(p, b.params[name]), name
    for key in ("exp_avg", "exp_avg_sq", "step"):
      assert torch.equal(state.opt_state.state[p][key],
                         b.opt_state.state[b.params[name]][key]), name


@pytest.mark.gpu
def test_guarded_step_makes_no_host_sync_on_the_card(cuda):
  """The sentinel's skip (fused AdamW's found_inf) and the clean step
  after it run under ``set_sync_debug_mode("error")``: a host sync
  would raise.  The skipped step leaves every leaf bit-identical."""
  _, state, step, mesh = _tiny_training(cuda)
  batches = [{k: torch.as_tensor(v).to(cuda) for k, v in b.items()}
             for b in _token_batches(3)]
  bad = dict(batches[1], weight=torch.full_like(batches[1]["weight"],
                                                float("nan")))
  key = np.zeros(2, np.uint32)
  state, _ = step(state, batches[0], key)          # creates the moments
  torch.cuda.synchronize()
  before = {n: [p.clone()] + [v.clone() for v in
                              state.opt_state.state[p].values()]
            for n, p in state.params.items()}
  step_before = state.step.clone()
  torch.cuda.set_sync_debug_mode("error")
  try:
    state, m = step(state, bad, key)
    skipped = {n: [p.clone()] + [v.clone() for v in
                                 state.opt_state.state[p].values()]
               for n, p in state.params.items()}
    state, m2 = step(state, batches[2], key)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  for n in before:
    assert all(torch.equal(x, y) for x, y in zip(before[n], skipped[n])), n
  assert int(m["bad_steps"]) == 1 and int(m2["bad_steps"]) == 0
  assert int(state.step) == int(step_before) + 1


@pytest.mark.gpu
def test_prefetcher_keeps_order_with_pinned_buffers(cuda):
  from easyparallellibrary_tpu_torch.io import DevicePrefetcher
  src = [{"x": np.full((1024, 256), i, np.float32),
          "i": np.arange(4, dtype=np.int64) + i} for i in range(8)]
  pre = DevicePrefetcher(iter(src), device=cuda, depth=3)
  out = []
  for b in pre:
    assert b["x"].device.type == "cuda"
    out.append((float(b["x"].float().mean()), b["i"].cpu().tolist()))
  assert pre.copies == 8
  assert out == [(float(i), [i, i + 1, i + 2, i + 3]) for i in range(8)]


@pytest.mark.gpu
def test_serving_from_a_fit_checkpoint_on_the_card(cuda, tmp_path):
  """``DraftModelDrafter.from_checkpoint`` over the checkpoint ``fit``
  wrote: a self-draft paged run launches the paged kernel and serves
  every request."""
  from easyparallellibrary_tpu_torch.runtime import saver
  from easyparallellibrary_tpu_torch.runtime.loop import fit
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, DraftModelDrafter, Request)
  model, state, step, _ = _tiny_training(cuda)
  ckpt = str(tmp_path / "ck")
  fit(step, state, _token_batches(2), num_steps=2, checkpoint_dir=ckpt,
      checkpoint_every=2, log_every=0)
  drafter = DraftModelDrafter.from_checkpoint(ckpt, model, k=2)
  params, rstep = saver.restore_params(ckpt)
  assert rstep == 2
  for name, p in state.params.items():
    assert torch.equal(params[name], p.detach()), name
  eng = ContinuousBatchingEngine(model, params, paged=True, num_slots=2,
                                 prefill_chunk=4, block_size=4,
                                 drafter=drafter)
  launches = pa.paged_attention_cuda.launches
  r = np.random.RandomState(1)
  for i in range(3):
    eng.submit(Request(uid=i, prompt=r.randint(0, 64, (5,)).astype(
        np.int32), max_new_tokens=4))
  out = eng.run()
  assert sorted(out) == [0, 1, 2]
  assert pa.paged_attention_cuda.launches > launches
  assert eng.drafter_failures == 0


# ------------------------------------------------ the fleet and offload --


def _fleet_prompts(n=4, seed=8):
  r = np.random.RandomState(seed)
  return [r.randint(0, 64, (k,)).astype(np.int32)
          for k in r.randint(2, 10, n)]


FLEET_GEOMETRY = dict(num_slots=2, prefill_chunk=4, paged=True, block_size=4)


def _bare_streams(cuda, prompts, max_new=8):
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, Request)
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  model, params = tiny_gpt(device=cuda)
  eng = ContinuousBatchingEngine(model, params, **FLEET_GEOMETRY)
  for i, p in enumerate(prompts):
    eng.submit(Request(uid=i, prompt=p, max_new_tokens=max_new))
  return eng.run()


@pytest.mark.gpu
def test_router_replicas_equal_the_bare_engine_on_the_card(cuda):
  """An N=1 router equals the bare engine (fp32, the paged warp build:
  2 layers x steps launches, no plain call, no new library); two
  in-process replicas with one killed mid-decode lose nothing and stay
  token-equal (fp32)."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.kernels import _build
  from easyparallellibrary_tpu_torch.serving import Request, Router
  from easyparallellibrary_tpu_torch.testing import chaos
  from easyparallellibrary_tpu_torch.testing.factories import tiny_gpt
  torch.backends.cuda.matmul.allow_tf32 = False
  epl.init()
  prompts = _fleet_prompts()
  want = _bare_streams(cuda, prompts)
  model, params = tiny_gpt(device=cuda)
  libs = _build.loaded_count()
  router = Router(model, params, num_replicas=1, **FLEET_GEOMETRY)
  pa.reset_counts()
  for i, p in enumerate(prompts):
    router.submit(Request(uid=i, prompt=p, max_new_tokens=8))
  out = router.run()
  torch.cuda.synchronize()
  steps = router.replicas[0].engine.steps
  assert pa.paged_attention_cuda.launches == 2 * steps > 0
  assert pa.paged_attention_reference.calls == 0
  assert _build.loaded_count() == libs
  for i in want:
    np.testing.assert_array_equal(out[i], want[i], err_msg=f"req {i}")
  router = Router(model, params, num_replicas=2, **FLEET_GEOMETRY)
  chaos.ReplicaKiller(router.replicas[0].engine, kill_calls=(3,))
  for i, p in enumerate(prompts):
    router.submit(Request(uid=i, prompt=p, max_new_tokens=8))
  out = router.run()
  assert router.failovers == 1 and sorted(router.finished) == sorted(want)
  for i in want:
    np.testing.assert_array_equal(out[i], want[i], err_msg=f"req {i}")


@pytest.mark.gpu
def test_process_replicas_survive_a_sigkill_on_the_card(cuda):
  """Two children on the card: a SIGKILL of one mid-decode loses
  nothing, streams stay token-equal to the bare engine (fp32), the
  children's paged launches reach the parent through their beats (no
  plain call), the dead child's pid is reaped and ``close()`` leaves no
  child."""
  import os
  import signal
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.serving import Request, Router
  from easyparallellibrary_tpu_torch.testing import chaos
  torch.backends.cuda.matmul.allow_tf32 = False
  prompts = _fleet_prompts()
  want = _bare_streams(cuda, prompts)
  cfg = epl.Config({"serving": {"router": {
      "transport": "process", "spawn_timeout_s": 300.0,
      "rpc_timeout_s": 120.0}}})
  epl.init(cfg)
  router = Router(num_replicas=2, config=cfg, factory={
      "fn": "easyparallellibrary_tpu_torch.testing.factories:tiny_gpt",
      "kwargs": {}}, device="cuda", **FLEET_GEOMETRY)
  pids = [rep.child_pid for rep in router.replicas]
  try:
    for i, p in enumerate(prompts):
      router.submit(Request(uid=i, prompt=p, max_new_tokens=8))
    for _ in range(3):
      router.step()
    chaos.ProcessKiller(router.replicas[0]).kill()
    router.run()
    assert router.failovers == 1
    assert router.replicas[0].exit_signal == signal.SIGKILL
    for i in want:
      np.testing.assert_array_equal(router.finished[i].tokens, want[i],
                                    err_msg=f"req {i}")
    launches = [rep.kernel_launches for rep in router.replicas]
    assert all(c.get("paged_attention", 0) > 0 for c in launches)
    assert all(c.get("paged_attention_plain", 0) == 0 for c in launches)
  finally:
    router.close()
  for pid in pids:
    with pytest.raises(ProcessLookupError):
      os.kill(pid, 0)


@pytest.mark.gpu
def test_offloaded_moments_are_pinned_and_the_step_is_bit_equal(cuda,
                                                                tmp_path):
  """``offload.level = "v0"`` on the card: the moments live in pinned
  host memory, 4 guarded steps (one NaN-skipped) leave params, moments
  and steps bit-equal to the same run without offload, and a native
  save/restore of the offloaded state is bit-equal into the same pinned
  tensors."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.runtime import saver
  from easyparallellibrary_tpu_torch.runtime.offload import (
      HostOffloadOptimizer)
  from easyparallellibrary_tpu_torch.testing import chaos
  runs = []
  batches = _token_batches(4)
  for offload in ("", "v0"):
    _, state, step, _ = _tiny_training(cuda, epl.Config({
        "resilience.max_bad_steps": 2, "offload.level": offload}))
    assert isinstance(state.opt_state, HostOffloadOptimizer) == bool(offload)
    for i, b in enumerate(batches):
      state, _ = step(state, chaos.nan_batch(b) if i == 1 else b, None)
    torch.cuda.synchronize()
    runs.append(state)
  plain, off = runs
  for name, p in plain.params.items():
    q = off.params[name]
    assert torch.equal(p, q), name
    st = off.opt_state.state[q]
    assert st["exp_avg"].is_pinned() and st["exp_avg_sq"].is_pinned()
    for key in ("exp_avg", "exp_avg_sq", "step"):
      assert torch.equal(plain.opt_state.state[p][key].cpu(),
                         st[key].cpu()), (name, key)
  ckpt = str(tmp_path / "ck")
  saver.save_checkpoint(ckpt, saver.state_tree(off), step=3)
  hosts = {n: off.opt_state.state[p]["exp_avg"] for n, p in
           off.params.items()}
  off, rstep = saver.restore_train_state(ckpt, off)
  assert rstep == 3
  for name, p in off.params.items():
    assert off.opt_state.state[p]["exp_avg"] is hosts[name]
    assert torch.equal(hosts[name],
                       plain.opt_state.state[plain.params[name]][
                           "exp_avg"].cpu())


@pytest.mark.gpu
def test_offloaded_step_streams_many_buckets_bit_equal(cuda):
  """``HostOffloadOptimizer`` in buckets of at most the largest
  parameter's moments, so the side streams double-buffer many buckets a
  step: 4 guarded steps (one NaN-skipped) leave params and both moments
  bit-equal to the run without offload."""
  import easyparallellibrary_tpu_torch as epl
  from easyparallellibrary_tpu_torch.runtime.offload import (
      HostOffloadOptimizer)
  from easyparallellibrary_tpu_torch.testing import chaos
  runs = []
  batches = _token_batches(4, seed=1)
  for offload in (False, True):
    _, state, step, _ = _tiny_training(cuda, epl.Config({
        "resilience.max_bad_steps": 2}))
    if offload:
      state = state.replace(opt_state=HostOffloadOptimizer(
          state.opt_state, bucket_mb=0.01))
      assert state.opt_state.num_buckets > 2
    for i, b in enumerate(batches):
      state, _ = step(state, chaos.nan_batch(b) if i == 1 else b, None)
    torch.cuda.synchronize()
    runs.append(state)
  plain, off = runs
  for name, p in plain.params.items():
    q = off.params[name]
    assert torch.equal(p, q), name
    for key in ("exp_avg", "exp_avg_sq"):
      got = off.opt_state.state[q][key]
      assert got.is_pinned(), (name, key)
      assert torch.equal(plain.opt_state.state[p][key].cpu(), got), (name,
                                                                      key)


@pytest.mark.gpu
def test_dcp_round_trip_of_card_tensors(cuda, tmp_path):
  """``save_checkpoint_orbax`` / ``restore_checkpoint_orbax`` (DCP) of a
  tree of card tensors, fp32 and bf16: bit-equal, back on the card."""
  from easyparallellibrary_tpu_torch.runtime import saver
  g = torch.Generator(device="cpu").manual_seed(0)
  tree = {"w": torch.randn(64, 32, generator=g).to(cuda),
          "h": torch.randn(7, generator=g).to(cuda, torch.bfloat16),
          "n": torch.tensor(5, dtype=torch.int32, device=cuda)}
  saver.save_checkpoint_orbax(str(tmp_path), tree, step=1)
  got = saver.restore_checkpoint_orbax(str(tmp_path), 1, target=tree)
  for k, v in tree.items():
    assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
    assert torch.equal(got[k], v), k


# ---------------------------------------------- the tensor-parallel slice


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_paged_tiled_kernel_at_the_tp2_rank_shape(cuda, hd):
  """K2 at the per-rank heads of a TP = 2 GPT-350M engine (H / tp = 8)
  at ``engine_step``: the tiled build against its plain version."""
  step = dict(PAGED_STEPS["engine_step"], H=8)
  args, runs = _paged_step(cuda, torch.bfloat16, 5, hd=hd, **step)
  tiles = pa.plan_tiles(runs, args[4].cpu().numpy(), args[3].shape[1],
                        args[1].shape[1], 8, cuda)
  launches = pa.paged_attention_tiled_cuda.launches
  got = pa.paged_attention(*args, tiles)
  torch.cuda.synchronize()
  assert pa.paged_attention_tiled_cuda.launches == launches + 1
  want = pa.paged_attention_reference(*args)
  torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                             atol=2e-2)


@pytest.mark.gpu
def test_flash_kernels_at_the_tp2_rank_shape(cuda):
  """K1's three kernels at the per-rank heads of TP = 2 training
  (H / tp = 8, S = 1024, D = 64; batch cut to 2), bf16 causal, against
  their plain versions by chip_smoke.py's normalized limits."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  q, k, v, dout = _flash_case(cuda, torch.bfloat16, 11, 2, 8, 1024, 1024,
                              64)
  out, _ = fa.flash_fwd(q, k, v, True)
  want_out, want_lse = fa.flash_fwd_reference(q, k, v, True)
  _assert_flash_close(out, want_out, "fwd", "out")
  delta = (dout.float() * want_out.float()).sum(-1)
  dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, True)
  dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, True)
  want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, want_lse,
                                                delta, True)
  want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta, True)
  for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                          ("dv", dv, want_dv)):
    _assert_flash_close(got, want, "grad", name)


@pytest.mark.gpu
def test_tp2_engine_on_the_card_equals_tp1(cuda):
  """Two gloo ranks sharing the card (NCCL refuses two ranks on one
  device): a tiny fp32 TP = 2 paged engine's staggered streams equal the
  tp = 1 engine's, each rank's paged launches layers x steps."""
  from easyparallellibrary_tpu_torch.models.gpt import GPT
  from easyparallellibrary_tpu_torch.serving import ContinuousBatchingEngine
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  from easyparallellibrary_tpu_torch.weights import init_params
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg_kwargs = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32,
                    d_ff=64, max_seq_len=64)
  r = np.random.RandomState(0)
  prompts = [r.randint(0, 64, (n,)).astype(np.int32) for n in (5, 3, 9, 1)]
  runs = {"plain": (prompts, [(0, 2), (2, 4)], 1, 0, False)}
  kw = dict(num_slots=2, prefill_chunk=4, block_size=4)
  ranks = spawn(tp_workers.chip_tp_serving, 2,
                ("gloo", cfg_kwargs, 0, runs, kw, "cuda"), timeout_s=300)
  cfg = tp_workers.gpt_config(cfg_kwargs)
  eng = ContinuousBatchingEngine(GPT(cfg), init_params(cfg, 0, device=cuda),
                                 paged=True, **kw)
  want = tp_workers.lead_waves(eng, prompts, [(0, 2), (2, 4)], 1)
  for i in want:
    np.testing.assert_array_equal(ranks[0]["plain"]["streams"][i], want[i])
  for rec in (ranks[0]["plain"], ranks[1]["plain"]):
    assert rec["all_launches"] == 2 * rec["steps"] > 0
    assert rec["plain_calls"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("engine,strategy", [("smap", "PreferBackward"),
                                             ("", "PreferForward")])
def test_pipeline_step_on_the_card_equals_one_process(cuda, engine,
                                                      strategy):
  """Two gloo stage ranks sharing the card (every hop staged through host
  memory): three AdamW steps of a small fp32 GPT with the flash kernels,
  cut into 2 stages of 4 micro-batches (``smap`` 1F1B; the ``vmap``
  layout's GPipe), give the one-process step's losses."""
  from easyparallellibrary_tpu_torch.testing import pp_workers, tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  from easyparallellibrary_tpu_torch.weights import init_params, stack_stages
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg_kwargs = dict(vocab_size=64, num_layers=4, num_heads=2, d_model=128,
                    d_ff=256, max_seq_len=64, attn_impl="pallas_flash")
  flat = init_params(tp_workers.gpt_config(cfg_kwargs), 0, device="cpu")
  pp_kwargs = dict(cfg_kwargs, pipeline_stages=2, num_micro_batch=4)
  stacked = {k: v.numpy() for k, v in stack_stages(
      flat, tp_workers.gpt_config(pp_kwargs)).items()}
  r = np.random.RandomState(0)
  batches = [r.randint(0, 64, (8, 65)).astype(np.int32) for _ in range(3)]
  ranks = spawn(pp_workers.train, 2,
                ("stage:2", engine, strategy, pp_kwargs, stacked, batches,
                 1e-2, 0.01, "cuda", "gloo"), timeout_s=300)
  one = tp_workers.gpt_train_losses(
      0, 1, "", cfg_kwargs, {k: v.numpy() for k, v in flat.items()},
      batches, 1e-2, device="cuda")
  for rank in ranks:
    np.testing.assert_allclose(rank["losses"], one["losses"], rtol=1e-4)


# ----------------------------- MoE and sequence parallelism (slice 13)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["zigzag", "contiguous"])
def test_ring_attention_step_on_the_card(cuda, layout):
  """Two gloo seq ranks sharing the card: one fp32 flash ring step
  (forward and the recommunicating backward) gives the whole sequence's
  attention and gradients, and each rank launches the forward kernel as
  the layout's formula says."""
  from easyparallellibrary_tpu_torch.sequence.ring_attention import (
      launches_per_layer)
  from easyparallellibrary_tpu_torch.testing import sp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  torch.backends.cuda.matmul.allow_tf32 = False
  r = np.random.RandomState(0)
  q, k, v, dout = (r.randn(2, 256, 4, 64).astype(np.float32)
                   for _ in range(4))
  ranks = spawn(sp_workers.attention, 2, (
      "seq:2", {"sequence.ring_layout": layout}, "ring", True, q, k, v, dout,
      None, False, "cuda", "gloo"), timeout_s=300)
  leaves = [torch.from_numpy(a).to(cuda).requires_grad_(True)
            for a in (q, k, v)]
  s = torch.einsum("bqhd,bkhd->bhqk", *leaves[:2]) / 8.0
  s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool,
                                device=cuda).tril(), float("-inf"))
  want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), leaves[2])
  (want * torch.from_numpy(dout).to(cuda)).sum().backward()
  ranks = sorted(ranks, key=lambda x: x["coords"]["seq"])
  for key, ref in zip(("out", "dq", "dk", "dv"),
                      [want] + [t.grad for t in leaves]):
    got = np.concatenate([x[key] for x in ranks], axis=1)
    np.testing.assert_allclose(got, ref.detach().cpu().numpy(), atol=1e-4,
                               rtol=1e-4)
  for i, x in enumerate(ranks):
    assert x["fwd_calls"] == launches_per_layer(2, i, True,
                                                layout == "zigzag")


@pytest.mark.gpu
def test_moe_layer_on_the_card_routes_as_on_the_cpu(cuda):
  """An fp32 ``MoEMLP`` (top-2, with drops) on the card routes every
  token as on the CPU, even with TF32 allowed for matmuls (the router
  product runs at full fp32 precision): the same drops, the output and
  gradients within the experts' TF32 rounding by normalized error."""
  from torch.func import functional_call

  from easyparallellibrary_tpu_torch.models.gpt import GPTConfig
  from easyparallellibrary_tpu_torch.models.moe import MoEMLP
  cfg = GPTConfig(vocab_size=64, num_layers=2, num_heads=4, d_model=256,
                  d_ff=512, max_seq_len=64, num_experts=8,
                  capacity_factor=0.75, moe_top_k=2, dtype=torch.float32)
  r = np.random.RandomState(1)
  params = {"router_kernel": r.randn(256, 8).astype(np.float32) * 0.5,
            "wi": r.randn(8, 256, 512).astype(np.float32) * 0.02,
            "wo": r.randn(8, 512, 256).astype(np.float32) * 0.02}
  x = r.randn(4, 64, 256).astype(np.float32)
  results = {}
  was = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    for dev in (torch.device("cpu"), cuda):
      layer = MoEMLP(cfg, top_k=2, device="meta")
      p = {k: torch.from_numpy(a).to(dev).requires_grad_(True)
           for k, a in params.items()}
      xx = torch.from_numpy(x).to(dev)
      out, aux = functional_call(layer, p, (xx,))
      (out.square().sum() + aux).backward()
      results[dev.type] = (out.detach().cpu(), layer.last_dropped.cpu(),
                           {k: t.grad.cpu() for k, t in p.items()})
  finally:
    torch.backends.cuda.matmul.allow_tf32 = was
  (oc, dc, gc_), (og, dg, gg) = results["cpu"], results["cuda"]
  assert int(dc) == int(dg) and int(dc) > 0

  def rel(a, b):
    return float((a - b).norm() / b.norm())

  # TF32 experts read ~1e-3 by normalized error; one token sent to
  # another expert moves the output by ~4e-2.
  assert rel(og, oc) < 1e-2, rel(og, oc)
  for k in gc_:
    assert rel(gg[k], gc_[k]) < 2e-2, (k, rel(gg[k], gc_[k]))


# BERT's encoder block at BERT-Large width (phase 24's shape, batch cut):
# the flash kernels with causal=False against the plain version, bf16
# (chip_smoke.py's FLASH_BF16_LIMIT forward limit).
BERT_BF16_LIMIT = (5e-3, 1e-2)


@pytest.mark.gpu
def test_bert_encoder_block_flash_matches_plain_version(cuda):
  """One ``EncoderBlock`` of BERT-Large (D 1024, 16 heads of 64, S 512),
  bf16, with ``attn_impl="pallas_flash"``: the non-causal wgmma kernels
  (one launch each) against the same block on the plain version of the
  same kernels: the output, the input's and every parameter's gradient
  under one fixed cotangent, by normalized error within the forward's
  ``FLASH_BF16_LIMIT`` (``chip_smoke.py``; the forward's rounding of
  the attention output reaches every gradient through the activations,
  so the kernels' own gradient limit, which 24b holds at this shape, is
  not the block's); and the output against dense attention
  (``attn_impl="xla"``) within the same."""
  import dataclasses

  from torch.func import functional_call

  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.models.bert import (
      EncoderBlock, bert_large_config)
  from easyparallellibrary_tpu_torch.weights import init_params
  cfg = bert_large_config(num_layers=1, max_seq_len=512,
                          attn_impl="pallas_flash")
  params = {k[len("block_0."):]: v for k, v in
            init_params(cfg, seed=0, device=cuda).items()
            if k.startswith("block_0.")}
  r = np.random.RandomState(0)
  x, cot = (torch.from_numpy(r.randn(2, 512, 1024).astype(np.float32)).to(
      cuda, torch.bfloat16) for _ in range(2))

  def run(cfg, plain=False):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    xx = x.detach().clone().requires_grad_(True)
    fa.reset_counts()
    real = (fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    if plain:   # the same block with the kernels' plain versions
      fa.flash_fwd = fa.flash_fwd_reference
      fa.flash_bwd_dkv = fa.flash_bwd_dkv_reference
      fa.flash_bwd_dq = fa.flash_bwd_dq_reference
    try:
      out = functional_call(EncoderBlock(cfg, device="meta"), p, (xx,))
      out.backward(cot)
    finally:
      fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq = real
    counts = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
              fa.flash_bwd_dq_cuda.launches)
    return counts, {"out": out.detach(), "dx": xx.grad,
                    **{k: v.grad for k, v in p.items()}}

  counts, kernel = run(cfg)
  assert counts == (1, 1, 1)
  readings = {}
  for label, other in (("plain", run(cfg, plain=True)),
                       ("dense", run(dataclasses.replace(cfg,
                                                         attn_impl="xla")))):
    assert other[0] == (0, 0, 0), label
    for k, got in kernel.items():
      if label == "dense" and k != "out":
        # Dense attention rounds p to bf16 elsewhere: its gradients stray
        # from flash's by up to ~6e-3 on the CPU too.
        continue
      want = other[1][k].float()
      got = got.float()
      if k == "qkv.bias":
        # The key bias's gradient is 0 up to rounding (a shift of every
        # key's score by one constant a query): the query and value
        # parts are held, the key part against their scale.
        key = slice(1024, 2048)
        rest = torch.cat([want[:1024], want[2048:]]).abs().max()
        readings[f"{label} qkv.bias key"] = (
            (got[key] - want[key]).abs().max() / rest).item()
        got, want = (torch.cat([t[:1024], t[2048:]]) for t in (got, want))
      diff = got - want
      readings[f"{label} {k}"] = ((diff.norm() / want.norm()).item(),
                                  (diff.abs().max() / want.abs().max()).item())
  bad = {k: v for k, v in readings.items()
         if (v > BERT_BF16_LIMIT[1] if isinstance(v, float) else
             v[0] > BERT_BF16_LIMIT[0] or v[1] > BERT_BF16_LIMIT[1])}
  assert not bad, (bad, readings)


@pytest.mark.gpu
@pytest.mark.parametrize("norm", ["group", "batch"])
def test_tiny_resnet_step_on_the_card_matches_the_cpu(cuda, norm):
  """Two AdamW steps of a small ResNet (fp32, NHWC 32 x 32) on the card
  and on the CPU from the same weights: the losses (and, with batch
  norm, the running statistics) agree to the card's fp32 convolutions
  (TF32 off)."""
  from torch.func import functional_call

  from easyparallellibrary_tpu_torch.models.resnet import (
      ResNet, ResNetConfig)
  from easyparallellibrary_tpu_torch.ops.adamw import adamw
  from easyparallellibrary_tpu_torch.parallel import api
  from easyparallellibrary_tpu_torch.weights import (
      init_model_state, init_params)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = ResNetConfig(stage_sizes=(1, 1), num_filters=16, num_classes=10,
                     norm_groups=4, norm=norm, dtype=torch.float32)
  r = np.random.RandomState(0)
  x = r.randn(8, 32, 32, 3).astype(np.float32)
  y = r.randint(0, 10, (8,))
  results = {}
  for dev in (torch.device("cpu"), cuda):
    model = ResNet(cfg)
    state = api.MutableTrainState.create(
        apply_fn=model, params=init_params(cfg, seed=1, device=dev),
        tx=adamw(1e-3, weight_decay=0.01),
        model_state=init_model_state(cfg, device=dev))

    def loss_fn(params, model_state, batch, rng):
      out = functional_call(model, {**params, **model_state},
                            (batch["x"],), {"train": True,
                                            "mutable": True})
      return torch.nn.functional.cross_entropy(out[0], batch["y"]), (
          {}, out[1])

    step = api.make_mutable_train_step(loss_fn)
    batch = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
    losses = []
    for _ in range(2):
      state, m = step(state, batch, None)
      losses.append(m["loss"].item())
    results[dev.type] = (losses, {k: v.cpu() for k, v in
                                  state.model_state.items()})
  assert np.isfinite(results["cuda"][0]).all()
  np.testing.assert_allclose(results["cuda"][0], results["cpu"][0], rtol=1e-4)
  for k, v in results["cpu"][1].items():
    torch.testing.assert_close(results["cuda"][1][k], v, rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------------------ the tooling


def _tool_gpt(device, dtype, attn_impl="pallas_flash"):
  """A small GPT train step (head dim 64, the kernels' wgmma shape) of
  ``bench.build_training`` on ``device``."""
  from easyparallellibrary_tpu_torch import bench
  cfg = bench.bench_config(
      torch.device(device), vocab_size=256, num_layers=2, num_heads=2,
      d_model=128, d_ff=256, max_seq_len=128, dtype=dtype,
      attn_impl=attn_impl, remat=True, remat_policy="dots_flash",
      loss_chunk=64)[0]
  return bench.build_training(cfg, 2, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("attn_impl", ["pallas_flash", "xla"])
def test_compiled_cost_on_the_card_equals_the_cpu_count(cuda, attn_impl):
  """The FLOPs of one train step counted on the card (the flash kernels,
  launched through ctypes, counted by formula) equal the count of the
  same step on the CPU (their plain versions), and the kernels ran."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.profiler.flops import compiled_cost
  counts = {}
  for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
    state, step, batch, rng, _ = _tool_gpt(dev, dtype, attn_impl)
    fa.reset_counts()
    counts[dev] = compiled_cost(step, state, batch, rng)["flops"]
    if dev == "cuda" and attn_impl == "pallas_flash":
      assert fa.flash_fwd_cuda.launches == 2
      assert fa.flash_bwd_dq_cuda.launches == 2
  assert counts["cuda"] == counts["cpu"] > 0


@pytest.mark.gpu
def test_profile_step_on_the_card_leaves_the_state_and_measures(cuda):
  from easyparallellibrary_tpu_torch.profiler.profiler import profile_step
  state, step, batch, rng, _ = _tool_gpt("cuda", torch.bfloat16)
  state, _m = step(state, batch, rng)
  before = {k: v.detach().clone() for k, v in state.params.items()}
  moments = [v.clone() for st in state.opt_state.state.values()
             for v in st.values()]
  first = profile_step(step, state, batch, rng)
  second = profile_step(step, state, batch, rng)
  assert first["cost_flops"] == second["cost_flops"] > 0
  assert first["temp_size_in_bytes"] > 0
  assert first["generated_code_size_in_bytes"] > 0
  for k, v in state.params.items():
    assert torch.equal(v, before[k]), k
  after = [v for st in state.opt_state.state.values() for v in st.values()]
  assert all(torch.equal(a, b) for a, b in zip(after, moments))


@pytest.mark.gpu
def test_perf_gate_passes_on_the_card(cuda):
  """The reference twins on the card against the budget generated on the
  CPU: no violation, the paged twin through K2, every measured peak
  within the CPU card's static bound."""
  from easyparallellibrary_tpu_torch.observability import perfgate
  pa.reset_counts()
  cards = perfgate.collect_cards(device="cuda")
  assert pa.paged_attention_cuda.launches > 0
  assert perfgate.run_gate(cards=cards) == []
  budget = perfgate.load_budget()
  for label, card in cards.items():
    bound = budget["cost_cards"][label]["peak_hbm_bytes"]["max"] / 1.25
    assert card["peak_hbm_bytes"] <= bound, (label, card["peak_hbm_bytes"])


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["params", "all"])
def test_parameter_offload_on_the_card_is_bit_equal(cuda, what):
  """``offload_to_host(state, what)`` on the card: the blocks' parameters
  pinned on the host and streamed around each block's forward and remat
  recompute, the update through the two buffers; three steps bit-equal
  in loss and parameters to the same steps without offload, with less
  memory held between steps."""
  from easyparallellibrary_tpu_torch.runtime.offload import (
      HostOffloadOptimizer, offload_to_host)
  import gc
  runs = []
  for offload in (False, True):
    gc.collect()
    base = torch.cuda.memory_allocated()
    state, step, batch, rng, _ = _tool_gpt("cuda", torch.bfloat16)
    if offload:
      state = offload_to_host(state, what=what, bucket_mb=0.05)
      assert isinstance(state.opt_state, HostOffloadOptimizer)
      assert state.params["block_0.attn.qkv.weight"].is_pinned()
      assert state.params["wte.weight"].is_cuda
    losses = []
    for _ in range(3):
      state, m = step(state, batch, rng)
      losses.append(m["loss"].item())
    torch.cuda.synchronize()
    runs.append((losses, {k: v.detach().cpu() for k, v in
                          state.params.items()},
                 torch.cuda.memory_allocated() - base))
    del state, step
  (plain, pp, plain_mem), (off, op, off_mem) = runs
  assert plain == off
  assert off_mem < plain_mem, (off_mem, plain_mem)
  for k, v in pp.items():
    assert torch.equal(v, op[k]), k


# ------------------------------------------------ K1's tile builds (table)

_BUILD_LIMITS = {torch.bfloat16: FLASH_BF16_LIMIT, torch.float16: FLASH_FP16_LIMIT}


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_flash_library_lists_the_python_builds_and_none_spills(cuda, dtype,
                                                               D):
  """The library's builds of each kernel (``epl_flash_builds``) are
  ``WGMMA_BUILDS``, ``flash_route`` with a length names the build
  ``flash_tile`` resolves, and no build uses local memory (a spill) but
  dK/dV's one build at D = 128, which has spilled since it was written
  (the 168-register cap of a 288-thread CTA)."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  for kernel in ("fwd", "dkv", "dq"):
    builds = fa.flash_builds(kernel, dtype, D)
    assert builds == fa.WGMMA_BUILDS[kernel, D], (kernel, builds)
    for build in builds:
      info = fa.flash_build_info(kernel, dtype, D, *build)
      assert info["registers"] <= 168, (kernel, build, info)
      if (kernel, D) != ("dkv", 128):
        assert info["local_bytes"] == 0, (kernel, build, info)
      assert 0 < info["smem_bytes"] <= 232448, (kernel, build, info)
    assert fa.flash_route(kernel, dtype, D, S=1024) == (
        ("wgmma",) + fa.flash_tile(kernel, 1024, D, dtype))
  assert fa.flash_builds("fwd", torch.float32, D) == (fa.CUDA_CORE_BUILD,)


@pytest.mark.gpu
@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("want", [32, 64, 128])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_flash_tile_builds_match_plain_versions(cuda, dtype, D, want,
                                                stages):
  """Each block-table ``want`` and ring depth takes every kernel to its
  build (``tile_for_want``), counted in ``by_tile``, and the build's
  outputs meet the plain versions' at the existing limits: a ragged
  length, a key length past the query length, causal and not."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  torch.backends.cuda.matmul.allow_tf32 = False
  limits = _BUILD_LIMITS[dtype]
  builds = {k: fa.tile_for_want(k, D, dtype, want, stages)
            for k in ("fwd", "dkv", "dq")}
  for S, Skv in ((200, 200), (128, 192), (384, 384)):
    fa.set_block_want(S, D, 2, want, stages)
    try:
      for causal in (True, False):
        q, k, v, dout = _flash_case(cuda, dtype, 19, 2, 3, S, Skv, D)
        fa.reset_counts()
        out, lse = fa.flash_fwd(q, k, v, causal)
        want_out, want_lse = fa.flash_fwd_reference(q, k, v, causal)
        delta = (dout.float() * want_out.float()).sum(-1)
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal)
        dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal)
        torch.cuda.synchronize()
        assert (fa.flash_fwd_cuda.by_tile, fa.flash_bwd_dkv_cuda.by_tile,
                fa.flash_bwd_dq_cuda.by_tile) == tuple(
                    {builds[k]: 1} for k in ("fwd", "dkv", "dq"))
        _assert_normalized_close(out, want_out, limits["fwd"], "out")
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-6)
        want_dk, want_dv = fa.flash_bwd_dkv_reference(
            q, k, v, dout, want_lse, delta, causal)
        want_dq = fa.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                            causal)
        for name, got, ref in (("dq", dq, want_dq), ("dk", dk, want_dk),
                               ("dv", dv, want_dv)):
          _assert_normalized_close(got, ref, limits["grad"], name)
    finally:
      fa._BLOCK_TABLE.pop((S, D, 2), None)
      fa._BLOCK_STAGES.pop((S, D, 2), None)


@pytest.mark.gpu
def test_flash_unknown_build_raises(cuda):
  """A tile or ring depth a kernel does not have is refused by the
  library (cudaErrorInvalidValue); nothing falls back."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  q, k, v, dout = _flash_case(cuda, torch.bfloat16, 3, 1, 2, 128, 128, 64)
  for build in ((32, 2), (64, 4), (64, 1)):
    with pytest.raises(RuntimeError, match="launch failed"):
      fa.flash_fwd_cuda(q, k, v, True, build=build)
  with pytest.raises(RuntimeError, match="launch failed"):
    fa.flash_fwd_cuda(q.float(), k.float(), v.float(), True, build=(64, 2))
  out, lse = fa.flash_fwd_cuda(q, k, v, True)
  delta = (dout.float() * out.float()).sum(-1)
  with pytest.raises(RuntimeError, match="launch failed"):
    fa.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, True, build=(128, 2))
  q128, k128, v128, do128 = _flash_case(cuda, torch.bfloat16, 3, 1, 2, 128,
                                        128, 128)
  out, lse = fa.flash_fwd_cuda(q128, k128, v128, True)
  with pytest.raises(RuntimeError, match="launch failed"):
    fa.flash_bwd_dq_cuda(q128, k128, v128, do128, lse, lse, True,
                         build=(128, 3))
