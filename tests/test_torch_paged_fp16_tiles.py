"""The slot-tiled paged-attention kernel's fp16 and mixed arithmetic
against the JAX package's reference.

The CUDA kernel (``csrc/paged_attention.cu``, namespace ``tiled``) runs
only on the card, where ``tests/test_torch_gpu.py`` and ``chip_smoke.py``
hold it to the plain version.  Here its arithmetic is emulated on the
CPU and held to JAX ``paged_attention_reference`` over the tiles that
the engine plans for real scheduler steps: per work item (a context
split of a query tile), stages of 64 keys with a running max, p rounded
to the query's fp16 after it, then the splits combined.  Two builds:
fp16 q over fp16 pools, and fp16 q over bf16 pools (amp O1 in fp16 over
a bf16 model config), whose products the kernel takes in tf32 from
widened 16-bit operands; the tf32 tests pin that design's premise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyparallellibrary_tpu.kernels.paged_attention import (
    paged_attention_reference as jax_reference)
from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
from easyparallellibrary_tpu_torch.testing import step_plans

torch.set_num_threads(1)

KEYS = 64                  # keys of one shared-memory stage (csrc: kKeys)
NUM_SLOTS, CHUNK, BS = 6, 64, 16
# The limits the card holds the fp16 and mixed builds to against their
# plain version (chip_smoke.py's PAGED_FP16_LIMIT and PAGED_MIXED_LIMIT):
# ||got - want|| / ||want|| and max|got - want| / max|want|.  Against the
# JAX reference the emulation differs by the same roundings (p after a
# running max, not after the whole softmax; the fp16 reference's scores
# also rounded to fp16), so the same limits hold; p rounded to bf16
# instead of fp16 exceeds them.
LIMIT = dict(rel_l2=1e-3, max_rel=2e-3)
BUILDS = {"fp16": (torch.float16, torch.float16),
          "fp16_bf16": (torch.float16, torch.bfloat16)}
JAX_DTYPES = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}


def emulate_tiled(q, kp, vp, tables, positions, items, p_dtype=None):
  """The tiled kernel's arithmetic for one call: q ``[T, H, hd]`` in
  fp16, the pools in fp16 or bf16 (read exactly into fp32, as the
  kernel's fp16 products and its tf32 products of widened operands take
  them), scores and the online softmax in fp32, p rounded to
  ``p_dtype`` (the query's type; another type emulates a wrong build)
  per 64-key stage before the V product, each split's (m, l, acc), and
  every tile's splits combined.  Returns fp32 ``[T, H, hd]``."""
  p_dtype = q.dtype if p_dtype is None else p_dtype
  T, H, hd = q.shape
  bs, MB = kp.shape[1], tables.shape[1]
  scale = np.float32(1.0 / np.sqrt(hd))
  qf, kf, vf = q.float(), kp.float(), vp.float()
  out = torch.zeros((T, H, hd), dtype=torch.float32)
  parts = {}
  for t0, n, k0, k1, split, splits, _, _ in items.tolist():
    pos = torch.clamp(positions[t0:t0 + n].long(), max=MB * bs - 1)
    ctx = int(pos.max()) + 1
    k1 = ctx if k1 < 0 else min(k1, ctx)
    m = torch.full((n, H), -np.inf)
    l = torch.zeros((n, H))
    acc = torch.zeros((n, H, hd))
    for s0 in range(k0, k1, KEYS):
      j = torch.arange(s0, min(s0 + KEYS, k1))
      blk = tables[t0].long()[j // bs]
      blk = torch.where((blk < 0) | (blk >= kp.shape[0]), 0, blk)
      k, v = kf[blk, j % bs], vf[blk, j % bs]             # [keys, H, hd]
      s = torch.einsum("rhd,khd->rhk", qf[t0:t0 + n], k) * scale
      s = torch.where(j[None, None, :] <= pos[:, None, None], s,
                      torch.tensor(-np.inf))
      m_new = torch.maximum(m, s.amax(-1))
      m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
      corr = torch.exp(m - m_use)
      p = torch.exp(s - m_use[..., None])
      l = l * corr + p.sum(-1)
      acc = acc * corr[..., None] + torch.einsum(
          "rhk,khd->rhd", p.to(p_dtype).float(), v)
      m = m_new
    parts.setdefault(t0, []).append((m, l, acc))
    if split == splits - 1:
      ms = torch.stack([a for a, _, _ in parts[t0]])
      big = ms.amax(0)
      w = torch.exp(ms - torch.where(torch.isinf(big), 0.0, big))
      lsum = (w * torch.stack([b for _, b, _ in parts[t0]])).sum(0)
      o = (w[..., None] * torch.stack([c for _, _, c in parts[t0]])).sum(0)
      out[t0:t0 + n] = o / torch.clamp_min(lsum, 1e-30)[..., None]
  return out


def _normalized_errors(got, want):
  d = (got.double() - want.double())
  return ((d.norm() / want.double().norm()).item(),
          (d.abs().max() / want.double().abs().max()).item())


def _calls(kind, seed, H, hd):
  """The kernel's calls at a real scheduler step (``testing.step_plans``
  at 6 slots, chunk 64, bs 16, k = 4) with the tiles the engine plans
  for it: ``spec_step`` (decode tokens, their draft runs partly filled,
  a prefill chunk, padding), ``warm_prefix_step`` (the chunk starts at
  position 256 over another slot's blocks) or ``rollout_step`` (a draft
  model's four one-token-per-slot calls, one plan from the last call's
  positions, slot 0 crossing position 256).  Returns the inputs in fp32
  and ``[(positions, items)]``, one per call."""
  plan = step_plans.scheduled_step(seed, num_slots=NUM_SLOTS, chunk=CHUNK,
                                   block_size=BS,
                                   warm=kind == "warm_prefix_step")
  MB = plan.block_tables.shape[1]
  if kind == "rollout_step":
    calls = list(step_plans.rollout_positions(plan, 4, cross=256))
    tables = plan.block_tables
    runs = pa.one_row_runs(NUM_SLOTS)
  else:
    calls = [plan.positions]
    tables = plan.block_tables[plan.slot_ids]
    runs = pa.tile_runs_from_plan(plan.base_idx, plan.num_valid,
                                  len(plan.positions), plan.draft_base,
                                  plan.draft_cap)
  items, _ = pa.work_items(runs, calls[-1], MB, BS)
  r = np.random.RandomState(seed)
  NB = NUM_SLOTS * MB + 1
  q, kp, vp = [torch.from_numpy(r.randn(*s).astype(np.float32))
               for s in ((len(tables), H, hd), (NB, BS, H, hd),
                         (NB, BS, H, hd))]
  return (q, kp, vp, torch.from_numpy(np.ascontiguousarray(tables)),
          [(torch.from_numpy(p), items) for p in calls])


def _jax_want(q, kp, vp, tables, positions):
  got = jax_reference(*[jnp.asarray(x.float().numpy()).astype(
      JAX_DTYPES[x.dtype]) for x in (q, kp, vp)],
                      jnp.asarray(tables.numpy()), jnp.asarray(
                          positions.numpy()))
  return torch.from_numpy(np.array(got.astype(jnp.float32)))


@pytest.mark.parametrize("kind,H,hd", [("spec_step", 2, 64),
                                       ("warm_prefix_step", 2, 64),
                                       ("rollout_step", 2, 64),
                                       ("spec_step", 1, 128)])
@pytest.mark.parametrize("build", list(BUILDS))
def test_tiled_fp16_arithmetic_matches_jax_reference(build, kind, H, hd):
  """The emulated fp16 (fp16 out) and mixed (fp32 out) builds over the
  engine's planned tiles, split contexts and 64-key stages included,
  against JAX ``paged_attention_reference`` at the same types, within
  ``LIMIT``; and against the port's plain version (the card's oracle)
  within the same limit."""
  q_dtype, kv_dtype = BUILDS[build]
  q, kp, vp, tables, calls = _calls(kind, 7 + hd, H, hd)
  q, kp, vp = q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype)
  assert any((items[:, 5] > 1).any() for _, items in calls)  # splits
  for positions, items in calls:
    got = emulate_tiled(q, kp, vp, tables, positions, items)
    if build == "fp16":
      got = got.half()                       # the fp16 build's output
    want = _jax_want(q, kp, vp, tables, positions)
    plain = pa.paged_attention(q, kp, vp, tables, positions)
    assert plain.dtype == got.dtype == torch.promote_types(q_dtype,
                                                           kv_dtype)
    for label, ref in (("jax", want), ("plain", plain.float())):
      rel_l2, max_rel = _normalized_errors(got.float(), ref)
      assert rel_l2 <= LIMIT["rel_l2"] and max_rel <= LIMIT["max_rel"], (
          label, rel_l2, max_rel)


@pytest.mark.parametrize("build", list(BUILDS))
def test_p_rounded_to_bf16_exceeds_the_limit(build):
  """The limit is tight enough to see a wrong rounding: the same
  arithmetic with p rounded to bf16 instead of the query's fp16, at a
  draft model's rollout: decode rows over contexts of 200-600 keys,
  where the rounding of many small p weighs most."""
  q_dtype, kv_dtype = BUILDS[build]
  q, kp, vp, tables, calls = _calls("rollout_step", 71, 2, 64)
  q, kp, vp = q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype)
  for positions, items in calls:
    got = emulate_tiled(q, kp, vp, tables, positions, items,
                        p_dtype=torch.bfloat16)
    rel_l2, max_rel = _normalized_errors(
        got, _jax_want(q, kp, vp, tables, positions))
    assert rel_l2 > LIMIT["rel_l2"] or max_rel > LIMIT["max_rel"]


def _tf32(x):
  """fp32 values truncated to tf32 (10 mantissa bits kept), as the
  tensor core reads a tf32 operand register."""
  bits = x.view(torch.int32)
  return (bits & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_every_16bit_value_is_exact_in_tf32(dtype):
  """The mixed build's premise: every finite fp16 and bf16 bit pattern
  (p rounded to fp16 among them), widened to fp32, passes tf32
  truncation unchanged; and the kernel's widening of a bf16 (a 16-bit
  shift) is the exact conversion."""
  bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
  vals = bits.view(dtype)
  finite = torch.isfinite(vals)
  wide = vals[finite].float()
  assert torch.equal(_tf32(wide).view(torch.int32), wide.view(torch.int32))
  if dtype == torch.bfloat16:
    shifted = (bits[finite].to(torch.int32) & 0xFFFF) << 16
    assert torch.equal(shifted, wide.view(torch.int32))


def test_products_of_fp16_and_bf16_values_are_exact_in_fp32():
  """A product of an fp16 and a bf16 value (11 and 8 significant bits)
  needs at most 19 bits, so the tf32 product the kernel accumulates in
  fp32 equals the reference's fp32 product, over every exponent."""
  r = np.random.RandomState(0)
  a = torch.from_numpy(r.randn(1 << 16).astype(np.float32) * np.exp2(
      r.randint(-24, 16, 1 << 16)).astype(np.float32)).half()
  b = torch.from_numpy(r.randn(1 << 16).astype(np.float32) * np.exp2(
      r.randint(-60, 60, 1 << 16)).astype(np.float32)).bfloat16()
  keep = torch.isfinite(a) & torch.isfinite(b)
  a, b = a[keep], b[keep]
  exact = a.double() * b.double()
  prod = _tf32(a.float()) * _tf32(b.float())
  normal = exact.abs() >= 2.0 ** -126       # fp32's normal range
  assert torch.equal(prod[normal].double(), exact[normal])


def test_draft_model_plans_tiles_by_the_engines_question(monkeypatch):
  """Under amp O1 in fp16 over a bf16 model config the query is fp16 and
  the pools bf16, which the tiled build now takes: the draft model's
  paged step must ask ``needs_tiles`` with its compute dtype, as the
  engine does, so that both plan tiles by one rule.  Every call of a
  self-drafting engine's run on the CPU is recorded: the engine's and
  the drafter's all name fp16 over bf16 pools."""
  from easyparallellibrary_tpu_torch import env as env_lib
  from easyparallellibrary_tpu_torch.config import Config
  from easyparallellibrary_tpu_torch.models.gpt import GPT, GPTConfig
  from easyparallellibrary_tpu_torch.serving import (
      ContinuousBatchingEngine, DraftModelDrafter, Request)
  from easyparallellibrary_tpu_torch.weights import init_params
  asked = []
  real = pa.needs_tiles

  def recording(pool, q_dtype=None):
    asked.append((pool.dtype, q_dtype))
    return real(pool, q_dtype)

  monkeypatch.setattr(pa, "needs_tiles", recording)
  env_lib.Env.get().reset(Config({"amp.level": "O1",
                                  "amp.compute_dtype": "fp16"}))
  try:
    cfg = GPTConfig(vocab_size=64, num_layers=2, num_heads=4, d_model=32,
                    d_ff=64, max_seq_len=32, dtype=torch.bfloat16)
    model = GPT(cfg)
    params = init_params(cfg, 0, device="cpu")
    eng = ContinuousBatchingEngine(
        model, params, device="cpu", paged=True, num_slots=2,
        prefill_chunk=8, block_size=4,
        drafter=DraftModelDrafter(model, params, k=3))
    assert eng.compute_dtype == eng.drafter.compute_dtype == torch.float16
    r = np.random.RandomState(0)
    for uid in range(2):
      eng.submit(Request(uid=uid, prompt=r.randint(0, 64, (5,)).astype(
          np.int32), max_new_tokens=6))
    eng.run()
  finally:
    env_lib.Env.get().reset()
  assert eng.drafter.rollout_steps > 0
  assert len(asked) >= 2 * eng.drafter.rollout_steps
  assert set(asked) == {(torch.bfloat16, torch.float16)}, set(asked)
