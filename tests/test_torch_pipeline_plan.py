"""The pipeline's host-side pieces of the port against the JAX package's
on the same inputs: the schedule policies, stage partitioning, the auto
stage planner, the stage layout, the bubble fraction, the interleaved
schedule tables, and the port's own action tables (replayed as the
executor replays them); and ``weights.shard_params`` / ``unshard_params``
on the stacked pipelined tree.  No process group, no model run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
from easyparallellibrary_tpu.models import GPT as JaxGPT
from easyparallellibrary_tpu.models import GPTConfig as JaxGPTConfig
from easyparallellibrary_tpu.models import gpt as jgpt
from easyparallellibrary_tpu.parallel import partitioner as jpart
from easyparallellibrary_tpu.parallel import pipeline as jpipe
from easyparallellibrary_tpu.parallel import planner as jplanner
from easyparallellibrary_tpu.parallel.pipeline_interleaved import (
    build_interleaved_schedule as jax_interleaved)
from easyparallellibrary_tpu.strategies import scheduler as jsched
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch import weights
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.parallel import partitioner as tpart
from easyparallellibrary_tpu_torch.parallel import pipeline as tpipe
from easyparallellibrary_tpu_torch.parallel import planner as tplanner
from easyparallellibrary_tpu_torch.parallel.pipeline_interleaved import (
    build_interleaved_schedule, interleaved_pipe_schedule)
from easyparallellibrary_tpu_torch.parallel.schedule_1f1b import (
    one_f_one_b_schedule)
from easyparallellibrary_tpu_torch.strategies import scheduler as tsched

NAMES = [f"block_{i}" for i in range(7)]
MIXED = ["embed", "h/0/attn", "h/0/mlp", "h/1/attn", "h/1/mlp", "h/2/attn",
         "h/2/mlp", "head"]


@pytest.mark.parametrize("name", ["PreferForward", "PreferBackward",
                                  "PreferBackwardOptimizer"])
def test_get_scheduler_matches_jax(name):
  got, want = tsched.get_scheduler(name), jsched.get_scheduler(name)
  assert (got.name, got.remat_stage, got.grouped_apply) == (
      want.name, want.remat_stage, want.grouped_apply)


def test_get_scheduler_rejects_unknown_names_as_jax():
  for mod in (tsched, jsched):
    with pytest.raises(ValueError, match="Unknown pipeline schedule"):
      mod.get_scheduler("Bogus")


@pytest.mark.parametrize("names", [NAMES, MIXED, ["a1b2", "a3b4", "c"]])
def test_find_repeated_blocks_matches_jax(names):
  assert tpart.find_repeated_blocks(names) == jpart.find_repeated_blocks(
      names)


@pytest.mark.parametrize("weights_,stages", [
    (None, 3), ({"block_0": 5.0, "block_6": 3.0}, 2),
    ({f"block_{i}": float(i + 1) for i in range(7)}, 4), (None, 7)])
def test_partition_stages_matches_jax(weights_, stages):
  assert tpart.partition_stages(NAMES, stages, weights_) == \
      jpart.partition_stages(NAMES, stages, weights_)


@pytest.mark.parametrize("policy", ["balance_param", "repeated_layers",
                                    "balance_flops"])
@pytest.mark.parametrize("names", [NAMES, MIXED])
def test_auto_stage_generator_search_matches_jax(policy, names):
  jepl.init()
  tepl.init(device="cpu")
  params = {n: 10.0 + 3 * i for i, n in enumerate(names)}
  flops = {n: float((i * 7) % 5 + 1) for i, n in enumerate(names)}
  for stages in (2, 3):
    got = tplanner.AutoStageGenerator(policy, stages).search(
        names, params, flops)
    want = jplanner.AutoStageGenerator(policy, stages).search(
        names, params, flops)
    assert got == want


def test_auto_stage_generator_from_params_matches_jax():
  jepl.init()
  tepl.init(device="cpu")
  r = np.random.RandomState(0)
  shapes = {f"block_{i}": [(4, 4 * (i % 3 + 1)), (4 * (i % 3 + 1),)]
            for i in range(6)}
  jtrees = {n: {f"w{j}": r.randn(*s) for j, s in enumerate(ss)}
            for n, ss in shapes.items()}
  ttrees = {n: {k: torch.from_numpy(v) for k, v in t.items()}
            for n, t in jtrees.items()}
  for stages in (2, 3, 4):
    assert tplanner.AutoStageGenerator(num_stages=stages).search_from_params(
        ttrees) == jplanner.AutoStageGenerator(
            num_stages=stages).search_from_params(jtrees)


def test_auto_stage_generator_from_cost_model_matches_jax():
  """Blocks that are one matrix product each: the port's FLOP counter
  and XLA's cost analysis both count 2 M K N, so the plans agree."""
  jepl.init()
  tepl.init(device="cpu")
  widths = [8, 32, 8, 64, 16, 8]
  x = np.ones((4, 8), np.float32)
  jfns = {f"block_{i}": (lambda w: lambda a: a @ jnp.ones((8, w)))(w)
          for i, w in enumerate(widths)}
  tfns = {f"block_{i}": (lambda w: lambda a: a @ torch.ones(8, w))(w)
          for i, w in enumerate(widths)}
  for stages in (2, 3):
    got = tplanner.AutoStageGenerator(num_stages=stages).search_from_cost_model(
        tfns, torch.from_numpy(x))
    want = jplanner.AutoStageGenerator(
        num_stages=stages).search_from_cost_model(jfns, jnp.asarray(x))
    assert got == want


@pytest.mark.parametrize("L,chunks,plan", [
    (4, 2, None), (5, 2, None), (7, 3, None), (24, 4, None), (6, 4, None),
    (5, 2, (2, 3)), (6, 3, (2, 2, 2))])
def test_stage_layout_matches_jax(L, chunks, plan):
  assert tgpt.stage_layout(L, chunks, plan) == jgpt.stage_layout(L, chunks,
                                                                 plan)


def test_stage_layout_rejects_bad_plans_as_jax():
  for fn in (tgpt.stage_layout, jgpt.stage_layout):
    with pytest.raises(ValueError, match="stage_plan"):
      fn(5, 2, (1, 1))


@pytest.mark.parametrize("S,M", [(2, 4), (4, 6), (2, 1), (8, 32)])
def test_bubble_fraction_matches_jax(S, M):
  assert tpipe.bubble_fraction(S, M) == jpipe.bubble_fraction(S, M)


GRID = [(2, 2, 4), (4, 2, 8), (4, 4, 8), (3, 2, 6), (2, 3, 6), (8, 2, 8),
        (2, 2, 3)]


@pytest.mark.parametrize("S,K,M", GRID)
def test_interleaved_schedule_tables_equal_jax(S, K, M):
  """Every table of the interleaved schedule equals the JAX builder's
  (so its ramp ``MK + 2(S-1) + (K-1)S`` where S divides M, and its
  buffer-replay and no-collision properties, pinned by the JAX tests,
  hold)."""
  got, want = build_interleaved_schedule(S, K, M), jax_interleaved(S, K, M)
  for field in ("S", "K", "M", "T", "W", "busy_slots", "total_slots"):
    assert getattr(got, field) == getattr(want, field), field
  for field in ("f_valid", "f_chunk", "f_mb", "b_valid", "b_chunk", "b_mb",
                "rf_valid", "rf_chunk", "rf_slot", "rb_valid", "rb_chunk",
                "rb_slot", "emit_valid", "emit_mb", "feed_mb", "fb_mb"):
    np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                  err_msg=field)
  if M % S == 0:     # whole groups of S micro-batches: the JAX formula
    assert got.T == M * K + 2 * (S - 1) + (K - 1) * S


def _replay(sched):
  """Replay ``sched`` as the executor does (hops arrive the next tick,
  the emit's cotangent the same tick): every stage input and cotangent
  is there when read, every (virtual stage, micro-batch) runs once each
  way, nothing is left; returns each rank's peak of kept stage inputs."""
  S, K, M = sched.S, sched.K, sched.M
  V = S * K
  ready_f, ready_b = set(), set()
  done_f, done_b = set(), set()
  kept = [set() for _ in range(S)]
  peak = [0] * S
  for tick in sched.ticks:
    arrive_f, arrive_b = set(), set()
    if tick.feed is not None:
      ready_f.add((0, tick.feed))
    for d in range(S):
      op = tick.fwd[d]
      if op is None:
        continue
      v, m = op[0] * S + d, op[1]
      assert (v, m) in ready_f, ("input missing", v, m)
      assert (v, m) not in done_f
      done_f.add((v, m))
      kept[d].add((v, m))
      peak[d] = max(peak[d], len(kept[d]))
      if v < V - 1:
        arrive_f.add((v + 1, m))
      else:
        assert tick.emit == m
        ready_b.add((v, m))
    for d in range(S):
      op = tick.bwd[d]
      if op is None:
        continue
      v, m = op[0] * S + d, op[1]
      assert (v, m) in ready_b, ("cotangent missing", v, m)
      assert (v, m) not in done_b
      done_b.add((v, m))
      kept[d].discard((v, m))
      if v > 0:
        arrive_b.add((v - 1, m))
      else:
        assert tick.feed_bwd == m
    ready_f |= arrive_f
    ready_b |= arrive_b
  want = {(v, m) for v in range(V) for m in range(M)}
  assert done_f == want and done_b == want
  assert not any(kept)
  return peak


@pytest.mark.parametrize("S,M", [(2, 4), (4, 6), (2, 1), (3, 8)])
def test_gpipe_and_1f1b_tables_replay(S, M):
  """GPipe keeps all M micro-batches' inputs on a stage; 1F1B keeps at
  most ``min(M, 2S - 1)`` (the JAX residual ring's bound), on the JAX
  timeline (forward of m at stage s at tick m + s, backward at
  m + 2(S - 1) - s)."""
  assert max(_replay(tpipe.gpipe_schedule(S, M))) == M
  sched = one_f_one_b_schedule(S, M)
  assert max(_replay(sched)) <= min(M, 2 * S - 1)
  assert len(sched.ticks) == M + 2 * (S - 1)
  for t, tick in enumerate(sched.ticks):
    for s in range(S):
      if tick.fwd[s] is not None:
        assert tick.fwd[s][1] == t - s
      if tick.bwd[s] is not None:
        assert tick.bwd[s][1] == t - 2 * (S - 1) + s


@pytest.mark.parametrize("S,K,M", GRID)
def test_interleaved_and_chained_gpipe_tables_replay(S, K, M):
  _replay(interleaved_pipe_schedule(S, K, M))
  _replay(tpipe.gpipe_schedule(S, M, K))


def test_launch_formula_doubles_forwards_under_stage_remat():
  assert one_f_one_b_schedule(2, 4).launches_per_rank(12) == {
      "fwd": 96, "dkv": 48, "dq": 48}
  assert tpipe.gpipe_schedule(2, 4).launches_per_rank(12) == {
      "fwd": 48, "dkv": 48, "dq": 48}


# ---------------------------------------------- the stacked parameters


TINY = dict(vocab_size=64, num_layers=5, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=16, pipeline_stages=2, num_micro_batch=2)


def _jax_tree(**over):
  jepl.init()
  model = JaxGPT(JaxGPTConfig(**dict(TINY, **over), dtype=jnp.float32))
  params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 4), jnp.int32))
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params["params"]))


@pytest.mark.parametrize("interleave", [1, 2])
def test_from_jax_params_takes_the_stacked_tree(interleave):
  """The JAX pipelined tree bridges to the names and shapes of the
  port's pipelined GPT (stacked kernels transposed on their last two
  dims), and ``init_params`` gives the same names and shapes."""
  tree = _jax_tree(pipeline_interleave=interleave)
  params = weights.from_jax_params(tree, device="cpu")
  tepl.init(device="cpu")
  cfg = tgpt.GPTConfig(**dict(TINY, pipeline_interleave=interleave))
  shapes = {n: tuple(p.shape) for n, p in tgpt.GPT(cfg).named_parameters()}
  assert {n: tuple(t.shape) for n, t in params.items()} == shapes
  assert {n: tuple(t.shape) for n, t in weights.init_params(
      cfg, 0, device="cpu").items()} == shapes
  pre = "pipeline" if interleave == 1 else "pipeline_1"
  jk = tree[pre]["stages"]["stacked"]["block_0"]["mlp"]["wi"]["kernel"]
  np.testing.assert_array_equal(
      params[f"{pre}.stages.stacked.block_0.mlp.wi.weight"].numpy(),
      np.swapaxes(jk, -1, -2))


@pytest.mark.parametrize("stage_vocab,tp", [(False, 1), (True, 1),
                                             (True, 2), (False, 2)])
def test_shard_params_cuts_stage_rows_and_vocab_and_round_trips(
    stage_vocab, tp):
  """Each rank keeps its stage row of every stacked leaf, the smap
  layout its ``[V / (S tp), D]`` vocab rows (stage-major), TP its model
  slice; ``unshard_params`` puts the whole tree back."""
  import dataclasses
  import types
  whole = weights.from_jax_params(_jax_tree(), device="cpu")
  cfg = tgpt.GPTConfig(**TINY)
  if tp > 1:
    cfg = dataclasses.replace(cfg, tensor_parallel=True)
  # What shard_params reads of a model: its cfg and its vocab layout.
  model = types.SimpleNamespace(cfg=cfg, wte=types.SimpleNamespace(
      parallel="stage_vocab" if stage_vocab else "none"))
  grid = [[weights.shard_params(whole, model, rank=r, tp=tp, stage=2,
                                stage_rank=s)
           for r in range(tp)] for s in range(2)]
  name = "pipeline.stages.stacked.block_1.ln2.weight"
  for s in range(2):
    np.testing.assert_array_equal(grid[s][0][name].numpy(),
                                  whole[name][s:s + 1].numpy())
    if stage_vocab:
      rows = 64 // (2 * tp)
      for r in range(tp):
        i = s * tp + r
        np.testing.assert_array_equal(
            grid[s][r]["wte.weight"].numpy(),
            whole["wte.weight"][i * rows:(i + 1) * rows].numpy())
  back = weights.unshard_params(grid, cfg)
  assert sorted(back) == sorted(whole)
  for k in whole:
    np.testing.assert_array_equal(back[k].numpy(), whole[k].numpy(),
                                  err_msg=k)


def test_stack_stages_round_trips_and_runs_the_same_model():
  """A non-pipelined state dict stacked into the pipelined layout (a
  masked slot for 5 layers over 2 stages) gives the same logits on one
  process, and unstacks back to itself."""
  tepl.init(device="cpu")
  flat_cfg = tgpt.GPTConfig(**dict(TINY, pipeline_stages=1),
                            dtype=torch.float32)
  flat = weights.init_params(flat_cfg, 3, device="cpu")
  cfg = tgpt.GPTConfig(**TINY, dtype=torch.float32)
  stacked = weights.stack_stages(flat, cfg)
  ids = torch.from_numpy(np.random.RandomState(1).randint(0, 64, (2, 9)))
  with torch.no_grad():
    a = torch.func.functional_call(tgpt.GPT(flat_cfg), flat, (ids,))
    b = torch.func.functional_call(tgpt.GPT(cfg), stacked, (ids,))
  np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)
  back = weights.unstack_stages(stacked, cfg)
  assert sorted(back) == sorted(flat)
  for k in flat:
    np.testing.assert_array_equal(back[k].numpy(), flat[k].numpy())


def test_auto_parallel_gpt_plans_stages_as_jax():
  """``auto.auto_parallel`` with ``pipeline.num_stages`` 2 plans the
  stages of an uneven model as JAX ``auto_parallel_gpt`` does."""
  conf = {"auto.auto_parallel": True, "pipeline.num_stages": 2,
          "pipeline.num_micro_batch": 4}
  kw = dict(TINY, pipeline_stages=1, num_micro_batch=1, num_layers=7)
  jepl.init(jepl.Config(conf))
  want = jgpt.auto_parallel_gpt(JaxGPTConfig(**kw)).cfg
  tepl.init(tepl.Config(conf), device="cpu")
  got = tgpt.auto_parallel_gpt(tgpt.GPTConfig(**kw)).cfg
  assert (got.pipeline_stages, got.stage_plan, got.num_micro_batch) == (
      want.pipeline_stages, want.stage_plan, want.num_micro_batch)


def test_pipeline_entry_points_no_longer_raise():
  """``GPTConfig(pipeline_stages=2)``, ``Dense(parallel="stage_column")``
  and ``Embedding(parallel="stage_vocab")`` build (the stage mesh is
  held in the CPU pipeline tests)."""
  from easyparallellibrary_tpu_torch.ops.layers import Dense, Embedding
  tepl.init(device="cpu")
  tgpt.GPTConfig(pipeline_stages=2)
  assert Dense(8, 64, parallel="stage_column", device="meta").weight.shape \
      == (64, 8)
  assert Embedding(64, 8, parallel="stage_vocab",
                   device="meta").weight.shape == (64, 8)
