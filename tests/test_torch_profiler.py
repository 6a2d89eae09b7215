"""The port's profilers, evidence writer, planner cost twin and traffic
generators against the JAX package's.

* ``utils/bench_evidence.py``: ``validate_record`` gives JAX's verdicts
  on a corpus (every record of the repo's ``BENCH_EVIDENCE.json``, read
  only, and malformed ones); a log the port writes reads back equal
  through JAX's ``load_records``.
* ``profiler/flops.py``: ``compiled_cost`` of a tiny GPT forward and
  train step counts the same FLOPs with the flash op (its plain version
  on the CPU) and with plain attention, equal to JAX
  ``gpt_flops_per_token`` x tokens, and within 10% of XLA's count
  (XLA also counts the elementwise work: 7.7% of its count here);
  ``collective_op_sizes`` of a row-parallel Dense on two gloo ranks
  against JAX's over the ``shard_map`` twin; ``FlopsProfiler``'s lines.
* ``profiler/profiler.py``: ``profile_step`` leaves the state bit-equal,
  repeats its report, and has JAX's keys less XLA's own.
* ``parallel/planner.py``: ``plan_collective_matmul_from_cost`` decides
  as JAX's on the same local product.
* ``testing/chaos.py``: ``poisson_trace`` / ``overload_burst`` bit-equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu.models import gpt as jgpt
from easyparallellibrary_tpu.profiler import flops as jflops
from easyparallellibrary_tpu.profiler import memory as jmemory
from easyparallellibrary_tpu.profiler import profiler as jprofiler
from easyparallellibrary_tpu.testing import chaos as jchaos
from easyparallellibrary_tpu.utils import bench_evidence as jev
from easyparallellibrary_tpu_torch import bench
from easyparallellibrary_tpu_torch.profiler import flops as tflops
from easyparallellibrary_tpu_torch.profiler import memory as tmemory
from easyparallellibrary_tpu_torch.profiler import profiler as tprofiler
from easyparallellibrary_tpu_torch.testing import chaos as tchaos
from easyparallellibrary_tpu_torch.utils import bench_evidence as tev

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A GPT small enough for a CPU count: 2 layers, d_model 32, 16 tokens.
TINY = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=16)
BATCH = 2
DEADLINE = 120.0


@pytest.fixture(autouse=True)
def _reset_port_env():
  yield
  tepl.Env.get().reset()


# ------------------------------------------------------ bench evidence --


def _corpus():
  with open(os.path.join(REPO, "BENCH_EVIDENCE.json")) as f:
    repo = json.load(f)["records"]
  malformed = [
      None, [], "text", {}, {"metric": "x"},
      {"metric": "", "unix_time": 1.0, "value": 1.0},
      {"metric": 3, "unix_time": 1.0, "value": 1.0},
      {"metric": "x", "unix_time": "now", "value": 1.0},
      {"metric": "x", "unix_time": True, "value": 1.0},
      {"metric": "x", "unix_time": 1.0, "value": True},
      {"metric": "x", "unix_time": 1.0, "value": "1"},
      {"metric": "x", "unix_time": 1.0, "config": [1]},
      {"metric": "x", "unix_time": 1.0, "unit": "s", "device": "gpu"},
      {"metric": "x", "unix_time": 1.0, "value": None},
      {"metric": "x", "unix_time": 1.0, "value": None, "payload": 2},
      {"metric": "x", "unix_time": 2, "value": 0},
  ]
  return repo + malformed


def test_validate_record_gives_jax_verdicts():
  corpus = _corpus()
  assert len(corpus) > 20
  for rec in corpus:
    assert tev.validate_record(rec) == jev.validate_record(rec), rec
  assert any(tev.validate_record(r) for r in corpus)
  assert not any(tev.validate_record(r) for r in corpus[:-16])


def test_append_and_latest_record_read_back_through_jax(tmp_path,
                                                        monkeypatch):
  path = str(tmp_path / "ev.json")
  monkeypatch.setenv("EPL_BENCH_EVIDENCE", path)
  ctx = tev.run_context(device_kind="NVIDIA H100 80GB HBM3",
                        power_limit="700.00 W")
  assert ctx == jev.run_context(device_kind="NVIDIA H100 80GB HBM3",
                                power_limit="700.00 W")
  first = tev.append_record({"metric": "m", "value": 1.0, "unix_time": 5.0,
                             **ctx})
  tev.append_record({"metric": "m", "value": 2.0, "unix_time": 9.0})
  tev.append_record({"metric": "other", "payload": {"a": 1}})
  assert first["provenance"] == "hardware" and "utc" in first
  assert jev.load_records(path) == tev.load_records()
  assert len(jev.load_records(path)) == 3
  assert tev.latest_record("m") == jev.latest_record("m", path)
  assert tev.latest_record("m")["value"] == 2.0
  assert tev.latest_record("absent") is None
  with pytest.raises(ValueError, match="malformed BENCH_EVIDENCE record"):
    tev.append_record({"metric": "", "value": 1.0})
  assert len(tev.load_records()) == 3
  # A log that does not parse is moved aside, never overwritten.
  with open(path, "w") as f:
    f.write("{not json")
  tev.append_record({"metric": "m", "value": 3.0})
  aside = [p for p in os.listdir(tmp_path) if ".corrupt-" in p]
  assert len(aside) == 1
  assert [r["value"] for r in jev.load_records(path)] == [3.0]


# ---------------------------------------------------------- FLOP count --


def _torch_gpt(attn_impl):
  cfg = bench.bench_config(torch.device("cpu"), attn_impl=attn_impl,
                           **TINY)[0]
  return bench.build_training(cfg, BATCH, device="cpu")


def _jax_forward_cost(attn_impl):
  cfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32, attn_impl=attn_impl)
  model = jgpt.GPT(cfg)
  ids = jnp.asarray(np.random.RandomState(0).randint(
      0, TINY["vocab_size"], (BATCH, TINY["max_seq_len"])))
  params = model.init(jax.random.PRNGKey(0), ids)["params"]
  cost = jflops.compiled_cost(lambda p, x: model.apply({"params": p}, x),
                              params, ids)
  return cost, cfg


@pytest.mark.parametrize("attn_impl", ["pallas_flash", "xla"])
def test_compiled_cost_counts_products_the_same_with_flash_and_plain(
    attn_impl):
  """The forward counts JAX's ``gpt_flops_per_token / 3`` x tokens (its
  products), the train step ``gpt_flops_per_token`` x tokens, whichever
  attention ran; against XLA's count of the same forward: at most it,
  and within 10% of it (XLA adds the elementwise work) under plain
  attention, within 1% under the flash kernel."""
  state, step, batch, rng, _ = _torch_gpt(attn_impl)
  model = state.apply_fn
  tokens = BATCH * TINY["max_seq_len"]
  ids = batch["ids"][:, :-1]
  fwd = tflops.compiled_cost(
      lambda p, x: torch.func.functional_call(model, p, (x,)),
      dict(state.params), ids)
  jcost, jcfg = _jax_forward_cost(attn_impl)
  per_token = jgpt.gpt_flops_per_token(jcfg, TINY["max_seq_len"])
  assert fwd["flops"] == pytest.approx(per_token / 3 * tokens, rel=1e-12)
  train = tflops.compiled_cost(step, state, batch, rng)
  assert train["flops"] == pytest.approx(per_token * tokens, rel=1e-12)
  if attn_impl == "xla":
    assert 0.9 * jcost["flops"] <= fwd["flops"] <= jcost["flops"]
  else:
    assert fwd["flops"] == pytest.approx(jcost["flops"], rel=0.01)
  assert set(fwd) == {k for k in jcost
                      if not tflops.is_xla_only_cost_key(k)}
  assert 0 < fwd["bytes accessedout{}"] < fwd["bytes accessed"]
  # No argument moved: the count ran on copies.
  assert state.step == 0 and not state.opt_state.state


def test_kernel_entries_count_by_formula_not_by_their_insides():
  """Each kernel entry books its formula once under a count, and the
  plain version's own products are not added to it."""
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
  r = np.random.RandomState(0)
  B, H, S, D = 1, 2, 8, 16
  q, k, v, dout = (torch.from_numpy(r.randn(B, H, S, D).astype(np.float32))
                   for _ in range(4))
  lse = torch.zeros(B, H, S)
  one = 4 * B * H * S * S * D
  assert tflops.compiled_cost(fa.flash_fwd_reference, q, k, v,
                              True)["flops"] > 0
  assert tflops.compiled_cost(fa.FLASH_FWD_OP, q, k, v, True)["flops"] == one
  assert tflops.compiled_cost(fa.flash_bwd_dq, q, k, v, dout, lse, lse,
                              True)["flops"] == one
  assert tflops.compiled_cost(fa.flash_bwd_dkv, q, k, v, dout, lse, lse,
                              True)["flops"] == one
  T, hd, NB, bs, MB = 3, 16, 5, 4, 2
  qp = torch.from_numpy(r.randn(T, H, hd).astype(np.float32))
  kp, vp = (torch.from_numpy(r.randn(NB, bs, H, hd).astype(np.float32))
            for _ in range(2))
  tables = torch.from_numpy(r.randint(0, NB, (T, MB)).astype(np.int32))
  pos = torch.tensor([0, 3, 7], dtype=torch.int32)
  cost = tflops.compiled_cost(pa.paged_attention, qp, kp, vp, tables, pos)
  assert cost["flops"] == 4 * T * H * MB * bs * hd
  # Outside a count the dispatchers run as before.
  out = pa.paged_attention(qp, kp, vp, tables, pos)
  np.testing.assert_array_equal(
      out.numpy(), pa.paged_attention_reference(qp, kp, vp, tables,
                                                pos).numpy())


@pytest.mark.quick
def test_profile_step_flash_equals_plain_and_leaves_the_state():
  """``profile_step`` of the tiny GPT train step: the same flops with the
  flash op and with plain attention, the caller's parameters bit-equal
  and its optimizer untouched."""
  flops = {}
  for impl in ("pallas_flash", "xla"):
    state, step, batch, rng, _ = _torch_gpt(impl)
    before = {k: v.clone() for k, v in state.params.items()}
    report = tprofiler.profile_step(step, state, batch, rng)
    flops[impl] = report["cost_flops"]
    for k, v in state.params.items():
      assert torch.equal(v, before[k]), k
    assert state.step == 0 and not state.opt_state.state
    tepl.Env.get().reset()
  assert flops["pallas_flash"] == flops["xla"] > 0


def test_profile_step_repeats_leaves_a_stepped_state_and_keeps_jax_keys():
  """Two steps in (moments and step counts live), ``profile_step``
  leaves parameters, moments and step bit-equal and gives the same
  report twice; its keys are JAX ``profile_step``'s less XLA's own."""
  state, step, batch, rng, _ = _torch_gpt("pallas_flash")
  for _ in range(2):
    state, _m = step(state, batch, rng)

  def snap(s):
    out = {f"p/{k}": v.detach().clone() for k, v in s.params.items()}
    for i, st in enumerate(s.opt_state.state.values()):
      for key, v in st.items():
        out[f"o/{i}/{key}"] = v.clone()
    return out

  before = snap(state)
  kw = dict(tokens_per_step=BATCH * TINY["max_seq_len"], num_stages=2,
            num_micro_batch=4)
  first = tprofiler.profile_step(step, state, batch, rng, **kw)
  second = tprofiler.profile_step(step, state, batch, rng, **kw)
  assert first == second
  after = snap(state)
  assert sorted(after) == sorted(before)
  for k in before:
    assert torch.equal(before[k], after[k]), k
  assert state.step == 2
  assert first["pipeline_bubble"] == pytest.approx(1 / 5)
  assert first["total_bytes"] == (first["temp_size_in_bytes"]
                                  + first["argument_size_in_bytes"])
  jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
  jmodel = jgpt.GPT(jcfg)
  ids = jnp.zeros((BATCH, TINY["max_seq_len"]), jnp.int32)
  jparams = jmodel.init(jax.random.PRNGKey(0), ids)["params"]
  want = jprofiler.profile_step(
      lambda p, x: jmodel.apply({"params": p}, x), jparams, ids, **kw)
  assert set(first) == {k for k in want
                        if not tflops.is_xla_only_cost_key(k[5:])}


def test_compiled_memory_has_jax_keys_and_measures_the_run():
  a, b = torch.ones(64, 32), torch.ones(32, 16)
  got = tmemory.compiled_memory(lambda x, y: torch.tanh(x @ y).sum(), a, b)
  want = jmemory.compiled_memory(lambda x, y: jnp.tanh(x @ y).sum(),
                                 jnp.ones((64, 32)), jnp.ones((32, 16)))
  assert set(got) == set(want)
  assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]
  assert got["output_size_in_bytes"] == want["output_size_in_bytes"] == 4
  assert got["temp_size_in_bytes"] >= 64 * 16 * 4
  assert got["generated_code_size_in_bytes"] == 0.0


def test_memory_profiler_without_a_card_records_steps_and_csv(tmp_path):
  prof = tmemory.MemoryProfiler(every_n_steps=2,
                                csv_path=str(tmp_path / "m.csv"))
  recs = [prof.step() for _ in range(4)]
  assert recs[0] is None and recs[1]["step"] == 2
  assert prof.peak_bytes() == 0.0
  prof.dump_csv()
  assert (tmp_path / "m.csv").read_text().startswith("step,time")
  prof.dump_png(str(tmp_path / "m.png"))   # no matplotlib: a no-op


# ---------------------------------------------------------- collectives --


def test_collective_op_sizes_of_a_row_parallel_dense_match_jax():
  """A row-parallel Dense on two gloo ranks hands one all-reduce of its
  [rows, d_out] fp32 output to the backend: the kinds and result bytes
  JAX counts over the ``shard_map`` twin (psum of the local product) on
  a two-device CPU mesh."""
  from jax.sharding import Mesh, PartitionSpec as P

  from easyparallellibrary_tpu.utils.compat import shard_map
  from easyparallellibrary_tpu_torch.testing import tp_workers
  from easyparallellibrary_tpu_torch.utils.launcher import spawn
  rows, d_in, d_out = 8, 16, 6
  ranks = spawn(tp_workers.row_dense_collective_sizes, 2,
                (rows, d_in, d_out), timeout_s=DEADLINE)
  mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
  f = shard_map(lambda x, w: jax.lax.psum(x @ w, "model"), mesh,
                in_specs=(P(None, "model"), P("model", None)),
                out_specs=P(None, None))
  text = jax.jit(f).lower(jnp.ones((rows, d_in)),
                          jnp.ones((d_in, d_out))).as_text()
  want = jflops.collective_op_sizes(text)
  assert want == [("all_reduce", rows * d_out * 4.0)]
  for rank in ranks:
    assert rank["sizes"] == want
    assert rank["bytes"] == sum(b for _k, b in want)


def test_flops_profiler_lines_match_jax(monkeypatch):
  """Measured once, then a line every n steps: JAX's keys (MFU only on
  the card) and values at the same clock, the comm share against
  ``DEFAULT_LINK_BYTES_PER_S``, the registry publish; ``tick`` and
  ``summary`` for ``fit``."""
  from easyparallellibrary_tpu_torch.parallel.planner import (
      DEFAULT_LINK_BYTES_PER_S)
  clock = [0.0]
  monkeypatch.setattr(tflops.time, "perf_counter", lambda: clock[0])
  monkeypatch.setattr(jflops.time, "perf_counter", lambda: clock[0])
  published = []

  class Registry:
    def publish_many(self, step, by_ns):
      published.append((step, by_ns))

  t = tflops.FlopsProfiler(every_n_steps=2, registry=Registry(),
                           link_bytes_per_s=DEFAULT_LINK_BYTES_PER_S)
  j = jflops.FlopsProfiler(every_n_steps=2,
                           link_bytes_per_s=DEFAULT_LINK_BYTES_PER_S)
  a, b = torch.ones(8, 4), torch.ones(4, 3)
  assert t.measure_from(torch.matmul, a, b) == 2 * 8 * 4 * 3
  assert t.comm_bytes_per_step == 0.0
  j.flops_per_step = t.flops_per_step
  for prof in (t, j):
    prof.comm_bytes_per_step = 1e6
    prof.note_bad_step(2)
    prof.note_retry()
  lines = []
  for i in range(5):
    clock[0] = 0.5 * i
    lines.append((t.tick(), j.step()))
  for got, want in lines:
    if want is None:
      assert got is None
      continue
    want = {k: v for k, v in want.items() if k != "mfu"}
    assert got == pytest.approx(want)
  assert lines[-1][0]["comm_share"] == pytest.approx(
      1e6 / DEFAULT_LINK_BYTES_PER_S / 0.5)
  assert t.summary() == lines[-1][0]
  assert [s for s, _ in published] == [3, 5]
  assert published[0][1]["resilience"]["bad_steps"] == 2.0


def test_fit_takes_a_flops_profiler():
  from easyparallellibrary_tpu_torch.runtime.loop import fit
  state, step, batch, rng, _ = _torch_gpt("xla")
  prof = tflops.FlopsProfiler(every_n_steps=2)
  prof.measure_from(step, state, batch, rng)
  assert prof.flops_per_step == pytest.approx(
      jgpt.gpt_flops_per_token(jgpt.GPTConfig(**TINY), 16)
      * BATCH * TINY["max_seq_len"])
  state, _m = fit(step, state, [batch] * 5, num_steps=5, log_every=0,
                  profiler=prof, device="cpu")
  assert prof.summary()["gflops_per_step"] == pytest.approx(
      prof.flops_per_step / 1e9)


# ------------------------------------------------------------- planner --


@pytest.mark.parametrize("kind,axis", [("all_gather_matmul", 4),
                                       ("matmul_reduce_scatter", 2),
                                       ("reduce_scatter", 8)])
def test_plan_collective_matmul_from_cost_decides_as_jax(kind, axis):
  from easyparallellibrary_tpu.parallel import planner as jplanner
  from easyparallellibrary_tpu_torch.parallel import planner as tplanner
  m, k, n_out = 256, 512, 384
  kw = dict(kind=kind, axis_size=axis, k=k, n_out=n_out, peak_flops=989e12,
            link_bytes_per_s=tplanner.DEFAULT_LINK_BYTES_PER_S)
  got = tplanner.plan_collective_matmul_from_cost(
      torch.matmul, torch.ones(m, k), torch.ones(k, n_out), **kw)
  want = jplanner.plan_collective_matmul_from_cost(
      jnp.matmul, jnp.ones((m, k)), jnp.ones((k, n_out)), **kw)
  assert dataclasses.astuple(got) == pytest.approx(
      dataclasses.astuple(want))
  cube = dict(kind=kind, axis_size=axis, peak_flops=989e12,
              link_bytes_per_s=tplanner.DEFAULT_LINK_BYTES_PER_S)
  assert dataclasses.astuple(tplanner.plan_collective_matmul_from_cost(
      torch.matmul, torch.ones(m, k), torch.ones(k, n_out), **cube)) == \
      pytest.approx(dataclasses.astuple(
          jplanner.plan_collective_matmul_from_cost(
              jnp.matmul, jnp.ones((m, k)), jnp.ones((k, n_out)), **cube)))


# ------------------------------------------------------------- traffic --


@pytest.mark.parametrize("seed", [0, 7])
def test_poisson_trace_and_overload_burst_are_bit_equal(seed):
  np.testing.assert_array_equal(tchaos.poisson_trace(3.5, 40, seed=seed),
                                jchaos.poisson_trace(3.5, 40, seed=seed))
  np.testing.assert_array_equal(
      tchaos.poisson_trace(2.0, 9, seed=seed, first_at_zero=False),
      jchaos.poisson_trace(2.0, 9, seed=seed, first_at_zero=False))
  rng_t, rng_j = (np.random.RandomState(seed) for _ in range(2))
  np.testing.assert_array_equal(tchaos.poisson_trace(1.0, 5, rng=rng_t),
                                jchaos.poisson_trace(1.0, 5, rng=rng_j))
  np.testing.assert_array_equal(
      tchaos.overload_burst(4.0, 30, 20, factor=2.5, seed=seed),
      jchaos.overload_burst(4.0, 30, 20, factor=2.5, seed=seed))
  np.testing.assert_array_equal(tchaos.overload_burst(4.0, 5, 0, seed=seed),
                                jchaos.overload_burst(4.0, 5, 0, seed=seed))
  for bad in (dict(factor=1.0), dict(recover_frac=0.0)):
    with pytest.raises(ValueError):
      tchaos.overload_burst(1.0, 2, 2, **bad)
  with pytest.raises(ValueError):
    tchaos.poisson_trace(0.0, 3)
