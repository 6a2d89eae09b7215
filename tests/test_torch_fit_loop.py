"""The port's ``fit`` against the JAX package's.

The same tiny GPT (the JAX package's own initialised parameters, bridged
with ``weights.from_jax_params``), the same token records read back by
each package's ``RecordReader``: the loss trajectory of ``fit`` follows
JAX ``fit`` at rtol 2e-5 (the tolerance of the 10-step pin), through a
checkpoint and a resume; a resumed or SIGTERM-preempted run is bit-equal
to the port's uninterrupted one; the data-factory contract (epochs,
``start_step``), ``evaluate`` / ``train_and_evaluate`` and the JSONL
registry's keys match the JAX loop's.
"""

import functools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import easyparallellibrary_tpu as jepl
import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu.io import dataloader as jio
from easyparallellibrary_tpu.models import gpt as jgpt
from easyparallellibrary_tpu.parallel import api as japi
from easyparallellibrary_tpu.runtime import loop as jloop
from easyparallellibrary_tpu.runtime import trainer as jtrainer
from easyparallellibrary_tpu_torch.io import dataloader as tio
from easyparallellibrary_tpu_torch.models import gpt as tgpt
from easyparallellibrary_tpu_torch.ops import adamw as tadamw
from easyparallellibrary_tpu_torch.parallel import api as tapi
from easyparallellibrary_tpu_torch.runtime import loop as tloop
from easyparallellibrary_tpu_torch.runtime import saver as tsaver
from easyparallellibrary_tpu_torch.runtime import trainer as ttrainer
from easyparallellibrary_tpu_torch.utils import prng
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=16)
BATCH = 4


@pytest.fixture(autouse=True)
def _reset_port_env():
  yield
  tepl.Env.get().reset()


@functools.lru_cache(maxsize=None)
def _params0():
  model = jgpt.GPT(jgpt.GPTConfig(**TINY, dtype=jnp.float32))
  params = model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, TINY["max_seq_len"]), jnp.int32))
  return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params["params"]))


def _ids(n, seed=0):
  r = np.random.RandomState(seed)
  return [r.randint(0, TINY["vocab_size"], (BATCH, TINY["max_seq_len"] + 1))
          for _ in range(n)]


def _write(tmp_path, n_records=16, seed=7):
  """Token records (int32, seq + 1 each) in two files, written by the JAX
  package's writer."""
  r = np.random.RandomState(seed)
  files = []
  for i in range(2):
    path = str(tmp_path / f"tok_{i}.rec")
    jio.write_records(path, [r.randint(0, TINY["vocab_size"],
                                       TINY["max_seq_len"] + 1)
                             .astype(np.int32).tobytes()
                             for _ in range(n_records // 2)],
                      use_native=False)
    files.append(path)
  return files, n_records


def _factory(reader_cls, files, n_records, calls=None, **kw):
  def data(start_step=0):
    if calls is not None:
      calls.append(start_step)
    reader = reader_cls(files, skip_records=(start_step * BATCH) % n_records,
                        **kw)
    rows = []
    for rec in reader:
      rows.append(np.frombuffer(rec, np.int32))
      if len(rows) == BATCH:
        yield {"ids": np.stack(rows)}
        rows = []
  return data


def _jax(config=None):
  jepl.init(config, devices=jax.devices()[:1])
  with jepl.replicate(1):
    model = jgpt.GPT(jgpt.GPTConfig(**TINY, dtype=jnp.float32))
  mesh = jepl.current_plan().build_mesh()
  tx = optax.adamw(1e-2, weight_decay=0.01)
  params0 = _params0()
  state, sh = japi.create_sharded_train_state(
      lambda: jtrainer.create_train_state(model.apply, params0, tx), mesh)
  step = japi.parallelize(jtrainer.build_train_step(
      lambda p, b, r: jgpt.gpt_loss(model, p, b, r)), mesh, sh)
  return model, state, step


def _port(config=None):
  tepl.init(config, device="cpu")
  with tepl.replicate(1):
    model = tgpt.GPT(tgpt.GPTConfig(**TINY, dtype=torch.float32))
  mesh = tepl.current_plan().build_mesh()
  tx = tadamw.adamw(1e-2, weight_decay=0.01)
  state, sh = tapi.create_sharded_train_state(
      lambda: ttrainer.create_train_state(
          model, from_jax_params(_params0(), device="cpu"), tx), mesh)
  step = tapi.parallelize(ttrainer.build_train_step(
      lambda p, b, r: tgpt.gpt_loss(model, p, b, r)), mesh, sh)
  return model, state, step


def _recording(step, losses):
  def run(state, batch, rng):
    state, metrics = step(state, batch, rng)
    losses.append(float(metrics["loss"]))
    return state, metrics
  return run


def _snap(state):
  out = {}
  for name, p in state.params.items():
    st = state.opt_state.state.get(p, {})
    out[name] = [p.detach().clone()] + [st[k].clone() for k in sorted(st)]
  return out


def _assert_same(a, b):
  assert a.keys() == b.keys()
  for name in a:
    assert len(a[name]) == len(b[name]), name
    for x, y in zip(a[name], b[name]):
      assert torch.equal(x, y), name


# ------------------------------------------------- against JAX fit ----


def test_fit_trajectory_matches_jax_over_the_same_records(tmp_path):
  """Six steps over 16 records in batches of 4 (an epoch restart after
  step 4), each package reading the JAX-written records with its own
  reader, the port's native one included."""
  files, n = _write(tmp_path)
  _, jstate, jstep = _jax()
  want = []
  jstate, _ = jloop.fit(_recording(jstep, want), jstate,
                        _factory(jio.RecordReader, files, n,
                                 use_native=False), num_steps=6,
                        log_every=0)
  got = []
  _, tstate, tstep = _port()
  tstate, metrics = tloop.fit(_recording(tstep, got), tstate,
                              _factory(tio.RecordReader, files, n,
                                       use_native=True),
                              num_steps=6, log_every=0, device="cpu")
  assert int(tstate.step) == int(jstate.step) == 6
  np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.quick
def test_fit_checkpoint_and_resume_match_jax_fit(tmp_path):
  """The slice's pin: the port's fit checkpoints at step 3, a fresh
  state resumes from that checkpoint to step 6, and the six losses follow
  the JAX package's uninterrupted 6-step fit at rtol 2e-5."""
  files, n = _write(tmp_path)
  _, jstate, jstep = _jax()
  want = []
  jloop.fit(_recording(jstep, want), jstate,
            _factory(jio.RecordReader, files, n, use_native=False),
            num_steps=6, log_every=0)
  ckpt = str(tmp_path / "ck")
  got, calls = [], []
  data = _factory(tio.RecordReader, files, n, calls, use_native=False)
  _, tstate, tstep = _port()
  tloop.fit(_recording(tstep, got), tstate, data, num_steps=3,
            checkpoint_dir=ckpt, checkpoint_every=3, log_every=0,
            device="cpu")
  assert tsaver.latest_step(ckpt) == 3
  _, fresh, fstep = _port()
  fresh, _ = tloop.fit(_recording(fstep, got), fresh, data, num_steps=6,
                       checkpoint_dir=ckpt, checkpoint_every=3, log_every=0,
                       device="cpu")
  assert int(fresh.step) == 6 and calls[:2] == [0, 3]
  np.testing.assert_allclose(got, want, rtol=2e-5)


def test_registry_jsonl_keys_match_jax(tmp_path):
  """With a checkpoint dir and no writer, both loops log every step to
  ``<dir>/metrics.jsonl`` under the namespaced schema; the keys agree
  line by line, the sentinel's included."""
  cfg = {"resilience": {"sentinel": True}}
  batches = [{"ids": b} for b in _ids(3)]
  _, jstate, jstep = _jax(jepl.Config(cfg))
  jloop.fit(jstep, jstate, batches, num_steps=3, log_every=0,
            checkpoint_dir=str(tmp_path / "j"))
  _, tstate, tstep = _port(tepl.Config(cfg))
  tloop.fit(tstep, tstate, batches, num_steps=3, log_every=0,
            checkpoint_dir=str(tmp_path / "t"), device="cpu")
  lines = {}
  for side in ("j", "t"):
    with open(tmp_path / side / "metrics.jsonl") as f:
      lines[side] = [json.loads(line) for line in f]
  assert len(lines["t"]) == len(lines["j"]) == 3
  for a, b in zip(lines["t"], lines["j"]):
    assert sorted(a) == sorted(b)
    np.testing.assert_allclose(a["train/loss"], b["train/loss"], rtol=2e-5)
    assert a["resilience/bad_steps"] == b["resilience/bad_steps"] == 0


# ------------------------------------------------ resume exactness ----


def test_resume_is_bit_exact_against_the_uninterrupted_run(tmp_path):
  batches = [{"ids": b} for b in _ids(6, seed=1)]
  _, st, step = _port()
  st, _ = tloop.fit(step, st, batches, num_steps=6, log_every=0,
                    device="cpu")
  straight = _snap(st)
  ckpt = str(tmp_path / "ck")

  def data(start_step=0):
    return batches[start_step:]

  _, st1, step1 = _port()
  tloop.fit(step1, st1, data, num_steps=3, checkpoint_dir=ckpt,
            checkpoint_every=3, log_every=0, device="cpu")
  _, st2, step2 = _port()
  st2, _ = tloop.fit(step2, st2, data, num_steps=6, checkpoint_dir=ckpt,
                     log_every=0, device="cpu")
  assert int(st2.step) == 6
  _assert_same(_snap(st2), straight)


def test_preemption_roundtrip_bit_exact(tmp_path):
  """SIGTERM mid-fit -> checkpoint -> resume: the final params, moments
  and per-parameter steps are bit-equal to the uninterrupted run."""
  batches = [{"ids": b} for b in _ids(6, seed=2)]
  _, st, step = _port()
  st, _ = tloop.fit(step, st, batches, num_steps=6, log_every=0,
                    device="cpu")
  uninterrupted = _snap(st)

  class PreemptingStream:
    def __init__(self):
      self.calls = []

    def __call__(self, start_step=0):
      self.calls.append(start_step)

      def gen():
        for i, b in enumerate(batches[start_step:]):
          if start_step == 0 and i == 3:
            os.kill(os.getpid(), signal.SIGTERM)
          yield b
      return gen()

  ckpt = str(tmp_path / "ck")
  stream = PreemptingStream()
  _, st2, step2 = _port()
  with pytest.raises(SystemExit):
    tloop.fit(step2, st2, stream, num_steps=6, checkpoint_dir=ckpt,
              log_every=0, device="cpu")
  saved = tsaver.latest_step(ckpt)
  assert saved is not None and 3 <= saved <= 5
  _, st3, step3 = _port()
  st3, _ = tloop.fit(step3, st3, stream, num_steps=6, checkpoint_dir=ckpt,
                     log_every=0, device="cpu")
  assert int(st3.step) == 6
  assert stream.calls[-1] == saved
  _assert_same(_snap(st3), uninterrupted)


def test_step_rng_is_the_key_folded_with_the_step_index(tmp_path):
  """The key each step receives is ``rng`` folded with the step index,
  on a resumed run as on an uninterrupted one (so a resumed run draws
  the dropout masks of the original)."""
  batches = [{"ids": b} for b in _ids(4)]
  seen = []

  def spy(step):
    def run(state, batch, rng):
      seen.append(np.asarray(rng).tolist())
      return step(state, batch, rng)
    return run

  key = prng.prng_key(5)
  ckpt = str(tmp_path / "ck")
  _, st, step = _port()
  tloop.fit(spy(step), st, lambda start_step=0: batches[start_step:],
            num_steps=2, rng=key, checkpoint_dir=ckpt, checkpoint_every=2,
            log_every=0, device="cpu")
  _, st2, step2 = _port()
  tloop.fit(spy(step2), st2, lambda start_step=0: batches[start_step:],
            num_steps=4, rng=key, checkpoint_dir=ckpt, log_every=0,
            device="cpu")
  assert seen == [prng.host_fold_in(key, i).tolist() for i in range(4)]


# ------------------------------------------- the data-factory contract --


def test_fit_iterator_factory_multi_epoch():
  _, st, step = _port()
  batch = {"ids": _ids(1)[0]}
  calls = {"n": 0}

  def factory():
    calls["n"] += 1
    return iter([batch, batch])

  st, _ = tloop.fit(step, st, factory, num_steps=5, log_every=0,
                    device="cpu")
  assert int(st.step) == 5 and calls["n"] >= 3


def test_fit_exhausted_iterator_raises_clear_error():
  _, st, step = _port()
  batch = {"ids": _ids(1)[0]}
  with pytest.raises(RuntimeError, match="exhausted"):
    tloop.fit(step, st, iter([batch, batch]), num_steps=5, log_every=0,
              device="cpu")


def test_fit_resume_passes_start_step_to_data_factory(tmp_path):
  """As the JAX loop: the first iterator at step 0, epoch restarts at
  0; a resumed fit hands the factory the restored step first."""
  batch = {"ids": _ids(1)[0]}
  ckpt = str(tmp_path / "ck")
  calls = []

  def factory(start_step=0):
    calls.append(start_step)
    return [batch, batch]

  _, st, step = _port()
  tloop.fit(step, st, factory, num_steps=5, checkpoint_dir=ckpt,
            checkpoint_every=5, log_every=0, device="cpu")
  assert calls == [0, 0, 0]
  calls.clear()
  _, st2, step2 = _port()
  st2, _ = tloop.fit(step2, st2, factory, num_steps=7, checkpoint_dir=ckpt,
                     log_every=0, device="cpu")
  assert calls[0] == 5 and all(c == 0 for c in calls[1:])
  assert int(st2.step) == 7


def test_fit_plain_factory_still_works():
  _, st, step = _port()
  batch = {"ids": _ids(1)[0]}
  st, _ = tloop.fit(step, st, lambda: [batch], num_steps=3, log_every=0,
                    device="cpu")
  assert int(st.step) == 3


def test_evaluate_and_train_and_evaluate_match_jax():
  batch = {"ids": _ids(1, seed=4)[0]}
  jmodel, jstate, jstep = _jax()

  def jeval(state, b, rng):
    loss, _ = jgpt.gpt_loss(jmodel, state.params, b)
    return {"loss": loss}

  jm0 = jloop.evaluate(jeval, jstate, [batch, batch])
  jstate, jmetrics = jloop.train_and_evaluate(
      jstep, jeval, jstate, [batch], [batch], num_steps=6, eval_every=3,
      log_every=0)
  tmodel, tstate, tstep = _port()

  def teval(state, b, rng):
    with torch.no_grad():
      loss, _ = tgpt.gpt_loss(tmodel, state.params,
                              {"ids": torch.as_tensor(b["ids"])})
    return {"loss": loss}

  tm0 = tloop.evaluate(teval, tstate, [batch, batch])
  tstate, tmetrics = tloop.train_and_evaluate(
      tstep, teval, tstate, [batch], [batch], num_steps=6, eval_every=3,
      log_every=0, device="cpu")
  assert int(tstate.step) == 6 and "eval_loss" in tmetrics
  np.testing.assert_allclose(tm0["loss"], jm0["loss"], rtol=1e-6)
  np.testing.assert_allclose(tmetrics["eval_loss"], jmetrics["eval_loss"],
                             rtol=2e-5)
  assert tmetrics["eval_loss"] < tm0["loss"]


def test_fit_feeds_metrics_writer(tmp_path):
  from easyparallellibrary_tpu_torch.utils.metrics_writer import (
      MetricsWriter)
  _, st, step = _port()
  path = str(tmp_path / "m.jsonl")
  with MetricsWriter(path) as w:
    tloop.fit(step, st, [{"ids": b} for b in _ids(3)], num_steps=3,
              log_every=0, metrics_writer=w, device="cpu")
  lines = [json.loads(line) for line in open(path)]
  assert [line["step"] for line in lines] == [1, 2, 3]
  assert all(np.isfinite(line["loss"]) for line in lines)


def test_keyboard_interrupt_saves_final_checkpoint(tmp_path):
  _, st, step = _port()
  batch = {"ids": _ids(1)[0]}
  ckpt = str(tmp_path / "ck")

  class InterruptAt:
    def __init__(self, n):
      self.n, self.i = n, 0

    def __iter__(self):
      return self

    def __next__(self):
      self.i += 1
      if self.i > self.n:
        raise KeyboardInterrupt
      return batch

  with pytest.raises(KeyboardInterrupt):
    tloop.fit(step, st, InterruptAt(3), num_steps=10, checkpoint_dir=ckpt,
              log_every=0, device="cpu")
  assert tsaver.latest_step(ckpt) == 3


def test_sigterm_handler_restored_after_step_exception(tmp_path):
  _, st, _ = _port()
  mine = lambda *a: None  # noqa: E731
  prev = signal.signal(signal.SIGTERM, mine)
  try:
    def boom(state, b, rng):
      raise ValueError("step exploded")

    with pytest.raises(ValueError):
      tloop.fit(boom, st, [{"ids": _ids(1)[0]}], num_steps=3, log_every=0,
                checkpoint_dir=str(tmp_path / "never"), device="cpu")
    assert signal.getsignal(signal.SIGTERM) is mine
  finally:
    signal.signal(signal.SIGTERM, prev)


def test_fit_refuses_a_state_off_the_device_it_was_asked_for():
  _, st, step = _port()
  with pytest.raises(ValueError, match="lives on"):
    tloop.fit(step, st, [{"ids": _ids(1)[0]}], num_steps=1, log_every=0,
              device="meta")


def test_chip_smoke_phase_18_rehearses_on_the_cpu():
  """``chip_smoke.py``'s phase 18 (fit from native records with
  checkpoints, resume, the sentinel and rollback, accumulation, grouped
  apply, dropout, serving from the checkpoint) end to end on the CPU at
  a tiny width, with every check it makes on the card that does not
  need one."""
  import chip_smoke
  from easyparallellibrary_tpu_torch import bench
  from easyparallellibrary_tpu_torch.kernels import flash_attention as fa
  from easyparallellibrary_tpu_torch.kernels import paged_attention as pa
  launches, paged = chip_smoke.training_runtime(
      torch, fa, pa, bench, device="cpu",
      widths=dict(vocab_size=128, num_layers=2, num_heads=2, d_model=32,
                  d_ff=64, max_seq_len=128),
      batch_size=4, records=64)
  assert launches == {"fwd": 0, "dkv": 0, "dq": 0} and paged == 0


def test_traced_fit_exports_the_jax_span_set_and_a_cost_card(tmp_path):
  """With observability and the device introspector on, both loops
  export ``<checkpoint_dir>/trace.json`` with the same span names (the
  ``train/*`` phases, the checkpoint's stage / commit / restore), the
  port's adding the phases inside its train step (forward, backward,
  optimizer), and the port captures a ``train/fit_step`` cost card, its
  in-place update verified."""
  from easyparallellibrary_tpu.observability import device as jdevice
  from easyparallellibrary_tpu.observability import trace as jtrace
  from easyparallellibrary_tpu_torch.observability import device as tdevice
  from easyparallellibrary_tpu_torch.observability import trace as ttrace
  cfg = {"observability": {"enabled": True, "sample_rate": 1.0,
                           "device": {"enabled": True}}}
  batches = [{"ids": b} for b in _ids(3)]
  names = {}
  try:
    _, jstate, jstep = _jax(jepl.Config(cfg))
    jloop.fit(jstep, jstate, batches, num_steps=3, log_every=0,
              checkpoint_dir=str(tmp_path / "j"), checkpoint_every=2)
    _, tstate, tstep = _port(tepl.Config(cfg))
    tloop.fit(tstep, tstate, batches, num_steps=3, log_every=0,
              checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2,
              device="cpu")
    card = tdevice.get_introspector().card("train/fit_step")
    for side in ("j", "t"):
      with open(tmp_path / side / "trace.json") as f:
        events = json.load(f)["traceEvents"]
      names[side] = {e["name"] for e in events if e.get("ph") == "B"}
  finally:
    jtrace.reset()
    jdevice.reset()
    ttrace.reset()
    tdevice.reset()
  inner = {"train/forward", "train/backward", "train/optimizer"}
  assert names["t"] - inner == names["j"] and inner <= names["t"]
  assert {"train/data_next", "train/step_dispatch", "checkpoint/stage",
          "checkpoint/commit", "checkpoint/restore"} <= names["t"]
  assert card is not None and card.donation_verified
  assert card.argument_bytes > 0
