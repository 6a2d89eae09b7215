"""Sequence parallelism of the port (``sequence/``: ring attention and
Ulysses over a gloo ``seq`` axis, each rank a slice of the tokens)
against the JAX package on the CPU.

Every ring (flash, dense and einsum blocks; contiguous and zigzag
layouts; causal and not; ``n`` = 2 and 4; finer ``sequence.block_size``
blocking; the einsum fallback of an unblockable slice; the stage
programs' ring) and Ulysses (flash and einsum) computes the attention
of the whole sequence: the ranks' outputs and the gradients of ``sum(out
* dout)`` put together are held against the JAX package's full
attention (``sequence.ulysses._dense_full_attention``) and, for the
einsum ring on four ranks, against its ``ring_attention`` on a ``seq:4``
mesh: output at 1e-5, gradients at 1e-4 by normalized error.  The flash
rings' forward calls (the plain version's, on the CPU) follow the
launch formula the port states.  A GPT with ``attn_impl="ring"`` /
``"ulysses"`` on ``seq:2`` gives the loss and gradients of the JAX GPT
on one device (dense attention, the same numbers).  The einsum MoE's
routing of a batch split over ``data:2,seq:2`` equals JAX's on the
whole batch bit for bit.  Each world size's cases run in one gloo group
of ``utils.launcher.spawn``.
"""

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
from easyparallellibrary_tpu.models import moe as jmoe
from easyparallellibrary_tpu.sequence import ring_attention as jring
from easyparallellibrary_tpu.sequence.ulysses import _dense_full_attention
from easyparallellibrary_tpu_torch.sequence.ring_attention import (
    launches_per_layer)
from easyparallellibrary_tpu_torch.testing import sp_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn
from easyparallellibrary_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

DEADLINE = 300
OUT_TOL, GRAD_LIMIT = 1e-5, 1e-4
SHAPE = (2, 32, 4, 16)                     # B, S, H, D
LONG = (1, 1032, 2, 8)                     # a 516-token slice: no tiling


def _cfg(**over):
  return {"sequence.ring_impl": "flash", "sequence.ring_layout": "zigzag",
          **over}


# name: (n, impl, config, causal, shape, manual, zigzag for the formula)
CASES = {
    "flash_zigzag_n2": (2, "ring", _cfg(), True, SHAPE, False, True),
    "flash_contiguous_n2": (2, "ring", _cfg(**{
        "sequence.ring_layout": "contiguous"}), True, SHAPE, False, False),
    "flash_full_n2": (2, "ring", _cfg(), False, SHAPE, False, False),
    "dense_zigzag_n2": (2, "ring", _cfg(**{"sequence.ring_impl": "dense"}),
                        True, SHAPE, False, None),
    "dense_full_n2": (2, "ring", _cfg(**{"sequence.ring_impl": "dense"}),
                      False, SHAPE, False, None),
    "einsum_n2": (2, "ring", _cfg(**{"sequence.ring_impl": "einsum"}), True,
                  SHAPE, False, None),
    "einsum_finer_n2": (2, "ring", _cfg(**{"sequence.block_size": 8}),
                        True, SHAPE, False, None),
    "unblockable_n2": (2, "ring", _cfg(), True, LONG, False, None),
    "manual_zigzag_n2": (2, "ring", _cfg(), True, SHAPE, True, True),
    "ulysses_flash_n2": (2, "ulysses", {"sequence.ulysses_impl": "flash"},
                         True, SHAPE, False, None),
    "ulysses_einsum_n2": (2, "ulysses", {"sequence.ulysses_impl": "einsum"},
                          False, SHAPE, False, None),
    "flash_zigzag_n4": (4, "ring", _cfg(), True, SHAPE, False, True),
    "flash_contiguous_n4": (4, "ring", _cfg(**{
        "sequence.ring_layout": "contiguous"}), True, SHAPE, False, False),
    "dense_full_n4": (4, "ring", _cfg(**{"sequence.ring_impl": "dense"}),
                      False, SHAPE, False, None),
    "einsum_n4": (4, "ring", _cfg(**{"sequence.ring_impl": "einsum"}), True,
                  SHAPE, False, None),
    "ulysses_flash_n4": (4, "ulysses", {}, True, SHAPE, False, None),
}
GPT_KW = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
              max_seq_len=32)
# name: (config, GPT overrides)
GPT_CASES = {
    "gpt_ring_zigzag": (_cfg(), {"attn_impl": "ring", "seq_parallel": True}),
    "gpt_ring_contiguous": (_cfg(**{"sequence.ring_layout": "contiguous"}),
                            {"attn_impl": "ring"}),
    "gpt_ulysses": ({}, {"attn_impl": "ulysses", "seq_parallel": True}),
}


def _inputs(shape, seed=0):
  r = np.random.RandomState(seed)
  return [r.randn(*shape).astype(np.float32) for _ in range(4)]


def _jax_full(causal, shape):
  """JAX full attention of the inputs and its gradients."""
  q, k, v, dout = (jnp.asarray(a) for a in _inputs(shape))
  out, vjp = jax.vjp(lambda a, b, c: _dense_full_attention(a, b, c, causal),
                     q, k, v)
  return [np.asarray(a) for a in (out,) + vjp(dout)]


def _jax_ring_n4():
  """The JAX einsum ring on a ``seq:4`` mesh."""
  jepl.init(jepl.Config({"sequence.ring_impl": "einsum"}))
  jepl.Env.get().cluster.build_mesh(seq=4)
  q, k, v, dout = (jnp.asarray(a) for a in _inputs(SHAPE))
  out, vjp = jax.vjp(lambda a, b, c: jring(a, b, c, causal=True), q, k, v)
  return [np.asarray(a) for a in (out,) + vjp(dout)]


def _jax_gpt():
  """JAX GPT (dense attention) on one device: parameters, ids, loss and
  gradients in the port's layout."""
  jepl.init()
  model = JaxGPT(JaxGPTConfig(**GPT_KW, dtype=jnp.float32))
  ids = np.random.RandomState(3).randint(0, 64, (2, 33)).astype(np.int32)
  params = model.init(jax.random.PRNGKey(0),
                      jnp.asarray(ids[:, :-1]))["params"]
  (loss, _), grads = jax.value_and_grad(
      lambda p: jgpt.gpt_loss(model, p, {"ids": jnp.asarray(ids)}),
      has_aux=True)(params)

  def port(tree):
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree)),
        device="cpu").items()}

  return {"params": port(params), "ids": ids, "loss": float(loss),
          "grads": port(grads)}


MOE_CAPACITY = 5   # of 32 tokens over 4 experts: drops


def _moe_probs():
  """MoE router probabilities of a ``[4, 8]`` batch over 4 experts."""
  logits = np.random.RandomState(12).randn(4, 8, 4).astype(np.float32)
  return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.fixture(scope="module")
def refs():
  out = {(c, s): _jax_full(c, s) for c, s in
         {(c[3], c[4]) for c in CASES.values()}}
  out["ring_n4"] = _jax_ring_n4()
  out["gpt"] = _jax_gpt()
  return out


def _attention_case(name):
  n, impl, config, causal, shape, manual, _ = CASES[name]
  return ("attention", (f"seq:{n}", config, impl, causal,
                        *_inputs(shape), None, manual))


@pytest.fixture(scope="module")
def ranks(refs):
  """The two-rank cases (attention, the GPTs, the raises) in one group
  and the four-rank ones in another."""
  out = {}
  for n in (2, 4):
    names = [k for k, c in CASES.items() if c[0] == n]
    cases = [_attention_case(k) for k in names]
    if n == 2:
      g = refs["gpt"]
      for name, (config, over) in GPT_CASES.items():
        cases.append(("gpt_grads", ("seq:2", config, dict(GPT_KW, **over),
                                    g["params"], g["ids"])))
      cases.append(("raises", ()))
      names = names + list(GPT_CASES) + ["raises"]
    else:
      for k in (1, 2):
        cases.append(("dispatch", ("data:2,seq:2", _moe_probs(), k,
                                   MOE_CAPACITY)))
        names = names + [f"moe_routing_top{k}"]
    got = spawn(sp_workers.suite, n, (cases,), timeout_s=DEADLINE)
    out.update({k: [r[i] for r in got] for i, k in enumerate(names)})
  return out


def _rel(got, want):
  return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                1e-30))


def _whole(ranks, key):
  ranks = sorted(ranks, key=lambda r: r["coords"]["seq"])
  return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("name", list(CASES))
def test_attention_matches_jax(name, refs, ranks):
  """The ranks' token slices put together: output at 1e-5 and dq, dk,
  dv at 1e-4 against JAX."""
  _, _, _, causal, shape, _, _ = CASES[name]
  want = refs["ring_n4"] if name == "einsum_n4" else refs[(causal, shape)]
  got = [_whole(ranks[name], k) for k in ("out", "dq", "dk", "dv")]
  np.testing.assert_allclose(got[0], want[0], atol=OUT_TOL, rtol=0)
  for g, w, key in zip(got[1:], want[1:], ("dq", "dk", "dv")):
    assert _rel(g, w) < GRAD_LIMIT, key


@pytest.mark.parametrize("name", [k for k, c in CASES.items()
                                  if c[6] is not None])
def test_flash_ring_launch_formula(name, ranks):
  """Flash forward launches a layer on rank i: contiguous causal i + 1
  (the fully masked blocks skipped), not causal n, zigzag 2n + 1
  half-blocks (a non-causal ring falls back to the contiguous layout)."""
  n, _, _, causal, _, _, zigzag = CASES[name]
  for r in ranks[name]:
    i = r["coords"]["seq"]
    assert r["fwd_calls"] == launches_per_layer(n, i, causal, zigzag)


def test_fallbacks_take_no_flash_call(ranks):
  """An unblockable slice and finer ``block_size`` blocking run the
  einsum ring; dense blocks never call the flash kernels."""
  for name in ("unblockable_n2", "einsum_finer_n2", "dense_zigzag_n2"):
    assert all(r["fwd_calls"] == 0 for r in ranks[name]), name


def test_sequence_raises_name_the_fault(ranks):
  """The JAX guards: Ulysses needs heads divisible by the seq axis, the
  einsum ring cannot run in a stage program, ring blocks must divide
  the sequence, and the smap engine refuses both at build."""
  r = ranks["raises"][0]
  assert "divisible by the seq axis" in r["ulysses_heads"]
  assert "seq-manual region" in r["ring_manual_einsum"]
  assert "not divisible by 3 ring blocks" in r["ring_blocks"]
  assert "divisible by the seq axis" in r["smap_ulysses"]
  assert "ring_impl='einsum'" in r["smap_einsum_ring"]


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_routing_over_data_and_seq_equals_jax(top_k, ranks):
  """The einsum MoE's routing of a batch split over ``data:2,seq:2``
  (each rank 2 rows of 4 tokens) as one group, in the global order
  (data rank, row, seq rank, token): the ranks' masks put together are
  JAX's on the whole batch bit for bit, drops included."""
  probs = _moe_probs()
  want = [np.asarray(a) for a in jmoe._top_k_dispatch(
      jnp.asarray(probs.reshape(32, 4)), top_k, 4, MOE_CAPACITY,
      jnp.float32)]
  got = sp_workers.whole_masks(ranks[f"moe_routing_top{top_k}"])
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.reshape(w.shape), w)
  assert want[0].sum() < top_k * 32


@pytest.mark.quick
@pytest.mark.parametrize("name", list(GPT_CASES))
def test_gpt_sequence_parallel_matches_jax(name, refs, ranks):
  """GPT on ``seq:2`` (each rank 16 of the 32 tokens, the next-token
  shift taken over the whole sequence): the loss at 1e-5 relative and
  every gradient, averaged over the seq axis, at 1e-4 against the JAX
  GPT on one device."""
  want = refs["gpt"]
  for r in ranks[name]:
    np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
    for leaf, g in r["grads"].items():
      assert _rel(g, want["grads"][leaf]) < GRAD_LIMIT, leaf
