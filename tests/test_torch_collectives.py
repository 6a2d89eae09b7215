"""The port's collectives (``communicators/``) on two gloo ranks against
the JAX package's on a two-device CPU mesh (the ops of
``tests/test_collectives.py``): the same per-rank blocks in, SUM of
integer-valued floats exact, everything else within rtol 1e-6.  The
fusion plan's buckets are shape arithmetic and must equal JAX's leaf for
leaf.  One group of two ranks serves every op (a module fixture)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from easyparallellibrary_tpu.communicators import collectives as JC
from easyparallellibrary_tpu.communicators import fusion as jfusion
from easyparallellibrary_tpu.communicators import overlap as joverlap
from easyparallellibrary_tpu.ops import distributed_ops as jdops
from easyparallellibrary_tpu.parallel import metrics as jmetrics
from easyparallellibrary_tpu_torch.communicators import fusion as tfusion
from easyparallellibrary_tpu_torch.testing import tp_workers
from easyparallellibrary_tpu_torch.utils.launcher import spawn

torch.set_num_threads(1)
WORLD = 2
X = np.arange(4 * 6, dtype=np.float32).reshape(4, 6) + 1.0
TREE = {"w": np.random.RandomState(0).randn(4, 3).astype(np.float32),
        "b": np.arange(6.0, dtype=np.float32)}
W = np.arange(6 * 3, dtype=np.float32).reshape(6, 3) / 7


@functools.lru_cache(maxsize=None)
def _port():
  return spawn(tp_workers.collectives_suite, WORLD, (X, TREE),
               timeout_s=120)


def _jax(body, x=X, out_spec=P("data")):
  mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
  f = jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                    out_specs=out_spec, check_vma=False)
  out = np.asarray(f(jnp.asarray(x)))
  return np.split(out, WORLD, axis=0)


def _grad(fn, ranked=True, scale=1.0):
  def body(v):
    def total(t):
      y = fn(t)
      coeff = jnp.arange(y.size, dtype=y.dtype).reshape(y.shape)
      if ranked:
        coeff = coeff + jax.lax.axis_index("data")
      return jnp.sum(y * coeff)
    return jax.grad(total)(v) * scale
  return body


JAX_OPS = {
    "all_reduce_sum": lambda v: JC.all_reduce(v, "data"),
    "all_reduce_max": lambda v: JC.all_reduce(v, "data", op="max"),
    "all_reduce_min": lambda v: JC.all_reduce(v, "data", op="min"),
    "all_reduce_mean": lambda v: JC.all_reduce(v, "data", op="mean"),
    "all_reduce_prod": lambda v: JC.all_reduce(v, "data", op="prod"),
    "all_gather": lambda v: JC.all_gather(v, "data")[None],
    "all_gather_untiled": lambda v: JC.all_gather(v, "data",
                                                  tiled=False)[None],
    "reduce_scatter": lambda v: JC.reduce_scatter(JC.all_gather(v, "data"),
                                                  "data"),
    "broadcast": lambda v: JC.broadcast(v, "data", root=1),
    "reduce": lambda v: JC.reduce(v, "data", root=1),
    "ring_shift": lambda v: JC.ring_shift(v, "data", 1),
    "ppermute": lambda v: JC.ppermute(v, "data", [(0, 1)]),
    "all_to_all": lambda v: JC.all_to_all(v, "data", split_axis=1,
                                          concat_axis=0)[None],
    "all_gather_matmul_ring": lambda v: joverlap.all_gather_matmul(
        v, jnp.asarray(W), "data", num_chunks=WORLD)[None],
    "all_gather_matmul_fused": lambda v: joverlap.all_gather_matmul(
        v, jnp.asarray(W), "data")[None],
    "matmul_reduce_scatter_ring": lambda v: joverlap.matmul_reduce_scatter(
        v, jnp.asarray(W), "data", num_chunks=WORLD),
    "matmul_reduce_scatter_fused": lambda v: joverlap.matmul_reduce_scatter(
        v, jnp.asarray(W), "data"),
    "reduce_scatter_ring": lambda v: joverlap.reduce_scatter(
        v, "data", num_chunks=WORLD),
    # JAX differentiates a shard_map body as the sum of the ranks'
    # objectives, so a psum's backward is a psum; the port's SUM
    # all-reduce has the identity backward of the replicated-loss
    # convention (its TP layers rely on it): with the same cotangent on
    # every rank, JAX's gradient is WORLD times the port's.
    "gather_matmul": lambda v: jdops.gather_matmul(
        v, jnp.asarray(W), "data", num_chunks=WORLD)[None],
    "matmul_scatter": lambda v: jdops.matmul_scatter(
        v, jnp.asarray(W), "data", num_chunks=WORLD),
    "merge_mean": lambda v: jmetrics.merge_shard_metrics(
        {"m": v.sum(1)}, "mean")["m"],
    "merge_sum": lambda v: jmetrics.merge_shard_metrics(
        {"m": v.sum(1)}, "sum")["m"],
    "merge_concat": lambda v: jmetrics.merge_shard_metrics(
        {"m": v.sum(1)}, "concat")["m"][None],
    "grad_all_reduce": _grad(lambda t: JC.all_reduce(t, "data"),
                             ranked=False, scale=1.0 / WORLD),
    "grad_all_gather": _grad(lambda t: JC.all_gather(t, "data")),
    "grad_reduce_scatter": _grad(lambda t: JC.reduce_scatter(t, "data")),
    "grad_ring_shift": _grad(lambda t: JC.ring_shift(t, "data", 1)),
}
EXACT = {"all_reduce_sum", "reduce_scatter", "reduce", "broadcast",
         "ring_shift", "ppermute", "all_gather", "all_gather_untiled",
         "all_to_all", "all_reduce_max", "all_reduce_min"}


@pytest.mark.parametrize("op", sorted(JAX_OPS))
def test_collective_equals_jax(op):
  want = _jax(JAX_OPS[op])
  got = _port()
  for r in range(WORLD):
    g = got[r][op]
    w = np.asarray(want[r]).reshape(g.shape)
    if op in EXACT:
      np.testing.assert_array_equal(g, w, err_msg=f"rank {r}")
    else:
      np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("variant", ["fused", "tiny_buckets", "bf16_wire"])
def test_batch_all_reduce_equals_jax(variant):
  kw = {"fused": {}, "tiny_buckets": dict(fusion_threshold_mb=0,
                                          max_splits=2),
        "bf16_wire": dict(compress_dtype="bf16", compress_scale=4.0)}[variant]
  mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
  spec = {"w": P("data"), "b": P("data")}
  f = jax.shard_map(lambda t: jfusion.batch_all_reduce(t, "data", **kw),
                    mesh=mesh, in_specs=(spec,), out_specs=spec,
                    check_vma=False)
  want = f({k: jnp.asarray(v) for k, v in TREE.items()})
  got = _port()
  for r in range(WORLD):
    for k in TREE:
      g = got[r][f"batch_all_reduce_{variant}_{k}"]
      w = np.split(np.asarray(want[k]), WORLD)[r]
      np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f"{k} rank {r}")


def _plans(tree_np, **kw):
  jplan = jfusion.build_fusion_plan(
      {k: jnp.asarray(v) for k, v in tree_np.items()}, **kw)
  tplan = tfusion.build_fusion_plan(
      {k: torch.from_numpy(v) for k, v in tree_np.items()}, **kw)
  return jplan, tplan


@pytest.mark.parametrize("kw", [dict(), dict(fusion_threshold_mb=1),
                                dict(fusion_threshold_mb=1, max_splits=3),
                                dict(fusion_threshold_mb=0, max_splits=2)],
                         ids=["default", "1mb", "1mb_3splits", "0mb_2"])
def test_fusion_plan_buckets_equal_jax(kw):
  mb = 1024 * 1024 // 4
  tree = {"a": np.zeros((mb,), np.float32), "b": np.ones((3, 4), np.float32),
          "c": np.arange(6, dtype=np.int32).reshape(2, 3),
          "d": np.zeros((mb, 2), np.float32), "e": np.zeros((0,), np.float32),
          "f": np.ones((), np.float32),
          "g": np.zeros((mb // 2,), np.float16),
          "h": np.zeros((mb,), np.float32)}
  jplan, tplan = _plans(tree, **kw)
  assert tplan.buckets == jplan.buckets
  bufs = tplan.flatten({k: torch.from_numpy(v) for k, v in tree.items()})
  back = tplan.unflatten(bufs, tree)
  for k, v in tree.items():
    np.testing.assert_array_equal(back[k].numpy(), v)
