"""K3, the LayerNorm op ``epl_torch::layer_norm``: its plain path against
flax's formula written out as autograd sees it, its registrations, its
dispatch and its place in the remat policies; and, on the card, its
kernels against the plain version.

Tests marked ``gpu`` skip themselves where no CUDA device is present.
This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_layer_norm.py
"""

import numpy as np
import pytest
import torch

import easyparallellibrary_tpu_torch as tepl
from easyparallellibrary_tpu_torch.kernels import layer_norm as ln
from easyparallellibrary_tpu_torch.ops.layers import LayerNorm

# Small shapes: one intra-op thread leaves the cores to the suite's other
# worker processes.
torch.set_num_threads(1)

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
EPS = 1e-6


def _flax_formula(x, weight, bias, eps, dtype):
  """flax's LayerNorm as the port's module computed it op by op."""
  xf = x.to(torch.promote_types(x.dtype, torch.float32))
  mean = xf.mean(-1, keepdim=True)
  mean2 = (xf * xf).mean(-1, keepdim=True)
  var = torch.clamp(mean2 - mean * mean, min=0.0)
  mul = torch.rsqrt(var + eps) * weight
  y = (xf - mean) * mul + bias
  return y.to(dtype)


def _draw(shape, dtype, device="cpu", seed=0, constant_rows=()):
  """x of ``shape`` in ``dtype`` (mean 0.5, not centred, so the fast
  variance cancels), fp32 weight and bias, from a numpy seed.  The rows
  listed hold one value each, a multiple of 1/8: their fp32 sums of x
  and x^2 are exact in any order, so their variance is 0 on every path
  and rstd is rsqrt(eps) (a value with more bits would leave a variance
  of rounding noise near eps, on which rstd depends)."""
  r = np.random.RandomState(seed)
  x = (0.5 + r.randn(*shape)).astype(np.float32)
  flat = x.reshape(-1, shape[-1])
  for i in constant_rows:
    flat[i] = np.round(flat[i, 0] * 8) / 8
  d = shape[-1]
  w = (1.0 + 0.5 * r.randn(d)).astype(np.float32)
  b = (0.5 * r.randn(d)).astype(np.float32)
  return (torch.from_numpy(x).to(device, dtype),
          torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))


def _module(d, weight, bias):
  m = LayerNorm(d, device="meta").to_empty(device=weight.device)
  with torch.no_grad():
    m.weight.copy_(weight)
    m.bias.copy_(bias)
  return m


@pytest.fixture(autouse=True)
def _counts():
  ln.reset_counts()
  yield
  tepl.Env.get().reset()


# ------------------------------------------------------------------ CPU --


@pytest.mark.parametrize("in_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
def test_plain_path_is_the_formula_bit_for_bit(in_dtype, out_dtype):
  x, w, b = _draw((3, 7, 48), in_dtype, constant_rows=(4,))
  got = _module(48, w, b)(x, out_dtype)
  assert got.dtype == out_dtype
  assert torch.equal(got, _flax_formula(x, w, b, EPS, out_dtype))


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float16)], ids=str)
def test_opcheck(in_dtype, out_dtype):
  """The schema, the fake registration and the autograd registration, as
  ``torch.library.opcheck`` tests them."""
  x, w, b = _draw((5, 24), in_dtype)
  x.requires_grad_()
  w.requires_grad_()
  b.requires_grad_()
  torch.library.opcheck(ln._layer_norm_op, (x, w, b, EPS, out_dtype))


def test_dispatcher_sends_cpu_tensors_to_the_plain_versions():
  x, w, b = _draw((4, 32), torch.bfloat16)
  x.requires_grad_()
  y = ln.layer_norm(x, w.requires_grad_(), b.requires_grad_())
  assert ln.layer_norm_reference.calls == 1
  y.float().sum().backward()
  assert ln.layer_norm_bwd_reference.calls == 1
  assert ln.layer_norm_fwd_cuda.launches == 0
  assert ln.layer_norm_bwd_cuda.launches == 0
  meta = torch.empty(2, 32, device="meta")
  assert ln.layer_norm(meta, w, b).shape == (2, 32)
  assert ln.layer_norm_reference.calls == 1


def test_cuda_wrappers_refuse_cpu_tensors():
  x, w, b = _draw((4, 32), torch.float32)
  with pytest.raises(ValueError, match="needs CUDA tensors"):
    ln.layer_norm_fwd_cuda(x, w, b, EPS, torch.float32)
  with pytest.raises(ValueError, match="needs CUDA tensors"):
    ln.layer_norm_bwd_cuda(x, w, x, EPS)


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float32), (torch.float32, torch.bfloat16)],
    ids=str)
def test_module_gradients_are_autograd_of_the_formula(in_dtype, out_dtype):
  """The op's backward on the CPU gives the gradients autograd takes of
  the formula, bit for bit, a constant row (the variance clipped at 0)
  among them."""
  x, w, b = _draw((2, 5, 40), in_dtype, seed=3, constant_rows=(0, 7))
  dy = torch.from_numpy(np.random.RandomState(4).randn(2, 5, 40).astype(
      np.float32)).to(out_dtype)
  m = _module(40, w, b)
  xa = x.clone().requires_grad_()
  m(xa, out_dtype).backward(dy)
  xb, wb, bb = (t.clone().requires_grad_() for t in (x, w, b))
  _flax_formula(xb, wb, bb, EPS, out_dtype).backward(dy)
  assert torch.equal(xa.grad, xb.grad)
  assert torch.equal(m.weight.grad, wb.grad)
  assert torch.equal(m.bias.grad, bb.grad)


def _kernel_bwd(x, w, dy, eps):
  """The kernels' backward arithmetic (csrc/layer_norm.cu): dx =
  r (g - mean(g) - [E[x^2] - mean^2 >= 0] xm r^2 mean(g xm)), dgamma =
  sum of dy xm r, dbeta = sum of dy, with g = dy w and xm = x - mean."""
  mean = x.mean(-1, keepdim=True)
  raw_var = (x * x).mean(-1, keepdim=True) - mean * mean
  r = torch.rsqrt(raw_var.clamp(min=0.0) + eps)
  xm = x - mean
  g = dy * w
  c2 = torch.where(raw_var >= 0, r * r * (g * xm).mean(-1, keepdim=True),
                   torch.zeros_like(r))
  dx = r * (g - g.mean(-1, keepdim=True) - xm * c2)
  return dx, (dy * xm * r).sum(0), dy.sum(0)


@pytest.mark.parametrize("d", [8, 48, 1000])
def test_kernel_backward_arithmetic_is_the_formulas_gradient(d):
  """The closed form the backward kernel computes equals autograd of the
  formula, in float64 (where the two differ only by rounding), on rows
  that vary and on constant rows."""
  x, w, b = _draw((9, d), torch.float64, seed=d, constant_rows=(2, 5))
  w = w.double()
  dy = torch.from_numpy(np.random.RandomState(d + 1).randn(9, d))
  got = _kernel_bwd(x, w, dy, EPS)
  xa, wa, ba = (t.clone().requires_grad_() for t in (x, w, b.double()))
  want = torch.autograd.grad(_flax_formula(xa, wa, ba, EPS, torch.float64),
                             (xa, wa, ba), dy)
  for name, g, h in zip(("dx", "dgamma", "dbeta"), got, want):
    torch.testing.assert_close(g, h, rtol=1e-9, atol=1e-9,
                               msg=lambda m: f"{name}: {m}")


def _gpt_step_counts(device, policy, dtype):
  """One forward and backward of a 2-layer GPT under ``policy`` (None:
  no remat): the module's counts afterwards."""
  from easyparallellibrary_tpu_torch.models import gpt as tgpt
  from easyparallellibrary_tpu_torch.weights import init_params
  remat = dict(remat=True, remat_policy=policy) if policy else {}
  cfg = tgpt.GPTConfig(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
                       d_ff=64, max_seq_len=16, dtype=dtype, **remat)
  tepl.init(device=device)
  params = {k: v.requires_grad_() for k, v in
            init_params(cfg, 0, device=device).items()}
  ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 17)))
  ln.reset_counts()
  loss, _ = tgpt.gpt_loss(tgpt.GPT(cfg), params, {"ids": ids.to(device)})
  loss.backward()
  return dict(fwd_plain=ln.layer_norm_reference.calls,
              bwd_plain=ln.layer_norm_bwd_reference.calls,
              fwd_kernel=ln.layer_norm_fwd_cuda.launches,
              bwd_kernel=ln.layer_norm_bwd_cuda.launches)


# Two LayerNorms a block and ln_f; the recompute of a remat block re-runs
# its two, once each, under either policy.
REMAT_CALLS = {None: (2 * 2 + 1, 2 * 2 + 1),
               "dots_flash": (2 * 2 * 2 + 1, 2 * 2 + 1),
               "nothing": (2 * 2 * 2 + 1, 2 * 2 + 1)}


@pytest.mark.parametrize("policy", list(REMAT_CALLS), ids=str)
def test_remat_recomputes_each_layer_norm_once(policy):
  counts = _gpt_step_counts("cpu", policy, torch.float32)
  fwd, bwd = REMAT_CALLS[policy]
  assert counts == dict(fwd_plain=fwd, bwd_plain=bwd, fwd_kernel=0,
                        bwd_kernel=0)


# ----------------------------------------------------------------- card --


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
  return torch.device("cuda")


# The kernels and the plain version sum the statistics and the gradient
# terms in other orders, in fp32 both: before the final rounding the two
# differ by a few fp32 ulps of the row's scale.  So an output in a 16-bit
# type may land one ulp of that type apart (rtol: bf16 2^-7, fp16 2^-10,
# each one ulp at the bottom of a binade), and an fp32 output by the fp32
# error of a 4096-wide sum (rtol 2e-5).  atol covers the values near 0,
# where the fp32 error of the row's scale (~1-5 here) exceeds one ulp of
# the value: 4e-5 (fp32, 16-bit outputs alike).  dgamma and dbeta are fp32
# sums over the rows in other orders (up to 2051 rows here): rtol 1e-4,
# atol 1e-4 of the largest element.
ULP = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}
ATOL = 4e-5


def _card_case(cuda, rows, d, in_dtype, out_dtype, seed, constant_rows=()):
  x, w, b = _draw((rows, d), in_dtype, cuda, seed, constant_rows)
  dy = torch.from_numpy(np.random.RandomState(seed + 1).randn(
      rows, d).astype(np.float32)).to(cuda, out_dtype)
  return x, w, b, dy


def _assert_matches_plain(x, w, b, dy, out_dtype):
  y = ln.layer_norm_fwd_cuda(x, w, b, EPS, out_dtype)
  dx, dw, db = ln.layer_norm_bwd_cuda(x, w, dy, EPS)
  torch.cuda.synchronize()
  want_y = ln.layer_norm_reference(x, w, b, EPS, out_dtype)
  want_dx, want_dw, want_db = ln.layer_norm_bwd_reference(x, w, b, dy, EPS)
  torch.testing.assert_close(y.float(), want_y.float(),
                             rtol=ULP[out_dtype], atol=ATOL)
  torch.testing.assert_close(dx.float(), want_dx.float(),
                             rtol=ULP[x.dtype], atol=ATOL)
  for got, want in ((dw, want_dw), (db, want_db)):
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
  return dw


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 768, 1000, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("in_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
def test_kernels_match_the_plain_version(cuda, d, in_dtype, out_dtype):
  """y, dx, dgamma and dbeta at each width, every type pair, over a row
  count that fills no whole number of CTAs or persistent walks.  The
  widths take every team shape: a warp a row, four rows a CTA (up to
  1024); two warps a row, two rows a CTA (2048); one row of 4 or 8 warps
  a CTA (4096, 8192)."""
  launches = ln.layer_norm_fwd_cuda.launches, ln.layer_norm_bwd_cuda.launches
  _assert_matches_plain(*_card_case(cuda, 2051, d, in_dtype, out_dtype, d),
                        out_dtype)
  assert (ln.layer_norm_fwd_cuda.launches,
          ln.layer_norm_bwd_cuda.launches) == (launches[0] + 1,
                                               launches[1] + 1)


def _off_grid(t):
  """``t``'s values in a buffer that starts one element past a 16-byte
  boundary."""
  flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
  flat[1:] = t.reshape(-1)
  return flat[1:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [24, 36, 1000])
def test_kernels_take_widths_and_pointers_off_the_16_byte_grid(cuda, d):
  """The element-by-element path: a width that is no multiple of 8, and
  rows starting one element past a 16-byte boundary."""
  x, w, b, dy = _card_case(cuda, 97, d, torch.bfloat16, torch.bfloat16, d)
  x, dy = _off_grid(x), _off_grid(dy)
  assert x.data_ptr() % 16 and dy.data_ptr() % 16
  _assert_matches_plain(x, w, b, dy, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernels_on_constant_rows(cuda, dtype):
  """A constant row's mean is its value, so y is beta exactly, and dx is
  rstd (g - mean(g)), as the plain version's autograd gives it."""
  x, w, b, dy = _card_case(cuda, 300, 1024, dtype, dtype, 5,
                           constant_rows=range(0, 300, 3))
  y = ln.layer_norm_fwd_cuda(x, w, b, EPS, torch.float32)
  assert torch.equal(y[::3], b.expand(100, -1))
  _assert_matches_plain(x, w, b, dy, dtype)


@pytest.mark.gpu
def test_dgamma_is_the_same_bits_on_every_run(cuda):
  x, w, b, dy = _card_case(cuda, 65536 // 8, 1024, torch.bfloat16,
                           torch.bfloat16, 11)
  first = ln.layer_norm_bwd_cuda(x, w, dy, EPS)
  for _ in range(3):
    again = ln.layer_norm_bwd_cuda(x, w, dy, EPS)
    for a, b_ in zip(first, again):
      assert torch.equal(a, b_)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
  x, w, b, dy = _card_case(cuda, 4, 32, torch.float32, torch.float32, 0)
  with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
    ln.layer_norm_fwd_cuda(x.double(), w, b, EPS, torch.float32)
  with pytest.raises(ValueError, match="weight and bias must be float32"):
    ln.layer_norm_fwd_cuda(x, w.half(), b, EPS, torch.float32)
  with pytest.raises(ValueError, match="width"):
    wide = torch.zeros(2, ln.MAX_WIDTH + 8, device=cuda)
    ln.layer_norm_fwd_cuda(wide, torch.zeros(ln.MAX_WIDTH + 8, device=cuda),
                           torch.zeros(ln.MAX_WIDTH + 8, device=cuda), EPS,
                           torch.float32)
  with pytest.raises(ValueError, match="contiguous"):
    ln.layer_norm_bwd_cuda(x, w, dy.t().contiguous().t(), EPS)
  empty = ln.layer_norm(torch.empty(0, 32, device=cuda), w, b)
  assert empty.shape == (0, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", list(REMAT_CALLS), ids=str)
def test_remat_recompute_launches_k3_once_per_layer_norm(cuda, policy):
  counts = _gpt_step_counts(cuda, policy, torch.bfloat16)
  fwd, bwd = REMAT_CALLS[policy]
  assert counts == dict(fwd_plain=0, bwd_plain=0, fwd_kernel=fwd,
                        bwd_kernel=bwd)
