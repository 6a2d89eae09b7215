"""Plain PyTorch pieces of the references: float32 products (TF32 off),
attention in query blocks, pre-norm blocks checkpointed one at a time,
AdamW, and the three-step training loop that gives the readings the
check compares.  Nothing here imports the port.

``mm(x, w)`` is ``x @ w.T`` for a weight ``[out, in]``; the control
passes :func:`fp8_mm` instead, the same reference with every linear
layer's operands in fp8 (e4m3 forward, e5m2 gradients, one scale a
tensor), the step below the configuration's bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.check import Readings, part_norms, to_host

LN_EPS = 1e-6   # the port's LayerNorm (flax's default)


def fp32_mm(x, w):
  return x @ w.t()


def _quantize(t, dtype):
  """``t`` rounded to ``dtype`` under one scale that maps its largest
  magnitude to the format's largest value, back in float32."""
  amax = t.detach().abs().amax().clamp(min=1e-30)
  scale = torch.finfo(dtype).max / amax
  return (t * scale).to(dtype).to(torch.float32) / scale


class _Fp8Linear(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, w):
    xq = _quantize(x, torch.float8_e4m3fn)
    wq = _quantize(w, torch.float8_e4m3fn)
    ctx.save_for_backward(xq, wq)
    return xq @ wq.t()

  @staticmethod
  def backward(ctx, dy):
    xq, wq = ctx.saved_tensors
    dyq = _quantize(dy, torch.float8_e5m2)
    dw = dyq.reshape(-1, dy.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
    return dyq @ wq, dw


def fp8_mm(x, w):
  return _Fp8Linear.apply(x, w)


PRECISIONS = {"fp32": fp32_mm, "fp8": fp8_mm}


def linear(x, p, prefix: str, mm):
  y = mm(x, p[prefix + ".weight"])
  bias = p.get(prefix + ".bias")
  return y if bias is None else y + bias


def layer_norm(x, p, prefix: str):
  return F.layer_norm(x, (x.shape[-1],), p[prefix + ".weight"],
                      p[prefix + ".bias"], LN_EPS)


def attention(q, k, v, causal: bool, block: int = 1024):
  """Softmax attention over ``[B, H, S, D]``, scale ``D ** -0.5``, in
  query blocks of ``block`` rows (a causal block reads only the keys up
  to its last query)."""
  S = q.shape[2]
  scale = q.shape[-1] ** -0.5
  outs = []
  for s in range(0, S, block):
    e = min(S, s + block)
    kv = e if causal else S
    scores = (q[:, :, s:e] @ k[:, :, :kv].transpose(-1, -2)) * scale
    if causal:
      rows = torch.arange(s, e, device=q.device)[:, None]
      cols = torch.arange(kv, device=q.device)[None]
      scores = scores.masked_fill(cols > rows, float("-inf"))
    outs.append(torch.softmax(scores, dim=-1) @ v[:, :, :kv])
  return torch.cat(outs, dim=2)


@dataclasses.dataclass(frozen=True)
class Names:
  """A pre-norm block's parameter prefixes, relative to the block."""
  ln1: str
  qkv: str
  proj: str
  ln2: str
  wi: str
  wo: str


def block(x, p, prefix: str, names: Names, heads: int, causal: bool, mm):
  """``x + proj(attn(ln1 x))``, then ``x + wo(gelu_tanh(wi(ln2 x)))``;
  QKV is one product whose output splits as ``(3, heads, D / heads)``."""
  B, S, D = x.shape
  qkv = linear(layer_norm(x, p, prefix + names.ln1), p, prefix + names.qkv,
               mm)
  q, k, v = qkv.view(B, S, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
  a = attention(q, k, v, causal).transpose(1, 2).reshape(B, S, D)
  x = x + linear(a, p, prefix + names.proj, mm)
  h = F.gelu(linear(layer_norm(x, p, prefix + names.ln2), p,
                    prefix + names.wi, mm), approximate="tanh")
  return x + linear(h, p, prefix + names.wo, mm)


def blocks(x, p, layers: int, names: Names, heads: int, causal: bool, mm):
  """Every block under its own checkpoint, so that only the blocks'
  inputs stay live through the backward."""
  for i in range(layers):
    x = checkpoint(block, x, p, f"block_{i}.", names, heads, causal, mm,
                   use_reentrant=False)
  return x


def train(loss_sum: Callable, count: Callable, params0: Dict[str, torch.Tensor],
          batches: List[dict], optimizer: dict, rows: int,
          groups: Dict[str, int]) -> Readings:
  """AdamW steps from ``params0``, one a batch: each step's gradient is
  that of ``sum(loss_sum over the batch's row blocks of rows) /
  count(batch)``, accumulated block by block.  Norms are taken by
  ``check.part_norms`` over ``groups``.  TF32 is off while it runs and
  the process's settings are restored after."""
  flags = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    return _train(loss_sum, count, params0, batches, optimizer, rows, groups)
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _train(loss_sum, count, params0, batches, optimizer, rows, groups):
  lr, wd = optimizer["learning_rate"], optimizer["weight_decay"]
  b1, b2, eps = optimizer["b1"], optimizer["b2"], optimizer["eps"]
  p = {n: t.detach().clone().requires_grad_(True) for n, t in params0.items()}
  m = {n: torch.zeros_like(t) for n, t in p.items()}
  v = {n: torch.zeros_like(t) for n, t in p.items()}
  losses, grads = [], {}
  for t, batch in enumerate(batches, start=1):
    den = float(count(batch))
    total = torch.zeros((), device=next(iter(p.values())).device)
    B = next(iter(batch.values())).shape[0]
    for r in range(0, B, rows):
      part = {k: x[r:r + rows] for k, x in batch.items()}
      s = loss_sum(p, part)
      (s / den).backward()
      total += s.detach()
    losses.append(float(total) / den)
    with torch.no_grad():
      if t == 1:
        grads = to_host(part_norms({n: x.grad for n, x in p.items()},
                                   groups))
      for n, x in p.items():
        g = x.grad
        m[n].mul_(b1).add_(g, alpha=1 - b1)
        v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
        x.mul_(1 - lr * wd)
        denom = (v[n] / (1 - b2 ** t)).sqrt_().add_(eps)
        x.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
        x.grad = None
  with torch.no_grad():
    changes = to_host(part_norms({n: x - params0[n] for n, x in p.items()},
                                 groups))
  return Readings(losses, grads, changes)
