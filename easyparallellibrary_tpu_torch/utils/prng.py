"""Counter-based random streams for sampling.

The JAX package folds a request's PRNG key with each token index
(``jax.random.fold_in``), so a request's samples do not depend on the
slot or the iteration that serves it.  This module keeps that property
with a stateless integer hash: a key is two 32-bit words, ``fold_in``
hashes a counter into it, and :func:`categorical` draws Gumbel noise
from the hash of ``(key, vocabulary index)``.  Integer arithmetic gives
the same bits on the CPU and the GPU.  The bits differ from JAX's, so
sampled streams differ from the JAX package's; greedy streams do not
sample.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
  """A 32-bit avalanche hash (shift-multiply rounds) of int64 tensors
  holding values in ``[0, 2**32)``; both multipliers are below 2**31, so
  every product fits in int64."""
  x = x ^ (x >> 16)
  x = (x * 0x21F0AAAD) & _M32
  x = x ^ (x >> 15)
  x = (x * 0x735A2D97) & _M32
  return x ^ (x >> 15)


def prng_key(seed: int) -> np.ndarray:
  """The key of ``seed``: uint32 ``[2]``, laid out like
  ``jax.random.PRNGKey`` (high word, low word)."""
  seed = int(seed) & 0xFFFFFFFFFFFFFFFF
  return np.asarray([seed >> 32, seed & _M32], np.uint32)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
  """New keys from ``key [..., 2]`` and integer counters ``data [...]``."""
  key = key.to(torch.int64) & _M32
  data = data.to(torch.int64) & _M32
  k0 = _hash32(key[..., 0] ^ _hash32(data))
  k1 = _hash32(key[..., 1] ^ _hash32((k0 + data) & _M32))
  return torch.stack([k0, k1], dim=-1)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
  """Standard Gumbel noise ``[..., n]`` (fp32), one value per index of
  the last axis, from keys ``[..., 2]``."""
  key = key.to(torch.int64) & _M32
  idx = torch.arange(n, device=key.device, dtype=torch.int64)
  h = _hash32(_hash32(idx ^ key[..., :1]) ^ key[..., 1:])
  u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # (0, 1)
  return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
  """Sample indices from ``softmax(logits)`` along the last axis
  (Gumbel-max), one draw per key."""
  g = gumbel(key, logits.shape[-1])
  return torch.argmax(logits.float() + g, dim=-1)


def uniform(key: torch.Tensor) -> torch.Tensor:
  """One uniform fp32 value in ``[0, 1)`` per key ``[..., 2]``."""
  key = key.to(torch.int64) & _M32
  h = _hash32(key[..., 0] ^ _hash32(key[..., 1]))
  return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def host_fold_in(key, data: int) -> np.ndarray:
  """:func:`fold_in` of one host key (``uint32 [2]``, any array-like)
  with the integer ``data``, computed on the CPU; returns ``uint32
  [2]``.  Keys derived on the host reach the device as plain integers,
  with no copy."""
  k = torch.as_tensor(np.asarray(key).astype(np.int64))
  return fold_in(k, torch.tensor(int(data))).numpy().astype(np.uint32)


def keep_mask(key, shape, rate: float, device) -> torch.Tensor:
  """Bool ``shape`` mask keeping each element with probability ``1 -
  rate`` (a dropout mask), drawn from the hash of ``(host key, flat
  element index)``: the same key gives the same mask on any device, so
  a recomputed forward (remat) and a resumed run draw the masks of the
  original."""
  k0, k1 = (int(v) for v in np.asarray(key).astype(np.int64))
  n = int(np.prod(shape))
  idx = torch.arange(n, device=device, dtype=torch.int64)
  h = _hash32(_hash32(idx ^ k0) ^ k1)
  return ((h >> 8) >= int(round(rate * (1 << 24)))).reshape(shape)
