"""Batched speculative verification: per-slot accept or reject (port of
``easyparallellibrary_tpu/serving/speculative/verify.py``).

One call decides, for every slot at once, how many of its drafted tokens
the target keeps and what the one guaranteed extra token is.  Drafters
here are deterministic (a point-mass proposal ``q = onehot(d)``):

* **greedy** (``temperature <= 0``): draft ``d_j`` is accepted while it
  equals the argmax of the target logits at its position; the first
  mismatch commits the argmax (the correction), and when every draft
  survives the bonus token is the argmax after them.  Committed ids
  equal non-speculative greedy decode.
* **sampled**: draft ``d_j`` is accepted with probability ``p_j(d_j)``,
  ``p_j`` the target distribution after the request's temperature /
  top-k / top-p filters (``engine.filtered_logits``, what
  ``sample_token_slots`` draws from).  On rejection the committed token
  samples ``p_j`` with the rejected id removed; with every draft
  accepted the bonus samples ``p_k``.  Each emitted token is distributed
  as ``p_j``, so speculation keeps the distribution and changes the
  bits.

Randomness rides each request's counter stream folded by committed token
index: the decision for index ``t`` derives from ``fold_in(key, t)``,
the accept uniform and the residual or bonus sample from two salted
folds of it.  A slot with ``num_draft == 0`` samples with the plain fold,
so a request served without drafts reproduces the non-speculative
engine's stream bit for bit.
"""

from __future__ import annotations

import torch

from easyparallellibrary_tpu_torch.utils import prng

# Salts of the accept-uniform and residual/bonus-sample streams (the
# JAX package's values).  The plain fold is reserved for the
# num_draft == 0 sample.
_ACCEPT_SALT = 0x5bec
_SAMPLE_SALT = 0xd4a7


def verify_tokens(target_logits, draft_tokens, num_draft, keys, tok_index,
                  temperature, top_k, top_p):
  """Accept or reject one step's drafts, vectorized over slots.

  ``target_logits`` fp32 ``[N, K+1, V]``: row ``j`` is the target's
  (unfiltered) distribution that draft ``j`` is judged against, row
  ``num_draft`` feeds the bonus token.  ``draft_tokens`` int ``[N, K]``;
  ``num_draft`` int ``[N]`` in ``[0, K]``.  ``keys`` int64 ``[N, 2]``
  request keys, ``tok_index`` int ``[N]`` tokens committed so far;
  ``temperature`` / ``top_k`` / ``top_p`` as ``sample_token_slots``.

  Returns ``(committed [N, K+1] int64, n_committed [N] int64, accepted
  [N] int64)`` with ``n_committed = accepted + 1``; only the first
  ``n_committed`` entries of a row are meaningful.
  """
  from easyparallellibrary_tpu_torch.serving.engine import filtered_logits
  N, K1, V = target_logits.shape
  K = K1 - 1
  dev = target_logits.device
  rows = torch.arange(N, device=dev)
  cols = torch.arange(K1, device=dev)
  draft_tokens = draft_tokens.long()
  num_draft = num_draft.long()
  rep = lambda a: a.repeat_interleave(K1, dim=0)  # noqa: E731
  filt = filtered_logits(
      target_logits.reshape(N * K1, V), rep(temperature), rep(top_k),
      rep(top_p)).reshape(N, K1, V)
  probs = torch.softmax(filt, dim=-1)
  greedy_tok = torch.argmax(target_logits, dim=-1)

  # One fold per committed token index this step could produce.
  idx = tok_index.long()[:, None] + cols[None]                # [N, K+1]
  folded = prng.fold_in(keys.long()[:, None, :].expand(N, K1, 2), idx)
  accept_u = prng.uniform(prng.fold_in(
      folded, torch.full_like(idx, _ACCEPT_SALT)))             # [N, K+1]

  p_draft = torch.gather(probs[:, :K], 2, draft_tokens[:, :, None])[..., 0]
  greedy_mode = temperature <= 0
  ok = torch.where(greedy_mode[:, None], draft_tokens == greedy_tok[:, :K],
                   accept_u[:, :K] < p_draft)
  ok = ok & (cols[None, :K] < num_draft[:, None])
  # Longest accepted prefix: a rejection voids every later draft.
  accepted = torch.cumprod(ok.long(), dim=1).sum(dim=1)

  # The guaranteed extra token at draft index a = accepted: the bonus
  # from p_a when every draft survived, else the residual at the
  # rejection.
  a = accepted
  fin_filt = filt[rows, a]                                     # [N, V]
  fin_greedy = greedy_tok[rows, a]
  rej_tok = draft_tokens[rows, torch.clamp(a, 0, K - 1)]
  is_bonus = a == num_draft
  rejected = torch.nn.functional.one_hot(rej_tok, V).bool()
  resid = fin_filt.masked_fill(rejected, float("-inf"))
  # A degenerate residual (the filtered support was the rejected token
  # alone, reachable only through roundoff) falls back to the filtered
  # distribution.
  resid_ok = (resid > -1e29).any(dim=-1, keepdim=True)
  resid = torch.where(resid_ok, resid, fin_filt)
  fin_logits = torch.where(is_bonus[:, None], fin_filt, resid)

  fold_a = folded[rows, a]                                     # [N, 2]
  salted = prng.fold_in(fold_a, torch.full_like(a, _SAMPLE_SALT))
  samp_keys = torch.where((num_draft == 0)[:, None], fold_a, salted)
  sampled = prng.categorical(samp_keys, fin_logits)
  fin = torch.where(greedy_mode, fin_greedy, sampled)

  pad_drafts = torch.cat(
      [draft_tokens, torch.zeros((N, 1), dtype=torch.long, device=dev)],
      dim=1)
  committed = torch.where(cols[None] < a[:, None], pad_drafts,
                          fin[:, None])
  return committed, accepted + 1, accepted
