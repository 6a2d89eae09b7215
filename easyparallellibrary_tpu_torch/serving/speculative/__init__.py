"""Speculative decoding on the paged engine (port of
``easyparallellibrary_tpu/serving/speculative/``).

Drafters guess the next ``k`` tokens of each decode slot (drafter.py);
the engine's one flat step scores them on the flat positions the
scheduler reserved for them, and the verifier keeps each slot's accepted
prefix plus one correction or bonus token (verify.py).  Greedy output
stays token-exact; sampled output keeps its distribution (Leviathan et
al. rejection sampling).
"""

from easyparallellibrary_tpu_torch.serving.speculative.drafter import (
    Drafter, DraftModelDrafter, NgramDrafter, ngram_propose,
)
from easyparallellibrary_tpu_torch.serving.speculative.verify import (
    verify_tokens,
)

__all__ = [
    "Drafter", "DraftModelDrafter", "NgramDrafter", "ngram_propose",
    "verify_tokens",
]
