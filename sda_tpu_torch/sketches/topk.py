"""Categorical top-k via count-min heavy hitters.

The exact known-domain top-k (``SecureFrequency``) needs one wire
coordinate *per category* — untenable for large categorical domains.
This sketch keeps the ``depth x width`` count-min grid instead (width
≪ domain size) and lets the recipient rank a candidate list by their
estimated counts. Count-min never undercounts, so:

- **completeness**: any category whose true count exceeds the true
  k-th largest count by more than ``ε·N`` is always in the returned
  top-k (its estimate beats the k-th's true count, which at least k
  estimates also beat only if inflated — bounded by εN w.p. 1−δ each);
- **soundness**: every returned estimate is within ``[true,
  true + ε·N]`` w.p. 1−δ per category.

Ties break deterministically by candidate-list position — the same
discipline as ``SecureFrequency.finish_top_k``.

The port's copy of ``sda_tpu/sketches/topk.py``: host numpy and
``hashlib``, so every encoded cell index is the reference's.
"""

from __future__ import annotations

import numpy as np

from .countmin import CountMinSketch


class TopKSketch(CountMinSketch):
    """Count-min grid + a recipient-side candidate ranking.

    ``candidates`` is the categorical domain the recipient ranks over
    (participants may submit values outside it — they just add
    colliding mass to N). Encode is count-min's; only decode differs.
    """

    kind = "topk"

    def __init__(self, k: int, candidates, width: int, depth: int, seed: int = 0):
        super().__init__(width, depth, seed)
        self.candidates = list(candidates)
        if not 1 <= int(k) <= len(self.candidates):
            raise ValueError(
                f"k must be in [1, {len(self.candidates)}] (the candidate count)"
            )
        self.k = int(k)

    def top_k(self, summed):
        """-> list of (candidate, estimated count), k entries, count-
        descending, ties broken by candidate-list position."""
        counts = np.array(
            [self.point_query(summed, c) for c in self.candidates],
            dtype=np.int64,
        )
        order = np.lexsort((np.arange(len(counts)), -counts))[: self.k]
        return [(self.candidates[i], int(counts[i])) for i in order]

    def decode(self, summed, n: int) -> dict:
        total = self.total(summed)
        return {
            "topk": self.top_k(summed),
            "total": total,
            "epsilon": self.epsilon,
            "delta": self.delta,
            "error_bound": self.epsilon * total,
        }
