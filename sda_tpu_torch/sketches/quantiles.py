"""Rank / quantile queries over dyadic count-min levels.

The classic dyadic trick (Cormode–Muthukrishnan 2005 §4.2): for an
integer universe ``[0, 2^U)``, keep one count-min sketch per level
``ℓ ∈ {0, …, U−1}``, where level ℓ counts values by their prefix
``v >> ℓ``. Any prefix range ``[0, x)`` decomposes into at most one
dyadic node per level — for each set bit ℓ of x, the node at level ℓ
with prefix ``(x >> ℓ) − 1`` — so a rank query is at most U point
queries, each carrying count-min's one-sided ``ε·N`` bound over the
same total N (every level counts every value exactly once):

    rank(x) <= r̂(x) <= rank(x) + U·ε·N   w.p. >= 1 − U·δ.

Quantiles are the inverse: binary-search the smallest x whose estimated
rank reaches ``q·N``. The returned value's *true* rank is then within
``U·ε·N`` of the target (plus 1 for the discrete step), which is the
bound tests and the CI smoke assert.

Everything is linear — the concatenated level grids sum coordinate-wise
— so the whole structure rides one secure round.

The port's copy of ``sda_tpu/sketches/quantiles.py``: host numpy and
``hashlib``, so every encoded cell index is the reference's.
"""

from __future__ import annotations

import numpy as np

from .base import LinearSketch, sketch_hash
from .countmin import CountMinSketch


class DyadicQuantiles(LinearSketch):
    """``U`` stacked count-min levels over an integer universe
    ``[0, 2^universe_bits)``; ``dim = universe_bits * depth * width``.

    Per-level seeds are derived from the root seed (still a pure
    function of it) so column collisions don't repeat across levels.
    """

    kind = "quantiles"

    def __init__(self, universe_bits: int, width: int, depth: int, seed: int = 0):
        if universe_bits < 1:
            raise ValueError("universe_bits must be >= 1")
        self.universe_bits = int(universe_bits)
        self.seed = int(seed)
        self.levels = [
            CountMinSketch(
                width, depth, seed=sketch_hash(seed, lvl, "level", tag=b"qt")
            )
            for lvl in range(self.universe_bits)
        ]
        self.level_dim = self.levels[0].dim
        self.dim = self.universe_bits * self.level_dim

    @property
    def universe(self) -> int:
        return 1 << self.universe_bits

    @property
    def epsilon(self) -> float:
        return self.levels[0].epsilon

    @property
    def delta(self) -> float:
        """Per-rank-query failure probability (union over levels)."""
        return min(1.0, self.universe_bits * self.levels[0].delta)

    def _validated(self, values) -> np.ndarray:
        values = np.asarray(list(values), dtype=np.int64).reshape(-1)
        if values.size and (values.min() < 0 or values.max() >= self.universe):
            raise ValueError(
                f"values must be integers in [0, {self.universe})"
            )
        return values

    def encode(self, values) -> np.ndarray:
        values = self._validated(values)
        return np.concatenate(
            [
                lvl_sketch.encode((values >> lvl).tolist())
                for lvl, lvl_sketch in enumerate(self.levels)
            ]
        )

    def _level(self, summed, lvl: int) -> np.ndarray:
        return self._check_summed(summed)[
            lvl * self.level_dim : (lvl + 1) * self.level_dim
        ]

    def total(self, summed) -> int:
        """Exact cohort value count (level 0's exact row total)."""
        return self.levels[0].total(self._level(summed, 0))

    def rank(self, summed, x: int) -> int:
        """Estimated number of values < x (one-sided: never below the
        true rank, above by at most ``rank_error_bound``)."""
        x = int(x)
        if not 0 <= x <= self.universe:
            raise ValueError(f"x must be in [0, {self.universe}]")
        if x == self.universe:
            return self.total(summed)
        r = 0
        for lvl in range(self.universe_bits):
            if (x >> lvl) & 1:
                r += self.levels[lvl].point_query(
                    self._level(summed, lvl), (x >> lvl) - 1
                )
        return r

    def rank_error_bound(self, summed) -> float:
        """U·ε·N: one εN-bounded point query per set bit, same N at
        every level."""
        return self.universe_bits * self.epsilon * self.total(summed)

    def quantile_query(self, summed, q: float) -> int:
        """Smallest value whose estimated rank reaches ``q·N``."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        total = self.total(summed)
        if total <= 0:
            raise ValueError("empty cohort: no quantiles")
        target = max(1.0, np.ceil(q * total))
        lo, hi = 0, self.universe - 1  # invariant: answer in [lo, hi]
        while lo < hi:
            mid = (lo + hi) // 2
            if self.rank(summed, mid + 1) >= target:
                hi = mid
            else:
                lo = mid + 1
        return int(lo)

    def decode(self, summed, n: int) -> dict:
        total = self.total(summed)
        qs = (0.1, 0.25, 0.5, 0.75, 0.9)
        return {
            "total": total,
            "epsilon": self.epsilon,
            "delta": self.delta,
            "error_bound": self.rank_error_bound(summed),
            "quantiles": {q: self.quantile_query(summed, q) for q in qs},
        }
