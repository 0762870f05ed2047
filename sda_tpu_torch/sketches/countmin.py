"""Count-min sketch: biased-up point queries with an εN additive bound.

Cormode–Muthukrishnan 2005. A ``depth x width`` grid of counters; each
row hashes every item into one column and counts it. The row estimates
of an item's frequency each overcount by the colliding mass in its
cell, never undercount — so the minimum over rows is the estimate:

    f(x) <= f̂(x) <= f(x) + ε·N   with probability >= 1 − δ,

where N is the total number of counted values, ε = e / width, and
δ = e^(−depth) (Markov per row at e/width, independent rows). The grid
is linear in the input multiset, so the secure sum of per-participant
grids IS the cohort grid, and the recipient's point queries carry the
cohort-level guarantee.

The port's copy of ``sda_tpu/sketches/countmin.py``: host numpy and
``hashlib``, so every encoded cell index is the reference's.
"""

from __future__ import annotations

import math

import numpy as np

from .base import LinearSketch, sketch_hash


class CountMinSketch(LinearSketch):
    """``encode(values) -> (depth*width,) int64`` counting grid.

    ``width`` controls the additive error (ε = e/width of the total
    count), ``depth`` the failure probability (δ = e^−depth); ``seed``
    makes the row hashes a shared pure function across participants.
    """

    kind = "countmin"

    def __init__(self, width: int, depth: int, seed: int = 0):
        if width < 1 or depth < 1:
            raise ValueError("width and depth must be >= 1")
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        self.dim = self.width * self.depth

    @property
    def epsilon(self) -> float:
        """Additive error per N: estimate <= true + epsilon*N w.p. 1-delta."""
        return math.e / self.width

    @property
    def delta(self) -> float:
        return math.exp(-self.depth)

    def _columns(self, item) -> np.ndarray:
        return np.array(
            [
                sketch_hash(self.seed, r, item, tag=b"cm") % self.width
                for r in range(self.depth)
            ],
            dtype=np.int64,
        )

    def encode(self, values) -> np.ndarray:
        grid = np.zeros((self.depth, self.width), dtype=np.int64)
        for item in values:
            grid[np.arange(self.depth), self._columns(item)] += 1
        return grid.reshape(-1)

    def total(self, summed) -> int:
        """Exact total count N: every row counts every value once."""
        summed = self._check_summed(summed).reshape(self.depth, self.width)
        return int(summed[0].sum())

    def point_query(self, summed, item) -> int:
        """Estimated frequency of ``item`` (min over rows; never below
        the true count, above by at most ``epsilon * N`` w.p. 1−δ)."""
        grid = self._check_summed(summed).reshape(self.depth, self.width)
        return int(grid[np.arange(self.depth), self._columns(item)].min())

    def error_bound(self, summed) -> float:
        """The εN additive bound at this sketch's width, off the summed
        sketch's exact total."""
        return self.epsilon * self.total(summed)

    def heavy_hitters(self, summed, candidates, threshold: int):
        """Candidates whose estimated count >= threshold, with counts.

        Completeness: every candidate with true count >= threshold is
        returned (estimates never undercount). Soundness: anything
        returned has true count > threshold − εN w.p. 1−δ per item."""
        hits = [
            (item, self.point_query(summed, item))
            for item in candidates
        ]
        return [(i, c) for i, c in hits if c >= threshold]

    def decode(self, summed, n: int) -> dict:
        """Round-level summary: exact total + the analytic bound. Point
        estimates come from ``point_query``/``heavy_hitters``."""
        total = self.total(summed)
        return {
            "total": total,
            "epsilon": self.epsilon,
            "delta": self.delta,
            "error_bound": self.epsilon * total,
        }
