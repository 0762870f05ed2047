"""Count-sketch: unbiased point queries with an L2 (not L1) bound.

Charikar–Chen–Farach-Colton 2002. Same ``depth x width`` grid as
count-min, but each row also assigns the item a random sign and adds
±1 — colliding mass cancels in expectation, so each row estimate
``sign(x) * cell`` is *unbiased* with variance ≤ ‖f‖₂²/width (f the
frequency vector excluding x). The median over rows concentrates:

    |f̂(x) − f(x)| <= 3·sqrt(‖f‖₂² / width)  w.p. >= 1 − e^(−depth/5)

(Chebyshev per row at 3σ gives failure ≤ 1/9; a median of depth
independent rows fails only if ≥ depth/2 rows fail — Chernoff). The
L2 bound beats count-min's εN whenever the frequency mass is spread
(‖f‖₂ ≪ ‖f‖₁), and the estimator is two-sided, so it also serves
signed data. ‖f‖₂² itself is estimated from the sketch by the AMS
median-of-row-energies, so the reported bound needs no side channel.

The port's copy of ``sda_tpu/sketches/countsketch.py``: host numpy and
``hashlib``, so every encoded cell index is the reference's.
"""

from __future__ import annotations

import math

import numpy as np

from .base import LinearSketch, sketch_hash


class CountSketch(LinearSketch):
    """``encode(values) -> (depth*width,) int64`` signed counting grid.

    Cells are signed (participants' ±1 increments), which is exactly
    why ``SketchQuery`` decodes through the centered field lift.
    """

    kind = "countsketch"

    def __init__(self, width: int, depth: int, seed: int = 0):
        if width < 1 or depth < 1:
            raise ValueError("width and depth must be >= 1")
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        self.dim = self.width * self.depth

    def _columns(self, item) -> np.ndarray:
        return np.array(
            [
                sketch_hash(self.seed, r, item, tag=b"cs") % self.width
                for r in range(self.depth)
            ],
            dtype=np.int64,
        )

    def _signs(self, item) -> np.ndarray:
        # a distinct tag decorrelates the sign from the bucket choice —
        # sharing one hash would make the sign a function of the column
        return np.array(
            [
                1 if sketch_hash(self.seed, r, item, tag=b"sg") & 1 else -1
                for r in range(self.depth)
            ],
            dtype=np.int64,
        )

    def encode(self, values) -> np.ndarray:
        grid = np.zeros((self.depth, self.width), dtype=np.int64)
        for item in values:
            grid[np.arange(self.depth), self._columns(item)] += self._signs(item)
        return grid.reshape(-1)

    def point_query(self, summed, item) -> int:
        """Median over rows of ``sign * cell`` — unbiased, two-sided."""
        grid = self._check_summed(summed).reshape(self.depth, self.width)
        ests = self._signs(item) * grid[np.arange(self.depth), self._columns(item)]
        return int(np.median(ests))

    def f2_estimate(self, summed) -> float:
        """AMS second-moment estimate: median over rows of the row's
        cell-energy Σ_j cell², each an unbiased ‖f‖₂² estimator."""
        grid = self._check_summed(summed).reshape(self.depth, self.width)
        return float(np.median((grid.astype(np.float64) ** 2).sum(axis=1)))

    def error_bound(self, summed) -> float:
        """3σ bound off the sketch's own F2 estimate."""
        return 3.0 * math.sqrt(self.f2_estimate(summed) / self.width)

    @property
    def delta(self) -> float:
        """Per-query failure probability of the 3σ median bound."""
        return math.exp(-self.depth / 5.0)

    def decode(self, summed, n: int) -> dict:
        return {
            "f2_estimate": self.f2_estimate(summed),
            "delta": self.delta,
            "error_bound": self.error_bound(summed),
        }
