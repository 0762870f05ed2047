"""Linear-counting cohort cardinality over a shared hashed bitmap.

Whang–Vander-Zanden–Taylor 1990, the same estimator the statistics
plane's ``SecureCountDistinct`` uses — restated as a ``LinearSketch``
so cardinality composes with the sketch-plane drivers. Each participant
hashes its locally-distinct items into an ``m``-bit bitmap (0/1 per bin); the secure sum counts how many
participants touched each bin, and a bin of the *union* is empty iff
its summed count is zero. With ``z`` empty bins and load ``t = n/m``:

    n̂ = −m·ln(z/m),   Var(n̂) ≈ m·(e^t − t − 1)

so the reported bound is 3·sqrt(m·(e^t̂ − t̂ − 1)) at the estimated
load — under 1% relative error for m ≥ 2n. A saturated bitmap (z = 0)
has no unbiased estimate and raises loudly, per the repo convention.

The port's copy of ``sda_tpu/sketches/cardinality.py``: host numpy and
``hashlib``, so every encoded cell index is the reference's.
"""

from __future__ import annotations

import math

import numpy as np

from .base import LinearSketch, sketch_hash


class LinearCountingSketch(LinearSketch):
    """``encode(items) -> (m,) int64`` 0/1 touched-bin bitmap (items are
    deduped locally first, so each participant adds at most 1 per bin
    and the field only needs ``n_participants`` of per-cell headroom)."""

    kind = "cardinality"

    def __init__(self, m: int, seed: int = 0):
        if m < 1:
            raise ValueError("m must be >= 1")
        self.m = int(m)
        self.seed = int(seed)
        self.dim = self.m

    def cell_bound(self, max_values: int) -> int:
        return 1  # deduped 0/1 bitmap, regardless of how many items

    def _bin_of(self, item) -> int:
        return sketch_hash(self.seed, 0, item, tag=b"lc") % self.m

    def encode(self, values) -> np.ndarray:
        out = np.zeros(self.m, dtype=np.int64)
        out[list({self._bin_of(x) for x in values})] = 1
        return out

    def decode(self, summed, n: int) -> dict:
        summed = self._check_summed(summed)
        zeros = int(np.count_nonzero(summed == 0))
        if zeros == 0:
            raise ValueError(
                f"sketch saturated (0 of {self.m} bins empty): raise m "
                "beyond ~2x the expected distinct count and re-run"
            )
        estimate = -self.m * math.log(zeros / self.m)
        load = estimate / self.m
        std_error = math.sqrt(self.m * (math.exp(load) - load - 1.0))
        return {
            "estimate": estimate,
            "std_error": std_error,
            "error_bound": 3.0 * std_error,
        }
