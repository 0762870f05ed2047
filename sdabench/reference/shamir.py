"""Plain packed Shamir over the configuration's numbers: what the clerks'
sums say about the sharing, worked out from the sums alone.

One polynomial of degree below ``k + t`` holds a batch: its values at
``omega_secrets^1..^k`` are the ``k`` secrets and at
``omega_secrets^(k+1)..^(k+t)`` the ``t`` random values; clerk ``i`` holds
its value at ``omega_shares^(i+1)``. Sums of shares are shares of the sums,
so from the sums of any ``k + t`` clerks Lagrange interpolation gives back
each batch's summed randomness and what every other clerk's sum must be.

- ``share_mismatches``: the other clerks' sums that no such polynomial
  through the reconstructing clerks gives (exact: 0).
- ``randomness_zero_share``: the share of summed random values that are 0.
  Sums of uniform draws are uniform in ``[0, p)``, so this is 0 but for
  chance; where the draws are left out or zero, it is 1.
- ``randomness_mean_sigmas``: how far the mean of the summed random values
  over ``p`` lies from 1/2, in standard deviations of a mean of that many
  uniform values (``sqrt(1 / 12N)``). Draws that do not cover the field, or
  none, read hundreds or more.

Python integers for the interpolation's weights; int64 numpy for a field
below 2^31 (each product stays below 2^62), Python integers above.
Nothing of the port is imported.
"""

from __future__ import annotations

import math

import numpy as np

#: the limits of the sharing's numbers (PERF.md gives the readings they
#: were set from); ``share_mismatches`` is exact, its limit 0
ZERO_SHARE_LIMIT = 0.6
MEAN_SIGMAS_LIMIT = 40.0


def lagrange(xs: list, targets: list, p: int) -> list:
    """Rows of weights: the value at each target of the polynomial of degree
    below ``len(xs)`` through ``xs`` is ``sum_j row[j] * value_j mod p``."""
    rows = []
    for x in targets:
        row = []
        for j, xj in enumerate(xs):
            num = den = 1
            for m, xm in enumerate(xs):
                if m != j:
                    num = num * (x - xm) % p
                    den = den * (xj - xm) % p
            row.append(num * pow(den, -1, p) % p)
        rows.append(row)
    return rows


def _apply(rows: list, values: np.ndarray, p: int) -> np.ndarray:
    dtype = np.int64 if p < 1 << 31 else object
    values = np.asarray(values).astype(dtype) % p
    out = np.zeros((len(rows), values.shape[1]), dtype=dtype)
    for i, row in enumerate(rows):
        for j, w in enumerate(row):
            out[i] = (out[i] + w * values[j]) % p
    return out


def sharing(clerk_sums, scheme: dict, clerks: list) -> tuple[np.ndarray, int]:
    """``(n, B)`` clerk sums -> the ``(t, B)`` summed randomness that the
    sums of ``clerks`` (``k + t`` of them) give, and the count of the other
    clerks' sums that differ from what those give."""
    k, t, n = scheme["secret_count"], scheme["privacy_threshold"], scheme["share_count"]
    p, ws, wn = scheme["prime_modulus"], scheme["omega_secrets"], scheme["omega_shares"]
    if len(clerks) != k + t:
        raise ValueError(f"interpolation takes k + t = {k + t} clerks, got {len(clerks)}")
    sums = np.asarray(clerk_sums)
    others = [i for i in range(n) if i not in clerks]
    xs = [pow(wn, i + 1, p) for i in clerks]
    targets = [pow(ws, k + 1 + r, p) for r in range(t)] + [pow(wn, i + 1, p) for i in others]
    got = _apply(lagrange(xs, targets, p), sums[clerks], p)
    mismatches = int(np.count_nonzero(got[t:] != np.asarray(sums[others]).astype(got.dtype) % p))
    return got[:t], mismatches


def checks(clerk_sums: list, scheme: dict, clerks: list) -> dict:
    """The sharing's numbers over a run's kept clerk sums (one ``(n, B)``
    array each). Where the run handed none back, each number is ``None``:
    no number, which fails its limit."""
    limits = {"share_mismatches": 0, "randomness_zero_share": ZERO_SHARE_LIMIT,
              "randomness_mean_sigmas": MEAN_SIGMAS_LIMIT}
    if not clerk_sums or any(sums is None for sums in clerk_sums):
        return {name: (None, limit) for name, limit in limits.items()}
    p = scheme["prime_modulus"]
    mismatches, zeros, count, total = 0, 0, 0, 0.0
    for sums in clerk_sums:
        randomness, bad = sharing(sums, scheme, clerks)
        mismatches += bad
        zeros += int(np.count_nonzero(randomness == 0))
        count += randomness.size
        total += int(np.sum(randomness)) / p
    sigmas = abs(total / count - 0.5) / math.sqrt(1.0 / (12 * count))
    values = {"share_mismatches": mismatches, "randomness_zero_share": zeros / count,
              "randomness_mean_sigmas": sigmas}
    return {name: (values[name], limit) for name, limit in limits.items()}
