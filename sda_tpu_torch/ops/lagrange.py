"""Lagrange interpolation matrices over F_p (copy of ``sda_tpu/ops/lagrange.py``).

For a surviving clerk subset the (targets x shares) interpolation matrix is
built exactly on the host; reconstruction over every dimension batch is
then one mod-p product on the device.
"""

from __future__ import annotations

import numpy as np


def lagrange_matrix(xs, targets, p: int) -> np.ndarray:
    """M[t, j] such that poly(targets[t]) = sum_j M[t, j] * values[j] mod p.

    ``xs`` are the distinct interpolation points, ``targets`` the evaluation
    points. Exact integer construction, canonical representatives.
    """
    xs = [x % p for x in xs]
    if len(set(xs)) != len(xs):
        raise ValueError("interpolation points must be distinct")
    rows = []
    for t in targets:
        t = t % p
        row = []
        for j, xj in enumerate(xs):
            num, den = 1, 1
            for m, xm in enumerate(xs):
                if m == j:
                    continue
                num = num * ((t - xm) % p) % p
                den = den * ((xj - xm) % p) % p
            row.append(num * pow(den, p - 2, p) % p)
        rows.append(row)
    return np.array(rows, dtype=np.int64)
