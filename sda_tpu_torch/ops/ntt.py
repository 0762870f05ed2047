"""Number-theoretic transform matrices over F_p (copy of ``sda_tpu/ops/ntt.py``).

The packed-Shamir domains are tiny (radix-2 of size k+t+1, radix-3 of size
n+1), so transforms are precomputed host matrices composed into the share
matrix once per scheme; the device only ever sees the composed map.
"""

from __future__ import annotations

import numpy as np

from .modular import modmatmul_np


def dft_matrix(omega: int, n: int, p: int) -> np.ndarray:
    """V[i, j] = omega^(i*j) mod p, exact, canonical representatives."""
    rows = []
    for i in range(n):
        w = pow(omega, i, p)
        row, acc = [], 1
        for _ in range(n):
            row.append(acc)
            acc = acc * w % p
        rows.append(row)
    return np.array(rows, dtype=np.int64)


def inverse_dft_matrix(omega: int, n: int, p: int) -> np.ndarray:
    """V^-1[i, j] = n^-1 * omega^(-i*j) mod p, scaled with exact python ints
    (an int64 elementwise multiply would overflow for 61-bit moduli)."""
    n_inv = pow(n, p - 2, p)
    omega_inv = pow(omega, p - 2, p)
    V = dft_matrix(omega_inv, n, p)
    return np.array(
        [[int(v) * n_inv % p for v in row] for row in V], dtype=np.int64
    )


def ntt(values: np.ndarray, omega: int, p: int) -> np.ndarray:
    """Forward transform of the trailing axis: values @ V^T mod p."""
    n = values.shape[-1]
    return modmatmul_np(values, dft_matrix(omega, n, p).T, p)


def intt(values: np.ndarray, omega: int, p: int) -> np.ndarray:
    """Inverse transform of the trailing axis."""
    n = values.shape[-1]
    return modmatmul_np(values, inverse_dft_matrix(omega, n, p).T, p)
