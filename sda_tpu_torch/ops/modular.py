"""Modular arithmetic with Rust signed-remainder semantics.

Counterpart of ``sda_tpu/ops/modular.py``: the numpy/int half is copied,
the device half runs on torch tensors. Rust's ``%`` truncates toward zero
(``-7 % 5 == -2``); so do ``numpy.fmod`` and ``torch.fmod``. torch's ``%``
and ``torch.remainder`` floor instead, so no hot-path reduction here uses
them. Values stay in ``(-m, m)`` and ``positive`` lifts them to ``[0, m)``.

Products for moduli < 2**31 fit int64; wider moduli (to 2**62) take the
halving sums and the exact host or limb-space products.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_SAFE_MODULUS = 1 << 31
WIDE_MAX_MODULUS = 1 << 62


# ---------------------------------------------------------------------------
# numpy / python-int half
# ---------------------------------------------------------------------------


def rust_rem_np(x, m):
    """Truncated remainder (Rust ``%``) for numpy arrays / scalars."""
    return np.fmod(x, m)


def rust_rem_int(x: int, m: int) -> int:
    """Truncated remainder for python ints."""
    r = abs(x) % m
    return -r if x < 0 else r


def positive(x, m):
    """Lift representatives from ``(-m, m)`` to canonical ``[0, m)``.

    Works for torch tensors, numpy arrays and python ints.
    """
    if isinstance(x, torch.Tensor):
        return torch.where(x < 0, x + m, x)
    if isinstance(x, (int, np.integer)):
        return x + m if x < 0 else x
    x = np.asarray(x)
    return np.where(x < 0, x + m, x)


def mod_add(a, b, m):
    """(a + b) with one truncated reduction; inputs in (-m, m)."""
    return rust_rem_np(np.asarray(a, dtype=np.int64) + np.asarray(b, dtype=np.int64), m)


def mod_mul(a, b, m):
    """(a * b) % m in int64; valid for m < 2**31 (products < 2**62)."""
    return rust_rem_np(np.asarray(a, dtype=np.int64) * np.asarray(b, dtype=np.int64), m)


def mod_pow(base: int, exp: int, m: int) -> int:
    """Scalar modular exponentiation (canonical representative)."""
    return pow(base % m, exp, m)


def mod_inverse(a: int, m: int) -> int:
    """Inverse of a mod prime m (canonical representative)."""
    a = a % m
    if a == 0:
        raise ZeroDivisionError("no inverse of 0")
    return pow(a, m - 2, m)


def mod_sum_wide_np(x: np.ndarray, m: int, axis: int = 0) -> np.ndarray:
    """Exact sum-mod-m along ``axis`` for any m < 2**62 (halving reduction:
    pair sums of values in (-m, m) stay within int64)."""
    x = np.moveaxis(np.asarray(x, dtype=np.int64), axis, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        paired = rust_rem_np(x[:half] + x[half : 2 * half], m)
        if x.shape[0] % 2:
            paired = np.concatenate([paired, x[-1:]], axis=0)
        x = paired
    return x[0]


def modmatmul_np(A: np.ndarray, B: np.ndarray, m: int) -> np.ndarray:
    """Exact (A @ B) mod m on the host, truncated representatives.

    m < 2**31: int64 (or float64 when every partial sum stays < 2**53);
    larger m (to 2**62): exact object-dtype arithmetic.
    """
    if m >= MAX_SAFE_MODULUS:
        A = np.asarray(A, dtype=object)
        B = np.asarray(B, dtype=object)
        out = A @ B
        return np.vectorize(lambda v: rust_rem_int(int(v), m), otypes=[np.int64])(out)
    A = np.asarray(A, dtype=np.int64)
    B = np.asarray(B, dtype=np.int64)
    # |INT64_MIN| wraps to itself; pre-reduce such operands so the
    # magnitude bound below stays honest
    int64_min = np.iinfo(np.int64).min
    if (A == int64_min).any():
        A = rust_rem_np(A, m)
    if (B == int64_min).any():
        B = rust_rem_np(B, m)
    bound = (
        A.shape[-1]
        * max(1, int(np.abs(A).max(initial=0)))
        * max(1, int(np.abs(B).max(initial=0)))
    )
    if bound < (1 << 53):
        prod = (A.astype(np.float64) @ B.astype(np.float64)).astype(np.int64)
        return rust_rem_np(prod, m)
    if bound < (1 << 63):
        return rust_rem_np(A @ B, m)
    prods = rust_rem_np(A[..., :, None] * B[None, ...], m)  # (..., K, N)
    return rust_rem_np(prods.sum(axis=-2), m)


# ---------------------------------------------------------------------------
# torch (device) half
# ---------------------------------------------------------------------------


def rust_rem(x: torch.Tensor, m: int) -> torch.Tensor:
    """Truncated remainder (Rust ``%``) for tensors."""
    return torch.fmod(x, m)


def mod_sum(x: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    """Sum along ``axis`` then one truncated reduction; int64 accumulate.
    Safe while ``x.shape[axis] * (m - 1) < 2**63``."""
    return torch.fmod(torch.sum(x.to(torch.int64), dim=axis), m)


def mod_sum_wide(x: torch.Tensor, m: int, axis: int = 0) -> torch.Tensor:
    """Halving sum-mod-m along ``axis``; exact for m < 2**62.

    Zero-pads to a power of two; each level's pair sums stay within int64.
    """
    x = torch.movedim(x.to(torch.int64), axis, 0)
    n = x.shape[0]
    levels = max(1, (n - 1).bit_length())
    pad = (1 << levels) - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    for _ in range(levels):
        half = x.shape[0] // 2
        x = torch.fmod(x[:half] + x[half:], m)
    return x[0]


def mod_sum_auto(x: torch.Tensor, m: int, axis: int = 0) -> torch.Tensor:
    """Reduced sum-mod-m along ``axis``, exact for any ``|x| < m < 2**62``.

    While ``n*(m-1) < 2**63`` a plain int64 sum + fmod is exact; past it
    the halving sum takes over. On mixed-sign input the two paths may
    return different signed representatives of the same residue: compare
    after ``positive``.
    """
    if x.shape[axis] * (m - 1) < 2**63:
        return mod_sum(x, m, axis)
    return mod_sum_wide(x, m, axis)


def modmatmul(A: torch.Tensor, B: torch.Tensor, m: int) -> torch.Tensor:
    """Exact (A @ B) mod m for m < 2**31: per-product reduction, then an
    int64 sum. Broadcast-multiply instead of a matmul: CUDA has no integer
    GEMM in torch."""
    A = A.to(torch.int64)
    B = B.to(torch.int64)
    prods = torch.fmod(A[..., :, None] * B[None, ...], m)
    return torch.fmod(torch.sum(prods, dim=-2), m)
