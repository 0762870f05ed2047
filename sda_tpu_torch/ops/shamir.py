"""Packed and basic Shamir sharing as precomputed mod-p linear maps.

Copy of the parts of ``sda_tpu/ops/shamir.py`` the engine, the model plane
(``verify_scheme`` checks ``QuantizationSpec.fitted``'s scheme), the
participants' host sharing (``share_batches``) and the tier tree's share
promotion (``reshare_coefficients``/``reshare_column``) use. One
degree-(t+k-1) polynomial hides k secrets: its values on the order-(k+t+1)
secrets domain are ``[v_0, s_1..s_k, r_1..r_t]`` with v_0 chosen so the top
coefficient vanishes; clerk i holds the evaluation at omega_shares^(i+1).
The whole pipeline is linear over F_p, so it is composed once on the host
into an (n x (k+t)) share matrix and a (k x R) reconstruction matrix.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from .lagrange import lagrange_matrix
from .modular import modmatmul_np, positive
from .ntt import dft_matrix, inverse_dft_matrix


def scheme_dims(scheme) -> tuple[int, int, int, int]:
    """(k, t, n, m2) for a PackedShamirSharing scheme."""
    k = scheme.secret_count
    t = scheme.privacy_threshold
    n = scheme.share_count
    return k, t, n, k + t + 1


def _is_basic(scheme) -> bool:
    """Basic (non-packed) Shamir: no NTT domains, evaluation points 0
    (secret) and 1..n (shares)."""
    return not hasattr(scheme, "omega_secrets")


def reconstruct_limit(scheme) -> int:
    """Shares needed to reconstruct (t+1 basic, t+k packed)."""
    return scheme.reconstruction_threshold


def basic_share_matrix(scheme) -> np.ndarray:
    """BasicShamir share map: f(x) = s + sum_j r_j x^j, shares at x = 1..n,
    i.e. the (n x (t+1)) Vandermonde at points 1..n."""
    n, t, p = scheme.share_count, scheme.privacy_threshold, scheme.prime_modulus
    if n <= t:
        raise ValueError("share_count must exceed privacy_threshold")
    if n >= p:
        raise ValueError("share_count must be below the prime modulus")
    V = np.zeros((n, t + 1), dtype=np.int64)
    for i in range(n):
        for j in range(t + 1):
            V[i, j] = pow(i + 1, j, p)
    return V


def share_matrix(scheme) -> np.ndarray:
    """(n x (k+t)) matrix S: shares = [secrets, randomness] @ S.T mod p.

    Embed the k+t free values into the m2-point secrets domain with
    v_0 = -sum_{j>=1} omega^j * v_j (zeroing the top coefficient),
    inverse-NTT to coefficients, zero-pad to m3, forward-NTT to the shares
    domain, drop the evaluation at point 1.
    """
    if _is_basic(scheme):
        return basic_share_matrix(scheme)
    k, t, n, m2 = scheme_dims(scheme)
    m3 = n + 1
    p = scheme.prime_modulus
    if m3 < m2:
        raise ValueError("share domain smaller than polynomial degree")
    C = np.zeros((m2, k + t), dtype=np.int64)
    for j in range(k + t):
        C[j + 1, j] = 1
        C[0, j] = (-pow(scheme.omega_secrets, j + 1, p)) % p
    intt2 = inverse_dft_matrix(scheme.omega_secrets, m2, p)
    ntt3 = dft_matrix(scheme.omega_shares, m3, p)
    pad = np.zeros((m3, m2), dtype=np.int64)
    pad[:m2, :] = np.eye(m2, dtype=np.int64)
    full = modmatmul_np(ntt3, modmatmul_np(pad, modmatmul_np(intt2, C, p), p), p)
    return full[1:, :]  # (n, k+t); drop evaluation at point 1


def reconstruction_matrix(scheme, indices) -> np.ndarray:
    """(k x R) matrix L for surviving clerk ``indices`` (0-based):
    secrets = L @ shares[indices] mod p."""
    p = scheme.prime_modulus
    n = scheme.share_count
    if len(indices) < reconstruct_limit(scheme):
        raise ValueError(
            f"need at least {reconstruct_limit(scheme)} shares, got {len(indices)}"
        )
    if any(not 0 <= i < n for i in indices):
        raise ValueError("share index out of range")
    if _is_basic(scheme):
        return lagrange_matrix([i + 1 for i in indices], [0], p)
    k = scheme.secret_count
    xs = [pow(scheme.omega_shares, i + 1, p) for i in indices]
    targets = [pow(scheme.omega_secrets, j, p) for j in range(1, k + 1)]
    return lagrange_matrix(xs, targets, p)


def share_batches(secrets: np.ndarray, randomness: np.ndarray, S: np.ndarray, p: int) -> np.ndarray:
    """Share (B, k) secret batches with (B, t) randomness -> (B, n) shares."""
    values = np.concatenate([secrets, randomness], axis=1)  # (B, k+t)
    return modmatmul_np(values, S.T, p)


def reconstruct_batches(shares: np.ndarray, L: np.ndarray, p: int) -> np.ndarray:
    """Reconstruct (B, R) indexed share batches -> (B, k) secrets."""
    return modmatmul_np(shares, L.T, p)


def reconstruct_clerk_sums_host(clerk_sums, indices, scheme, dim: int) -> np.ndarray:
    """Host-exact reconstruction of ``(n, B)`` clerk sums from the surviving
    0-based clerk ``indices`` -> ``(dim,)`` aggregate, pad truncated. Exact
    for any modulus width."""
    L = reconstruction_matrix(scheme, list(indices))  # (k, R)
    rows = np.asarray(clerk_sums)[list(indices)]  # (R, B)
    secrets = reconstruct_batches(rows.T, L, scheme.prime_modulus)  # (B, k)
    return np.asarray(secrets).reshape(-1)[:dim]


def reshare_coefficients(scheme, survivors, position) -> np.ndarray:
    """(k,) Lagrange column for the surviving clerk at committee
    ``position`` — the share-promotion weights of the tier tree.

    ``reconstruction_matrix(scheme, survivors)`` maps the survivors' share
    columns to the secrets; its column for ``position`` is the weight
    vector this one clerk contributes. A clerk that scales its aggregated
    share column by these coefficients (``reshare_column``) and submits
    the result as an ordinary participation one tier up makes the parent's
    sum over all survivors equal the reconstructed sub-cohort aggregate,
    without any party ever holding more than its own single column.
    """
    survivors = list(survivors)
    L = reconstruction_matrix(scheme, survivors)  # (k, R)
    return L[:, survivors.index(position)].copy()


def reshare_column(column, coefficients, p: int, dim: int) -> np.ndarray:
    """Expand a clerk's (B,) aggregated share column into the (dim,)
    parent-tier contribution: outer(column, coefficients) flattened
    batch-major and pad-truncated — the flatten ``reconstruct_batches``
    applies, so summing all survivors' expansions mod p IS the
    reconstruction, term-reordered. Exact at any modulus width: the
    products go through ``modmatmul_np``, which takes Python-int products
    where int64 would overflow. Empty columns (no participations in the
    sub-cohort) expand to zeros."""
    col = np.asarray(column, dtype=np.int64).reshape(-1, 1)  # (B, 1)
    if col.size == 0:
        return np.zeros(dim, dtype=np.int64)
    coef = np.asarray(coefficients, dtype=np.int64).reshape(1, -1)  # (1, k)
    out = modmatmul_np(col, coef, p)  # (B, k)
    return np.asarray(positive(np.asarray(out).reshape(-1)[:dim], p), dtype=np.int64)


def _mod_rank(M: np.ndarray, p: int) -> int:
    """Rank of a small integer matrix over F_p (exact Gaussian elimination
    with python ints; matrices here are at most committee-sized)."""
    M = [[int(x) % p for x in row] for row in np.asarray(M)]
    rows, cols = len(M), len(M[0]) if M else 0
    rank = 0
    for col in range(cols):
        pivot = next((r for r in range(rank, rows) if M[r][col] % p), None)
        if pivot is None:
            continue
        M[rank], M[pivot] = M[pivot], M[rank]
        inv = pow(M[rank][col], -1, p)
        M[rank] = [(x * inv) % p for x in M[rank]]
        for r in range(rows):
            if r != rank and M[r][col]:
                f = M[r][col]
                M[r] = [(a - f * b) % p for a, b in zip(M[r], M[rank])]
        rank += 1
        if rank == rows:
            break
    return rank


def verify_scheme(scheme, max_subsets: int = 20000) -> None:
    """Check a Shamir scheme's two promises over F_p; raises ``ValueError``
    on any violation.

    1. t-privacy: for every t-subset of share rows, the randomness columns
       (k..k+t) of the share matrix restricted to those rows have rank t,
       so any t shares are a bijective image of the randomness and hide
       the secrets.
    2. reconstruction: every ``reconstruction_threshold``-subset of share
       rows has full rank k+t, so ``reconstruction_matrix`` exists for any
       surviving subset.

    ``max_subsets`` bounds the committee-sized subset counts (n choose t).
    """
    S = share_matrix(scheme)  # (n, k+t)
    n = S.shape[0]
    k = 1 if _is_basic(scheme) else scheme.secret_count
    t = scheme.privacy_threshold
    p = scheme.prime_modulus
    R = reconstruct_limit(scheme)
    for size, what in ((t, "privacy"), (R, "reconstruction")):
        count = math.comb(n, size)
        if count > max_subsets:
            raise ValueError(
                f"{what} check needs {count} subsets > max_subsets={max_subsets}"
            )
    for subset in itertools.combinations(range(n), t):
        if _mod_rank(S[list(subset), k:], p) != t:
            raise ValueError(
                f"t-privacy violated: share rows {subset} are not fully "
                f"randomized (rank < {t}) — {t} colluding clerks could "
                f"learn about the secrets"
            )
    for subset in itertools.combinations(range(n), R):
        if _mod_rank(S[list(subset), :], p) != k + t:
            raise ValueError(
                f"reconstruction violated: share rows {subset} do not "
                f"determine the secrets (rank < {k + t})"
            )
