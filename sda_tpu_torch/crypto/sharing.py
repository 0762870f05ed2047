"""Secret sharing: additive and (basic or packed) Shamir, with batching
semantics (copy of ``sda_tpu/crypto/sharing.py`` over the port's numpy
helpers in ``ops/shamir.py`` and ``ops/modular.py``).

A ``ShareGenerator`` turns a dim-length secret vector into one share-vector
per clerk; the ``Combiner`` sums share-vectors mod m (the clerk hot loop); a
``SecretReconstructor`` rebuilds the dim-length vector from indexed clerk
results. All of it is host work, as in the reference.

Batching semantics match the SDA client's batched.rs:30-49: the dim axis is
chopped into ``input_size``-sized batches, the last batch zero-padded,
shares transposed per clerk, and reconstruction truncates the pad — as one
(batches, k) reshape + one mod-p matmul over the whole tensor.
"""

from __future__ import annotations

import numpy as np

from ..ops import shamir
from ..ops.modular import MAX_SAFE_MODULUS, mod_sum_wide_np, rust_rem_np
from ..ops.rng import uniform_mod_host
from ..protocol import AdditiveSharing, BasicShamirSharing, PackedShamirSharing


class ShareGenerator:
    def generate(self, secrets: np.ndarray) -> np.ndarray:
        """(dim,) secrets -> (share_count, per_clerk_len) shares."""
        raise NotImplementedError


class ShareCombiner:
    def combine(self, share_vectors) -> np.ndarray:
        raise NotImplementedError


class SecretReconstructor:
    def reconstruct(self, indexed_shares) -> np.ndarray:
        """[(clerk_index, share_vector), ...] -> (dim,) secrets."""
        raise NotImplementedError


def _batched(secrets: np.ndarray, input_size: int) -> np.ndarray:
    """Chop (dim,) into (n_batches, input_size), zero-padding the tail."""
    secrets = np.asarray(secrets, dtype=np.int64)
    dim = len(secrets)
    n_batches = (dim + input_size - 1) // input_size
    padded = np.zeros(n_batches * input_size, dtype=np.int64)
    padded[:dim] = secrets
    return padded.reshape(n_batches, input_size)


class AdditiveShareGenerator(ShareGenerator):
    """n-of-n additive sharing (sharing/additive.rs:42-48).

    The reference's per-element fold ``last = (last - share) % m`` over
    uniform draws reduces (proven in the truncated-remainder algebra) to
    ``last = rust_rem(secret - sum(draws), m)`` — one vectorized line.
    """

    def __init__(self, share_count: int, modulus: int):
        self.share_count = share_count
        self.modulus = modulus

    def generate(self, secrets):
        secrets = np.asarray(secrets, dtype=np.int64)
        dim = len(secrets)
        draws = uniform_mod_host((self.share_count - 1, dim), self.modulus)
        total = mod_sum_wide_np(draws, self.modulus, axis=0)
        last = rust_rem_np(secrets - total, self.modulus)
        return np.concatenate([draws, last[None, :]], axis=0)


class PackedShamirShareGenerator(ShareGenerator):
    """Shamir sharing (packed or basic) as one batched mod-p matmul
    (ops/shamir.py) — both schemes are linear maps; only the matrix and
    batch width (``input_size``: k for packed, 1 for basic) differ."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.S = shamir.share_matrix(scheme)

    def generate(self, secrets):
        k = self.scheme.input_size
        t = self.scheme.privacy_threshold
        p = self.scheme.prime_modulus
        batches = _batched(secrets, k)  # (B, k)
        randomness = uniform_mod_host((batches.shape[0], t), p)
        shares = shamir.share_batches(batches, randomness, self.S, p)  # (B, n)
        return shares.T.copy()  # (share_count, B): one row per clerk


class Combiner(ShareCombiner):
    """Scheme-independent modular sum over participants (combiner.rs:16-30).

    int64 accumulate then a single truncated reduction — congruent to the
    reference's per-add ``+=; %=`` chain and identical after ``positive()``.
    """

    def __init__(self, modulus: int):
        self.modulus = modulus

    def combine(self, share_vectors):
        if not len(share_vectors):
            # empty snapshot cut: the reference yields the empty vector
            # (combiner.rs:17 — `map_or(0, Vec::len)` defaults the
            # dimension to 0 when there are no shares)
            return np.empty(0, dtype=np.int64)
        stack = np.stack([np.asarray(v, dtype=np.int64) for v in share_vectors])
        if self.modulus < MAX_SAFE_MODULUS and len(stack) < (1 << 32):
            return rust_rem_np(stack.sum(axis=0), self.modulus)
        return mod_sum_wide_np(stack, self.modulus, axis=0)


class AdditiveReconstructor(SecretReconstructor):
    def __init__(self, modulus: int):
        self.modulus = modulus

    def reconstruct(self, indexed_shares):
        stack = np.stack([np.asarray(v, dtype=np.int64) for _, v in indexed_shares])
        return mod_sum_wide_np(stack, self.modulus, axis=0)


class PackedShamirReconstructor(SecretReconstructor):
    """Gather surviving clerk rows, Lagrange-interpolate, truncate pad.

    Works from any ``reconstruction_threshold`` indexed shares — the
    dropout-recovery path (reference receive.rs:127-145, batched.rs:68-98).
    """

    def __init__(self, scheme, dimension: int):
        self.scheme = scheme
        self.dimension = dimension

    def reconstruct(self, indexed_shares):
        p = self.scheme.prime_modulus
        indices = [i for i, _ in indexed_shares]
        L = shamir.reconstruction_matrix(self.scheme, indices)  # (k, R)
        shares = np.stack(
            [np.asarray(v, dtype=np.int64) for _, v in indexed_shares]
        )  # (R, B)
        secrets = shamir.reconstruct_batches(shares.T, L, p)  # (B, k)
        return secrets.reshape(-1)[: self.dimension].copy()


def new_share_generator(scheme) -> ShareGenerator:
    if isinstance(scheme, AdditiveSharing):
        return AdditiveShareGenerator(scheme.share_count, scheme.modulus)
    if isinstance(scheme, (BasicShamirSharing, PackedShamirSharing)):
        return PackedShamirShareGenerator(scheme)
    raise TypeError(f"unknown sharing scheme {scheme!r}")


def new_share_combiner(scheme) -> ShareCombiner:
    if isinstance(scheme, AdditiveSharing):
        return Combiner(scheme.modulus)
    if isinstance(scheme, (BasicShamirSharing, PackedShamirSharing)):
        return Combiner(scheme.prime_modulus)
    raise TypeError(f"unknown sharing scheme {scheme!r}")


def new_secret_reconstructor(scheme, dimension: int) -> SecretReconstructor:
    if isinstance(scheme, AdditiveSharing):
        return AdditiveReconstructor(scheme.modulus)
    if isinstance(scheme, (BasicShamirSharing, PackedShamirSharing)):
        return PackedShamirReconstructor(scheme, dimension)
    raise TypeError(f"unknown sharing scheme {scheme!r}")
