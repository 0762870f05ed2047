"""Packed Paillier cryptosystem: additively homomorphic encryption
(counterpart of ``sda_tpu/ops/paillier.py``).

The reference names Paillier as its scale-up path ("scale up the system
to any number of participants", README.md "Doing more") and sketches the
scheme enum (protocol/src/crypto.rs:164-174) but ships no implementation.
This module is the working core: textbook Paillier over n = p*q with
g = n+1, plus the *packing* layer the sketch describes — many bounded
values packed into one plaintext at fixed component offsets, so one
~2048-bit ciphertext carries ``component_count`` values and ciphertext
multiplication adds ALL of them at once.

Why it matters here: with masks Paillier-encrypted to the recipient, the
*server* multiplies all participants' ciphertexts together (it learns
nothing — it has no private key) and hands the recipient ONE ciphertext
per component block; recipient mask work becomes O(dim), independent of
the participant count.

Bounds discipline (the sketch's fields): each component holds values
< 2^max_value_bitsize in a fresh ciphertext and is allocated
component_bitsize bits, so up to ``2^(component_bitsize -
max_value_bitsize)`` ciphertexts may be added before a component could
carry into its neighbor — enforced by callers via ``additions_capacity``.

Constant time is NOT a goal — the threat model matches the reference's:
honest-but-curious server, no timing channel to the key holder's own
decryption. Modexps run in the native layer's Montgomery C
(``native.mod_exp``; ``encrypt_vector`` and ``decrypt_vector`` make one
``native.mod_exp_batch`` call for all their blocks, split over a pthread
pool), where ``sda_tpu`` calls OpenSSL's ``BN_mod_exp``; the port loads no
shared library for its crypto, and the two give the same integers. There
is no fallback: when the native layer cannot build, Paillier raises.
Products stay ``a * b % n`` on Python integers. This is host work: no
kernel runs here. Key generation uses OS entropy with Miller-Rabin
primality testing.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from .. import native
from .params import is_prime

_mod_exp = native.mod_exp


def _mod_mul(a: int, b: int, mod: int) -> int:
    return a * b % mod


def _random_prime(bits: int) -> int:
    """Uniform-ish prime with the top two bits set (so p*q has 2*bits)."""
    while True:
        cand = secrets.randbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
        if is_prime(cand):
            return cand


@dataclass(frozen=True)
class PaillierPublicKey:
    n: int

    @property
    def n_sq(self) -> int:
        return self.n * self.n


@dataclass(frozen=True)
class PaillierPrivateKey:
    n: int
    lam: int  # lcm(p-1, q-1)
    mu: int  # (L(g^lam mod n^2))^-1 mod n


def keygen(modulus_bits: int = 2048):
    """-> (PaillierPublicKey, PaillierPrivateKey); ``modulus_bits`` is the
    size of n = p*q. 2048 for real use; tests use smaller for speed."""
    half = modulus_bits // 2
    while True:
        p = _random_prime(half)
        q = _random_prime(half)
        if p != q:
            break
    n = p * q
    lam = (p - 1) * (q - 1) // _gcd(p - 1, q - 1)  # lcm
    n_sq = n * n
    # g = n+1: g^lam mod n^2 = 1 + lam*n (binomial), L(.) = lam mod n
    mu = pow(lam % n, -1, n)
    return PaillierPublicKey(n), PaillierPrivateKey(n, lam, mu)


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def _random_unit(n: int) -> int:
    """r uniform in [1, n) and coprime to n."""
    while True:
        r = secrets.randbelow(n)
        if r and _gcd(r, n) == 1:
            return r


def _check_plaintext(pk: PaillierPublicKey, m: int) -> None:
    if not 0 <= m < pk.n:
        raise ValueError("plaintext out of range [0, n)")


def _with_noise(pk: PaillierPublicKey, m: int, rn: int) -> int:
    """(1+n)^m * r^n mod n^2 from r^n mod n^2 (with (1+n)^m = 1 + m*n)."""
    return _mod_mul((1 + m * pk.n) % pk.n_sq, rn, pk.n_sq)


def encrypt(pk: PaillierPublicKey, m: int, r: int | None = None) -> int:
    """E(m) = (1+n)^m * r^n mod n^2 (with (1+n)^m = 1 + m*n mod n^2)."""
    _check_plaintext(pk, m)
    if r is None:
        r = _random_unit(pk.n)
    return _with_noise(pk, m, _mod_exp(r, pk.n, pk.n_sq))


def add(pk: PaillierPublicKey, c1: int, c2: int) -> int:
    """E(m1) (*) E(m2) = E(m1 + m2 mod n)."""
    return _mod_mul(c1, c2, pk.n_sq)


def _check_ciphertext(sk: PaillierPrivateKey, c: int) -> None:
    if not 0 <= c < sk.n * sk.n:
        raise ValueError("ciphertext out of range")


def _plaintext(sk: PaillierPrivateKey, u: int) -> int:
    """m from u = c^lam mod n^2: L(u) * mu mod n."""
    return (u - 1) // sk.n * sk.mu % sk.n


def decrypt(sk: PaillierPrivateKey, c: int) -> int:
    _check_ciphertext(sk, c)
    return _plaintext(sk, _mod_exp(c, sk.lam, sk.n * sk.n))


# ---------------------------------------------------------------------------
# Packing: many bounded components per plaintext (the sketch's layout)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Packing:
    """Component layout of one plaintext (crypto.rs sketch fields)."""

    component_count: int
    component_bitsize: int
    max_value_bitsize: int

    def __post_init__(self):
        if self.max_value_bitsize > self.component_bitsize:
            raise ValueError("component values larger than their slots")

    @property
    def plaintext_bits(self) -> int:
        return self.component_count * self.component_bitsize

    @property
    def additions_capacity(self) -> int:
        """How many fresh ciphertexts may be summed before a component
        could overflow its slot and carry into its neighbor."""
        return 1 << (self.component_bitsize - self.max_value_bitsize)

    def fits(self, pk: PaillierPublicKey) -> bool:
        return self.plaintext_bits < pk.n.bit_length()

    def pack(self, values) -> int:
        if len(values) > self.component_count:
            raise ValueError("too many components")
        out = 0
        for i, v in enumerate(values):
            v = int(v)
            if not 0 <= v < (1 << self.max_value_bitsize):
                raise ValueError(
                    f"component {i} value {v} outside [0, 2^{self.max_value_bitsize})"
                )
            out |= v << (i * self.component_bitsize)
        return out

    def unpack(self, plaintext: int, count: int | None = None) -> list:
        count = self.component_count if count is None else count
        mask = (1 << self.component_bitsize) - 1
        return [
            (plaintext >> (i * self.component_bitsize)) & mask for i in range(count)
        ]


def encrypt_vector(pk: PaillierPublicKey, packing: Packing, values) -> list:
    """Pack + encrypt a value vector -> list of ciphertext ints
    (ceil(len/component_count) of them)."""
    if not packing.fits(pk):
        raise ValueError("packing does not fit the key's plaintext space")
    cc = packing.component_count
    plaintexts = [packing.pack(values[i : i + cc]) for i in range(0, len(values), cc)]
    for m in plaintexts:
        _check_plaintext(pk, m)
    # one r per block, drawn in block order as ``encrypt`` draws them, then
    # every r^n mod n^2 in one batch
    noise = native.mod_exp_batch([_random_unit(pk.n) for _ in plaintexts], pk.n, pk.n_sq)
    return [_with_noise(pk, m, rn) for m, rn in zip(plaintexts, noise)]


def add_vectors(pk: PaillierPublicKey, blocks_a: list, blocks_b: list) -> list:
    """Componentwise homomorphic sum of two encrypted vectors."""
    if len(blocks_a) != len(blocks_b):
        raise ValueError("mismatched ciphertext block counts")
    return [add(pk, a, b) for a, b in zip(blocks_a, blocks_b)]


def decrypt_vector(
    sk: PaillierPrivateKey, packing: Packing, blocks: list, length: int
) -> list:
    """Decrypt + unpack ciphertext blocks back to a ``length`` vector."""
    for c in blocks:
        _check_ciphertext(sk, c)
    out = []
    for u in native.mod_exp_batch(blocks, sk.lam, sk.n * sk.n):
        out.extend(packing.unpack(_plaintext(sk, u)))
    if len(out) < length:
        raise ValueError("ciphertext blocks shorter than requested length")
    return out[:length]
