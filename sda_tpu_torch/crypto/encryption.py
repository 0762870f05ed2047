"""Transport encryption of share vectors: sealed boxes over varints, and
Packed Paillier for the recipient's masks (counterpart of
``sda_tpu/crypto/encryption.py``).

Each share vector is zigzag-LEB128 encoded and sealed to the receiver's box
public key; decryption opens and decodes. Both halves run in the port's
native layer (``sda_tpu_torch.native``, C with no library behind it), as
the reference's run in ``sda_tpu.native`` over libsodium: the varints in
one call per vector, the seals and opens in batches split over a pthread
pool, and a committee's whole share matrix in one
``native.seal_participations`` call (one ephemeral key per participant,
comb-table scalar multiplications). A single ``encrypt`` or ``decrypt`` is
a batch of one. ``crypto/sodium.py`` and ``crypto/varint.py`` are the plain
versions the tests hold the layer against.

Packed Paillier (``ops/paillier.py``) encrypts nonnegative bounded vectors
to a Paillier key; its wire format, the server's homomorphic combine
(``combine_encryptions``) and the server's public well-formedness check are
``sda_tpu``'s, byte for byte. Its modexps run in the native layer's
Montgomery C, one batch per vector.

Key generation (``generate_encryption_keypair``) runs in the native layer
too, in constant time.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..ops import paillier
from ..protocol import (
    B32,
    Binary,
    Encryption,
    EncryptionKey,
    PackedPaillierEncryptionScheme,
    PaillierEncryptionKey,
    SodiumEncryptionScheme,
)
from ..utils import workpool
from . import sodium
from .keystore import DecryptionKey, EncryptionKeypair


class ShareEncryptor:
    def encrypt(self, shares: np.ndarray) -> Encryption:
        raise NotImplementedError


class ShareDecryptor:
    def decrypt(self, encryption: Encryption) -> np.ndarray:
        raise NotImplementedError

    def decrypt_batch(self, encryptions) -> list:
        """Default batch: a plain loop (sodium overrides with one native
        batched call)."""
        return [self.decrypt(e) for e in encryptions]


class SodiumEncryptor(ShareEncryptor):
    def __init__(self, ek: EncryptionKey):
        self.pk = ek.data

    def encrypt(self, shares):
        encoded = native.varint_encode(np.asarray(shares, dtype=np.int64))
        return Encryption(Binary(native.seal_batch([encoded], self.pk)[0]))

    def encrypt_batch(self, share_vectors) -> list:
        """Seal many share vectors in one native batch call, split across
        the shared worker pool when ``SDA_WORKERS`` > 1."""
        encoded = [native.varint_encode(np.asarray(v, dtype=np.int64)) for v in share_vectors]
        cts = workpool.map_items(
            "seal",
            encoded,
            lambda sub, nt: native.seal_batch(sub, self.pk, n_threads=nt),
        )
        return [Encryption(Binary(ct)) for ct in cts]


class SodiumDecryptor(ShareDecryptor):
    def __init__(self, keypair: EncryptionKeypair):
        self.pk = keypair.ek.data
        self.sk = keypair.dk.data

    def decrypt(self, encryption):
        return self.decrypt_batch([encryption])[0]

    def decrypt_batch(self, encryptions) -> list:
        """Open many sealed boxes in one native batch call (the clerk-side
        per-participant loop, clerk.rs:79-82)."""
        for e in encryptions:
            if e.variant != "Sodium":
                raise ValueError(f"sodium decryptor got a {e.variant} ciphertext")
        raws = workpool.map_items(
            "open",
            [bytes(e.inner) for e in encryptions],
            lambda sub, nt: native.open_batch(sub, self.pk, self.sk, n_threads=nt),
        )
        return [native.varint_decode(r) for r in raws]


def encrypt_share_matrix(clerk_keys, scheme, share_rows) -> list:
    """Seal a whole committee's share matrix in one engine call.

    ``share_rows`` is a list over participants of ``(n_clerks, dim)`` share
    arrays; the result is a list over participants of per-clerk
    ``Encryption`` lists (``result[p][c]`` sealed to ``clerk_keys[c]``).

    For the sodium scheme the full ``P x C`` matrix goes through
    ``native.seal_participations``: one ephemeral keypair per participant
    shared across its clerk boxes, comb-table scalar multiplications, and
    standard sealed boxes out. Other schemes take the per-clerk encryptor
    loop."""
    n_clerks = len(clerk_keys)
    if isinstance(scheme, SodiumEncryptionScheme):
        matrix = [
            [
                native.varint_encode(np.asarray(row[c], dtype=np.int64))
                for c in range(n_clerks)
            ]
            for row in share_rows
        ]
        pks = [ek.data for ek in clerk_keys]
        sealed = workpool.map_items(
            "share_matrix",
            matrix,
            lambda sub, nt: native.seal_participations(sub, pks, n_threads=nt),
        )
        return [[Encryption(Binary(ct)) for ct in prow] for prow in sealed]
    encryptors = [new_share_encryptor(ek, scheme) for ek in clerk_keys]
    return [
        [enc.encrypt(row[c]) for c, enc in enumerate(encryptors)]
        for row in share_rows
    ]


def generate_encryption_keypair() -> EncryptionKeypair:
    """A box keypair from the native layer's constant-time comb (libsodium's
    ``crypto_box_keypair``; ``sodium.box_keypair`` is its plain version)."""
    pk, sk = native.box_keypair()
    return EncryptionKeypair(ek=EncryptionKey(B32(pk)), dk=DecryptionKey(B32(sk)))


# -- Paillier wire format ----------------------------------------------------
# One Encryption (variant "Paillier"): 4-byte big-endian value count, then
# fixed-width big-endian ciphertext blocks (2 * key bytes each, c < n^2).
# The count header exists because block packing pads: padding must not
# change the vector length on the way back through decrypt. These three
# helpers are the single definition of that format — encryptor, decryptor,
# and the server-side combine all go through them.


def _paillier_block_bytes(n: int) -> int:
    return 2 * ((n.bit_length() + 7) // 8)


def _paillier_encode(blocks, count: int, block_bytes: int) -> "Encryption":
    raw = count.to_bytes(4, "big") + b"".join(
        c.to_bytes(block_bytes, "big") for c in blocks
    )
    return Encryption(Binary(raw), variant="Paillier")


def _paillier_decode(encryption, block_bytes: int):
    """-> (count, blocks). Validates the variant tag and block alignment."""
    if encryption.variant != "Paillier":
        raise ValueError(f"expected a Paillier ciphertext, got {encryption.variant}")
    raw = bytes(encryption.inner)
    count, raw = int.from_bytes(raw[:4], "big"), raw[4:]
    if len(raw) % block_bytes:
        raise ValueError("ciphertext length not a multiple of the block width")
    blocks = [
        int.from_bytes(raw[i : i + block_bytes], "big")
        for i in range(0, len(raw), block_bytes)
    ]
    return count, blocks


class PaillierEncryptor(ShareEncryptor):
    """Packed-Paillier encryption of nonnegative bounded value vectors.

    Values must be canonical nonnegative residues below
    2^max_value_bitsize (the mask path guarantees this; shares can be
    negative and stay on sodium).
    """

    def __init__(self, ek: PaillierEncryptionKey, scheme: PackedPaillierEncryptionScheme):
        if not isinstance(ek, PaillierEncryptionKey):
            raise TypeError("PackedPaillier scheme requires a Paillier public key")
        if ek.n.bit_length() < scheme.min_modulus_bitsize:
            raise ValueError("Paillier key smaller than the scheme's minimum")
        self.pk = paillier.PaillierPublicKey(ek.n)
        self.packing = paillier.Packing(
            scheme.component_count, scheme.component_bitsize, scheme.max_value_bitsize
        )
        self.block_bytes = _paillier_block_bytes(ek.n)

    def encrypt(self, shares):
        values = [int(v) for v in np.asarray(shares, dtype=np.int64)]
        if any(v < 0 for v in values):
            raise ValueError("Paillier packing requires nonnegative values")
        blocks = paillier.encrypt_vector(self.pk, self.packing, values)
        return _paillier_encode(blocks, len(values), self.block_bytes)


class PaillierDecryptor(ShareDecryptor):
    def __init__(self, keypair, scheme: PackedPaillierEncryptionScheme):
        self.sk = paillier.PaillierPrivateKey(keypair.ek.n, keypair.lam, keypair.mu)
        self.packing = paillier.Packing(
            scheme.component_count, scheme.component_bitsize, scheme.max_value_bitsize
        )
        self.block_bytes = _paillier_block_bytes(keypair.ek.n)

    def decrypt(self, encryption):
        count, blocks = _paillier_decode(encryption, self.block_bytes)
        values = paillier.decrypt_vector(self.sk, self.packing, blocks, count)
        # component_bitsize <= 62 (scheme invariant): sums fit int64
        return np.asarray(values, dtype=np.int64)


def combine_encryptions(ek, scheme, encryptions: list) -> "Encryption":
    """Homomorphic server-side combine: product of ciphertext blocks ==
    encryption of the componentwise sum. Public-key only — callable by the
    untrusted server. All inputs must have identical block counts (same
    vector dimension), and the caller bounds how many are combined
    (scheme additions capacity)."""
    if not isinstance(ek, PaillierEncryptionKey):
        raise TypeError("combine requires a Paillier public key")
    pk = paillier.PaillierPublicKey(ek.n)
    block_bytes = _paillier_block_bytes(ek.n)

    combined, count0 = None, None
    for e in encryptions:
        count, b = _paillier_decode(e, block_bytes)
        if combined is None:
            combined, count0 = b, count
        else:
            if count != count0:
                raise ValueError("mismatched vector lengths in combine")
            combined = paillier.add_vectors(pk, combined, b)
    return _paillier_encode(combined, count0, block_bytes)


def paillier_ciphertext_well_formed(
    encryption, ek: PaillierEncryptionKey, scheme, expected_values: int | None
) -> bool:
    """Cheap *public* well-formedness check of one Paillier Encryption:
    variant tag, count header, block alignment, block count consistent with
    the packing, and every block in (0, n²). Lets the server reject
    malformed uploads at the participation door — where a garbage blob
    would otherwise surface only at snapshot-combine or recipient-decrypt
    time, after the participant's shares are already in the aggregate."""
    try:
        block_bytes = _paillier_block_bytes(ek.n)
        count, blocks = _paillier_decode(encryption, block_bytes)
    except ValueError:
        return False
    if expected_values is not None and count != expected_values:
        return False
    expected_blocks = -(-count // scheme.component_count) if count else 0
    if len(blocks) != expected_blocks:
        return False
    n_sq = ek.n * ek.n
    return all(0 < b < n_sq for b in blocks)


def generate_paillier_keypair(modulus_bits: int = 2048):
    """-> keystore.PaillierKeypair with fresh primes."""
    from .keystore import PaillierKeypair

    pk, sk = paillier.keygen(modulus_bits)
    return PaillierKeypair(ek=PaillierEncryptionKey(pk.n), lam=sk.lam, mu=sk.mu)


def new_share_encryptor(ek: EncryptionKey, scheme) -> ShareEncryptor:
    if isinstance(scheme, SodiumEncryptionScheme):
        return SodiumEncryptor(ek)
    if isinstance(scheme, PackedPaillierEncryptionScheme):
        return PaillierEncryptor(ek, scheme)
    raise TypeError(f"unknown encryption scheme {scheme!r}")


def new_share_decryptor(keypair: EncryptionKeypair, scheme) -> ShareDecryptor:
    if isinstance(scheme, SodiumEncryptionScheme):
        return SodiumDecryptor(keypair)
    if isinstance(scheme, PackedPaillierEncryptionScheme):
        return PaillierDecryptor(keypair, scheme)
    raise TypeError(f"unknown encryption scheme {scheme!r}")
