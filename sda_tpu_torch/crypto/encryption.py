"""Transport encryption of share vectors: sealed boxes over varints (counterpart
of ``sda_tpu/crypto/encryption.py``, sodium only).

Each share vector is zigzag-LEB128 encoded (``varint``) and sealed to the
receiver's box public key with the port's own ``sodium.seal``; decryption
opens and decodes. One ``seal`` or ``seal_open`` per share vector: the
reference's batched native route (``native.seal_participations``, one
ephemeral key per participant with comb-table scalar multiplications) is
not ported, and its pure-Python fallback, a per-box ``seal`` loop, is what
``encrypt_share_matrix`` does here. The Paillier scheme is not ported
either: asking for it raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from ..protocol import B32, Binary, Encryption, EncryptionKey, SodiumEncryptionScheme
from ..protocol.schemes import PAILLIER_NOT_PORTED
from . import sodium, varint
from .keystore import DecryptionKey, EncryptionKeypair


class ShareEncryptor:
    def encrypt(self, shares: np.ndarray) -> Encryption:
        raise NotImplementedError


class ShareDecryptor:
    def decrypt(self, encryption: Encryption) -> np.ndarray:
        raise NotImplementedError

    def decrypt_batch(self, encryptions) -> list:
        return [self.decrypt(e) for e in encryptions]


class SodiumEncryptor(ShareEncryptor):
    def __init__(self, ek: EncryptionKey):
        self.pk = ek.data

    def encrypt(self, shares):
        encoded = varint.encode_i64(np.asarray(shares, dtype=np.int64))
        return Encryption(Binary(sodium.seal(encoded, self.pk)))


class SodiumDecryptor(ShareDecryptor):
    def __init__(self, keypair: EncryptionKeypair):
        self.pk = keypair.ek.data
        self.sk = keypair.dk.data

    def decrypt(self, encryption):
        if encryption.variant != "Sodium":
            raise ValueError(f"sodium decryptor got a {encryption.variant} ciphertext")
        raw = sodium.seal_open(bytes(encryption.inner), self.pk, self.sk)
        return varint.decode_i64(raw)


def encrypt_share_matrix(clerk_keys, scheme, share_rows) -> list:
    """Seal a whole committee's share matrix.

    ``share_rows`` is a list over participants of ``(n_clerks, dim)`` share
    arrays; the result is a list over participants of per-clerk
    ``Encryption`` lists (``result[p][c]`` sealed to ``clerk_keys[c]``),
    one sealed box per share vector."""
    encryptors = [new_share_encryptor(ek, scheme) for ek in clerk_keys]
    return [
        [enc.encrypt(row[c]) for c, enc in enumerate(encryptors)]
        for row in share_rows
    ]


def generate_encryption_keypair() -> EncryptionKeypair:
    pk, sk = sodium.box_keypair()
    return EncryptionKeypair(ek=EncryptionKey(B32(pk)), dk=DecryptionKey(B32(sk)))


def new_share_encryptor(ek: EncryptionKey, scheme) -> ShareEncryptor:
    if isinstance(scheme, SodiumEncryptionScheme):
        return SodiumEncryptor(ek)
    raise NotImplementedError(f"{scheme!r}: {PAILLIER_NOT_PORTED}")


def new_share_decryptor(keypair: EncryptionKeypair, scheme) -> ShareDecryptor:
    if isinstance(scheme, SodiumEncryptionScheme):
        return SodiumDecryptor(keypair)
    raise NotImplementedError(f"{scheme!r}: {PAILLIER_NOT_PORTED}")
