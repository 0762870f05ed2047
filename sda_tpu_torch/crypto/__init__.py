"""Scheme implementations and the CryptoModule (counterpart of
``sda_tpu/crypto``).

The ``CryptoModule`` is the scheme-dispatch layer (the SDA client's
crypto/mod.rs): it owns the keystore and builds maskers, sharers,
encryptors and signers from the scheme descriptors carried on the
Aggregation resource. Sealed boxes and signatures come from the port's own
``sodium``, which binds no shared library. ``device`` is where a ChaCha
mask combine large enough for the device runs (CUDA unless the caller asks
for the CPU); everything else here is host work, as in the reference.
"""

from __future__ import annotations

from ..device import resolve_device
from ..protocol import Agent, EncryptionKeyId, Labelled, VerificationKeyId
from . import encryption, masking, sharing, signing
from .keystore import (
    DecryptionKey,
    EncryptionKeypair,
    Filebased,
    Keystore,
    SignatureKeypair,
)


class CryptoModule:
    """Keystore-backed factory for all per-scheme crypto operations."""

    def __init__(self, keystore: Keystore, device=None):
        self.keystore = keystore
        self.device = resolve_device(device)

    # -- key generation ------------------------------------------------------

    def new_encryption_key(self) -> EncryptionKeyId:
        """Generate + store a sodium box keypair; returns its id."""
        pair = encryption.generate_encryption_keypair()
        key_id = EncryptionKeyId.random()
        self.keystore.put_encryption_keypair(key_id, pair)
        return key_id

    def new_paillier_encryption_key(self, modulus_bits: int = 2048) -> EncryptionKeyId:
        """Generate + store a Paillier keypair (PackedPaillier extension);
        returns its id. 2048-bit modulus for real use."""
        pair = encryption.generate_paillier_keypair(modulus_bits)
        key_id = EncryptionKeyId.random()
        self.keystore.put_encryption_keypair(key_id, pair)
        return key_id

    def new_signature_key(self) -> Labelled:
        """Generate + store an Ed25519 keypair; returns Labelled[id, vk]."""
        pair = signing.generate_signature_keypair()
        key_id = VerificationKeyId.random()
        self.keystore.put_signature_keypair(key_id, pair)
        return Labelled(key_id, pair.vk)

    # -- masking -------------------------------------------------------------

    def new_secret_masker(self, scheme):
        return masking.new_secret_masker(scheme, self.device)

    def new_mask_combiner(self, scheme):
        return masking.new_mask_combiner(scheme, self.device)

    def new_secret_unmasker(self, scheme):
        return masking.new_secret_unmasker(scheme, self.device)

    # -- sharing -------------------------------------------------------------

    def new_share_generator(self, scheme):
        return sharing.new_share_generator(scheme)

    def new_share_combiner(self, scheme):
        return sharing.new_share_combiner(scheme)

    def new_secret_reconstructor(self, scheme, dimension: int):
        return sharing.new_secret_reconstructor(scheme, dimension)

    # -- transport encryption ------------------------------------------------

    def new_share_encryptor(self, ek, scheme):
        return encryption.new_share_encryptor(ek, scheme)

    def encrypt_share_matrix(self, clerk_keys, scheme, share_rows):
        """Committee-wide sealing; see encryption.encrypt_share_matrix."""
        return encryption.encrypt_share_matrix(clerk_keys, scheme, share_rows)

    def new_share_decryptor(self, key_id: EncryptionKeyId, scheme):
        pair = self.keystore.get_encryption_keypair(key_id)
        if pair is None:
            raise KeyError(f"no keypair for {key_id} in keystore")
        return encryption.new_share_decryptor(pair, scheme)

    # -- signing -------------------------------------------------------------

    def sign_encryption_key(self, signer: Agent, key_id: EncryptionKeyId):
        """Export the stored public key as a Signed Labelled EncryptionKey."""
        pair = self.keystore.get_encryption_keypair(key_id)
        if pair is None:
            return None
        sig_pair = self.keystore.get_signature_keypair(signer.verification_key.id)
        if sig_pair is None:
            return None
        body = Labelled(key_id, pair.ek)
        return signing.sign(body, signer.id, sig_pair)


__all__ = [
    "CryptoModule",
    "Keystore",
    "Filebased",
    "EncryptionKeypair",
    "SignatureKeypair",
    "DecryptionKey",
    "encryption",
    "masking",
    "sharing",
    "signing",
]
