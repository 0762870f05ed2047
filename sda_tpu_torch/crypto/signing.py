"""Ed25519 signing of labelled encryption keys (copy of
``sda_tpu/crypto/signing.py``): keypairs and signatures in the port's native
C, in constant time (libsodium's ``crypto_sign_keypair`` and
``crypto_sign_detached`` in the reference); verification, which is public,
in the port's own ``sodium``.

Parity with the SDA client's crypto/signing/mod.rs: detached
Ed25519 over the canonical JSON bytes of ``Labelled<EncryptionKeyId,
EncryptionKey>``; verification additionally checks the claimed signer is the
agent whose verification key is used (signing/mod.rs:113).
"""

from __future__ import annotations

from ..protocol import (
    B32,
    B64,
    Agent,
    Signature,
    Signed,
    SigningKey,
    VerificationKey,
    canonical_bytes,
)
from .. import native
from . import sodium
from .keystore import SignatureKeypair


def generate_signature_keypair() -> SignatureKeypair:
    vk, sk = native.sign_keypair()
    return SignatureKeypair(vk=VerificationKey(B32(vk)), sk=SigningKey(B64(sk)))


def sign(body, signer_id, keypair: SignatureKeypair) -> Signed:
    """Sign ``body`` (any wire object) with the agent's signing key."""
    sig = native.sign_detached(canonical_bytes(body), keypair.sk.data)
    return Signed(signature=Signature(B64(sig)), signer=signer_id, body=body)


def signature_is_valid(agent: Agent, signed: Signed) -> bool:
    """Verify a Signed object against the agent's verification key."""
    if signed.signer != agent.id:
        raise ValueError("Agent differs from claimed signer")
    return sodium.verify_detached(
        signed.signature.data,
        canonical_bytes(signed.body),
        agent.verification_key.body.data,
    )
