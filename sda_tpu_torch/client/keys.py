"""Signed-encryption-key fetch + verification, shared by the client roles
(copy of ``sda_tpu/client/keys.py``).

Participants verify each clerk's key before sealing shares to it (the SDA
client's participate.rs:82-101) and clerks verify the recipient's key
before sealing the combined vector (clerk.rs:88-100) — the same
fetch/verify sequence, so it lives once here.
"""

from __future__ import annotations

from ..crypto import signing


class VerifiedKeys:
    """Mixin: ``_fetch_verified_key`` with a per-client cache."""

    #: verified-key cache bound (committee + recipient keys are few; the
    #: cap only matters for a client touching thousands of aggregations)
    _VERIFIED_KEY_CACHE_MAX = 4096

    def _fetch_verified_key(self, agent_id, key_id):
        """Fetch a signed encryption key + its owner, verify the signature.

        Successfully verified keys are cached per client: a key id names
        immutable content (create-if-identical store semantics), so a
        multi-round participant or clerk daemon pays the two fetches and
        the Ed25519 verify once per key, not once per participation/job.
        Failures are never cached."""
        cache = getattr(self, "_verified_keys", None)
        if cache is None:
            cache = self._verified_keys = {}
        hit = cache.get((agent_id, key_id))
        if hit is not None:
            return hit
        signed_key = self.service.get_encryption_key(self.agent, key_id)
        if signed_key is None:
            raise ValueError("Unknown encryption key")
        owner = self.service.get_agent(self.agent, agent_id)
        if owner is None:
            raise ValueError("Unknown agent")
        if not signing.signature_is_valid(owner, signed_key):
            raise ValueError("Signature verification failed for key")
        if len(cache) >= self._VERIFIED_KEY_CACHE_MAX:
            cache.clear()
        key_body = signed_key.body.body  # the EncryptionKey
        cache[(agent_id, key_id)] = key_body
        return key_body
