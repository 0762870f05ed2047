"""Identity maintenance tasks (copy of ``sda_tpu/client/profile.py``)."""

from __future__ import annotations

from ..protocol import Profile


class Maintenance:
    """Upload agent identity and create/upload signed encryption keys."""

    def upload_agent(self) -> None:
        self.service.create_agent(self.agent, self.agent)

    def new_encryption_key(self):
        """Create a new encryption keypair in the keystore; returns its id."""
        return self.crypto.new_encryption_key()

    def new_paillier_encryption_key(self, modulus_bits: int = 2048):
        """Create a Paillier keypair in the keystore; returns its id."""
        return self.crypto.new_paillier_encryption_key(modulus_bits)

    def upload_encryption_key(self, key_id) -> None:
        """Sign the public key with the agent's signature key and upload."""
        signed = self.crypto.sign_encryption_key(self.agent, key_id)
        if signed is None:
            raise ValueError("Could not sign encryption key")
        self.service.create_encryption_key(self.agent, signed)

    def update_profile(self, *, name=None, twitter_id=None, keybase_id=None,
                       website=None):
        """Create/update the public profile linking this agent to external
        identities. Only the caller can write its own profile (server ACL).
        Uploads the FULL object — omitted fields unset (upsert semantics).
        Returns the stored Profile."""
        profile = Profile(
            owner=self.agent.id, name=name, twitter_id=twitter_id,
            keybase_id=keybase_id, website=website,
        )
        self.service.upsert_profile(self.agent, profile)
        return profile

    def get_profile(self, owner_id):
        """Fetch any agent's public profile (None when unset)."""
        return self.service.get_profile(self.agent, owner_id)
