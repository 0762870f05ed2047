"""File-based client store and keystore (copy of ``sda_tpu/crypto/keystore.py``,
Paillier keypairs included).

The SDA client's file store (client-store/src/file.rs): one JSON file per
object under a directory, plus the alias indirection (``alias -> id ->
object``, store.rs:11-40) the CLI uses to remember "the agent identity in
this directory". Built on the atomic ``JsonDir`` (private 0600/0700 permissions — these files hold
secret keys). The JSON is ``sda_tpu``'s, so a keystore directory written by
either package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..protocol import B32, PaillierEncryptionKey
from ..protocol.schemes import EncryptionKey, SigningKey, VerificationKey, _untag
from ..utils.jsondir import JsonDir


@dataclass
class DecryptionKey:
    """Sodium box secret key."""

    inner: B32

    def to_json(self):
        return {"Sodium": self.inner.to_json()}

    @classmethod
    def from_json(cls, obj):
        _, payload = _untag(obj, ("Sodium",))
        return cls(B32.from_json(payload))

    @property
    def data(self) -> bytes:
        return self.inner.data


@dataclass
class EncryptionKeypair:
    ek: EncryptionKey
    dk: DecryptionKey

    def to_json(self):
        return {"ek": self.ek.to_json(), "dk": self.dk.to_json()}

    @classmethod
    def from_json(cls, obj):
        dk = obj["dk"]
        if isinstance(dk, dict) and "Paillier" in dk:
            return PaillierKeypair.from_json(obj)
        return cls(
            ek=EncryptionKey.from_json(obj["ek"]), dk=DecryptionKey.from_json(obj["dk"])
        )


@dataclass
class PaillierKeypair:
    """Paillier keypair: public n, private (lam, mu) — the PackedPaillier
    extension's key material, stored alongside sodium pairs."""

    ek: "PaillierEncryptionKey"
    lam: int
    mu: int

    def to_json(self):
        return {
            "ek": self.ek.to_json(),
            "dk": {"Paillier": {"lam": str(self.lam), "mu": str(self.mu)}},
        }

    @classmethod
    def from_json(cls, obj):
        dk = obj["dk"]["Paillier"]
        return cls(
            ek=PaillierEncryptionKey.from_json(obj["ek"]),
            lam=int(dk["lam"]),
            mu=int(dk["mu"]),
        )


@dataclass
class SignatureKeypair:
    vk: VerificationKey
    sk: SigningKey

    def to_json(self):
        return {"vk": self.vk.to_json(), "sk": self.sk.to_json()}

    @classmethod
    def from_json(cls, obj):
        return cls(
            vk=VerificationKey.from_json(obj["vk"]), sk=SigningKey.from_json(obj["sk"])
        )


class Filebased:
    """One JSON file per object; safe for ids and aliases used here."""

    def __init__(self, path):
        self._dir = JsonDir(path)
        self.path = self._dir.path

    def put(self, id: str, obj) -> None:
        payload = obj.to_json() if hasattr(obj, "to_json") else obj
        self._dir.put(id, payload)

    def get(self, id: str, from_json=None):
        payload = self._dir.get(id)
        if payload is None:
            return None
        return from_json(payload) if from_json else payload

    def list_ids(self) -> list:
        return self._dir.list_ids()

    # alias indirection (client-store/src/store.rs:11-40)

    def put_aliased(self, alias: str, obj) -> None:
        ident = str(obj.id)
        self.put(ident, obj)
        self.put(f"alias-{alias}", {"id": ident})

    def get_aliased(self, alias: str, from_json=None):
        pointer = self.get(f"alias-{alias}")
        if pointer is None:
            return None
        return self.get(pointer["id"], from_json)


class Keystore(Filebased):
    """Keypair storage keyed by EncryptionKeyId / VerificationKeyId."""

    def put_encryption_keypair(self, key_id, pair: EncryptionKeypair) -> None:
        self.put(str(key_id), pair)

    def get_encryption_keypair(self, key_id) -> EncryptionKeypair | None:
        return self.get(str(key_id), EncryptionKeypair.from_json)

    def put_signature_keypair(self, key_id, pair: SignatureKeypair) -> None:
        self.put(str(key_id), pair)

    def get_signature_keypair(self, key_id) -> SignatureKeypair | None:
        return self.get(str(key_id), SignatureKeypair.from_json)
