"""Wire-format helpers: fixed byte arrays, binary blobs, Signed/Labelled
(copy of ``sda_tpu/protocol/helpers.py``).

Wire parity notes (with the original SDA protocol's serde output):
- ``B8``/``B32``/``B64`` fixed-size byte arrays serialize as standard base64
  with padding (protocol/src/byte_arrays.rs:3-99).
- ``Binary`` is a variable-size base64 blob (protocol/src/helpers.rs:176-216).
- ``Signed<M>`` carries ``signature``, ``signer``, ``body`` in that field
  order (helpers.rs:99-107); ``Labelled<ID, M>`` carries ``id``, ``body``
  (helpers.rs:146-152). Field order matters because the canonical signing
  bytes are defined as the compact JSON encoding of the object
  (helpers.rs:130-142) — we pin the same order and separators.
"""

from __future__ import annotations

import base64
import json


def canonical_bytes(obj) -> bytes:
    """Canonical signing bytes: the compact JSON encoding of the object.

    Matches the SDA protocol's rule ``Sign::canonical = serde_json::to_vec``
    (protocol/src/helpers.rs:138-142): field order is declaration order,
    no whitespace. Accepts either a wire object (with ``to_json``) or an
    already-plain JSON value.
    """
    payload = obj.to_json() if hasattr(obj, "to_json") else obj
    return json.dumps(payload, separators=(",", ":"), ensure_ascii=False).encode("utf-8")


class FixedBytes:
    """Fixed-length byte array; wire form is padded standard base64."""

    SIZE = 0
    __slots__ = ("data",)

    def __init__(self, data: bytes | None = None):
        if data is None:
            data = bytes(self.SIZE)
        data = bytes(data)
        if len(data) != self.SIZE:
            raise ValueError(f"{type(self).__name__} expects {self.SIZE} bytes, got {len(data)}")
        self.data = data

    def to_json(self) -> str:
        return base64.b64encode(self.data).decode("ascii")

    @classmethod
    def from_json(cls, obj):
        if not isinstance(obj, str):
            raise ValueError(f"expected base64 string, got {obj!r}")
        return cls(base64.b64decode(obj, validate=True))

    def __bytes__(self) -> bytes:
        return self.data

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other.data == self.data

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.data))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.data.hex()})"


class B8(FixedBytes):
    SIZE = 8


class B32(FixedBytes):
    SIZE = 32


class B64(FixedBytes):
    SIZE = 64


class Binary:
    """Variable-length binary blob; wire form is padded standard base64."""

    __slots__ = ("data",)

    def __init__(self, data: bytes = b""):
        self.data = bytes(data)

    def to_json(self) -> str:
        return base64.b64encode(self.data).decode("ascii")

    @classmethod
    def from_json(cls, obj):
        if not isinstance(obj, str):
            raise ValueError(f"expected base64 string, got {obj!r}")
        return cls(base64.b64decode(obj, validate=True))

    def __bytes__(self) -> bytes:
        return self.data

    def __len__(self) -> int:
        return len(self.data)

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other.data == self.data

    def __hash__(self) -> int:
        return hash(("Binary", self.data))

    def __repr__(self) -> str:
        preview = self.data[:8].hex()
        return f"Binary({len(self.data)}B:{preview}...)"


class Labelled:
    """A message labelled by an identifier: ``{id, body}``."""

    __slots__ = ("id", "body")

    def __init__(self, id, body):
        self.id = id
        self.body = body

    def to_json(self):
        return {"id": self.id.to_json(), "body": self.body.to_json()}

    @classmethod
    def from_json(cls, obj, id_cls, body_cls):
        return cls(id=id_cls.from_json(obj["id"]), body=body_cls.from_json(obj["body"]))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Labelled) and other.id == self.id and other.body == self.body
        )

    def __hash__(self) -> int:
        return hash(("Labelled", self.id, self.body))

    def __repr__(self) -> str:
        return f"Labelled(id={self.id!r}, body={self.body!r})"


class Signed:
    """A signed message with claimed signer: ``{signature, signer, body}``.

    The signature covers ``canonical_bytes(body)``.
    """

    __slots__ = ("signature", "signer", "body")

    def __init__(self, signature, signer, body):
        self.signature = signature
        self.signer = signer
        self.body = body

    def to_json(self):
        return {
            "signature": self.signature.to_json(),
            "signer": self.signer.to_json(),
            "body": self.body.to_json(),
        }

    @classmethod
    def from_json(cls, obj, body_from_json):
        from .schemes import Signature
        from .ids import AgentId

        return cls(
            signature=Signature.from_json(obj["signature"]),
            signer=AgentId.from_json(obj["signer"]),
            body=body_from_json(obj["body"]),
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Signed)
            and other.signature == self.signature
            and other.signer == self.signer
            and other.body == self.body
        )

    def __repr__(self) -> str:
        return f"Signed(signer={self.signer!r}, body={self.body!r})"
