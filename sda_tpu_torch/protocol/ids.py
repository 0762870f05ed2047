"""Typed unique identifiers (copy of ``sda_tpu/protocol/ids.py``).

One id newtype per resource, as the original SDA protocol's ``uuid_id!``
macro makes them; ids serialize as hyphenated uuid strings. We keep one small Python class per id type so type confusion
(e.g. passing an AgentId where a SnapshotId is expected) stays a visible bug
rather than a silent one, and so the wire format is pinned.
"""

from __future__ import annotations

import uuid


class TypedId:
    """A uuid wrapper with nominal typing; wire form is the hyphenated string."""

    __slots__ = ("uuid", "_hash")

    def __init__(self, value=None):
        if value is None:
            self.uuid = uuid.uuid4()
        elif isinstance(value, uuid.UUID):
            self.uuid = value
        elif isinstance(value, TypedId):
            if type(value) is not type(self):
                raise TypeError(f"cannot build {type(self).__name__} from {type(value).__name__}")
            self.uuid = value.uuid
        elif isinstance(value, str):
            try:
                self.uuid = uuid.UUID(value)
            except ValueError:
                raise ValueError(f"unparseable uuid {value}")
        else:
            raise TypeError(f"cannot build {type(self).__name__} from {value!r}")

    @classmethod
    def random(cls):
        return cls(uuid.uuid4())

    @classmethod
    def _from_uuid_bytes(cls, raw: bytes):
        """Trusted bulk-decode path: build from 16 raw big-endian bytes,
        bypassing the dispatching constructor and ``uuid.UUID.__init__``
        (both hot when a binary wire frame carries thousands of id
        columns). Callers must guarantee ``len(raw) == 16``."""
        u = object.__new__(uuid.UUID)
        object.__setattr__(u, "int", int.from_bytes(raw, "big"))
        object.__setattr__(u, "is_safe", uuid.SafeUUID.unknown)
        self = object.__new__(cls)
        self.uuid = u
        return self

    @classmethod
    def from_str(cls, s: str):
        return cls(s)

    def to_json(self) -> str:
        return str(self.uuid)

    @classmethod
    def from_json(cls, obj):
        if not isinstance(obj, str):
            raise ValueError(f"expected hyphenated uuid string, got {obj!r}")
        return cls(obj)

    def __str__(self) -> str:
        return str(self.uuid)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({str(self.uuid)!r})"

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other.uuid.int == self.uuid.int

    def __hash__(self) -> int:
        # Ids are immutable and hashed constantly as store keys; cache the
        # hash on first use rather than re-deriving the tuple each lookup.
        try:
            return self._hash
        except AttributeError:
            h = hash((type(self).__name__, self.uuid))
            self._hash = h
            return h


class AgentId(TypedId):
    """Unique agent identifier (resources.rs:19)."""


class VerificationKeyId(TypedId):
    """Unique verification key identifier (resources.rs:3)."""


class EncryptionKeyId(TypedId):
    """Unique encryption key identifier (resources.rs:37)."""


class AggregationId(TypedId):
    """Unique aggregation identifier (resources.rs:69)."""


class ParticipationId(TypedId):
    """Unique participation identifier (resources.rs:110)."""


class SnapshotId(TypedId):
    """Unique snapshot identifier (resources.rs:123)."""


class ClerkingJobId(TypedId):
    """Unique clerking job identifier (resources.rs:141)."""
