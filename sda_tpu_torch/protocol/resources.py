"""Protocol resources — the REST objects of the SDA wire contract (copy of
``sda_tpu/protocol/resources.py``).

Field names and order mirror the SDA protocol's resources.rs, so the JSON
wire format (and canonical signing bytes) match ``sda_tpu``'s byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .helpers import Labelled, Signed
from .ids import (
    AgentId,
    AggregationId,
    ClerkingJobId,
    EncryptionKeyId,
    ParticipationId,
    SnapshotId,
    VerificationKeyId,
)
from .schemes import (
    AdditiveEncryptionScheme,
    Encryption,
    EncryptionKey,
    LinearMaskingScheme,
    LinearSecretSharingScheme,
    VerificationKey,
)


def _opt(value, f):
    return None if value is None else f(value)


@dataclass
class Agent:
    """Fundamental agent description (resources.rs:12-17)."""

    id: AgentId
    verification_key: Labelled  # Labelled[VerificationKeyId, VerificationKey]

    def to_json(self):
        return {
            "id": self.id.to_json(),
            "verification_key": self.verification_key.to_json(),
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            id=AgentId.from_json(obj["id"]),
            verification_key=Labelled.from_json(
                obj["verification_key"], VerificationKeyId, VerificationKey
            ),
        )


@dataclass
class Profile:
    """Extended public profile of an agent (resources.rs:24-35)."""

    owner: AgentId
    name: Optional[str] = None
    twitter_id: Optional[str] = None
    keybase_id: Optional[str] = None
    website: Optional[str] = None

    def to_json(self):
        return {
            "owner": self.owner.to_json(),
            "name": self.name,
            "twitter_id": self.twitter_id,
            "keybase_id": self.keybase_id,
            "website": self.website,
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            owner=AgentId.from_json(obj["owner"]),
            name=obj.get("name"),
            twitter_id=obj.get("twitter_id"),
            keybase_id=obj.get("keybase_id"),
            website=obj.get("website"),
        )


def signed_encryption_key_from_json(obj) -> Signed:
    """SignedEncryptionKey = Signed<Labelled<EncryptionKeyId, EncryptionKey>>."""
    return Signed.from_json(
        obj, lambda body: Labelled.from_json(body, EncryptionKeyId, EncryptionKey)
    )


@dataclass
class Aggregation:
    """Description of an aggregation (resources.rs:44-67).

    ``sub_cohort_size`` / ``tiers`` are the hierarchical-plane extension
    (arXiv 2201.00864): a TIERED aggregation (``tiers >= 2``) partitions
    its participants into ``sub_cohort_size`` sub-cohorts per node by
    deterministic hash, each aggregated by its own sub-committee, with
    partial sums re-shared upward until the root committee reveals the
    exact total (``sda_tpu/protocol/tiers.py`` derives the whole tree
    from this one record). Both fields are emitted only when set, so FLAT
    aggregations — the default — keep the original ten-key wire shape and
    canonical signing bytes, byte for byte.
    """

    id: AggregationId
    title: str
    vector_dimension: int
    modulus: int
    recipient: AgentId
    recipient_key: EncryptionKeyId
    masking_scheme: LinearMaskingScheme
    committee_sharing_scheme: LinearSecretSharingScheme
    recipient_encryption_scheme: AdditiveEncryptionScheme
    committee_encryption_scheme: AdditiveEncryptionScheme
    sub_cohort_size: Optional[int] = None  # fan-out m per tiered node
    tiers: Optional[int] = None  # committee tiers; absent/1 = flat
    tier_parent: Optional[AggregationId] = None  # set on derived children
    tier_promotion: Optional[str] = None  # "reveal" | "reshare"; absent = auto

    def is_tiered(self) -> bool:
        return (self.tiers or 1) > 1

    def to_json(self):
        obj = {
            "id": self.id.to_json(),
            "title": self.title,
            "vector_dimension": self.vector_dimension,
            "modulus": self.modulus,
            "recipient": self.recipient.to_json(),
            "recipient_key": self.recipient_key.to_json(),
            "masking_scheme": self.masking_scheme.to_json(),
            "committee_sharing_scheme": self.committee_sharing_scheme.to_json(),
            "recipient_encryption_scheme": self.recipient_encryption_scheme.to_json(),
            "committee_encryption_scheme": self.committee_encryption_scheme.to_json(),
        }
        if self.sub_cohort_size is not None:
            obj["sub_cohort_size"] = self.sub_cohort_size
        if self.tiers is not None:
            obj["tiers"] = self.tiers
        if self.tier_parent is not None:
            obj["tier_parent"] = self.tier_parent.to_json()
        if self.tier_promotion is not None:
            obj["tier_promotion"] = self.tier_promotion
        return obj

    @classmethod
    def from_json(cls, obj):
        return cls(
            id=AggregationId.from_json(obj["id"]),
            title=obj["title"],
            vector_dimension=int(obj["vector_dimension"]),
            modulus=int(obj["modulus"]),
            recipient=AgentId.from_json(obj["recipient"]),
            recipient_key=EncryptionKeyId.from_json(obj["recipient_key"]),
            masking_scheme=LinearMaskingScheme.from_json(obj["masking_scheme"]),
            committee_sharing_scheme=LinearSecretSharingScheme.from_json(
                obj["committee_sharing_scheme"]
            ),
            recipient_encryption_scheme=AdditiveEncryptionScheme.from_json(
                obj["recipient_encryption_scheme"]
            ),
            committee_encryption_scheme=AdditiveEncryptionScheme.from_json(
                obj["committee_encryption_scheme"]
            ),
            sub_cohort_size=_opt(obj.get("sub_cohort_size"), int),
            tiers=_opt(obj.get("tiers"), int),
            tier_parent=_opt(obj.get("tier_parent"), AggregationId.from_json),
            tier_promotion=obj.get("tier_promotion"),
        )


@dataclass
class ClerkCandidate:
    """Suggested clerk for an aggregation (resources.rs:74-79)."""

    id: AgentId
    keys: list  # list[EncryptionKeyId]

    def to_json(self):
        return {"id": self.id.to_json(), "keys": [k.to_json() for k in self.keys]}

    @classmethod
    def from_json(cls, obj):
        return cls(
            id=AgentId.from_json(obj["id"]),
            keys=[EncryptionKeyId.from_json(k) for k in obj["keys"]],
        )


@dataclass
class Committee:
    """Committee elected for an aggregation (resources.rs:83-88)."""

    aggregation: AggregationId
    clerks_and_keys: list  # list[tuple[AgentId, EncryptionKeyId]]

    def to_json(self):
        return {
            "aggregation": self.aggregation.to_json(),
            "clerks_and_keys": [
                [a.to_json(), k.to_json()] for (a, k) in self.clerks_and_keys
            ],
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            aggregation=AggregationId.from_json(obj["aggregation"]),
            clerks_and_keys=[
                (AgentId.from_json(a), EncryptionKeyId.from_json(k))
                for (a, k) in obj["clerks_and_keys"]
            ],
        )


@dataclass
class TierReshare:
    """Share-promotion tag on a participation climbing the tier tree
    (arXiv 2201.00864: re-share shares upward, never reveal).

    ``position`` is the submitting clerk's 0-based seat in ``child``'s
    committee for a re-shared column row, or None for the mask-correction
    row the child's owner submits (which carries only the negated mask
    sum — data-independent, no aggregate content). ``survivors`` is the
    consistent 0-based seat set the Lagrange weights of this ``epoch``
    were computed over (None on mask rows). The tagged participation is
    otherwise an ordinary one — freshly masked, shared, and sealed for
    the PARENT aggregation — so flat records and parent-side clerking
    stay byte-unchanged."""

    child: AggregationId
    epoch: int
    position: Optional[int] = None
    survivors: Optional[list] = None  # list[int], sorted

    def to_json(self):
        obj = {"child": self.child.to_json(), "epoch": self.epoch}
        if self.position is not None:
            obj["position"] = self.position
        if self.survivors is not None:
            obj["survivors"] = [int(s) for s in self.survivors]
        return obj

    @classmethod
    def from_json(cls, obj):
        survivors = obj.get("survivors")
        return cls(
            child=AggregationId.from_json(obj["child"]),
            epoch=int(obj["epoch"]),
            position=_opt(obj.get("position"), int),
            survivors=None if survivors is None else [int(s) for s in survivors],
        )


@dataclass
class Participation:
    """A participant's input to an aggregation (resources.rs:92-108).

    ``id`` is client-chosen so retries are idempotent (resources.rs:93-101).
    ``tier_reshare`` marks a share-promotion row of the hierarchical plane
    and is emitted only when set, so flat participations keep the original
    five-key wire shape byte for byte.
    """

    id: ParticipationId
    participant: AgentId
    aggregation: AggregationId
    recipient_encryption: Optional[Encryption]
    clerk_encryptions: list  # list[tuple[AgentId, Encryption]]
    tier_reshare: Optional[TierReshare] = None

    def to_json(self):
        obj = {
            "id": self.id.to_json(),
            "participant": self.participant.to_json(),
            "aggregation": self.aggregation.to_json(),
            "recipient_encryption": _opt(self.recipient_encryption, lambda e: e.to_json()),
            "clerk_encryptions": [
                [a.to_json(), e.to_json()] for (a, e) in self.clerk_encryptions
            ],
        }
        if self.tier_reshare is not None:
            obj["tier_reshare"] = self.tier_reshare.to_json()
        return obj

    @classmethod
    def from_json(cls, obj):
        return cls(
            id=ParticipationId.from_json(obj["id"]),
            participant=AgentId.from_json(obj["participant"]),
            aggregation=AggregationId.from_json(obj["aggregation"]),
            recipient_encryption=_opt(obj.get("recipient_encryption"), Encryption.from_json),
            clerk_encryptions=[
                (AgentId.from_json(a), Encryption.from_json(e))
                for (a, e) in obj["clerk_encryptions"]
            ],
            tier_reshare=_opt(obj.get("tier_reshare"), TierReshare.from_json),
        )


@dataclass
class Snapshot:
    """A consistent cut over the participation stream (resources.rs:116-121)."""

    id: SnapshotId
    aggregation: AggregationId

    def to_json(self):
        return {"id": self.id.to_json(), "aggregation": self.aggregation.to_json()}

    @classmethod
    def from_json(cls, obj):
        return cls(
            id=SnapshotId.from_json(obj["id"]),
            aggregation=AggregationId.from_json(obj["aggregation"]),
        )


@dataclass
class ClerkingJob:
    """Partial aggregation job for one clerk (resources.rs:128-139).

    Jobs above the server's paging threshold are DELIVERED as metadata:
    ``encryptions`` empty, ``total_encryptions``/``chunk_size`` set, and
    the ciphertext column fetched range-by-range via
    ``GET /v1/aggregations/implied/jobs/{id}/chunks/{start}``. Small jobs
    keep the original five-key wire shape (both paging fields are emitted
    only when set), so pre-paging clients and transcripts stay byte
    compatible.
    """

    id: ClerkingJobId
    clerk: AgentId
    aggregation: AggregationId
    snapshot: SnapshotId
    encryptions: list  # list[Encryption], one per participant
    total_encryptions: Optional[int] = None  # paged delivery only
    chunk_size: Optional[int] = None  # server's suggested fetch range

    def is_paged(self) -> bool:
        return self.total_encryptions is not None

    def to_json(self):
        obj = {
            "id": self.id.to_json(),
            "clerk": self.clerk.to_json(),
            "aggregation": self.aggregation.to_json(),
            "snapshot": self.snapshot.to_json(),
            "encryptions": [e.to_json() for e in self.encryptions],
        }
        if self.total_encryptions is not None:
            obj["total_encryptions"] = self.total_encryptions
        if self.chunk_size is not None:
            obj["chunk_size"] = self.chunk_size
        return obj

    @classmethod
    def from_json(cls, obj):
        return cls(
            id=ClerkingJobId.from_json(obj["id"]),
            clerk=AgentId.from_json(obj["clerk"]),
            aggregation=AggregationId.from_json(obj["aggregation"]),
            snapshot=SnapshotId.from_json(obj["snapshot"]),
            encryptions=[Encryption.from_json(e) for e in obj["encryptions"]],
            total_encryptions=_opt(obj.get("total_encryptions"), int),
            chunk_size=_opt(obj.get("chunk_size"), int),
        )


@dataclass
class ClerkingResult:
    """Result of a clerking job (resources.rs:146-153)."""

    job: ClerkingJobId
    clerk: AgentId
    encryption: Encryption

    def to_json(self):
        return {
            "job": self.job.to_json(),
            "clerk": self.clerk.to_json(),
            "encryption": self.encryption.to_json(),
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            job=ClerkingJobId.from_json(obj["job"]),
            clerk=AgentId.from_json(obj["clerk"]),
            encryption=Encryption.from_json(obj["encryption"]),
        )


@dataclass
class SnapshotStatus:
    """Status of a snapshot (resources.rs:168-175)."""

    id: SnapshotId
    number_of_clerking_results: int
    result_ready: bool

    def to_json(self):
        return {
            "id": self.id.to_json(),
            "number_of_clerking_results": self.number_of_clerking_results,
            "result_ready": self.result_ready,
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            id=SnapshotId.from_json(obj["id"]),
            number_of_clerking_results=int(obj["number_of_clerking_results"]),
            result_ready=bool(obj["result_ready"]),
        )


@dataclass
class AggregationStatus:
    """Status of an aggregation (resources.rs:157-164)."""

    aggregation: AggregationId
    number_of_participations: int
    snapshots: list  # list[SnapshotStatus]

    def to_json(self):
        return {
            "aggregation": self.aggregation.to_json(),
            "number_of_participations": self.number_of_participations,
            "snapshots": [s.to_json() for s in self.snapshots],
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            aggregation=AggregationId.from_json(obj["aggregation"]),
            number_of_participations=int(obj["number_of_participations"]),
            snapshots=[SnapshotStatus.from_json(s) for s in obj["snapshots"]],
        )


@dataclass
class SnapshotResult:
    """Result of a snapshot, ready for reconstruction (resources.rs:179-188).

    Results above the server's paging threshold are DELIVERED as metadata:
    ``clerk_encryptions`` empty, ``recipient_encryptions`` None, and the
    three paging fields set; the recipient then streams both payloads
    range-by-range via
    ``GET .../snapshots/{id}/result/masks/{start}`` and
    ``GET .../snapshots/{id}/result/clerks/{start}``. Small results keep
    the original four-key wire shape (paging fields are emitted only when
    set), so pre-paging clients and transcripts stay byte compatible.
    ``mask_encryption_count`` is None in a paged result iff the snapshot
    stored no recipient mask (NoMasking) — mirroring the legacy
    ``recipient_encryptions`` None/list distinction.
    """

    snapshot: SnapshotId
    number_of_participations: int
    clerk_encryptions: list  # list[ClerkingResult]
    recipient_encryptions: Optional[list]  # Optional[list[Encryption]]
    mask_encryption_count: Optional[int] = None  # paged delivery only
    clerk_result_count: Optional[int] = None  # paged delivery only
    chunk_size: Optional[int] = None  # server's suggested fetch range

    def is_paged(self) -> bool:
        return self.clerk_result_count is not None

    def to_json(self):
        obj = {
            "snapshot": self.snapshot.to_json(),
            "number_of_participations": self.number_of_participations,
            "clerk_encryptions": [c.to_json() for c in self.clerk_encryptions],
            "recipient_encryptions": _opt(
                self.recipient_encryptions, lambda es: [e.to_json() for e in es]
            ),
        }
        if self.mask_encryption_count is not None:
            obj["mask_encryption_count"] = self.mask_encryption_count
        if self.clerk_result_count is not None:
            obj["clerk_result_count"] = self.clerk_result_count
        if self.chunk_size is not None:
            obj["chunk_size"] = self.chunk_size
        return obj

    @classmethod
    def from_json(cls, obj):
        recipient = obj.get("recipient_encryptions")
        return cls(
            snapshot=SnapshotId.from_json(obj["snapshot"]),
            number_of_participations=int(obj["number_of_participations"]),
            clerk_encryptions=[ClerkingResult.from_json(c) for c in obj["clerk_encryptions"]],
            recipient_encryptions=None
            if recipient is None
            else [Encryption.from_json(e) for e in recipient],
            mask_encryption_count=_opt(obj.get("mask_encryption_count"), int),
            clerk_result_count=_opt(obj.get("clerk_result_count"), int),
            chunk_size=_opt(obj.get("chunk_size"), int),
        )


@dataclass
class TierNodeStatus:
    """Status of one node of a tiered aggregation's derived tree.

    ``exists`` is False for a node whose sub-aggregation record was never
    provisioned (the topology is derived, not stored — see
    protocol/tiers.py); counts are zero for such nodes. ``result_ready``
    means at least one of the node's snapshots has collected enough clerk
    results to reconstruct."""

    aggregation: AggregationId
    tier: int
    parent: Optional[AggregationId]
    exists: bool
    number_of_participations: int
    result_ready: bool

    def to_json(self):
        return {
            "aggregation": self.aggregation.to_json(),
            "tier": self.tier,
            "parent": _opt(self.parent, lambda p: p.to_json()),
            "exists": self.exists,
            "number_of_participations": self.number_of_participations,
            "result_ready": self.result_ready,
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            aggregation=AggregationId.from_json(obj["aggregation"]),
            tier=int(obj["tier"]),
            parent=_opt(obj.get("parent"), AggregationId.from_json),
            exists=bool(obj["exists"]),
            number_of_participations=int(obj["number_of_participations"]),
            result_ready=bool(obj["result_ready"]),
        )


@dataclass
class TierStatus:
    """Per-node readiness of a tiered aggregation's whole derived tree,
    root first in breadth-first order (additive resource, no reference
    counterpart)."""

    aggregation: AggregationId
    tiers: int
    sub_cohort_size: int
    nodes: list  # list[TierNodeStatus], BFS order, root first

    def to_json(self):
        return {
            "aggregation": self.aggregation.to_json(),
            "tiers": self.tiers,
            "sub_cohort_size": self.sub_cohort_size,
            "nodes": [n.to_json() for n in self.nodes],
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            aggregation=AggregationId.from_json(obj["aggregation"]),
            tiers=int(obj["tiers"]),
            sub_cohort_size=int(obj["sub_cohort_size"]),
            nodes=[TierNodeStatus.from_json(n) for n in obj["nodes"]],
        )


@dataclass
class Pong:
    """Return message of the ping call (methods.rs:6-10)."""

    running: bool

    def to_json(self):
        return {"running": self.running}

    @classmethod
    def from_json(cls, obj):
        return cls(running=bool(obj["running"]))
