"""Hierarchical aggregation topology — pure derivation, no IO (copy of
``sda_tpu/protocol/tiers.py``; every id and assignment is byte-equal to
``sda_tpu``'s, so either package's participants land on the same leaves).

The tree scheme of "Secret Sharing Sharing For Highly Scalable Secure
Aggregation" (arXiv 2201.00864): a tiered aggregation is a TREE of
ordinary aggregations, derived entirely from the ROOT record. Node ids
are uuid5 of (parent id, child index), participants hash into
sub-cohorts per node, and every node runs the unchanged flat pipeline
(committee, snapshot, clerking, reveal) over its own cohort — per-clerk
work drops from O(N) to O(N / m^(tiers-1)) because each sub-committee
only ever touches its own sub-cohort's columns.

Client and server both import these functions, so both sides compute the
SAME topology from the same root record: a participant can resolve its
leaf without asking the server, and the server can enumerate the derived
tree (tier status, delete cascade) without storing any edges.

``tiers`` counts committee LEVELS (2 = sub-committees + root committee);
``sub_cohort_size`` is the fan-out m — the number of sub-cohorts each
tiered node splits its cohort into (NOT the participants per sub-cohort).
A node's children carry ``tiers - 1``; nodes reaching 1 are plain flat
aggregations and accept real participations.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Optional

from ..utils.hashring import HashRing
from .ids import AggregationId, ParticipationId
from .resources import Aggregation
from .schemes import AdditiveSharing, SodiumEncryptionScheme

#: uuid5 namespace for everything tier-derived (child ids, cohort hashes).
#: Fixed forever: child ids must be reproducible by any client or server
#: from the root id alone, across processes and versions.
TIER_NAMESPACE = uuid.UUID("8f3f6d2a-94b1-4dfd-b1b5-6a42a86be1a4")

#: validation bounds (server/service.py): the tree has m^(tiers-1) leaves,
#: so both knobs are capped to keep the derived fan-out enumerable
MAX_TIERS = 4
MAX_SUB_COHORTS = 64

#: how partial sums climb the tree. ``reveal``: the promoter reconstructs
#: the sub-cohort partial and re-submits it;
#: ``reshare`` is the paper's share-promotion path (clerks re-share their
#: aggregated columns upward; nothing intermediate is ever reconstructed).
PROMOTION_REVEAL = "reveal"
PROMOTION_RESHARE = "reshare"

#: re-share epochs are tiny (0 = full committee, 1 = survivor reissue);
#: the bound keeps the deterministic id space and validation enumerable
MAX_RESHARE_EPOCHS = 16


def effective_promotion(aggregation: Aggregation) -> str:
    """The promotion path a tiered round actually runs. Explicit
    ``tier_promotion`` wins; otherwise share-promotion is the default for
    every threshold scheme and additive sharing falls back to reveal
    (additive columns are the secrets' full image — there is no Lagrange
    column to re-share by, and ``reconstruction_matrix`` has no additive
    form)."""
    if aggregation.tier_promotion is not None:
        return aggregation.tier_promotion
    if isinstance(aggregation.committee_sharing_scheme, AdditiveSharing):
        return PROMOTION_REVEAL
    return PROMOTION_RESHARE


def is_reshare_child(aggregation: Aggregation) -> bool:
    """True when ``aggregation`` is a derived tier child whose clerks must
    promote their aggregated share columns to ``tier_parent`` instead of
    sealing clerking results for a local reveal."""
    return (
        aggregation.tier_parent is not None
        and effective_promotion(aggregation) == PROMOTION_RESHARE
    )


def reshare_participation_id(
    child_id: AggregationId, epoch: int, position: Optional[int] = None
) -> ParticipationId:
    """Deterministic id for a share-promotion row: uuid5 of (child, epoch,
    committee position), or of (child,) alone for the owner's single
    mask-correction row. Retries and re-drains therefore collide on the
    stores' create-if-identical semantics instead of double-counting."""
    leaf = "reshare-mask" if position is None else f"reshare:{epoch}:{position}"
    return ParticipationId(uuid.uuid5(TIER_NAMESPACE, f"{child_id}:{leaf}"))


def tier_depth(aggregation: Aggregation) -> int:
    return aggregation.tiers or 1


def child_aggregation_id(parent_id: AggregationId, index: int) -> AggregationId:
    """Deterministic sub-aggregation id: uuid5 of (parent, child index).
    The same idiom as the snapshot pipeline's job ids — a re-provisioned
    tree derives byte-identical records, which the stores'
    create-if-identical semantics absorb."""
    return AggregationId(uuid.uuid5(TIER_NAMESPACE, f"{parent_id}:child:{index}"))


def assign_sub_cohort(node_id: AggregationId, participant_id, sub_cohorts: int) -> int:
    """Which of ``node_id``'s sub-cohorts ``participant_id`` belongs to.

    Deterministic hash, salted by the node id: the same participant lands
    in independent positions at different nodes of the tree, so one tier's
    assignment leaks nothing about another's."""
    if sub_cohorts < 1:
        raise ValueError("sub_cohorts must be >= 1")
    digest = uuid.uuid5(TIER_NAMESPACE, f"{node_id}:cohort:{participant_id}")
    return digest.int % sub_cohorts


def leaf_aggregation_id(root: Aggregation, participant_id) -> AggregationId:
    """The leaf aggregation a participant's submission routes to: walk the
    derived tree from the root, hashing into a sub-cohort per tiered
    node. Pure — every hop's id derives from the root id, so no server
    round-trips are needed to resolve the leaf."""
    node, depth = root.id, tier_depth(root)
    while depth > 1:
        ix = assign_sub_cohort(node, participant_id, root.sub_cohort_size)
        node = child_aggregation_id(node, ix)
        depth -= 1
    return node


def frontend_for(aggregation_id, frontends: int) -> int:
    """Which of ``frontends`` REST frontends serves ``aggregation_id``'s
    traffic. This is exactly the multi-root client's routing function
    (``HashRing(len(roots)).shard_for(str(key))`` — see
    ``rest/client.py``), exposed as a pure topology function so tier
    drivers can pin each node's committee daemon next to the frontend
    its requests will land on WITHOUT asking any coordinator: every
    party derives the same placement from the root id alone."""
    if frontends < 1:
        raise ValueError("placement needs at least one frontend")
    return HashRing(frontends).shard_for(str(aggregation_id))


def tier_placement(root: Aggregation, frontends: int) -> dict:
    """Deterministic tier→frontend placement for the whole derived tree:
    ``{aggregation_id: frontend_index}`` for every node of ``root``'s
    topology. A pure function of (root id, frontend count) — clients,
    committee daemons, and launchers all compute the identical map, so a
    sub-committee process can be spawned pointing at exactly the
    frontend that will serve its node's wire traffic."""
    ring = HashRing(frontends) if frontends > 1 else None
    return {
        node.aggregation_id: (
            ring.shard_for(str(node.aggregation_id)) if ring is not None else 0
        )
        for node in iter_tier_nodes(root)
    }


@dataclass(frozen=True)
class TierNode:
    """One node of the derived tree: tier 0 is the root; ``index`` is the
    position within the parent's children (0 for the root)."""

    aggregation_id: AggregationId
    tier: int
    index: int
    parent: Optional[AggregationId]

    def is_leaf_of(self, root: Aggregation) -> bool:
        return self.tier == tier_depth(root) - 1


def iter_tier_nodes(root: Aggregation) -> list:
    """The whole derived tree as a list of ``TierNode``, breadth-first,
    root first — the enumeration order tier status reports in and the
    provisioning order (parents before children) the round driver uses.
    A flat aggregation yields just its own root node."""
    nodes = [TierNode(root.id, 0, 0, None)]
    frontier = [root.id]
    m = root.sub_cohort_size or 0
    for tier in range(1, tier_depth(root)):
        next_frontier = []
        for parent in frontier:
            for ix in range(m):
                child = child_aggregation_id(parent, ix)
                nodes.append(TierNode(child, tier, ix, parent))
                next_frontier.append(child)
        frontier = next_frontier
    return nodes


def child_aggregation(
    parent: Aggregation, index: int, recipient, recipient_key
) -> Aggregation:
    """The derived sub-aggregation record for child ``index`` of
    ``parent``: same group (modulus, dimension), same masking and sharing
    schemes (so every tier gets the same dropout tolerance), one fewer
    tier. The child's recipient is its OWNER — under share-promotion it
    only ever decrypts the sub-cohort's mask sum (to submit the
    mask-correction row); under reveal-promotion it reconstructs and
    re-submits the partial. Either way the recipient encryption scheme is
    pinned to sodium sealed boxes (owner keystores hold sodium keys;
    PackedPaillier mask transport stays a root-only concern).
    ``tier_parent``/``tier_promotion`` propagate so a child record alone
    tells its clerks where and how to promote."""
    remaining = tier_depth(parent) - 1
    return Aggregation(
        id=child_aggregation_id(parent.id, index),
        title=f"{parent.title}/sub{index}",
        vector_dimension=parent.vector_dimension,
        modulus=parent.modulus,
        recipient=recipient,
        recipient_key=recipient_key,
        masking_scheme=parent.masking_scheme,
        committee_sharing_scheme=parent.committee_sharing_scheme,
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=parent.committee_encryption_scheme,
        sub_cohort_size=parent.sub_cohort_size if remaining > 1 else None,
        tiers=remaining if remaining > 1 else None,
        tier_parent=parent.id,
        tier_promotion=parent.tier_promotion,
    )
