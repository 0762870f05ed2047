"""The snapshot pipeline — the server's orchestration heart (counterpart of
``sda_tpu/server/snapshot.py``).

The SDA server's snapshot.rs:4-47: freeze the current participation set,
transpose the (participants x clerks) ciphertext matrix, enqueue one
durable ClerkingJob per committee member, persist the snapshot, and (when
the scheme masks) collect every participation's recipient encryption into
the snapshot mask blob.

The run is a stage pipeline (``SNAPSHOT_STAGES``): prepare re-share ->
freeze -> job fan-out -> mask collect -> commit. Everything before the
commit stage is idempotent — membership freeze is write-once, job ids
deterministic, the mask blob a plain overwrite of identical content — so a
crashed run retried by the client replays cleanly into the stores'
create-if-identical semantics. Under Packed Paillier recipient encryption
the mask-collect stage multiplies the participants' mask ciphertexts into
one (``_maybe_combine_masks``), with the recipient's public key only.

Hierarchical aggregations run this SAME pipeline once per node of their
derived tree (protocol/tiers.py): each sub-aggregation's snapshot fans
its sub-cohort's columns out to its own sub-committee, so per-clerk work
is O(cohort/m) instead of O(cohort). ``snapshot_dag`` exposes the
execution order — leaves first, root last, each node's snapshot
depending on its children's promotions having landed — which the client
round driver (client/tiers.py) walks bottom-up.
"""

from __future__ import annotations

import logging
import uuid

from ..protocol import ClerkingJob, ClerkingJobId, ServerError
from ..protocol import tiers as tiers_mod
from ..utils.metrics import get_metrics
from . import stores as stores_mod

log = logging.getLogger("sda.server.snapshot")

# Deterministic job ids: uuid5 of (snapshot, clerk position), the
# reference's namespace. A crashed snapshot run retried by the client
# re-creates byte-identical jobs, which the stores' create-if-identical
# semantics absorb — no duplicate jobs, no double-counted results.
_JOB_NAMESPACE = uuid.UUID("6b1b36cf-4f3a-4bca-8a3c-1d53437e8ed9")


def _job_id(snapshot_id, clerk_index: int) -> ClerkingJobId:
    return ClerkingJobId(uuid.uuid5(_JOB_NAMESPACE, f"{snapshot_id}:{clerk_index}"))


def snapshot_dag(aggregation) -> list:
    """The sub-aggregation DAG a full round of ``aggregation`` snapshots
    through, in execution order: leaves first, root last (reverse
    breadth-first over the derived tree). Each entry is a
    ``protocol.tiers.TierNode``; a node's snapshot may only be cut after
    its children's partial sums have been promoted into it, which is
    exactly the reversed-BFS order. Flat aggregations yield a
    single-node DAG — the degenerate tree."""
    return list(reversed(tiers_mod.iter_tier_nodes(aggregation)))


# -- pipeline stages ---------------------------------------------------------


def _stage_prepare_reshare(server, aggregation, snapshot) -> None:
    """Resolve share-promotion epochs BEFORE the membership freeze.

    A tiered parent's participation table may hold, per derived child,
    tier_reshare-tagged rows from several epochs (the full-committee
    epoch 0, plus a survivor reissue after a clerk death) and one
    mask-correction row. Only ONE consistent epoch per child may enter
    the frozen cut — folding two epochs would double-count the
    sub-cohort — so this stage picks, per child, the highest COMPLETE
    epoch (one consistent survivor set, a column row from every survivor,
    enough survivors to reconstruct) and discards every other tagged row
    of that child. A child with no complete epoch (or a masked child
    missing its correction row) contributes nothing: all its rows are
    dropped and the round continues exact off the surviving subtrees —
    the cross-tier threshold semantics client/tiers.py builds on.

    Runs only on tiered nodes, and only while membership is still
    unfrozen: once ``snapshot_participations`` has pinned a member list
    (a crashed earlier run), the resolution that freeze saw must stand —
    discarding a frozen member would corrupt the transpose count.
    """
    if not aggregation.is_tiered():
        return
    if (
        server.aggregation_store.count_participations_snapshot(
            snapshot.aggregation, snapshot.id
        )
        > 0
    ):
        return  # membership already frozen: resolution is pinned
    by_child: dict = {}
    for part in server.aggregation_store.iter_participations(snapshot.aggregation):
        tag = part.tier_reshare
        if tag is not None:
            by_child.setdefault(tag.child, []).append(part)
    needs_mask = aggregation.masking_scheme.has_mask()
    threshold = aggregation.committee_sharing_scheme.reconstruction_threshold
    discard = []
    for child, rows in by_child.items():
        mask_rows = [p for p in rows if p.tier_reshare.position is None]
        epochs: dict = {}
        for p in rows:
            if p.tier_reshare.position is not None:
                epochs.setdefault(p.tier_reshare.epoch, []).append(p)
        chosen = None
        for epoch in sorted(epochs, reverse=True):
            cols = epochs[epoch]
            survivor_sets = {tuple(p.tier_reshare.survivors) for p in cols}
            if len(survivor_sets) != 1:
                continue  # inconsistent weights: Lagrange columns disagree
            survivors = set(next(iter(survivor_sets)))
            positions = {p.tier_reshare.position for p in cols}
            if positions != survivors or len(survivors) < threshold:
                continue  # incomplete epoch: missing a survivor's column
            chosen = epoch
            break
        if chosen is None or (needs_mask and not mask_rows):
            discard.extend(p.id for p in rows)
            log.warning(
                "snapshot %s: child %s has no complete re-share epoch; "
                "dropping its %d promotion rows (subtree excluded)",
                snapshot.id,
                child,
                len(rows),
            )
            continue
        discard.extend(
            p.id
            for p in rows
            if p.tier_reshare.position is not None and p.tier_reshare.epoch != chosen
        )
    if discard:
        with get_metrics().phase("snapshot.prepare_reshare"):
            server.aggregation_store.discard_participations(
                snapshot.aggregation, discard
            )


def _stage_freeze(server, aggregation, snapshot) -> None:
    """Freeze the participation set: the consistent cut every later stage
    (and every retry) reads. Write-once per (aggregation, snapshot)."""
    with get_metrics().phase("snapshot.freeze"):
        server.aggregation_store.snapshot_participations(
            snapshot.aggregation, snapshot.id
        )


def _stage_fanout_jobs(server, aggregation, snapshot) -> None:
    """Transpose the frozen (participants x clerks) ciphertext matrix and
    enqueue one durable ClerkingJob per committee member."""
    metrics = get_metrics()
    committee = server.aggregation_store.get_committee(snapshot.aggregation)
    if committee is None:
        raise ServerError("lost committee")

    log.debug("snapshot %s: transposing + enqueueing clerking jobs", snapshot.id)
    with metrics.phase("snapshot.transpose"):
        # streaming backends enqueue jobs before later columns are even
        # read — malformed bodies must be rejected up front, or a
        # mid-stream failure leaves durable jobs for a snapshot that never
        # commits (see AggregationsStore.validate_snapshot_clerk_jobs)
        server.aggregation_store.validate_snapshot_clerk_jobs(
            snapshot.aggregation, snapshot.id, len(committee.clerks_and_keys)
        )
        per_clerk = iter(
            server.aggregation_store.iter_snapshot_clerk_jobs_chunks(
                snapshot.aggregation,
                snapshot.id,
                len(committee.clerks_and_keys),
                stores_mod.job_chunk_size(),
            )
        )
    for ix, (clerk_id, _) in enumerate(committee.clerks_and_keys):
        with metrics.phase("snapshot.transpose"):
            try:
                chunks = next(per_clerk)
            except StopIteration:
                raise ServerError(
                    f"transpose yielded fewer than "
                    f"{len(committee.clerks_and_keys)} clerk columns"
                )
        with metrics.phase("snapshot.enqueue"):
            server.clerking_job_store.enqueue_clerking_job_chunked(
                ClerkingJob(
                    id=_job_id(snapshot.id, ix),
                    clerk=clerk_id,
                    aggregation=snapshot.aggregation,
                    snapshot=snapshot.id,
                    encryptions=[],
                ),
                chunks,
            )


def _stage_collect_masks(server, aggregation, snapshot) -> None:
    """Gather every frozen participation's recipient encryption into the
    snapshot mask blob (skipped entirely for non-masking schemes)."""
    if not aggregation.masking_scheme.has_mask():
        return
    log.debug("snapshot %s: collecting masking data", snapshot.id)
    recipient_encryptions = []
    for part in server.aggregation_store.iter_snapped_participations(
        snapshot.aggregation, snapshot.id
    ):
        if part.recipient_encryption is None:
            raise ServerError("participation should have had a recipient encryption")
        recipient_encryptions.append(part.recipient_encryption)
    recipient_encryptions = _maybe_combine_masks(
        server, aggregation, recipient_encryptions
    )
    server.aggregation_store.create_snapshot_mask(snapshot.id, recipient_encryptions)


def _stage_commit(server, aggregation, snapshot) -> None:
    """Persist the snapshot record — the COMMIT POINT: the retry guard in
    ``run_snapshot`` keys on it, so every earlier stage must be (and is)
    idempotent."""
    server.aggregation_store.create_snapshot(snapshot)


#: the pipeline, in order; each stage is f(server, aggregation, snapshot).
#: Every stage before the final commit is idempotent by construction.
SNAPSHOT_STAGES = (
    _stage_prepare_reshare,
    _stage_freeze,
    _stage_fanout_jobs,
    _stage_collect_masks,
    _stage_commit,
)


def run_snapshot(server, snapshot) -> None:
    aggregation = server.aggregation_store.get_aggregation(snapshot.aggregation)
    if aggregation is None:
        raise ServerError("lost aggregation")

    # Idempotent retry: the snapshot id is client-chosen; re-submitting an
    # existing snapshot must not enqueue a second set of clerking jobs
    # (duplicate results would double-count toward result_ready).
    if server.aggregation_store.get_snapshot(snapshot.aggregation, snapshot.id) is not None:
        log.debug("snapshot %s: already exists, retry is a no-op", snapshot.id)
        return

    get_metrics().count("snapshots")
    log.debug("snapshot %s: freezing participations", snapshot.id)
    for stage in SNAPSHOT_STAGES:
        stage(server, aggregation, snapshot)
    log.debug("snapshot %s: done", snapshot.id)


def _maybe_combine_masks(server, aggregation, recipient_encryptions):
    """Homomorphic server-side mask combine (the Paillier scale-up path of
    the SDA README's "Doing more"): when masks are PackedPaillier-encrypted,
    multiply all participants' ciphertexts into ONE — the recipient then
    decrypts O(dim) data regardless of participant count. Public-key only;
    the untrusted server learns nothing. Falls back to the uncombined list
    (recipient combines after decrypting, still correct) if the cohort
    exceeds the packing's addition capacity or the key is unavailable.
    """
    from ..protocol import PackedPaillierEncryptionScheme

    scheme = aggregation.recipient_encryption_scheme
    if not isinstance(scheme, PackedPaillierEncryptionScheme):
        return recipient_encryptions
    if len(recipient_encryptions) < 2:
        return recipient_encryptions
    from ..ops.paillier import Packing

    capacity = Packing(
        scheme.component_count, scheme.component_bitsize, scheme.max_value_bitsize
    ).additions_capacity
    if len(recipient_encryptions) > capacity:
        log.warning(
            "snapshot: %d participations exceed Paillier addition capacity %d; "
            "leaving masks uncombined",
            len(recipient_encryptions),
            capacity,
        )
        return recipient_encryptions
    signed = server.agents_store.get_encryption_key(aggregation.recipient_key)
    if signed is None:
        log.warning("snapshot: recipient key unavailable; leaving masks uncombined")
        return recipient_encryptions
    from ..crypto.encryption import combine_encryptions

    try:
        with get_metrics().phase("snapshot.paillier_combine"):
            combined = combine_encryptions(
                signed.body.body, scheme, recipient_encryptions
            )
    except Exception:
        # one malformed participant upload must not wedge the snapshot
        # forever (retries would re-read the same stored participations):
        # the uncombined list is always a correct fallback — the recipient
        # decrypts and combines client-side.
        log.warning(
            "snapshot: homomorphic mask combine failed; leaving masks "
            "uncombined",
            exc_info=True,
        )
        return recipient_encryptions
    return [combined]
