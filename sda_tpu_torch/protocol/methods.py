"""The SDA service interface — the single seam of the whole system.

Copy of ``sda_tpu/protocol/methods.py``: the 19 RPC methods of the SDA
protocol (protocol/src/methods.rs) as one abstract base class. The
in-process server and any other binding implement this same interface, so
protocol logic and tests are written once against it (the SDA design's key
architectural property, SURVEY.md §1).

Every method takes ``caller`` for access control; ``get_*`` methods return
``None`` for missing resources.
"""

from __future__ import annotations

import abc
from typing import Optional


class SdaService(abc.ABC):
    """Combined SDA service: agent, aggregation, participation, clerking,
    and recipient methods (methods.rs:13-112)."""

    # -- base ---------------------------------------------------------------

    @abc.abstractmethod
    def ping(self):
        """Liveness check; returns Pong."""

    # -- agents (methods.rs:31-50) -----------------------------------------

    @abc.abstractmethod
    def create_agent(self, caller, agent) -> None:
        """Register an agent (caller must be the agent itself)."""

    @abc.abstractmethod
    def get_agent(self, caller, agent_id):
        """Fetch an agent description; public."""

    @abc.abstractmethod
    def upsert_profile(self, caller, profile) -> None:
        """Create or update the caller's public profile."""

    @abc.abstractmethod
    def get_profile(self, caller, owner_id):
        """Fetch a public profile."""

    @abc.abstractmethod
    def create_encryption_key(self, caller, signed_key) -> None:
        """Register a signed encryption key (caller must be the signer)."""

    @abc.abstractmethod
    def get_encryption_key(self, caller, key_id):
        """Fetch a signed encryption key; public."""

    # -- aggregations (methods.rs:53-64) -------------------------------------

    @abc.abstractmethod
    def list_aggregations(self, caller, filter: Optional[str] = None, recipient=None):
        """Search aggregations by title substring and/or recipient."""

    @abc.abstractmethod
    def get_aggregation(self, caller, aggregation_id):
        """Fetch an aggregation description."""

    @abc.abstractmethod
    def get_committee(self, caller, aggregation_id):
        """Fetch the committee elected for an aggregation."""

    # -- participation (methods.rs:68-73) ------------------------------------

    @abc.abstractmethod
    def create_participation(self, caller, participation) -> None:
        """Submit a participation (caller must be the participant)."""

    def create_participations(self, caller, participations) -> None:
        """Submit a batch of participations (caller must be the participant
        of every one).  Both shipped bindings (the in-process service and
        the REST client's batch route) make the batch atomic: every
        participation is accepted — idempotent replays included — or none
        is stored.  This default is only a compatibility shim for
        third-party bindings and submits sequentially, without atomicity."""
        for participation in participations:
            self.create_participation(caller, participation)

    # -- clerking (methods.rs:76-84) -----------------------------------------

    @abc.abstractmethod
    def get_clerking_job(self, caller, clerk_id):
        """Poll the durable queue for the clerk's next job, if any.

        Jobs above the server's paging threshold come back as metadata
        (``ClerkingJob.is_paged()``): ``encryptions`` empty,
        ``total_encryptions``/``chunk_size`` set, the ciphertext column
        fetched range-by-range via ``get_clerking_job_chunk``."""

    def get_clerking_job_chunk(self, caller, job_id, start: int):
        """Fetch one ciphertext range ``[start, start+server_chunk)`` of
        a paged clerking job the caller owns; returns list[Encryption]
        (empty past the end), or None for a job that doesn't exist or
        belongs to another clerk. Bindings serve this from the chunk
        route / ranged store reads; this default exists so third-party
        ``SdaService`` implementations predating paged delivery keep
        importing — but they will never hand out a paged job either, so
        reaching it means a binding/version mismatch."""
        raise NotImplementedError(
            "this SdaService binding does not support paged clerking jobs"
        )

    @abc.abstractmethod
    def create_clerking_result(self, caller, result) -> None:
        """Push the result of a finished clerking job."""

    def complete_clerking_job(self, caller, job_id) -> None:
        """Retire a clerking job the caller owns WITHOUT filing a result —
        the terminal of tier share-promotion (client/clerk.py), where the
        clerk's output left as tagged participations of the parent and no
        recipient-sealed result may exist. Idempotent on replay. Default
        shim raises so ``SdaService`` bindings predating share promotion
        keep importing; reaching it means a binding/version mismatch."""
        raise NotImplementedError(
            "this SdaService binding does not support completing a job "
            "without a clerking result"
        )

    # -- recipient (methods.rs:87-112) ----------------------------------------

    @abc.abstractmethod
    def create_aggregation(self, caller, aggregation) -> None:
        """Create an aggregation (caller must be the recipient)."""

    @abc.abstractmethod
    def delete_aggregation(self, caller, aggregation_id) -> None:
        """Delete all information regarding an aggregation."""

    @abc.abstractmethod
    def suggest_committee(self, caller, aggregation_id):
        """Propose suitable committee members; returns list[ClerkCandidate]."""

    @abc.abstractmethod
    def create_committee(self, caller, committee) -> None:
        """Elect the committee for an aggregation."""

    @abc.abstractmethod
    def get_aggregation_status(self, caller, aggregation_id):
        """Poll aggregation status (participations, snapshots, readiness)."""

    def get_tier_status(self, caller, aggregation_id):
        """Per-node readiness of a TIERED aggregation's derived tree
        (``TierStatus``, nodes in breadth-first order, root first), or
        None for a flat or unknown aggregation. Recipient-only, like
        ``get_aggregation_status``. Compatibility shim rationale as the
        paged-delivery defaults: a binding predating tiered aggregation
        never creates one, so reaching this default means a
        binding/version mismatch."""
        raise NotImplementedError(
            "this SdaService binding does not support tiered aggregations"
        )

    @abc.abstractmethod
    def create_snapshot(self, caller, snapshot) -> None:
        """Freeze a consistent subset of participations and build clerk jobs."""

    @abc.abstractmethod
    def get_snapshot_result(self, caller, aggregation_id, snapshot_id):
        """Fetch the collected clerk results + mask blob for a snapshot.

        Results above the server's paging threshold come back as metadata
        (``SnapshotResult.is_paged()``): payload lists empty,
        ``mask_encryption_count``/``clerk_result_count``/``chunk_size``
        set, both payloads fetched range-by-range via
        ``get_snapshot_result_masks`` / ``get_snapshot_result_clerks``."""

    def get_snapshot_result_masks(self, caller, aggregation_id, snapshot_id, start: int):
        """Fetch one recipient-mask-encryption range
        ``[start, start+server_chunk)`` of a paged snapshot result;
        returns list[Encryption] (empty past the end), or None for a
        snapshot that doesn't exist, doesn't belong to the aggregation,
        or stored no mask. Same compatibility shim rationale as
        ``get_clerking_job_chunk``: a binding predating paged delivery
        never hands out a paged result, so reaching this default means a
        binding/version mismatch."""
        raise NotImplementedError(
            "this SdaService binding does not support paged snapshot results"
        )

    def get_snapshot_result_clerks(self, caller, aggregation_id, snapshot_id, start: int):
        """Fetch one clerk-result range ``[start, start+server_chunk)``
        of a paged snapshot result, ordered by job id; returns
        list[ClerkingResult] (empty past the end), or None for a snapshot
        that doesn't exist or doesn't belong to the aggregation."""
        raise NotImplementedError(
            "this SdaService binding does not support paged snapshot results"
        )
