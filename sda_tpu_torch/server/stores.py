"""Storage abstraction of the orchestration server (copy of
``sda_tpu/server/stores.py``).

The four store interfaces of the SDA server's stores.rs: agents, auth
tokens, aggregations (incl. participations/snapshots/masks), and clerking
jobs (durable per-clerk pull queues). The server core only talks to these
interfaces; backends plug in underneath (memory, file, sqlite).

``iter_snapshot_clerk_jobs_data`` is the server's one nontrivial
computation: transposing the (participants x clerks) ciphertext matrix into
per-clerk job payloads (stores.rs:86-101). Jobs and snapshot results above
a paging threshold are delivered as metadata and read range by range, as in
the reference.
"""

from __future__ import annotations

import abc
import os
from typing import Iterable, Iterator, Optional

from ..protocol import Labelled, ServerError

# AuthToken = Labelled[AgentId, str] (stores.rs:8)
AuthToken = Labelled


def job_page_threshold() -> int:
    """Encryption count above which ``poll_clerking_job`` delivers paged
    metadata instead of the monolithic body. Read per call so tests (and
    operators) can flip it without rebuilding stores; <= 0 pages every
    job."""
    return int(os.environ.get("SDA_JOB_PAGE_THRESHOLD", "8192"))


def job_chunk_size() -> int:
    """Server-suggested chunk length for paged delivery and for the
    chunked transpose write-through. Clamped to >= 1."""
    return max(1, int(os.environ.get("SDA_JOB_CHUNK_SIZE", "4096")))


def result_page_threshold() -> int:
    """Payload-item count (mask encryptions + clerk results) above which
    ``get_snapshot_result`` delivers paged metadata instead of the
    monolithic body. Read per call, like ``job_page_threshold``; <= 0
    pages every result."""
    return int(os.environ.get("SDA_RESULT_PAGE_THRESHOLD", "8192"))


def result_chunk_size() -> int:
    """Server-suggested range length for paged snapshot-result delivery.
    Clamped to >= 1."""
    return max(1, int(os.environ.get("SDA_RESULT_CHUNK_SIZE", "4096")))


def split_small_column(chunks, threshold: int):
    """Consume ``chunks`` just far enough to learn whether the column
    fits within ``threshold`` ciphertexts. Returns ``(column, None)``
    with the full materialized column when it does — small jobs keep the
    inline layout — or ``(None, iterator)`` where the iterator replays
    the buffered prefix and then the remaining ranges. Peak memory is one
    threshold's worth either way."""
    import itertools

    buffered: list = []
    total = 0
    it = iter(chunks)
    for block in it:
        buffered.append(block)
        total += len(block)
        if total > threshold:
            return None, itertools.chain(buffered, it)
    return [enc for block in buffered for enc in block], None


def paged_job_view(job):
    """The wire view of a job under paged delivery: metadata only, the
    ciphertext column left behind for ``get_clerking_job_chunk``. Small
    jobs pass through untouched so the original wire shape survives."""
    total = len(job.encryptions) if job.total_encryptions is None else job.total_encryptions
    if total <= job_page_threshold():
        return job
    return type(job)(
        id=job.id,
        clerk=job.clerk,
        aggregation=job.aggregation,
        snapshot=job.snapshot,
        encryptions=[],
        total_encryptions=total,
        chunk_size=job_chunk_size(),
    )


class BaseStore(abc.ABC):
    def ping(self) -> None:
        """Raise if the backend is unhealthy."""


class AgentsStore(BaseStore):
    @abc.abstractmethod
    def create_agent(self, agent) -> None: ...

    @abc.abstractmethod
    def get_agent(self, agent_id): ...

    @abc.abstractmethod
    def upsert_profile(self, profile) -> None: ...

    @abc.abstractmethod
    def get_profile(self, owner_id): ...

    @abc.abstractmethod
    def create_encryption_key(self, signed_key) -> None: ...

    @abc.abstractmethod
    def get_encryption_key(self, key_id): ...

    @abc.abstractmethod
    def suggest_committee(self) -> list:
        """All agents holding at least one registered key, as ClerkCandidates
        (reference jfs impl groups signed keys by signer, agents.rs:66-83)."""


class AuthTokensStore(BaseStore):
    @abc.abstractmethod
    def upsert_auth_token(self, token: AuthToken) -> None: ...

    @abc.abstractmethod
    def register_auth_token(self, token: AuthToken) -> bool:
        """Atomic trust-on-first-use registration: record the token if the
        agent id has none yet; return whether the presented token is now
        the valid one (existing identical token also returns True).
        Check-and-write must be one atomic operation — two concurrent first
        registrations must not last-writer-win."""

    @abc.abstractmethod
    def get_auth_token(self, agent_id) -> Optional[AuthToken]: ...

    @abc.abstractmethod
    def delete_auth_token(self, agent_id) -> None: ...


class AggregationsStore(BaseStore):
    @abc.abstractmethod
    def list_aggregations(self, filter: Optional[str], recipient) -> list: ...

    @abc.abstractmethod
    def create_aggregation(self, aggregation) -> None: ...

    @abc.abstractmethod
    def get_aggregation(self, aggregation_id): ...

    @abc.abstractmethod
    def delete_aggregation(self, aggregation_id) -> None: ...

    @abc.abstractmethod
    def get_committee(self, aggregation_id): ...

    @abc.abstractmethod
    def create_committee(self, committee) -> None: ...

    @abc.abstractmethod
    def create_participation(self, participation) -> None: ...

    @abc.abstractmethod
    def iter_participations(self, aggregation_id):
        """Every stored participation of ``aggregation_id``, in a stable
        (id-sorted) order. Snapshot-independent — this is the raw table
        scan the shard-migration copier replays onto a new partition,
        not the frozen-membership iteration the transpose uses."""
        ...

    def create_participations(self, participations) -> None:
        """Bulk write of pre-validated participations — the storage half of
        the batched ingest pipeline.

        Contract: ATOMIC with the same create-if-identical idempotence as
        singles.  If any participation conflicts (same id, different body)
        or its aggregation is missing, the whole batch must be rejected
        with no partial state.  Backends override with a real bulk write
        (sqlite: one BEGIN IMMEDIATE + executemany); this default serves
        backends whose single create is already an in-memory mutation that
        the caller serializes (and is made atomic there by pre-checking)."""
        for participation in participations:
            self.create_participation(participation)

    @abc.abstractmethod
    def create_snapshot(self, snapshot) -> None: ...

    @abc.abstractmethod
    def list_snapshots(self, aggregation_id) -> list: ...

    @abc.abstractmethod
    def get_snapshot(self, aggregation_id, snapshot_id): ...

    @abc.abstractmethod
    def count_participations(self, aggregation_id) -> int: ...

    @abc.abstractmethod
    def snapshot_participations(self, aggregation_id, snapshot_id) -> None:
        """Freeze the current participation set as the snapshot's members."""

    @abc.abstractmethod
    def iter_snapped_participations(self, aggregation_id, snapshot_id) -> Iterator: ...

    def discard_participations(self, aggregation_id, participation_ids) -> None:
        """Remove the given participation rows before any snapshot freezes
        them — the share-promotion prepare stage drops incomplete re-share
        epochs here (server/snapshot.py). Missing ids are ignored; rows
        already frozen into a snapshot must never be passed (the pipeline
        guards on frozen membership before resolving)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support discard_participations"
        )

    def count_participations_snapshot(self, aggregation_id, snapshot_id) -> int:
        return sum(1 for _ in self.iter_snapped_participations(aggregation_id, snapshot_id))

    def validate_snapshot_clerk_jobs(
        self, aggregation_id, snapshot_id, clerks_number: int
    ) -> None:
        """Reject malformed snapped bodies BEFORE the transpose starts.

        Streaming backends yield columns lazily, after the snapshot
        pipeline has begun durably enqueueing clerk jobs — a mid-stream
        failure would leave clerks 0..k-1 holding jobs for a snapshot
        whose commit point never runs. The pipeline calls this first; a
        backend whose transpose can fail mid-stream overrides it to raise
        here instead (sqlite: indexed COUNT; file store: one validation
        pass). The default is a no-op because the base transpose is eager
        — it materializes every column before the caller sees the first
        one, so a malformed body raises before any enqueue."""

    def iter_snapshot_clerk_jobs_data(
        self, aggregation_id, snapshot_id, clerks_number: int
    ) -> Iterable:
        """Transpose participations x clerks -> per-clerk ciphertext columns.

        Contract: an ITERABLE of ``clerks_number`` columns, consumed once
        in committee order (column ix = the clerk's committee position;
        participations carry clerk encryptions in committee order).
        Backends may return a lazy single-use generator (sqlite, file
        store above its threshold) — callers must not index, len(), or
        iterate twice. This default is the reference's eager in-memory
        transpose (stores.rs:86-101).
        """
        shares: list = [[] for _ in range(clerks_number)]
        for participation in self.iter_snapped_participations(aggregation_id, snapshot_id):
            for ix, (_, enc) in enumerate(participation.clerk_encryptions):
                shares[ix].append(enc)
        return shares

    def iter_snapshot_clerk_jobs_chunks(
        self, aggregation_id, snapshot_id, clerks_number: int, chunk_size: int
    ) -> Iterable:
        """Chunked transpose: an iterable of ``clerks_number`` column
        iterators, each yielding ``chunk_size``-long ciphertext ranges in
        participant order. Same single-use, committee-order contract as
        ``iter_snapshot_clerk_jobs_data``; this is what keeps snapshot
        enqueue memory at one chunk instead of one full column per clerk.
        The default re-chunks the column transpose (eager backends gain
        nothing, which is fine: they already hold everything in memory);
        sqlite and the file store override with genuinely ranged reads.
        """

        def chunks_of(column):
            it = iter(column)
            while True:
                block = []
                for enc in it:
                    block.append(enc)
                    if len(block) >= chunk_size:
                        break
                if not block:
                    return
                yield block

        for column in self.iter_snapshot_clerk_jobs_data(
            aggregation_id, snapshot_id, clerks_number
        ):
            yield chunks_of(column)

    @abc.abstractmethod
    def create_snapshot_mask(self, snapshot_id, mask: list) -> None: ...

    @abc.abstractmethod
    def get_snapshot_mask(self, snapshot_id): ...

    def count_snapshot_mask(self, snapshot_id) -> Optional[int]:
        """Length of the stored recipient-mask blob, or None when the
        snapshot stored no mask — the paged-delivery decision input.
        Backends with an externalized mask layout override to answer from
        metadata without materializing the blob."""
        mask = self.get_snapshot_mask(snapshot_id)
        return None if mask is None else len(mask)

    def get_snapshot_mask_range(self, snapshot_id, start: int, count: int) -> Optional[list]:
        """Mask encryptions ``[start, start+count)`` in stored order, or
        None when no mask exists. Ranges past the end return the
        (possibly empty) tail, like ``get_clerking_job_chunk``. Backends
        override to read ONLY the requested range (sqlite: indexed
        position rows; file store: byte-offset seek); this default slices
        the materialized blob for in-memory layouts."""
        mask = self.get_snapshot_mask(snapshot_id)
        if mask is None:
            return None
        if start < 0 or count < 0:
            return []
        return mask[start : start + count]


class ClerkingJobsStore(BaseStore):
    @abc.abstractmethod
    def enqueue_clerking_job(self, job) -> None: ...

    def enqueue_clerking_job_chunked(self, job, chunks: Iterable) -> None:
        """Enqueue ``job`` (its ``encryptions`` empty) with the ciphertext
        column supplied as an iterator of ranges, in participant order.

        The streaming half of the chunked transpose: backends with an
        external column representation (sqlite rows, file-store column
        files) write ranges through without ever holding the full column;
        this default materializes for purely in-memory backends, which
        hold the whole queue anyway. Must keep ``enqueue_clerking_job``'s
        idempotence: re-enqueueing an existing job id is a no-op."""
        encryptions = []
        for block in chunks:
            encryptions.extend(block)
        job.encryptions = encryptions
        self.enqueue_clerking_job(job)

    @abc.abstractmethod
    def poll_clerking_job(self, clerk_id):
        """First not-yet-done job for the clerk; jobs stay queued until a
        result is posted, so a crashed clerk re-polls the same job
        (jfs_stores/clerking_jobs.rs:40-59). Jobs above
        ``job_page_threshold()`` are returned as paged metadata (see
        ``paged_job_view``); the column is then read range-by-range via
        ``get_clerking_job_chunk``."""

    @abc.abstractmethod
    def get_clerking_job(self, clerk_id, job_id): ...

    def get_clerking_job_chunk(
        self, clerk_id, job_id, start: int, count: int
    ) -> Optional[list]:
        """Ciphertexts ``[start, start+count)`` of the job's column, or
        None when the job doesn't exist / isn't the clerk's. Ranges past
        the end return the (possibly empty) tail — polling clients stop
        on their own count, and an empty list is a valid answer. Backends
        override to read ONLY the requested range (sqlite: indexed
        position rows; file store: byte-offset seek); this default slices
        the materialized job for in-memory layouts."""
        job = self.get_clerking_job(clerk_id, job_id)
        if job is None:
            return None
        if start < 0 or count < 0:
            return []
        return job.encryptions[start : start + count]

    @abc.abstractmethod
    def create_clerking_result(self, result) -> None: ...

    def complete_clerking_job(self, clerk_id, job_id) -> None:
        """Retire a job WITHOUT filing a clerking result — the terminal of
        tier share-promotion (the clerk's output left as tagged
        participations of the parent aggregation, so no recipient-sealed
        result may exist). Must be idempotent: completing an already-done
        job is a no-op; an unknown/foreign job raises. Backends that
        predate share-promotion inherit this raising default."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement complete_clerking_job"
        )

    @abc.abstractmethod
    def list_results(self, snapshot_id) -> list: ...

    @abc.abstractmethod
    def get_result(self, snapshot_id, job_id): ...

    def get_results(self, snapshot_id) -> list:
        """All ClerkingResults for the snapshot in ``list_results`` order
        (sorted by str(job_id) — canonical across backends). Bulk
        replacement for the get_result-per-job loop; backends override
        with a single scan/query."""
        results = []
        for job_id in self.list_results(snapshot_id):
            result = self.get_result(snapshot_id, job_id)
            if result is None:
                raise ServerError("inconsistent storage")
            results.append(result)
        return results

    def count_results(self, snapshot_id) -> int:
        """Number of posted ClerkingResults for the snapshot — the other
        paged-delivery decision input. Backends override with an indexed
        COUNT where one exists."""
        return len(self.list_results(snapshot_id))

    def get_results_range(self, snapshot_id, start: int, count: int) -> list:
        """ClerkingResults ``[start, start+count)`` in ``get_results``
        order (sorted by str(job_id) — the canonical cross-backend order,
        so a paged reader sees exactly the monolithic sequence). Ranges
        past the end return the (possibly empty) tail. Committee results
        are small next to mask columns, but paging them through the same
        discipline keeps one reveal-side code path."""
        if start < 0 or count < 0:
            return []
        return self.get_results(snapshot_id)[start : start + count]
