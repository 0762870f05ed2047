"""In-memory store backend (copy of ``sda_tpu/server/memstore.py``).

Dict-backed, thread-safe via a single lock, with the SDA server's jfs
create semantics: re-creating identical content is a no-op, differing
content an error (jfs_stores/mod.rs:79-89).
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

from ..protocol import InvalidRequestError, ServerError
from .stores import (
    AggregationsStore,
    AgentsStore,
    AuthTokensStore,
    ClerkingJobsStore,
    paged_job_view,
)


def _create_if_identical(table: dict, key, value) -> None:
    """Reference jfs create semantics: re-creating with identical content is
    a no-op; differing content is an error (jfs_stores/mod.rs:79-89)."""
    if key in table and table[key] != value:
        raise ServerError(f"object already exists: {key}")
    table[key] = value


class MemAuthTokensStore(AuthTokensStore):
    def __init__(self):
        self._lock = threading.RLock()
        self._tokens: dict = {}

    def upsert_auth_token(self, token) -> None:
        with self._lock:
            self._tokens[token.id] = token

    def register_auth_token(self, token) -> bool:
        with self._lock:
            existing = self._tokens.get(token.id)
            if existing is None:
                self._tokens[token.id] = token
                return True
            return existing == token

    def get_auth_token(self, agent_id):
        with self._lock:
            return self._tokens.get(agent_id)

    def delete_auth_token(self, agent_id) -> None:
        with self._lock:
            self._tokens.pop(agent_id, None)


class MemAgentsStore(AgentsStore):
    def __init__(self):
        self._lock = threading.RLock()
        self._agents: dict = {}
        self._profiles: dict = {}
        self._keys: dict = {}  # EncryptionKeyId -> SignedEncryptionKey

    def create_agent(self, agent) -> None:
        with self._lock:
            _create_if_identical(self._agents, agent.id, agent)

    def get_agent(self, agent_id):
        with self._lock:
            return self._agents.get(agent_id)

    def upsert_profile(self, profile) -> None:
        with self._lock:
            self._profiles[profile.owner] = profile

    def get_profile(self, owner_id):
        with self._lock:
            return self._profiles.get(owner_id)

    def create_encryption_key(self, signed_key) -> None:
        with self._lock:
            _create_if_identical(self._keys, signed_key.body.id, signed_key)

    def get_encryption_key(self, key_id):
        with self._lock:
            return self._keys.get(key_id)

    def suggest_committee(self) -> list:
        from ..protocol import ClerkCandidate

        with self._lock:
            by_signer: dict = {}
            for signed in self._keys.values():
                by_signer.setdefault(signed.signer, []).append(signed.body.id)
            return [
                ClerkCandidate(id=signer, keys=keys)
                for signer, keys in by_signer.items()
                if signer in self._agents
            ]


class MemAggregationsStore(AggregationsStore):
    def __init__(self):
        self._lock = threading.RLock()
        self._aggregations: dict = {}
        self._committees: dict = {}  # AggregationId -> Committee
        self._participations: dict = {}  # AggregationId -> {ParticipationId: Participation}
        self._snapshots: dict = {}  # AggregationId -> {SnapshotId: Snapshot}
        self._snapshot_members: dict = {}  # SnapshotId -> [ParticipationId]
        self._snapshot_masks: dict = {}  # SnapshotId -> [Encryption]

    def list_aggregations(self, filter: Optional[str], recipient) -> list:
        with self._lock:
            out = []
            for agg in self._aggregations.values():
                if filter is not None and filter not in agg.title:
                    continue
                if recipient is not None and agg.recipient != recipient:
                    continue
                out.append(agg.id)
            return out

    def create_aggregation(self, aggregation) -> None:
        with self._lock:
            _create_if_identical(self._aggregations, aggregation.id, aggregation)
            self._participations.setdefault(aggregation.id, {})
            self._snapshots.setdefault(aggregation.id, {})

    def get_aggregation(self, aggregation_id):
        with self._lock:
            return self._aggregations.get(aggregation_id)

    def delete_aggregation(self, aggregation_id) -> None:
        with self._lock:
            self._aggregations.pop(aggregation_id, None)
            self._committees.pop(aggregation_id, None)
            self._participations.pop(aggregation_id, None)
            for snap_id in self._snapshots.pop(aggregation_id, {}):
                self._snapshot_members.pop(snap_id, None)
                self._snapshot_masks.pop(snap_id, None)

    def get_committee(self, aggregation_id):
        with self._lock:
            return self._committees.get(aggregation_id)

    def create_committee(self, committee) -> None:
        with self._lock:
            _create_if_identical(self._committees, committee.aggregation, committee)

    def create_participation(self, participation) -> None:
        with self._lock:
            agg = participation.aggregation
            if agg not in self._aggregations:
                raise InvalidRequestError(f"no aggregation {agg}")
            _create_if_identical(self._participations[agg], participation.id, participation)

    def create_participations(self, participations) -> None:
        # atomic batch: validate everything under the lock, then commit —
        # a mid-batch conflict/missing aggregation leaves no partial state
        participations = list(participations)
        with self._lock:
            staged: dict = {}
            for p in participations:
                if p.aggregation not in self._aggregations:
                    raise InvalidRequestError(f"no aggregation {p.aggregation}")
                prev = staged.get(p.id)
                if prev is not None and prev != p:
                    raise ServerError(f"object already exists: {p.id}")
                existing = self._participations[p.aggregation].get(p.id)
                if existing is not None and existing != p:
                    raise ServerError(f"object already exists: {p.id}")
                staged[p.id] = p
            for p in staged.values():
                self._participations[p.aggregation][p.id] = p

    def create_snapshot(self, snapshot) -> None:
        with self._lock:
            self._snapshots.setdefault(snapshot.aggregation, {})
            _create_if_identical(self._snapshots[snapshot.aggregation], snapshot.id, snapshot)

    def list_snapshots(self, aggregation_id) -> list:
        with self._lock:
            return list(self._snapshots.get(aggregation_id, {}).keys())

    def get_snapshot(self, aggregation_id, snapshot_id):
        with self._lock:
            return self._snapshots.get(aggregation_id, {}).get(snapshot_id)

    def count_participations(self, aggregation_id) -> int:
        with self._lock:
            return len(self._participations.get(aggregation_id, {}))

    def iter_participations(self, aggregation_id):
        with self._lock:
            table = self._participations.get(aggregation_id, {})
            return iter(sorted(table.values(), key=lambda p: str(p.id)))

    def discard_participations(self, aggregation_id, participation_ids) -> None:
        with self._lock:
            table = self._participations.get(aggregation_id)
            if table is None:
                return
            for pid in participation_ids:
                table.pop(pid, None)

    def snapshot_participations(self, aggregation_id, snapshot_id) -> None:
        with self._lock:
            # write-once: retries must not re-freeze a different membership
            if snapshot_id in self._snapshot_members:
                return
            members = list(self._participations.get(aggregation_id, {}).keys())
            self._snapshot_members[snapshot_id] = members

    def iter_snapped_participations(self, aggregation_id, snapshot_id):
        with self._lock:
            members = self._snapshot_members.get(snapshot_id, [])
            table = self._participations.get(aggregation_id, {})
            return iter([table[pid] for pid in members if pid in table])

    def create_snapshot_mask(self, snapshot_id, mask: list) -> None:
        with self._lock:
            self._snapshot_masks[snapshot_id] = list(mask)

    def get_snapshot_mask(self, snapshot_id):
        with self._lock:
            return self._snapshot_masks.get(snapshot_id)

    def count_snapshot_mask(self, snapshot_id):
        with self._lock:
            mask = self._snapshot_masks.get(snapshot_id)
            return None if mask is None else len(mask)

    def get_snapshot_mask_range(self, snapshot_id, start, count):
        # grab the reference under the lock, slice outside: the mask list
        # is replaced whole by create_snapshot_mask, never mutated in
        # place, so concurrent range readers don't convoy on the lock
        with self._lock:
            mask = self._snapshot_masks.get(snapshot_id)
        if mask is None:
            return None
        if start < 0 or count < 0:
            return []
        return mask[start : start + count]


class MemClerkingJobsStore(ClerkingJobsStore):
    def __init__(self):
        self._lock = threading.RLock()
        # per-clerk FIFO of pending job ids: poll peeks the head in O(1)
        # instead of rebuilding/scanning a job list (done jobs are lazily
        # popped off the head on the next poll)
        self._queues: dict = {}  # AgentId -> deque[ClerkingJobId]
        self._jobs: dict = {}  # ClerkingJobId -> ClerkingJob
        self._done: set = set()  # ClerkingJobIds with a posted result
        self._results: dict = {}  # SnapshotId -> {ClerkingJobId: ClerkingResult}

    def enqueue_clerking_job(self, job) -> None:
        with self._lock:
            # idempotent under snapshot retries (job ids are deterministic)
            if job.id in self._jobs:
                return
            self._jobs[job.id] = job
            self._queues.setdefault(job.clerk, collections.deque()).append(job.id)

    def poll_clerking_job(self, clerk_id):
        with self._lock:
            queue = self._queues.get(clerk_id)
            while queue:
                job_id = queue[0]
                if job_id in self._done:
                    queue.popleft()  # amortized O(1): each id pops once
                    continue
                return paged_job_view(self._jobs[job_id])
            return None

    def get_clerking_job(self, clerk_id, job_id):
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.clerk != clerk_id:
                return None
            return job

    def get_clerking_job_chunk(self, clerk_id, job_id, start, count):
        # grab the job under the lock, slice outside: the encryption
        # column is immutable after enqueue, so concurrent chunk readers
        # (prefetch pipelines, many clerks) don't convoy on the lock
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None or job.clerk != clerk_id:
            return None
        if start < 0 or count < 0:
            return []
        return job.encryptions[start : start + count]

    def create_clerking_result(self, result) -> None:
        with self._lock:
            job = self._jobs.get(result.job)
            if job is None:
                raise InvalidRequestError(f"no job {result.job}")
            self._results.setdefault(job.snapshot, {})[job.id] = result
            self._done.add(job.id)

    def complete_clerking_job(self, clerk_id, job_id) -> None:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.clerk != clerk_id:
                raise InvalidRequestError(f"no job {job_id}")
            self._done.add(job_id)

    def list_results(self, snapshot_id) -> list:
        # job-id order: every store returns the same canonical ordering
        # (sqlite's ORDER BY job), so snapshot-result bodies are
        # byte-stable across backends (asserted by test_replay_interop)
        with self._lock:
            keys = list(self._results.get(snapshot_id, {}).keys())
        return sorted(keys, key=str)  # O(n log n) outside the lock

    def get_result(self, snapshot_id, job_id):
        with self._lock:
            return self._results.get(snapshot_id, {}).get(job_id)

    def get_results(self, snapshot_id) -> list:
        # copy the table under the lock, sort + build outside
        with self._lock:
            table = dict(self._results.get(snapshot_id, {}))
        return [table[job_id] for job_id in sorted(table.keys(), key=str)]

    def count_results(self, snapshot_id) -> int:
        with self._lock:
            return len(self._results.get(snapshot_id, {}))

    def get_results_range(self, snapshot_id, start, count) -> list:
        if start < 0 or count < 0:
            return []
        with self._lock:
            table = dict(self._results.get(snapshot_id, {}))
        ordered = sorted(table.keys(), key=str)[start : start + count]
        return [table[job_id] for job_id in ordered]
