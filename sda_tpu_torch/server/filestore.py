"""Durable JSON-file store backend (copy of ``sda_tpu/server/filestore.py``).

Equivalent of the SDA server's jfs stores (server/src/jfs_stores/): one JSON
file per object, idempotent create-if-identical semantics (mod.rs:79-89),
per-aggregation participation directories (aggregations.rs:47-50), and
durable per-clerk job queues laid out as ``queue/<clerk>/``,
``results/<snapshot>/``, ``done/<clerk>/`` with move-after-result
(clerking_jobs.rs:36-59) — a crashed clerk re-polls the same job.

Everything is written atomically (tmp + rename) so a crashed server restarts
from consistent state (SURVEY.md §5). The layout is ``sda_tpu``'s, so a
store directory either package writes opens in the other.
"""

from __future__ import annotations

import json
import os
import struct

from ..protocol import (
    Agent,
    ClerkCandidate,
    ClerkingJob,
    ClerkingResult,
    Committee,
    Aggregation,
    Encryption,
    InvalidRequestError,
    Labelled,
    Participation,
    Profile,
    ServerError,
    Snapshot,
    signed_encryption_key_from_json,
)
from ..protocol.ids import (
    AgentId,
    ClerkingJobId,
    SnapshotId,
)
from ..utils.jsondir import ConflictError, JsonDir
from .stores import (
    AggregationsStore,
    AgentsStore,
    AuthTokensStore,
    ClerkingJobsStore,
    job_chunk_size,
    job_page_threshold,
    result_page_threshold,
    split_small_column,
)


def _create(jdir: JsonDir, id, payload) -> None:
    """create-if-identical, mapped onto the server error type."""
    try:
        jdir.create(id, payload)
    except ConflictError as e:
        raise ServerError(str(e))


class FileAuthTokensStore(AuthTokensStore):
    def __init__(self, path):
        self.dir = JsonDir(str(path))

    def upsert_auth_token(self, token) -> None:
        self.dir.put(token.id, {"id": str(token.id), "body": token.body})

    def register_auth_token(self, token) -> bool:
        # JsonDir.create is atomic under the per-directory lock
        try:
            self.dir.create(token.id, {"id": str(token.id), "body": token.body})
            return True
        except ConflictError:
            return False

    def get_auth_token(self, agent_id):
        payload = self.dir.get(agent_id)
        if payload is None:
            return None
        return Labelled(AgentId(payload["id"]), payload["body"])

    def delete_auth_token(self, agent_id) -> None:
        self.dir.delete(agent_id)


class FileAgentsStore(AgentsStore):
    def __init__(self, path):
        path = str(path)
        self.agents = JsonDir(os.path.join(path, "agents"))
        self.profiles = JsonDir(os.path.join(path, "profiles"))
        self.keys = JsonDir(os.path.join(path, "keys"))

    def create_agent(self, agent) -> None:
        _create(self.agents, agent.id, agent.to_json())

    def get_agent(self, agent_id):
        payload = self.agents.get(agent_id)
        return None if payload is None else Agent.from_json(payload)

    def upsert_profile(self, profile) -> None:
        self.profiles.put(profile.owner, profile.to_json())

    def get_profile(self, owner_id):
        payload = self.profiles.get(owner_id)
        return None if payload is None else Profile.from_json(payload)

    def create_encryption_key(self, signed_key) -> None:
        _create(self.keys, signed_key.body.id, signed_key.to_json())

    def get_encryption_key(self, key_id):
        payload = self.keys.get(key_id)
        return None if payload is None else signed_encryption_key_from_json(payload)

    def suggest_committee(self) -> list:
        by_signer: dict = {}
        for key_id in self.keys.list_ids():
            signed = signed_encryption_key_from_json(self.keys.get(key_id))
            by_signer.setdefault(signed.signer, []).append(signed.body.id)
        return [
            ClerkCandidate(id=signer, keys=keys)
            for signer, keys in by_signer.items()
            if self.agents.get(signer) is not None
        ]


class FileAggregationsStore(AggregationsStore):
    def __init__(self, path):
        self.root = str(path)
        self.aggregations = JsonDir(os.path.join(self.root, "aggregations"))
        self.committees = JsonDir(os.path.join(self.root, "committees"))
        self.members = JsonDir(os.path.join(self.root, "snapshot_members"))
        self.masks = JsonDir(os.path.join(self.root, "snapshot_masks"))

    def _participations(self, aggregation_id) -> JsonDir:
        return JsonDir(os.path.join(self.root, "participations", str(aggregation_id)))

    def _snapshots(self, aggregation_id) -> JsonDir:
        return JsonDir(os.path.join(self.root, "snapshots", str(aggregation_id)))

    def list_aggregations(self, filter, recipient) -> list:
        out = []
        for agg_id in self.aggregations.list_ids():
            agg = Aggregation.from_json(self.aggregations.get(agg_id))
            if filter is not None and filter not in agg.title:
                continue
            if recipient is not None and agg.recipient != recipient:
                continue
            out.append(agg.id)
        return out

    def create_aggregation(self, aggregation) -> None:
        _create(self.aggregations, aggregation.id, aggregation.to_json())

    def get_aggregation(self, aggregation_id):
        payload = self.aggregations.get(aggregation_id)
        return None if payload is None else Aggregation.from_json(payload)

    def delete_aggregation(self, aggregation_id) -> None:
        import shutil

        for snap_id in self._snapshots(aggregation_id).list_ids():
            self.members.delete(snap_id)
            self.masks.delete(snap_id)
            for path in self._mask_paths(snap_id):
                if os.path.exists(path):
                    os.unlink(path)
        self.aggregations.delete(aggregation_id)
        self.committees.delete(aggregation_id)
        for sub in ("participations", "snapshots"):
            path = os.path.join(self.root, sub, str(aggregation_id))
            shutil.rmtree(path, ignore_errors=True)

    def get_committee(self, aggregation_id):
        payload = self.committees.get(aggregation_id)
        return None if payload is None else Committee.from_json(payload)

    def create_committee(self, committee) -> None:
        _create(self.committees, committee.aggregation, committee.to_json())

    def create_participation(self, participation) -> None:
        if self.aggregations.get(participation.aggregation) is None:
            raise InvalidRequestError(f"no aggregation {participation.aggregation}")
        _create(
            self._participations(participation.aggregation),
            participation.id,
            participation.to_json(),
        )

    def create_participations(self, participations) -> None:
        # validate the whole batch (aggregation existence + conflicts)
        # before the first write, so a mid-batch reject leaves no partial
        # state from *this* batch. File-per-object gives no multi-file
        # transaction: a crash mid-loop can still persist a prefix, which
        # is exactly the durability model of N single uploads (each
        # already-written file is a valid, idempotently replayable row).
        participations = list(participations)
        staged: dict = {}
        dirs: dict = {}
        for p in participations:
            if p.aggregation not in dirs:
                if self.aggregations.get(p.aggregation) is None:
                    raise InvalidRequestError(f"no aggregation {p.aggregation}")
                dirs[p.aggregation] = self._participations(p.aggregation)
            payload = p.to_json()
            prev = staged.get(p.id)
            if prev is not None and prev[1] != payload:
                raise ServerError(f"object already exists: {p.id}")
            existing = dirs[p.aggregation].get(p.id)
            if existing is not None and existing != payload:
                raise ServerError(f"object already exists: {p.id}")
            staged[p.id] = (p.aggregation, payload)
        for pid, (agg, payload) in staged.items():
            # _create (not put): keeps the per-directory lock's conflict
            # check against writers racing this batch
            _create(dirs[agg], pid, payload)

    def create_snapshot(self, snapshot) -> None:
        _create(self._snapshots(snapshot.aggregation), snapshot.id, snapshot.to_json())

    def list_snapshots(self, aggregation_id) -> list:
        return [SnapshotId(s) for s in self._snapshots(aggregation_id).list_ids()]

    def get_snapshot(self, aggregation_id, snapshot_id):
        payload = self._snapshots(aggregation_id).get(snapshot_id)
        return None if payload is None else Snapshot.from_json(payload)

    def count_participations(self, aggregation_id) -> int:
        return len(self._participations(aggregation_id).list_ids())

    def iter_participations(self, aggregation_id):
        table = self._participations(aggregation_id)
        for pid in sorted(table.list_ids(), key=str):
            payload = table.get(pid)
            if payload is None:
                continue  # raced a concurrent delete — nothing to copy
            yield Participation.from_json(payload)

    def discard_participations(self, aggregation_id, participation_ids) -> None:
        table = self._participations(aggregation_id)
        for pid in participation_ids:
            table.delete(pid)

    def snapshot_participations(self, aggregation_id, snapshot_id) -> None:
        # write-once: a retry after a partial snapshot must not re-freeze a
        # different membership (participations may have arrived in between)
        members = self._participations(aggregation_id).list_ids()
        self.members.create_once(snapshot_id, members)

    def iter_snapped_participations(self, aggregation_id, snapshot_id):
        members = self.members.get(snapshot_id) or []
        table = self._participations(aggregation_id)
        for pid in members:
            payload = table.get(pid)
            if payload is None:
                # the frozen member list IS the count the transpose and
                # number_of_participations report; silently skipping a
                # missing payload (partial write, manual cleanup) would
                # let the count and the rows actually transposed diverge
                raise ServerError(
                    f"snapshot {snapshot_id}: snapped participation "
                    f"{pid} has no payload on disk — store corrupted?"
                )
            yield Participation.from_json(payload)

    def count_participations_snapshot(self, aggregation_id, snapshot_id) -> int:
        # the default parses every member's JSON just to count; the
        # frozen id list already knows (a snapped member whose payload
        # later goes missing makes iter_snapped_participations raise, so
        # this count can never silently disagree with the rows iterated)
        return len(self.members.get(snapshot_id) or [])

    #: above this many snapped participations the transpose switches from
    #: the one-pass in-memory default to per-clerk column scans
    TRANSPOSE_STREAM_THRESHOLD = 10_000

    def validate_snapshot_clerk_jobs(
        self, aggregation_id, snapshot_id, clerks_number: int
    ) -> None:
        """Streaming cohorts only: one validation pass over the snapped
        bodies before the pipeline enqueues anything (the eager
        below-threshold path is safe by construction — see the base
        docstring). Also surfaces missing payload files up front via
        iter_snapped_participations' loud-raise, narrowing the window in
        which a mid-column-scan disappearance could strand phantom jobs.
        Cost: one extra directory scan on top of the ``clerks`` column
        scans (~1/clerks overhead)."""
        n = self.count_participations_snapshot(aggregation_id, snapshot_id)
        if n <= self.TRANSPOSE_STREAM_THRESHOLD:
            return
        for p in self.iter_snapped_participations(aggregation_id, snapshot_id):
            if len(p.clerk_encryptions) != clerks_number:
                raise ServerError(
                    f"snapshot {snapshot_id}: participation {p.id} has "
                    f"{len(p.clerk_encryptions)} clerk encryptions, "
                    f"expected {clerks_number} — refusing to enqueue a "
                    "partial transpose"
                )

    def iter_snapshot_clerk_jobs_data(
        self, aggregation_id, snapshot_id, clerks_number: int
    ):
        """Memory-bounded transpose for large cohorts (SURVEY hard part
        #6: the SDA server's jfs path materializes every ciphertext at
        once, stores.rs:86-101; its mongo path spills to disk instead).

        Below the threshold: the default single-pass transpose (reads
        each participation file once). Above it: one pass per clerk,
        yielding a single clerk's ciphertext column at a time — the
        snapshot pipeline enqueues each job before the next column is
        built, so peak memory is one column (1/clerks of the cohort)
        plus one serialized job, at the cost of ``clerks`` directory
        scans."""
        n = self.count_participations_snapshot(aggregation_id, snapshot_id)
        if n <= self.TRANSPOSE_STREAM_THRESHOLD:
            return super().iter_snapshot_clerk_jobs_data(
                aggregation_id, snapshot_id, clerks_number
            )

        def columns():
            for ix in range(clerks_number):
                yield [
                    p.clerk_encryptions[ix][1]
                    for p in self.iter_snapped_participations(
                        aggregation_id, snapshot_id
                    )
                ]

        return columns()

    def iter_snapshot_clerk_jobs_chunks(
        self, aggregation_id, snapshot_id, clerks_number: int, chunk_size: int
    ):
        """Chunked transpose for large cohorts: each chunk re-reads only
        its own slice of the frozen member list, so peak memory per clerk
        is one chunk of ciphertexts instead of one column. Below the
        threshold the default (re-chunked eager transpose) is cheaper —
        one file read per participation instead of ``clerks``."""
        n = self.count_participations_snapshot(aggregation_id, snapshot_id)
        if n <= self.TRANSPOSE_STREAM_THRESHOLD:
            return super().iter_snapshot_clerk_jobs_chunks(
                aggregation_id, snapshot_id, clerks_number, chunk_size
            )
        members = self.members.get(snapshot_id) or []
        table = self._participations(aggregation_id)

        def column_chunks(ix: int):
            for lo in range(0, len(members), chunk_size):
                block = []
                for pid in members[lo : lo + chunk_size]:
                    payload = table.get(pid)
                    if payload is None:
                        raise ServerError(
                            f"snapshot {snapshot_id}: snapped participation "
                            f"{pid} has no payload on disk — store corrupted?"
                        )
                    block.append(
                        Participation.from_json(payload).clerk_encryptions[ix][1]
                    )
                yield block

        return (column_chunks(ix) for ix in range(clerks_number))

    # -- snapshot masks ------------------------------------------------------
    # Two layouts, mirroring FileClerkingJobsStore's columns: small masks
    # stay a single JSON list in the masks JsonDir; masks above
    # result_page_threshold() are EXTERNALIZED — the JsonDir payload
    # becomes the marker ``{"externalized": n}`` and the encryptions live
    # in ``mask_columns/<snapshot>.jsonl`` with an n+1 little-endian
    # uint64 byte-offset sidecar, so a range read is two seeks, never a
    # blob parse. Layout is decided at WRITE time; the wire shape is
    # decided per call in the service, so either layout serves both.

    def _mask_paths(self, snapshot_id):
        d = os.path.join(self.root, "mask_columns")
        os.makedirs(d, exist_ok=True)
        return (
            os.path.join(d, f"{snapshot_id}.jsonl"),
            os.path.join(d, f"{snapshot_id}.idx"),
        )

    def _read_mask_range(self, snapshot_id, start: int, end: int) -> list:
        # lock-free like _read_column_range: idx + jsonl are immutable
        # once the snapshot-mask metadata is visible
        if end <= start:
            return []
        data_path, idx_path = self._mask_paths(snapshot_id)
        with open(idx_path, "rb") as xf:
            xf.seek(start * 8)
            raw = xf.read((end - start + 1) * 8)
        offs = struct.unpack(f"<{len(raw) // 8}Q", raw)
        if len(offs) < 2:
            return []
        with open(data_path, "rb") as df:
            df.seek(offs[0])
            blob = df.read(offs[-1] - offs[0])
        return [Encryption.from_json(json.loads(line)) for line in blob.splitlines()]

    def create_snapshot_mask(self, snapshot_id, mask) -> None:
        mask = list(mask)
        if len(mask) <= result_page_threshold():
            self.masks.put(snapshot_id, [e.to_json() for e in mask])
            return
        # externalized: column files land atomically first, the marker —
        # the blob's visibility point — last, so a crash mid-write leaves
        # the mask absent and the snapshot pipeline's retry rewrites it
        data_path, idx_path = self._mask_paths(snapshot_id)
        tmp_data, tmp_idx = data_path + ".tmp", idx_path + ".tmp"
        try:
            with open(tmp_data, "wb") as df, open(tmp_idx, "wb") as xf:
                off = 0
                xf.write(struct.pack("<Q", 0))
                for e in mask:
                    line = json.dumps(e.to_json()).encode("utf-8") + b"\n"
                    df.write(line)
                    off += len(line)
                    xf.write(struct.pack("<Q", off))
            os.replace(tmp_data, data_path)
            os.replace(tmp_idx, idx_path)
        finally:
            for tmp in (tmp_data, tmp_idx):
                if os.path.exists(tmp):
                    os.unlink(tmp)
        self.masks.put(snapshot_id, {"externalized": len(mask)})

    def get_snapshot_mask(self, snapshot_id):
        payload = self.masks.get(snapshot_id)
        if payload is None:
            return None
        if isinstance(payload, dict):
            return self._read_mask_range(snapshot_id, 0, int(payload["externalized"]))
        return [Encryption.from_json(e) for e in payload]

    def count_snapshot_mask(self, snapshot_id):
        payload = self.masks.get(snapshot_id)
        if payload is None:
            return None
        if isinstance(payload, dict):
            return int(payload["externalized"])
        return len(payload)

    def get_snapshot_mask_range(self, snapshot_id, start, count):
        payload = self.masks.get(snapshot_id)
        if payload is None:
            return None
        if start < 0 or count < 0:
            return []
        if isinstance(payload, dict):
            end = min(start + count, int(payload["externalized"]))
            return self._read_mask_range(snapshot_id, start, end)
        return [Encryption.from_json(e) for e in payload[start : start + count]]


class FileClerkingJobsStore(ClerkingJobsStore):
    """Two column layouts, mirroring the sqlite backend:

    - INLINE (legacy / small jobs): the full job JSON in the queue dir.
    - EXTERNALIZED: the queue JSON is metadata only
      (``total_encryptions`` set) and the ciphertext column lives in
      ``columns/<job-id>.jsonl`` (one encryption per line) with a
      sidecar ``columns/<job-id>.idx`` of n+1 little-endian uint64 byte
      offsets — a chunk read is two seeks, never a column parse.
    """

    def __init__(self, path):
        self.root = str(path)

    def _queue(self, clerk_id) -> JsonDir:
        return JsonDir(os.path.join(self.root, "queue", str(clerk_id)))

    def _done(self, clerk_id) -> JsonDir:
        return JsonDir(os.path.join(self.root, "done", str(clerk_id)))

    def _results(self, snapshot_id) -> JsonDir:
        return JsonDir(os.path.join(self.root, "results", str(snapshot_id)))

    def _column_paths(self, job_id):
        d = os.path.join(self.root, "columns")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{job_id}.jsonl"), os.path.join(d, f"{job_id}.idx")

    def _read_column_range(self, job_id, start: int, end: int) -> list:
        """Ciphertexts [start, end) via the offset sidecar: seek into the
        idx for the bounding offsets, then one ranged read of the jsonl.

        Deliberately lock-free: both files are written whole before the
        job metadata lands (tmp + os.replace) and are immutable after,
        so concurrent chunk readers never contend on a store lock."""
        if end <= start:
            return []
        data_path, idx_path = self._column_paths(job_id)
        with open(idx_path, "rb") as xf:
            xf.seek(start * 8)
            raw = xf.read((end - start + 1) * 8)
        offs = struct.unpack(f"<{len(raw) // 8}Q", raw)
        if len(offs) < 2:
            return []
        with open(data_path, "rb") as df:
            df.seek(offs[0])
            blob = df.read(offs[-1] - offs[0])
        return [Encryption.from_json(json.loads(line)) for line in blob.splitlines()]

    def _deliver(self, payload):
        """Stored payload -> wire body under the current paging threshold."""
        job = ClerkingJob.from_json(payload)
        total = (
            job.total_encryptions
            if job.total_encryptions is not None
            else len(job.encryptions)
        )
        if total > job_page_threshold():
            return ClerkingJob(
                id=job.id,
                clerk=job.clerk,
                aggregation=job.aggregation,
                snapshot=job.snapshot,
                encryptions=[],
                total_encryptions=total,
                chunk_size=job_chunk_size(),
            )
        if job.total_encryptions is None:
            return job  # inline + small: original shape, untouched
        # externalized + small: reassemble the monolithic wire body
        return ClerkingJob(
            id=job.id,
            clerk=job.clerk,
            aggregation=job.aggregation,
            snapshot=job.snapshot,
            encryptions=self._read_column_range(job.id, 0, total),
        )

    def enqueue_clerking_job(self, job) -> None:
        # idempotent under snapshot retries (job ids are deterministic): a
        # job already queued or already completed is not enqueued again
        if len(job.encryptions) > job_page_threshold():
            self.enqueue_clerking_job_chunked(
                ClerkingJob(
                    id=job.id,
                    clerk=job.clerk,
                    aggregation=job.aggregation,
                    snapshot=job.snapshot,
                    encryptions=[],
                ),
                [job.encryptions],
            )
            return
        if self._done(job.clerk).get(job.id) is not None:
            return
        _create(self._queue(job.clerk), job.id, job.to_json())

    def enqueue_clerking_job_chunked(self, job, chunks) -> None:
        """Streaming enqueue into the externalized layout: column ranges
        append to tmp files (one chunk in memory at a time), both files
        land atomically via os.replace, and the queue metadata JSON —
        the job's visibility point — is written last, so a crash
        mid-column leaves no pollable job and the deterministic-id retry
        rewrites the orphaned tmp/column files from scratch."""
        if (
            self._done(job.clerk).get(job.id) is not None
            or self._queue(job.clerk).get(job.id) is not None
        ):
            return  # idempotent: don't consume the iterator either
        column, chunks = split_small_column(chunks, job_page_threshold())
        if column is not None:
            # small column: keep the legacy inline layout
            job.encryptions = column
            _create(self._queue(job.clerk), job.id, job.to_json())
            return
        data_path, idx_path = self._column_paths(job.id)
        tmp_data, tmp_idx = data_path + ".tmp", idx_path + ".tmp"
        total = 0
        try:
            with open(tmp_data, "wb") as df, open(tmp_idx, "wb") as xf:
                off = 0
                xf.write(struct.pack("<Q", 0))
                for block in chunks:
                    lines = [
                        json.dumps(e.to_json()).encode("utf-8") + b"\n"
                        for e in block
                    ]
                    df.write(b"".join(lines))
                    for line in lines:
                        off += len(line)
                        xf.write(struct.pack("<Q", off))
                    total += len(block)
            os.replace(tmp_data, data_path)
            os.replace(tmp_idx, idx_path)
        finally:
            for tmp in (tmp_data, tmp_idx):
                if os.path.exists(tmp):
                    os.unlink(tmp)
        meta = ClerkingJob(
            id=job.id,
            clerk=job.clerk,
            aggregation=job.aggregation,
            snapshot=job.snapshot,
            encryptions=[],
            total_encryptions=total,
        )
        _create(self._queue(job.clerk), job.id, meta.to_json())

    def poll_clerking_job(self, clerk_id):
        queue = self._queue(clerk_id)
        ids = queue.list_ids()
        if not ids:
            return None
        return self._deliver(queue.get(ids[0]))

    def get_clerking_job(self, clerk_id, job_id):
        payload = self._queue(clerk_id).get(job_id) or self._done(clerk_id).get(job_id)
        return None if payload is None else self._deliver(payload)

    def get_clerking_job_chunk(self, clerk_id, job_id, start, count):
        payload = self._queue(clerk_id).get(job_id) or self._done(clerk_id).get(job_id)
        if payload is None:
            return None
        if start < 0 or count < 0:
            return []
        job = ClerkingJob.from_json(payload)
        if job.total_encryptions is None:
            return job.encryptions[start : start + count]  # inline layout
        end = min(start + count, job.total_encryptions)
        return self._read_column_range(job.id, start, end)

    def create_clerking_result(self, result) -> None:
        # raw stored payload, not the delivered view: the done-dir copy
        # must keep the stored layout (meta for externalized jobs) so the
        # column file stays addressable after completion
        payload = self._queue(result.clerk).get(result.job) or self._done(
            result.clerk
        ).get(result.job)
        if payload is None:
            raise InvalidRequestError(f"no job {result.job}")
        job = ClerkingJob.from_json(payload)
        self._results(job.snapshot).put(job.id, result.to_json())
        # move queue -> done so the job is no longer pollable but stays auditable
        self._done(job.clerk).put(job.id, payload)
        self._queue(job.clerk).delete(job.id)

    def complete_clerking_job(self, clerk_id, job_id) -> None:
        payload = self._queue(clerk_id).get(job_id)
        if payload is None:
            if self._done(clerk_id).get(job_id) is not None:
                return  # already retired — idempotent replay
            raise InvalidRequestError(f"no job {job_id}")
        self._done(clerk_id).put(job_id, payload)
        self._queue(clerk_id).delete(job_id)

    def list_results(self, snapshot_id) -> list:
        return [ClerkingJobId(j) for j in self._results(snapshot_id).list_ids()]

    def get_result(self, snapshot_id, job_id):
        payload = self._results(snapshot_id).get(job_id)
        return None if payload is None else ClerkingResult.from_json(payload)

    def get_results(self, snapshot_id) -> list:
        # one directory scan in list_ids order (canonical str sort)
        results = self._results(snapshot_id)
        out = []
        for job_id in results.list_ids():
            payload = results.get(job_id)
            if payload is None:
                raise ServerError("inconsistent storage")
            out.append(ClerkingResult.from_json(payload))
        return out

    def count_results(self, snapshot_id) -> int:
        return len(self._results(snapshot_id).list_ids())

    def get_results_range(self, snapshot_id, start, count) -> list:
        # file-per-result: the range is an id-list slice, reading only
        # the requested files (list_ids is already the canonical order)
        if start < 0 or count < 0:
            return []
        results = self._results(snapshot_id)
        out = []
        for job_id in results.list_ids()[start : start + count]:
            payload = results.get(job_id)
            if payload is None:
                raise ServerError("inconsistent storage")
            out.append(ClerkingResult.from_json(payload))
        return out
