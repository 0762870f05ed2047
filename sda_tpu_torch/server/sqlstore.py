"""Production store backend: sqlite (copy of ``sda_tpu/server/sqlstore.py``).

Fills the role of the SDA server's MongoDB backend (server-store-mongodb/):
durable, indexed, and — the scalability-critical part — a **streaming
server-side transpose**. The SDA server runs the (participants x clerks)
ciphertext transpose as a Mongo aggregation pipeline with disk spill
($unwind/$group, aggregations.rs:164-195); here each clerk's column is
extracted by the SQL engine with ``json_extract`` over an indexed snapshot
scan, one streaming pass per clerk, so no participation set is ever
materialized in RAM (contrast the generic in-memory transpose,
stores.iter_snapshot_clerk_jobs_data).

Job documents carry a ``done`` flag instead of queue-file moves, matching
the mongo store's shape (clerking_jobs.rs:36-76).

Multi-process sharing: like the SDA server's mongo backend — where any
number of server processes serve one datastore (server-store-mongodb/
src/lib.rs:64-84, unique-index upsert Daos at lib.rs:86-151) — one
sqlite file may back several ``sdad`` processes at once. WAL keeps
readers unblocked by the (single) writer, ``busy_timeout`` turns
cross-process write contention into bounded waiting instead of
``database is locked`` errors, and every check-then-act sequence runs
inside ``BEGIN IMMEDIATE`` so the read half of a read-modify-write
holds the write lock — two processes racing create-if-identical or the
job-done flip serialize instead of interleaving.

The schema is ``sda_tpu``'s, so a database either package writes opens in
the other.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..protocol import (
    Agent,
    Aggregation,
    ClerkCandidate,
    ClerkingJob,
    ClerkingResult,
    Committee,
    Encryption,
    InvalidRequestError,
    Labelled,
    Participation,
    Profile,
    ServerError,
    Snapshot,
    signed_encryption_key_from_json,
)
from ..protocol.ids import AgentId, AggregationId, ClerkingJobId, SnapshotId
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

_SCHEMA = """
CREATE TABLE IF NOT EXISTS agents (id TEXT PRIMARY KEY, body TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS profiles (owner TEXT PRIMARY KEY, body TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS enc_keys (
    id TEXT PRIMARY KEY, signer TEXT NOT NULL, body TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS enc_keys_signer ON enc_keys (signer);
CREATE TABLE IF NOT EXISTS auth_tokens (agent TEXT PRIMARY KEY, token TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS aggregations (
    id TEXT PRIMARY KEY, title TEXT NOT NULL, recipient TEXT NOT NULL,
    body TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS aggregations_recipient ON aggregations (recipient);
CREATE TABLE IF NOT EXISTS committees (aggregation TEXT PRIMARY KEY, body TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS participations (
    id TEXT PRIMARY KEY, aggregation TEXT NOT NULL, body TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS participations_agg ON participations (aggregation);
CREATE TABLE IF NOT EXISTS snapshots (
    id TEXT PRIMARY KEY, aggregation TEXT NOT NULL, body TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS snapshots_agg ON snapshots (aggregation);
CREATE TABLE IF NOT EXISTS snapshot_members (
    snapshot TEXT NOT NULL, ord INTEGER NOT NULL, participation TEXT NOT NULL,
    PRIMARY KEY (snapshot, ord));
CREATE TABLE IF NOT EXISTS snapshot_masks (snapshot TEXT PRIMARY KEY, body TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS mask_encs (
    snapshot TEXT NOT NULL, pos INTEGER NOT NULL, body TEXT NOT NULL,
    PRIMARY KEY (snapshot, pos)) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS jobs (
    id TEXT PRIMARY KEY, clerk TEXT NOT NULL, snapshot TEXT NOT NULL,
    done INTEGER NOT NULL DEFAULT 0, body TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS jobs_clerk ON jobs (clerk, done);
CREATE TABLE IF NOT EXISTS job_encs (
    job TEXT NOT NULL, pos INTEGER NOT NULL, body TEXT NOT NULL,
    PRIMARY KEY (job, pos)) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS results (
    job TEXT PRIMARY KEY, snapshot TEXT NOT NULL, body TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS results_snapshot ON results (snapshot);
"""


#: cross-process write-contention wait bound (seconds). Long enough to
#: ride out another process's streaming transpose commit; short enough
#: that a wedged writer surfaces as an error rather than a silent hang.
BUSY_TIMEOUT_S = 30.0


class SqliteBackend:
    """Shared write connection + lock, per-thread read connections.

    ``self.lock`` serializes *threads* of one process on the shared
    write connection; ``transaction()`` (BEGIN IMMEDIATE) serializes
    *processes* on the shared file — both are needed: the thread lock
    cannot see other processes, and sqlite's write lock cannot protect
    a Python check-then-act unless the check runs inside an immediate
    transaction.

    Reads take neither lock: each reading thread gets its own
    connection (``threading.local``), and WAL lets any number of
    readers run concurrently with the single writer — so
    ThreadingHTTPServer's per-request threads actually serve chunk
    range-reads in parallel instead of convoying on one shared read
    connection. Thread-local connections are reclaimed when their
    thread dies (thread-per-request server) or at interpreter exit.
    """

    def __init__(self, path):
        path = str(path)
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

        def connect():
            # autocommit mode: transaction boundaries are explicit (BEGIN
            # IMMEDIATE in transaction()); Python's implicit deferred
            # transactions would take the write lock only at the first
            # write, after the check half of check-then-act already ran.
            # timeout=0 so the PRAGMA below is the one place the busy
            # wait is configured.
            conn = sqlite3.connect(
                path, check_same_thread=False, timeout=0, isolation_level=None
            )
            conn.execute(f"PRAGMA busy_timeout={int(BUSY_TIMEOUT_S * 1000)}")
            # the rollback->WAL transition takes an exclusive lock through
            # a path that does NOT invoke the busy handler (observed: two
            # sdad processes booting on one fresh file -> "database is
            # locked" despite the busy_timeout above), so the wait has to
            # live here in a retry loop
            deadline = time.monotonic() + BUSY_TIMEOUT_S
            while True:
                try:
                    conn.execute("PRAGMA journal_mode=WAL")
                    break
                except sqlite3.OperationalError as exc:
                    if "locked" not in str(exc) or time.monotonic() >= deadline:
                        raise
                    time.sleep(0.05)
            return conn

        self.conn = connect()
        self.lock = threading.RLock()
        with self.lock:
            self.conn.executescript(_SCHEMA)
        # reads go through per-thread connections: WAL lets readers run
        # concurrently with the (single) writer, so neither a thread
        # stuck in BEGIN IMMEDIATE's busy wait nor another reader's
        # range scan can stall this thread's polls/status reads.
        # ":memory:" has no shared file — a second connection would be a
        # different database — so reads alias the write connection
        # (under self.lock) there.
        self._memory = path == ":memory:"
        self._connect = connect
        self._readers = threading.local()

    def _read_conn(self):
        """This thread's read connection, created on first use."""
        conn = getattr(self._readers, "conn", None)
        if conn is None:
            conn = self._readers.conn = self._connect()
        return conn

    @contextmanager
    def transaction(self):
        """Thread lock + BEGIN IMMEDIATE: the write lock is taken up
        front, so reads inside the block see a state no other process
        can change before our writes commit."""
        with self.lock:
            self.conn.execute("BEGIN IMMEDIATE")
            try:
                yield self.conn
                self.conn.execute("COMMIT")
            except BaseException:
                # a failed COMMIT must roll back too, or the shared
                # connection stays inside a dead transaction and every
                # later BEGIN fails ("cannot start a transaction within
                # a transaction"). Guarded: some COMMIT failures
                # (SQLITE_FULL/IOERR) auto-roll-back, and a bare
                # ROLLBACK there would mask the real error
                if self.conn.in_transaction:
                    self.conn.execute("ROLLBACK")
                raise

    def execute(self, sql, params=()):
        with self.lock:
            # single-statement writes are atomic on their own; autocommit
            # applies them immediately (no explicit transaction needed)
            return self.conn.execute(sql, params)

    def query_one(self, sql, params=()):
        if self._memory:
            with self.lock:
                return self.conn.execute(sql, params).fetchone()
        return self._read_conn().execute(sql, params).fetchone()

    def query_all(self, sql, params=()):
        if self._memory:
            with self.lock:
                return self.conn.execute(sql, params).fetchall()
        return self._read_conn().execute(sql, params).fetchall()

    def create_row(self, table, id_col, id_val, cols: dict):
        """create-if-identical semantics via INSERT OR conflict check."""
        with self.transaction() as conn:
            row = conn.execute(
                f"SELECT body FROM {table} WHERE {id_col} = ?", (id_val,)
            ).fetchone()
            if row is not None:
                if row[0] != cols["body"]:
                    raise ServerError(f"object already exists: {id_val}")
                return
            names = ", ".join([id_col] + list(cols))
            marks = ", ".join("?" * (1 + len(cols)))
            conn.execute(
                f"INSERT INTO {table} ({names}) VALUES ({marks})",
                (id_val, *cols.values()),
            )


class SqliteAuthTokensStore(AuthTokensStore):
    def __init__(self, backend: SqliteBackend):
        self.db = backend

    def upsert_auth_token(self, token) -> None:
        self.db.execute(
            "INSERT INTO auth_tokens (agent, token) VALUES (?, ?) "
            "ON CONFLICT(agent) DO UPDATE SET token = excluded.token",
            (str(token.id), token.body),
        )

    def register_auth_token(self, token) -> bool:
        with self.db.transaction() as conn:
            row = conn.execute(
                "SELECT token FROM auth_tokens WHERE agent = ?", (str(token.id),)
            ).fetchone()
            if row is None:
                conn.execute(
                    "INSERT INTO auth_tokens (agent, token) VALUES (?, ?)",
                    (str(token.id), token.body),
                )
                return True
            return row[0] == token.body

    def get_auth_token(self, agent_id):
        row = self.db.query_one(
            "SELECT token FROM auth_tokens WHERE agent = ?", (str(agent_id),)
        )
        return None if row is None else Labelled(agent_id, row[0])

    def delete_auth_token(self, agent_id) -> None:
        self.db.execute("DELETE FROM auth_tokens WHERE agent = ?", (str(agent_id),))


class SqliteAgentsStore(AgentsStore):
    def __init__(self, backend: SqliteBackend):
        self.db = backend

    def create_agent(self, agent) -> None:
        self.db.create_row(
            "agents", "id", str(agent.id), {"body": json.dumps(agent.to_json())}
        )

    def get_agent(self, agent_id):
        row = self.db.query_one("SELECT body FROM agents WHERE id = ?", (str(agent_id),))
        return None if row is None else Agent.from_json(json.loads(row[0]))

    def upsert_profile(self, profile) -> None:
        self.db.execute(
            "INSERT INTO profiles (owner, body) VALUES (?, ?) "
            "ON CONFLICT(owner) DO UPDATE SET body = excluded.body",
            (str(profile.owner), json.dumps(profile.to_json())),
        )

    def get_profile(self, owner_id):
        row = self.db.query_one(
            "SELECT body FROM profiles WHERE owner = ?", (str(owner_id),)
        )
        return None if row is None else Profile.from_json(json.loads(row[0]))

    def create_encryption_key(self, signed_key) -> None:
        self.db.create_row(
            "enc_keys",
            "id",
            str(signed_key.body.id),
            {"signer": str(signed_key.signer), "body": json.dumps(signed_key.to_json())},
        )

    def get_encryption_key(self, key_id):
        row = self.db.query_one("SELECT body FROM enc_keys WHERE id = ?", (str(key_id),))
        return None if row is None else signed_encryption_key_from_json(json.loads(row[0]))

    def suggest_committee(self) -> list:
        rows = self.db.query_all(
            "SELECT k.signer, k.id FROM enc_keys k JOIN agents a ON a.id = k.signer "
            "ORDER BY k.signer, k.id"
        )
        out: dict = {}
        for signer, key_id in rows:
            out.setdefault(signer, []).append(key_id)
        from ..protocol.ids import EncryptionKeyId

        return [
            ClerkCandidate(id=AgentId(s), keys=[EncryptionKeyId(k) for k in keys])
            for s, keys in out.items()
        ]


class SqliteAggregationsStore(AggregationsStore):
    def __init__(self, backend: SqliteBackend):
        self.db = backend

    def list_aggregations(self, filter: Optional[str], recipient) -> list:
        sql = "SELECT id, title, recipient FROM aggregations"
        rows = self.db.query_all(sql)
        out = []
        for id_, title, rec in rows:
            if filter is not None and filter not in title:
                continue
            if recipient is not None and rec != str(recipient):
                continue
            out.append(AggregationId(id_))
        return out

    def create_aggregation(self, aggregation) -> None:
        self.db.create_row(
            "aggregations",
            "id",
            str(aggregation.id),
            {
                "title": aggregation.title,
                "recipient": str(aggregation.recipient),
                "body": json.dumps(aggregation.to_json()),
            },
        )

    def get_aggregation(self, aggregation_id):
        row = self.db.query_one(
            "SELECT body FROM aggregations WHERE id = ?", (str(aggregation_id),)
        )
        return None if row is None else Aggregation.from_json(json.loads(row[0]))

    def delete_aggregation(self, aggregation_id) -> None:
        a = str(aggregation_id)
        with self.db.transaction() as conn:
            snaps = [
                r[0]
                for r in conn.execute(
                    "SELECT id FROM snapshots WHERE aggregation = ?", (a,)
                ).fetchall()
            ]
            for s in snaps:
                conn.execute("DELETE FROM snapshot_members WHERE snapshot = ?", (s,))
                conn.execute("DELETE FROM snapshot_masks WHERE snapshot = ?", (s,))
                conn.execute("DELETE FROM mask_encs WHERE snapshot = ?", (s,))
            conn.execute("DELETE FROM snapshots WHERE aggregation = ?", (a,))
            conn.execute("DELETE FROM participations WHERE aggregation = ?", (a,))
            conn.execute("DELETE FROM committees WHERE aggregation = ?", (a,))
            conn.execute("DELETE FROM aggregations WHERE id = ?", (a,))

    def get_committee(self, aggregation_id):
        row = self.db.query_one(
            "SELECT body FROM committees WHERE aggregation = ?", (str(aggregation_id),)
        )
        return None if row is None else Committee.from_json(json.loads(row[0]))

    def create_committee(self, committee) -> None:
        self.db.create_row(
            "committees",
            "aggregation",
            str(committee.aggregation),
            {"body": json.dumps(committee.to_json())},
        )

    def create_participation(self, participation) -> None:
        # existence check + insert are NOT one transaction: a concurrent
        # delete_aggregation can strand this row, which the snapshot
        # freeze scopes out (it selects by aggregation id); matching the
        # SDA server's non-transactional Mongo Daos
        if self.get_aggregation(participation.aggregation) is None:
            raise InvalidRequestError(f"no aggregation {participation.aggregation}")
        self.db.create_row(
            "participations",
            "id",
            str(participation.id),
            {
                "aggregation": str(participation.aggregation),
                "body": json.dumps(participation.to_json()),
            },
        )

    def create_participations(self, participations) -> None:
        """Bulk ingest: ONE write transaction for the whole batch.

        The single-row path pays a BEGIN IMMEDIATE + existence probe +
        SELECT + INSERT per participation; here the batch shares one
        transaction, one aggregation probe per distinct aggregation, a
        chunked IN() duplicate scan, and one executemany (sqlite3 reuses
        the prepared INSERT across the whole sequence). Semantics match
        N singles: identical replays no-op, a same-id-different-body
        conflict or missing aggregation raises and the transaction's
        rollback discards every row of the batch."""
        participations = list(participations)
        if not participations:
            return
        # canonicalize + intra-batch dedup before taking the write lock
        rows: dict = {}
        for p in participations:
            key = str(p.id)
            body = json.dumps(p.to_json())
            prev = rows.get(key)
            if prev is not None and prev[2] != body:
                raise ServerError(f"object already exists: {key}")
            rows[key] = (key, str(p.aggregation), body)
        with self.db.transaction() as conn:
            for agg in sorted({r[1] for r in rows.values()}):
                if (
                    conn.execute(
                        "SELECT 1 FROM aggregations WHERE id = ?", (agg,)
                    ).fetchone()
                    is None
                ):
                    raise InvalidRequestError(f"no aggregation {agg}")
            fresh = dict(rows)
            ids = list(rows)
            chunk = 500  # stay under SQLITE_MAX_VARIABLE_NUMBER (999 legacy)
            for lo in range(0, len(ids), chunk):
                part = ids[lo : lo + chunk]
                marks = ",".join("?" * len(part))
                for id_, body in conn.execute(
                    f"SELECT id, body FROM participations WHERE id IN ({marks})",
                    part,
                ):
                    if body != rows[id_][2]:
                        raise ServerError(f"object already exists: {id_}")
                    fresh.pop(id_, None)  # identical replay: no-op
            if fresh:
                conn.executemany(
                    "INSERT INTO participations (id, aggregation, body) "
                    "VALUES (?, ?, ?)",
                    list(fresh.values()),
                )

    def create_snapshot(self, snapshot) -> None:
        self.db.create_row(
            "snapshots",
            "id",
            str(snapshot.id),
            {
                "aggregation": str(snapshot.aggregation),
                "body": json.dumps(snapshot.to_json()),
            },
        )

    def list_snapshots(self, aggregation_id) -> list:
        rows = self.db.query_all(
            "SELECT id FROM snapshots WHERE aggregation = ? ORDER BY id",
            (str(aggregation_id),),
        )
        return [SnapshotId(r[0]) for r in rows]

    def get_snapshot(self, aggregation_id, snapshot_id):
        row = self.db.query_one(
            "SELECT body FROM snapshots WHERE id = ? AND aggregation = ?",
            (str(snapshot_id), str(aggregation_id)),
        )
        return None if row is None else Snapshot.from_json(json.loads(row[0]))

    def count_participations(self, aggregation_id) -> int:
        row = self.db.query_one(
            "SELECT COUNT(*) FROM participations WHERE aggregation = ?",
            (str(aggregation_id),),
        )
        return row[0]

    def iter_participations(self, aggregation_id):
        # ordered full scan for the shard-migration copier: id-keyed
        # batches keep memory bounded like iter_snapped_participations
        a = str(aggregation_id)
        last = ""
        batch = 1024
        while True:
            rows = self.db.query_all(
                "SELECT id, body FROM participations "
                "WHERE aggregation = ? AND id > ? ORDER BY id LIMIT ?",
                (a, last, batch),
            )
            if not rows:
                return
            for pid, body in rows:
                yield Participation.from_json(json.loads(body))
            last = rows[-1][0]

    def discard_participations(self, aggregation_id, participation_ids) -> None:
        ids = [str(pid) for pid in participation_ids]
        if not ids:
            return
        a = str(aggregation_id)
        chunk = 500  # stay under SQLITE_MAX_VARIABLE_NUMBER (999 legacy)
        with self.db.transaction() as conn:
            for lo in range(0, len(ids), chunk):
                part = ids[lo : lo + chunk]
                marks = ",".join("?" * len(part))
                conn.execute(
                    f"DELETE FROM participations "
                    f"WHERE aggregation = ? AND id IN ({marks})",
                    [a] + part,
                )

    def snapshot_participations(self, aggregation_id, snapshot_id) -> None:
        s = str(snapshot_id)
        with self.db.transaction() as conn:
            existing = conn.execute(
                "SELECT COUNT(*) FROM snapshot_members WHERE snapshot = ?", (s,)
            ).fetchone()[0]
            if existing:
                return  # write-once freeze (retry safety)
            conn.execute(
                "INSERT INTO snapshot_members (snapshot, ord, participation) "
                "SELECT ?, ROW_NUMBER() OVER (ORDER BY id) - 1, id "
                "FROM participations WHERE aggregation = ?",
                (s, str(aggregation_id)),
            )

    def iter_snapped_participations(self, aggregation_id, snapshot_id):
        # streaming: indexed ord-range batches, memory bounded to one
        # batch (a fetchall would materialize every raw body for the
        # whole cohort — the exact RAM ceiling this backend exists to
        # avoid). Each batch is a COMPLETE query on the read connection —
        # never an open cursor held across lock releases, whose row
        # visibility under same-connection writes (e.g.
        # delete_aggregation) is undefined in sqlite. ord is dense
        # 0..n-1 at freeze time, so a short batch means rows were
        # deleted mid-scan: raise loudly rather than silently yield a
        # partial cohort.
        s = str(snapshot_id)
        total = self.db.query_one(
            "SELECT COUNT(*) FROM snapshot_members WHERE snapshot = ?", (s,)
        )[0]
        batch = 1024
        for lo in range(0, total, batch):
            want = min(batch, total - lo)
            rows = self.db.query_all(
                "SELECT p.body FROM snapshot_members m "
                "JOIN participations p ON p.id = m.participation "
                "WHERE m.snapshot = ? AND m.ord >= ? AND m.ord < ? "
                "ORDER BY m.ord",
                (s, lo, lo + batch),
            )
            if len(rows) != want:
                raise ServerError(
                    f"snapshot {snapshot_id}: snapped rows vanished "
                    f"mid-scan (ord [{lo},{lo + batch}) returned "
                    f"{len(rows)}/{want}) — store mutated during iteration?"
                )
            for (body,) in rows:
                yield Participation.from_json(json.loads(body))

    def count_participations_snapshot(self, aggregation_id, snapshot_id) -> int:
        row = self.db.query_one(
            "SELECT COUNT(*) FROM snapshot_members WHERE snapshot = ?",
            (str(snapshot_id),),
        )
        return row[0]

    def validate_snapshot_clerk_jobs(
        self, aggregation_id, snapshot_id, clerks_number: int
    ) -> None:
        """One indexed COUNT validates every snapped body's
        clerk_encryptions shape before the pipeline enqueues anything —
        constant memory, no phantom jobs (see the base docstring)."""
        bad = self.db.query_one(
            "SELECT COUNT(*) FROM snapshot_members m "
            "JOIN participations p ON p.id = m.participation "
            "WHERE m.snapshot = ? AND ("
            "  json_array_length(p.body, '$.clerk_encryptions') IS NULL"
            "  OR json_array_length(p.body, '$.clerk_encryptions') != ?)",
            (str(snapshot_id), clerks_number),
        )[0]
        if bad:
            raise ServerError(
                f"snapshot {snapshot_id}: {bad} snapped participation(s) "
                f"lack exactly {clerks_number} clerk encryptions — "
                "refusing to enqueue a partial transpose"
            )

    def iter_snapshot_clerk_jobs_data(
        self, aggregation_id, snapshot_id, clerks_number: int
    ):
        """The streaming transpose: the SQL engine extracts clerk ``ix``'s
        ciphertext column with json_extract, one indexed pass per clerk —
        the sqlite analog of the SDA server's $unwind/$group disk-spilling
        pipeline (server-store-mongodb/src/aggregations.rs:164-195).

        Returns a GENERATOR of columns: the snapshot pipeline enqueues
        each clerk's job before pulling the next column, so peak memory
        is one column (1/clerks of the cohort) — a list of columns here
        would materialize the entire ciphertext matrix and erase the
        point of streaming.

        Malformed bodies are rejected up front by
        ``validate_snapshot_clerk_jobs`` (called by the snapshot
        pipeline before the first yield)."""

        def column(ix: int):
            rows = self.db.query_all(
                "SELECT json_extract(p.body, '$.clerk_encryptions[' || ? || '][1]') "
                "FROM snapshot_members m "
                "JOIN participations p ON p.id = m.participation "
                "WHERE m.snapshot = ? ORDER BY m.ord",
                (ix, str(snapshot_id)),
            )
            return [Encryption.from_json(json.loads(r[0])) for r in rows]

        return (column(ix) for ix in range(clerks_number))

    def iter_snapshot_clerk_jobs_chunks(
        self, aggregation_id, snapshot_id, clerks_number: int, chunk_size: int
    ):
        """Chunked streaming transpose: same json_extract column pull as
        ``iter_snapshot_clerk_jobs_data``, but each chunk is its own
        ord-range query, so peak memory per clerk drops from one column
        to one chunk. Same complete-query-per-batch and loud short-batch
        rules as ``iter_snapped_participations``."""
        s = str(snapshot_id)
        total = self.count_participations_snapshot(aggregation_id, snapshot_id)

        def column_chunks(ix: int):
            for lo in range(0, total, chunk_size):
                want = min(chunk_size, total - lo)
                rows = self.db.query_all(
                    "SELECT json_extract(p.body, '$.clerk_encryptions[' || ? || '][1]') "
                    "FROM snapshot_members m "
                    "JOIN participations p ON p.id = m.participation "
                    "WHERE m.snapshot = ? AND m.ord >= ? AND m.ord < ? "
                    "ORDER BY m.ord",
                    (ix, s, lo, lo + chunk_size),
                )
                if len(rows) != want:
                    raise ServerError(
                        f"snapshot {snapshot_id}: snapped rows vanished "
                        f"mid-transpose (ord [{lo},{lo + chunk_size}) returned "
                        f"{len(rows)}/{want}) — store mutated during iteration?"
                    )
                yield [Encryption.from_json(json.loads(r[0])) for r in rows]

        return (column_chunks(ix) for ix in range(clerks_number))

    # -- snapshot masks ------------------------------------------------------
    # Two layouts, mirroring job_encs: small masks stay one JSON blob in
    # snapshot_masks.body; masks above result_page_threshold() are
    # EXTERNALIZED — the blob becomes the marker ``{"externalized": n}``
    # and the encryptions live as one ``mask_encs`` row per ciphertext,
    # keyed (snapshot, pos), so a range read is an indexed scan. Layout
    # is decided at write time; the wire shape per call in the service.

    def create_snapshot_mask(self, snapshot_id, mask: list) -> None:
        mask = list(mask)
        s = str(snapshot_id)
        with self.db.transaction() as conn:
            # stale rows from a different-threshold rewrite must not
            # survive a layout switch (the snapshot retry path overwrites)
            conn.execute("DELETE FROM mask_encs WHERE snapshot = ?", (s,))
            if len(mask) <= result_page_threshold():
                body = json.dumps([e.to_json() for e in mask])
            else:
                conn.executemany(
                    "INSERT INTO mask_encs (snapshot, pos, body) VALUES (?, ?, ?)",
                    (
                        (s, pos, json.dumps(e.to_json()))
                        for pos, e in enumerate(mask)
                    ),
                )
                body = json.dumps({"externalized": len(mask)})
            conn.execute(
                "INSERT INTO snapshot_masks (snapshot, body) VALUES (?, ?) "
                "ON CONFLICT(snapshot) DO UPDATE SET body = excluded.body",
                (s, body),
            )

    def _mask_marker(self, snapshot_id):
        """(payload, total) — payload is the parsed blob (list for the
        inline layout, dict marker for externalized), total its length."""
        row = self.db.query_one(
            "SELECT body FROM snapshot_masks WHERE snapshot = ?", (str(snapshot_id),)
        )
        if row is None:
            return None, None
        payload = json.loads(row[0])
        if isinstance(payload, dict):
            return payload, int(payload["externalized"])
        return payload, len(payload)

    def get_snapshot_mask(self, snapshot_id):
        payload, total = self._mask_marker(snapshot_id)
        if payload is None:
            return None
        if isinstance(payload, dict):
            return self._read_mask_range(snapshot_id, 0, total)
        return [Encryption.from_json(e) for e in payload]

    def count_snapshot_mask(self, snapshot_id):
        _, total = self._mask_marker(snapshot_id)
        return total

    def get_snapshot_mask_range(self, snapshot_id, start, count):
        payload, total = self._mask_marker(snapshot_id)
        if payload is None:
            return None
        if start < 0 or count < 0:
            return []
        if isinstance(payload, dict):
            return self._read_mask_range(snapshot_id, start, min(start + count, total))
        return [Encryption.from_json(e) for e in payload[start : start + count]]

    def _read_mask_range(self, snapshot_id, start: int, end: int) -> list:
        if end <= start:
            return []
        rows = self.db.query_all(
            "SELECT body FROM mask_encs WHERE snapshot = ? AND pos >= ? AND pos < ? "
            "ORDER BY pos",
            (str(snapshot_id), start, end),
        )
        return [Encryption.from_json(json.loads(r[0])) for r in rows]


class SqliteClerkingJobsStore(ClerkingJobsStore):
    """Two column layouts coexist:

    - INLINE (legacy / small jobs): the full ciphertext column lives in
      ``jobs.body`` — the original wire shape, parsed and sliced on
      demand.
    - EXTERNALIZED (chunked enqueue, or plain enqueue above the paging
      threshold): ``jobs.body`` is the metadata-only job
      (``total_encryptions`` set, ``encryptions`` empty) and the column
      lives as one ``job_encs`` row per ciphertext, keyed (job, pos), so
      a chunk read is an indexed range scan and never materializes the
      column.

    Delivery shape is decided at poll time from the CURRENT paging
    threshold: small externalized jobs are reassembled into the
    monolithic wire body (byte-identical to inline — both re-serialize
    through the same dataclasses), large inline jobs are paged by view.
    """

    def __init__(self, backend: SqliteBackend):
        self.db = backend

    def enqueue_clerking_job(self, job) -> None:
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
        with self.db.transaction() as conn:
            row = conn.execute(
                "SELECT id FROM jobs WHERE id = ?", (str(job.id),)
            ).fetchone()
            if row is not None:
                return  # idempotent under deterministic snapshot retries
            conn.execute(
                "INSERT INTO jobs (id, clerk, snapshot, done, body) VALUES (?, ?, ?, 0, ?)",
                (str(job.id), str(job.clerk), str(job.snapshot), json.dumps(job.to_json())),
            )

    def enqueue_clerking_job_chunked(self, job, chunks) -> None:
        """Streaming enqueue: small columns (within the paging threshold)
        keep the legacy inline layout; larger ones land externalized in
        one write transaction, one executemany per range, never more
        than one range of the column in memory. The jobs row (with the
        final total) lands last, inside the same transaction, so a crash
        mid-column leaves no visible job and the deterministic-id retry
        rewrites from scratch."""
        job_key = str(job.id)
        if (
            self.db.query_one("SELECT id FROM jobs WHERE id = ?", (job_key,))
            is not None
        ):
            return  # idempotent: don't consume the iterator either
        column, chunks = split_small_column(chunks, job_page_threshold())
        if column is not None:
            job.encryptions = column
            self.enqueue_clerking_job(job)
            return
        with self.db.transaction() as conn:
            row = conn.execute(
                "SELECT id FROM jobs WHERE id = ?", (job_key,)
            ).fetchone()
            if row is not None:
                return  # lost a race to a concurrent retry: same bytes
            # defensive: an aborted prior transaction can't leave rows
            # (transactional), but a stale manual write could
            conn.execute("DELETE FROM job_encs WHERE job = ?", (job_key,))
            pos = 0
            for block in chunks:
                conn.executemany(
                    "INSERT INTO job_encs (job, pos, body) VALUES (?, ?, ?)",
                    [
                        (job_key, pos + i, json.dumps(enc.to_json()))
                        for i, enc in enumerate(block)
                    ],
                )
                pos += len(block)
            meta = ClerkingJob(
                id=job.id,
                clerk=job.clerk,
                aggregation=job.aggregation,
                snapshot=job.snapshot,
                encryptions=[],
                total_encryptions=pos,
            )
            conn.execute(
                "INSERT INTO jobs (id, clerk, snapshot, done, body) VALUES (?, ?, ?, 0, ?)",
                (job_key, str(job.clerk), str(job.snapshot), json.dumps(meta.to_json())),
            )

    def _deliver(self, job):
        """Stored body -> wire body under the current paging threshold."""
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
        rows = self.db.query_all(
            "SELECT body FROM job_encs WHERE job = ? ORDER BY pos", (str(job.id),)
        )
        return ClerkingJob(
            id=job.id,
            clerk=job.clerk,
            aggregation=job.aggregation,
            snapshot=job.snapshot,
            encryptions=[Encryption.from_json(json.loads(r[0])) for r in rows],
        )

    def poll_clerking_job(self, clerk_id):
        row = self.db.query_one(
            "SELECT body FROM jobs WHERE clerk = ? AND done = 0 ORDER BY id LIMIT 1",
            (str(clerk_id),),
        )
        if row is None:
            return None
        return self._deliver(ClerkingJob.from_json(json.loads(row[0])))

    def get_clerking_job(self, clerk_id, job_id):
        row = self.db.query_one(
            "SELECT body FROM jobs WHERE id = ? AND clerk = ?",
            (str(job_id), str(clerk_id)),
        )
        if row is None:
            return None
        return self._deliver(ClerkingJob.from_json(json.loads(row[0])))

    def get_clerking_job_chunk(self, clerk_id, job_id, start, count):
        row = self.db.query_one(
            "SELECT body FROM jobs WHERE id = ? AND clerk = ?",
            (str(job_id), str(clerk_id)),
        )
        if row is None:
            return None
        if start < 0 or count < 0:
            return []
        job = ClerkingJob.from_json(json.loads(row[0]))
        if job.total_encryptions is None:
            return job.encryptions[start : start + count]  # inline layout
        # externalized: indexed (job, pos) range scan — reads ONLY the
        # requested rows, the whole point of the layout
        rows = self.db.query_all(
            "SELECT body FROM job_encs WHERE job = ? AND pos >= ? AND pos < ? "
            "ORDER BY pos",
            (str(job_id), start, start + count),
        )
        return [Encryption.from_json(json.loads(r[0])) for r in rows]

    def create_clerking_result(self, result) -> None:
        with self.db.transaction() as conn:
            row = conn.execute(
                "SELECT snapshot FROM jobs WHERE id = ?", (str(result.job),)
            ).fetchone()
            if row is None:
                raise InvalidRequestError(f"no job {result.job}")
            conn.execute(
                "INSERT INTO results (job, snapshot, body) VALUES (?, ?, ?) "
                "ON CONFLICT(job) DO UPDATE SET body = excluded.body",
                (str(result.job), row[0], json.dumps(result.to_json())),
            )
            conn.execute(
                "UPDATE jobs SET done = 1 WHERE id = ?", (str(result.job),)
            )

    def complete_clerking_job(self, clerk_id, job_id) -> None:
        with self.db.transaction() as conn:
            row = conn.execute(
                "SELECT clerk FROM jobs WHERE id = ?", (str(job_id),)
            ).fetchone()
            if row is None or row[0] != str(clerk_id):
                raise InvalidRequestError(f"no job {job_id}")
            conn.execute("UPDATE jobs SET done = 1 WHERE id = ?", (str(job_id),))

    def list_results(self, snapshot_id) -> list:
        rows = self.db.query_all(
            "SELECT job FROM results WHERE snapshot = ? ORDER BY job", (str(snapshot_id),)
        )
        return [ClerkingJobId(r[0]) for r in rows]

    def get_result(self, snapshot_id, job_id):
        row = self.db.query_one(
            "SELECT body FROM results WHERE job = ? AND snapshot = ?",
            (str(job_id), str(snapshot_id)),
        )
        return None if row is None else ClerkingResult.from_json(json.loads(row[0]))

    def get_results(self, snapshot_id) -> list:
        # one indexed scan replaces the list_results + get_result-per-job
        # N+1; ORDER BY job keeps the canonical cross-backend ordering
        rows = self.db.query_all(
            "SELECT body FROM results WHERE snapshot = ? ORDER BY job",
            (str(snapshot_id),),
        )
        return [ClerkingResult.from_json(json.loads(r[0])) for r in rows]

    def count_results(self, snapshot_id) -> int:
        row = self.db.query_one(
            "SELECT COUNT(*) FROM results WHERE snapshot = ?", (str(snapshot_id),)
        )
        return int(row[0])

    def get_results_range(self, snapshot_id, start, count) -> list:
        if start < 0 or count < 0:
            return []
        rows = self.db.query_all(
            "SELECT body FROM results WHERE snapshot = ? ORDER BY job "
            "LIMIT ? OFFSET ?",
            (str(snapshot_id), count, start),
        )
        return [ClerkingResult.from_json(json.loads(r[0])) for r in rows]
