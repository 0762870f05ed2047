"""Partitioned store seam: K backing store partitions behind the one
store interface the server core already speaks, with R-way replication
so losing any one partition mid-round is a non-event (copy of
``sda_tpu/server/sharded.py``; the partition layout is ``sda_tpu``'s, so
a sharded root either package writes opens in the other).

The routable half of the sharded coordination plane (SSNet's
service-plane shape): aggregation-keyed state — the hot,
unbounded tables — is consistent-hashed over K complete backing store
partitions (mem, file, or sqlite; ``HashRing`` in ``utils/hashring.py``),
while the small global tables (agents, auth tokens, encryption keys) are
pinned to shard 0 by the factory (``new_sharded_server``). ``service.py``,
the snapshot pipeline, paged delivery, and every bulk read work
unchanged: the sharded classes implement the exact ``AggregationsStore``
/ ``ClerkingJobsStore`` interfaces and delegate each call to the owning
partition(s), so a backend's smarter overrides (sqlite's indexed counts,
the file store's ranged reads) are still the code that runs.

Routing rules:

- anything keyed by aggregation id hashes to its home partition; with
  ``replicas = R > 1`` the write set is the first R shards of the ring's
  ``preference()`` walk — a fixed, deterministic prefix, so replicas of
  one aggregation are self-consistent (parent rows always precede child
  rows on every replica);
- clerking jobs ride their ``job.aggregation`` at enqueue, and lookups
  keyed only by job id or snapshot id consult in-process routing maps
  recorded at enqueue/snapshot time, falling back to a partition fan-out
  (first partition that answers) so a fresh process over durable
  partitions still resolves everything;
- ``poll_clerking_job`` fans out in shard order — a clerk serves
  whichever aggregations hashed anywhere;
- snapshot-scoped result reads land on the aggregation's replica set by
  construction (every job of a snapshot lives with its aggregation), so
  the fan-out merge path is exact whenever the map is cold (with a
  replica-aware dedupe when R > 1).

Replication model (``SDA_SHARD_REPLICAS``, default 1 = one home shard
per aggregation):

- **writes** fan out to all R target shards. A write needs a quorum of
  ``ceil((R+1)/2)`` acknowledgements, where a replica that is down (the
  wedge hook, a dead sqlite file, any transport-class error) is
  acknowledged *as a hint*: the op is queued in the coordinator and
  replayed by the background repair thread once the shard returns. At
  least one real (non-hinted) replica must accept, so the hard floor is
  one surviving copy — lose-any-one-shard survival at R=2, lose-any-two
  best effort at R=3. Logical rejections (``SdaError``: conflicts,
  missing parents, bad requests) are deterministic across replicas and
  propagate immediately — they are never hinted.
- **hinted handoff**: hints replay in FIFO order (program order per
  shard, so causality holds: ``create_aggregation`` replays before the
  participations that reference it). A hint whose shard is reachable but
  keeps rejecting is dropped after ``SDA_SHARD_HANDOFF_ATTEMPTS``
  tries (every store write is idempotent create-if-identical, so
  replays and client retries never double-apply).
- **reads** walk the target shards in preference order. Record reads
  (``get_*`` returning ``None`` on miss) take the first hit and
  *read-repair* any earlier replica that was up but missing the record;
  set/count/iterator reads are answered by the first reachable replica
  (replicas converge once the handoff queue drains — the drain window
  is the staleness bound).

The deterministic shard-fault hook has two faces: in-process
``router.wedge(ix)`` / ``heal(ix)``, and — for wedging a shard inside a
live ``sdad`` from another process — a ``shard-NN.down`` marker file in
the deployment root (``ShardRouter.down_marker``). Both make every
access to that partition fail with ``ShardDownError`` until healed.

Every partition access ticks ``sda_shard_requests_total{shard}`` so the
split is observable (fan-out ops tick each partition they touch); the
replica plane adds ``sda_shard_replica_writes_total{shard,outcome}``
(outcome ok / hinted / handoff / abandoned), the
``sda_shard_handoff_queue`` depth gauge, and
``sda_shard_read_repairs_total``.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from typing import Iterable, Iterator, Optional

from .. import telemetry
from ..protocol import SdaError, ServerError
from ..utils.hashring import HashRing
from . import stores

log = logging.getLogger("sda.shard")


class ShardDownError(Exception):
    """A partition is wedged or unreachable.

    Deliberately *not* an ``SdaError``: the replicated paths classify
    ``SdaError`` as a deterministic logical rejection (propagate) and
    everything else as a transport-class replica failure (hint and
    carry on). Reaching the REST layer it maps to a retryable 500.
    """


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class ShardRouter:
    """Shared routing state for one sharded deployment: the ring, the
    replica count, the job-id/snapshot-id target maps both sharded
    stores consult, the shard-fault hook, and the hinted-handoff queue
    with its background repair thread."""

    def __init__(self, shards: int, replicas: int = 1, root=None):
        self.shards = shards
        self.replicas = max(1, min(int(replicas), shards))
        self.ring = HashRing(shards)
        #: deployment root for cross-process ``shard-NN.down`` markers
        #: (None for mem partitions — wedge in-process instead)
        self.root = root
        # in-process routing hints only — correctness never depends on
        # them (every reader has a fan-out fallback), so a fresh process
        # over durable partitions starts cold and warms as it routes.
        # Values are tuples of target shard indexes (length R).
        self._snapshot_targets: dict = {}
        self._job_targets: dict = {}
        # -- shard-fault hook + hinted handoff ----------------------------
        self._down: set = set()
        self._hints: collections.deque = collections.deque()
        self._hints_lock = threading.Lock()
        self._stores: dict = {}  # "agg"/"jobs" -> partition list (attach())
        self._repair_stop: Optional[threading.Event] = None
        self._repair_thread: Optional[threading.Thread] = None
        # -- elastic scale-out (add_shard / finish_add_shard) -------------
        #: shards mid-migration: writes hint to them, reads skip them
        self._warming: set = set()
        #: warming shards whose bulk copy has not landed yet — the
        #: handoff drain must hold off (hints replay AFTER the base copy)
        self._copying: set = set()
        #: the grown ring while a migration is in flight (targets() adds
        #: its preference prefix to the current ring's, old shards first)
        self._next_ring: Optional[HashRing] = None
        #: factory building partition ``ix`` on demand, attached by
        #: ``new_sharded_server`` — ``None`` means this deployment
        #: cannot grow (hand-assembled partition lists)
        self.new_partition = None
        # write gate: finish_add_shard's flip drains in-flight writes,
        # swaps the ring, and releases — the only moment writes pause
        self._gate = threading.Condition()
        self._inflight = 0
        self._paused = False

    # -- telemetry ---------------------------------------------------------

    def touch(self, ix: int) -> None:
        if telemetry.enabled():
            telemetry.counter(
                "sda_shard_requests_total",
                "store requests routed per shard (fan-outs tick each "
                "partition touched)",
                shard=str(ix),
            ).inc()

    def tick_replica(self, ix: int, outcome: str) -> None:
        if telemetry.enabled():
            telemetry.counter(
                "sda_shard_replica_writes_total",
                "replicated write attempts per shard: ok (replica "
                "acked), hinted (replica down, queued for handoff), "
                "handoff (hint replayed), abandoned (hint dropped)",
                shard=str(ix),
                outcome=outcome,
            ).inc()

    def tick_read_repair(self) -> None:
        if telemetry.enabled():
            telemetry.counter(
                "sda_shard_read_repairs_total",
                "records written back to a live replica that was "
                "missing them",
            ).inc()

    def _update_hint_gauge(self) -> None:
        if telemetry.enabled():
            telemetry.gauge(
                "sda_shard_handoff_queue",
                "writes queued for replay onto a down shard",
            ).set(float(len(self._hints)))

    # -- routing -----------------------------------------------------------

    def aggregation_shard(self, aggregation_id) -> int:
        return self.ring.shard_for(str(aggregation_id))

    def targets(self, key) -> tuple:
        """The write/read set for ``key``: the first R shards of the
        ring's preference walk (just the home shard when R == 1).

        While a shard add is migrating, keys the grown ring moves get
        the UNION of both rings' prefixes, old shards first: reads stay
        authoritative on the current home (the new shard is skipped as
        warming anyway), while every write is also queued for the future
        home as a hinted handoff — so by flip time the new shard holds
        base copy + replayed deltas and nothing is lost."""
        next_ring = self._next_ring
        if next_ring is None and self.replicas == 1:
            return (self.aggregation_shard(key),)
        out = tuple(self.ring.preference(str(key))[: self.replicas])
        if next_ring is not None:
            grown = [
                ix
                for ix in next_ring.preference(str(key))[: self.replicas]
                if ix not in out
            ]
            out = out + tuple(grown)
        return out

    def note_snapshot(self, snapshot_id, ixs) -> None:
        self._snapshot_targets[str(snapshot_id)] = (
            (ixs,) if isinstance(ixs, int) else tuple(ixs)
        )

    def snapshot_targets(self, snapshot_id) -> Optional[tuple]:
        return self._snapshot_targets.get(str(snapshot_id))

    def note_job(self, job_id, ixs) -> None:
        self._job_targets[str(job_id)] = (
            (ixs,) if isinstance(ixs, int) else tuple(ixs)
        )

    def job_targets(self, job_id) -> Optional[tuple]:
        return self._job_targets.get(str(job_id))

    # -- deterministic shard-fault hook ------------------------------------

    @staticmethod
    def down_marker(root, ix: int) -> str:
        """Path of the cross-process wedge marker for partition ``ix``:
        touch it to take the shard down inside a live server, remove it
        to bring the shard back. Fault drills use this to
        murder partitions inside a running ``sdad``."""
        return os.path.join(root, f"shard-{ix:02d}.down")

    def wedge(self, ix: int) -> None:
        """Take partition ``ix`` down (in-process hook)."""
        self._down.add(ix)

    def heal(self, ix: int) -> None:
        self._down.discard(ix)

    def shard_down(self, ix: int) -> bool:
        if ix in self._down:
            return True
        if self.root is not None:
            return os.path.exists(self.down_marker(self.root, ix))
        return False

    def shard_warming(self, ix: int) -> bool:
        """True while ``ix`` is a mid-migration shard: its contents are
        a partial copy, so reads must not treat it as authoritative."""
        return ix in self._warming

    def check_up(self, ix: int) -> None:
        if self.shard_down(ix):
            raise ShardDownError(f"shard {ix} is down")
        if ix in self._warming:
            # writes treat a warming shard exactly like a down one:
            # they queue as hints, which replay (in order, after the
            # bulk copy) instead of racing the copier
            raise ShardDownError(f"shard {ix} is warming")

    # -- hinted handoff ----------------------------------------------------

    def attach(self, kind: str, partitions: list) -> None:
        """Register a partition list ("agg" / "jobs") so the repair
        thread can replay hints onto it."""
        self._stores[kind] = partitions

    def add_hint(self, kind: str, ix: int, op: str, args: tuple) -> None:
        with self._hints_lock:
            self._hints.append([kind, ix, op, args, 0])
        self._update_hint_gauge()

    def hint_depth(self) -> int:
        return len(self._hints)

    def drain_hints_once(self) -> int:
        """One repair pass: replay queued writes onto shards that came
        back, in FIFO order (per-shard program order — causality).
        Returns the number of hints applied. A shard that is still down
        keeps its hints (attempts are free while waiting); a shard that
        is up but rejects a hint gets ``SDA_SHARD_HANDOFF_ATTEMPTS``
        tries before the hint is dropped as ``abandoned``."""
        with self._hints_lock:
            pending = list(self._hints)
            self._hints.clear()
        max_attempts = _env_int("SDA_SHARD_HANDOFF_ATTEMPTS", 8)
        applied = 0
        requeue = []
        blocked: set = set()  # shards that must keep FIFO order this pass
        for hint in pending:
            kind, ix, op, args, attempts = hint
            if ix in blocked or ix in self._copying or self.shard_down(ix):
                blocked.add(ix)
                requeue.append(hint)
                continue
            try:
                getattr(self._stores[kind][ix], op)(*args)
            except Exception as exc:
                hint[4] = attempts + 1
                if hint[4] >= max_attempts:
                    self.tick_replica(ix, "abandoned")
                    log.error(
                        "handoff hint %s to shard %d abandoned after %d "
                        "attempts: %r", op, ix, hint[4], exc
                    )
                else:
                    blocked.add(ix)
                    requeue.append(hint)
                continue
            applied += 1
            self.tick_replica(ix, "handoff")
        if requeue:
            with self._hints_lock:
                self._hints.extendleft(reversed(requeue))
        self._update_hint_gauge()
        return applied

    def start_repair(self, interval: Optional[float] = None) -> None:
        """Start the background repair thread (idempotent). The factory
        calls this when R > 1; tests may instead call
        ``drain_hints_once`` directly for deterministic stepping."""
        if self._repair_stop is not None:
            return
        if interval is None:
            interval = _env_float("SDA_SHARD_HANDOFF_S", 0.5)
        stop = threading.Event()
        self._repair_stop = stop

        def _loop():
            while not stop.wait(interval):
                try:
                    self.drain_hints_once()
                except Exception:
                    pass  # the repair loop must survive anything

        self._repair_thread = threading.Thread(
            target=_loop, name="sda-shard-repair", daemon=True
        )
        self._repair_thread.start()

    def stop_repair(self) -> None:
        if self._repair_stop is None:
            return
        self._repair_stop.set()
        if self._repair_thread is not None:
            self._repair_thread.join(timeout=2.0)
        self._repair_stop = None
        self._repair_thread = None

    # -- write gate (used by the grow flip) --------------------------------

    def write_begin(self) -> None:
        with self._gate:
            while self._paused:
                self._gate.wait()
            self._inflight += 1

    def write_end(self) -> None:
        with self._gate:
            self._inflight -= 1
            self._gate.notify_all()

    # -- elastic scale-out -------------------------------------------------

    def add_shard(self) -> int:
        """Begin a live scale-out to K+1 shards. Builds partition K via
        the attached factory, registers it with both sharded stores
        (``attach`` shares the list objects, so the append is visible
        everywhere), marks it warming+copying, and installs the grown
        ring as ``_next_ring`` — from this moment every write to a key
        the grown ring moves is ALSO queued for the new shard as a
        hinted handoff. Returns the new shard's index. The shard serves
        nothing until ``finish_add_shard`` flips the ring."""
        if self.new_partition is None:
            raise ServerError(
                "this deployment has no partition factory; cannot grow"
            )
        if self._next_ring is not None:
            raise ServerError("a shard add is already in progress")
        ix = self.shards
        agg_part, jobs_part = self.new_partition(ix)
        # warming/copying BEFORE the partitions become reachable: no
        # reader may ever treat the empty partition as authoritative
        self._warming.add(ix)
        self._copying.add(ix)
        self._stores["agg"].append(agg_part)
        self._stores["jobs"].append(jobs_part)
        self._next_ring = HashRing(self.shards + 1)
        return ix

    def moved_aggregations(self) -> list:
        """Every (aggregation id, old targets, new targets) whose target
        set the in-flight grow changes — the bulk-copy work list,
        enumerated from the old partitions' own tables (no separate
        catalog exists or is needed)."""
        if self._next_ring is None:
            return []
        seen: set = set()
        moved = []
        for src_ix in range(self.shards):
            part = self._stores["agg"][src_ix]
            if self.shard_down(src_ix):
                continue
            try:
                ids = part.list_aggregations(None, None)
            except Exception:
                continue  # a down replica's rows live on its peers
            for agg_id in ids:
                key = str(agg_id)
                if key in seen:
                    continue
                seen.add(key)
                old = tuple(self.ring.preference(key)[: self.replicas])
                new = tuple(self._next_ring.preference(key)[: self.replicas])
                if old != new:
                    moved.append((agg_id, old, new))
        return moved

    def _copy_aggregation(self, agg_id, src_ixs, dst_ix) -> None:
        """Copy one aggregation's full state from its current replica
        set onto the warming shard, in dependency order. Every store
        write is create-if-identical, so re-copies and later hint
        replays of the same rows are absorbed.

        Frozen snapshot membership is reproduced by construction: only
        the SNAPPED participations are copied before the membership
        freeze is replayed, so the destination freezes exactly the
        source's member set (the mask list is copied verbatim — nothing
        pairs masks and members positionally, reveals sum both)."""
        parts = self._stores["agg"]
        dst = parts[dst_ix]
        src = None
        for ix in src_ixs:
            if not self.shard_down(ix):
                src = parts[ix]
                break
        if src is None:
            raise ShardDownError(f"no live replica to copy {agg_id} from")
        agg = src.get_aggregation(agg_id)
        if agg is None:
            return  # deleted while the work list was being walked
        dst.create_aggregation(agg)
        committee = src.get_committee(agg_id)
        if committee is not None:
            dst.create_committee(committee)
        for snap_id in src.list_snapshots(agg_id):
            snapshot = src.get_snapshot(agg_id, snap_id)
            if snapshot is None:
                continue
            for p in src.iter_snapped_participations(agg_id, snap_id):
                dst.create_participation(p)
            dst.create_snapshot(snapshot)
            dst.snapshot_participations(agg_id, snap_id)
            self.note_snapshot(snap_id, self.targets(agg_id))
            mask = src.get_snapshot_mask(snap_id)
            if mask is not None:
                dst.create_snapshot_mask(snap_id, mask)
        for p in src.iter_participations(agg_id):
            dst.create_participation(p)

    def migrate_once(self) -> int:
        """One bulk-copy pass of the in-flight grow: copy every moved
        aggregation onto the warming shard, then open the shard to the
        handoff drain (hints replay the writes that raced the copy).
        Returns the number of aggregations copied. Idempotent."""
        if self._next_ring is None:
            return 0
        new_ix = self.shards  # the warming shard
        copied = 0
        for agg_id, old, new in self.moved_aggregations():
            if new_ix not in new:
                continue  # moved between old shards cannot happen; guard anyway
            self._copy_aggregation(agg_id, old, new_ix)
            copied += 1
        # base copy landed: let the repair thread replay queued deltas
        self._copying.discard(new_ix)
        return copied

    def finish_add_shard(self, timeout: float = 30.0) -> None:
        """Complete the grow: wait for the handoff queue to drain onto
        the (now copied) warming shard, briefly pause writes, drain the
        residual hints, atomically flip to the grown ring, and resume.
        After the flip the new shard is a full member: reads for moved
        keys land on it first and the old copies are plain garbage that
        replicated merges dedupe away."""
        import time as _time

        if self._next_ring is None:
            raise ServerError("no shard add in progress")
        new_ix = self.shards
        if new_ix in self._copying:
            self.migrate_once()
        deadline = _time.monotonic() + timeout
        while self.hint_depth() and _time.monotonic() < deadline:
            self.drain_hints_once()
            if self.hint_depth():
                _time.sleep(0.02)
        # flip under the write gate: no write may straddle the ring swap
        with self._gate:
            self._paused = True
            while self._inflight:
                if not self._gate.wait(timeout=timeout):
                    break
            try:
                # residual hints enqueued by the last in-flight writes
                while self.hint_depth():
                    if self.drain_hints_once() == 0:
                        break
                if self.hint_depth():
                    raise ServerError(
                        "grow flip aborted: handoff queue did not drain "
                        f"({self.hint_depth()} hints pending)"
                    )
                self.ring = self._next_ring
                self.shards += 1
                self._next_ring = None
                self._warming.discard(new_ix)
                self._copying.discard(new_ix)
            finally:
                self._paused = False
                self._gate.notify_all()

    def grow(self, timeout: float = 30.0) -> int:
        """Convenience one-call scale-out: add a shard, bulk-copy the
        moved keys, drain, flip. Returns the new shard index."""
        ix = self.add_shard()
        self.migrate_once()
        self.finish_add_shard(timeout=timeout)
        return ix


class _ReplicatedPartitions:
    """Shared read/write machinery over a partition list. ``_kind``
    names the partition list in the router's handoff registry."""

    _kind = ""

    def __init__(self, partitions: list, router: ShardRouter):
        self._parts = partitions
        self._router = router
        router.attach(self._kind, partitions)

    # -- write -------------------------------------------------------------

    def _write(self, op: str, args: tuple, targets) -> None:
        """Replicated write over ``targets`` (a tuple of shard indexes).

        Quorum ``ceil((R+1)/2)`` where a down replica's queued hint
        counts as a (durable-intent) ack; at least one replica must
        really accept. Logical rejections propagate untouched.

        ``targets`` may exceed R while a shard add is migrating (the
        union set); the extra warming shard is not a quorum participant
        — its write always queues as a hint — so the quorum math stays
        a function of R alone."""
        router = self._router
        router.write_begin()
        try:
            if len(targets) == 1:
                ix = targets[0]
                router.touch(ix)
                getattr(self._parts[ix], op)(*args)
                return
            quorum = (router.replicas + 2) // 2
            acks = 0
            hinted = []
            first_err = None
            for ix in targets:
                router.touch(ix)
                try:
                    router.check_up(ix)
                    getattr(self._parts[ix], op)(*args)
                except SdaError:
                    raise  # deterministic logical rejection, same everywhere
                except Exception as exc:
                    router.tick_replica(ix, "hinted")
                    log.warning(
                        "replica write %s to shard %d hinted: %r", op, ix, exc
                    )
                    hinted.append(ix)
                    if first_err is None:
                        first_err = exc
                    continue
                router.tick_replica(ix, "ok")
                acks += 1
            if acks == 0 or acks + len(hinted) < quorum:
                raise first_err if first_err is not None else ServerError(
                    f"write quorum failed: {op}"
                )
            for ix in hinted:
                router.add_hint(self._kind, ix, op, args)
        finally:
            router.write_end()

    # -- reads -------------------------------------------------------------

    def _read_record(self, op: str, args: tuple, targets, repair=None):
        """Record read (``None`` means miss): first replica with the
        record answers; earlier live-but-missing replicas get the record
        written back when ``repair(part, out)`` is provided."""
        router = self._router
        if len(targets) == 1:
            ix = targets[0]
            router.touch(ix)
            return getattr(self._parts[ix], op)(*args)
        first_err = None
        behind = []  # replicas that answered but were missing the record
        for ix in targets:
            router.touch(ix)
            try:
                router.check_up(ix)
                out = getattr(self._parts[ix], op)(*args)
            except SdaError:
                raise
            except Exception as exc:
                if first_err is None:
                    first_err = exc
                continue
            if out is None:
                behind.append(ix)
                continue
            if repair is not None:
                for b in behind:
                    try:
                        repair(self._parts[b], out)
                    except Exception:
                        continue
                    router.tick_read_repair()
            return out
        if behind:
            return None  # at least one replica answered: a genuine miss
        if first_err is not None:
            raise first_err
        return None

    def _read_any(self, op: str, args: tuple, targets):
        """Set/count/iterator read: the first reachable replica is
        authoritative (``None``/``0``/``[]`` are valid answers here, so
        there is no miss-walk — replicas converge once the handoff
        queue drains)."""
        router = self._router
        if len(targets) == 1:
            ix = targets[0]
            router.touch(ix)
            return getattr(self._parts[ix], op)(*args)
        first_err = None
        for ix in targets:
            router.touch(ix)
            try:
                router.check_up(ix)
            except ShardDownError as exc:
                if first_err is None:
                    first_err = exc
                continue
            try:
                return getattr(self._parts[ix], op)(*args)
            except SdaError:
                raise
            except Exception as exc:
                if first_err is None:
                    first_err = exc
                continue
        raise first_err if first_err is not None else ShardDownError(
            f"no replica answered {op}"
        )

    def _live_parts(self):
        """Fan-out iteration; when R > 1 a down partition is skipped
        (its rows live on R-1 other replicas). A warming partition —
        the target of an in-flight shard add — is always skipped: its
        contents are a partial copy of state that still lives, in
        full, on the old shards."""
        for ix, part in enumerate(self._parts):
            if self._router.shard_warming(ix):
                continue
            if self._router.replicas > 1 and self._router.shard_down(ix):
                continue
            yield ix, part


class ShardedAggregationsStore(_ReplicatedPartitions, stores.AggregationsStore):
    """K ``AggregationsStore`` partitions routed by aggregation id,
    replicated over the first R shards of the preference walk."""

    _kind = "agg"

    def ping(self) -> None:
        for part in self._parts:
            part.ping()

    def _home(self, aggregation_id):
        ix = self._router.aggregation_shard(aggregation_id)
        self._router.touch(ix)
        return self._parts[ix]

    def _snap_targets(self, aggregation_id, snapshot_id) -> tuple:
        """Route by the aggregation AND warm the snapshot map — these
        calls are the only ones that carry both ids, and the snapshot
        pipeline issues several of them before the first snapshot-only
        lookup (mask writes happen before the snapshot record commits)."""
        targets = self._router.targets(aggregation_id)
        self._router.note_snapshot(snapshot_id, targets)
        return targets

    # -- aggregations --------------------------------------------------------

    def list_aggregations(self, filter: Optional[str], recipient) -> list:
        # first-seen dedupe in every mode: with R > 1 each aggregation
        # appears on R shards, and after a grow a moved key's absorbed
        # copy lingers on its former home until garbage-collected
        router = self._router
        out: list = []
        seen: set = set()
        for ix, part in self._live_parts():
            router.touch(ix)
            try:
                rows = part.list_aggregations(filter, recipient)
            except SdaError:
                raise
            except Exception:
                if router.replicas == 1:
                    raise  # single-copy plane: a dead partition is fatal
                continue
            for row in rows:
                key = str(row)
                if key not in seen:
                    seen.add(key)
                    out.append(row)
        return out

    def create_aggregation(self, aggregation) -> None:
        self._write(
            "create_aggregation",
            (aggregation,),
            self._router.targets(aggregation.id),
        )

    def get_aggregation(self, aggregation_id):
        return self._read_record(
            "get_aggregation",
            (aggregation_id,),
            self._router.targets(aggregation_id),
            repair=lambda part, out: part.create_aggregation(out),
        )

    def delete_aggregation(self, aggregation_id) -> None:
        self._write(
            "delete_aggregation",
            (aggregation_id,),
            self._router.targets(aggregation_id),
        )

    def get_committee(self, aggregation_id):
        return self._read_record(
            "get_committee",
            (aggregation_id,),
            self._router.targets(aggregation_id),
            repair=lambda part, out: part.create_committee(out),
        )

    def create_committee(self, committee) -> None:
        self._write(
            "create_committee",
            (committee,),
            self._router.targets(committee.aggregation),
        )

    # -- participations ------------------------------------------------------

    def create_participation(self, participation) -> None:
        self._write(
            "create_participation",
            (participation,),
            self._router.targets(participation.aggregation),
        )

    def create_participations(self, participations) -> None:
        """Bulk write grouped by target set. Atomicity holds within
        each partition (the backend's contract); a batch spanning
        aggregations on different shards commits per-shard — the service
        layer submits per-aggregation batches, so in practice this is
        one replica set's write."""
        by_targets: dict = {}
        for participation in participations:
            targets = self._router.targets(participation.aggregation)
            by_targets.setdefault(targets, []).append(participation)
        for targets, group in sorted(by_targets.items()):
            self._write("create_participations", (group,), targets)

    def count_participations(self, aggregation_id) -> int:
        return self._read_any(
            "count_participations",
            (aggregation_id,),
            self._router.targets(aggregation_id),
        )

    def iter_participations(self, aggregation_id):
        return self._read_any(
            "iter_participations",
            (aggregation_id,),
            self._router.targets(aggregation_id),
        )

    def discard_participations(self, aggregation_id, participation_ids) -> None:
        self._write(
            "discard_participations",
            (aggregation_id, list(participation_ids)),
            self._router.targets(aggregation_id),
        )

    # -- snapshots -----------------------------------------------------------

    def create_snapshot(self, snapshot) -> None:
        targets = self._router.targets(snapshot.aggregation)
        self._router.note_snapshot(snapshot.id, targets)
        self._write("create_snapshot", (snapshot,), targets)

    def list_snapshots(self, aggregation_id) -> list:
        return self._read_any(
            "list_snapshots",
            (aggregation_id,),
            self._router.targets(aggregation_id),
        )

    def get_snapshot(self, aggregation_id, snapshot_id):
        return self._read_record(
            "get_snapshot",
            (aggregation_id, snapshot_id),
            self._snap_targets(aggregation_id, snapshot_id),
            repair=lambda part, out: part.create_snapshot(out),
        )

    def snapshot_participations(self, aggregation_id, snapshot_id) -> None:
        self._write(
            "snapshot_participations",
            (aggregation_id, snapshot_id),
            self._snap_targets(aggregation_id, snapshot_id),
        )

    def iter_snapped_participations(self, aggregation_id, snapshot_id) -> Iterator:
        return self._read_any(
            "iter_snapped_participations",
            (aggregation_id, snapshot_id),
            self._snap_targets(aggregation_id, snapshot_id),
        )

    def count_participations_snapshot(self, aggregation_id, snapshot_id) -> int:
        return self._read_any(
            "count_participations_snapshot",
            (aggregation_id, snapshot_id),
            self._snap_targets(aggregation_id, snapshot_id),
        )

    def validate_snapshot_clerk_jobs(
        self, aggregation_id, snapshot_id, clerks_number: int
    ) -> None:
        return self._read_any(
            "validate_snapshot_clerk_jobs",
            (aggregation_id, snapshot_id, clerks_number),
            self._snap_targets(aggregation_id, snapshot_id),
        )

    def iter_snapshot_clerk_jobs_data(
        self, aggregation_id, snapshot_id, clerks_number: int
    ) -> Iterable:
        return self._read_any(
            "iter_snapshot_clerk_jobs_data",
            (aggregation_id, snapshot_id, clerks_number),
            self._snap_targets(aggregation_id, snapshot_id),
        )

    def iter_snapshot_clerk_jobs_chunks(
        self, aggregation_id, snapshot_id, clerks_number: int, chunk_size: int
    ) -> Iterable:
        return self._read_any(
            "iter_snapshot_clerk_jobs_chunks",
            (aggregation_id, snapshot_id, clerks_number, chunk_size),
            self._snap_targets(aggregation_id, snapshot_id),
        )

    # -- snapshot masks (snapshot-id-keyed) ----------------------------------

    def create_snapshot_mask(self, snapshot_id, mask: list) -> None:
        targets = self._router.snapshot_targets(snapshot_id)
        if targets is None:
            # unreachable through the snapshot pipeline (it routes
            # several (aggregation, snapshot)-keyed calls first); a
            # direct write with a cold map has no home to resolve
            raise ServerError(f"unroutable snapshot mask: {snapshot_id}")
        self._write("create_snapshot_mask", (snapshot_id, mask), targets)

    def _mask_read(self, snapshot_id, op, *args, repair=None):
        targets = self._router.snapshot_targets(snapshot_id)
        if targets is not None:
            return self._read_record(op, (snapshot_id,) + args, targets, repair=repair)
        for ix, part in self._live_parts():
            self._router.touch(ix)
            try:
                out = getattr(part, op)(snapshot_id, *args)
            except SdaError:
                raise
            except Exception:
                if self._router.replicas == 1:
                    raise
                continue
            if out is not None:
                self._router.note_snapshot(snapshot_id, ix)
                return out
        return None

    def get_snapshot_mask(self, snapshot_id):
        return self._mask_read(
            snapshot_id,
            "get_snapshot_mask",
            repair=lambda part, out: part.create_snapshot_mask(snapshot_id, out),
        )

    def count_snapshot_mask(self, snapshot_id) -> Optional[int]:
        return self._mask_read(snapshot_id, "count_snapshot_mask")

    def get_snapshot_mask_range(
        self, snapshot_id, start: int, count: int
    ) -> Optional[list]:
        return self._mask_read(snapshot_id, "get_snapshot_mask_range", start, count)


class ShardedClerkingJobsStore(_ReplicatedPartitions, stores.ClerkingJobsStore):
    """K ``ClerkingJobsStore`` partitions; jobs live with their
    aggregation's replica set, polls fan out across all partitions."""

    _kind = "jobs"

    def ping(self) -> None:
        for part in self._parts:
            part.ping()

    def _enqueue_targets(self, job) -> tuple:
        targets = self._router.targets(job.aggregation)
        self._router.note_job(job.id, targets)
        if job.snapshot is not None:
            self._router.note_snapshot(job.snapshot, targets)
        return targets

    def enqueue_clerking_job(self, job) -> None:
        self._write("enqueue_clerking_job", (job,), self._enqueue_targets(job))

    def enqueue_clerking_job_chunked(self, job, chunks: Iterable) -> None:
        targets = self._enqueue_targets(job)
        if len(targets) > 1:
            # the chunk stream is single-use: materialize so the write
            # can replay across replicas (and later from a hint) — the
            # union write set of an in-flight shard grow needs this even
            # at R=1, or the hint would replay an exhausted iterator
            # (and, via the default chunked enqueue's job mutation,
            # blank the column the first shard already stored). The
            # replication trade: peak memory goes from one chunk to one
            # job column while the write is in flight.
            chunks = list(chunks)
        self._write("enqueue_clerking_job_chunked", (job, chunks), targets)

    def poll_clerking_job(self, clerk_id):
        for ix, part in self._live_parts():
            self._router.touch(ix)
            try:
                job = part.poll_clerking_job(clerk_id)
            except SdaError:
                raise
            except Exception:
                if self._router.replicas == 1:
                    raise
                continue
            if job is not None:
                # never clobber the entry recorded at enqueue time: a
                # job enqueued before a shard grow lives with its
                # aggregation's FORMER replica set, and the current
                # ring's derivation would point result writes at shards
                # that never saw the job
                if self._router.job_targets(job.id) is None:
                    targets = self._router.targets(job.aggregation)
                    self._router.note_job(
                        job.id, targets if ix in targets else (ix,)
                    )
                return job
        return None

    def _job_read(self, job_id, op, *args):
        targets = self._router.job_targets(job_id)
        if targets is not None:
            return self._read_record(op, args, targets)
        for ix, part in self._live_parts():
            self._router.touch(ix)
            try:
                out = getattr(part, op)(*args)
            except SdaError:
                raise
            except Exception:
                if self._router.replicas == 1:
                    raise
                continue
            if out is not None:
                # cache routing only when the record lets us derive the
                # FULL replica set (a job carries its aggregation). A
                # bare probe index must never land in the map: writes
                # trust it, so caching one replica here would silently
                # degrade the later result write to a single-replica
                # write — no quorum, no hint, and a round that hangs on
                # whichever replica the status read happens to consult.
                agg = getattr(out, "aggregation", None)
                if agg is not None:
                    targets = self._router.targets(agg)
                    self._router.note_job(
                        job_id, targets if ix in targets else (ix,)
                    )
                return out
        return None

    def get_clerking_job(self, clerk_id, job_id):
        return self._job_read(job_id, "get_clerking_job", clerk_id, job_id)

    def get_clerking_job_chunk(
        self, clerk_id, job_id, start: int, count: int
    ) -> Optional[list]:
        return self._job_read(
            job_id, "get_clerking_job_chunk", clerk_id, job_id, start, count
        )

    def create_clerking_result(self, result) -> None:
        targets = self._router.job_targets(result.job)
        if targets is None:
            # cold map (fresh process): locate the job by owner probe —
            # the result carries its clerk, and job ids are unique. The
            # job record carries its aggregation, which re-derives the
            # full replica set.
            for probe, part in self._live_parts():
                self._router.touch(probe)
                try:
                    job = part.get_clerking_job(result.clerk, result.job)
                except SdaError:
                    raise
                except Exception:
                    if self._router.replicas == 1:
                        raise
                    continue
                if job is not None:
                    targets = self._router.targets(job.aggregation)
                    if probe not in targets:
                        # the job predates a shard grow: it lives with
                        # its aggregation's former replica set, so write
                        # where the job actually is
                        targets = (probe,)
                    self._router.note_job(result.job, targets)
                    break
        if targets is None:
            raise ServerError(f"unroutable clerking result: job {result.job}")
        self._write("create_clerking_result", (result,), targets)

    def complete_clerking_job(self, clerk_id, job_id) -> None:
        targets = self._router.job_targets(job_id)
        if targets is None:
            # same cold-map probe as create_clerking_result: the caller
            # owns the job, and job ids are unique across partitions
            for probe, part in self._live_parts():
                self._router.touch(probe)
                try:
                    job = part.get_clerking_job(clerk_id, job_id)
                except SdaError:
                    raise
                except Exception:
                    if self._router.replicas == 1:
                        raise
                    continue
                if job is not None:
                    targets = self._router.targets(job.aggregation)
                    if probe not in targets:
                        targets = (probe,)
                    self._router.note_job(job_id, targets)
                    break
        if targets is None:
            raise ServerError(f"unroutable clerking job: {job_id}")
        self._write("complete_clerking_job", (clerk_id, job_id), targets)

    # -- snapshot-scoped result reads ---------------------------------------
    # Every job of a snapshot lives on one replica set (its
    # aggregation's), so the cold-map fan-out merges are exact: the
    # other partitions contribute nothing and the canonical sort (plus
    # a replica dedupe when R > 1) matches the single-store order.

    def _snap_read(self, snapshot_id, op, *args):
        targets = self._router.snapshot_targets(snapshot_id)
        if targets is None:
            return None, False
        out = self._read_any(op, (snapshot_id,) + args, targets)
        if not out:
            # an EMPTY routed answer is not authoritative here: after a
            # shard grow the map re-warms to the aggregation's new home
            # while job rows enqueued before the grow stay behind on the
            # former home — re-answer with the fan-out merge (exact: a
            # snapshot's jobs all live somewhere, and the merge dedupes)
            return None, False
        return out, True

    def list_results(self, snapshot_id) -> list:
        out, routed = self._snap_read(snapshot_id, "list_results")
        if routed:
            return out
        merged: list = []
        seen: set = set()
        for ix, part in self._live_parts():
            self._router.touch(ix)
            try:
                rows = part.list_results(snapshot_id)
            except SdaError:
                raise
            except Exception:
                if self._router.replicas == 1:
                    raise
                continue
            for row in rows:
                key = str(row)
                if key not in seen:
                    seen.add(key)
                    merged.append(row)
        return sorted(merged, key=str)

    def get_result(self, snapshot_id, job_id):
        targets = self._router.snapshot_targets(snapshot_id)
        if targets is not None:
            out = self._read_record("get_result", (snapshot_id, job_id), targets)
            if out is not None:
                return out
            # routed miss: the result may live with the job's pre-grow
            # home rather than the snapshot's current one
        return self._job_read(job_id, "get_result", snapshot_id, job_id)

    def get_results(self, snapshot_id) -> list:
        out, routed = self._snap_read(snapshot_id, "get_results")
        if routed:
            return out
        merged = []
        seen: set = set()
        for ix, part in self._live_parts():
            self._router.touch(ix)
            try:
                rows = part.get_results(snapshot_id)
            except SdaError:
                raise
            except Exception:
                if self._router.replicas == 1:
                    raise
                continue
            for row in rows:
                key = str(row.job)
                if key not in seen:
                    seen.add(key)
                    merged.append(row)
        return sorted(merged, key=lambda r: str(r.job))

    def count_results(self, snapshot_id) -> int:
        out, routed = self._snap_read(snapshot_id, "count_results")
        if routed:
            return out
        # merged count in every mode: a plain per-partition sum would
        # double-count rows that exist on both a moved key's former and
        # current home after a shard grow
        return len(self.list_results(snapshot_id))

    def get_results_range(self, snapshot_id, start: int, count: int) -> list:
        out, routed = self._snap_read(
            snapshot_id, "get_results_range", start, count
        )
        if routed:
            return out
        if start < 0 or count < 0:
            return []
        return self.get_results(snapshot_id)[start : start + count]
