"""The orchestration server (counterpart of ``sda_tpu/server``): the
``SdaServer`` core, its ACL-enforcing ``SdaService`` wrapper, the store
interfaces, the snapshot pipeline and the memory, JSON-file and sqlite
stores. Every constructor wraps its stores with the telemetry proxy
(:mod:`.instrument`): op latency, rows written and ``store.<op>`` spans,
labelled mem/file/sqlite. ``new_sharded_server`` puts K partitions of one
backend behind the same interfaces (``sharded.py``), with R-way
replication.
"""

from __future__ import annotations

import os

from .instrument import instrument_store
from .memstore import (
    MemAgentsStore,
    MemAggregationsStore,
    MemAuthTokensStore,
    MemClerkingJobsStore,
)
from .service import SdaServer, SdaServerService
from .stores import (
    AggregationsStore,
    AgentsStore,
    AuthToken,
    AuthTokensStore,
    BaseStore,
    ClerkingJobsStore,
)


def _server(store: str, agents, auths, aggs, jobs) -> SdaServerService:
    return SdaServerService(
        SdaServer(
            agents_store=instrument_store(agents, store),
            auth_tokens_store=instrument_store(auths, store),
            aggregation_store=instrument_store(aggs, store),
            clerking_job_store=instrument_store(jobs, store),
        )
    )


def new_mem_server() -> SdaServerService:
    """In-memory server (tests / dev)."""
    return _server(
        "mem", MemAgentsStore(), MemAuthTokensStore(), MemAggregationsStore(),
        MemClerkingJobsStore(),
    )


def new_file_server(path) -> SdaServerService:
    """Durable JSON-file-backed server (the SDA server's jfs equivalent)."""
    from .filestore import (
        FileAgentsStore,
        FileAggregationsStore,
        FileAuthTokensStore,
        FileClerkingJobsStore,
    )

    return _server(
        "file",
        FileAgentsStore(os.path.join(path, "agents")),
        FileAuthTokensStore(os.path.join(path, "auths")),
        FileAggregationsStore(os.path.join(path, "agg")),
        FileClerkingJobsStore(os.path.join(path, "jobs")),
    )


def new_sharded_server(
    kind: str, shards: int, path=None, replicas=None
) -> SdaServerService:
    """Server over K store partitions routed by aggregation id.

    ``kind`` picks the backend for every partition (``mem`` / ``file`` /
    ``sqlite``; the latter two lay partitions out under ``path`` as
    ``shard-NN`` dirs / ``shard-NN.db`` files). Agents and auth tokens —
    the small global tables — are pinned to partition 0; the
    aggregation-keyed tables are consistent-hashed over all K. With
    ``shards == 1`` this is behaviourally identical to the plain
    constructors (one partition owns the whole ring).

    ``replicas`` (default: ``SDA_SHARD_REPLICAS``, 1) writes each
    aggregation's state to the first R shards of its ring preference
    with quorum + hinted handoff, so any one partition can die mid-round
    without losing the round (see ``server/sharded.py``). R > 1 starts
    the background handoff-repair thread; the router is exposed as
    ``service.shard_router`` for operability (wedge/heal hooks, hint
    depth, deterministic drains in tests).
    """
    from .sharded import (
        ShardedAggregationsStore,
        ShardedClerkingJobsStore,
        ShardRouter,
    )

    def _partition(ix: int):
        if kind == "mem":
            return (
                MemAgentsStore(),
                MemAuthTokensStore(),
                MemAggregationsStore(),
                MemClerkingJobsStore(),
            )
        if kind == "file":
            from .filestore import (
                FileAgentsStore,
                FileAggregationsStore,
                FileAuthTokensStore,
                FileClerkingJobsStore,
            )

            root = os.path.join(path, f"shard-{ix:02d}")
            return (
                FileAgentsStore(os.path.join(root, "agents")),
                FileAuthTokensStore(os.path.join(root, "auths")),
                FileAggregationsStore(os.path.join(root, "agg")),
                FileClerkingJobsStore(os.path.join(root, "jobs")),
            )
        if kind == "sqlite":
            from .sqlstore import (
                SqliteAgentsStore,
                SqliteAggregationsStore,
                SqliteAuthTokensStore,
                SqliteBackend,
                SqliteClerkingJobsStore,
            )

            backend = SqliteBackend(os.path.join(path, f"shard-{ix:02d}.db"))
            return (
                SqliteAgentsStore(backend),
                SqliteAuthTokensStore(backend),
                SqliteAggregationsStore(backend),
                SqliteClerkingJobsStore(backend),
            )
        raise ValueError(f"unknown sharded store kind: {kind!r}")

    if kind in ("file", "sqlite") and path is None:
        raise ValueError(f"sharded {kind} store needs a path")
    if replicas is None:
        replicas = int(os.environ.get("SDA_SHARD_REPLICAS", "1") or 1)

    router = ShardRouter(shards, replicas=replicas, root=path)
    parts = [_partition(ix) for ix in range(shards)]
    # each partition's stores get the usual telemetry proxy, so per-op
    # store metrics stay labelled by backend kind exactly as before
    aggs = [instrument_store(p[2], kind) for p in parts]
    jobs = [instrument_store(p[3], kind) for p in parts]
    service = SdaServerService(
        SdaServer(
            agents_store=instrument_store(parts[0][0], kind),
            auth_tokens_store=instrument_store(parts[0][1], kind),
            aggregation_store=ShardedAggregationsStore(aggs, router),
            clerking_job_store=ShardedClerkingJobsStore(jobs, router),
        )
    )
    # elastic scale-out seam: router.add_shard() builds partition K
    # through the same factory (and telemetry proxy) the initial layout
    # used, so a grown shard is indistinguishable from a seeded one
    def _grow_partition(ix: int):
        p = _partition(ix)
        return instrument_store(p[2], kind), instrument_store(p[3], kind)

    router.new_partition = _grow_partition
    service.shard_router = router
    if router.replicas > 1:
        router.start_repair()
    return service


def new_sqlite_server(path) -> SdaServerService:
    """Production sqlite-backed server (the SDA server's mongo equivalent)."""
    from .sqlstore import (
        SqliteAgentsStore,
        SqliteAggregationsStore,
        SqliteAuthTokensStore,
        SqliteBackend,
        SqliteClerkingJobsStore,
    )

    backend = SqliteBackend(path)
    return _server(
        "sqlite",
        SqliteAgentsStore(backend),
        SqliteAuthTokensStore(backend),
        SqliteAggregationsStore(backend),
        SqliteClerkingJobsStore(backend),
    )


__all__ = [
    "SdaServer",
    "SdaServerService",
    "instrument_store",
    "new_mem_server",
    "new_file_server",
    "new_sqlite_server",
    "new_sharded_server",
    "BaseStore",
    "AuthToken",
    "AuthTokensStore",
    "AgentsStore",
    "AggregationsStore",
    "ClerkingJobsStore",
    "MemAgentsStore",
    "MemAuthTokensStore",
    "MemAggregationsStore",
    "MemClerkingJobsStore",
]
