"""The orchestration server (counterpart of ``sda_tpu/server``): the
``SdaServer`` core, its ACL-enforcing ``SdaService`` wrapper, the store
interfaces, the snapshot pipeline and the memory, JSON-file and sqlite
stores. Every constructor wraps its stores with the telemetry proxy
(:mod:`.instrument`): op latency, rows written and ``store.<op>`` spans,
labelled mem/file/sqlite. The reference's sharded store is not ported yet
(ROADMAP queue A: the sharded store).
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
