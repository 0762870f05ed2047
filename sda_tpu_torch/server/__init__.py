"""The orchestration server (counterpart of ``sda_tpu/server``): the
``SdaServer`` core, its ACL-enforcing ``SdaService`` wrapper, the store
interfaces, the snapshot pipeline and the memory store. The file, sqlite and
sharded stores, the stores' telemetry proxy and the REST binding's
auth-token store are not ported."""

from __future__ import annotations

from .memstore import (
    MemAgentsStore,
    MemAggregationsStore,
    MemClerkingJobsStore,
)
from .service import SdaServer, SdaServerService
from .stores import (
    AggregationsStore,
    AgentsStore,
    BaseStore,
    ClerkingJobsStore,
)


def new_mem_server() -> SdaServerService:
    """In-memory server (tests / dev)."""
    return SdaServerService(
        SdaServer(
            agents_store=MemAgentsStore(),
            aggregation_store=MemAggregationsStore(),
            clerking_job_store=MemClerkingJobsStore(),
        )
    )


__all__ = [
    "SdaServer",
    "SdaServerService",
    "new_mem_server",
    "BaseStore",
    "AgentsStore",
    "AggregationsStore",
    "ClerkingJobsStore",
    "MemAgentsStore",
    "MemAggregationsStore",
    "MemClerkingJobsStore",
]
