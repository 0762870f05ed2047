"""The protocol-plane riders of ``python -m sda_tpu_torch.bench``
(counterparts of ``bench.py``'s riders, ``bench.py:371-3011``).

Each rider drives one host plane of the port through the entry points a
deployment calls (the native batch layer, REST, the stores, the clerking
and reveal pipelines, the worker pools, the sharded store, tiers and
sketches), holds every reveal byte-exact against the plain modular sum,
prints one metric line per leg and returns the reference's result dict.
The bench runs them before its device run and attaches their results
under ``crypto`` on its metric line.

Knobs, the reference's own: ``SDA_BENCH_CLERKING_N``, ``_REVEAL_N``,
``_WIRE_N``, ``_SHARD_N``, ``_REPLICATION_N``, ``_COMMITTEE_N``, ``_TIER_N``,
``_TIER_REPS``, ``_TIER_AB_DIM``, ``_TIER_AB_N``, ``_TIER_AB_REPS``;
``SDA_BENCH_RIDERS=0`` runs only the first two (``HOST_PLANES``);
``SDA_BENCH_ARTIFACTS=0`` banks nothing. Artifacts go to
``bench-artifacts-torch/`` at the checkout's root.
"""

from __future__ import annotations

from ._common import ARTIFACTS_DIR, RUN_TRACE_ID, set_artifacts_dir, stage
from .committee import measure_committee_scaling
from .crypto import measure_crypto_plane
from .ingest import measure_batched_ingest, measure_rest_ingest
from .pipelines import measure_clerking_pipeline, measure_reveal_pipeline
from .scaleout import measure_replication_overhead, measure_shard_scaling
from .sketches import measure_sketch_accuracy
from .tiers import measure_tier_fanout
from .wire import measure_wire_transport

#: ``(key, stage, rider)``: the two host planes that always run, their
#: results merged into ``crypto``
HOST_PLANES = (
    ("crypto_plane", "crypto-plane host bench", measure_crypto_plane),
    ("rest_ingest", "rest-ingest loopback bench", measure_rest_ingest),
)
#: the nine that ``SDA_BENCH_RIDERS=0`` skips, in the reference's order, each
#: under its key in ``crypto`` and each given the clients' device
RIDERS = (
    ("ingest", "batched-ingest rider", measure_batched_ingest),
    ("wire", "wire-transport rider", measure_wire_transport),
    ("clerking", "clerking-pipeline rider", measure_clerking_pipeline),
    ("reveal", "reveal-pipeline rider", measure_reveal_pipeline),
    ("committee", "committee-scaling rider", measure_committee_scaling),
    ("shard", "shard-scaling rider", measure_shard_scaling),
    ("replication", "replication rider", measure_replication_overhead),
    ("tier", "tier-fanout rider", measure_tier_fanout),
    ("sketch", "sketch-accuracy rider", measure_sketch_accuracy),
)

__all__ = [
    "ARTIFACTS_DIR",
    "HOST_PLANES",
    "RIDERS",
    "RUN_TRACE_ID",
    "measure_batched_ingest",
    "measure_clerking_pipeline",
    "measure_committee_scaling",
    "measure_crypto_plane",
    "measure_replication_overhead",
    "measure_rest_ingest",
    "measure_reveal_pipeline",
    "measure_shard_scaling",
    "measure_sketch_accuracy",
    "measure_tier_fanout",
    "measure_wire_transport",
    "set_artifacts_dir",
    "stage",
]
