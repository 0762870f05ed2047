"""The wire-transport rider (counterpart of ``bench.py``'s
``measure_wire_transport``): one round shape driven once per wire format."""

from __future__ import annotations

import os
import time

from ._common import (
    RssSampler,
    aggregation,
    bank,
    emit_line,
    env_int,
    rest_deployment,
    scoped_env,
    wire_bytes_by_direction,
)

WIRE_ENV = ("SDA_WIRE", "SDA_JOB_PAGE_THRESHOLD", "SDA_JOB_CHUNK_SIZE",
            "SDA_RESULT_PAGE_THRESHOLD", "SDA_RESULT_CHUNK_SIZE")


def measure_wire_transport(n_participants: int | None = None, device=None) -> dict:
    """Binary against JSON: the same round driven once per wire format over
    a loopback keep-alive server on the mem store (its commit is the same on
    both legs, so the difference is serialise, transport and parse), the
    three hot routes timed apart:

    - ingest: one batch POST of the whole sealed cohort (sealed outside the
      timed window);
    - clerking download: every chunk of one clerk's job column;
    - reveal: the paged mask and clerk-result fetch and reconstruct, held
      against the plain modular sum.

    Peak RSS is sampled per leg, payload bytes come from the
    ``sda_wire_bytes_total`` counters, and the whole is banked as
    ``wire-<stamp>.json``. N is ``SDA_BENCH_WIRE_N`` (default 3,000)."""
    from ..protocol import AdditiveSharing, FullMasking
    from ..server import new_mem_server

    n = n_participants or env_int("SDA_BENCH_WIRE_N", 3000)
    chunk = 512
    dim, modulus = 4, 433
    out: dict = {"n_participants": n, "chunk_size": chunk, "store": "mem"}

    def wire_leg(wire_env: str) -> dict:
        os.environ["SDA_WIRE"] = wire_env
        os.environ.pop("SDA_JOB_PAGE_THRESHOLD", None)
        leg: dict = {}
        with rest_deployment(lambda root: new_mem_server(), device) as d:
            service = d.service
            recipient, rkey = d.keyed("r")
            clerks = d.committee(3, staged=True)
            agg = aggregation(recipient, rkey, "wire-bench", dim, modulus, FullMasking(modulus=modulus),
                              AdditiveSharing(share_count=3, modulus=modulus))
            recipient.upload_aggregation(agg)
            recipient.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in clerks])
            participant = d.client("p", upload=True)
            # the sealed batch is built outside the timed window: this rider
            # times the wire, not the sealer
            batch = participant.new_participations([[1, 2, 3, 4]] * n, agg.id)

            bytes_before = wire_bytes_by_direction()
            with RssSampler() as rss:
                t0 = time.perf_counter()
                participant.upload_participations(batch)
                leg["ingest_s"] = round(time.perf_counter() - t0, 4)

                for knob in WIRE_ENV[1:]:
                    os.environ[knob] = str(chunk) if knob.endswith("CHUNK_SIZE") else "0"
                recipient.end_aggregation(agg.id)

                # clerking download: one clerk's whole column, chunk by
                # chunk through the negotiated route
                clerk0 = clerks[0]
                job = service.get_clerking_job(clerk0.agent, clerk0.agent.id)
                t0 = time.perf_counter()
                got = 0
                while got < job.total_encryptions:
                    got += len(service.get_clerking_job_chunk(clerk0.agent, job.id, got))
                leg["clerking_fetch_s"] = round(time.perf_counter() - t0, 4)

                for c in clerks:
                    c.run_chores(-1)

                t0 = time.perf_counter()
                revealed = recipient.reveal_aggregation(agg.id)
                leg["reveal_s"] = round(time.perf_counter() - t0, 4)
            leg["peak_rss_mib"] = rss.peak_mib
            expected = [(n * v) % modulus for v in (1, 2, 3, 4)]
            if [int(v) for v in revealed.positive().values] != expected:
                raise RuntimeError(f"wire rider reveal mismatch on {wire_env}")

            for key, val in wire_bytes_by_direction().items():
                delta = val - bytes_before.get(key, 0)
                if delta:
                    leg[f"bytes_{key}"] = int(delta)
        leg["ingest_per_s"] = round(n / leg["ingest_s"])
        leg["clerking_fetch_per_s"] = round(n / leg["clerking_fetch_s"])
        leg["reveal_per_s"] = round(n / leg["reveal_s"])
        return leg

    with scoped_env(*WIRE_ENV):
        out["json"] = wire_leg("json")
        out["binary"] = wire_leg("binary")

    for tag, per_s in (("ingest", "ingest_per_s"), ("clerking_fetch", "clerking_fetch_per_s"),
                       ("reveal", "reveal_per_s")):
        ratio = round(out["binary"][per_s] / max(1, out["json"][per_s]), 2)
        out[f"{tag}_binary_vs_json"] = ratio
        emit_line(f"wire_transport_{tag}", out["binary"][per_s], "participations_per_second",
                  vs_json=ratio,
                  json_per_s=out["json"][per_s],
                  binary_per_s=out["binary"][per_s],
                  peak_rss_json_mib=out["json"]["peak_rss_mib"],
                  peak_rss_binary_mib=out["binary"]["peak_rss_mib"],
                  roofline={"plane": "loopback_rest", "bound": "serialize_parse_then_store_commit",
                            "wire": "binary", "n": n})
    out["rss_flat"] = out["binary"]["peak_rss_mib"] <= out["json"]["peak_rss_mib"] * 1.1 + 32

    bank({"wire": {"metric": "wire_transport", **out}})
    return out
