"""The clerking- and reveal-pipeline riders (counterparts of ``bench.py``'s
``measure_clerking_pipeline`` and ``measure_reveal_pipeline``): paged,
pipelined delivery against the monolithic one over loopback REST on
sqlite."""

from __future__ import annotations

import time

import numpy as np

from ._common import (
    RssSampler,
    aggregation,
    bank,
    emit_line,
    env_int,
    gauge_value,
    rest_deployment,
    scoped_env,
    set_env,
)

CHUNK_SIZES = [1024, 4096, 16384]
#: paging off: a threshold above any column
MONOLITHIC = 10**9


def _ratio(cfg: dict, mono: dict):
    if cfg["encryptions_per_s"] and mono["encryptions_per_s"]:
        return round(cfg["encryptions_per_s"] / mono["encryptions_per_s"], 2)
    return None


def _emit_configs(family: str, out: dict, n: int, n_clerks: int, bound: str) -> None:
    """One line per chunked config, then the monolithic one."""
    mono = out["configs"]["monolithic"]
    for cs in CHUNK_SIZES:
        cfg = out["configs"][f"chunked_{cs}"]
        emit_line(f"{family}_chunked_{cs}", cfg["encryptions_per_s"], "encryptions_per_second",
                  vs_monolithic=cfg["vs_monolithic"], n_participants=n, clerks=n_clerks,
                  chunk_size=cs, peak_rss_mib=cfg["peak_rss_mib"],
                  monolithic_per_s=mono["encryptions_per_s"],
                  monolithic_peak_rss_mib=mono["peak_rss_mib"],
                  overlap_efficiency=cfg["overlap_efficiency"],
                  roofline={"plane": "loopback_rest", "bound": bound, "in_flight_chunks": 2})
    emit_line(f"{family}_monolithic", mono["encryptions_per_s"], "encryptions_per_second",
              vs_monolithic=1.0, n_participants=n, clerks=n_clerks,
              peak_rss_mib=mono["peak_rss_mib"],
              roofline={"plane": "loopback_rest", "bound": "download_then_decrypt_serial",
                        "in_flight_chunks": "whole column"})


def _sqlite(root):
    from ..server import new_sqlite_server

    return new_sqlite_server(str(root / "sda.db"))


def measure_clerking_pipeline(n_participants: int | None = None, device=None) -> dict:
    """Paged, pipelined clerking-job delivery against the monolithic poll.

    N participations are seeded once; then two snapshots of the same cohort
    are cut, one enqueued with paging off (the inline layout and monolithic
    wire shape) and one with paging forced (the externalised column). Each
    clerk's ``process_clerking_job`` is timed against the monolithic job
    and against the paged job at each chunk size: a job stays queued until
    its result is posted, so the paged job is polled again, identically,
    per size. Per config: encryptions/s, the process's peak RSS (clerk and
    server share it) and the clerk's overlap-efficiency gauge. N is
    ``SDA_BENCH_CLERKING_N`` (default 6,000)."""
    from ..protocol import AdditiveSharing, NoMasking, Snapshot, SnapshotId

    n = n_participants or env_int("SDA_BENCH_CLERKING_N", 6000)
    n_clerks = 2
    out: dict = {"n_participants": n, "clerks": n_clerks, "configs": {}}

    def set_paging(threshold, chunk):
        set_env("SDA_JOB_PAGE_THRESHOLD", threshold)
        set_env("SDA_JOB_CHUNK_SIZE", chunk)

    with scoped_env("SDA_JOB_PAGE_THRESHOLD", "SDA_JOB_CHUNK_SIZE"), \
            rest_deployment(_sqlite, device) as d:
        recipient, rkey = d.keyed("r")
        clerks = d.committee(n_clerks)
        agg = aggregation(recipient, rkey, "clerking-bench", 4, 433, NoMasking(),
                          AdditiveSharing(share_count=n_clerks, modulus=433))
        recipient.upload_aggregation(agg)
        # the default selection skips the keyed recipient, so every clerk
        # gets a seat without pinning
        recipient.begin_aggregation(agg.id)
        participant = d.client("p", upload=True)

        t0 = time.perf_counter()
        participant.participate_many([[1, 2, 3, 4]] * n, agg.id, chunk_size=512)
        out["seed_s"] = round(time.perf_counter() - t0, 2)

        def run_config(tag: str, threshold, chunk, post_results: bool) -> dict:
            set_paging(threshold, chunk)
            total_s = 0.0
            results = []
            with RssSampler() as rss:
                for clerk in clerks:
                    job = clerk.service.get_clerking_job(clerk.agent, clerk.agent.id)
                    t1 = time.perf_counter()
                    results.append((clerk, clerk.process_clerking_job(job)))
                    total_s += time.perf_counter() - t1
            if post_results:
                for clerk, result in results:
                    clerk.service.create_clerking_result(clerk.agent, result)
            cfg = {
                "encryptions_per_s": round(n * n_clerks / total_s) if total_s else None,
                "wall_s": round(total_s, 3),
                "peak_rss_mib": rss.peak_mib,
                "chunk_size": chunk,
                "overlap_efficiency": gauge_value("sda_clerk_overlap_efficiency"),
            }
            out["configs"][tag] = cfg
            return cfg

        def cut_snapshot():
            # created directly: end_aggregation does nothing once a snapshot
            # exists, and this rider cuts two of the same cohort
            recipient.service.create_snapshot(
                recipient.agent, Snapshot(id=SnapshotId.random(), aggregation=agg.id))

        set_paging(MONOLITHIC, None)
        cut_snapshot()
        mono = run_config("monolithic", MONOLITHIC, None, post_results=True)
        # the paged snapshot: polled again per chunk size, never marked done
        set_paging(0, 4096)
        cut_snapshot()
        for cs in CHUNK_SIZES:
            cfg = run_config(f"chunked_{cs}", 0, cs, post_results=False)
            cfg["vs_monolithic"] = _ratio(cfg, mono)
        _emit_configs("clerking_pipeline", out, n, n_clerks, "max(download, decrypt+combine)")

    bank({"clerking": {
        "metric": "clerking_pipeline",
        "config": {"n_participants": n, "clerks": n_clerks, "chunk_sizes": CHUNK_SIZES, "dim": 4,
                   "committee": f"additive x{n_clerks}", "store": "sqlite",
                   "transport": "loopback_rest"},
        **out,
    }})
    return out


def measure_reveal_pipeline(n_participants: int | None = None, device=None) -> dict:
    """Paged, pipelined snapshot-result delivery against the monolithic
    reveal.

    N Full-masked participations are seeded and clerked once, the mask
    column stored externalised so it can be served both ways; then the same
    snapshot's ``reveal_aggregation`` is timed monolithic and chunked at
    each size. Reveal only reads, so every config sees the same stored state
    and must give byte-identical output (held per config against the
    monolithic values, which are held against the plain modular sum). The
    masks fold on the host: N x 32 stays far below the device fold's
    threshold. N is ``SDA_BENCH_REVEAL_N`` (default 6,000)."""
    from ..protocol import AdditiveSharing, FullMasking

    n = n_participants or env_int("SDA_BENCH_REVEAL_N", 6000)
    n_clerks, dim, modulus = 2, 32, 433
    out: dict = {"n_participants": n, "clerks": n_clerks, "configs": {}}

    def set_paging(threshold, chunk):
        set_env("SDA_RESULT_PAGE_THRESHOLD", threshold)
        set_env("SDA_RESULT_CHUNK_SIZE", chunk)

    with scoped_env("SDA_RESULT_PAGE_THRESHOLD", "SDA_RESULT_CHUNK_SIZE"), \
            rest_deployment(_sqlite, device) as d:
        recipient, rkey = d.keyed("r")
        clerks = d.committee(n_clerks)
        # Full masking: the reveal plane's own load is the N-long
        # mask-encryption column, which gives the pipeline pages to fetch
        agg = aggregation(recipient, rkey, "reveal-bench", dim, modulus, FullMasking(modulus=modulus),
                          AdditiveSharing(share_count=n_clerks, modulus=modulus))
        recipient.upload_aggregation(agg)
        recipient.begin_aggregation(agg.id)
        participant = d.client("p", upload=True)

        t0 = time.perf_counter()
        participant.participate_many([[1] * dim] * n, agg.id, chunk_size=512)
        # paging forced at the snapshot, so the mask column is stored
        # externalised: servable monolithic and chunked
        set_paging(0, 4096)
        recipient.end_aggregation(agg.id)
        for clerk in clerks:
            clerk.run_chores(-1)
        out["seed_s"] = round(time.perf_counter() - t0, 2)

        def run_config(tag: str, threshold, chunk):
            set_paging(threshold, chunk)
            with RssSampler() as rss:
                t1 = time.perf_counter()
                revealed = recipient.reveal_aggregation(agg.id)
                wall = time.perf_counter() - t1
            cfg = {
                "encryptions_per_s": round(n / wall) if wall else None,
                "wall_s": round(wall, 3),
                "peak_rss_mib": rss.peak_mib,
                "chunk_size": chunk,
                "n_participants": n,
                "overlap_efficiency": gauge_value("sda_reveal_overlap_efficiency"),
            }
            out["configs"][tag] = cfg
            return cfg, np.asarray(revealed.values), np.asarray(revealed.positive().values)

        mono, mono_values, mono_positive = run_config("monolithic", MONOLITHIC, None)
        np.testing.assert_array_equal(mono_positive, np.full(dim, n % modulus, dtype=np.int64))
        for cs in CHUNK_SIZES:
            cfg, values, _ = run_config(f"chunked_{cs}", 0, cs)
            np.testing.assert_array_equal(values, mono_values)
            cfg["vs_monolithic"] = _ratio(cfg, mono)
        _emit_configs("reveal_pipeline", out, n, n_clerks, "max(download, decrypt+fold)")

    bank({"reveal": {
        "metric": "reveal_pipeline",
        "config": {"n_participants": n, "clerks": n_clerks, "chunk_sizes": CHUNK_SIZES, "dim": dim,
                   "masking": "full", "committee": f"additive x{n_clerks}", "store": "sqlite",
                   "transport": "loopback_rest"},
        **out,
    }})
    return out
