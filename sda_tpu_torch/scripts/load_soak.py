"""Sustained-load soak rider: hold a pinned arrival rate against a live
loopback REST server and bank the longitudinal evidence (counterpart of
``scripts/load_soak.py``).

Drives full participation rounds — register once, then per round: build
a fresh aggregation, submit ``--round-size`` participations at a pinned
``--rate`` (participations/s, paced per submission like sporadic
phones), cut the snapshot, run the clerks through the PAGED pipeline,
reveal, and assert the aggregate is byte-exact — for ``--duration``
seconds, with the time-series sampler scraping the shared process-global
registry every ``--interval`` seconds.

Banks ``soak-<stamp>.json`` into the artifact dir with:

- ``samples``: the sampler's full window — per-route throughput and
  windowed p50/p95/p99, store-op rates, wire bytes/s, RSS, rate
  counters: the throughput/p99/RSS-over-time series;
- ``rounds``: per-round trace id, achieved arrival rate, wall time, and
  exactness — every round must reveal the exact sum;
- ``spans``: the span ring at exit, so ``trace_report`` can
  render any banked round's flight-recorder timeline straight from this
  artifact;
- ``fault_counters``: injected-fault and client-retry totals (nonzero
  only when ``SDA_FAULTS`` shapes the run);
- ``admission``: ``sda_rest_shed_total`` sum and per-route split —
  nonzero only when ``--max-inflight`` caps the frontends and
  ``--submit-workers`` bursts hard enough to trip it;
- ``sampler_overhead_pct``: a sampler-off vs sampler-on A/B over
  ``--ab-rounds`` unpaced rounds each; the background scrape must cost
  < 2%.

``--frontends N`` serves the same shared service from N REST frontends;
the multi-root client hashes each aggregation id to a home frontend and
fails over on connect errors.  The banked ``samples`` series is bounded
at ``SDA_SOAK_MAX_SAMPLES`` entries (newest kept, rest thinned at a
uniform stride).

``--shards K --replicas R`` runs the replicated sharded plane instead of
the plain mem store, and ``--kill-shard M`` wedges the round's HOME
store shard for the whole body of every M-th round (writes ride the
surviving replica, the dead shard's writes queue as hints); the shard
heals when the round completes and the soak waits for hinted handoff to
drain before moving on.  Every round — killed or not — must still reveal
byte-exactly; the artifact is banked as ``replica-soak-<stamp>.json`` so
the replica-soak family rolls up separately from the plain soaks.

Every client computes on ``--device`` (CUDA by default; without a GPU
the script exits 2). ``run_round(..., values=...)`` takes a round's rows
from the caller instead of ``workload_values`` (a wide round on the card).

The server runs with ``SDA_TS=0`` — the script owns the global sampler
explicitly so the A/B legs can hold it stopped — and the live
``GET /v1/metrics/history`` route is scraped once mid-soak to prove the
window is served over the wire, not just in memory.

Usage:
  python -m sda_tpu_torch.scripts.load_soak --duration 60       # the default soak
  python -m sda_tpu_torch.scripts.load_soak --duration 20 --rate 40 --interval 1  # CI smoke
  python -m sda_tpu_torch.scripts.load_soak --duration 20 --frontends 3 \
      --max-inflight 1 --submit-workers 8   # multi-frontend, shedding
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

from ..utils.faults import Backoff
from . import REPO, device_or_exit

DIM = 4
MODULUS = 100003

#: paged delivery, so the clerk/reveal pipeline spans (the flight
#: recorder's clerking + reveal tracks) appear in every round; ``main``
#: applies it to its server unless the environment already says otherwise
PAGED_ENV = {"SDA_JOB_PAGE_THRESHOLD": "0", "SDA_JOB_CHUNK_SIZE": "32",
             "SDA_RESULT_PAGE_THRESHOLD": "0", "SDA_RESULT_CHUNK_SIZE": "32"}

#: the sketch workload's count-min shape, shared with ``flagship``: each
#: phone's payload is its encoded grid — dim 128 instead of 4, so the
#: soak pushes the sketch plane's fat columns through ingest, the paged
#: clerking pipeline, and reveal at the pinned arrival rate
WORKLOAD_SKETCH_SHAPE = {"width": 32, "depth": 4, "seed": 7}


def workload_sketch():
    from ..sketches import CountMinSketch

    return CountMinSketch(**WORKLOAD_SKETCH_SHAPE)


def workload_items(ix: int, i: int) -> list:
    """Phone i's private items for round (or flagship rung) ix — app-0
    dominates the round-wide counts, so the decoded grid has a known
    heavy hitter."""
    return [f"app-{(ix + i) % 6}", f"app-{i % 9}", f"app-{(3 * i) % 13}"]


def workload_values(ix: int, n: int, workload: str) -> list:
    if workload == "sketch":
        cm = workload_sketch()
        return [[int(c) for c in cm.encode(workload_items(ix, i))]
                for i in range(n)]
    return [[(ix + i) % 11, i % 7, 1, (3 * i) % 5] for i in range(n)]


def build_stack(tmp: pathlib.Path, roots, device=None):
    """Recipient + committee + one pinned-rate participant, registered
    once against the live server; rounds reuse these identities.
    ``roots`` may be a single base URL or a list (multi-frontend soak) —
    the client hashes aggregation ids across the list. Every client
    computes on ``device``."""
    from ..client import SdaClient
    from ..crypto import Keystore
    from ..rest import SdaHttpClient, TokenStore

    def new_client(name):
        keystore = Keystore(str(tmp / name))
        service = SdaHttpClient(roots, TokenStore(str(tmp / name)))
        return SdaClient(SdaClient.new_agent(keystore), keystore, service, device=device)

    recipient = new_client("recipient")
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    clerks = [new_client(f"clerk{i}") for i in range(2)]
    for c in clerks:
        c.upload_agent()
        c.upload_encryption_key(c.new_encryption_key())
    participant = new_client("participant")
    participant.upload_agent()
    return recipient, rkey, clerks, participant


def new_round_aggregation(recipient, rkey, clerks, tag: str, dim: int = DIM):
    from ..protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        ChaChaMasking,
        SodiumEncryptionScheme,
    )

    agg = Aggregation(
        id=AggregationId.random(),
        title=f"soak-{tag}",
        vector_dimension=dim,
        modulus=MODULUS,
        recipient=recipient.agent.id,
        recipient_key=rkey,
        masking_scheme=ChaChaMasking(
            modulus=MODULUS, dimension=dim, seed_bitsize=128
        ),
        committee_sharing_scheme=AdditiveSharing(
            share_count=len(clerks), modulus=MODULUS
        ),
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme(),
    )
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in clerks])
    return agg


def run_round(ix: int, stack, round_size: int, rate: float | None,
              submit_services=None, kill_router=None, trace_ctx=None,
              workload: str = "dense", values=None) -> dict:
    """One full round; returns the per-round record. Raises on an
    inexact reveal — a soak that silently aggregates wrong numbers is
    worse than one that stops.

    Submission is paced sequentially by default.  With
    ``submit_services`` (one extra REST client per worker) the round
    submits concurrently and unpaced instead — the burst shape that can
    actually trip admission control; paced one-at-a-time arrivals never
    exceed one in-flight request, so they can never shed.

    ``kill_router`` (a ShardRouter, --kill-shard rounds only) wedges the
    round's home store shard right after the aggregation opens and heals
    it once the reveal lands — ingest, snapshot, clerking, and reveal
    all ride the surviving replica while the victim's writes queue as
    hints.

    ``trace_ctx`` (--trace runs) replaces the pinned-rate pacing with a
    live arrival trace: ``{"trace": ArrivalTrace, "index": k, "t": last
    trace time, "t0": perf_counter at soak start}``. The cursor persists
    across rounds so the diurnal phase and burst slots run continuously
    through the whole soak; churned arrivals are deferred to the end of
    the round (the disconnect-and-retry flood) — they still land before
    the snapshot, so every reveal stays exact.

    ``values`` (``round_size`` rows of residues mod ``MODULUS``, a list or
    an array) replaces ``workload_values``; the round's width is theirs."""
    import concurrent.futures

    from .. import telemetry
    from ..client.ingest import ingest_cohort, pipeline_enabled

    recipient, rkey, clerks, participant = stack
    if values is None:
        values = workload_values(ix, round_size, workload)
    dim = len(values[0])
    # the exact sum: rows are below MODULUS, so int64 holds any round's
    # column total before the reduction
    expected = np.asarray(values, dtype=np.int64).sum(axis=0) % MODULUS

    t_round0 = time.perf_counter()
    victim = None
    churned = None
    try:
        with telemetry.trace(f"soak-round-{ix}") as trace_id:
            agg = new_round_aggregation(recipient, rkey, clerks, str(ix),
                                        dim=dim)
            if kill_router is not None:
                victim = kill_router.targets(agg.id)[0]
                kill_router.wedge(victim)
            # trace rounds ride the arrival pipeline (plan/build/upload
            # inside ingest_cohort), so they skip the upfront build;
            # SDA_INGEST_PIPELINE=0 pins the legacy paced-singles path
            pipelined_trace = trace_ctx is not None and pipeline_enabled()
            if not pipelined_trace:
                with telemetry.span("ingest.build", rows=round_size):
                    parts = participant.new_participations(values, agg.id)
            t0 = time.perf_counter()
            if pipelined_trace:
                report = ingest_cohort(
                    [participant], values, agg.id,
                    trace=trace_ctx["trace"], cursor=trace_ctx,
                )
                churned = report.churned
            elif submit_services:
                # concurrent burst: each worker drains its slice flat-out
                # on its own client; 429s surface as client-side paced
                # retries (sda_rest_retries_total), sheds tick
                # sda_rest_shed_total
                def drain(worker_ix):
                    service = submit_services[worker_ix]
                    for p in parts[worker_ix::len(submit_services)]:
                        with telemetry.span("ingest.upload", rows=1):
                            service.create_participation(participant.agent, p)
                with concurrent.futures.ThreadPoolExecutor(
                        max_workers=len(submit_services)) as pool:
                    for f in [pool.submit(drain, w)
                              for w in range(len(submit_services))]:
                        f.result()
            elif trace_ctx is not None:
                # live arrival trace: pace each phone to its trace time
                # (absolute against the soak's t0, so a slow round never
                # silently slows the offered process), defer churned
                # arrivals to a retry flood at the end of the round
                trace = trace_ctx["trace"]
                deferred = []
                for p in parts:
                    k = trace_ctx["index"]
                    trace_ctx["index"] = k + 1
                    trace_ctx["t"] = trace.next_arrival(k, trace_ctx["t"])
                    delay = trace_ctx["t0"] + trace_ctx["t"] - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    if trace.is_churned(k):
                        deferred.append(p)
                        continue
                    with telemetry.span("ingest.upload", rows=1):
                        participant.upload_participation(p)
                for p in deferred:
                    with telemetry.span("ingest.upload", rows=1):
                        participant.upload_participation(p)
                churned = len(deferred)
            else:
                # pinned arrival: one submission per 1/rate seconds,
                # absolute schedule (sleep to the slot, not after the
                # previous request) so a slow request doesn't silently
                # lower the offered rate
                interarrival = (1.0 / rate) if rate else 0.0
                for i, p in enumerate(parts):
                    if interarrival:
                        delay = t0 + i * interarrival - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                    with telemetry.span("ingest.upload", rows=1):
                        participant.upload_participation(p)
            ingest_s = time.perf_counter() - t0
            recipient.end_aggregation(agg.id)
            for c in clerks:
                c.run_chores(-1)
            out = recipient.reveal_aggregation(agg.id).positive().values
    finally:
        if victim is not None:
            kill_router.heal(victim)
    exact = bool(np.array_equal(np.asarray(out), expected))
    if not exact:
        raise AssertionError(
            f"round {ix} inexact: got {list(out)[:8]}, want {expected.tolist()[:8]}"
        )
    r = {
        "round": ix,
        "trace_id": trace_id,
        "n": round_size,
        "rate_target": rate,
        "rate_achieved": round(round_size / ingest_s, 2) if ingest_s > 0 else None,
        "round_s": round(time.perf_counter() - t_round0, 3),
        "exact": exact,
        "killed_shard": victim,
        "churned": churned,
    }
    if workload == "sketch":
        # the exact grid must also DECODE: count-min never undercounts
        # (guaranteed, so asserted); the one-sided overshoot vs the
        # analytic bound is recorded per round
        from collections import Counter

        cm = workload_sketch()
        grid = np.asarray(out, dtype=np.int64)
        true = Counter(
            it for i in range(round_size) for it in workload_items(ix, i)
        )
        hot, hot_true = true.most_common(1)[0]
        est = int(cm.point_query(grid, hot))
        bound = cm.error_bound(grid)
        if est < hot_true:
            raise AssertionError(f"round {ix}: count-min undercounted {hot}")
        r["sketch"] = {
            "hot_item": hot,
            "true": hot_true,
            "estimate": est,
            "bound": round(bound, 2),
            "within_bound": bool(est <= hot_true + bound),
        }
    return r


def measure_sampler_overhead(stack, round_size: int, ab_rounds: int,
                             interval_s: float,
                             workload: str = "dense") -> dict | None:
    """Sampler-off vs sampler-on A/B: one warm
    full round to populate the registry with every hot series (so the
    on-arm scrapes a realistic snapshot), then ``ab_rounds`` interleaved
    off/on batches of foreground requests — interleaving makes drift hit
    both arms equally. The sampler runs at a deliberately hot interval
    (10x the soak rate, floored at 50ms) so the measurement bounds the
    production cost from above; overhead is the on-vs-off wall delta."""
    from ..telemetry import TimeSeriesSampler

    if ab_rounds <= 0:
        return None
    # warm everything (JIT, connection pool, key caches) and light every
    # series the soak will light, so the scrape under test is full-size
    run_round(9000, stack, round_size, None, workload=workload)
    service = stack[3].service
    service.ping()
    batch = 200
    t_off = t_on = 0.0
    for _ in range(ab_rounds):
        t0 = time.perf_counter()
        for _ in range(batch):
            service.ping()
        t_off += time.perf_counter() - t0
        sampler = TimeSeriesSampler(
            interval_s=max(0.05, interval_s / 10.0)
        ).start()
        try:
            t0 = time.perf_counter()
            for _ in range(batch):
                service.ping()
            t_on += time.perf_counter() - t0
        finally:
            sampler.stop()
    pct = (t_on - t_off) / t_off * 100.0
    return {
        "batches_per_arm": ab_rounds,
        "requests_per_arm": ab_rounds * batch,
        "sampler_off_s": round(t_off, 4),
        "sampler_on_s": round(t_on, 4),
        "overhead_pct": round(pct, 2),
        "ok": pct < 2.0,
    }


def fault_counters() -> dict:
    """Injected-fault and retry totals from the registry (labels summed
    away) — nonzero only when SDA_FAULTS shaped the run."""
    from .. import telemetry

    out: dict = {}
    snap = telemetry.get_registry().snapshot()
    for (name, _labels), value in snap["counters"].items():
        if name in ("sda_fault_injections_total", "sda_rest_retries_total"):
            out[name] = out.get(name, 0) + value
    return out


def admission_counters() -> dict:
    """Shed totals (sum + per-route split) — the frontends run in-process,
    so their sda_rest_shed_total ticks land in this same registry.
    Nonzero only when SDA_REST_MAX_INFLIGHT caps the run."""
    from .. import telemetry

    total, by_route = 0, {}
    snap = telemetry.get_registry().snapshot()
    for (name, labels), value in snap["counters"].items():
        if name == "sda_rest_shed_total":
            total += value
            route = dict(labels).get("route", "?")
            by_route[route] = by_route.get(route, 0) + value
    return {"sda_rest_shed_total": total, "by_route": by_route}


def downsample(samples: list, cap: int) -> list:
    """Bound the banked sample series at ``cap`` entries: always keep the
    newest sample, and thin the rest with a uniform stride so the window
    still spans the whole soak.  Long soaks otherwise bank megabytes of
    per-interval snapshots."""
    if cap <= 0 or len(samples) <= cap:
        return samples
    if cap == 1:
        return [samples[-1]]
    head, newest = samples[:-1], samples[-1]
    kept = [head[i * len(head) // (cap - 1)] for i in range(cap - 1)]
    return kept + [newest]


def summarize(samples: list) -> dict:
    """Headline numbers over the banked window: mean/max total rps, the
    worst windowed p99 per hot route, and the RSS trajectory."""
    total_rps = [
        sum(r.get("rps", 0.0) for r in s.get("routes", {}).values())
        for s in samples
    ]
    p99_by_route: dict = {}
    for s in samples:
        for route, r in s.get("routes", {}).items():
            if "p99_s" in r:
                entry = p99_by_route.setdefault(route, [])
                entry.append(r["p99_s"])
    rss = [s["rss_mib"] for s in samples if s.get("rss_mib")]
    return {
        "rps_mean": round(sum(total_rps) / len(total_rps), 2) if total_rps else None,
        "rps_max": round(max(total_rps), 2) if total_rps else None,
        "p99_s_by_route": {
            route: {"max": max(v), "last": v[-1]}
            for route, v in sorted(p99_by_route.items())
        },
        "rss_mib": {
            "start": rss[0] if rss else None,
            "end": rss[-1] if rss else None,
            "peak": max(rss) if rss else None,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sda_tpu_torch.scripts.load_soak",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=60.0,
                    help="soak length in seconds (default 60)")
    ap.add_argument("--rate", type=float, default=40.0,
                    help="pinned arrival rate, participations/s (default 40)")
    ap.add_argument("--trace", default=None, metavar="SPEC",
                    help="replace the pinned rate with a deterministic "
                         "arrival trace (sda_tpu_torch.utils.arrivals grammar: "
                         "base=R[,diurnal=A@P][,burst=P@M][,churn=P][:seed]"
                         ") — diurnal phase and burst slots run "
                         "continuously across rounds; churned arrivals "
                         "retry at the end of their round")
    ap.add_argument("--round-size", type=int, default=80,
                    help="participations per round (default 80)")
    ap.add_argument("--workload", choices=["dense", "sketch"], default="dense",
                    help="round payload: the dense 4-wide control vectors, "
                         "or each phone's count-min sketch columns "
                         "(dim 128) decoded after every exact reveal "
                         "(default dense)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="sampler interval in seconds (default 2)")
    ap.add_argument("--ab-rounds", type=int, default=3,
                    help="rounds per arm of the sampler overhead A/B "
                         "(0 skips it; default 3)")
    ap.add_argument("--frontends", type=int, default=1, metavar="N",
                    help="serve N REST frontends over the one shared "
                         "service; the client hashes aggregation ids "
                         "across them (default 1)")
    ap.add_argument("--max-inflight", type=int, default=0,
                    help="per-frontend admission cap (exported as "
                         "SDA_REST_MAX_INFLIGHT; 0 = off, the default)")
    ap.add_argument("--queue-high-water", type=int, default=0,
                    help="extra admitted-but-queued slack above the cap "
                         "(SDA_REST_QUEUE_HIGH_WATER; default 0)")
    ap.add_argument("--submit-workers", type=int, default=1, metavar="W",
                    help="submit each round concurrently from W clients "
                         "instead of paced one-at-a-time — the burst "
                         "shape that exercises admission control "
                         "(default 1 = sequential paced)")
    ap.add_argument("--shards", type=int, default=1, metavar="K",
                    help="run the service over K mem store shards "
                         "instead of the plain mem store (default 1)")
    ap.add_argument("--replicas", type=int, default=1, metavar="R",
                    help="replicate aggregation state over the first R "
                         "shards of the ring preference (default 1)")
    ap.add_argument("--grow-shards", type=int, default=0, metavar="G",
                    help="add G store shards live during the soak, one "
                         "per odd-numbered round, each grow migrating in "
                         "the background WHILE that round runs — every "
                         "reveal must stay byte-exact across the resize "
                         "and the handoff/migration queue must drain to "
                         "zero (0 = off, the default)")
    ap.add_argument("--kill-shard", type=int, default=0, metavar="M",
                    help="wedge the round's home store shard for the "
                         "whole body of every M-th round, heal it after "
                         "the reveal, and wait for hinted handoff to "
                         "drain (needs --shards > 1 --replicas > 1; "
                         "0 = off, the default)")
    ap.add_argument("--artifacts", default=str(REPO / "bench-artifacts"))
    ap.add_argument("--device", default="cuda",
                    help="the clients' torch device (default cuda; exits 2 "
                         "without a GPU)")
    args = ap.parse_args(argv)

    if args.kill_shard > 0 and (args.shards < 2 or args.replicas < 2):
        ap.error("--kill-shard needs --shards >= 2 and --replicas >= 2 "
                 "(a single-home round cannot survive losing its shard)")
    if args.grow_shards > 0 and args.kill_shard > 0:
        ap.error("--grow-shards and --kill-shard are separate axes: a "
                 "grow flip waits for the handoff queue to drain, which "
                 "a wedged shard holds open forever")
    device = device_or_exit("load_soak", args.device)

    os.environ["SDA_TS"] = "0"  # the script owns the sampler, not the server
    os.environ["SDA_TS_INTERVAL_S"] = str(args.interval)
    if args.max_inflight > 0:
        os.environ["SDA_REST_MAX_INFLIGHT"] = str(args.max_inflight)
        os.environ["SDA_REST_QUEUE_HIGH_WATER"] = str(args.queue_high_water)
    for key, value in PAGED_ENV.items():
        os.environ.setdefault(key, value)

    import contextlib

    from .. import telemetry
    from ..rest import serve_background, serve_background_multi
    from ..server import new_mem_server
    from ..telemetry import timeseries

    if not telemetry.enabled():
        print("load_soak: SDA_TELEMETRY=0 — nothing to sample", file=sys.stderr)
        return 1

    record: dict = {
        "kind": "soak",
        "config": {
            "duration_s": args.duration,
            "rate": args.rate,
            "round_size": args.round_size,
            "workload": args.workload,
            "interval_s": args.interval,
            "frontends": args.frontends,
            "max_inflight": args.max_inflight,
            "queue_high_water": args.queue_high_water,
            "submit_workers": args.submit_workers,
            "shards": args.shards,
            "replicas": args.replicas,
            "kill_shard": args.kill_shard,
            "grow_shards": args.grow_shards,
            "trace": args.trace,
            "faults": os.environ.get("SDA_FAULTS"),
        },
    }
    if args.shards > 1 or args.grow_shards > 0:
        from ..server import new_sharded_server

        # a grow axis needs the elastic router even from K=1
        server = new_sharded_server("mem", args.shards, replicas=args.replicas)
    else:
        server = new_mem_server()
    router = getattr(server, "shard_router", None)
    with contextlib.ExitStack() as ctx:
        if args.frontends > 1:
            roots = ctx.enter_context(
                serve_background_multi(server, args.frontends))
        else:
            roots = ctx.enter_context(serve_background(server))
        tmp = pathlib.Path(ctx.enter_context(tempfile.TemporaryDirectory()))
        stack = build_stack(tmp, roots, device)
        http = stack[3].service  # the participant's SdaHttpClient
        submit_services = None
        if args.submit_workers > 1:
            # one extra client per worker, sharing the participant's
            # token dir (tokens are negotiated once and cached on disk)
            from ..rest import SdaHttpClient, TokenStore
            submit_services = [
                SdaHttpClient(roots, TokenStore(str(tmp / "participant")))
                for _ in range(args.submit_workers)
            ]

        record["sampler_ab"] = measure_sampler_overhead(
            stack, args.round_size, args.ab_rounds, args.interval,
            workload=args.workload,
        )
        if record["sampler_ab"]:
            record["sampler_overhead_pct"] = record["sampler_ab"]["overhead_pct"]
            print(f"[soak] sampler overhead A/B: "
                  f"{record['sampler_overhead_pct']:+.2f}% over "
                  f"{record['sampler_ab']['requests_per_arm']} requests/arm",
                  file=sys.stderr)

        telemetry.reset()  # the soak window starts clean of A/B traffic
        sampler = timeseries.acquire()
        trace_ctx = None
        if args.trace:
            from ..utils.arrivals import ArrivalTrace

            trace_ctx = {
                "trace": ArrivalTrace.from_text(args.trace),
                "index": 0,
                "t": 0.0,
                "t0": time.perf_counter(),
            }
        grows_done = 0
        try:
            rounds: list = []
            deadline = time.monotonic() + args.duration
            ix = 0
            while time.monotonic() < deadline:
                kill = (
                    args.kill_shard > 0
                    and ix % args.kill_shard == args.kill_shard - 1
                )
                grow_thread = grow_info = None
                if (args.grow_shards > 0 and grows_done < args.grow_shards
                        and ix % 2 == 1):
                    # the grow — copy, handoff drain, ring flip — runs in
                    # the background WHILE this round's traffic flows;
                    # the round and the resize must not perturb each other
                    import threading

                    grow_info = {}

                    def do_grow(info=grow_info):
                        t0 = time.monotonic()
                        try:
                            info["to_shards"] = router.grow(timeout=60.0) + 1
                            info["grow_s"] = round(time.monotonic() - t0, 3)
                        except Exception as e:  # surfaced after the round
                            info["error"] = f"{type(e).__name__}: {e}"

                    grow_thread = threading.Thread(target=do_grow, daemon=True)
                    grow_thread.start()
                rounds.append(run_round(
                    ix, stack, args.round_size, args.rate, submit_services,
                    kill_router=router if kill else None,
                    trace_ctx=trace_ctx,
                    workload=args.workload,
                ))
                if grow_thread is not None:
                    grow_thread.join(timeout=90.0)
                    if grow_thread.is_alive():
                        raise AssertionError(f"round {ix}: shard grow stuck")
                    if "error" in grow_info:
                        raise AssertionError(
                            f"round {ix}: shard grow failed: "
                            f"{grow_info['error']}"
                        )
                    if router.hint_depth() > 0:
                        raise AssertionError(
                            f"round {ix}: post-grow handoff queue at "
                            f"{router.hint_depth()}"
                        )
                    grows_done += 1
                    rounds[-1]["grow"] = grow_info
                if kill:
                    # healed: the repair thread must replay every hint
                    # before the next round murders a different shard;
                    # polls back off full-jitter toward a 2s cap,
                    # resetting while the queue is visibly draining
                    t0 = time.monotonic()
                    backoff = Backoff(base=0.05, cap=2.0)
                    last_depth = router.hint_depth()
                    while router.hint_depth() > 0:
                        if time.monotonic() - t0 > 30.0:
                            raise AssertionError(
                                f"round {ix}: handoff queue stuck at "
                                f"{router.hint_depth()}"
                            )
                        depth = router.hint_depth()
                        if depth < last_depth:
                            backoff.reset()
                        last_depth = depth
                        backoff.sleep()
                    rounds[-1]["handoff_drain_s"] = round(
                        time.monotonic() - t0, 3
                    )
                tag = (
                    f", shard {rounds[-1]['killed_shard']} killed+repaired"
                    if kill else ""
                )
                if rounds[-1].get("grow"):
                    tag += (f", grew to {rounds[-1]['grow']['to_shards']} "
                            f"shards in {rounds[-1]['grow']['grow_s']}s")
                if rounds[-1].get("churned") is not None:
                    tag += f", {rounds[-1]['churned']} churned"
                print(f"[soak] round {ix}: {rounds[-1]['round_s']}s, "
                      f"arrival {rounds[-1]['rate_achieved']}/s, exact{tag}",
                      file=sys.stderr)
                ix += 1
            # one extra tick so work since the last interval boundary is
            # banked, then prove the live route serves the window
            sampler.sample_once()
            history = http.get_metrics_history()
            healthz = http.get_healthz()
            ready, readyz = http.get_readyz()
            samples = sampler.history()
        finally:
            timeseries.release()

        record["rounds"] = rounds
        # summary over the FULL window; the banked series itself is
        # bounded at SDA_SOAK_MAX_SAMPLES (newest kept, rest thinned at
        # a uniform stride) so long soaks don't bank megabytes
        max_samples = int(os.environ.get("SDA_SOAK_MAX_SAMPLES", "2000"))
        record["summary"] = summarize(samples)
        record["samples_total"] = len(samples)
        record["samples"] = downsample(samples, max_samples)
        record["fault_counters"] = fault_counters()
        record["admission"] = admission_counters()
        record["history_route"] = {
            "running": history.get("running"),
            "samples_served": len(history.get("samples", [])),
        }
        record["healthz"] = healthz
        record["readyz"] = {"ready": ready, **readyz}
        record["spans"] = telemetry.spans()

    if router is not None:
        router.stop_repair()

    exact = sum(1 for r in record["rounds"] if r["exact"])
    record["exact_rounds"] = exact
    record["total_rounds"] = len(record["rounds"])
    record["killed_rounds"] = sum(
        1 for r in record["rounds"] if r.get("killed_shard") is not None
    )

    record["grows_done"] = grows_done
    record["final_shards"] = router.shards if router is not None else 1

    artdir = pathlib.Path(args.artifacts)
    artdir.mkdir(parents=True, exist_ok=True)
    # the kill-shard and grow-shard axes bank their own artifact families
    # (replica-soak-* / grow-soak-*) so bench_compare's plain soak-*
    # rider stays an apples-to-apples set
    family = ("grow-soak" if args.grow_shards > 0
              else "replica-soak" if args.kill_shard > 0 else "soak")
    path = artdir / f"{family}-{time.strftime('%Y%m%d-%H%M%S')}.json"
    path.write_text(json.dumps(record, indent=1, default=repr))

    s = record["summary"]
    print(f"[soak] {len(record['rounds'])} rounds ({exact} exact), "
          f"{len(record['samples'])}/{record['samples_total']} samples banked, "
          f"rps mean {s['rps_mean']} max {s['rps_max']}, "
          f"sheds {record['admission']['sda_rest_shed_total']}, "
          f"rss {s['rss_mib']['start']} -> {s['rss_mib']['end']} MiB "
          f"(peak {s['rss_mib']['peak']})", file=sys.stderr)
    print(path)

    ok = (
        record["total_rounds"] >= 1
        and exact == record["total_rounds"]
        and len(record["samples"]) >= 1
        and record["history_route"]["samples_served"] >= 1
        and record["healthz"].get("status") == "ok"
        and record["readyz"]["ready"]
        and (record["sampler_ab"] is None or record["sampler_ab"]["ok"])
        and (args.kill_shard == 0 or record["killed_rounds"] >= 1)
        and (args.grow_shards == 0 or record["grows_done"] >= 1)
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
