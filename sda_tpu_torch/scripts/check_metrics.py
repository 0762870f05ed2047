"""CI gate: scrape /v1/metrics from a live REST stack and fail loudly if
the exposition stops parsing or the core series disappear (counterpart of
``scripts/check_metrics.py``).

    python -m sda_tpu_torch.scripts.check_metrics [--device cpu]

Spins up the port's asyncio keep-alive REST server on a loopback port
(same process, so the process-global registry is the one the server
samples), drives a small genuine workload through every instrumented
layer (HTTP requests, store writes, sealed participations, paged clerking
and reveal, two tiered rounds, a sketch round, an arrival-pipelined
cohort, a faulted rerun and one ``TorchAggregator.secure_sum`` for the
engine series), then fetches the exposition over HTTP like a Prometheus
scraper would and checks:

1. every line obeys the text-format 0.0.4 line grammar;
2. every series of ``REQUIRED_SERIES`` has samples, the tier promotion
   counter carries both ``path`` labels and the tier-close histogram both
   ``mode`` labels, and the workload's trace id reached the store spans;
3. ``/v1/metrics/history`` holds a sample and ``/v1/healthz`` answers ok;
4. the merged cross-process series assembles: a second real ``sdad``
   (``python -m sda_tpu_torch.cli.sdad --mem httpd``) is spawned and both
   processes' ``/v1/metrics/history`` bodies must merge
   (``merge_histories``) into a bucket with ``procs >= 2``.

Every client computes on ``--device`` (CUDA by default; without a GPU the
script exits 2). Exit 0 on pass, 1 with a diagnostic on fail.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.request

from ..riders._common import start_sdad
from . import device_or_exit

# text-format 0.0.4 line grammar; label values are quoted strings with
# backslash escaping, so braces INSIDE a value (route templates like
# "/v1/agents/{id}") are legal
_LINE = re.compile(
    r"^(?:"
    r"# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .*"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(?:\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
    r" (?:[+-]?[0-9.eE+-]+|\+Inf|NaN)"
    r")$"
)

REQUIRED_SERIES = [
    "sda_http_requests_total",
    "sda_store_op_seconds",
    "sda_crypto_seals_total",
    "sda_engine_step_seconds",
    # clerking pipeline: stage histograms + the overlap gauge, lit by the
    # paged-job round drive_workload runs (threshold 0 pages every job)
    "sda_clerk_stage_seconds",
    "sda_clerk_overlap_efficiency",
    # reveal pipeline: stage histograms + the overlap gauge, lit by the
    # paged reveal drive_workload finishes the round with (threshold 0
    # pages every snapshot result)
    "sda_reveal_stage_seconds",
    "sda_reveal_overlap_efficiency",
    # crypto worker pool: drive_workload runs its round at SDA_WORKERS=2,
    # so the pooled dispatch path emits all three series
    "sda_pool_workers",
    "sda_pool_task_seconds",
    "sda_pool_utilization",
    # churn plane: drive_faulted_leg reruns a round under SDA_FAULTS, so
    # the injected failures and the client's recoveries must both show
    "sda_fault_injections_total",
    "sda_rest_retries_total",
    # binary wire plane: the workload's batch POST and chunk GETs ride
    # application/x-sda-binary by default, so per-route timing and payload
    # volume must both show with their wire labels
    "sda_rest_route_seconds",
    "sda_wire_bytes_total",
    # observability plane: the time-series sampler rides serve_background
    # (SDA_TS defaults on) and must have banked at least one window by
    # scrape time: main() shrinks the interval and waits for the tick
    "sda_ts_samples_total",
    # hierarchical plane: drive_tier_round runs one 2-tier round per
    # promotion path (additive -> reveal, Shamir -> share-promotion), so
    # the promotion counter (both path labels, asserted separately in
    # main), the depth gauge, the clerk-side re-share histogram, and the
    # driver-side promotion histogram must all show
    "sda_tier_promotions_total",
    "sda_tier_depth",
    "sda_tier_reshare_seconds",
    "sda_tier_promote_seconds",
    # tier-close dispatch: the reveal leg pins SDA_TIER_FANOUT=1 (serial
    # mode label) and the reshare leg pins =2 (fanout mode label), so the
    # per-level wall histogram shows with BOTH dispatch modes (asserted
    # per label in main) plus the effective-width gauge
    "sda_tier_close_seconds",
    "sda_tier_fanout_nodes",
    # workload plane: drive_sketch_round completes one count-min round
    # through SketchQuery, which ticks the per-family round counter
    "sda_workload_rounds_total",
    # arrival-pipelined ingest: drive_ingest_pipeline runs one traced
    # cohort through client/ingest.py over live REST, so all three
    # pipeline series must show: per-stage latency (plan/build/upload),
    # per-row release lag, and the built-but-unreleased backlog gauge
    "sda_ingest_stage_seconds",
    "sda_arrival_lag_seconds",
    "sda_ingest_backlog",
]


def _client_factory(base_url: str, tmp: str, device):
    """``new_client(subdir)``: a fresh identity under ``tmp/subdir`` on its
    own ``SdaHttpClient`` and token store, computing on ``device``."""
    from ..client import SdaClient
    from ..crypto import Keystore
    from ..rest import SdaHttpClient, TokenStore

    def new_client(subdir):
        keystore = Keystore(os.path.join(tmp, subdir))
        service = SdaHttpClient(base_url, TokenStore(os.path.join(tmp, subdir)))
        return SdaClient(SdaClient.new_agent(keystore), keystore, service, device=device)

    return new_client


_PAGED_ENV = {
    "SDA_JOB_PAGE_THRESHOLD": "0",
    "SDA_JOB_CHUNK_SIZE": "2",
    "SDA_RESULT_PAGE_THRESHOLD": "0",
    "SDA_RESULT_CHUNK_SIZE": "2",
    # a 2-worker round so the crypto pool's pooled dispatch path (and its
    # sda_pool_* series) is exercised by the scrape
    "SDA_WORKERS": "2",
}


def drive_workload(base_url: str, tmp: str, device) -> None:
    """A few real requests through client -> REST -> service -> store,
    with enough crypto (participation sealing) to light the native series."""
    from ..protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        FullMasking,
        SodiumEncryptionScheme,
    )

    new_client = _client_factory(base_url, tmp, device)
    recipient = new_client("recipient")
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)

    agg = Aggregation(
        id=AggregationId.random(),
        title="check-metrics",
        vector_dimension=4,
        modulus=433,
        recipient=recipient.agent.id,
        recipient_key=rkey,
        # Full masking so the reveal's mask decrypt + fold stages light
        masking_scheme=FullMasking(modulus=433),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme(),
    )
    recipient.upload_aggregation(agg)

    clerks = [new_client(f"clerk{i}") for i in range(3)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())
    # pin the committee to this round's clerks: the faulted leg reuses the
    # server, so the candidate pool also holds earlier rounds' agents who
    # would never run chores here and the snapshot would never turn ready
    recipient.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in clerks])

    participant = new_client("participant")
    participant.upload_agent()
    participant.participate([1, 2, 3, 4], agg.id)  # seals -> crypto series

    # run the round to completion through the PAGED delivery paths so
    # both pipelines' series (clerk download/decrypt/combine + reveal
    # download/decrypt/fold/reconstruct histograms, and both
    # overlap-efficiency gauges) appear in the scrape
    os.environ.update(_PAGED_ENV)
    try:
        recipient.end_aggregation(agg.id)
        for clerk in clerks:
            clerk.run_chores(-1)
        recipient.run_chores(-1)  # recipient may hold a committee seat too
        out = recipient.reveal_aggregation(agg.id).positive()
        assert list(out.values) == [1, 2, 3, 4], "workload reveal disagrees"
    finally:
        for key in _PAGED_ENV:
            os.environ.pop(key, None)


def drive_tier_round(base_url: str, tmp: str, device) -> None:
    """Two 2-tier hierarchical rounds (fan-out 2) over the live REST
    stack, one per promotion path, so the whole tier plane shows in the
    scrape: sda_tier_promotions_total with BOTH path labels (additive
    committees promote by reveal, Shamir committees by share-promotion),
    sda_tier_depth, the clerk-side sda_tier_reshare_seconds histogram and
    the driver-side sda_tier_promote_seconds histogram."""
    from ..client import run_tier_round, setup_tier_round
    from ..protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        BasicShamirSharing,
        ChaChaMasking,
        SodiumEncryptionScheme,
    )

    new_client = _client_factory(base_url, tmp, device)

    def run_leg(leg: str, sharing, expect_children_ready: bool, fanout_width: str) -> None:
        # pin the dispatch width so the scrape carries BOTH mode labels
        # of sda_tier_close_seconds: "1" takes the serial loop, "2" fans
        # the two sibling nodes out
        saved_fanout = os.environ.get("SDA_TIER_FANOUT")
        os.environ["SDA_TIER_FANOUT"] = fanout_width
        try:
            _run_leg(leg, sharing, expect_children_ready)
        finally:
            if saved_fanout is None:
                os.environ.pop("SDA_TIER_FANOUT", None)
            else:
                os.environ["SDA_TIER_FANOUT"] = saved_fanout

    def _run_leg(leg: str, sharing, expect_children_ready: bool) -> None:
        recipient = new_client(f"tier-{leg}-recipient")
        rkey = recipient.new_encryption_key()
        recipient.upload_agent()
        recipient.upload_encryption_key(rkey)
        agg = Aggregation(
            id=AggregationId.random(),
            title=f"check-metrics-tiered-{leg}",
            vector_dimension=4,
            modulus=433,
            recipient=recipient.agent.id,
            recipient_key=rkey,
            masking_scheme=ChaChaMasking(modulus=433, dimension=4, seed_bitsize=128),
            committee_sharing_scheme=sharing,
            recipient_encryption_scheme=SodiumEncryptionScheme(),
            committee_encryption_scheme=SodiumEncryptionScheme(),
            sub_cohort_size=2,
            tiers=2,
        )
        pool = [new_client(f"tier-{leg}-clerk{i}") for i in range(2)]
        for clerk in pool:
            clerk.upload_agent()
            clerk.upload_encryption_key(clerk.new_encryption_key())
        tround = setup_tier_round(
            recipient, agg, lambda name: new_client(f"tier-{leg}-{name}"), pool
        )
        values = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
        for i, v in enumerate(values):
            p = new_client(f"tier-{leg}-part{i}")
            p.upload_agent()
            p.participate(v, agg.id)
        out = run_tier_round(tround).output.positive()
        assert list(out.values) == [15, 18, 21, 24], f"tiered workload reveal disagrees ({leg})"
        status = recipient.service.get_tier_status(recipient.agent, agg.id)
        assert status is not None, "tier status route missing"
        root = next(n for n in status.nodes if n.tier == 0)
        assert root.result_ready, f"root not ready after the {leg} round"
        children_ready = all(n.result_ready for n in status.nodes)
        assert children_ready == expect_children_ready, \
            f"unexpected child readiness under {leg} promotion"

    # additive committees promote by reveal: every node clerks to a
    # result, so the whole tree reports ready
    run_leg("reveal", AdditiveSharing(share_count=2, modulus=433), True, "1")
    # Shamir committees share-promote: children never seal clerking
    # results (their columns climb as tagged participations), only the
    # root turns ready
    run_leg(
        "reshare",
        BasicShamirSharing(share_count=2, privacy_threshold=1, prime_modulus=433),
        False,
        "2",
    )


def drive_sketch_round(base_url: str, tmp: str, device) -> None:
    """One count-min round through the sketch-plane driver (SketchQuery
    riding FederatedAveraging at frac_bits=0) over the live REST stack, so
    ``sda_workload_rounds_total{workload="countmin"}`` appears in the
    scrape. Runs FIRST on the fresh server: SketchQuery elects its
    committee from the candidate pool, so earlier legs' clerks (who never
    run chores here) must not be candidates yet."""
    import numpy as np

    from ..protocol import AdditiveSharing
    from ..sketches import CountMinSketch, SketchQuery

    new_client = _client_factory(base_url, tmp, device)
    recipient = new_client("sk-recipient")
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    clerks = [new_client(f"sk-clerk{i}") for i in range(3)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())

    cm = CountMinSketch(width=16, depth=2, seed=3)
    query = SketchQuery(cm, n_participants=3, max_values_per_participant=8, device=device)
    agg = query.open_round(
        recipient, rkey,
        AdditiveSharing(share_count=3, modulus=query.spec.modulus),
        title="check-metrics-sketch",
    )
    datasets = [["a", "b"], ["a", "c"], ["a", "b", "c"]]
    for i, values in enumerate(datasets):
        phone = new_client(f"sk-phone{i}")
        phone.upload_agent()
        query.submit(phone, agg, values)
    query.close_round(recipient, agg)
    for w in [recipient] + clerks:  # the recipient may hold a seat too
        w.run_chores(-1)
    summed = query.finish(recipient, agg, len(datasets)).cpu().numpy()
    expected = sum(query.local_sketch(d) for d in datasets)
    assert summed.tobytes() == np.asarray(expected).tobytes(), "sketch workload sum disagrees"


def drive_ingest_pipeline(base_url: str, tmp: str, device) -> None:
    """One arrival-pipelined cohort over the live REST stack
    (client/ingest.py): a deterministic trace with churn paces a 12-phone
    cohort through plan/build/upload, so the scrape must carry
    sda_ingest_stage_seconds{stage=plan|build|upload},
    sda_arrival_lag_seconds and the sda_ingest_backlog gauge, and the
    reveal over the pipelined rows must stay exact."""
    from ..client import ingest_cohort
    from ..protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        ChaChaMasking,
        SodiumEncryptionScheme,
    )
    from ..utils.arrivals import ArrivalTrace

    new_client = _client_factory(base_url, tmp, device)
    recipient = new_client("ip-recipient")
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    agg = Aggregation(
        id=AggregationId.random(),
        title="check-metrics-ingest-pipeline",
        vector_dimension=4,
        modulus=433,
        recipient=recipient.agent.id,
        recipient_key=rkey,
        masking_scheme=ChaChaMasking(modulus=433, dimension=4, seed_bitsize=128),
        committee_sharing_scheme=AdditiveSharing(share_count=2, modulus=433),
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme(),
    )
    recipient.upload_aggregation(agg)
    clerks = [new_client(f"ip-clerk{i}") for i in range(2)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())
    recipient.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in clerks])

    phones = [new_client(f"ip-phone{i}") for i in range(2)]
    for p in phones:
        p.upload_agent()
    values = [[i % 7, i % 5, 1, i % 3] for i in range(12)]
    trace = ArrivalTrace.from_text("base=400,churn=0.3:11")
    cursor = {"index": 0, "t": 0.0, "t0": time.perf_counter()}
    report = ingest_cohort(phones, values, agg.id, trace=trace, cursor=cursor, window=4)
    assert report.rows == 12, "pipelined ingest lost rows"
    recipient.end_aggregation(agg.id)
    for clerk in clerks:
        clerk.run_chores(-1)
    recipient.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id).positive()
    expected = [sum(v[d] for v in values) % 433 for d in range(4)]
    assert list(out.values) == expected, "pipelined ingest reveal disagrees"


#: the churn plane's mix: ~15% transient failures against an 8-retry
#: budget make an overall failure astronomically unlikely (p ~ 0.15^9 per
#: request) and at least one injection near-certain over a full round
FAULTED_ENV = {
    "SDA_FAULTS": "drop=0.05,e503=0.05@0.01,truncate=0.05:17",
    "SDA_REST_RETRIES": "8",
    "SDA_REST_BACKOFF_CAP_S": "0.1",
}


def drive_faulted_leg(base_url: str, tmp: str, device) -> None:
    """Rerun the round workload under fault injection so the scrape must
    contain the churn plane's series: sda_fault_injections_total (the
    plane fired) and sda_rest_retries_total (the client recovered)."""
    saved = {k: os.environ.get(k) for k in FAULTED_ENV}
    os.environ.update(FAULTED_ENV)
    try:
        drive_workload(base_url, os.path.join(tmp, "faulted"), device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def drive_engine(device) -> None:
    """One tiny secure_sum on ``device`` so the engine series show up in
    the scrape. The additive plan has no limb path, so no kernel runs."""
    import torch

    from ..parallel.engine import TorchAggregator
    from ..protocol import AdditiveSharing

    engine = TorchAggregator(AdditiveSharing(share_count=3, modulus=433), dim=8, device=device)
    secrets = torch.ones((4, 8), dtype=torch.int32, device=engine.device)
    generator = torch.Generator(device=engine.device).manual_seed(0)
    out = engine.secure_sum(secrets, generator)
    assert int(out[0]) == 4, "engine smoke sum disagrees"


def check_exposition(text: str) -> list:
    errors = []
    if not text.endswith("\n"):
        errors.append("exposition must end with a newline")
    sampled = set()
    for lineno, line in enumerate(text.rstrip("\n").split("\n"), 1):
        if not _LINE.match(line):
            errors.append(f"line {lineno} violates the text format: {line!r}")
            continue
        if not line.startswith("#"):
            name = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line).group(0)
            sampled.add(re.sub(r"_(?:bucket|sum|count)$", "", name))
            sampled.add(name)
    for series in REQUIRED_SERIES:
        if series not in sampled:
            errors.append(f"required series missing from the scrape: {series}")
    return errors


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read().decode("utf-8"))


def check_observability_routes(base_url: str) -> list:
    """Scrape the observability plane the way a dashboard would: the
    sampler window over /v1/metrics/history must hold >= 1 banked sample
    and /v1/healthz must answer ok, both live, over HTTP."""
    errors = []
    try:
        deadline = time.monotonic() + 10.0
        while True:
            hist = _get_json(f"{base_url}/v1/metrics/history")
            if hist.get("samples") or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        if not hist.get("running"):
            errors.append("/v1/metrics/history: sampler not running "
                          "(serve_background should autostart it)")
        if not hist.get("samples"):
            errors.append("/v1/metrics/history: no samples banked within 10s")
        else:
            missing = {"t", "dt_s", "rss_mib", "routes"} - set(hist["samples"][-1])
            if missing:
                errors.append(f"/v1/metrics/history: sample missing {missing}")
    except Exception as e:
        errors.append(f"/v1/metrics/history scrape failed: {e}")
    try:
        health = _get_json(f"{base_url}/v1/healthz")
        if health.get("status") != "ok":
            errors.append(f"/v1/healthz answered {health!r}")
    except Exception as e:
        errors.append(f"/v1/healthz scrape failed: {e}")
    return errors


def check_merged_history(base_url: str) -> list:
    """The flagship plane assembles its fleet view by merging per-process
    ``/v1/metrics/history`` bodies (``telemetry.timeseries.merge_histories``).
    Gate the merge over two REAL processes, this process's live sampler
    plus a separate ``sdad httpd``, both scraped over HTTP: the merged
    series must contain a bucket both contributed to."""
    from ..telemetry.timeseries import merge_histories

    errors = []
    env = dict(os.environ, SDA_TS_INTERVAL_S="0.2", SDA_TELEMETRY="1")
    try:
        proc, peer = start_sdad(["--mem"], env=env)
    except RuntimeError as e:
        return [f"peer sdad never came up: {e}"]
    try:
        deadline = time.monotonic() + 15.0
        peak = 0
        while time.monotonic() < deadline:
            # keep both samplers fed so their windows are non-empty
            urllib.request.urlopen(f"{peer}/v1/healthz", timeout=30).read()
            urllib.request.urlopen(f"{base_url}/v1/healthz", timeout=30).read()
            merged = merge_histories([_get_json(f"{base_url}/v1/metrics/history"),
                                      _get_json(f"{peer}/v1/metrics/history")])
            peak = max([peak] + [s.get("procs", 0) for s in merged])
            if peak >= 2:
                break
            time.sleep(0.2)
        if peak < 2:
            errors.append(
                "merged /v1/metrics/history series never saw both "
                f"processes within 15s (peak procs {peak})"
            )
    except Exception as e:
        errors.append(f"merged cross-process history check failed: {e}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return errors


def label_errors(body: str) -> list:
    """Both promotion paths and both tier-close modes must carry samples."""
    errors = []
    for path in ("reveal", "reshare"):
        if not re.search(rf'^sda_tier_promotions_total\{{[^}}]*path="{path}"', body, re.M):
            errors.append(
                f'sda_tier_promotions_total missing the path="{path}" label '
                "(one tiered round per promotion path must be driven)"
            )
    for mode in ("serial", "fanout"):
        if not re.search(rf'^sda_tier_close_seconds_count\{{[^}}]*mode="{mode}"', body, re.M):
            errors.append(
                f'sda_tier_close_seconds missing the mode="{mode}" label '
                "(the tier legs must pin SDA_TIER_FANOUT to 1 and 2)"
            )
    return errors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sda_tpu_torch.scripts.check_metrics",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="the clients' and the engine's torch device (default cuda; "
                             "exits 2 without a GPU)")
    args = parser.parse_args(argv)
    device = device_or_exit("check_metrics", args.device)
    # a sub-second sampler interval so at least one time-series window is
    # banked (and sda_ts_samples_total sampled) before the scrape
    os.environ.setdefault("SDA_TS_INTERVAL_S", "0.2")
    from .. import telemetry
    from ..rest import serve_background
    from ..server import new_mem_server

    if not telemetry.enabled():
        print("check_metrics: SDA_TELEMETRY=0 in this environment", file=sys.stderr)
        return 1

    server = new_mem_server()
    with serve_background(server) as base_url, tempfile.TemporaryDirectory() as tmp:
        drive_sketch_round(base_url, tmp, device)  # first: elects from candidates
        with telemetry.trace("ci-check-metrics"):
            drive_workload(base_url, tmp, device)
        drive_tier_round(base_url, tmp, device)
        drive_ingest_pipeline(base_url, tmp, device)
        drive_faulted_leg(base_url, tmp, device)
        drive_engine(device)
        observability_errors = check_observability_routes(base_url)
        observability_errors += check_merged_history(base_url)
        with urllib.request.urlopen(f"{base_url}/v1/metrics", timeout=30) as resp:
            content_type = resp.headers.get("Content-Type", "")
            body = resp.read().decode("utf-8")

    errors = check_exposition(body) + observability_errors
    if not content_type.startswith("text/plain"):
        errors.append(f"unexpected Content-Type: {content_type!r}")
    if not telemetry.spans(name="store.", trace_id="ci-check-metrics"):
        errors.append("trace id did not propagate into store spans")
    errors += label_errors(body)

    if errors:
        print("check_metrics FAILED:", file=sys.stderr)
        for err in errors:
            print(f"  - {err}", file=sys.stderr)
        return 1

    lines = body.count("\n")
    print(f"check_metrics OK: {lines} exposition lines, "
          f"all of {', '.join(REQUIRED_SERIES)} present")
    return 0


if __name__ == "__main__":
    sys.exit(main())
