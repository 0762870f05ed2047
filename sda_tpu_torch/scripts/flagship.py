"""Flagship campaign: tiers x shards x replicas as one elastic topology
(counterpart of ``scripts/flagship.py``).

A tiered aggregation
(T tiers, fan-out m) driven over a REAL distributed deployment — N
separate ``sdad httpd`` OS processes (``python -m sda_tpu_torch.cli.sdad``)
fronting one sharded (K) +
replicated (R) store plane — with every sub-committee clerking as its
own ``sdad committee`` daemon process, coordinating purely over the
REST wire. No in-process shortcuts anywhere on the data path: the
driver only provisions, paces participants, and polls.

Placement is coordinator-free: ``protocol.tiers.tier_placement`` stamps
every tier node with a deterministic frontend index (pure function of
the node's aggregation id and the frontend count), the multi-root
client routes each node's traffic to the same index, and this script
asserts the two agree for every node of every rung.

The campaign models a million-phone population compressed onto one
host: participants arrive on a deterministic trace
(:mod:`sda_tpu_torch.utils.arrivals` — diurnal ramp, bursts, churned
stragglers), and the cohort DOUBLES each rung until a rung misses the
deadline or the wall budget runs out. The headline is
``certified_max_cohort``: the largest real cohort whose tiered round
over the full topology revealed byte-identically to a flat
single-process baseline over the same values, within the rung
deadline. The artifact is honest about scale: ``multi_core_host:
false`` (everything shares one host's cores) and the 1M figure is the
``simulated_population`` the trace models, not the certified cohort.

Per-frontend ``/v1/metrics/history`` windows are scraped at the end and
folded into one fleet series (``telemetry.timeseries.merge_histories``)
so the longitudinal evidence spans all N processes.

Banks ``flagship-<stamp>.json`` (``scripts/bench_compare.py`` gates the
family; ``scripts/sweep_report.py`` renders the ladder). Every client and
committee daemon computes on ``--device`` (CUDA by default; without a GPU
the script exits 2).

Usage:
  python -m sda_tpu_torch.scripts.flagship            # the full local flagship
  python -m sda_tpu_torch.scripts.flagship --smoke    # ~30s CI shape (2x2, tiny ladder)
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from ..riders._common import spawn_sdad, start_sdad
from . import REPO, device_or_exit
from .load_soak import (  # noqa: F401 - WORKLOAD_SKETCH_SHAPE is one of flagship's names
    WORKLOAD_SKETCH_SHAPE,
    workload_items,
    workload_sketch,
)
from .scenarios import persistent_client

DIM = 4
MODULUS = 100003


# -- process plane -----------------------------------------------------------


def spawn_frontend(tmp: pathlib.Path, ix: int, store_root: pathlib.Path,
                   shards: int, replicas: int) -> tuple:
    """One ``sdad httpd`` OS process over the SHARED file-store root on a
    kernel-picked port; returns (proc, base_url). All N frontends build
    the same pure ring over the same partition layout, so any of them
    can serve any key — the client's placement just decides which one
    usually does."""
    return start_sdad(["--file", store_root, "--shards", shards, "--replicas", replicas],
                      errlog=tmp / f"frontend-{ix}.stderr")


def spawn_committee(tmp: pathlib.Path, tag: str, identity_dirs: list,
                    roots: list, device) -> subprocess.Popen:
    """One sub-committee as its own ``sdad committee`` daemon process:
    it loads the clerk identities from disk and polls every frontend
    root (repeatable ``-s``, ring-routed exactly like the driver's
    multi-root client); its clerks compute on ``device``."""
    args = ["committee", "-p", "0.2", "--device", device]
    for u in roots:
        args += ["-s", u]
    for d in identity_dirs:
        args += ["-i", d]
    return spawn_sdad(args, errlog=tmp / f"committee-{tag}.stderr", stdout=subprocess.DEVNULL)


def multi_root_client(tmp: pathlib.Path, name: str, roots: list, device):
    """Disk-persistent identity over the multi-root REST client — the
    same layout the committee daemons load."""
    from ..rest import SdaHttpClient, TokenStore

    identity = tmp / f"id-{name}"
    service = SdaHttpClient(roots, TokenStore(str(identity)))
    return persistent_client(identity, service, device)


def stop(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


# -- rounds ------------------------------------------------------------------


def rung_values(rung: int, cohort: int, workload: str = "dense") -> list:
    if workload == "sketch":
        cm = workload_sketch()
        return [[int(c) for c in cm.encode(workload_items(rung, i))]
                for i in range(cohort)]
    return [[(rung + i) % 11, i % 7, 1, (3 * i) % 5] for i in range(cohort)]


def flat_baseline(values: list, device) -> bytes:
    """The flat single-process control: the same values through the
    plain pipeline on an in-process mem server, every client on
    ``device``; returns the revealed vector's bytes — the byte-identity
    target for the distributed tiered reveal."""
    from ..client import SdaClient, run_committee
    from ..crypto import Keystore
    from ..protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        ChaChaMasking,
        SodiumEncryptionScheme,
    )
    from ..server import new_mem_server

    service = new_mem_server()
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)

        def new_client(name):
            ks = Keystore(str(tmp / name))
            return SdaClient(SdaClient.new_agent(ks), ks, service, device=device)

        recipient = new_client("r")
        recipient.upload_agent()
        rkey = recipient.new_encryption_key()
        recipient.upload_encryption_key(rkey)
        clerks = [new_client(f"c{i}") for i in range(2)]
        for c in clerks:
            c.upload_agent()
            c.upload_encryption_key(c.new_encryption_key())
        agg = Aggregation(
            id=AggregationId.random(),
            title="flagship-flat-baseline",
            vector_dimension=DIM,
            modulus=MODULUS,
            recipient=recipient.agent.id,
            recipient_key=rkey,
            masking_scheme=ChaChaMasking(
                modulus=MODULUS, dimension=DIM, seed_bitsize=128
            ),
            committee_sharing_scheme=AdditiveSharing(
                share_count=2, modulus=MODULUS
            ),
            recipient_encryption_scheme=SodiumEncryptionScheme(),
            committee_encryption_scheme=SodiumEncryptionScheme(),
        )
        recipient.upload_aggregation(agg)
        recipient.begin_aggregation(
            agg.id, chosen_clerks=[c.agent.id for c in clerks]
        )
        participant = new_client("p")
        participant.upload_agent()
        participant.upload_participations(
            participant.new_participations(values, agg.id)
        )
        recipient.end_aggregation(agg.id)
        run_committee(clerks, -1)
        return recipient.reveal_aggregation(agg.id).positive().values.tobytes()


class _FlatBaseline:
    """The flat control off the rung critical path.

    ``flat_baseline`` is pure verification overhead — fully independent
    of the distributed rung (own in-process mem server, own keystore
    tempdir) — so it runs on a background thread overlapping arrivals
    and the tiered round, and ``result()`` joins at rung end for the
    byte-identity assert. The worker rebinds the rung's trace id and
    records the usual ``rung.baseline`` span (tagged ``overlapped``),
    so the waterfall still shows where the control ran — just no longer
    holding the wall clock. Bytes are memoized per
    ``(rung, cohort, workload)`` in ``ctx["baseline_memo"]`` so A/B legs
    repeating a rung at the same cohort stop paying the control twice
    (rung values are a pure function of that key). The control's clients
    compute on ``ctx["device"]``."""

    def __init__(self, rung: int, cohort: int, ctx: dict, values: list):
        from .. import telemetry

        self._memo = ctx.setdefault("baseline_memo", {})
        self._key = (rung, cohort, ctx["workload"])
        self._thread = None
        self._error = None
        self._bytes = self._memo.get(self._key)
        if self._bytes is not None:
            # memo hit: a zero-work marker span keeps the stage visible
            with telemetry.span("rung.baseline", rung=rung, cohort=cohort,
                                memo=True):
                pass
            return
        trace_id = telemetry.current_trace_id()

        def work():
            if trace_id:
                telemetry.set_trace_id(trace_id)
            try:
                with telemetry.span("rung.baseline", rung=rung,
                                    cohort=cohort, overlapped=True):
                    self._bytes = flat_baseline(values, ctx["device"])
            except BaseException as exc:  # noqa: BLE001 — rethrown at join
                self._error = exc

        self._thread = threading.Thread(
            target=work, name="flagship-baseline", daemon=True
        )
        self._thread.start()

    def result(self) -> bytes:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise self._error
        self._memo[self._key] = self._bytes
        return self._bytes


def tiered_aggregation(recipient, rkey, tiers: int, m: int, tag: str):
    from ..protocol import (
        Aggregation,
        AggregationId,
        BasicShamirSharing,
        ChaChaMasking,
        SodiumEncryptionScheme,
    )

    # Shamir committees so the tier tree promotes over the default
    # share-promotion path (clerks re-share upward; no per-node reveal
    # round-trip) — the certification now covers the production path.
    return Aggregation(
        id=AggregationId.random(),
        title=f"flagship-{tag}",
        vector_dimension=DIM,
        modulus=MODULUS,
        recipient=recipient.agent.id,
        recipient_key=rkey,
        masking_scheme=ChaChaMasking(
            modulus=MODULUS, dimension=DIM, seed_bitsize=128
        ),
        committee_sharing_scheme=BasicShamirSharing(
            share_count=2, privacy_threshold=1, prime_modulus=MODULUS
        ),
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme(),
        sub_cohort_size=m,
        tiers=tiers,
    )


def run_rung(rung: int, cohort: int, ctx: dict, pipeline=None,
             leg: str = None) -> dict:
    """One ladder rung: provision a fresh tiered tree over the live
    plane, pace the cohort in on the arrival trace, run the round with
    EXTERNAL committees (the daemons), reveal, and hold the reveal
    byte-identical to the flat baseline over the same values — computed
    concurrently on a background thread (:class:`_FlatBaseline`) and
    joined at rung end.

    ``pipeline`` overrides the campaign's ingest path for this rung
    (the arrivals A/B legs pin one serial and one pipelined rung at the
    same cohort); None inherits ``ctx["pipeline"]``. ``leg`` suffixes
    the trace id so A/B legs sharing a rung number (and therefore the
    memoized baseline) still record distinct traces."""
    from .. import telemetry
    from ..client import ingest_cohort, run_tier_round, setup_tier_round

    t0 = time.perf_counter()
    tmp, roots = ctx["tmp"], ctx["roots"]
    recipient, rkey = ctx["recipient"], ctx["rkey"]
    trace, cursor = ctx["trace"], ctx["cursor"]

    # every driver-side span this rung records carries one trace id, so
    # trace_report can render the rung's stage waterfall from
    # the banked artifact
    trace_id = f"rung{rung}-c{cohort}" + (f"-{leg}" if leg else "")
    telemetry.set_trace_id(trace_id)

    agg = tiered_aggregation(recipient, rkey, ctx["tiers"], ctx["fanout"],
                             f"rung{rung}")

    def new_promoter(name):
        return multi_root_client(tmp, f"rung{rung}-{name}", roots, ctx["device"])

    with telemetry.span("rung.provision", rung=rung, cohort=cohort):
        tround = setup_tier_round(
            recipient, agg, new_promoter, ctx["pool"],
            disjoint_committees=True, frontends=len(roots),
        )
    # placement is honored end to end: every node's stamped frontend is
    # exactly where the multi-root client homes that node's traffic
    for tn in tround.nodes:
        assert tn.frontend == recipient.service.route_index(tn.aggregation.id), (
            f"placement disagrees for node {tn.aggregation.id}"
        )

    values = rung_values(rung, cohort, ctx["workload"])
    # the cohort arrives on the trace: each upload waits for its arrival
    # time; churned phones disconnect and retry at the end of the round
    pipelined = ctx["pipeline"] if pipeline is None else pipeline
    participants = ctx["participants"]
    churned = 0
    with telemetry.span("rung.arrivals", rung=rung, cohort=cohort,
                        pipelined=pipelined):
        # the flat control starts NOW — strictly inside the arrivals
        # span, overlapping arrivals + round on its own thread, so the
        # overlapped rung.baseline span can never start ahead of the
        # stage it hides under (keeps the greedy critical path honest);
        # joined (and byte-compared) after the distributed reveal
        baseline = _FlatBaseline(rung, cohort, ctx, values)
        if pipelined:
            # plan the whole schedule up front, build windows of phones
            # ahead of their arrival times, release per-frontend
            # micro-batches on the bulk route (client/ingest.py)
            report = ingest_cohort(
                participants, values, agg.id, trace=trace, cursor=cursor
            )
            churned = report.churned
        else:
            # legacy serial baseline (SDA_INGEST_PIPELINE=0 / A/B leg):
            # per-phone batch-of-1 build + single POST at arrival time
            deferred = []
            for i, v in enumerate(values):
                k = cursor["index"]
                cursor["index"] = k + 1
                cursor["t"] = trace.next_arrival(k, cursor["t"])
                delay = cursor["t0"] + cursor["t"] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                p = participants[i % len(participants)]
                part = p.new_participations([v], agg.id)[0]
                if trace.is_churned(k):
                    deferred.append((p, part))
                    continue
                p.service.create_participation(p.agent, part)
            # the churn drain reconnects in bulk: one batch POST per
            # participant (= per frontend under tier placement), not one
            # create_participation round-trip per phone
            by_phone: dict = {}
            for p, part in deferred:
                by_phone.setdefault(id(p), (p, []))[1].append(part)
            for p, parts in by_phone.values():
                p.upload_participations(parts)
            churned = len(deferred)

    with telemetry.span("rung.round", rung=rung, cohort=cohort):
        result = run_tier_round(
            tround, external_clerks=True, poll_interval=0.1,
            poll_timeout=ctx["poll_timeout"],
        )
    out = result.output.positive()
    expected = [sum(v[d] for v in values) % MODULUS for d in range(DIM)]
    exact = [int(x) for x in out.values] == expected
    flat = baseline.result()
    flat_match = out.values.tobytes() == flat
    elapsed = time.perf_counter() - t0
    rung_spans = telemetry.spans(trace_id=trace_id)
    telemetry.set_trace_id(None)
    stages: dict = {}
    for s in rung_spans:
        if str(s.get("name", "")).startswith(("rung.", "tier.")):
            stages[s["name"]] = round(
                stages.get(s["name"], 0.0) + s["duration_s"], 4
            )
    r = {
        "rung": rung,
        "cohort": cohort,
        "churned": churned,
        "ingest_pipeline": pipelined,
        "committees": len(tround.nodes),
        "round_s": round(elapsed, 2),
        "exact": exact,
        "flat_byte_match": flat_match,
        "aggregate": [int(x) for x in out.values],
        "skipped": [str(s) for s in result.skipped],
        # driver-side stage totals; tier.* stages are nested inside
        # rung.round, so the rung.* entries partition the wall and the
        # tier.* entries break rung.round down further
        "stages": stages,
        "trace_id": trace_id,
        "placement": {
            str(tn.aggregation.id): tn.frontend for tn in tround.nodes
        },
        "_elapsed": elapsed,
        "_spans": rung_spans,
    }
    if ctx["workload"] == "sketch":
        # the certified grid must also DECODE: count-min never
        # undercounts (guaranteed, so asserted), and the one-sided
        # overshoot vs the analytic bound is recorded per rung
        from collections import Counter

        cm = workload_sketch()
        grid = np.asarray([int(x) for x in out.values], dtype=np.int64)
        true = Counter(
            it for i in range(cohort) for it in workload_items(rung, i)
        )
        hot, hot_true = true.most_common(1)[0]
        est = int(cm.point_query(grid, hot))
        bound = cm.error_bound(grid)
        assert est >= hot_true, f"count-min undercounted {hot}"
        r["sketch"] = {
            "hot_item": hot,
            "true": hot_true,
            "estimate": est,
            "bound": round(bound, 2),
            "within_bound": bool(est <= hot_true + bound),
        }
    return r


# -- merged fleet telemetry --------------------------------------------------


def scrape_fleet(roots: list) -> dict:
    """Every frontend's /v1/metrics/history folded into one series."""
    from ..telemetry.timeseries import merge_histories

    histories = []
    for u in roots:
        try:
            with urllib.request.urlopen(f"{u}/v1/metrics/history", timeout=10) as resp:
                histories.append(json.loads(resp.read().decode("utf-8")))
        except Exception:
            histories.append({"samples": []})
    merged = merge_histories(histories)
    per_proc = [len(h.get("samples", [])) for h in histories]
    return {
        "frontends_scraped": len(roots),
        "samples_per_frontend": per_proc,
        "merged_buckets": len(merged),
        "max_procs_in_bucket": max((b["procs"] for b in merged), default=0),
        "merged": merged,
    }


# -- campaign ----------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sda_tpu_torch.scripts.flagship",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--frontends", type=int, default=3, metavar="N",
                    help="sdad httpd OS processes (default 3)")
    ap.add_argument("--shards", type=int, default=2, metavar="K")
    ap.add_argument("--replicas", type=int, default=2, metavar="R")
    ap.add_argument("--tiers", type=int, default=2, metavar="T")
    ap.add_argument("--fanout", type=int, default=4, metavar="M",
                    help="sub-cohorts per node (default 4)")
    ap.add_argument("--workload", choices=["dense", "sketch"], default="dense",
                    help="rung payload: the dense 4-wide control vectors, "
                         "or each phone's count-min sketch columns "
                         "(dim 128) certified and decoded per rung "
                         "(default dense)")
    ap.add_argument("--trace",
                    default="base=200,diurnal=0.6@20,burst=0.15@4,churn=0.1:16",
                    help="arrival trace spec (sda_tpu_torch.utils.arrivals)")
    ap.add_argument("--cohort-start", type=int, default=8)
    ap.add_argument("--rung-deadline", type=float, default=90.0,
                    help="a rung slower than this fails certification")
    ap.add_argument("--budget-s", type=float, default=240.0,
                    help="wall budget for the whole ladder")
    ap.add_argument("--max-cohort", type=int, default=512)
    ap.add_argument("--simulated-population", type=int, default=1_000_000)
    ap.add_argument("--participant-identities", type=int, default=16,
                    help="distinct registered phone identities the cohort "
                         "cycles through (leaf assignment hashes the "
                         "identity, so this bounds leaf diversity)")
    ap.add_argument("--smoke", action="store_true",
                    help="the ~30s CI shape: 2 frontends, 2 shards, "
                         "ladder capped at 2 rungs")
    ap.add_argument("--artifacts", default=str(REPO / "bench-artifacts"))
    ap.add_argument("--device", default="cuda",
                    help="the clients' and committee daemons' torch device "
                         "(default cuda; exits 2 without a GPU)")
    args = ap.parse_args(argv)
    device = device_or_exit("flagship", args.device)

    if args.smoke:
        args.frontends = 2
        args.shards = 2
        args.tiers = 2
        args.fanout = 4
        args.cohort_start = 4
        args.max_cohort = 8
        args.budget_s = 120.0
        args.trace = "base=300,burst=0.2@3,churn=0.1:16"

    # the frontends sample their own registries; a 1s window makes even
    # the smoke run bank several samples per process
    env_ts = os.environ.setdefault("SDA_TS_INTERVAL_S", "1")
    os.environ.setdefault("SDA_TELEMETRY", "1")
    del env_ts

    from ..client.ingest import pipeline_enabled
    from ..utils.arrivals import ArrivalTrace

    global DIM
    if args.workload == "sketch":
        DIM = workload_sketch().dim  # fat columns on the whole data path

    t_start = time.perf_counter()
    procs: list = []
    record: dict = {
        "kind": "flagship",
        "workload": args.workload,
        "vector_dimension": DIM,
        "topology": {
            "frontend_processes": args.frontends,
            "shards": args.shards,
            "replicas": args.replicas,
            "tiers": args.tiers,
            "fanout": args.fanout,
            "multi_core_host": False,
        },
        "committee_scheme": "basic-shamir x2 (t=1)",
        "tier_path": "reshare",
        "trace": args.trace,
        "simulated_population": args.simulated_population,
        "ingest_pipeline": pipeline_enabled(),
    }
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        store_root = tmp / "store"
        try:
            roots = []
            for ix in range(args.frontends):
                proc, url = spawn_frontend(
                    tmp, ix, store_root, args.shards, args.replicas
                )
                procs.append(proc)
                roots.append(url)
            print(f"[flagship] {len(roots)} frontends up: {' '.join(roots)}",
                  file=sys.stderr)

            recipient = multi_root_client(tmp, "recipient", roots, device)
            recipient.upload_agent()
            rkey = recipient.new_encryption_key()
            recipient.upload_encryption_key(rkey)

            # disjoint committees: every tree node gets its own clerks,
            # and every node's committee runs as its own OS process
            n_nodes = sum(args.fanout**t for t in range(args.tiers))
            share_count = 2
            pool = []
            for i in range(share_count * n_nodes):
                c = multi_root_client(tmp, f"clerk{i}", roots, device)
                c.upload_agent()
                c.upload_encryption_key(c.new_encryption_key())
                pool.append(c)
            for node_ix in range(n_nodes):
                ids = [tmp / f"id-clerk{node_ix * share_count + j}"
                       for j in range(share_count)]
                procs.append(spawn_committee(tmp, f"node{node_ix}", ids, roots, device))
            print(f"[flagship] {n_nodes} committee daemons launched "
                  f"({share_count} clerks each)", file=sys.stderr)

            participants = []
            for i in range(args.participant_identities):
                p = multi_root_client(tmp, f"phone{i}", roots, device)
                p.upload_agent()
                participants.append(p)

            ctx = {
                "tmp": tmp, "roots": roots,
                "recipient": recipient, "rkey": rkey,
                "pool": pool, "participants": participants,
                "tiers": args.tiers, "fanout": args.fanout,
                "workload": args.workload,
                "device": device,
                "pipeline": pipeline_enabled(),
                "trace": ArrivalTrace.from_text(args.trace),
                "cursor": {"index": 0, "t": 0.0, "t0": time.perf_counter()},
                "poll_timeout": max(60.0, args.rung_deadline),
            }

            ladder: list = []
            last_spans: list = []
            certified = 0
            cohort, rung = args.cohort_start, 0
            while cohort <= args.max_cohort:
                if time.perf_counter() - t_start > args.budget_s:
                    print(f"[flagship] wall budget spent before cohort "
                          f"{cohort}; stopping ladder", file=sys.stderr)
                    break
                r = run_rung(rung, cohort, ctx)
                elapsed = r.pop("_elapsed")
                # the deepest rung's span list is the profile worth
                # banking: trace_report renders its waterfall
                last_spans = r.pop("_spans")
                certified_rung = (
                    r["exact"] and r["flat_byte_match"]
                    and not r["skipped"] and elapsed <= args.rung_deadline
                )
                r["certified"] = certified_rung
                ladder.append(r)
                print(f"[flagship] rung {rung}: cohort {cohort} in "
                      f"{r['round_s']}s exact={r['exact']} "
                      f"flat_match={r['flat_byte_match']} "
                      f"certified={certified_rung}", file=sys.stderr)
                if not certified_rung:
                    break
                certified = cohort
                cohort *= 2
                rung += 1

            record["ladder"] = ladder
            # the last (deepest) rung's driver-side span records, in the
            # SpanLog shape trace_report consumes
            record["spans"] = last_spans
            record["certified_max_cohort"] = certified

            # within-run arrivals A/B at the deepest certified cohort:
            # one serial rung, one pipelined rung, back to back on the
            # SAME live plane — their rung.arrivals ratio is the
            # drift-immune speedup bench_compare gates (host load moves
            # both legs together; the ratio regresses only when the
            # pipeline stops beating the per-phone loop)
            ab_cohort = certified if certified else args.cohort_start
            legs: dict = {}
            # both legs share one rung number — same values, so the
            # second leg's flat control is a baseline-memo hit
            for leg, pipe in [("serial", False), ("pipelined", True)]:
                ab = run_rung(rung + 1, ab_cohort, ctx, pipeline=pipe, leg=leg)
                ab.pop("_elapsed")
                ab.pop("_spans")
                assert ab["exact"] and ab["flat_byte_match"], (
                    f"arrivals A/B {leg} leg lost exactness"
                )
                legs[leg] = {
                    "arrivals_s": ab["stages"].get("rung.arrivals"),
                    "round_s": ab["round_s"],
                    "churned": ab["churned"],
                    "exact": ab["exact"],
                    "flat_byte_match": ab["flat_byte_match"],
                }
                print(f"[flagship] arrivals A/B {leg}: cohort {ab_cohort} "
                      f"arrivals={legs[leg]['arrivals_s']}s", file=sys.stderr)
            serial_s = legs["serial"]["arrivals_s"]
            pipe_s = legs["pipelined"]["arrivals_s"]
            record["arrivals_ab"] = {
                "cohort": ab_cohort,
                "legs": legs,
                "arrivals_pipeline_speedup": (
                    round(serial_s / pipe_s, 4)
                    if serial_s and pipe_s else None
                ),
            }
            # within-run tier-close A/B at the same cohort: rungs over
            # the legacy serial loop (SDA_TIER_FANOUT=1) INTERLEAVED
            # with rungs over the default fanout on the SAME live plane
            # — serial, fanout, serial, fanout — so store growth and
            # daemon warm-up drift hit both legs alike; each leg is
            # scored by its best rep (one-off stalls on a 1-CPU host
            # would dominate a 2-sample mean). The compared wall is the
            # WHOLE post-ingest tier machinery (tier.close + promote +
            # root stages): fanned-out closes deliberately hand the
            # committee daemons their jobs earlier, so clerk work the
            # serial leg serves inside tier.promote runs inside the
            # fanout leg's tier.close window — judging tier.close alone
            # would penalize exactly the overlap the fan-out exists to
            # buy. The resulting ratio is the drift-immune
            # ``tier_close_fanout_speedup`` bench_compare gates
            tc_reps: dict = {"serial": [], "fanout": []}
            ambient_fanout = os.environ.get("SDA_TIER_FANOUT")
            try:
                for rep in range(2):
                    for leg, pin in [("serial", "1"), ("fanout", None)]:
                        if pin is None:
                            os.environ.pop("SDA_TIER_FANOUT", None)
                        else:
                            os.environ["SDA_TIER_FANOUT"] = pin
                        tc = run_rung(
                            rung + 2, ab_cohort, ctx, leg=f"tc-{leg}-r{rep}"
                        )
                        tc.pop("_elapsed")
                        tc_spans = tc.pop("_spans")
                        assert tc["exact"] and tc["flat_byte_match"] \
                            and not tc["skipped"], (
                                f"tier-close A/B {leg} leg lost exactness"
                            )
                        overlaps = [
                            (s.get("attrs") or {}).get("overlap_efficiency")
                            for s in tc_spans if s.get("name") == "tier.close"
                        ]
                        overlaps = [o for o in overlaps if o is not None]
                        tier_s = round(sum(
                            v for k, v in tc["stages"].items()
                            if k.startswith("tier.")
                        ), 4)
                        tc_reps[leg].append({
                            "tier_s": tier_s,
                            "tier_close_s": tc["stages"].get("tier.close"),
                            "round_s": tc["round_s"],
                            "overlap_efficiency": (
                                round(sum(overlaps) / len(overlaps), 4)
                                if overlaps else None
                            ),
                            "exact": tc["exact"],
                            "flat_byte_match": tc["flat_byte_match"],
                        })
                        print(f"[flagship] tier-close A/B {leg} rep {rep}: "
                              f"cohort {ab_cohort} tier_s={tier_s}s "
                              f"(close="
                              f"{tc_reps[leg][-1]['tier_close_s']}s) overlap="
                              f"{tc_reps[leg][-1]['overlap_efficiency']}",
                              file=sys.stderr)
            finally:
                if ambient_fanout is None:
                    os.environ.pop("SDA_TIER_FANOUT", None)
                else:
                    os.environ["SDA_TIER_FANOUT"] = ambient_fanout
            tc_legs = {}
            for leg, reps in tc_reps.items():
                timed = [r for r in reps if r["tier_s"]]
                best = (
                    min(timed, key=lambda r: r["tier_s"])
                    if timed else reps[-1]
                )
                tc_legs[leg] = dict(best, reps=reps)
            serial_close = tc_legs["serial"]["tier_s"]
            fan_close = tc_legs["fanout"]["tier_s"]
            record["tier_close_ab"] = {
                "cohort": ab_cohort,
                "legs": tc_legs,
                "tier_close_fanout_speedup": (
                    round(serial_close / fan_close, 4)
                    if serial_close and fan_close else None
                ),
            }
            record["scale_factor"] = (
                round(args.simulated_population / certified, 1)
                if certified else None
            )
            fleet = scrape_fleet(roots)
            record["fleet_timeseries"] = {
                k: v for k, v in fleet.items() if k != "merged"
            }
            # the full merged series, bounded like the soak banks it
            record["merged_samples"] = fleet["merged"][-600:]
        except BaseException:
            # the tmp dir dies with this scope: surface every process's
            # stderr tail before it does, or daemon deaths are invisible
            for log in sorted(tmp.glob("*.stderr")):
                tail = log.read_text().splitlines()[-15:]
                if tail:
                    print(f"--- {log.name} ---", file=sys.stderr)
                    print("\n".join(tail), file=sys.stderr)
            raise
        finally:
            stop(procs)

    record["campaign_s"] = round(time.perf_counter() - t_start, 1)
    artdir = pathlib.Path(args.artifacts)
    artdir.mkdir(parents=True, exist_ok=True)
    path = artdir / f"flagship-{time.strftime('%Y%m%d-%H%M%S')}.json"
    path.write_text(json.dumps(record, indent=1, default=repr))

    print(f"[flagship] certified_max_cohort={record['certified_max_cohort']} "
          f"over {record['topology']['frontend_processes']} frontends x "
          f"{record['topology']['shards']} shards (R="
          f"{record['topology']['replicas']}), "
          f"{record['fleet_timeseries']['merged_buckets']} merged buckets "
          f"(max {record['fleet_timeseries']['max_procs_in_bucket']} procs), "
          f"arrivals_pipeline_speedup="
          f"{record['arrivals_ab']['arrivals_pipeline_speedup']} "
          f"tier_close_fanout_speedup="
          f"{record['tier_close_ab']['tier_close_fanout_speedup']} "
          f"in {record['campaign_s']}s", file=sys.stderr)
    print(path)

    ok = (
        record["certified_max_cohort"] >= args.cohort_start
        and record["fleet_timeseries"]["merged_buckets"] >= 1
        and record["fleet_timeseries"]["max_procs_in_bucket"] >= 2
        and record["arrivals_ab"]["arrivals_pipeline_speedup"] is not None
        and record["tier_close_ab"]["tier_close_fanout_speedup"] is not None
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
