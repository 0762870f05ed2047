"""The ingest riders (counterparts of ``bench.py``'s ``measure_rest_ingest``
and ``measure_batched_ingest``): the REST route's raw participation rate,
then the native sealers, the client's batched build and the single-POST
against the batch route over live mem and sqlite stores."""

from __future__ import annotations

import base64
import http.client
import importlib.util
import json
import pathlib
import time

from .. import telemetry
from ._common import RUN_TRACE_ID, aggregation, bank, emit_line, rest_deployment

#: the frozen HTTP transcript of the reference walkthrough, kept with the
#: checkout's tests: fixed identities, tokens and opaque ciphertexts
TRANSCRIPT_PATH = pathlib.Path(__file__).resolve().parents[2] / "tests" / "replay_transcript.py"


def _transcript() -> list:
    spec = importlib.util.spec_from_file_location("replay_transcript", TRANSCRIPT_PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.TRANSCRIPT


def measure_rest_ingest(n_posts: int = 300) -> dict:
    """Coordination-plane ingest: participations/s over the REST stack on
    loopback. A threaded server over the mem store takes pre-built
    participation bodies on one keep-alive connection, so the server's
    route, auth and store path is what is timed; client crypto is not.
    The transcript's setup prefix (agents, keys, aggregation, committee)
    replays first, each step at its recorded status; then ``n_posts``
    copies of its first participation, each under a fresh id, must all be
    accepted."""
    from ..rest.server import serve_background
    from ..server import new_mem_server

    transcript = _transcript()
    by_label = {s["label"]: s for s in transcript}
    post = by_label["part-1 participates"]
    out = {}
    with serve_background(new_mem_server()) as url:
        conn = http.client.HTTPConnection(url.split("//")[1], timeout=30)

        def do(step, body=None):
            headers = {}
            if step["auth"]:
                agent, pw = step["auth"]
                headers["Authorization"] = "Basic " + base64.b64encode(f"{agent}:{pw}".encode()).decode()
            data = (body or step["request_body"] or "").encode() or None
            if data:
                headers["Content-Type"] = "application/json"
            conn.request(step["method"], step["path"], body=data, headers=headers)
            resp = conn.getresponse()
            resp.read()
            want = (200, 201) if body is not None else (step["status"],)
            assert resp.status in want, (step["label"], resp.status, want)

        try:
            for step in transcript[: transcript.index(post)]:
                do(step)
            template = json.loads(post["request_body"])
            posts = [json.dumps({**template, "id": f"11111111-0000-4000-8000-{i:012d}"},
                                separators=(",", ":")) for i in range(n_posts)]
            t0 = time.perf_counter()
            for body in posts:
                do(post, body=body)
            out["participations_per_s"] = round(n_posts / (time.perf_counter() - t0))
        finally:
            conn.close()
    return out


def measure_batched_ingest(n_build: int = 600, n_singles: int = 150, device=None) -> dict:
    """Batched participation ingest, three planes, each on its own rider
    line and all banked as ``ingest-<stamp>.json`` with the run's telemetry
    beside it (``telemetry-<stamp>.json``):

    - native sealing: the plain Python sealer per call, one C batch call,
      and the shared-ephemeral P x C participation sealer (the C comb);
    - client build: ``new_participations`` over a cohort chunk, with the
      measurement plane off and on (a warm pair) and the pipelined
      ``participate_many``;
    - REST ingest: the single-POST loop against the batch route over a live
      loopback server on the sqlite and the mem store, through the real
      client (auth, wire, keep-alive).

    Host CPU only, a few seconds. ``device`` is the clients' (the cohort is
    far below the device fold)."""
    from .. import native
    from ..crypto import sodium
    from ..protocol import AdditiveSharing, NoMasking
    from ..server import new_mem_server, new_sqlite_server

    out: dict = {"native_ext": native.available()}

    # -- plane 1: native sealing -------------------------------------------
    msg = b"\x42" * 64
    pk, _sk = sodium.box_keypair()
    n_scalar = 400
    t0 = time.perf_counter()
    for _ in range(n_scalar):
        sodium.seal(msg, pk)
    out["seal_scalar_per_s"] = round(n_scalar / (time.perf_counter() - t0))
    n_batch = 4000
    t0 = time.perf_counter()
    native.seal_batch([msg] * n_batch, pk)
    out["seal_batch_per_s"] = round(n_batch / (time.perf_counter() - t0))
    out["seal_batch_vs_scalar"] = round(out["seal_batch_per_s"] / out["seal_scalar_per_s"], 2)
    n_part, n_clerks = 400, 8
    clerk_pks = [sodium.box_keypair()[0] for _ in range(n_clerks)]
    t0 = time.perf_counter()
    native.seal_participations([[msg] * n_clerks] * n_part, clerk_pks)
    out["seal_participations_seals_per_s"] = round(n_part * n_clerks / (time.perf_counter() - t0))
    out["seal_participations_vs_scalar"] = round(
        out["seal_participations_seals_per_s"] / out["seal_scalar_per_s"], 2)
    emit_line("batched_ingest_native_sealing", out["seal_batch_per_s"], "seals_per_second",
              seal_scalar_per_s=out["seal_scalar_per_s"],
              seal_batch_vs_scalar=out["seal_batch_vs_scalar"],
              seal_participations_seals_per_s=out["seal_participations_seals_per_s"],
              seal_participations_vs_scalar=out["seal_participations_vs_scalar"],
              roofline={
                  "plane": "host_cpu",
                  "bound": "curve25519_scalarmult",
                  # curve multiplications per sealed box: two per box on the
                  # scalar and batch paths; 1 + 1/C on the participation
                  # sealer (one ephemeral per participant across C boxes)
                  "mults_per_seal_scalar": 2.0,
                  "mults_per_seal_batch": 2.0,
                  "mults_per_seal_matrix": round(1.0 + 1.0 / n_clerks, 3),
              })

    # -- planes 2 and 3: client build, REST ingest over live stores ----------
    values = [[1, 2, 3, 4]] * n_build

    def ingest_over_rest(make_server, tag: str, measure_build: bool):
        with rest_deployment(make_server, device) as d:
            recipient, rkey = d.keyed("r")
            d.committee(3)
            agg = aggregation(recipient, rkey, "ingest-bench", 4, 433, NoMasking(),
                              AdditiveSharing(share_count=3, modulus=433))
            recipient.upload_aggregation(agg)
            recipient.begin_aggregation(agg.id)
            participant = d.client("p", upload=True)

            t0 = time.perf_counter()
            batch = participant.new_participations(values, agg.id)
            build_s = time.perf_counter() - t0
            if measure_build:
                out["build_per_s"] = round(n_build / build_s)

                # the measurement plane's cost: the same build with
                # telemetry off and on, both warm (the build above paid the
                # first use of the comb tables and the lazy imports)
                def timed_build() -> float:
                    t1 = time.perf_counter()
                    participant.new_participations(values, agg.id)
                    return time.perf_counter() - t1

                was_enabled = telemetry.enabled()
                telemetry.set_enabled(False)
                try:
                    off_s = timed_build()
                finally:
                    telemetry.set_enabled(was_enabled)
                on_s = timed_build()
                out["build_per_s_telemetry_off"] = round(n_build / off_s)
                out["build_per_s_telemetry_on"] = round(n_build / on_s)
                out["telemetry_overhead_pct"] = round((on_s - off_s) / off_s * 100.0, 2)
            t0 = time.perf_counter()
            for p in batch[:n_singles]:
                participant.upload_participation(p)
            out[f"rest_{tag}_singles_per_s"] = round(n_singles / (time.perf_counter() - t0))
            rest = batch[n_singles:]
            t0 = time.perf_counter()
            participant.upload_participations(rest)
            out[f"rest_{tag}_batch_per_s"] = round(len(rest) / (time.perf_counter() - t0))
            out[f"rest_{tag}_batch_vs_singles"] = round(
                out[f"rest_{tag}_batch_per_s"] / out[f"rest_{tag}_singles_per_s"], 2)
            if measure_build:
                # build chunk k+1 while chunk k uploads: what a large
                # cohort's client runs
                t0 = time.perf_counter()
                participant.participate_many(values, agg.id, chunk_size=128)
                out["participate_many_per_s"] = round(n_build / (time.perf_counter() - t0))

    ingest_over_rest(lambda root: new_sqlite_server(str(root / "sda.db")), "sqlite", True)
    ingest_over_rest(lambda root: new_mem_server(), "mem", False)

    emit_line("batched_ingest_client_build", out["build_per_s"], "participations_per_second",
              participate_many_per_s=out["participate_many_per_s"],
              build_per_s_telemetry_off=out["build_per_s_telemetry_off"],
              telemetry_overhead_pct=out["telemetry_overhead_pct"],
              roofline={"plane": "host_cpu", "bound": "seal_and_share", "clerks": 3,
                        "seals_per_participation": 3})
    for tag in ("sqlite", "mem"):
        emit_line(f"batched_ingest_rest_{tag}", out[f"rest_{tag}_batch_per_s"],
                  "participations_per_second",
                  singles_per_s=out[f"rest_{tag}_singles_per_s"],
                  batch_vs_singles=out[f"rest_{tag}_batch_vs_singles"],
                  roofline={"plane": "loopback_rest",
                            "bound": "request_overhead_then_store_commit",
                            "requests_singles": n_singles, "requests_batch": 1})

    bank({
        "ingest": {
            "metric": "batched_participation_ingest",
            "config": {"n_build": n_build, "n_singles": n_singles, "n_seal_batch": n_batch,
                       "seal_matrix": [n_part, n_clerks], "dim": 4, "committee": "additive x3"},
            **out,
        },
        # the run's measurement plane beside it: every series the riders
        # touched and the recent spans, under the run's trace id
        "telemetry": {"trace_id": RUN_TRACE_ID, **telemetry.snapshot()},
    })
    return out

