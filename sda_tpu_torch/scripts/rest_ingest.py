"""Measured REST ingest at >= 100K participations (counterpart of
``scripts/rest_ingest.py``).

The server-side ingest choke point is the store write path: the port's
``rest/server.py`` handler over ``server/sqlstore.py`` (WAL), the memory
store or the JSON-file store. The bench's rest-ingest rider measures 300
posts against the mem store, enough for a rate estimate, not for
sustained-ingest evidence. This script replays the canonical transcript
setup (fixed identities, ``tests/replay_transcript.py``, read through the
REST ingest rider's loader) against a live loopback HTTP server, hammers
N fresh participation POSTs from ``--threads`` keep-alive connections,
verifies every response status AND the stored row count afterwards, and
prints one JSON artifact with the measured participations/s. It drives
the server and raw HTTP only, no client crypto and no device, so it
takes no ``--device``.

Usage: python -m sda_tpu_torch.scripts.rest_ingest [--n 100000] [--threads 4]
         [--backend sqlite|mem|file] [--out FILE]
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

from ..protocol import AggregationId
from ..rest.server import serve_background
from ..riders.ingest import load_transcript, participation_bodies, replay_request, replay_setup
from ..server import new_file_server, new_mem_server, new_sqlite_server


def _post_slice(host, step, bodies, results, ix):
    """One worker: own keep-alive connection, POST every body, count
    accepted statuses (anything else fails the run loudly)."""
    conn = http.client.HTTPConnection(host, timeout=60)
    ok = 0
    t0 = time.perf_counter()
    try:
        for body in bodies:
            status = replay_request(conn, step, body)
            if status in (200, 201):
                ok += 1
            else:
                raise AssertionError(f"worker {ix}: POST status {status} after {ok} ok")
    finally:
        results[ix] = {"ok": ok, "wall_s": time.perf_counter() - t0}
        conn.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sda_tpu_torch.scripts.rest_ingest",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--backend", choices=("sqlite", "mem", "file"),
                        default="sqlite")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    transcript = load_transcript()

    with tempfile.TemporaryDirectory() as tmp:
        service = {
            "sqlite": lambda: new_sqlite_server(os.path.join(tmp, "db")),
            "file": lambda: new_file_server(os.path.join(tmp, "files")),
            "mem": new_mem_server,
        }[args.backend]()
        with serve_background(service) as url:
            host = url.split("//")[1]
            setup_conn = http.client.HTTPConnection(host, timeout=60)
            part_step = replay_setup(setup_conn, transcript)
            setup_conn.close()
            agg_id = AggregationId(json.loads(part_step["request_body"])["aggregation"])

            # fresh unique participation ids, pre-serialized so body
            # construction never rides the timed loop
            bodies = participation_bodies(part_step, (
                f"22222222-{i >> 48 & 0xFFFF:04x}-4000-8000-{i & 0xFFFFFFFFFFFF:012d}"
                for i in range(args.n)))
            body_bytes = len(bodies[0])

            results: list = [None] * args.threads
            workers = []
            per = -(-args.n // args.threads)
            t0 = time.perf_counter()
            for ix in range(args.threads):
                chunk = bodies[ix * per: (ix + 1) * per]
                w = threading.Thread(
                    target=_post_slice,
                    args=(host, part_step, chunk, results, ix),
                )
                w.start()
                workers.append(w)
            for w in workers:
                w.join()
            wall = time.perf_counter() - t0

            posted = sum(r["ok"] for r in results if r)
            if posted != args.n:
                print(f"FAILED: {posted}/{args.n} accepted", file=sys.stderr)
                return 1
            # the store must actually HOLD the rows (status codes alone
            # would bless a handler that acks and drops)
            stored = service.server.aggregation_store.count_participations(
                agg_id
            )
            if stored != args.n:
                print(f"FAILED: {stored}/{args.n} rows stored",
                      file=sys.stderr)
                return 1
            # sqlite: the db file plus -wal/-shm siblings; file backend: a
            # directory tree; mem: nothing on disk
            db_bytes = sum(
                f.stat().st_size
                for pat in ("db*", "files/**/*")
                for f in Path(tmp).glob(pat)
                if f.is_file()
            ) or None

    artifact = {
        "metric": "rest_ingest_participations_per_second",
        "backend": args.backend,
        "n": args.n,
        "threads": args.threads,
        "wall_s": round(wall, 2),
        "participations_per_s": round(args.n / wall, 1),
        "body_bytes": body_bytes,
        "stored_rows_verified": True,
        "per_worker": [
            {"ok": r["ok"], "wall_s": round(r["wall_s"], 2)} for r in results
        ],
        "store_bytes_after": db_bytes,
    }
    payload = json.dumps(artifact)
    print(payload)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(payload + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
