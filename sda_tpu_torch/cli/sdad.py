"""``sdad`` — the server daemon (and committee runner); counterpart of
``sda_tpu/cli/sdad.py``, run as ``python -m sda_tpu_torch.cli.sdad``.

Parity with the SDA server's sdad.rs: pick a storage backend (``--file
root`` durable, ``--sqlite db``, ``--mem`` in-memory; the SDA server's
equivalents are ``--jfs``/``--mongo``), then ``httpd -b ip:port`` (default
127.0.0.1:8888). ``--shards K`` partitions aggregation state over K store
shards (``shard-NN`` directories or ``shard-NN.db`` files under the given
path, ``sda_tpu``'s layout) and ``--replicas R`` replicates each
aggregation over R of them; several ``sdad`` processes over one root are
frontends of one deployment.

``committee`` runs several clerk identities concurrently against a
remote server (``client.run_committee``): one worker thread per clerk,
so committee wall time approaches the slowest member instead of the
round-robin sum — the daemon shape for hosting a whole committee in one
process. Its ``--device`` follows the port's device rule (``cuda`` unless
``--device cpu``); clerks do host work only.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from ..server import new_file_server, new_mem_server, new_sharded_server, new_sqlite_server

log = logging.getLogger("sda.sdad")

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="sdad", description="SDA server daemon")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    backend = parser.add_mutually_exclusive_group()
    backend.add_argument("--file", metavar="ROOT", help="durable JSON-file store root")
    backend.add_argument("--sqlite", metavar="DB", help="sqlite database path (production)")
    backend.add_argument("--mem", action="store_true", help="in-memory store (dev)")
    parser.add_argument(
        "--shards",
        type=int,
        default=1,
        metavar="K",
        help="partition aggregation state over K store shards "
        "(file/sqlite paths become per-shard roots under the given path)",
    )
    parser.add_argument(
        "--replicas",
        type=int,
        default=None,
        metavar="R",
        help="replicate each aggregation's state over the first R shards "
        "of its ring preference (quorum writes + hinted handoff; default "
        "SDA_SHARD_REPLICAS or 1 — single-home routing). R>1 lets any "
        "one store shard die mid-round without losing the round.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    httpd = sub.add_parser("httpd", help="run the REST server")
    httpd.add_argument("-b", "--bind", default="127.0.0.1:8888", metavar="IP:PORT")
    committee = sub.add_parser(
        "committee", help="run several clerk identities concurrently"
    )
    committee.add_argument(
        "-s",
        "--server",
        action="append",
        default=None,
        metavar="URL",
        help="SDA service URL; repeat once per frontend of a multi-frontend "
        "deployment, in frontend order (every process must agree on it — "
        "the clerks' keyed requests ring-route over the list exactly like "
        "a multi-root client). Default http://127.0.0.1:8888",
    )
    committee.add_argument(
        "-i",
        "--identity",
        action="append",
        required=True,
        metavar="DIR",
        help="clerk identity/keys directory (repeat once per clerk)",
    )
    committee.add_argument(
        "-o", "--once", action="store_true", help="drain every queue once and exit"
    )
    committee.add_argument(
        "--device", default="cuda", help="the clerks' device (cuda or cpu)"
    )
    committee.add_argument(
        "-p",
        "--poll-seconds",
        type=float,
        default=2.0,
        metavar="SECONDS",
        help="max sleep between queue polls (jittered backoff ramps up "
        "to this after an idle pass)",
    )
    return parser


def run_committee_daemon(args) -> int:
    from pathlib import Path

    from ..client import SdaClient, run_committee
    from ..device import resolve_device
    from ..crypto import Filebased, Keystore
    from ..protocol import Agent, SdaError
    from ..rest import SdaHttpClient, TokenStore

    roots = args.server or ["http://127.0.0.1:8888"]
    device = resolve_device(args.device)
    clerks = []
    for d in args.identity:
        identity = Path(d)
        agent = Filebased(identity).get_aliased("agent", Agent.from_json)
        if agent is None:
            raise SystemExit(f"sdad: no agent identity under {identity}")
        clerks.append(
            SdaClient(
                agent,
                Keystore(identity / "keys"),
                SdaHttpClient(roots, TokenStore(identity)),
                device=device,
            )
        )
    log.info(
        "running a committee of %d clerks against %d frontend(s): %s",
        len(clerks), len(roots), " ".join(roots),
    )
    # bounded jittered backoff between polls: after a pass that found
    # work the queues are re-polled almost immediately (stragglers from
    # a snapshot land promptly); an idle or stalled server is probed at
    # most every poll_seconds, so the daemon never spins
    from ..utils.faults import Backoff

    backoff = Backoff(cap=max(args.poll_seconds, 0.001))
    while True:
        try:
            n = run_committee(clerks, -1)
        except SdaError as e:
            # a transient transport stall must not kill the daemon; the
            # next poll retries. --once runs propagate: the caller asked
            # for exactly one attempt and needs the failure.
            if args.once:
                raise
            log.warning("committee pass failed (%s); retrying next poll", e)
        else:
            if n:
                log.info("committee processed %d jobs", n)
                backoff.reset()
            if args.once:
                return 0
        time.sleep(backoff.next_delay())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    level = [logging.INFO, logging.DEBUG][min(args.verbose, 1)]
    logging.basicConfig(level=level, stream=sys.stderr, format="%(asctime)s %(name)s %(message)s")

    if args.command == "committee":
        return run_committee_daemon(args)

    shards = max(int(args.shards or 1), 1)
    replicas = args.replicas if args.replicas is None else max(int(args.replicas), 1)
    if shards > 1:
        if args.file:
            service = new_sharded_server("file", shards, args.file, replicas=replicas)
            log.info("using file store at %s over %d shards", args.file, shards)
        elif args.sqlite:
            service = new_sharded_server("sqlite", shards, args.sqlite, replicas=replicas)
            log.info("using sqlite store at %s over %d shards", args.sqlite, shards)
        else:
            service = new_sharded_server("mem", shards, replicas=replicas)
            log.info("using in-memory store over %d shards", shards)
        log.info(
            "replication factor %d (quorum writes + hinted handoff)"
            if service.shard_router.replicas > 1
            else "replication factor %d (single-home routing)",
            service.shard_router.replicas,
        )
    elif args.file:
        service = new_file_server(args.file)
        log.info("using file store at %s", args.file)
    elif args.sqlite:
        service = new_sqlite_server(args.sqlite)
        log.info("using sqlite store at %s", args.sqlite)
    else:
        service = new_mem_server()
        log.info("using in-memory store")

    host, _, port = args.bind.rpartition(":")
    from ..rest.server import listen

    httpd = listen((host or "127.0.0.1", int(port)), service)
    bound_host, bound_port = httpd.server_address[:2]
    # report the bound address on stdout: with ``-b ip:0`` the kernel picks
    # the port, so parent processes (tests, orchestration) parse this line
    # instead of racing a probe-socket for a "free" port
    print(f"sdad: listening on {bound_host}:{bound_port}", flush=True)
    log.info("sda REST server listening on %s:%s", bound_host, bound_port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        # keep-alive accounting: force-close live persistent connections
        # instead of waiting out their idle timeout (SDA_REST_IDLE_TIMEOUT_S)
        log.info("interrupted; closing live connections")
    finally:
        httpd.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
