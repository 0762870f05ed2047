"""Randomized crash-injection soak over the real two-process deployment
(counterpart of ``scripts/crash_soak.py``).

Each round boots TWO ``sdad`` server processes (``python -m
sda_tpu_torch.cli.sdad``) on one shared sqlite store (the reference's
multi-process deployment shape, server-store-mongodb/src/lib.rs:64-84),
runs a full masked additive round through them over real REST, and
SIGKILLs one server at a random point:

  - phase ``participate``: after some participations have landed
  - phase ``enqueue``:     right after end_aggregation enqueued the jobs
  - phase ``clerking``:    after the first clerk already posted a result
  - phase ``restart``:     kill post-enqueue, then boot a COLD sdad onto
    the store the dead writer left behind (stale WAL recovery + the
    boot-lock race) and route the clerks through the newcomer

The victim is random (server A or B); every role then fails over to the
survivor with the same identity and TOFU token. The round must still
produce the exact modular sum and the store must pass integrity_check —
the passive-resilience contract (delete-after-result job durability,
jfs_stores/clerking_jobs.rs:51-59; result_ready gating, server.rs:115-121)
under hard process death. Every client computes on ``--device`` (``cuda``
by default; without a GPU the script exits 2).

Usage:  python -m sda_tpu_torch.scripts.crash_soak [N] [--device cpu]
        (default 10 rounds; ~8-15 s/round)
Exit 0 = every round exact + integrity ok; 1 = any failure (seed printed).
"""

from __future__ import annotations

import argparse
import pathlib
import signal
import sys
import tempfile

import numpy as np

from ..riders._common import sdad_url, spawn_sdad, stop_process
from . import device_or_exit
from .scenarios import http_client, rebind

DIM = 24
MODULUS = 1_000_003
PHASES = ("participate", "enqueue", "clerking", "restart")
FIRST_SEED = 20_000


def draw_round(seed: int) -> tuple:
    """``(phase, victim index, participant count, vectors)`` drawn from
    ``np.random.default_rng(seed)`` in the reference's order: the three
    choices first, the ``(count, DIM)`` vectors after them."""
    rng = np.random.default_rng(seed)
    phase = PHASES[int(rng.integers(len(PHASES)))]
    victim_ix = int(rng.integers(2))
    n_parts = int(rng.integers(3, 7))
    vectors = rng.integers(0, MODULUS, size=(n_parts, DIM))
    return phase, victim_ix, n_parts, vectors


def spawn_sqlite_sdad(db: pathlib.Path, tag: str):
    """``sdad --sqlite db httpd`` on a kernel-chosen loopback port; its
    stderr beside the store. ``sdad_url(proc)`` waits for it."""
    return spawn_sdad(["--sqlite", db, "httpd", "-b", "127.0.0.1:0"],
                      errlog=db.parent / f"sdad-{tag}.stderr")


def integrity_ok(db) -> bool:
    """``PRAGMA integrity_check`` of the sqlite file ``db`` reads ``ok``."""
    import sqlite3

    conn = sqlite3.connect(str(db))
    try:
        return conn.execute("PRAGMA integrity_check").fetchone()[0] == "ok"
    finally:
        conn.close()


def new_client(tmpdir, service, device=None):
    """A real crypto-enabled client over a fresh keystore in ``tmpdir``."""
    from ..client import SdaClient
    from ..crypto import Keystore

    keystore = Keystore(tmpdir)
    return SdaClient(SdaClient.new_agent(keystore), keystore, service, device=device)


def one_round(seed: int, tmp: pathlib.Path, device=None) -> dict:
    """One randomized crash round under ``tmp``; raises unless the reveal
    is the exact sum and the store passes ``integrity_check``. Returns
    what was drawn: ``seed, phase, victim, participants``."""
    from ..protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        ChaChaMasking,
        SodiumEncryptionScheme,
    )

    phase, victim_ix, n_parts, vectors = draw_round(seed)

    db = tmp / "shared.db"
    # both boot at once, racing each other for the fresh file's WAL switch
    procs = [spawn_sqlite_sdad(db, "a"), spawn_sqlite_sdad(db, "b")]
    try:
        urls = [sdad_url(proc) for proc in procs]
        survivor_url = urls[1 - victim_ix]

        def client(name, url):
            return new_client(tmp / name, http_client(tmp / f"tok-{name}", url), device)

        recipient = client("recipient", urls[0])
        rkey = recipient.new_encryption_key()
        recipient.upload_agent()
        recipient.upload_encryption_key(rkey)
        clerks = [client(f"clerk{i}", urls[i % 2]) for i in range(3)]
        for c in clerks:
            c.upload_agent()
            c.upload_encryption_key(c.new_encryption_key())

        agg = Aggregation(
            id=AggregationId.random(),
            title=f"crash-soak-{seed}",
            vector_dimension=DIM,
            modulus=MODULUS,
            recipient=recipient.agent.id,
            recipient_key=rkey,
            masking_scheme=ChaChaMasking(modulus=MODULUS, dimension=DIM, seed_bitsize=128),
            committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=MODULUS),
            recipient_encryption_scheme=SodiumEncryptionScheme(),
            committee_encryption_scheme=SodiumEncryptionScheme(),
        )
        recipient.upload_aggregation(agg)
        recipient.begin_aggregation(agg.id)

        def kill_victim():
            procs[victim_ix].send_signal(signal.SIGKILL)
            procs[victim_ix].wait()

        for i in range(n_parts):
            # a mid-participation kill reroutes the remaining participants
            if phase == "participate" and i == n_parts // 2:
                kill_victim()
            alive = [u for j, u in enumerate(urls) if procs[j].poll() is None]
            part = client(f"part{i}", alive[i % len(alive)])
            part.upload_agent()
            part.participate(vectors[i].tolist(), agg.id)

        recipient = rebind(recipient, http_client(tmp / "tok-recipient", survivor_url))
        recipient.end_aggregation(agg.id)
        if phase == "enqueue":
            kill_victim()
        elif phase == "restart":
            # the distinct recovery path: kill the victim AFTER jobs are
            # enqueued, then boot a COLD process onto the store the dead
            # writer left behind (stale WAL + possible boot-lock race with
            # the survivor) and route the round through the newcomer
            kill_victim()
            newcomer = spawn_sqlite_sdad(db, "cold")
            procs.append(newcomer)
            survivor_url = sdad_url(newcomer)

        for i, c in enumerate(clerks):
            if phase == "clerking" and i == 1:
                kill_victim()
            c = rebind(c, http_client(tmp / f"tok-clerk{i}", survivor_url))
            c.run_chores(-1)
        recipient.run_chores(-1)  # recipient may also hold committee jobs

        out = recipient.reveal_aggregation(agg.id).positive().values
        want = vectors.sum(axis=0) % MODULUS
        if not np.array_equal(np.asarray(out), want):
            raise AssertionError(f"aggregate mismatch (phase={phase}, victim={victim_ix})")
        if not integrity_ok(db):
            raise AssertionError("sqlite integrity_check failed")
    finally:
        for proc in procs:
            stop_process(proc)
    return {"seed": seed, "phase": phase, "victim": victim_ix, "participants": n_parts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sda_tpu_torch.scripts.crash_soak",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=10,
                    help="randomized crash rounds to run (default 10)")
    ap.add_argument("--device", default="cuda",
                    help="the clients' torch device (default cuda; exits 2 without a GPU)")
    args = ap.parse_args(argv)
    device = device_or_exit("crash_soak", args.device)

    n = args.n
    fails = []
    for seed in range(n):
        try:
            with tempfile.TemporaryDirectory() as td:
                one_round(FIRST_SEED + seed, pathlib.Path(td), device)
        except Exception as e:  # noqa: BLE001 — report and continue
            fails.append(seed)
            print(f"FAIL seed={FIRST_SEED + seed}: {e!r}", file=sys.stderr)
        print(f"[crash-soak] round {seed + 1}/{n} done, {len(fails)} failures", file=sys.stderr)
    print(f"crash-soak: {n - len(fails)}/{n} randomized crash rounds exact")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
