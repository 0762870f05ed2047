"""Named churn scenarios over real SDA deployments — the chaos harness
(counterpart of ``scripts/scenarios.py``).

Each scenario drives a full aggregation round through a REAL deployment
cell (store x transport: mem/file/sqlite x in-process/REST to a
``python -m sda_tpu_torch.cli.sdad`` subprocess) while one specific kind
of churn happens, and asserts the protocol's survivability contract: the
revealed aggregate is EXACT (never silently wrong), or the failure is
loud. Every client computes on ``--device`` (``cuda`` by default; without
a GPU the script exits 2).

Scenarios:

  register-never-submit     agents register, some never participate; the
                            round aggregates exactly the submitted subset
  submit-mid-snapshot       participants submit concurrently WHILE the
                            recipient cuts the snapshot; participant i
                            submits the constant vector 2^i, so the
                            revealed value's bit pattern proves the
                            snapshot caught a consistent subset
  vanish-after-sharing      every participant seals shares to the whole
                            committee, then clerks above the
                            reconstruction threshold vanish; basic AND
                            packed Shamir reveal exactly from the
                            survivors, byte-identical to full attendance
  clerk-kill-mid-chunk      a clerk dies (os._exit, no cleanup) halfway
                            through a paged job download; a fresh clerk
                            process with the same identity resumes from
                            the re-served job and the round completes
  duplicate-replay-malformed  duplicate + replayed submissions under
                            concurrent load are absorbed (counted once),
                            malformed ones rejected at the door
  saturated-frontend        a burst storm against a frontend pinned to
                            SDA_REST_MAX_INFLIGHT=1 sheds with 429 +
                            Retry-After; the backoff client paces every
                            retry and the round still reveals exactly
  kill-shard-mid-round      a replicated deployment (K=3, R=2) loses the
                            aggregation's HOME store shard after ingest
                            (on-disk ``shard-NN.down`` marker); the
                            round reveals exactly off the surviving
                            replica, the handoff queue drains once the
                            shard heals, and the repaired victim alone
                            then serves a second exact reveal (file and
                            sqlite cells only: mem partitions have no
                            root to wedge across a process boundary)
  sub-committee-clerk-killed  a 2-tier hierarchical round (disjoint
                            committees) loses one clerk of one
                            sub-committee after ingest; the sub-Shamir
                            threshold reveals the partial from the
                            survivors and the ROOT total is byte-exact
  tier-reshare-clerk-death  a 2-tier round loses clerks of one
                            sub-committee on both sides of its
                            threshold: above it the root is exact over
                            everyone, below it the subtree is skipped
                            and the root is exact over the rest
  sub-cohort-vanishes       a 2-tier round loses an entire sub-cohort
                            (its sub-aggregation deleted after ingest);
                            the lenient driver skips it and the root
                            reveals the exact sum of the survivors

Each cell banks ``scenario-<name>-<stamp>-<store>-<transport>.json`` into
the artifact dir (default bench-artifacts/); ``scripts/sweep_report.py``
rolls all banked cells into the scenario x store x transport
survivability matrix. Exit 0 iff every requested cell is green.

Usage:
  python -m sda_tpu_torch.scripts.scenarios                  # full matrix
  python -m sda_tpu_torch.scripts.scenarios --scenarios vanish-after-sharing \\
      --stores mem --transports rest                         # one cell
  python -m sda_tpu_torch.scripts.scenarios --overhead-ab    # retry-layer A/B
  (add ``--device cpu`` on a host without a GPU)

``--overhead-ab`` measures the faults-off overhead of the REST retry
layer (SDA_REST_RETRIES=default vs 0, interleaved ping batches) and
banks ``overhead-ab-<stamp>.json`` — the evidence for the <2% bound.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from dataclasses import replace

import numpy as np

from ..riders._common import start_sdad, stop_process
from . import REPO, device_or_exit

DIM = 4
MODULUS = 433
STORES = ("mem", "file", "sqlite")
TRANSPORTS = ("inproc", "rest")


# -- deployment cells -------------------------------------------------------


def _store_args(store: str, tmp: pathlib.Path, shards: int = 1, replicas: int = 1) -> list:
    """``sdad``'s backend flags for a cell. ``shards > 1`` runs the
    partitioned plane (file/sqlite partitions laid out under
    ``tmp/shardstore``) with ``--replicas`` replication."""
    if shards > 1 and store != "mem":
        flag = "--file" if store == "file" else "--sqlite"
        backend = [flag, str(tmp / "shardstore")]
    elif store == "mem":
        backend = ["--mem"]
    elif store == "file":
        backend = ["--file", str(tmp / "filestore")]
    else:
        backend = ["--sqlite", str(tmp / "sda.db")]
    sharding = ["--shards", str(shards), "--replicas", str(replicas)] if shards > 1 else []
    return backend + sharding


def _new_server(store: str, tmp: pathlib.Path, shards: int = 1, replicas: int = 1):
    from ..server import new_file_server, new_mem_server, new_sharded_server, new_sqlite_server

    if shards > 1:
        path = None if store == "mem" else str(tmp / "shardstore")
        return new_sharded_server(store, shards, path, replicas=replicas)
    if store == "file":
        return new_file_server(str(tmp / "filestore"))
    if store == "sqlite":
        return new_sqlite_server(str(tmp / "sda.db"))
    return new_mem_server()


def http_client(tokens: pathlib.Path, url):
    """``SdaHttpClient`` to ``url`` over a token store in ``tokens``."""
    from ..rest import SdaHttpClient, TokenStore

    tokens.mkdir(parents=True, exist_ok=True)
    return SdaHttpClient(url, TokenStore(str(tokens)))


def rebind(client, service):
    """Same identity, keystore and device; another service (a second server
    process over a shared store)."""
    from ..client import SdaClient

    return SdaClient(client.agent, client.crypto.keystore, service, device=client.crypto.device)


def persistent_client(identity: pathlib.Path, service, device=None):
    """A crypto-enabled client whose identity (agent + keys) lives on disk
    — the same layout ``sdad committee`` loads, so a SECOND process (or a
    resurrected clerk) can pick up exactly where this one died. It
    computes on ``device`` (``resolve_device``: CUDA by default)."""
    from ..client import SdaClient
    from ..crypto import Filebased, Keystore
    from ..protocol import Agent

    identity.mkdir(parents=True, exist_ok=True)
    filestore = Filebased(identity)
    keystore = Keystore(identity / "keys")
    agent = filestore.get_aliased("agent", Agent.from_json)
    if agent is None:
        agent = SdaClient.new_agent(keystore)
        filestore.put_aliased("agent", agent)
    return SdaClient(agent, keystore, service, device=device)


class Deployment:
    """One live (store, transport) cell. ``client(name)`` returns a
    disk-persistent identity bound to the cell's service endpoint,
    computing on ``device``."""

    def __init__(self, store: str, transport: str, tmp: pathlib.Path,
                 shards: int = 1, replicas: int = 1, device=None):
        self.store = store
        self.transport = transport
        self.tmp = tmp
        self.shards = shards
        self.replicas = replicas
        self.device = device
        self.url = None
        self._proc = None
        self._server = None

    @property
    def store_root(self) -> pathlib.Path:
        """Partition root of a sharded cell — where the ``shard-NN.down``
        wedge markers live (both transports agree on the layout)."""
        return self.tmp / "shardstore"

    def __enter__(self):
        if self.transport == "rest":
            # the subprocess inherits this process's environment: the
            # runner's scoped knobs are in place before the spawn
            self._proc, self.url = start_sdad(
                _store_args(self.store, self.tmp, self.shards, self.replicas),
                errlog=self.tmp / f"sdad-{self.store}.stderr")
        else:
            self._server = _new_server(self.store, self.tmp, self.shards, self.replicas)
        return self

    def __exit__(self, *exc):
        if self._server is not None and hasattr(self._server, "shard_router"):
            self._server.shard_router.stop_repair()
        if self._proc is not None:
            stop_process(self._proc)

    def service_for(self, name: str):
        if self.transport == "rest":
            return http_client(self.tmp / f"tok-{name}", self.url)
        return self._server

    def client(self, name: str):
        return persistent_client(self.tmp / f"id-{name}", self.service_for(name), self.device)


# -- round scaffolding ------------------------------------------------------


def _chacha(modulus: int = MODULUS, dim: int = DIM):
    from ..protocol import ChaChaMasking

    return ChaChaMasking(modulus=modulus, dimension=dim, seed_bitsize=128)


def _setup_round(dep, sharing, masking, tag: str = "", dim: int = DIM, modulus: int = MODULUS):
    """Recipient + committee + opened aggregation; returns
    (recipient, clerks, aggregation)."""
    from ..protocol import Aggregation, AggregationId, SodiumEncryptionScheme

    recipient = dep.client(f"recipient{tag}")
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    clerks = [dep.client(f"clerk{tag}-{i}") for i in range(sharing.output_size)]
    for c in clerks:
        c.upload_agent()
        c.upload_encryption_key(c.new_encryption_key())
    agg = Aggregation(
        id=AggregationId.random(),
        title=f"scenario{tag}",
        vector_dimension=dim,
        modulus=modulus,
        recipient=recipient.agent.id,
        recipient_key=rkey,
        masking_scheme=masking,
        committee_sharing_scheme=sharing,
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme(),
    )
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in clerks])
    return recipient, clerks, agg


def _expected(values, modulus: int = MODULUS) -> np.ndarray:
    """The exact sum of ``values`` mod ``modulus``, one row at a time so
    no int64 partial sum can overflow below 2^62."""
    total = np.zeros(len(values[0]), dtype=np.int64)
    for v in values:
        total = (total + np.asarray(v, dtype=np.int64)) % modulus
    return total


def _reveal_exact(recipient, agg, expected) -> list:
    out = recipient.reveal_aggregation(agg.id).positive().values
    if not np.array_equal(np.asarray(out), np.asarray(expected)):
        raise AssertionError(f"aggregate mismatch: got {list(out)}, want {list(expected)}")
    return [int(v) for v in out]


def _metric_text(url: str) -> str:
    """The body of ``url``'s exempt ``/v1/metrics`` route."""
    with urllib.request.urlopen(f"{url}/v1/metrics", timeout=10) as resp:
        return resp.read().decode("utf-8", "replace")


# -- scenarios --------------------------------------------------------------


def scenario_register_never_submit(dep: Deployment, seed: int) -> dict:
    from ..protocol import AdditiveSharing

    recipient, clerks, agg = _setup_round(
        dep, AdditiveSharing(share_count=2, modulus=MODULUS), _chacha()
    )
    registered = [dep.client(f"part-{i}") for i in range(6)]
    for c in registered:
        c.upload_agent()
    # the last two are ghosts: registered, candidate-visible, never submit
    values = [[i, i + 1, 2, 0] for i in range(4)]
    for c, v in zip(registered[:4], values):
        c.participate(v, agg.id)
    recipient.end_aggregation(agg.id)
    for c in clerks:
        c.run_chores(-1)
    aggregate = _reveal_exact(recipient, agg, _expected(values))
    return {"registered": 6, "submitted": 4, "aggregate": aggregate}


def scenario_submit_mid_snapshot(dep: Deployment, seed: int) -> dict:
    """Participant i submits the constant vector [2^i]*DIM, so any exact
    subset-sum has one bit per included participant: all dimensions must
    agree, participant 0 (who submitted BEFORE the cut started) must be
    included, and the bit pattern proves the concurrent cut caught a
    consistent subset rather than torn rows."""
    from ..protocol import AdditiveSharing

    n = 8  # 2^8 - 1 = 255 < MODULUS: no wraparound can fake a bit
    recipient, clerks, agg = _setup_round(
        dep, AdditiveSharing(share_count=2, modulus=MODULUS), _chacha()
    )
    participants = [dep.client(f"part-{i}") for i in range(n)]
    for c in participants:
        c.upload_agent()
    participants[0].participate([1] * DIM, agg.id)

    errors: list = []
    barrier = threading.Barrier(n)  # n-1 submitters + the snapshot cutter

    def submit(i):
        try:
            barrier.wait()
            participants[i].participate([2**i] * DIM, agg.id)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append((i, repr(e)))

    def cut():
        try:
            barrier.wait()
            recipient.end_aggregation(agg.id)
        except Exception as e:  # noqa: BLE001
            errors.append(("cut", repr(e)))

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(1, n)]
    threads.append(threading.Thread(target=cut))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"concurrent submit/cut failed: {errors}")

    for c in clerks:
        c.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id).positive().values
    v = int(out[0])
    if not all(int(x) == v for x in out):
        raise AssertionError(f"torn snapshot: dimensions disagree: {list(out)}")
    if not v & 1:
        raise AssertionError("participant 0 submitted before the cut but is missing")
    if not 1 <= v < 2**n:
        raise AssertionError(f"revealed value {v} is not a subset bitmask")
    included = [i for i in range(n) if v >> i & 1]
    return {"submitted": n, "included": included, "value": v}


def vanish_cases() -> dict:
    """The reference's two committees for vanish-after-sharing, as
    ``{name: (sharing, vanished positions, values)}``."""
    from ..protocol import BasicShamirSharing, PackedShamirSharing

    values = [[i % 5, (i + 2) % 5, 1, 0] for i in range(5)]
    return {
        # 5 clerks, threshold 3: positions 0 and 3 vanish
        "basic": (
            BasicShamirSharing(share_count=5, privacy_threshold=2, prime_modulus=MODULUS),
            (0, 3),
            values,
        ),
        # 8 clerks, threshold t+k=7: position 5 vanishes
        "packed": (
            PackedShamirSharing(
                secret_count=3,
                share_count=8,
                privacy_threshold=4,
                prime_modulus=MODULUS,
                omega_secrets=354,
                omega_shares=150,
            ),
            (5,),
            values,
        ),
    }


def scenario_vanish_after_sharing(dep: Deployment, seed: int, *, cases=None) -> dict:
    """Each case's participant seals its rows to the whole committee, the
    clerks at the vanished positions never clerk, and the survivors'
    reveal must be exact; then the stragglers clerk and the full reveal
    must equal the degraded one in dtype and values. ``cases`` is
    ``{name: (sharing, vanished positions, values)}``, the reference's
    ``vanish_cases()`` by default; the aggregation's modulus is the
    sharing's prime and its dimension the rows' length."""
    cases = vanish_cases() if cases is None else cases
    details = {}
    for name, (sharing, vanished, values) in cases.items():
        modulus, dim = sharing.prime_modulus, len(values[0])
        recipient, clerks, agg = _setup_round(
            dep, sharing, _chacha(modulus, dim), tag=f"-{name}", dim=dim, modulus=modulus)
        participant = dep.client(f"subm-{name}")
        participant.upload_agent()
        participant.upload_participations(participant.new_participations(values, agg.id))
        recipient.end_aggregation(agg.id)
        survivors = [c for i, c in enumerate(clerks) if i not in vanished]
        for c in survivors:
            c.run_chores(-1)
        expected = _expected(values, modulus)
        partial = recipient.reveal_aggregation(agg.id)
        if not np.array_equal(partial.positive().values, expected):
            raise AssertionError(
                f"{name}: degraded reveal inexact: {list(partial.positive().values[:8])}"
            )
        # the stragglers come back; full attendance must change nothing
        for i in vanished:
            clerks[i].run_chores(-1)
        full = recipient.reveal_aggregation(agg.id)
        if full.values.dtype != partial.values.dtype or not np.array_equal(
            full.values, partial.values
        ):
            raise AssertionError(f"{name}: full reveal differs from degraded reveal")
        details[name] = {
            "committee": sharing.output_size,
            "vanished": list(vanished),
            "threshold": sharing.reconstruction_threshold,
            "aggregate": [int(v) for v in partial.positive().values],
        }
    return details


def kill_child(identity: str, tokens: str, url: str, kill_after: int, device) -> None:
    """The dying clerk of clerk-kill-mid-chunk's REST cells, run as
    ``python -m sda_tpu_torch.scripts.scenarios --kill-child ...``: loads
    the clerk identity from disk, wires a counting wrapper around the
    paged-chunk fetch, and dies via ``os._exit(9)`` (no cleanup, no result
    posted — the SIGKILL shape) after the ``kill_after``-th chunk."""
    from ..client import SdaClient
    from ..crypto import Filebased, Keystore
    from ..protocol import Agent

    svc = http_client(pathlib.Path(tokens), url)
    identity = pathlib.Path(identity)
    agent = Filebased(identity).get_aliased("agent", Agent.from_json)
    client = SdaClient(agent, Keystore(identity / "keys"), svc, device=device)
    state = {"left": int(kill_after)}
    orig = svc.get_clerking_job_chunk

    def bomb(caller, job_id, start):
        chunk = orig(caller, job_id, start)
        state["left"] -= 1
        if state["left"] <= 0:
            os._exit(9)
        return chunk

    svc.get_clerking_job_chunk = bomb
    client.run_chores(-1)
    os._exit(0)


class _InjectedDeath(BaseException):
    """In-process stand-in for os._exit: unwinds the clerk mid-chunk
    without posting a result (BaseException so no except-Exception
    handler absorbs it)."""


class _ChunkBomb:
    """Service proxy that dies after serving N paged-job chunks."""

    def __init__(self, inner, after: int):
        self._inner = inner
        self._left = after

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def get_clerking_job_chunk(self, caller, job_id, start):
        chunk = self._inner.get_clerking_job_chunk(caller, job_id, start)
        self._left -= 1
        if self._left <= 0:
            raise _InjectedDeath()
        return chunk


def scenario_clerk_kill_mid_chunk(dep: Deployment, seed: int) -> dict:
    """Requires paged job delivery (the runner sets
    SDA_JOB_PAGE_THRESHOLD=0 / SDA_JOB_CHUNK_SIZE=3 for this cell): the
    job's ciphertext column arrives in 4 chunks; the first clerk process
    dies after 2 and a fresh process with the same identity completes."""
    from ..client import SdaClient
    from ..crypto import Keystore
    from ..protocol import AdditiveSharing

    recipient, clerks, agg = _setup_round(
        dep, AdditiveSharing(share_count=2, modulus=MODULUS), _chacha()
    )
    participant = dep.client("part")
    participant.upload_agent()
    values = [[i % 7, 1, i % 3, 2] for i in range(10)]
    participant.upload_participations(participant.new_participations(values, agg.id))
    recipient.end_aggregation(agg.id)

    victim_identity = dep.tmp / "id-clerk-0"
    kill_after = 2
    if dep.transport == "rest":
        device = "cuda" if dep.device is None else str(dep.device)
        child = subprocess.run(
            [sys.executable, "-m", "sda_tpu_torch.scripts.scenarios", "--kill-child",
             str(victim_identity), str(dep.tmp / "tok-clerk-0"), dep.url, str(kill_after),
             "--device", device],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        if child.returncode != 9:
            raise AssertionError(
                f"kill child exited rc={child.returncode} (expected 9): "
                f"{child.stderr[-500:]}"
            )
        death = "os._exit(9) after 2 chunks"
    else:
        dying = SdaClient(
            clerks[0].agent,
            Keystore(victim_identity / "keys"),
            _ChunkBomb(dep.service_for("clerk-0"), kill_after),
            device=dep.device,
        )
        try:
            dying.run_chores(-1)
            raise AssertionError("chunk bomb never went off")
        except _InjectedDeath:
            death = "injected mid-chunk unwind after 2 chunks"

    # resurrection: a fresh client over the SAME identity; the store never
    # saw a result, so the job is re-served from the start
    resurrected = dep.client("clerk-0")
    done = resurrected.run_chores(-1)
    if done < 1:
        raise AssertionError("re-served job not found after mid-chunk death")
    clerks[1].run_chores(-1)
    aggregate = _reveal_exact(recipient, agg, _expected(values))
    return {"death": death, "resumed_jobs": done, "aggregate": aggregate}


def scenario_duplicate_replay_malformed(dep: Deployment, seed: int) -> dict:
    from ..protocol import AdditiveSharing, InvalidRequestError

    n = 6
    recipient, clerks, agg = _setup_round(
        dep, AdditiveSharing(share_count=2, modulus=MODULUS), _chacha()
    )
    participants = [dep.client(f"part-{i}") for i in range(n)]
    for c in participants:
        c.upload_agent()
    values = [[i, 1, i % 3, 0] for i in range(n)]
    built = [c.new_participations([v], agg.id)[0] for c, v in zip(participants, values)]

    # storm: every participation uploaded 3x concurrently (duplicate) ...
    errors: list = []

    def hammer(ix):
        try:
            for _ in range(3):
                participants[ix].service.create_participation(participants[ix].agent, built[ix])
        except Exception as e:  # noqa: BLE001
            errors.append((ix, repr(e)))

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"duplicate submissions were not absorbed: {errors}")

    # ... a delayed byte-identical replay (lost-response retry shape) ...
    participants[0].service.create_participation(participants[0].agent, built[0])

    # ... and a malformed submission: clerk-encryption list short of the
    # committee — must be rejected at the door, not at snapshot time
    broken = replace(built[1], clerk_encryptions=built[1].clerk_encryptions[:1])
    try:
        participants[1].service.create_participation(participants[1].agent, broken)
        raise AssertionError("malformed participation was accepted")
    except InvalidRequestError:
        pass

    recipient.end_aggregation(agg.id)
    for c in clerks:
        c.run_chores(-1)
    # exactness proves every duplicate/replay counted exactly once
    aggregate = _reveal_exact(recipient, agg, _expected(values))
    return {"participants": n, "uploads_per_participation": 4, "aggregate": aggregate}


class _RestView:
    """Deployment facade that routes EVERY client through a REST
    frontend URL — saturated-frontend uses it to put inproc cells behind
    an in-process frontend, so the 429 plane is exercised on all six
    store x transport cells."""

    def __init__(self, tmp: pathlib.Path, url: str, device=None):
        self.tmp = tmp
        self.url = url
        self.device = device

    def client(self, name: str):
        return persistent_client(
            self.tmp / f"id-{name}", http_client(self.tmp / f"tok-{name}", self.url), self.device
        )


def scenario_saturated_frontend(dep: Deployment, seed: int) -> dict:
    """A 429 storm: the runner pins SDA_REST_MAX_INFLIGHT=1 (+1 queued)
    around this cell, then 8 participants hammer the frontend with
    concurrent idempotent submissions.  The frontend must shed with
    429 + Retry-After (counted via the exempt /v1/metrics route), the
    backoff client must absorb every shed as a paced retry, and the
    round must reveal exactly — saturation degrades latency, never
    correctness."""
    from ..protocol import AdditiveSharing

    with contextlib.ExitStack() as ctx:
        if dep.transport == "rest":
            url = dep.url  # sdad subprocess inherited the admission env
        else:
            from ..rest import serve_background

            url = ctx.enter_context(serve_background(dep._server))
        view = _RestView(dep.tmp, url, dep.device)

        recipient, clerks, agg = _setup_round(
            view, AdditiveSharing(share_count=2, modulus=MODULUS), _chacha()
        )
        n = 8
        participants = [view.client(f"part-{i}") for i in range(n)]
        for c in participants:
            c.upload_agent()
        values = [[i, 1, (2 * i) % 5, 0] for i in range(n)]
        built = [c.new_participations([v], agg.id)[0] for c, v in zip(participants, values)]

        # the storm: every participant submits its (idempotent)
        # participation 4x from its own thread — bursts of 8 concurrent
        # requests against an admitted ceiling of 2
        barrier = threading.Barrier(n)
        errors: list = []

        def hammer(ix):
            try:
                barrier.wait()
                for _ in range(4):
                    participants[ix].service.create_participation(
                        participants[ix].agent, built[ix]
                    )
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append((ix, repr(e)))

        threads = [threading.Thread(target=hammer, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise AssertionError(f"storm submissions not absorbed: {errors}")

        # sheds, from the server's own registry over the exempt metrics
        # route — reachable even while the data plane is saturated
        text = _metric_text(url)
        sheds = sum(
            int(float(v)) for v in
            re.findall(r'^sda_rest_shed_total\{[^}]*\} (\S+)', text, re.M)
        )
        if sheds < 1:
            raise AssertionError("storm never tripped admission control (0 sheds)")

        recipient.end_aggregation(agg.id)
        for c in clerks:
            c.run_chores(-1)
        aggregate = _reveal_exact(recipient, agg, _expected(values))
    return {
        "participants": n,
        "storm_requests": 4 * n,
        "sheds": sheds,
        "aggregate": aggregate,
    }


def _handoff_queue_depth(dep: Deployment):
    """Current ``sda_shard_handoff_queue`` depth, however the cell is
    reachable: the router directly (in-proc) or the always-answering
    /v1/metrics route (rest subprocess)."""
    if dep.transport != "rest":
        return float(dep._server.shard_router.hint_depth())
    m = re.search(r"^sda_shard_handoff_queue(?:\{[^}]*\})? (\S+)", _metric_text(dep.url), re.M)
    return float(m.group(1)) if m else None


def scenario_kill_shard_mid_round(dep: Deployment, seed: int) -> dict:
    """The replicated plane's acceptance bar (runner deploys this cell
    with K=3, R=2): murder the aggregation's home store shard after
    ingest via the on-disk ``shard-NN.down`` marker — the same hook for
    an in-process server and a live sdad subprocess — and demand the
    snapshot, clerking, and reveal complete byte-exactly off the
    surviving replica. Then heal the shard, wait for hinted handoff to
    drain (scraped from sda_shard_handoff_queue), wedge the SURVIVOR
    instead, and demand a second exact reveal served by the repaired
    victim alone."""
    from ..protocol import AdditiveSharing
    from ..server.sharded import ShardRouter

    recipient, clerks, agg = _setup_round(
        dep, AdditiveSharing(share_count=2, modulus=MODULUS), _chacha()
    )
    participant = dep.client("part")
    participant.upload_agent()
    values = [[i % 5, i + 1, 2, (3 * i) % 7] for i in range(4)]
    participant.upload_participations(participant.new_participations(values, agg.id))

    # placement is a pure function of (K, R, id) — compute the home
    # shard locally instead of asking the (possibly remote) server
    victim, survivor = ShardRouter(dep.shards, replicas=dep.replicas).targets(agg.id)
    marker = pathlib.Path(ShardRouter.down_marker(str(dep.store_root), victim))
    hinted_while_down = 0.0
    expected = _expected(values)
    marker.touch()
    try:
        recipient.end_aggregation(agg.id)
        for c in clerks:
            c.run_chores(-1)
        aggregate = _reveal_exact(recipient, agg, expected)
        depth = _handoff_queue_depth(dep)
        hinted_while_down = 0.0 if depth is None else depth
        if not hinted_while_down:
            raise AssertionError(
                f"home shard was wedged but nothing was hinted (queue depth {depth!r})"
            )
    finally:
        marker.unlink()

    # healed: the background repair thread replays every hint
    t0 = time.monotonic()
    while True:
        if _handoff_queue_depth(dep) == 0.0:
            break
        if time.monotonic() - t0 > 30.0:
            raise AssertionError(
                f"handoff queue never drained; depth {_handoff_queue_depth(dep)!r}"
            )
        time.sleep(0.1)
    drain_s = round(time.monotonic() - t0, 2)

    # the proof of repair: the replayed victim carries the round alone
    smarker = pathlib.Path(ShardRouter.down_marker(str(dep.store_root), survivor))
    smarker.touch()
    try:
        _reveal_exact(recipient, agg, expected)
    finally:
        smarker.unlink()
    return {
        "shards": dep.shards,
        "replicas": dep.replicas,
        "victim": victim,
        "survivor": survivor,
        "hinted_while_down": hinted_while_down,
        "drain_s": drain_s,
        "aggregate": aggregate,
    }


def _setup_tier_round(dep, sharing, *, tiers: int, m: int, disjoint: bool, tag: str = "-tier"):
    """Provision a tiered aggregation over the deployment cell: recipient,
    clerk pool, derived tree + promoters via the client round driver."""
    from ..client import setup_tier_round
    from ..protocol import Aggregation, AggregationId, SodiumEncryptionScheme
    from ..protocol import tiers as tiers_mod

    recipient = dep.client(f"recipient{tag}")
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    n_nodes = sum(m**t for t in range(tiers))
    pool_size = sharing.output_size * n_nodes if disjoint else sharing.output_size
    pool = [dep.client(f"clerk{tag}-{i}") for i in range(pool_size)]
    for c in pool:
        c.upload_agent()
        c.upload_encryption_key(c.new_encryption_key())
    agg = Aggregation(
        id=AggregationId.random(),
        title=f"scenario{tag}",
        vector_dimension=DIM,
        modulus=MODULUS,
        recipient=recipient.agent.id,
        recipient_key=rkey,
        masking_scheme=_chacha(),
        committee_sharing_scheme=sharing,
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme(),
        sub_cohort_size=m,
        tiers=tiers,
    )
    round = setup_tier_round(
        recipient, agg, lambda name: dep.client(f"{tag}-{name}"), pool,
        disjoint_committees=disjoint,
    )
    return recipient, round, agg, tiers_mod


def scenario_sub_committee_clerk_killed(dep: Deployment, seed: int) -> dict:
    """One clerk of ONE sub-committee dies after ingest (never clerks,
    posts nothing — the vanish shape of vanish-after-sharing, one tier
    down): under share-promotion (the Shamir default) the surviving
    clerks re-issue their cached columns over the reduced survivor set
    (epoch 1), the parent's prepare stage keeps that epoch, and the ROOT
    total is byte-exact — a tier-local failure never poisons the
    hierarchy, and nobody reveals a partial along the way."""
    from ..client import run_tier_round
    from ..protocol import BasicShamirSharing

    sharing = BasicShamirSharing(share_count=3, privacy_threshold=1, prime_modulus=MODULUS)
    recipient, round, agg, _ = _setup_tier_round(
        dep, sharing, tiers=2, m=2, disjoint=True, tag="-subkill"
    )
    values = [[i % 5, (i + 2) % 5, 1, i % 3] for i in range(6)]
    for i, v in enumerate(values):
        p = dep.client(f"part-subkill-{i}")
        p.upload_agent()
        p.participate(v, agg.id)
    victim_node = round.nodes[1]
    killed = victim_node.clerks[0]
    # disjoint committees: the killed clerk serves no other node, so
    # dropping it from the drain IS its death — no result ever posted
    victim_node.clerks = victim_node.clerks[1:]
    result = run_tier_round(round, strict=True)
    expected = [int(v) for v in _expected(values)]
    aggregate = [int(v) for v in result.output.positive().values]
    if aggregate != expected:
        raise AssertionError(f"aggregate mismatch: got {aggregate}, want {expected}")
    return {
        "tiers": 2,
        "sub_cohorts": 2,
        "committee": sharing.output_size,
        "threshold": sharing.reconstruction_threshold,
        "killed_clerk": str(killed.agent.id),
        "killed_sub_committee": str(victim_node.aggregation.id),
        "skipped": [str(s) for s in result.skipped],
        "aggregate": aggregate,
    }


def scenario_tier_reshare_clerk_death(dep: Deployment, seed: int) -> dict:
    """Two-tier clerk-death matrix for the share-promotion path, both
    sides of the reconstruction threshold. Phase SURVIVE: one of three
    clerks dies (threshold 2) — the strict round re-issues from the
    survivors (epoch 1) and the root is byte-exact over ALL participants,
    with nothing skipped. Phase SKIP: two clerks die (below threshold) —
    the lenient round drops exactly that subtree and the root reveals the
    EXACT sum of the surviving sub-cohort's participants (never a
    silently wrong total). Both phases also hold the no-reveal shape:
    children never turn result_ready under share-promotion."""
    from ..client import run_tier_round
    from ..protocol import BasicShamirSharing

    def sharing():
        return BasicShamirSharing(share_count=3, privacy_threshold=1, prime_modulus=MODULUS)

    def run_phase(tag: str, kill: int, strict: bool):
        recipient, round, agg, tiers_mod = _setup_tier_round(
            dep, sharing(), tiers=2, m=2, disjoint=True, tag=tag
        )
        by_leaf: dict = {}
        for i in range(6):
            p = dep.client(f"part{tag}-{i}")
            p.upload_agent()
            v = [(i + seed) % 5, (3 * i) % 7, 2, i % 4]
            p.participate(v, agg.id)
            by_leaf.setdefault(tiers_mod.leaf_aggregation_id(agg, p.agent.id), []).append(v)
        victim_node = round.nodes[1]
        # disjoint committees: the killed clerks serve no other node, so
        # dropping them from the drain IS their death — their jobs are
        # never processed and no epoch-0 column ever lands
        victim_node.clerks = victim_node.clerks[kill:]
        result = run_tier_round(round, strict=strict)
        status = recipient.service.get_tier_status(recipient.agent, agg.id)
        if any(n.result_ready for n in status.nodes if n.tier > 0):
            raise AssertionError(
                "a share-promoted child sealed clerking results (something revealed a partial)"
            )
        return by_leaf, victim_node, result

    # phase SURVIVE: 2 of 3 clerks left >= threshold 2 -> epoch-1 reissue
    by_leaf, victim_node, result = run_phase("-reshare-live", 1, strict=True)
    if result.skipped:
        raise AssertionError(f"strict survivable round skipped {result.skipped}")
    full = [v for vals in by_leaf.values() for v in vals]
    expected = [int(v) for v in _expected(full)]
    aggregate = [int(v) for v in result.output.positive().values]
    if aggregate != expected:
        raise AssertionError(f"aggregate mismatch: got {aggregate}, want {expected}")

    # phase SKIP: 1 of 3 clerks left < threshold 2 -> subtree dropped,
    # root exact over the OTHER sub-cohort
    by_leaf, victim_node, skip_result = run_phase("-reshare-dead", 2, strict=False)
    if skip_result.skipped != [victim_node.aggregation.id]:
        raise AssertionError(
            f"expected skip of {victim_node.aggregation.id}, got {skip_result.skipped}"
        )
    survivors = [
        v for leaf, vals in by_leaf.items() if leaf != victim_node.aggregation.id for v in vals
    ]
    skip_expected = [sum(v[d] for v in survivors) % MODULUS for d in range(DIM)]
    skip_aggregate = [int(v) for v in skip_result.output.positive().values]
    if skip_aggregate != skip_expected:
        raise AssertionError(
            f"survivor aggregate mismatch: got {skip_aggregate}, want {skip_expected}"
        )
    return {
        "tiers": 2,
        "sub_cohorts": 2,
        "committee": 3,
        "threshold": 2,
        "survive_aggregate": aggregate,
        "skip_aggregate": skip_aggregate,
        "skip_lost_participations": len(by_leaf.get(victim_node.aggregation.id, [])),
        "skipped": [str(s) for s in skip_result.skipped],
    }


def scenario_sub_cohort_vanishes(dep: Deployment, seed: int) -> dict:
    """An ENTIRE sub-cohort vanishes after ingest (its sub-aggregation is
    deleted — the store-partition-death shape): the lenient round driver
    skips it and the root reveals the EXACT sum of the surviving
    sub-cohorts — degraded coverage, never a silently wrong total."""
    from ..client import run_tier_round
    from ..protocol import AdditiveSharing

    sharing = AdditiveSharing(share_count=2, modulus=MODULUS)
    recipient, round, agg, tiers_mod = _setup_tier_round(
        dep, sharing, tiers=2, m=2, disjoint=False, tag="-cohort"
    )
    by_leaf: dict = {}
    for i in range(6):
        p = dep.client(f"part-cohort-{i}")
        p.upload_agent()
        v = [i % 5, (2 * i) % 7, 3, 1]
        p.participate(v, agg.id)
        by_leaf.setdefault(tiers_mod.leaf_aggregation_id(agg, p.agent.id), []).append(v)
    # lose the busier sub-cohort — the harder half to survive
    victim_id = max(by_leaf, key=lambda leaf: len(by_leaf[leaf]))
    victim = round.node(victim_id)
    victim.owner.delete_aggregation(victim_id)
    result = run_tier_round(round, strict=False)
    if result.skipped != [victim_id]:
        raise AssertionError(f"expected skip of {victim_id}, got {result.skipped}")
    survivors = [v for leaf, vals in by_leaf.items() if leaf != victim_id for v in vals]
    expected = [sum(v[d] for v in survivors) % MODULUS for d in range(DIM)]
    aggregate = [int(v) for v in result.output.positive().values]
    if aggregate != expected:
        raise AssertionError(f"aggregate mismatch: got {aggregate}, want {expected}")
    # the tier-status route agrees: the vanished node is gone, the root
    # holds exactly the survivors' promotions and is result-ready
    status = recipient.service.get_tier_status(recipient.agent, agg.id)
    nodes = {n.aggregation: n for n in status.nodes}
    if nodes[victim_id].exists:
        raise AssertionError("vanished sub-aggregation still reported as existing")
    root = nodes[agg.id]
    if root.number_of_participations != len(by_leaf) - 1 or not root.result_ready:
        raise AssertionError(f"root status off: {root}")
    return {
        "tiers": 2,
        "sub_cohorts": 2,
        "vanished": str(victim_id),
        "lost_participations": len(by_leaf[victim_id]),
        "survived_participations": len(survivors),
        "aggregate": aggregate,
    }


SCENARIOS = {
    "register-never-submit": scenario_register_never_submit,
    "submit-mid-snapshot": scenario_submit_mid_snapshot,
    "vanish-after-sharing": scenario_vanish_after_sharing,
    "clerk-kill-mid-chunk": scenario_clerk_kill_mid_chunk,
    "duplicate-replay-malformed": scenario_duplicate_replay_malformed,
    "saturated-frontend": scenario_saturated_frontend,
    "kill-shard-mid-round": scenario_kill_shard_mid_round,
    "sub-committee-clerk-killed": scenario_sub_committee_clerk_killed,
    "tier-reshare-clerk-death": scenario_tier_reshare_clerk_death,
    "sub-cohort-vanishes": scenario_sub_cohort_vanishes,
}

#: deployment shape overrides (Deployment kwargs) per scenario
_SCENARIO_DEPLOY = {
    "kill-shard-mid-round": {"shards": 3, "replicas": 2},
}

#: stores a scenario is restricted to — kill-shard wedges partitions via
#: on-disk markers, which mem partitions (no root) cannot host
_SCENARIO_STORES = {
    "kill-shard-mid-round": ("file", "sqlite"),
}

#: per-scenario env the runner scopes around the cell (clerk-kill needs
#: the job column paged into several chunks to have a "mid-chunk")
_SCENARIO_ENV = {
    "clerk-kill-mid-chunk": {
        "SDA_JOB_PAGE_THRESHOLD": "0",
        "SDA_JOB_CHUNK_SIZE": "3",
    },
    # a tiny admission ceiling (1 executing + 1 queued) so an 8-wide
    # burst must shed; short Retry-After and a deep retry budget keep
    # the storm fast and every shed absorbable
    "saturated-frontend": {
        "SDA_REST_MAX_INFLIGHT": "1",
        "SDA_REST_QUEUE_HIGH_WATER": "1",
        "SDA_REST_RETRY_AFTER_S": "0.05",
        "SDA_REST_RETRIES": "8",
    },
    # fast repair passes so the drain wait is snappy; telemetry pinned on
    # because the rest cell scrapes the handoff gauge from /v1/metrics
    "kill-shard-mid-round": {
        "SDA_SHARD_HANDOFF_S": "0.1",
        "SDA_TELEMETRY": "1",
    },
}


@contextlib.contextmanager
def _scoped_env(extra: dict):
    saved = {k: os.environ.get(k) for k in extra}
    os.environ.update(extra)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- runner -----------------------------------------------------------------


def run_cell(name: str, store: str, transport: str, seed: int,
             artifacts: pathlib.Path, device=None) -> bool:
    t0 = time.monotonic()
    record = {
        "scenario": name,
        "store": store,
        "transport": transport,
        "seed": seed,
        "ok": False,
        "exact": False,
        "error": None,
        "details": None,
    }
    try:
        with tempfile.TemporaryDirectory() as td:
            with _scoped_env(_SCENARIO_ENV.get(name, {})):
                with Deployment(
                    store, transport, pathlib.Path(td), device=device,
                    **_SCENARIO_DEPLOY.get(name, {}),
                ) as dep:
                    record["details"] = SCENARIOS[name](dep, seed)
        record["ok"] = record["exact"] = True
    except Exception as e:  # noqa: BLE001 — recorded, run continues
        record["error"] = repr(e)
    record["elapsed_s"] = round(time.monotonic() - t0, 2)
    artifacts.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    path = artifacts / f"scenario-{name}-{stamp}-{store}-{transport}.json"
    path.write_text(json.dumps(record, indent=1))
    status = "OK  " if record["ok"] else "FAIL"
    print(
        f"[scenarios] {status} {name:<28} {store:<6} {transport:<6} "
        f"{record['elapsed_s']:6.1f}s -> {path.name}"
        + ("" if record["ok"] else f"  {record['error']}"),
        file=sys.stderr,
    )
    return record["ok"]


def run_overhead_ab(artifacts: pathlib.Path) -> bool:
    """Faults-off A/B of the retry layer: interleaved batches of pings
    against a REST mem deployment with retries enabled (default budget)
    vs disabled (SDA_REST_RETRIES=0, single-attempt loop). The delta is
    the pure bookkeeping cost of the hardened request path."""
    os.environ.pop("SDA_FAULTS", None)
    batches, batch = 10, 100
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        with Deployment("mem", "rest", tmp) as dep:
            service = dep.service_for("ab")
            service.ping()  # warm the connection pool
            t_on = t_off = 0.0
            for _ in range(batches):
                with _scoped_env({"SDA_REST_RETRIES": "4"}):
                    t0 = time.perf_counter()
                    for _ in range(batch):
                        service.ping()
                    t_on += time.perf_counter() - t0
                with _scoped_env({"SDA_REST_RETRIES": "0"}):
                    t0 = time.perf_counter()
                    for _ in range(batch):
                        service.ping()
                    t_off += time.perf_counter() - t0
    pct = (t_on - t_off) / t_off * 100.0
    record = {
        "requests_per_arm": batches * batch,
        "retries_enabled_s": round(t_on, 4),
        "retries_disabled_s": round(t_off, 4),
        "overhead_pct": round(pct, 2),
        "ok": pct < 2.0,
    }
    artifacts.mkdir(parents=True, exist_ok=True)
    path = artifacts / f"overhead-ab-{time.strftime('%Y%m%d-%H%M%S')}.json"
    path.write_text(json.dumps(record, indent=1))
    print(
        f"[scenarios] retry-layer overhead (faults off): {pct:+.2f}% "
        f"over {batches * batch} requests/arm -> {path.name}",
        file=sys.stderr,
    )
    return record["ok"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sda_tpu_torch.scripts.scenarios",
                                     description=__doc__.splitlines()[0])
    parser.add_argument(
        "--scenarios", default="all",
        help="comma list of scenario names, or 'all' "
        f"(know: {', '.join(SCENARIOS)})",
    )
    parser.add_argument("--stores", default=",".join(STORES))
    parser.add_argument("--transports", default=",".join(TRANSPORTS))
    parser.add_argument(
        "--artifacts", default=str(REPO / "bench-artifacts"),
        help="artifact directory (default: bench-artifacts/)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--overhead-ab", action="store_true",
        help="also run the retry-layer faults-off overhead A/B",
    )
    parser.add_argument("--list", action="store_true", help="list scenarios")
    parser.add_argument("--device", default="cuda",
                        help="the clients' torch device (default cuda; exits 2 without a GPU)")
    # clerk-kill-mid-chunk's dying clerk process: IDENTITY TOKENS URL KILL_AFTER
    parser.add_argument("--kill-child", nargs=4, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.list:
        for name in SCENARIOS:
            print(name)
        return 0

    names = list(SCENARIOS) if args.scenarios == "all" else [
        s.strip() for s in args.scenarios.split(",") if s.strip()
    ]
    unknown = [s for s in names if s not in SCENARIOS]
    if unknown:
        parser.error(f"unknown scenarios: {unknown} (know {list(SCENARIOS)})")
    stores = [s.strip() for s in args.stores.split(",") if s.strip()]
    transports = [t.strip() for t in args.transports.split(",") if t.strip()]
    device = device_or_exit("scenarios", args.device)
    if args.kill_child:
        identity, tokens, url, kill_after = args.kill_child
        kill_child(identity, tokens, url, int(kill_after), device)

    # the harness runs clean: stray fault injection would make failures
    # ambiguous (tests/test_torch_faults.py covers the faulted paths)
    os.environ.pop("SDA_FAULTS", None)

    artifacts = pathlib.Path(args.artifacts)
    results = {}
    for name in names:
        for store in stores:
            for transport in transports:
                if store not in _SCENARIO_STORES.get(name, STORES):
                    results[(name, store, transport)] = "skip"
                    print(
                        f"[scenarios] skip {name:<28} {store:<6} "
                        f"{transport:<6} (store not applicable)",
                        file=sys.stderr,
                    )
                    continue
                results[(name, store, transport)] = run_cell(
                    name, store, transport, args.seed, artifacts, device
                )
    ok = not any(r is False for r in results.values())
    if args.overhead_ab:
        ok = run_overhead_ab(artifacts) and ok

    # survivability matrix (this run; sweep_report.py rolls up all banked)
    print("\nsurvivability matrix (this run):")
    cols = [(s, t) for s in stores for t in transports]
    header = " ".join(f"{s[:3]}/{t[:4]:<4}" for s, t in cols)
    print(f"{'scenario':<28} {header}")

    def _cell(r):
        return "OK" if r is True else ("--" if r == "skip" else "FAIL")

    for name in names:
        cells = " ".join(f"{_cell(results[(name, s, t)]):<8}" for s, t in cols)
        print(f"{name:<28} {cells}")
    ran = [r for r in results.values() if r != "skip"]
    print(f"\nscenarios: {sum(r is True for r in ran)}/{len(ran)} cells green")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
