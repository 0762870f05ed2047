"""Randomized protocol soak: N full in-process rounds across the scheme
matrix (random sharing/masking/shape/cohort), asserting the exact modular
sum each time (counterpart of ``scripts/soak.py``).

Usage:  python -m sda_tpu_torch.scripts.soak [N] [--device cpu]
        (default 200 rounds; clients on CUDA unless ``--device cpu``,
        exit 2 without a GPU)
Exit 0 = every round exact; 1 = any failure (seeds printed, reproducible
via ``random_round(seed, tmp)``, on CUDA unless ``device="cpu"`` is
passed).

``random_round`` draws its configuration from ``np.random.default_rng(seed)``
in the reference's order (dim, cohort, scheme kind and its parameters,
masking, the values, the committee members kept), so one seed names the
same round in both packages.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

import numpy as np

from . import device_or_exit


def random_round(seed: int, tmp_path, kind=None, dim=None, n_participants=None,
                 keep_min=False, device=None) -> dict:
    """One random round through ``new_mem_server``; raises AssertionError
    unless the reveal is the exact sum mod p. Returns the configuration
    drawn: ``seed, kind, mask, dim, n, participants, kept, modulus``.
    ``device`` goes through ``resolve_device``: CUDA by default, and it
    raises without a GPU rather than run on the host."""
    from ..client import SdaClient
    from ..crypto import Keystore
    from ..device import resolve_device
    from ..ops import find_packed_parameters
    from ..protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        BasicShamirSharing,
        ChaChaMasking,
        FullMasking,
        NoMasking,
        PackedShamirSharing,
        SodiumEncryptionScheme,
    )
    from ..server import new_mem_server

    device = resolve_device(device)
    tmp_path = pathlib.Path(tmp_path)
    rng = np.random.default_rng(seed)
    if dim is None:
        dim = int(rng.integers(1, 41))
    if n_participants is None:
        n_participants = int(rng.integers(1, 6))
    if kind is None:
        kind = str(rng.choice(["additive", "basic", "packed", "packed_gen"]))
    if kind == "additive":
        n = int(rng.integers(2, 6))
        modulus = 433
        sharing = AdditiveSharing(share_count=n, modulus=modulus)
    elif kind == "basic":
        n = int(rng.integers(3, 8))
        t = int(rng.integers(1, n - 1))
        modulus = 433
        sharing = BasicShamirSharing(n, t, modulus)
    elif kind == "packed":
        sharing, modulus = PackedShamirSharing(3, 8, 4, 433, 354, 150), 433
        n = sharing.share_count
    else:
        k, t, n = 5, 2, 8
        p, w2, w3 = find_packed_parameters(k, t, n, min_modulus_bits=20, seed=seed)
        sharing, modulus = PackedShamirSharing(k, n, t, p, w2, w3), p

    mask = str(rng.choice(["none", "full", "chacha"]))
    masking = {
        "none": NoMasking(),
        "full": FullMasking(modulus=modulus),
        "chacha": ChaChaMasking(modulus=modulus, dimension=dim, seed_bitsize=128),
    }[mask]

    service = new_mem_server()

    def new_client(path):
        keystore = Keystore(path)
        return SdaClient(SdaClient.new_agent(keystore), keystore, service, device=device)

    recipient = new_client(tmp_path / f"r{seed}")
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    members = [new_client(tmp_path / f"m{seed}-{i}") for i in range(n)]
    for m in members:
        m.upload_agent()
        m.upload_encryption_key(m.new_encryption_key())

    agg = Aggregation(
        id=AggregationId.random(), title=f"fuzz-{seed}",
        vector_dimension=dim, modulus=modulus,
        recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=masking, committee_sharing_scheme=sharing,
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme(),
    )
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)

    vecs = rng.integers(0, modulus, size=(n_participants, dim))
    for i in range(n_participants):
        part = new_client(tmp_path / f"p{seed}-{i}")
        part.upload_agent()
        part.participate(vecs[i].tolist(), agg.id)
    recipient.end_aggregation(agg.id)

    # committee-aware dropout: keep a random minimal-or-larger subset
    committee = service.get_committee(recipient.agent, agg.id)
    member_ids = [cid for cid, _ in committee.clerks_and_keys]
    need = sharing.reconstruction_threshold
    keep = need if keep_min else int(rng.integers(need, len(member_ids) + 1))
    chosen = list(rng.choice(len(member_ids), size=keep, replace=False))
    workers = {c.agent.id: c for c in [recipient] + members}
    for ix in chosen:
        workers[member_ids[ix]].run_chores(-1)

    got = np.asarray(recipient.reveal_aggregation(agg.id).positive().values)
    want = (vecs.astype(object).sum(axis=0) % modulus).astype(np.int64)
    drawn = {"seed": seed, "kind": kind, "mask": mask, "dim": dim, "n": n,
             "participants": n_participants, "kept": keep, "modulus": modulus}
    if not np.array_equal(got, want):
        raise AssertionError(f"inexact reveal: {drawn}")
    return drawn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sda_tpu_torch.scripts.soak",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=200,
                    help="random rounds to run (default 200)")
    ap.add_argument("--device", default="cuda",
                    help="the clients' torch device (default cuda; exits 2 without a GPU)")
    args = ap.parse_args(argv)
    device = device_or_exit("soak", args.device)

    n = args.n
    fails = []
    for seed in range(n):
        try:
            with tempfile.TemporaryDirectory() as td:
                random_round(10_000 + seed, pathlib.Path(td), device=device)
        except Exception as e:  # noqa: BLE001 - report and continue
            fails.append(seed)
            print(f"FAIL seed={10_000 + seed}: {e!r}", file=sys.stderr)
        if (seed + 1) % 50 == 0:
            print(f"[soak] {seed + 1}/{n} rounds, {len(fails)} failures", file=sys.stderr)
    print(f"soak: {n - len(fails)}/{n} random rounds exact")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
