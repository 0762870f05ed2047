"""The baseline ladder's device rows on the card (counterpart of the
``--device`` mode of ``scripts/baseline_ladder.py``).

    python -m sda_tpu_torch.baseline_ladder [--configs 2,3,4] [--quick] [--out FILE] [--device cpu]

Each row is the math plane of one ``BASELINE.md`` target config, streamed in
chunks and verified against an independent plain sum on the host:

- ``2``: additive 3-way sharing at dim 100,000 and p = 4,294,967,291 (the
  largest 32-bit prime, so the int64 share path: no kernel), 1,000
  participants: per chunk ``share_participants`` and ``clerk_combine_mod``
  into an accumulator kept canonical mod p on the device, then the additive
  reconstruction over the three clerks;
- ``3``: basic Shamir t=2, n=5 at p = 1,048,583, dim 10,000, 10,000
  participants, through ``engine.share_combine_limb_streamed``: on the card
  the fused limb kernel K1 (``limb_cuda``) once per 2,000-row chunk; the
  ``(L, nb, n)`` limb partials summed in int64 across chunks, recombined on
  the device and reconstructed by Lagrange from clerks 0, 2 and 4;
- ``4``: packed Shamir k=5, t=2, n=8 (30-bit p) at dim 50,000 and 100,000
  participants through the sum-first engine (``value_limb_sums_chunk``),
  the limb accumulator kept on the device; clerk 3's row is set to -7 and
  the aggregate reconstructed from the other seven clerks.

Every row keeps the reference's scheme, modulus, dimension, chunk and numpy
seed, so it sums the same secrets. The secrets are drawn on the host, chunk
by chunk, and copied over, as in the reference: the host's plain sum of the
same arrays is the row's independent check.

``--quick`` divides the participant counts by 100. Each row stops between
chunks once its budget (``SDA_LADDER_BUDGET`` seconds, default 300) is
spent, after at least one chunk, and is then marked ``"partial": true`` and
still verified. A watchdog re-armed before every row
(``SDA_LADDER_DEADLINE`` seconds, default 900) prints the rows done so far
and exits 3. A row that raises is recorded as ``{"config": name, "error":
...}`` and the ladder goes on. The JSON payload is printed, and written to
``--out``; the exit code is 0 only if every row is verified and
error-free, else 1 (2 when there is no GPU and no ``--device cpu``).

The rows run on CUDA unless ``--device cpu`` is given; without a GPU the
ladder exits before any row runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .bench import card_and_power_limit
from .device import resolve_device
from .ops import chacha_cuda, find_packed_parameters
from .ops.modular import positive
from .parallel import limb_cuda, make_plan
from .parallel.engine import clerk_combine_mod, reconstruct, share_combine_limb_streamed, share_participants
from .parallel.limbmatmul import limb_recombine
from .parallel.sumfirst import clerk_sums_from_limb_acc, reconstruct_from_clerk_sums, value_limb_sums_chunk
from .protocol import AdditiveSharing, BasicShamirSharing, PackedShamirSharing

#: participants per row at full size (``--quick`` divides them by 100)
PARTICIPANTS = {"2": 1_000, "3": 10_000, "4": 100_000}
#: rows per streamed chunk: the reference's (an upper bound: a row never
#: takes more than its participant count)
CHUNKS = {"2": 500, "3": 2_000, "4": 2_000}
#: config 4's clerk whose row is corrupted and never read
DROPPED_CLERK = 3
BUDGET_S, DEADLINE_S = 300.0, 900.0


def _stream(name, n_participants, dim, p, seed, dev, budget, step):
    """The rows' loop: per chunk, ``CHUNKS[name]`` rows of secrets drawn on
    the host from ``default_rng(seed)`` (int64, as the reference draws
    them), copied to ``dev`` as they are and handed to ``step``, and the
    host's plain int64 sum of the same rows (exact: participants * p <
    2^63). Stops between chunks once ``budget`` seconds are spent, after at
    least one. The int64 copy is kept rather than narrowed to int32 on the
    host for p < 2^31: the device narrows in a pass of its own, which costs
    less than numpy's ``astype`` over the chunk.

    Returns ``(t0, done, plain, split)``: the start of the row's clock, the
    rows streamed, the plain sum, and where the loop's time went: host
    draws, host plain sums, and on CUDA the device's time from each chunk's
    copy to the end of its step (CUDA events; ``None`` off CUDA)."""
    chunk = min(CHUNKS[name], n_participants)
    rng = np.random.default_rng(seed)
    plain = np.zeros(dim, dtype=np.int64)
    split = {"host_draw_s": 0.0, "host_plain_s": 0.0}
    marks = []
    done = 0
    t0 = time.perf_counter()
    while done < n_participants and not (
        budget is not None and done > 0 and time.perf_counter() - t0 > budget
    ):
        c = min(chunk, n_participants - done)
        t = time.perf_counter()
        secrets = rng.integers(0, p, size=(c, dim))
        split["host_draw_s"] += time.perf_counter() - t
        if dev.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        step(torch.as_tensor(secrets, device=dev))
        if dev.type == "cuda":
            events[1].record()
            marks.append(events)
        t = time.perf_counter()
        plain += secrets.sum(axis=0)
        split["host_plain_s"] += time.perf_counter() - t
        done += c
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    split["device_s"] = sum(a.elapsed_time(b) for a, b in marks) / 1e3 if marks else None
    return t0, done, plain, split


def _row(config, t0, done, n_participants, dim, dev, verified, split, **extra) -> dict:
    """A row's line: the reference's keys, then the port's (kernel
    launches since the row began, where the loop's time went)."""
    wall = time.perf_counter() - t0
    out = {
        "config": config,
        "plane": "device-fabric (share arithmetic; transport priced by the host row)",
        "backend": dev.type,
        "wall_s": wall,
        "participants": done,
        "elements": done * dim,
        "elements_per_s": done * dim / wall,
        "verified": verified,
        **extra,
        "launches": {"limb_share_sum": limb_cuda.launches, "chacha20": chacha_cuda.launches},
        **split,
    }
    if split["device_s"] is not None:
        out["device_share"] = split["device_s"] / wall
    if done < n_participants:
        out["partial"] = True
    return out


def config2_step(acc, secrets, generator, plan, draw=None):
    """One config-2 chunk: additive shares of the ``(C, dim)`` secrets (n-1
    draws and the closing share), the clerk sums mod p, added to the
    ``(n, dim)`` accumulator and reduced (the reference's ``lax.rem``, a
    truncated remainder: ``fmod``)."""
    shares = share_participants(secrets, generator, plan, draw=draw)  # (C, n, dim)
    return torch.fmod(acc + clerk_combine_mod(shares, plan.modulus), plan.modulus)


def config2_device(n_participants: int, device=None, budget: float | None = None) -> dict:
    """Config 2's math plane: additive 3-way sharing at a 32-bit prime,
    verified against the host's plain sum mod p."""
    dev = resolve_device(device)
    dim, p = 100_000, 4294967291  # same shape and modulus as the host row
    scheme = AdditiveSharing(share_count=3, modulus=p)
    plan = make_plan(scheme, dim, dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    acc = torch.zeros((scheme.share_count, dim), dtype=torch.int64, device=dev)
    limb_cuda.launches = chacha_cuda.launches = 0

    def step(secrets):
        nonlocal acc
        acc = config2_step(acc, secrets, gen, plan)

    t0, done, plain, split = _stream("2", n_participants, dim, p, 12, dev, budget, step)
    got = positive(reconstruct(acc, range(3), scheme, dim), p).cpu().numpy()
    return _row(f"2-device: additive-3 share fabric, dim 100K, {n_participants} participants, 32-bit",
                t0, done, n_participants, dim, dev, bool(np.array_equal(got, plain % p)), split)


def config3_device(n_participants: int, device=None, budget: float | None = None) -> dict:
    """Config 3's math plane: basic-Shamir t=2, n=5 shares through the fused
    limb path, a streamed participant reduction, device Lagrange
    reconstruction from the strict survivor subset [0, 2, 4]."""
    dev = resolve_device(device)
    t, n = 2, 5
    p = 1048583  # same 21-bit prime as the host row
    scheme = BasicShamirSharing(share_count=n, privacy_threshold=t, prime_modulus=p)
    dim = 10_000
    plan = make_plan(scheme, dim, dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    # the int64 partial sums stay below participants * L*K*127^2 (1.45e9 at
    # 10,000), inside limb_recombine's 2^31 per limb
    acc = None
    limb_cuda.launches = chacha_cuda.launches = 0

    def step(secrets):
        nonlocal acc
        a = share_combine_limb_streamed(secrets, gen, plan)  # (L, nb, n); K1 on the card
        acc = a if acc is None else acc + a

    t0, done, plain, split = _stream("3", n_participants, dim, p, 13, dev, budget, step)
    clerk_sums = limb_recombine(acc, p).T  # (n, nb)
    survivors = [0, 2, 4]  # strict t+1 = 3 of 5
    got = positive(reconstruct(clerk_sums, survivors, scheme, dim), p).cpu().numpy()
    return _row(f"3-device: basic-Shamir t=2 n=5 limb fabric, dim 10K, {n_participants} participants",
                t0, done, n_participants, dim, dev, bool(np.array_equal(got, plain % p)), split,
                survivor_subset=survivors)


def config4_scheme() -> PackedShamirSharing:
    k, t, n = 5, 2, 8
    p, w2, w3 = find_packed_parameters(k, t, n, min_modulus_bits=30, seed=0)
    return PackedShamirSharing(k, n, t, p, w2, w3)


def dropout_reveal(clerk_sums, scheme, dim: int) -> np.ndarray:
    """The aggregate from the first ``t+k`` clerk rows other than
    ``DROPPED_CLERK``'s (which is never read), canonical, on the host."""
    survivors = [i for i in range(scheme.share_count) if i != DROPPED_CLERK][: scheme.reconstruction_threshold]
    return positive(np.asarray(reconstruct_from_clerk_sums(clerk_sums, survivors, scheme, dim)),
                    scheme.prime_modulus)


def config4(n_participants: int, device=None, budget: float | None = None) -> dict:
    """Config 4: packed Shamir with clerk dropout through the sum-first
    engine, one clerk row corrupted and dropped."""
    dev = resolve_device(device)
    scheme = config4_scheme()
    p = scheme.prime_modulus
    dim = 50_000
    plan = make_plan(scheme, dim, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    acc = None  # the (1, nb, K) limb accumulator, on the device
    limb_cuda.launches = chacha_cuda.launches = 0

    def step(secrets):
        nonlocal acc
        a = value_limb_sums_chunk(secrets, gen, plan)  # (1, nb, k+t) exact limb sums
        acc = a if acc is None else acc + a

    t0, done, plain, split = _stream("4", n_participants, dim, p, 4, dev, budget, step)
    clerk_sums, _ = clerk_sums_from_limb_acc(acc, plan)
    clerk_sums[DROPPED_CLERK] = -7
    got = dropout_reveal(clerk_sums, scheme, dim)
    return _row(f"4: packed Shamir dropout, dim 50K, {n_participants} participants (sum-first fabric)",
                t0, done, n_participants, dim, dev, bool(np.array_equal(got, plain % p)), split,
                dropped_clerk_row=DROPPED_CLERK)


#: config name -> row function ``(n_participants, device, budget) -> dict``
ROWS = {"2": config2_device, "3": config3_device, "4": config4}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m sda_tpu_torch.baseline_ladder",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--quick", action="store_true", help="participant counts / 100 (smoke)")
    parser.add_argument("--configs", default="2,3,4", help="comma-separated subset of 2,3,4")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA; exits 2 without a GPU)")
    args = parser.parse_args(argv)
    args.configs = [c.strip() for c in args.configs.split(",")]
    bad = [c for c in args.configs if c not in ROWS]
    if bad:
        parser.error(f"--device supports configs 2,3,4 only (got {','.join(bad)}); "
                     "run host-only configs without --device")
    return args


def _dump(results: dict, out) -> None:
    payload = json.dumps(results, indent=1)
    print(payload, flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(payload + "\n")


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"baseline_ladder: {exc}", file=sys.stderr)
        return 2
    div = 100 if args.quick else 1
    budget = float(os.environ.get("SDA_LADDER_BUDGET", BUDGET_S))
    deadline = float(os.environ.get("SDA_LADDER_DEADLINE", DEADLINE_S))
    card, power_limit = card_and_power_limit(dev)
    results = {"quick": args.quick, "backend": dev.type, "card": card,
               "power_limit": power_limit, "configs": []}

    def wedged():
        results["watchdog"] = (f"deadline {deadline:.0f}s hit (device wedged mid-config?); "
                               "partial results dumped")
        _dump(results, args.out)
        os._exit(3)

    watchdog = None
    try:
        for name in args.configs:
            print(f"[ladder] running config {name}...", file=sys.stderr, flush=True)
            if watchdog is not None:
                watchdog.cancel()
            watchdog = threading.Timer(deadline, wedged)
            watchdog.daemon = True
            watchdog.start()
            t0 = time.perf_counter()
            try:
                entry = ROWS[name](PARTICIPANTS[name] // div, dev, budget)
            except Exception as exc:  # noqa: BLE001 - record the failure, keep laddering
                traceback.print_exc()
                entry = {"config": name, "error": f"{type(exc).__name__}: {exc}"}
            print(f"[ladder] config {name} done in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
            results["configs"].append(entry)
    finally:
        if watchdog is not None:
            watchdog.cancel()
    _dump(results, args.out)
    ok = all(c.get("verified", False) and "error" not in c for c in results["configs"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
