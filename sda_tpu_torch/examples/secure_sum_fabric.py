"""Runnable demo: the aggregation fabric itself, on the card (counterpart of
``examples/secure_sum_fabric.py``).

    python -m sda_tpu_torch.examples.secure_sum_fabric [--device cpu] [--ranks N]

Three stages, each verified against an independent plaintext sum:

1. single-device secure sum: per-participant packed-Shamir shares built on
   the device (int8-limb products), clerk-combined, reconstructed;
2. sum-first streaming: share linearity (``share(sum v) = sum share(v)``)
   reduces the hot loop to one exact limb-space integer reduction; a clerk
   row is corrupted and dropped to show that t+k-of-n reconstruction never
   reads it;
3. the sharded fabric: the same sum-first loop over a mesh of ranks
   (participants sharded over ``p``, dims over ``d``), one int64
   ``all_reduce`` carrying the tiny accumulator across the mesh, gathered
   over ``d`` before the reveal.

Stages 1 and 2 run in this process on its device; stage 3 in one process
per rank (``multihost.spawn_ranks``): on the card one per visible CUDA device
over NCCL, with ``--device cpu`` 8 gloo ranks unless ``--ranks`` says
otherwise. The mesh is fitted as the reference fits it to its devices:
``d = 2`` with at least 2 ranks, ``p = min(4, ranks // d)``. The scheme (k=5,
t=2, n=8, 30-bit p), the dimension and the numpy draws are the reference's,
so each stage prints the reference's line. Without a GPU and without
``--device cpu`` it exits 2 before any stage runs.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import find_packed_parameters
from ..ops.modular import positive
from ..parallel import TorchAggregator, make_mesh, make_plan, shard_participants, sharded_value_limb_sums
from ..parallel.mesh import gather_over, mesh_device
from ..parallel.multihost import spawn_ranks
from ..parallel.sumfirst import clerk_sums_from_limb_acc, reconstruct_from_clerk_sums, value_limb_sums_chunk
from ..protocol import PackedShamirSharing

DIM = 2_000
CPU_RANKS = 8  # the reference's 8 virtual CPU devices


def _scheme() -> PackedShamirSharing:
    # packed Shamir: k=5 secrets per batch, privacy threshold t=2, n=8 clerks,
    # a 30-bit prime with the radix-2/radix-3 roots the NTT domains need
    k, t, n = 5, 2, 8
    p, w2, w3 = find_packed_parameters(k, t, n, min_modulus_bits=30, seed=0)
    return PackedShamirSharing(k, n, t, p, w2, w3)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# participants per stage, each stage's rows drawn from ``default_rng(0)``
# in this order
STAGE1_PARTICIPANTS = 256
STAGE2_CHUNK, STAGE2_CHUNKS = 512, 4
STAGE3_PARTICIPANTS = 1_024


def _stage3_shard(p: int) -> np.ndarray:
    """Stage 3's ``(1024, DIM)`` secrets, replayed from ``default_rng(0)``
    call by call as ``run`` draws them. The ranks replay them rather than
    receive them: a spawned rank reads its arguments only after its
    imports, so a large argument would start the ranks one after another."""
    rng = np.random.default_rng(0)
    rng.integers(0, p, size=(STAGE1_PARTICIPANTS, DIM))
    for _ in range(STAGE2_CHUNKS):
        rng.integers(0, p, size=(STAGE2_CHUNK, DIM))
    return rng.integers(0, p, size=(STAGE3_PARTICIPANTS, DIM))


def _sharded_rank(rank: int, world: int, device: str, p_size: int, d_size: int):
    """Stage 3 on one rank: this rank's block of the secrets through the
    sharded sum-first fabric; rank 0 returns the accumulator gathered over
    ``d`` as a host array."""
    mesh = make_mesh(p_size=p_size, d_size=d_size, device=device)
    scheme = _scheme()
    shard = _stage3_shard(scheme.prime_modulus)
    plan = make_plan(scheme, DIM, mesh_device(mesh))
    fabric = sharded_value_limb_sums(plan, mesh)
    acc = gather_over(fabric(shard_participants(shard, mesh), 3), mesh, "d", dim=1)
    return acc.cpu().numpy() if rank == 0 else None


def run(device=None, ranks: int | None = None) -> None:
    """The three stages on ``device`` (CUDA unless the caller asks for the
    CPU), stage 3 over ``ranks`` processes; prints one line per stage and
    raises ``AssertionError`` on a wrong aggregate."""
    dev = resolve_device(device)
    if ranks is None:
        ranks = torch.cuda.device_count() if dev.type == "cuda" else CPU_RANKS
    scheme = _scheme()
    n, p = scheme.share_count, scheme.prime_modulus
    rng = np.random.default_rng(0)

    # --- 1. single-device secure sum ------------------------------------
    secrets = rng.integers(0, p, size=(STAGE1_PARTICIPANTS, DIM))
    agg = TorchAggregator(scheme, DIM, device=dev, use_limbs=True)
    out = agg.secure_sum(secrets, torch.Generator(device=dev).manual_seed(1))
    _check(np.array_equal(positive(out.cpu().numpy(), p), secrets.sum(axis=0) % p),
           "stage 1: the secure sum differs from the plain sum")
    print(f"1. single-device secure sum OK: {STAGE1_PARTICIPANTS} x {DIM}, p={p}", flush=True)

    # --- 2. sum-first streaming + clerk dropout -------------------------
    plan = make_plan(scheme, DIM, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    acc, plain = None, np.zeros(DIM, dtype=np.int64)
    for _ in range(STAGE2_CHUNKS):
        chunk = rng.integers(0, p, size=(STAGE2_CHUNK, DIM))
        a = value_limb_sums_chunk(torch.as_tensor(chunk, device=dev), gen, plan)
        acc = a if acc is None else acc + a
        plain += chunk.sum(axis=0)
    clerk_sums, _ = clerk_sums_from_limb_acc(acc, plan)
    clerk_sums[3] = -7  # corrupt the dropped clerk: must never be read
    survivors = [i for i in range(n) if i != 3][: scheme.reconstruction_threshold]
    out = reconstruct_from_clerk_sums(clerk_sums, survivors, scheme, DIM)
    _check(np.array_equal(positive(np.asarray(out), p), plain % p),
           "stage 2: the dropout reveal differs from the plain sum")
    print(f"2. sum-first stream OK: {STAGE2_CHUNK * STAGE2_CHUNKS} participants, clerk 3 dropped, "
          f"reconstructed from {len(survivors)} of {n} clerk sums", flush=True)

    # --- 3. the sharded fabric over a mesh of ranks ---------------------
    d_size = 2 if ranks >= 2 else 1  # dim axis: k*d must divide dim
    p_size = min(4, ranks // d_size)
    shard = rng.integers(0, p, size=(STAGE3_PARTICIPANTS, DIM))
    acc = spawn_ranks(_sharded_rank, p_size * d_size, dev, args=(dev.type, p_size, d_size))[0]
    clerk_sums, _ = clerk_sums_from_limb_acc(acc, plan)
    out = reconstruct_from_clerk_sums(clerk_sums, range(n), scheme, DIM)
    _check(np.array_equal(positive(np.asarray(out), p), shard.sum(axis=0) % p),
           "stage 3: the sharded aggregate differs from the plain sum")
    print(f"3. sharded fabric OK: mesh p={p_size} x d={d_size}, "
          "limb accumulator psum'd across the mesh, aggregate verified", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sda_tpu_torch.examples.secure_sum_fabric",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA; exits 2 without a GPU)")
    parser.add_argument("--ranks", type=int, default=None,
                        help="stage 3's processes (default: the visible cards, or 8 with --device cpu)")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"secure_sum_fabric: {exc}", file=sys.stderr)
        return 2
    run(args.device, args.ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
