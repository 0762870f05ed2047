"""Entry points of the port: one single-device round and the multi-device dry
run of every fabric (counterpart of ``__graft_entry__.py``).

    python -m sda_tpu_torch.entry [N] [--device cpu]

``entry()`` returns the single-device round, a packed-Shamir secure sum
(share -> clerk-combine -> reconstruct) through
``TorchAggregator.secure_sum``, with example arguments.
``dryrun_multichip(n)`` runs every sharded fabric once over ``n`` ranks
(one process each: ``n`` cards with NCCL, or ``n`` gloo processes with
``device="cpu"``) and verifies each against the plain sum, printing one
``... OK`` line per fabric from rank 0 (``SKIPPED`` with the reason where a
fabric's mesh cannot be built at this ``n``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

DIM = 24
PARTICIPANTS = 16
SEED_WORDS = 4  # 128-bit ChaCha seeds, the reference's default seed_bitsize


def _scheme():
    from .protocol import PackedShamirSharing

    # the reference-verified p=433 test vector (full_loop.rs:56-64)
    return PackedShamirSharing(
        secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=433,
        omega_secrets=354, omega_shares=150,
    )


def entry(device=None):
    """``(fn, (secrets, generator))``: ``fn`` is the single-device round on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    from .parallel import TorchAggregator

    agg = TorchAggregator(_scheme(), DIM, device=device)

    def fn(secrets, generator):
        return agg.secure_sum(secrets, generator)

    rng = np.random.default_rng(0)
    secrets = torch.as_tensor(rng.integers(0, 433, size=(PARTICIPANTS, DIM)), device=agg.device)
    return fn, (secrets, torch.Generator(device=agg.device).manual_seed(0))


def _say(rank: int, text: str) -> None:
    if rank == 0:
        print(text, flush=True)


def _dryrun_rank(rank: int, n: int, device: str) -> None:
    """One rank's part of ``dryrun_multichip``: every rank draws the same
    global inputs from one seed and takes its block by mesh coordinate."""
    from .ops import find_packed_parameters
    from .ops.chacha_cuda import combine_masks_device
    from .ops.modular import positive
    from .parallel import TorchAggregator, full_training_step, make_mesh, make_plan, shard_participants
    from .parallel.engine import masked_sum, reconstruct
    from .parallel.limbmatmul import limb_recombine_host
    from .parallel.mesh import gather_over, shard_block
    from .parallel.multihost import hierarchical_secure_sum, make_hybrid_mesh, shard_participants_hybrid
    from .parallel.sumfirst import clerk_sums_from_limb_acc, sharded_value_limb_sums
    from .protocol import PackedShamirSharing

    # two mesh axes when possible: participants ("p") x dim batches ("d")
    d_size = 2 if n % 2 == 0 and n > 1 else 1
    p_size = n // d_size
    mesh = make_mesh(p_size=p_size, d_size=d_size, device=device)

    scheme = _scheme()
    m = scheme.prime_modulus
    k = scheme.secret_count
    dim = k * d_size * 4  # divisible by k * d_size
    P_total = p_size * 4

    rng = np.random.default_rng(0)
    secrets = rng.integers(0, m, size=(P_total, dim))
    want = secrets.sum(axis=0) % m
    _, step = full_training_step(scheme, dim, mesh)
    out, plain = step(shard_participants(secrets, mesh), 0)
    if not (np.array_equal(positive(out.cpu().numpy(), m), want)
            and np.array_equal(positive(plain.cpu().numpy(), m), want)):
        raise AssertionError("sharded aggregate != plaintext sum")
    _say(rank, f"dryrun_multichip OK: mesh p={p_size} d={d_size}, "
               f"{P_total} participants x {dim} dims, aggregate verified")

    # the server-side transpose as an all-to-all over every rank: shares
    # reshard from participant-major to clerk-major, each rank sums its own
    # clerk slice
    if scheme.share_count % n == 0 and P_total % n == 0:
        a2a_mesh = make_mesh(p_size=n, d_size=1, device=device)
        a2a = TorchAggregator(scheme, dim, mesh=a2a_mesh)
        local = a2a.sharded_clerk_sums_all_to_all()(shard_participants(secrets, a2a_mesh), 3)
        sums = gather_over(local, a2a_mesh, "p", dim=0).clone()
        # dropout: reconstruct from t+k of n clerk rows; the dropped clerk's
        # row is corrupted to show it is never read
        survivors = [i for i in range(scheme.share_count) if i != 1][: scheme.reconstruction_threshold]
        sums[1] = -7
        out_a2a = reconstruct(sums, survivors, scheme, dim)
        if not np.array_equal(positive(out_a2a.cpu().numpy(), m), want):
            raise AssertionError("all_to_all dropout aggregate != plaintext sum")
        _say(rank, f"dryrun all_to_all fabric OK: clerk-major reshard over p={n}, dropout "
                   f"reconstruction from {len(survivors)}/{scheme.share_count} clerk rows verified")
    else:
        _say(rank, f"dryrun all_to_all fabric SKIPPED: share_count {scheme.share_count} and "
                   f"{P_total} participants do not both divide over p={n}")

    # hybrid (h = nodes) x (p = devices per node) mesh, staged reduction
    if n % 2 == 0 and n > 1:
        h, pc = 2, n // 2
        hmesh = make_hybrid_mesh(h_size=h, p_size=pc, device=device)
        P_h = h * pc * 2
        secrets_h = rng.integers(0, m, size=(P_h, dim))
        _, hstep = hierarchical_secure_sum(scheme, dim, hmesh)
        hout, hplain = hstep(shard_participants_hybrid(secrets_h, hmesh), 1)
        want_h = secrets_h.sum(axis=0) % m
        if not (np.array_equal(positive(hout.cpu().numpy(), m), want_h)
                and np.array_equal(positive(hplain.cpu().numpy(), m), want_h)):
            raise AssertionError("hybrid-mesh aggregate != plaintext sum")
        _say(rank, f"dryrun hybrid mesh OK: h={h} x p={pc}, {P_h} participants")
    else:
        _say(rank, f"dryrun hybrid mesh SKIPPED: n={n} does not split into h=2 nodes")

    # wide-modulus (61-bit) limb accumulators summed over p, exact host recombine
    pw, w2, w3 = find_packed_parameters(k, scheme.privacy_threshold, scheme.share_count,
                                        min_modulus_bits=60, seed=1)
    wscheme = PackedShamirSharing(k, scheme.share_count, scheme.privacy_threshold, pw, w2, w3)
    wagg = TorchAggregator(wscheme, dim, mesh=mesh)
    secrets_w = rng.integers(pw - 10_000, pw, size=(P_total, dim)).astype(np.int64)
    acc = wagg.sharded_limb_accumulators()(shard_participants(secrets_w, mesh), 2)
    clerk_sums = limb_recombine_host(gather_over(acc, mesh, "d", dim=1), pw).T
    wout = reconstruct(torch.as_tensor(clerk_sums.copy()), range(wscheme.share_count), wscheme, dim)
    want_w = np.array([sum(int(v) for v in secrets_w[:, j]) % pw for j in range(dim)], dtype=np.int64)
    if not np.array_equal(positive(wout.numpy(), pw), want_w):
        raise AssertionError("wide sharded aggregate != plaintext sum")
    _say(rank, f"dryrun wide (61-bit) sharded path OK: p={p_size} d={d_size}")

    # sum-first: per-rank limb sums of [batched secrets | randomness], one
    # all_reduce over p, host epilogue; checked against the plain sum and
    # through the verification handle
    plan = make_plan(scheme, dim, wagg.device)
    acc_sf = sharded_value_limb_sums(plan, mesh)(shard_participants(secrets, mesh), 4)
    clerk_sf, vsum_sf = clerk_sums_from_limb_acc(gather_over(acc_sf, mesh, "d", dim=1), plan)
    out_sf = reconstruct(torch.as_tensor(clerk_sf), range(scheme.share_count), scheme, dim)
    if not np.array_equal(positive(out_sf.numpy(), m), want):
        raise AssertionError("sum-first sharded aggregate != plaintext sum")
    if not np.array_equal(vsum_sf[:, :k], want.reshape(plan.n_batches, k)):
        raise AssertionError("sum-first verification handle != batched plaintext sums")
    _say(rank, f"dryrun sum-first fabric OK: limb accumulator psum over p={p_size}, "
               "epilogue clerk sums reconstruct + verification handle checked")

    # ChaCha masking: each rank masks its participants with their seeds'
    # expansion, the recipient re-expands every seed (combine_masks_device)
    seeds = rng.integers(0, 1 << 32, size=(P_total, SEED_WORDS), dtype=np.uint64).astype(np.uint32)
    my_seeds = shard_block(seeds.astype(np.int64), mesh, ("p",), col_axis=None)
    total = masked_sum(shard_block(secrets, mesh, ("p",), col_axis=None), my_seeds, m, mesh)
    combined = combine_masks_device(seeds, dim, m, device=my_seeds.device)
    out_masked = torch.remainder(total - combined, m)
    if not np.array_equal(out_masked.cpu().numpy(), want):
        raise AssertionError("chacha-masked sharded aggregate != plaintext sum")
    _say(rank, f"dryrun chacha masking fabric OK: device expansion over p={p_size}, "
               f"{P_total} seeds re-expanded at reveal, unmasked aggregate verified")


def dryrun_multichip(n: int, device=None) -> None:
    """Every sharded fabric once over ``n`` ranks, each verified against the
    plain sum. CUDA (the default) needs ``n`` cards and runs NCCL;
    ``device="cpu"`` runs ``n`` gloo processes."""
    from .device import resolve_device
    from .parallel.multihost import spawn_ranks

    dev = resolve_device(device)
    spawn_ranks(_dryrun_rank, n, dev, args=(dev.type,))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", nargs="?", type=int, default=8, help="ranks of the dry run")
    parser.add_argument("--device", default=None, help="cpu, or CUDA when omitted")
    args = parser.parse_args(argv)
    fn, (secrets, generator) = entry(args.device)
    out = fn(secrets, generator).cpu().numpy() % 433
    if not np.array_equal(out, secrets.cpu().numpy().sum(axis=0) % 433):
        raise AssertionError("entry round != plaintext sum")
    print("entry OK: single-device round verified", flush=True)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
