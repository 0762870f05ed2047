#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own line:

1. device: needs CUDA (exits nonzero without it); prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles every kernel from ``sda_tpu_torch/csrc`` (seconds, and
   ptxas' register/spill report);
3. parity: each kernel against its plain PyTorch version on the card, at the
   main path's full-width shape and at ragged shapes, bit-identical;
4. main path: one packed-Shamir secure-sum round of 100,000 participants x
   10,000 dims streamed in chunks of 2,000 through ``share_combine_limb_cuda``
   (the bench scheme: k=5, t=2, n=8, 31-bit p), revealed from clerks 1..7 and
   held against an independent int64 sum on the card; then
   ``TorchAggregator.secure_sum`` on its int64 and limb paths;
5. numbers: launch counts of the main-path run, kernel and plain times per
   chunk (CUDA events), the bound, the round's wall time.

Then the ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Any failed phase raises, and the script exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8 tensor-core ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

PARTICIPANTS, DIM, CHUNK = 100_000, 10_000, 2_000
K_SECRETS, THRESHOLD, CLERKS = 5, 2, 8


def _line(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


PROFILE_CHUNKS = 5


def _profile_chunks(step, chunks: int) -> None:
    """Where one streamed chunk's device time goes: ``torch.profiler`` over a
    few chunks of the main path (after its launch counts were read), kernel
    time by name and the device's busy share of the window's wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        _line("profile", chunks=chunks, wall_ms=wall_ms, device_time="not measured")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    _line("profile", chunks=chunks, wall_ms=wall_ms, device_busy_ms=busy_ms,
          busy_share=busy_ms / wall_ms, kernels=[
              {"name": e.key[:70], "ms_per_chunk": e.self_device_time_total / 1e3 / chunks,
               "count": e.count, "share": e.self_device_time_total / 1e3 / busy_ms}
              for e in top])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sda_tpu_torch import kernels
    from sda_tpu_torch.ops import find_packed_parameters
    from sda_tpu_torch.ops.modular import positive
    from sda_tpu_torch.ops.rng import uniform_bits_device_narrow
    from sda_tpu_torch.parallel import TorchAggregator, limb_cuda, make_plan
    from sda_tpu_torch.parallel.engine import reconstruct
    from sda_tpu_torch.parallel.limb_cuda import (
        participant_limb_sums_cuda,
        participant_limb_sums_torch,
        share_combine_limb_cuda,
    )
    from sda_tpu_torch.parallel.limbmatmul import limb_recombine_host
    from sda_tpu_torch.protocol import PackedShamirSharing

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    kind = torch.cuda.get_device_name(0)
    _line("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build_all()
    _line("build", seconds=time.perf_counter() - t0, kernels=sorted(kernels.KERNELS))
    for name, report in reports.items():
        for text in report.strip().splitlines():
            print(f"ptxas[{name}]: {text}", flush=True)

    # -- 3. kernel vs plain on the card --------------------------------------
    p, w2, w3 = find_packed_parameters(K_SECRETS, THRESHOLD, CLERKS, min_modulus_bits=30, seed=0)
    scheme = PackedShamirSharing(K_SECRETS, CLERKS, THRESHOLD, p, w2, w3)
    plan = make_plan(scheme, DIM)  # default device: CUDA
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def canonical(shape, modulus):
        return torch.randint(0, modulus, shape, generator=gen, dtype=torch.int32, device=dev)

    p26, a26, b26 = find_packed_parameters(2, 1, 26, min_modulus_bits=30, seed=0)
    cases = [  # (label, plan, C, dim)
        ("full", plan, CHUNK, DIM),
        ("ragged C=37 dim=23", make_plan(scheme, 23), 37, 23),
        ("ragged C=1001 dim=1003", make_plan(scheme, 1003), 1001, 1003),
        ("n=26 (4 clerk tiles)", make_plan(PackedShamirSharing(2, 26, 1, p26, a26, b26), 601), 77, 601),
        ("p=433 (L=2)", make_plan(PackedShamirSharing(3, 8, 4, 433, 354, 150), 150), 100, 150),
    ]
    max_err = 0
    full_values = None
    for label, case_plan, C, dim in cases:
        K = case_plan.input_size + case_plan.rand_size
        values = canonical((C, case_plan.n_batches, K), case_plan.modulus)
        got = participant_limb_sums_cuda(values, case_plan.limb_stacks)
        want = participant_limb_sums_torch(values, case_plan.limb_stacks)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        _line("parity", case=label, shape=list(values.shape), out=list(got.shape),
              identical=bool(torch.equal(got, want)))
        if not torch.equal(got, want):
            raise AssertionError(f"limb_share_sum differs from its plain version ({label})")
        if label == "full":
            full_values = values

    # -- 4. main path at full width ------------------------------------------
    nbits = p.bit_length() - 1

    def draw(generator, shape, modulus):  # bench.py's masked-bits draw
        return uniform_bits_device_narrow(generator, shape, modulus.bit_length() - 1)

    n_chunks = PARTICIPANTS // CHUNK
    acc = torch.zeros((plan.limb_stacks.shape[0], plan.n_batches, CLERKS), dtype=torch.int64, device=dev)
    plain = torch.zeros(DIM, dtype=torch.int64, device=dev)

    def one_chunk(acc, plain):
        secrets = uniform_bits_device_narrow(gen, (CHUNK, DIM), nbits)
        chunk_acc = share_combine_limb_cuda(secrets, gen, plan, draw=draw)
        acc = torch.fmod(acc + chunk_acc, p)
        plain = torch.fmod(plain + torch.sum(secrets, dim=0, dtype=torch.int64), p)
        return acc, plain

    torch.cuda.synchronize()
    limb_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        acc, plain = one_chunk(acc, plain)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = limb_cuda.launches
    survivors = list(range(1, 1 + scheme.reconstruction_threshold))  # clerk 0 dropped
    clerk_sums = torch.as_tensor(limb_recombine_host(acc, p).T.copy(), device=dev)
    out = reconstruct(clerk_sums, survivors, scheme, DIM)
    exact = bool(torch.equal(positive(out, p), positive(plain, p)))
    _line("main path", participants=PARTICIPANTS, dim=DIM, chunk=CHUNK, chunks=n_chunks,
          modulus=p, survivors=survivors, launches=launches, wall_s=stream_s, exact=exact)
    if not exact:
        raise AssertionError("streamed round's reveal differs from the plain sum")
    if launches != n_chunks:
        raise AssertionError(f"limb_share_sum launched {launches} times, expected {n_chunks}")

    for use_limbs in (False, True):
        P_small, dim_small = 2_000, 1_000
        secrets = canonical((P_small, dim_small), p)
        agg = TorchAggregator(scheme, dim_small, use_limbs=use_limbs)
        got = positive(agg.secure_sum(secrets, gen, indices=survivors), p)
        want = torch.fmod(torch.sum(secrets, dim=0, dtype=torch.int64), p)
        ok = bool(torch.equal(got, want))
        _line("secure_sum", path="limb" if use_limbs else "int64", participants=P_small,
              dim=dim_small, exact=ok)
        if not ok:
            raise AssertionError(f"secure_sum ({'limb' if use_limbs else 'int64'}) != plain sum")

    # -- 5. numbers ------------------------------------------------------------
    _profile_chunks(lambda: one_chunk(acc, plain), PROFILE_CHUNKS)
    stacks = plan.limb_stacks
    L, LK, n = stacks.shape
    plain_a = _time_ms(lambda: participant_limb_sums_torch(full_values, stacks), iters=2)
    kernel_a = _time_ms(lambda: participant_limb_sums_cuda(full_values, stacks), iters=20, warmup=3)
    kernel_b = _time_ms(lambda: participant_limb_sums_cuda(full_values, stacks), iters=20, warmup=3)
    plain_b = _time_ms(lambda: participant_limb_sums_torch(full_values, stacks), iters=2)
    C, nb, K = full_values.shape
    moved = full_values.numel() * 4 + stacks.numel() + L * nb * n * 4
    ops = 2 * C * nb * L * LK * n  # one multiply + one add per int8 MAC
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    _line("numbers", kernel="limb_share_sum", shape=[C, nb, K], kernel_ms=[kernel_a, kernel_b],
          plain_ms=[plain_a, plain_b], bytes=moved, int8_ops=ops, bound_ms=max(bytes_ms, ops_ms),
          library_ms=None, launches=launches, stream_wall_s=stream_s, card=card)

    print(json.dumps({"kernels": [{
        "name": "limb_share_sum",
        "route": "cuda",
        "source": "sda_tpu_torch/csrc/limb_share_sum.cu",
        "replaces": "sda_tpu/parallel/limb_pallas.py:31",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # no single PyTorch call computes the limb split + dots + participant sum
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
