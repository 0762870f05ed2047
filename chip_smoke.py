#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own line:

1. device: needs CUDA (exits nonzero without it); prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles every kernel from ``sda_tpu_torch/csrc`` (seconds, and
   ptxas' register/spill report) and, beside them, the native batch layer
   from ``sda_tpu_torch/native`` with the host's ``cc`` (its seconds and
   ``cc --version``'s first line), counts the int8 tensor-core
   instructions (``IMMA``) in K1's SASS with ``cuobjdump`` (none fails),
   and K2's integer instructions per 64-byte block by family (``LOP3``,
   ``SHF``, ``PRMT``, ``IADD3``, ``IMAD``, ``VIADD``) in its kernel's body,
   on the ``build`` line: K2's operations bound is reckoned from them;
3. parity: each kernel against its plain PyTorch version on the card, at the
   main path's full-width shape and at ragged shapes, bit-identical: K1 the
   limb share-and-reduce through both of its entries (the ``(C, nb, K)``
   values, and the secrets and randomness as two inputs) in six cases, among
   them the full chunk and a K = 15, n = 26 scheme; K2 the ChaCha20
   keystream, and K2's batched mask expansion against the host
   ``expand_seed``;
4. main path: one packed-Shamir secure-sum round of 100,000 participants x
   10,000 dims streamed in chunks of 2,000 through ``share_combine_limb_cuda``
   (the bench scheme: k=5, t=2, n=8, 31-bit p), revealed from clerks 1..7 and
   held against an independent int64 sum on the card (K1 reads the secrets
   and the drawn randomness directly: no ``cat`` kernel may show in the
   path's profile); then ``TorchAggregator.secure_sum`` on its int64 and
   limb paths;
5. masked path: the same round with ChaCha masking: each chunk's 128-bit
   seeds expand on the card (``expand_seeds_counts``, K2), mask the secrets
   mod p and go through K1; the recipient reconstructs the masked total,
   re-expands all 100,000 seeds (``combine_masks_device``, K2) and unmasks;
6. reveal: ``combine_masks_device`` over 1,000,000 seeds x 100,000 dims, the
   size K2 was written for; then K2 against its plain version at both
   shapes the reveal launched it at (a full fold and the last, shorter
   one), those two folds' partials against the host ``expand_seed`` rows
   folded in numpy, 8 sampled rows against ``expand_seed``, and a profile
   of a few folds (kernel against the torch compaction);
7. numbers: launch counts of each path's run, each kernel's own device time
   per launch at the chunk shape (``torch.profiler``), its wrapper's and its
   plain version's times (CUDA events), K2's time by CUDA events over
   back-to-back launches of its C entry (``event_ms``, here and at every
   later K2 ``numbers`` line), the bound, the paths' wall times;
8. sum-first: bench.py's sum-first stream with its full check and finalize
   at its two presets, uncut: quick (100,000 x 10,000 in chunks of 2,000,
   31-bit p, int32 draws) and the north star (1,000,000 x 100,000 in
   chunks of 500, 61-bit p, ``(hi, lo)`` int32 word pairs); per preset the
   wall, exactness, the bytes floor and a profile of a few chunks;
9. fabrics: a one-rank NCCL group in this process, then each sharded
   fabric once at the bench scheme (``full_training_step``, the
   all-to-all with a dropout reveal, the hierarchical round, the limb
   accumulators through K1, the same at 61 bits, sum-first, the
   ChaCha-masked round through K2), each held against the plain sum and,
   with the same draws, against a single-device path's clerk sums; one
   ``fabric`` line each, with K1's and K2's launches and the fabric's
   nominal collective bytes; then K2 against its plain version at each
   shape the masked round launched it at;
10. fedavg round: one ChaCha-masked secure FedAvg round (``fedavg_round``)
   of 100 updates of the FedAvg paper's MNIST CNN (1,663,370 parameters)
   through the model plane: flatten, quantize, mask (K2), share and sum
   (K1, at a width whose ``d % 4 == 2`` takes its unaligned copy path),
   reveal from clerks 1..7, unmask (K2), dequantize the mean and apply it
   to a global model; checked against host numpy and an independent field
   sum, once under ``torch_trace`` and once timed; then K1 and K2 against
   their plain versions and timed at the round's shapes, and a
   ``telemetry`` line (the engine's step histogram after one
   ``secure_sum``, the fabrics' collective bytes after phase 9);
11. bench: ``python -m sda_tpu_torch.bench`` (bench.py's device plane) once
   per engine route, each a whole verified stream: the participant engine
   at 100,000 x 10,000 on its int64, torch-limb, K1 (``--kernel``, 50
   launches) and 61-bit routes, sum-first quick with ``--check probe`` and
   ``off``; as subprocesses the north star and the K1 route with the
   ``--roofline`` decomposition, and a run with an injected fault that must
   exit 1. One ``bench`` line each (the bench's own metric line);
12. drivers: ``python -m sda_tpu_torch.baseline_ladder --configs 2,3,4``,
   the baseline ladder's device rows at full size (additive 3-way at a
   32-bit prime, 1,000 x 100,000; basic Shamir t=2, n=5 through K1, 10,000
   x 10,000; packed Shamir with clerk 3 dropped through sum-first, 100,000
   x 50,000), one ``ladder`` line per row, each whole and verified, config
   3 with one K1 launch per 2,000-row chunk; K1 against its plain version
   at config 3's launch shape (K = 3, L = 3, n = 5) through both entries,
   and its ``numbers`` line there; then ``python -m
   sda_tpu_torch.examples.secure_sum_fabric`` on the visible cards, which
   must print its three OK lines.

13. model rounds: the model plane's remaining drivers over ``model_round``,
   an engine round of wire vectors (mask: K2, share and sum: K1, reveal,
   unmask: K2) at the CNN's width with 10 clients per round, two rounds
   each: ``WeightedFederatedAveraging`` (the ``(w·x, w)`` wire, sample-count
   weights) under ``FedAvgM``, and ``DPFederatedAveraging`` (L2 clip,
   discrete Gaussian noise drawn on the card, the zCDP accountant) under
   ``FedAdam``; one ``model round`` line each, checked against host numpy
   (wires, field sum, mean, the server step bit for bit, the noise's
   spread, the privacy account) and by launch counts; a ``privacy`` line
   composing the DP rounds; K1 and K2 against their plain versions at the
   rounds' shapes, and their ``numbers`` there.
21. native (run here, before the rounds that ride it): the native batch
   layer's C (``native_phase``) byte for byte against its plain versions at
   fixed ephemeral keys: ``seal_participations`` at 1, 3 and 16 x 8 and
   ``seal_batch`` of the same messages, each on the comb and the ladder
   path, with messages of 0, 1 and 1,000 bytes and one CNN-width share
   row, under ``SDA_NATIVE_THREADS=1`` and the default; ``open_batch`` of
   plain-sealed boxes and a flipped byte refused at its index; a varint
   round trip at the CNN's width; ``chacha_expand`` against
   ``expand_seed`` at dims 1, 8,193 and 1,663,370 for p = 2^31 - 1,
   2^61 - 1 and 2^63; the box public key, Ed25519 seed keypairs and
   detached signatures of seeded keys and messages of 0 to 4,096 bytes
   against ``crypto/sodium.py``; ``mod_exp`` and ``mod_exp_batch`` against
   Python's ``pow`` at 2,048 and 4,096 bits; the C fold of 10 CNN-width
   seeds against K2's ``combine_masks_device``. One ``native`` line per
   case, each ``identical: true``; then ``native rates`` (C against plain
   for one CNN-width row) and a second ``native rates`` line for a 4,096-bit
   modexp (``pow``, the C on one thread, the batch on every thread).
14. sealed round: the protocol plane's aggregation round
   (``sealed_round``) through ``new_mem_server`` and ``SdaClient``s, each
   member with its own keystore in a temporary directory: 10 participants
   (the paper's per-round cohort) each quantize a float update of the CNN
   and mask (ChaCha, expanded by the native layer's C), share (packed
   Shamir k=5, t=2, n=8, from ``QuantizationSpec.fitted``) and seal it to 8
   clerks in one ``native.seal_participations`` call; the snapshot, the
   clerks' chores (batched opens in C), the recipient's reveal, whose ChaCha
   combine of 10 x 1,663,370 elements runs on the card (K2); one ``sealed
   round`` line with the stage times, the sealed bytes, the native layer's
   seal and open rates and its checks (the sum against numpy, K2 launched,
   every seal and open counted on a C path and nowhere else, a flipped
   ciphertext byte refused by the clerk's open, a participation
   posted under another agent refused by the server, a key with an
   altered signature refused by the participant); a round at dim 1,000,
   below the device threshold, that launches no K2; K2 against its plain
   version at the reveal fold's shape on the round's seeds, and its
   ``numbers`` there.
15. trainer: ``FederatedTrainer.run_round`` once (``TRAINER_ROUNDS``) over
   ``DPFederatedAveraging`` at the CNN's width (phase 13's DP setting, the
   field and scheme from ``fitted_spec``) through the sealed round of
   phase 14's deployment, ``FedAdam`` as the server step, checkpoints in a
   temporary directory, 10 participants submitting on 4 threads (each with
   a child generator for its noise); one ``trainer round`` line with
   ``wall_s`` split into ``submit_s``, ``clerking_s``, ``reveal_s``,
   ``mask_combine_s``, ``apply_s`` and ``save_s``, the checkpoint bytes
   and its checks (the revealed sum against numpy's sum of the submitted
   wires, the model against a numpy replay of FedAdam bit for bit, one K2
   launch); a ``privacy`` line; a fresh trainer's restore, bit-equal to the
   live one (``trainer restore``); K2 against its plain version at the
   fold's shape and its ``numbers`` there.
16. analytics: the port's ``federated_training``, ``federated_analytics``
   and ``sketch_suite`` examples in process on CUDA clients (one
   ``example`` line each, return code 0), then one ``SecureHistogram`` and
   one ``CountMinSketch`` round held exactly against numpy, with no K2
   launch in the whole phase (``analytics``).
17. rest round: phase 14's round over loopback HTTP — ``python -m
   sda_tpu_torch.cli.sdad --sqlite <tmp>/sda.db httpd -b 127.0.0.1:0`` as
   a subprocess (``--file`` where this Python has no ``sqlite3``), every
   member on its own ``SdaHttpClient`` with binary frames; the same five
   checks as phase 14 over HTTP, exactly one K2 launch in this (the
   recipient's) process, and the server's ``/v1/metrics`` request count
   equal to the requests the clients completed; one ``rest round`` line
   (stage seconds, requests and bytes each way, wire, store), K2 against
   its plain version at the fold's shape; then the reference's CLI
   walkthrough (scripts/simple-cli-example.sh) with each ``sda`` step
   called in process against an ``sdad --file`` subprocess, which must
   print ``result: 0 2 2 4 4 6 6 8 8 10`` with no K2 launch (``cli
   walkthrough`` line).
18. tier round: the scale-out plane — two ``python -m
   sda_tpu_torch.cli.sdad --sqlite <tmp>/store --shards 2 --replicas 2``
   frontends over one root, every member on a two-root ``SdaHttpClient``;
   phase 14's aggregation made tiered (``tiers=2``, two sub-cohorts, share
   promotion), 10 participants whose seeded ids put at least 3 in each
   sub-cohort, one pool of 8 clerks wrapped over the 3 nodes, through
   ``setup_tier_round(..., frontends=2)`` and ``run_tier_round``. One
   shard's ``shard-NN.down`` marker is touched after the participations
   and removed before the root's reveal, which waits for both frontends'
   hint queues to drain. One ``tier round`` line (stage seconds, each
   fold's ``mask_combine_s``, requests and bytes, hints, K2 launches) and
   its checks: the reveal against numpy's sum mod p, one reconstruction in
   the whole round, K2 launched once per fold of at least 2^22 elements
   (the two promoters' and the root's), writes hinted while the shard was
   down and none left after the heal, the servers' summed
   ``sda_http_requests_total`` equal to the requests the clients completed
   (with the phase's own metrics polls); K2 against its plain version at
   each fold's shape.
19. ingest round: arrival-driven ingest and the paged reads — one ``python
   -m sda_tpu_torch.cli.sdad --sqlite <tmp>/sda.db httpd`` subprocess
   (``--file`` where this Python has no ``sqlite3``) that pages every job
   and every result in ranges of 4 (``SDA_JOB_PAGE_THRESHOLD=0``,
   ``SDA_JOB_CHUNK_SIZE=4``, ``SDA_RESULT_PAGE_THRESHOLD=0``,
   ``SDA_RESULT_CHUNK_SIZE=4``), clients reading 3 ranges ahead
   (``SDA_PREFETCH_DEPTH=3``). Phase 14's aggregation at the CNN's width,
   16 phones on 4 participant identities through ``ingest_cohort(...,
   window=8)`` on the trace
   ``base=0.5,diurnal=0.6@20,burst=0.15@4,churn=0.25:16``; the snapshot,
   the 8 clerks on 8 threads each reading its paged job through the
   prefetch pipeline, the recipient's paged reveal folding each mask range
   of 4 seeds as it arrives, on K2. One ``ingest round`` line (stage
   seconds of plan, build, upload, snapshot, clerking, reveal and wall, the
   lag and backlog, windows and batches, both overlap gauges, each fold's
   ``mask_combine_s``, requests and bytes) and its checks: the reveal
   against numpy's sum mod p, one K2 launch per mask range of at least
   2^22 elements and each on the reveal's own thread, every job and the
   result read in more than one range, no live row released before its
   arrival less the slack, churned rows after every live row, the churn
   count, the backlog bound, the server's request count; K2 against its
   plain version at each range's shape.
20. paillier round: against the same ``sdad``, 10 participants of 20,000
   field values under Full masking with their masks encrypted to a
   2,048-bit Paillier key (``PackedPaillierEncryptionScheme`` of 50
   components of 40 bits), phase 14's packed Shamir; the server's snapshot
   combines the mask ciphertexts into one; every modexp on the native
   layer's Montgomery C. One ``paillier round`` line (keygen, participate,
   snapshot, clerking and reveal seconds, the modexps counted per stage)
   and its checks: the reveal against numpy's sum mod p, one mask
   encryption in the paged result, no K2 launch, the server's request
   count, every encryption and decryption on ``native.mod_exp_batch``.
22. flight: phase 14's round once more at the CNN's width on CUDA clients,
   each participant through ``participate_many``, under one trace id with
   the JSON log sink installed; the flight recorder's ``round_report``,
   ``critical_path`` and ``chrome_trace_json`` over the round's spans. One
   ``flight`` line (the stages' seconds and shares, the critical path, span
   and log-line counts) and its checks: every span logged once with the
   trace id, one Chrome event per span, the stages within the round's wall
   and covering half of it, the critical path inside the round, one K2
   launch, the sum against numpy's; K2 against its plain version at the
   fold's shape.
23. riders: ``python -m sda_tpu_torch.bench --engine participant --kernel``
   as a user runs it, with ``bench.py``'s eleven protocol-plane riders
   (``sda_tpu_torch/riders``) on at their default sizes before the device
   run, artifacts in a temporary directory. One ``rider`` line per rider
   (its seconds, rates, ratios, RSS, per-shard counts, sketch headroom),
   then a ``riders`` line and its checks: all eleven present, none with an
   error, every exactness flag true, one artifact per banking rider and
   none in ``bench-artifacts/``, CUDA uninitialised until the sketch rider
   (the only one whose clients compute on the card), and the metric line
   verified with K1 launched 50 times and K2 never.

Then the ``{"kernels": [...]}`` line (launches: K1's on the main path, the
fabrics, the FedAvg round, the bench's K1 route in phases 11 and 23, the
ladder's config 3 and the model rounds, K2's on the masked path, the
fabrics, the FedAvg round,
the model rounds, the sealed round, the trainer rounds, the REST round,
the tier round, the ingest round and the flight round),
and last ``{"ok":
true, "device": ...}``. Any failed phase raises, and the script exits
nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

from sda_tpu_torch import bench
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8 tensor-core ops/s
from sda_tpu_torch.bench import HBM_BYTES_PER_S, INT8_OPS_PER_S, sumfirst_finalize, sumfirst_stream

# 32-bit integer lanes of an H100 SM per clock: 4 schedulers issue one 32-lane
# warp instruction each (128); logic ops (LOP3), funnel shifts (SHF), byte
# permutes (PRMT) and IADD3 run only on the 64-lane INT pipe, IMAD (which
# ptxas also uses for adds and moves, as IMAD.IADD and IMAD.MOV) on the
# 64-lane FMA pipe. Rates are these times the SM count and the card's
# maximum SM clock.
ISSUE_LANES_PER_SM = 128
INT_PIPE_LANES_PER_SM = 64
# K2 runs one thread per 64-byte block, straight-line, so its per-block
# instruction counts are read off its SASS in phase 2 (``sass_counts``) and
# held here for ``_k2_bound``: the integer families counted, the INT-pipe
# ones among them
K2_SASS_FAMILIES = ("LOP3", "SHF", "PRMT", "IADD3", "IMAD", "VIADD")
INT_PIPE_FAMILIES = ("LOP3", "SHF", "PRMT", "IADD3")
K2_PER_BLOCK: dict = {}

PARTICIPANTS, DIM, CHUNK = 100_000, 10_000, 2_000
K_SECRETS, THRESHOLD, CLERKS = 5, 2, 8
SEED_WORDS = 4  # 128-bit ChaCha seeds, the reference's default seed_bitsize
REVEAL_SEEDS, REVEAL_DIM = 1_000_000, 100_000
# bench.py's sum-first presets (bench.py:3333-3336): participants, dims,
# chunk, min_modulus_bits; the north star is config 5 on the (hi, lo) path
SUMFIRST = {
    "sum-first quick": (100_000, 10_000, 2_000, 30),
    "sum-first north star": (1_000_000, 100_000, 500, 60),
}
# fabric participants at DIM dims: through K1 or sum-first, and on the
# int64 share path, whose (P, nb, K, n) int64 products and their fmod
# (2 x 4,000 x 2,000 x 7 x 8 x 8 B) stay well under 16 GB of the H100
# 80GB HBM3's memory
FABRIC_STREAM_P, FABRIC_SHARE_P = 20_000, 4_000
KNOWN_BLOCK0 = "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7"
# the MNIST CNN of McMahan et al., "Communication-Efficient Learning of Deep
# Networks from Decentralized Data" (AISTATS 2017), section 3: two 5x5
# convolutions of 32 and 64 channels, each followed by 2x2 max pooling, a
# 512-unit dense layer and a 10-way softmax, 1,663,370 parameters. Keys are
# out of sorted order on purpose: the flattening must sort them as JAX does
FEDAVG_MODEL = {
    "dense2": {"kernel": (512, 10), "bias": (10,)},
    "conv1": {"kernel": (5, 5, 1, 32), "bias": (32,)},
    "dense1": {"kernel": (3136, 512), "bias": (512,)},
    "conv2": {"kernel": (5, 5, 32, 64), "bias": (64,)},
}
# the paper's K = 100 clients at C = 1.0, taken in chunks of 25; the field
# holds 100 sums of 16 fractional bits clipped at 8.0
FEDAVG_PARTICIPANTS, FEDAVG_CHUNK = 100, 25
FEDAVG_FRAC_BITS, FEDAVG_CLIP = 16, 8.0


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


def _profile_chunks(step, chunks: int, label: str = "main path", kernel: str | None = None) -> list:
    """Where one streamed chunk's device time goes: ``torch.profiler`` over a
    few chunks of a path (after its launch counts were read), kernel time by
    name and the device's busy share of the window's wall; with ``kernel``,
    also the split between that kernel and everything else. Returns the
    names of every device kernel seen."""
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
        _line("profile", path=label, chunks=chunks, wall_ms=wall_ms, device_time="not measured")
        return [e.key for e in kernels]
    split = {}
    if kernel is not None:
        own = sum(e.self_device_time_total for e in kernels if kernel in e.key) / 1e3
        split = {"split_ms_per_chunk": {kernel: own / chunks, "rest": (busy_ms - own) / chunks}}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    _line("profile", path=label, chunks=chunks, wall_ms=wall_ms, device_busy_ms=busy_ms,
          busy_share=busy_ms / wall_ms, **split, kernels=[
              {"name": e.key[:70], "ms_per_chunk": e.self_device_time_total / 1e3 / chunks,
               "count": e.count, "share": e.self_device_time_total / 1e3 / busy_ms}
              for e in top])
    return [e.key for e in kernels]


def _profiled(fn, iters: int, kernel: str) -> tuple[int, float]:
    """``torch.profiler`` over ``iters`` runs of ``fn``: the launches of the
    kernel named ``kernel`` it saw and their own device time in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    own = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key]
    return sum(e.count for e in own), sum(e.self_device_time_total for e in own) / 1e3


def _k2_event_ms(keys, n_blocks: int, iters: int = 50, windows: int = 2) -> list:
    """K2's device time per launch at ``keys`` x ``n_blocks`` by CUDA events
    around ``iters`` back-to-back launches of its C entry into one output
    (no wrapper, no allocation between them), per window: the profiler's
    records, which drop some kernels, are not needed for it. These launches
    are timing only and count nowhere."""
    import torch

    from sda_tpu_torch import kernels
    from sda_tpu_torch.ops.chacha_cuda import kernel_keys

    packed = kernel_keys(keys)
    P = packed.shape[0]
    out = torch.empty((P, n_blocks, 16), dtype=torch.int32, device=packed.device)
    launch = kernels.load("chacha20").chacha20_launch
    stream = torch.cuda.current_stream().cuda_stream

    def run(count):
        for _ in range(count):
            if launch(packed.data_ptr(), 0, n_blocks, P, out.data_ptr(), stream):
                raise RuntimeError("chacha20 launch failed")

    run(3)  # warm
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        run(iters)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return times


PROFILER_WINDOWS = 5


def _kernel_ms(fn, iters: int, kernel: str) -> float:
    """Device time per launch of the kernel named ``kernel`` while ``fn``
    runs ``iters`` times: its own time by ``torch.profiler``, without the
    host work of the wrapper that launches it. A window counts only if the
    profiler saw all of its launches; on the H100 it drops some of a
    window's kernel records now and then (0, 2, 16 or 19 of 20 seen while
    all 20 ran, and once 14 of 20 in five windows in a row), so up to
    ``PROFILER_WINDOWS`` windows are tried, each one after a short window
    half as long as the one before (at least one launch), and each short
    window is printed on a line."""
    window = iters
    for _ in range(PROFILER_WINDOWS):
        count, total_ms = _profiled(fn, window, kernel)
        if count == window:
            return total_ms / count
        _line("profiler window", kernel=kernel, saw=count, expected=window)
        last, window = window, max(1, window // 2)
    raise AssertionError(f"the profiler saw {count} launches of {kernel}, expected {last}, "
                         f"in the last of {PROFILER_WINDOWS} windows")


def _k1_bound(secrets, rand, stacks):
    """K1's work on these inputs and the least time it could take: both
    inputs read once, the stacks, the output written once; the real int8
    MACs (the kk padding to 8 is not counted, one multiply + one add each)
    at the int8 tensor-core peak. Returns (bytes, ops, bytes_ms, ops_ms)."""
    L, LK, n = stacks.shape
    C, nb = secrets.shape[0], rand.shape[1]
    moved = (secrets.numel() + rand.numel()) * 4 + stacks.numel() + L * nb * n * 4
    ops = 2 * C * nb * L * LK * n
    return moved, ops, moved / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3


def _k2_bound(seeds: int, n_blocks: int, sm_clocks_per_ms: float):
    """K2's work for ``seeds`` x ``n_blocks`` keystream blocks and the least
    time it could take: keys read once, blocks written once; the integer
    instructions that K2's SASS issues per block (``K2_PER_BLOCK``, counted
    in phase 2) at the card's maximum SM clock, the INT-pipe ones on 64
    lanes per SM, the FMA pipe's IMADs on 64 and all of them on 128,
    whichever takes longer. Returns (bytes, ops, int_pipe_ops, bytes_ms,
    ops_ms)."""
    if not K2_PER_BLOCK:
        raise RuntimeError("K2's SASS has not been counted (phase 2)")
    blocks = seeds * n_blocks
    moved = seeds * 8 * 4 + blocks * 64
    ops, int_ops = blocks * K2_PER_BLOCK["issue"], blocks * K2_PER_BLOCK["int_pipe"]
    fma_ops = blocks * K2_PER_BLOCK["IMAD"]
    clocks = max(int_ops / INT_PIPE_LANES_PER_SM, fma_ops / INT_PIPE_LANES_PER_SM,
                 ops / ISSUE_LANES_PER_SM)
    return moved, ops, int_ops, moved / HBM_BYTES_PER_S * 1e3, clocks / sm_clocks_per_ms


def _sass(library) -> str:
    """A built library's SASS (``cuobjdump``)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "--dump-sass", str(library)], check=True,
                          capture_output=True, text=True, timeout=120).stdout


def _sass_count(library, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS."""
    return sum(1 for text in _sass(library).splitlines() if f" {opcode}" in text)


_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_counts(sass: str, function: str, families) -> tuple[dict, dict]:
    """Instructions per opcode family (``IMAD`` covers ``IMAD.IADD``,
    ``IMAD.MOV.U32``, ...) in the SASS of the one function whose name holds
    ``function``: ``(body, after)``, the body from its entry to its last
    unpredicated ``EXIT``, and what follows it (subroutines such as the
    64-bit division's, reached by ``CALL`` only on a slow path)."""
    code, inside = [], False  # (opcode, predicated) in address order
    for text in sass.splitlines():
        if "Function :" in text:
            inside = function in text
            continue
        m = _SASS_LINE.match(text)
        if inside and m:
            instruction = m.group(2)
            predicated = instruction.startswith("@")
            if predicated:
                instruction = instruction.split(None, 1)[1]
            code.append((instruction.split()[0], predicated))
    if not code:
        raise ValueError(f"no SASS for a function named like {function!r}")
    exits = [i for i, (op, predicated) in enumerate(code) if op == "EXIT" and not predicated]
    last = exits[-1] if exits else len(code) - 1
    body, after = dict.fromkeys(families, 0), dict.fromkeys(families, 0)
    for i, (op, _) in enumerate(code):
        family = op.split(".")[0]
        if family in body:
            (body if i <= last else after)[family] += 1
    return body, after


def sumfirst_phase(card: str, dev, seed: int) -> None:
    """Phase 8: the sum-first body and finalize of ``sda_tpu_torch.bench``
    (bench.py's) at each ``SUMFIRST`` preset, uncut, with the full check; per preset one line (wall,
    chunks, exactness, peak memory, the bytes floor of writing and reading
    every drawn value once) and a profile of a few chunks."""
    import torch

    from sda_tpu_torch.ops import find_packed_parameters
    from sda_tpu_torch.parallel import make_plan
    from sda_tpu_torch.protocol import PackedShamirSharing

    for label, (participants, dim, chunk, bits) in SUMFIRST.items():
        p, w2, w3 = find_packed_parameters(K_SECRETS, THRESHOLD, CLERKS, min_modulus_bits=bits, seed=0)
        scheme = PackedShamirSharing(K_SECRETS, CLERKS, THRESHOLD, p, w2, w3)
        plan = make_plan(scheme, dim, dev)
        step, acc, plain = sumfirst_stream(plan, dim, chunk, torch.Generator(device=dev).manual_seed(seed))
        chunks = participants // chunk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(chunks):
            acc, plain = step(acc, plain)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        got = sumfirst_finalize(acc, plain, plan, scheme, dim)
        finalize_s = time.perf_counter() - t0
        pair = p.bit_length() - 1 > 31
        word_bytes = 8 if pair else 4  # a (hi, lo) pair or one int32 per value
        drawn = (chunk * dim + chunk * plan.n_batches * THRESHOLD) * word_bytes
        _line(label, participants=participants, dim=dim, chunk=chunk, chunks=chunks, modulus=p,
              path="pair" if pair else "narrow", wall_s=wall_s, finalize_s=finalize_s,
              exact=got is not None, peak_bytes=peak, drawn_bytes_per_chunk=drawn,
              floor_bytes=2 * drawn * chunks, floor_s=2 * drawn * chunks / HBM_BYTES_PER_S,
              card=card)
        if got is None:
            raise AssertionError(f"{label}: the limb sums differ from the check sums or the reveal")
        _profile_chunks(lambda: step(acc, plain), 4, label=label)
        del acc, plain


class _RowDraw:
    """Draw hook over pre-drawn ``(P, nb, t)`` randomness: successive calls
    take successive row blocks, so a fabric that streams its rows in chunks
    and a one-shot single-device path consume the same draws."""

    def __init__(self, rand):
        self.rand, self.row = rand, 0

    def __call__(self, generator, shape, modulus):
        block = self.rand[self.row : self.row + shape[0]]
        self.row += shape[0]
        if tuple(block.shape) != tuple(shape):
            raise AssertionError(f"draw of {tuple(shape)} past the pre-drawn {tuple(self.rand.shape)}")
        return block


def fabric_phase(card: str, dev, seed: int) -> dict:
    """Phase 9: each sharded fabric once under a one-rank NCCL group, at the
    bench scheme, held against the plain sum on the card and, with the same
    pre-drawn randomness, its clerk sums against a single-device path (the
    sum-first engine, or, for the sum-first fabric, the per-participant
    int64 share path). One ``fabric`` line each. Returns the kernel
    launches the fabrics made, by kernel."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from sda_tpu_torch.ops import chacha_cuda, find_packed_parameters
    from sda_tpu_torch.ops.chacha import chacha_blocks_torch
    from sda_tpu_torch.ops.chacha_cuda import (
        chacha_blocks_cuda,
        combine_masks_device,
        default_chunk,
        seed_tensor,
        window_blocks,
    )
    from sda_tpu_torch.ops.modular import mod_sum_auto, positive
    from sda_tpu_torch.ops.rng import uniform_bits_device, uniform_bits_device_narrow
    from sda_tpu_torch.parallel import TorchAggregator, engine, full_training_step, limb_cuda, make_mesh, make_plan
    from sda_tpu_torch.parallel.engine import clerk_combine_mod, masked_sum, reconstruct, share_participants
    from sda_tpu_torch.parallel.limbmatmul import limb_recombine_host
    from sda_tpu_torch.parallel.mesh import gather_over, shard_participants
    from sda_tpu_torch.parallel.multihost import (
        hierarchical_clerk_sums,
        hierarchical_secure_sum,
        initialize_distributed,
        make_hybrid_mesh,
        shard_participants_hybrid,
    )
    from sda_tpu_torch.parallel.sumfirst import (
        clerk_sums_from_limb_acc,
        clerk_sums_sum_first,
        sharded_value_limb_sums,
    )
    from sda_tpu_torch.protocol import PackedShamirSharing

    gen = torch.Generator(device=dev).manual_seed(seed)
    schemes = {}
    for bits in (30, 60):
        p, w2, w3 = find_packed_parameters(K_SECRETS, THRESHOLD, CLERKS, min_modulus_bits=bits, seed=0)
        schemes[bits] = PackedShamirSharing(K_SECRETS, CLERKS, THRESHOLD, p, w2, w3)
    survivors = list(range(1, 1 + schemes[30].reconstruction_threshold))  # clerk 0 dropped

    def inputs(P, bits):
        """Secrets, their plain sum mod p, pre-drawn randomness (masked bits)."""
        p = schemes[bits].prime_modulus
        nbits = p.bit_length() - 1
        draw = uniform_bits_device_narrow if nbits <= 31 else uniform_bits_device
        secrets = draw(gen, (P, DIM), nbits)
        rand = draw(gen, (P, -(-DIM // K_SECRETS), THRESHOLD), nbits)
        return secrets, positive(mod_sum_auto(secrets, p, axis=0), p), rand

    moved = {}  # the warm call's nominal collective bytes, by fabric

    def timed(fn):
        """``fn()`` twice, synchronised: a cold call (the first use of a
        mesh's communicators and of fresh allocator blocks), then the warm
        one, with the kernels' launch counts set to 0 just before it.
        Returns the warm call's result, its wall and the cold call's; the
        warm call's growth of the registry's fabric bytes goes to
        ``moved``."""
        walls = []
        for _ in range(2):
            limb_cuda.launches = chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
            calls, before = engine.fabric_calls(), engine.fabric_bytes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        moved.clear()
        called = engine.fabric_calls()
        moved.update({f: n - before.get(f, 0) for f, n in engine.fabric_bytes().items()
                      if called[f] > calls.get(f, 0)})
        return out, walls[1], walls[0]

    def report(fabric, P, bits, walls, exact, **extra):
        _line("fabric", fabric=fabric, world_size=dist.get_world_size(), backend=dist.get_backend(),
              participants=P, dim=DIM, modulus=schemes[bits].prime_modulus, wall_s=walls[0],
              cold_s=walls[1], peak_bytes=torch.cuda.max_memory_allocated(), exact=exact,
              fabric_bytes=dict(moved), card=card, **extra)
        if not exact:
            raise AssertionError(f"fabric {fabric}: differs from the plain sum or the single-device clerk sums")

    def same_clerk_sums(sums, secrets, rand, plan):
        want = clerk_sums_sum_first(secrets, None, plan, draw=_RowDraw(rand))
        return bool(np.array_equal(positive(sums, plan.modulus).cpu().numpy(), want))

    def revealed(sums, scheme, want):
        out = reconstruct(torch.as_tensor(sums, device=dev), survivors, scheme, DIM)
        return bool(torch.equal(positive(out.to(dev), scheme.prime_modulus), want))

    launches, k2_err = {}, 0
    scheme = schemes[30]
    p = scheme.prime_modulus
    with tempfile.TemporaryDirectory() as rendezvous:
        initialize_distributed(f"file://{rendezvous}/rendezvous", 1, 0, device=dev)
        try:
            mesh = make_mesh(device=dev)
            plan = make_plan(scheme, DIM, dev)

            # full_training_step: int64 share path + psum, verified step
            secrets, want, rand = inputs(FABRIC_SHARE_P, 30)
            agg, step = full_training_step(scheme, DIM, mesh)
            local = shard_participants(secrets, mesh)
            torch.cuda.reset_peak_memory_stats()
            (out, plain), *walls = timed(lambda: step(local, seed))
            exact = bool(torch.equal(positive(out, p), want) and torch.equal(positive(plain, p), want))
            sums = agg.sharded_clerk_sums()(local, 0, draw=_RowDraw(rand))
            report("full_training_step", FABRIC_SHARE_P, 30, walls,
                   exact and same_clerk_sums(sums, secrets, rand, plan))

            # all_to_all: clerk-major reshard, dropout reconstruction with the
            # dropped clerk's row corrupted
            fn = TorchAggregator(scheme, DIM, mesh=mesh).sharded_clerk_sums_all_to_all()
            torch.cuda.reset_peak_memory_stats()
            sums, *walls = timed(lambda: gather_over(fn(local, seed), mesh, "p", dim=0))
            sums = sums.clone()
            sums[0] = -7
            exact = revealed(sums, scheme, want)
            sums = gather_over(fn(local, 0, draw=_RowDraw(rand)), mesh, "p", dim=0)
            report("sharded_clerk_sums_all_to_all", FABRIC_SHARE_P, 30, walls,
                   exact and same_clerk_sums(sums, secrets, rand, plan), survivors=survivors)

            # hierarchical, every axis of size 1
            hmesh = make_hybrid_mesh(1, 1, 1, device=dev)
            hlocal = shard_participants_hybrid(secrets, hmesh)
            _, hstep = hierarchical_secure_sum(scheme, DIM, hmesh)
            torch.cuda.reset_peak_memory_stats()
            (out, plain), *walls = timed(lambda: hstep(hlocal, seed))
            exact = bool(torch.equal(positive(out, p), want) and torch.equal(positive(plain, p), want))
            _, hfn = hierarchical_clerk_sums(scheme, DIM, hmesh)
            sums = hfn(hlocal, 0, draw=_RowDraw(rand))
            report("hierarchical_secure_sum", FABRIC_SHARE_P, 30, walls,
                   exact and same_clerk_sums(sums, secrets, rand, plan), mesh={"h": 1, "p": 1, "d": 1})
            del secrets, rand, local, hlocal, sums

            # the limb-accumulator fabric: K1 over 2,000-participant chunks
            secrets, want, rand = inputs(FABRIC_STREAM_P, 30)
            local = shard_participants(secrets, mesh)
            fn = TorchAggregator(scheme, DIM, mesh=mesh).sharded_limb_accumulators()
            torch.cuda.reset_peak_memory_stats()
            acc, *walls = timed(lambda: fn(local, seed))
            k1 = limb_cuda.launches
            exact = revealed(limb_recombine_host(acc, p).T.copy(), scheme, want)
            acc = fn(local, 0, draw=_RowDraw(rand))
            launches["limb_share_sum"] = k1
            report("sharded_limb_accumulators", FABRIC_STREAM_P, 30, walls,
                   exact and same_clerk_sums(torch.as_tensor(limb_recombine_host(acc, p).T.copy()),
                                             secrets, rand, plan), launches={"limb_share_sum": k1})
            want_k1 = -(-FABRIC_STREAM_P // 2_000)
            if k1 != want_k1:
                raise AssertionError(f"the limb fabric launched limb_share_sum {k1} times, expected {want_k1}")

            # sum-first: checked against the per-participant int64 share path
            # in 2,000-row chunks with the same draws
            fn = sharded_value_limb_sums(plan, mesh)
            torch.cuda.reset_peak_memory_stats()
            acc, *walls = timed(lambda: fn(local, seed))
            clerk, vsum = clerk_sums_from_limb_acc(acc, plan)
            exact = revealed(clerk, scheme, want) and bool(
                np.array_equal(vsum[:, :K_SECRETS].reshape(-1)[:DIM], want.cpu().numpy()))
            clerk, _ = clerk_sums_from_limb_acc(fn(local, 0, draw=_RowDraw(rand)), plan)
            per_participant = torch.zeros((CLERKS, plan.n_batches), dtype=torch.int64, device=dev)
            row_draw = _RowDraw(rand)
            for start in range(0, FABRIC_STREAM_P, 2_000):
                shares = share_participants(secrets[start : start + 2_000], None, plan, draw=row_draw)
                per_participant = torch.fmod(per_participant + clerk_combine_mod(shares, p), p)
            same = bool(np.array_equal(positive(per_participant, p).cpu().numpy(), clerk))
            report("sharded_value_limb_sums", FABRIC_STREAM_P, 30, walls, exact and same)
            del secrets, rand, local, acc

            # the limb-accumulator fabric at the 61-bit scheme: torch limb dots
            wide = schemes[60]
            pw = wide.prime_modulus
            wplan = make_plan(wide, DIM, dev)
            secrets, want, rand = inputs(FABRIC_SHARE_P, 60)
            local = shard_participants(secrets, mesh)
            fn = TorchAggregator(wide, DIM, mesh=mesh).sharded_limb_accumulators()
            torch.cuda.reset_peak_memory_stats()
            acc, *walls = timed(lambda: fn(local, seed))
            k1 = limb_cuda.launches
            exact = revealed(limb_recombine_host(acc, pw).T.copy(), wide, want)
            acc = fn(local, 0, draw=_RowDraw(rand))
            report("sharded_limb_accumulators (61-bit)", FABRIC_SHARE_P, 60, walls,
                   exact and same_clerk_sums(torch.as_tensor(limb_recombine_host(acc, pw).T.copy()),
                                             secrets, rand, wplan),
                   launches={"limb_share_sum": k1})
            if k1:
                raise AssertionError("the 61-bit limb fabric launched the narrow-only limb_share_sum")
            del secrets, rand, local, acc

            # the ChaCha-masked round: K2 expands each participant's seed,
            # the masked sums go over p, the recipient re-expands every seed
            P = FABRIC_SHARE_P * 5 // 2
            secrets, want, _ = inputs(P, 30)
            seeds = np.random.default_rng(seed).integers(
                0, 1 << 32, size=(P, SEED_WORDS), dtype=np.uint64).astype(np.uint32)
            torch.cuda.reset_peak_memory_stats()

            def masked_round():
                seed_words = shard_participants(seeds.astype(np.int64), mesh)
                total = masked_sum(shard_participants(secrets, mesh), seed_words, p, mesh)
                return torch.remainder(total - combine_masks_device(seeds, DIM, p, device=dev), p)

            out, *walls = timed(masked_round)
            k2 = chacha_cuda.launches
            want_k2 = 1 + -(-P // default_chunk(DIM)) + chacha_cuda.slack_recoveries
            launches["chacha20"] = k2
            report("masked round", P, 30, walls, bool(torch.equal(out, want)),
                   launches={"chacha20": k2}, slack_recoveries=chacha_cuda.slack_recoveries)
            if k2 != want_k2:
                raise AssertionError(f"the masked round launched chacha20 {k2} times, expected {want_k2}")
            del secrets, out
            # K2 against its plain version at every shape the round gave it:
            # all of this rank's seeds at once (masked_sum), a full reveal
            # fold and the last one (combine_masks_device)
            n_blocks, fold = window_blocks(DIM, p), default_chunk(DIM)
            for label, rows in (("masked_sum", slice(0, P)), ("reveal fold", slice(0, fold)),
                                ("reveal last fold", slice(fold * ((P - 1) // fold), P))):
                keys = seed_tensor(seeds[rows], dev)
                got = chacha_blocks_cuda(keys, 0, n_blocks)
                want = chacha_blocks_torch(keys, 0, n_blocks)
                same = bool(torch.equal(got, want))
                k2_err = max(k2_err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
                _line("parity", kernel="chacha20", case=f"fabric {label} {keys.shape[0]} seeds x "
                      f"{n_blocks} blocks", shape=list(got.shape), identical=same)
                del got, want
                if not same:
                    raise AssertionError(f"chacha20 differs from its plain version (fabric {label})")
        finally:
            dist.destroy_process_group()
    return launches, k2_err


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _stage_timer(dev, seconds: dict):
    """``stage(name, fn)``: run ``fn`` between two synchronisations of
    ``dev`` and add its seconds to ``seconds[name]``."""
    def stage(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        seconds[name] += time.perf_counter() - t0
        return out

    return stage


def _mask_chunk(seed_words, values, p: int):
    """A chunk's canonical ``(C, d)`` values masked mod p with the expansion
    of their ``(C, w)`` seeds (``expand_seeds_counts``: K2), as int32."""
    import torch

    from sda_tpu_torch.ops.chacha_cuda import expand_seeds_counts

    masks, counts = expand_seeds_counts(seed_words, values.shape[1], p)
    if int(counts.min()) < values.shape[1]:
        raise AssertionError("a participant's seed window held fewer than dim draws")
    return torch.remainder(values + masks, p).to(torch.int32)


def _unmask_reveal(acc, plan, scheme, seeds):
    """The recipient's side of a masked round: recombine the limb
    accumulator, reconstruct from clerks 1..t+k (clerk 0 dropped) and
    subtract the re-expanded masks of all ``seeds`` (``combine_masks_device``:
    K2); the canonical ``(dim,)`` field sum."""
    import torch

    from sda_tpu_torch.ops.chacha_cuda import combine_masks_device
    from sda_tpu_torch.ops.modular import positive
    from sda_tpu_torch.parallel.engine import reconstruct
    from sda_tpu_torch.parallel.limbmatmul import limb_recombine

    p, dim = plan.modulus, plan.dim
    survivors = list(range(1, 1 + scheme.reconstruction_threshold))
    masked_total = reconstruct(limb_recombine(acc, p).T, survivors, scheme, dim)
    masks = combine_masks_device(seeds, dim, p, device=acc.device)
    return positive(torch.fmod(masked_total - masks, p), p)


def fedavg_round(updates, spec, scheme, seeds, global_model, generator, chunk: int = FEDAVG_CHUNK):
    """One ChaCha-masked secure FedAvg round on ``generator``'s device,
    through the port's entry points. Each of the ``P`` update pytrees is
    flattened and held to ``global_model``'s layout; per chunk of ``chunk``
    participants the updates are quantized (``spec.quantize``), masked mod p
    with the expansion of their ``(P, w)`` uint32 ``seeds``
    (``expand_seeds_counts``: K2) and shared and summed over participants
    (``share_combine_limb_cuda``: K1) into an int64 limb accumulator mod p.
    The recipient recombines the limbs, reconstructs from clerks 1..t+k
    (clerk 0 dropped), subtracts the re-expanded masks
    (``combine_masks_device``: K2), and applies the mean update
    (``dequantize_mean``) to the global model (``fedavg_apply``). On CPU
    tensors the kernels' plain versions run.

    Returns a dict: ``new_global``, ``mean`` (pytrees), ``field_sum``
    (canonical ``(dim,)`` int64), ``residues`` (the ``(P, dim)`` quantized
    updates) and the synchronised seconds of each stage and of the whole.
    """
    import torch

    from sda_tpu_torch.models import dequantize_mean, fedavg_apply, flatten_pytree, tree_layout
    from sda_tpu_torch.ops.chacha_cuda import seed_tensor
    from sda_tpu_torch.parallel import make_plan
    from sda_tpu_torch.parallel.limb_cuda import share_combine_limb_cuda

    dev = generator.device
    p = spec.modulus
    treedef, shapes, dim = tree_layout(global_model)
    plan = make_plan(scheme, dim, dev)
    seed_words = seed_tensor(seeds, dev)
    P = len(updates)
    residues = torch.empty((P, dim), dtype=torch.int64, device=dev)
    acc = torch.zeros((plan.limb_stacks.shape[0], plan.n_batches, plan.share_count),
                      dtype=torch.int64, device=dev)
    seconds = dict.fromkeys(("quantize_s", "masking_s", "sharing_s", "reveal_s", "dequantize_s"), 0.0)
    stage = _stage_timer(dev, seconds)

    def quantize(rows):
        flats = []
        for tree in updates[rows]:
            flat, tdef, tshapes = flatten_pytree(tree, dev)
            if tdef != treedef or tshapes != shapes:
                raise ValueError("an update's layout differs from the global model's")
            flats.append(flat)
        return spec.quantize(torch.stack(flats))


    def finish(field_sum):
        mean = dequantize_mean(field_sum, P, spec, treedef, shapes)
        return mean, fedavg_apply(global_model, mean, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    for start in range(0, P, chunk):
        rows = slice(start, min(start + chunk, P))
        q = stage("quantize_s", lambda: quantize(rows))
        residues[rows] = q
        masked = stage("masking_s", lambda: _mask_chunk(seed_words[rows], q, p))
        acc = stage("sharing_s", lambda: torch.fmod(acc + share_combine_limb_cuda(masked, generator, plan), p))
    field_sum = stage("reveal_s", lambda: _unmask_reveal(acc, plan, scheme, seeds))
    mean, new_global = stage("dequantize_s", lambda: finish(field_sum))
    seconds["wall_s"] = time.perf_counter() - t0
    return {"new_global": new_global, "mean": mean, "field_sum": field_sum, "residues": residues,
            "seconds": seconds}


def _sorted_flat(tree) -> "np.ndarray":
    """A two-level dict of tensors as one host float64 vector in sorted key
    order, written out by hand: the check's own statement of JAX's order."""
    import numpy as np

    return np.concatenate([tree[layer][name].detach().cpu().numpy().astype(np.float64).ravel()
                           for layer in sorted(tree) for name in sorted(tree[layer])])


def _tree_views(row, model: dict) -> dict:
    """A ``model``-shaped pytree (insertion order as in ``model``) of views
    of ``row``, whose coordinates are laid out in sorted key order."""
    import math

    offsets, offset = {}, 0
    for layer in sorted(model):
        for name in sorted(model[layer]):
            offsets[layer, name] = offset
            offset += math.prod(model[layer][name])
    return {layer: {name: row[offsets[layer, name] : offsets[layer, name] + math.prod(shape)].view(shape)
                    for name, shape in leaves.items()} for layer, leaves in model.items()}


def fedavg_phase(card: str, dev, seed: int, main_scheme, sm_clocks_per_ms: float):
    """Phase 10: a ChaCha-masked FedAvg round of ``FEDAVG_PARTICIPANTS``
    updates of the ``FEDAVG_MODEL`` CNN (``fedavg_round``), once under
    ``torch_trace`` and once timed with the kernels' launch counts read;
    checked (a) quantization against host numpy, (b) the revealed field sum
    against an int64 sum of the residues, (c) the mean within the
    quantization bound of the host mean of the clipped updates, (d)
    ``fedavg_apply`` against a host sum, (e) the launch counts; then K1 and
    K2 against their plain versions at every shape the round launched them
    at, their times at those shapes, and a ``telemetry`` line. Returns
    ``(k1 launches, k2 launches, k1 max_abs_err, k2 max_abs_err)``."""
    import math
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from sda_tpu_torch import telemetry
    from sda_tpu_torch.models import QuantizationSpec
    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.ops.chacha import chacha_blocks_torch
    from sda_tpu_torch.ops.chacha_cuda import chacha_blocks_cuda, default_chunk, seed_tensor, window_blocks
    from sda_tpu_torch.ops.modular import positive
    from sda_tpu_torch.parallel import TorchAggregator, engine, limb_cuda, make_plan
    from sda_tpu_torch.parallel.limb_cuda import share_limb_sums_cuda, share_limb_sums_torch
    from sda_tpu_torch.utils import torch_trace

    spec, scheme = QuantizationSpec.fitted(FEDAVG_FRAC_BITS, FEDAVG_CLIP, FEDAVG_PARTICIPANTS)
    p = spec.modulus
    P = FEDAVG_PARTICIPANTS
    dim = sum(math.prod(s) for leaves in FEDAVG_MODEL.values() for s in leaves.values())
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat_updates = 2.0 * torch.randn((P, dim), generator=gen, dtype=torch.float64, device=dev)
    updates = [_tree_views(row, FEDAVG_MODEL) for row in flat_updates]
    global_model = {layer: {name: 0.05 * torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                            for name, shape in leaves.items()} for layer, leaves in FEDAVG_MODEL.items()}
    seeds = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(P, SEED_WORDS), dtype=np.uint64).astype(np.uint32)

    with tempfile.TemporaryDirectory() as log_dir:
        with torch_trace(log_dir) as prof:
            traced = fedavg_round(updates, spec, scheme, seeds, global_model, gen)
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA) / 1e3
        traces = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
        trace_bytes = sum(os.path.getsize(f) for f in traces)
        kernel_events = sum(Path(f).read_text().count('"cat": "kernel"') for f in traces)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    limb_cuda.launches = chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
    out = fedavg_round(updates, spec, scheme, seeds, global_model, gen)
    launches = {"limb_share_sum": limb_cuda.launches, "chacha20": chacha_cuda.launches}
    recoveries = chacha_cuda.slack_recoveries
    peak = torch.cuda.max_memory_allocated()

    # (a) quantization against host numpy on the same updates
    host = flat_updates.cpu().numpy()
    clipped = np.clip(host, -FEDAVG_CLIP, FEDAVG_CLIP)
    quantized = np.rint(clipped * 2.0**FEDAVG_FRAC_BITS).astype(np.int64) % p
    quantize_ok = bool(np.array_equal(out["residues"].cpu().numpy(), quantized))
    del quantized
    # (b) the revealed field sum against an int64 sum of the residues
    field_sum = out["field_sum"]
    sum_ok = bool(torch.equal(field_sum, torch.sum(out["residues"], dim=0) % p))
    # (c) the mean against the host mean of the clipped updates
    mean = _sorted_flat(out["mean"])
    max_mean_err = float(np.abs(mean - clipped.mean(axis=0)).max())
    shapes_ok = all(tuple(out["mean"][layer][name].shape) == shape
                    for layer, leaves in FEDAVG_MODEL.items() for name, shape in leaves.items())
    # (d) fedavg_apply against a host float64 sum, leaf by leaf
    apply_ok = all(np.array_equal(
        out["new_global"][layer][name].cpu().numpy(),
        global_model[layer][name].cpu().numpy().astype(np.float64) + out["mean"][layer][name].cpu().numpy())
        for layer, leaves in FEDAVG_MODEL.items() for name in leaves)
    same_as_traced = bool(torch.equal(traced["field_sum"], field_sum))
    traced_wall_ms = traced["seconds"]["wall_s"] * 1e3
    del host, clipped, traced
    # (e) launches: one K1 and one K2 per chunk, one K2 per reveal fold
    chunks = -(-P // FEDAVG_CHUNK)
    fold = default_chunk(dim)
    want = {"limb_share_sum": chunks, "chacha20": chunks + -(-P // fold) + recoveries}
    exact = quantize_ok and sum_ok and shapes_ok and apply_ok and same_as_traced
    _line("fedavg round", participants=P, dim=dim, modulus=p, omega_secrets=scheme.omega_secrets,
          omega_shares=scheme.omega_shares, frac_bits=FEDAVG_FRAC_BITS, clip=FEDAVG_CLIP, chunk=FEDAVG_CHUNK,
          reveal_chunk=fold, **out["seconds"], launches=launches, slack_recoveries=recoveries,
          max_mean_err=max_mean_err, bound=2.0 ** -(FEDAVG_FRAC_BITS + 1), exact=exact,
          checks={"quantize": quantize_ok, "field_sum": sum_ok, "mean_shapes": shapes_ok,
                  "fedavg_apply": apply_ok, "traced_round_same": same_as_traced},
          peak_bytes=peak, trace_files=len(traces), trace_bytes=trace_bytes,
          trace_kernel_events=kernel_events, traced_wall_ms=traced_wall_ms,
          traced_device_busy_ms=busy_ms, traced_busy_share=busy_ms / traced_wall_ms, card=card)
    if not exact:
        raise AssertionError("fedavg round: a check failed")
    if max_mean_err > 2.0 ** -(FEDAVG_FRAC_BITS + 1):
        raise AssertionError(f"fedavg round: mean error {max_mean_err} above the quantization bound")
    if launches != want:
        raise AssertionError(f"fedavg round launched {launches}, expected {want}")
    if not kernel_events:
        raise AssertionError("the fedavg round's trace holds no device kernel")
    del out, updates, flat_updates

    # K1 against its plain version at the round's shape: d % 4 == 2, so every
    # stage takes the kernel's unaligned copy path, not TMA
    plan = make_plan(scheme, dim, dev)
    stacks = plan.limb_stacks
    secrets = torch.randint(0, p, (FEDAVG_CHUNK, dim), generator=gen, dtype=torch.int32, device=dev)
    rand = torch.randint(0, p, (FEDAVG_CHUNK, plan.n_batches, plan.rand_size), generator=gen,
                         dtype=torch.int32, device=dev)
    got = share_limb_sums_cuda(secrets, rand, stacks, plan.input_size)
    want_k1 = share_limb_sums_torch(secrets, rand, stacks, plan.input_size)
    k1_err = int((got.to(torch.int64) - want_k1.to(torch.int64)).abs().max())
    same = bool(torch.equal(got, want_k1))
    _line("parity", kernel="limb_share_sum", entry="secrets+randomness", case=f"fedavg chunk (d % 4 = {dim % 4})",
          shape=[list(secrets.shape), list(rand.shape)], out=list(got.shape), identical=same)
    del got, want_k1
    if not same:
        raise AssertionError("limb_share_sum differs from its plain version (fedavg chunk)")
    # K2 against its plain version at the masking chunk and both reveal folds
    n_blocks = window_blocks(dim, p)
    k2_err = 0
    for label, rows in (("masking chunk", slice(0, FEDAVG_CHUNK)), ("reveal fold", slice(0, fold)),
                        ("reveal last fold", slice(fold * ((P - 1) // fold), P))):
        keys = seed_tensor(seeds[rows], dev)
        got = chacha_blocks_cuda(keys, 0, n_blocks)
        want_k2 = chacha_blocks_torch(keys, 0, n_blocks)
        same = bool(torch.equal(got, want_k2))
        k2_err = max(k2_err, int((got.to(torch.int64) - want_k2.to(torch.int64)).abs().max()))
        _line("parity", kernel="chacha20", case=f"fedavg {label} {keys.shape[0]} seeds x {n_blocks} blocks",
              shape=list(got.shape), identical=same)
        del got, want_k2
        if not same:
            raise AssertionError(f"chacha20 differs from its plain version (fedavg {label})")

    # each kernel's own time at the round's shapes, its plain version's, its bound
    # (K2's own time by the profiler, which saw only half of its launches
    # at this shape in one run, is printed beside its wrapper's by CUDA
    # events, not asserted)
    def k1():
        return share_limb_sums_cuda(secrets, rand, stacks, plan.input_size)

    k1_ms = [_kernel_ms(k1, 10, "limb_share_sum") for _ in range(2)]
    k1_wrapper = _time_ms(k1, iters=10, warmup=2)
    k1_plain = _time_ms(lambda: share_limb_sums_torch(secrets, rand, stacks, plan.input_size), iters=2)
    moved, ops, bytes_ms, ops_ms = _k1_bound(secrets, rand, stacks)
    _line("numbers", kernel="limb_share_sum", path="fedavg round", shape=[list(secrets.shape), list(rand.shape)],
          kernel_ms=k1_ms, wrapper_ms=k1_wrapper, plain_ms=k1_plain, bytes=moved, int8_ops=ops,
          bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms,
          launches=launches["limb_share_sum"], card=card)
    keys = seed_tensor(seeds[:FEDAVG_CHUNK], dev)

    def k2():
        return chacha_blocks_cuda(keys, 0, n_blocks)

    k2_wrapper = [_time_ms(k2, iters=10, warmup=2) for _ in range(2)]
    seen, seen_ms = _profiled(k2, 10, "chacha20")
    k2_plain = _time_ms(lambda: chacha_blocks_torch(keys, 0, n_blocks), iters=2)
    moved, ops, int_ops, bytes_ms, ops_ms = _k2_bound(FEDAVG_CHUNK, n_blocks, sm_clocks_per_ms)
    _line("numbers", kernel="chacha20", path="fedavg round", shape=[FEDAVG_CHUNK, n_blocks, 16],
          event_ms=_k2_event_ms(keys, n_blocks), wrapper_ms=k2_wrapper,
          profiler={"launches_seen": seen, "of": 10,
                    "ms_per_seen": seen_ms / seen if seen else None},
          plain_ms=k2_plain, bytes=moved, int32_ops=ops, int_pipe_ops=int_ops,
          bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms,
          launches=launches["chacha20"], card=card)
    del secrets, rand

    # telemetry: the fabrics' collective bytes accumulated over phase 9, then
    # the step histogram and span of one secure_sum at the main path's scheme
    psum_bytes = engine.fabric_bytes()
    telemetry.reset()
    mp = main_scheme.prime_modulus
    small = torch.randint(0, mp, (2_000, 1_000), generator=gen, dtype=torch.int64, device=dev)
    agg = TorchAggregator(main_scheme, 1_000)
    got = positive(agg.secure_sum(small, gen, indices=list(range(1, 1 + main_scheme.reconstruction_threshold))), mp)
    snap = telemetry.snapshot()
    steps = {h["labels"]["step"]: h["count"] for h in snap["histograms"] if h["name"] == engine.STEP_SECONDS}
    spans = [{"name": s["name"], "attrs": s["attrs"]} for s in snap["spans"]]
    ok = (bool(torch.equal(got, torch.sum(small, dim=0) % mp))
          and steps == {"share": 1, "combine": 1, "reconstruct": 1}
          and spans == [{"name": "engine.secure_sum", "attrs": {"dim": 1_000}}])
    _line("telemetry", enabled=snap["enabled"], sda_engine_step_seconds=steps, spans=spans,
          sda_engine_psum_bytes_total=psum_bytes, ok=ok)
    if not ok:
        raise AssertionError("telemetry: secure_sum's steps or span differ from one call's")
    return launches["limb_share_sum"], launches["chacha20"], k1_err, k2_err


# phase 13: the model plane's remaining drivers, each over engine rounds at
# the width of the FEDAVG_MODEL CNN: weighted FedAvg (the ``(w·x, w)`` wire)
# with server momentum (FedAvgM), and distributed-DP FedAvg (discrete
# Gaussian noise drawn on the card, the zCDP accountant) with server Adam
# (FedAdam), MODEL_ROUNDS rounds each. The cohort per round is the paper's
# C = 0.1 of K = 100 clients (McMahan et al., AISTATS 2017, section 3)
MODEL_COHORT, MODEL_ROUNDS = 10, 2
# update coordinates: UPDATE_SCALE x N(0, 1), clamped to the weighted clip
UPDATE_SCALE = 0.05
# weighted: a client's weight is its sample count, at most the 600 examples
# an MNIST client holds in the paper (60,000 over K = 100); coordinates
# bounded by 1.0; 15 fractional bits keep the field under 2^31 for K1
WEIGHTED_FRAC_BITS, WEIGHTED_CLIP, WEIGHTED_MAX_WEIGHT = 15, 1.0, 600
# DP-FedAvg (McMahan et al., ICLR 2018): updates clipped to L2 norm 1.0,
# noise multiplier 1.0, delta 1e-6 (the reference's default)
DP_FRAC_BITS, DP_L2_CLIP, DP_NOISE_MULTIPLIER, DP_DELTA = 16, 1.0, 1.0, 1e-6


def model_round(fed, updates, global_model, optimizer, scheme, seeds, generator, weights=None,
                chunk: int = FEDAVG_CHUNK):
    """One engine round of a model-plane driver on ``generator``'s device,
    through the port's entry points: each participant's wire vector
    (``fed.wire``: the quantized update, ``(w·x, w)`` with ``weights``, plus
    the party's noise for a DP driver), per chunk of ``chunk`` masked mod p
    with the expansion of its ``(P, w)`` uint32 ``seeds`` (K2) and shared
    and summed over participants (K1); the recipient reveals the field sum
    from clerks 1..t+k (K2 unmasks), ``fed.mean_from_field_sum`` makes the mean
    (and the total weight) of it, and ``optimizer`` applies the mean to
    ``global_model``. On CPU tensors the kernels' plain versions run.

    Returns a dict: ``wires`` (the ``(P, w)`` int64 vectors), ``field_sum``,
    ``mean``, ``total_weight`` (None without ``weights``), ``new_global``
    and the synchronised seconds of each stage and of the whole.
    """
    import torch

    from sda_tpu_torch.ops.chacha_cuda import seed_tensor
    from sda_tpu_torch.parallel import make_plan
    from sda_tpu_torch.parallel.limb_cuda import share_combine_limb_cuda

    dev = generator.device
    p, width = fed.spec.modulus, fed.wire_dimension
    plan = make_plan(scheme, width, dev)
    seed_words = seed_tensor(seeds, dev)
    P = len(updates)
    wires = torch.empty((P, width), dtype=torch.int64, device=dev)
    acc = torch.zeros((plan.limb_stacks.shape[0], plan.n_batches, plan.share_count),
                      dtype=torch.int64, device=dev)
    seconds = dict.fromkeys(("wire_s", "masking_s", "sharing_s", "reveal_s", "finish_s", "apply_s"), 0.0)
    stage = _stage_timer(dev, seconds)

    def wire(rows):
        if weights is None:
            return torch.stack([fed.wire(u) for u in updates[rows]])
        return torch.stack([fed.wire(u, w) for u, w in zip(updates[rows], weights[rows])])

    _sync(dev)
    t0 = time.perf_counter()
    for start in range(0, P, chunk):
        rows = slice(start, min(start + chunk, P))
        wires[rows] = stage("wire_s", lambda: wire(rows))
        masked = stage("masking_s", lambda: _mask_chunk(seed_words[rows], wires[rows], p))
        acc = stage("sharing_s", lambda: torch.fmod(acc + share_combine_limb_cuda(masked, generator, plan), p))
    field_sum = stage("reveal_s", lambda: _unmask_reveal(acc, plan, scheme, seeds))
    out = stage("finish_s", lambda: fed.mean_from_field_sum(field_sum, P))
    mean, total_weight = out if weights is not None else (out, None)
    new_global = stage("apply_s", lambda: optimizer(global_model, mean))
    seconds["wall_s"] = time.perf_counter() - t0
    return {"wires": wires, "field_sum": field_sum, "mean": mean, "total_weight": total_weight,
            "new_global": new_global, "seconds": seconds}


class _HostFedAvgM:
    """The check's own statement of server momentum in numpy float64
    (Reddi et al. 2021; the reference's ``FedAvgM``)."""

    def __init__(self, momentum: float = 0.9, lr: float = 1.0):
        self.momentum, self.lr, self.v = momentum, lr, None

    def __call__(self, w, u):
        import numpy as np

        self.v = np.zeros_like(w) if self.v is None else self.v
        self.v = self.momentum * self.v + u
        return w + self.lr * self.v


class _HostFedAdam:
    """The check's own statement of server Adam in numpy float64 (Reddi et
    al. 2021, Alg. 2; the reference's ``FedAdam``)."""

    def __init__(self, lr: float = 0.1, beta1: float = 0.9, beta2: float = 0.99, tau: float = 1e-3):
        self.lr, self.beta1, self.beta2, self.tau = lr, beta1, beta2, tau
        self.m = self.v = None
        self.t = 0

    def __call__(self, w, g):
        import numpy as np

        if self.m is None:
            self.m, self.v = np.zeros_like(w), np.zeros_like(w)
        self.t += 1
        self.m = self.beta1 * self.m + (1 - self.beta1) * g
        self.v = self.beta2 * self.v + (1 - self.beta2) * g * g
        m_hat = self.m / (1 - self.beta1 ** self.t)
        v_hat = self.v / (1 - self.beta2 ** self.t)
        return w + self.lr * m_hat / (np.sqrt(v_hat) + self.tau)


def _centered(v, p: int):
    import numpy as np

    return np.where(v > p // 2, v - p, v)


def model_rounds_phase(card: str, dev, seed: int, sm_clocks_per_ms: float):
    """Phase 13: MODEL_ROUNDS ``model_round``s of ``MODEL_COHORT`` clients of
    the ``FEDAVG_MODEL`` CNN for each of two drivers, the kernels' launches
    counted per round: ``WeightedFederatedAveraging`` with sample-count
    weights under ``FedAvgM``, and ``DPFederatedAveraging`` under
    ``FedAdam``. Each round is held to (a) its wire vectors against host
    numpy's quantization of the same updates (for DP: the noise they carry,
    against the discrete Gaussian's spread), (b) the revealed field sum
    against an int64 sum of the wires mod p, (c) the mean against host
    numpy (weighted: within the quantization bound of the exact weighted
    mean, the total weight exact; DP: bit-equal to numpy's dequantization
    of the field sum, and the privacy account against its formula), (d)
    the server step against the check's own numpy statement of the
    optimizer, bit-equal, (e) the launch counts. Then the composed privacy
    of the DP rounds, K1 and K2 against their plain versions at every shape
    the rounds launched them at, and their times there. Returns ``(k1
    launches, k2 launches, k1 max_abs_err, k2 max_abs_err)``."""
    import math

    import numpy as np
    import torch

    from sda_tpu_torch.models import (
        DPConfig,
        DPFederatedAveraging,
        FedAdam,
        FedAvgM,
        WeightedFederatedAveraging,
        compose_accounts,
    )
    from sda_tpu_torch.models.dp import NOISE_TAIL_SIGMAS
    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.ops.chacha import chacha_blocks_torch
    from sda_tpu_torch.ops.chacha_cuda import chacha_blocks_cuda, default_chunk, seed_tensor, window_blocks
    from sda_tpu_torch.parallel import limb_cuda, make_plan
    from sda_tpu_torch.parallel.limb_cuda import share_limb_sums_cuda, share_limb_sums_torch

    P = MODEL_COHORT
    dim = sum(math.prod(s) for leaves in FEDAVG_MODEL.values() for s in leaves.values())
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    global0 = {layer: {name: 0.05 * torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                       for name, shape in leaves.items()} for layer, leaves in FEDAVG_MODEL.items()}
    weighted, weighted_scheme = WeightedFederatedAveraging.fitted(
        WEIGHTED_FRAC_BITS, WEIGHTED_CLIP, WEIGHTED_MAX_WEIGHT, P, global0, device=dev)
    dp = DPConfig(l2_clip=DP_L2_CLIP, noise_multiplier=DP_NOISE_MULTIPLIER, expected_participants=P,
                  delta=DP_DELTA)
    dp_spec, dp_scheme = DPFederatedAveraging.fitted_spec(DP_FRAC_BITS, dp, dim)
    dp_fed = DPFederatedAveraging(dp_spec, global0, dp, torch.Generator(device=dev).manual_seed(seed + 1),
                                  device=dev)
    drivers = [("weighted", weighted, weighted_scheme, FedAvgM(device=dev), _HostFedAvgM()),
               ("dp", dp_fed, dp_scheme, FedAdam(device=dev), _HostFedAdam())]
    k1_total = k2_total = 0
    accounts = []
    for label, fed, scheme, optimizer, host_optimizer in drivers:
        spec = fed.spec
        p, scale = spec.modulus, spec.scale
        global_model = global0
        host_global = _sorted_flat(global0)
        for round_index in range(MODEL_ROUNDS):
            flat_updates = torch.clamp(
                UPDATE_SCALE * torch.randn((P, dim), generator=gen, dtype=torch.float64, device=dev),
                -WEIGHTED_CLIP, WEIGHTED_CLIP)
            updates = [_tree_views(row, FEDAVG_MODEL) for row in flat_updates]
            weights = ([int(w) for w in rng.integers(1, WEIGHTED_MAX_WEIGHT + 1, size=P)]
                       if label == "weighted" else None)
            seeds = rng.integers(0, 1 << 32, size=(P, SEED_WORDS), dtype=np.uint64).astype(np.uint32)
            torch.cuda.synchronize()
            limb_cuda.launches = chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
            out = model_round(fed, updates, global_model, optimizer, scheme, seeds, gen, weights)
            launches = {"limb_share_sum": limb_cuda.launches, "chacha20": chacha_cuda.launches}
            recoveries = chacha_cuda.slack_recoveries

            host = flat_updates.cpu().numpy()
            wires = out["wires"].cpu().numpy()
            field_sum = out["field_sum"].cpu().numpy()
            # (b) the revealed field sum against an int64 sum of the wires
            sum_ok = bool(np.array_equal(field_sum, wires.sum(axis=0) % p))
            extra = {}
            if weights is not None:
                # (a) the (w·x, w) wires against host numpy's quantization
                w = np.asarray(weights, dtype=np.float64)
                channel = np.concatenate([host * w[:, None], w[:, None]], axis=1)
                want_wires = np.rint(np.clip(channel, -spec.clip, spec.clip) * scale).astype(np.int64) % p
                wire_ok = bool(np.array_equal(wires, want_wires))
                # (c) the weighted mean within the quantization bound: each
                # w·x rounds by at most 2^-(f+1), so the sum by P times that,
                # over the exact total weight; 2^-40 of float64 slack
                total = float(w.sum())
                exact_mean = (w[:, None] * host).sum(axis=0) / total
                max_mean_err = float(np.abs(_sorted_flat(out["mean"]) - exact_mean).max())
                bound = P * 2.0 ** -(spec.frac_bits + 1) / total + 2.0 ** -40
                mean_ok = max_mean_err <= bound and out["total_weight"] == total
                extra = {"total_weight": out["total_weight"], "max_mean_err": max_mean_err, "bound": bound}
            else:
                # (a) the noise each wire carries: the wire less host numpy's
                # clipped quantization of the same update, centred, pooled
                # over the cohort; its spread against the party's sigma
                norms = np.linalg.norm(host, axis=1)
                clipped = host * np.where(norms > DP_L2_CLIP, DP_L2_CLIP / norms, 1.0)[:, None]
                clean = np.rint(np.clip(clipped, -spec.clip, spec.clip) * scale).astype(np.int64) % p
                noise = _centered((wires - clean) % p, p)
                sigma = dp.sigma_party_field(scale, dim)
                std_ratio = float(noise.std() / sigma)
                mean_z = float(noise.mean() / (sigma / math.sqrt(noise.size)))
                tail = float(np.abs(noise).max() / sigma)
                wire_ok = abs(std_ratio - 1.0) < 0.01 and abs(mean_z) < 6.0 and tail <= NOISE_TAIL_SIGMAS
                # (c) the mean bit-equal to numpy's dequantization, and the
                # realized account against the formula
                want_mean = _centered(field_sum, p).astype(np.float64) / scale / P
                account = fed.privacy()
                sens = DP_L2_CLIP * scale + 0.5 * math.sqrt(dim)
                sigma_total = DP_NOISE_MULTIPLIER * sens
                rho = sens * sens / (2.0 * sigma_total * sigma_total)
                classic = rho + 2.0 * math.sqrt(rho * math.log(1.0 / DP_DELTA))
                mean_ok = (bool(np.array_equal(_sorted_flat(out["mean"]), want_mean))
                           and account.n_parties == P and math.isclose(account.rho, rho, rel_tol=1e-12)
                           and rho < account.epsilon <= classic)
                accounts.append(account)
                extra = {"sigma_party": sigma, "noise_std_ratio": std_ratio, "noise_mean_z": mean_z,
                         "noise_max_sigmas": tail, "epsilon": account.epsilon, "rho": account.rho,
                         "delta": account.delta}
            # (d) the server step against numpy
            host_global = host_optimizer(host_global, _sorted_flat(out["mean"]))
            apply_ok = bool(np.array_equal(_sorted_flat(out["new_global"]), host_global))
            # (e) one K1 and one K2 per chunk, one K2 per reveal fold
            chunks = -(-P // FEDAVG_CHUNK)
            want = {"limb_share_sum": chunks,
                    "chacha20": chunks + -(-P // default_chunk(fed.wire_dimension)) + recoveries}
            exact = wire_ok and sum_ok and mean_ok and apply_ok
            _line("model round", driver=label, round=round_index, participants=P, wire_dim=fed.wire_dimension,
                  modulus=p, omega_secrets=scheme.omega_secrets, omega_shares=scheme.omega_shares,
                  frac_bits=spec.frac_bits, optimizer=type(optimizer).__name__, **out["seconds"],
                  launches=launches, slack_recoveries=recoveries, **extra, exact=exact,
                  checks={"wire": wire_ok, "field_sum": sum_ok, "mean": mean_ok, "server_step": apply_ok},
                  card=card)
            if not exact:
                raise AssertionError(f"model round ({label}, round {round_index}): a check failed")
            if launches != want:
                raise AssertionError(f"model round ({label}) launched {launches}, expected {want}")
            k1_total += launches["limb_share_sum"]
            k2_total += launches["chacha20"]
            global_model = out["new_global"]
            del out, updates, flat_updates, host, wires
    composed = compose_accounts(accounts)
    _line("privacy", driver="dp", rounds=composed.rounds, epsilon=composed.epsilon, rho=composed.rho,
          delta=composed.delta, per_round_epsilon=[a.epsilon for a in accounts])
    if not (composed.rounds == MODEL_ROUNDS and composed.epsilon > max(a.epsilon for a in accounts)):
        raise AssertionError("composed privacy does not grow over the rounds")

    # K1 and K2 against their plain versions at each driver's launch shapes
    k1_err = k2_err = 0
    timing = None
    for label, fed, scheme, _, _ in drivers:
        width, p = fed.wire_dimension, fed.spec.modulus
        plan = make_plan(scheme, width, dev)
        stacks = plan.limb_stacks
        secrets = torch.randint(0, p, (P, width), generator=gen, dtype=torch.int32, device=dev)
        rand = torch.randint(0, p, (P, plan.n_batches, plan.rand_size), generator=gen, dtype=torch.int32,
                             device=dev)
        got = share_limb_sums_cuda(secrets, rand, stacks, plan.input_size)
        want_k1 = share_limb_sums_torch(secrets, rand, stacks, plan.input_size)
        k1_err = max(k1_err, int((got.to(torch.int64) - want_k1.to(torch.int64)).abs().max()))
        same = bool(torch.equal(got, want_k1))
        _line("parity", kernel="limb_share_sum", entry="secrets+randomness",
              case=f"{label} round chunk (d % 4 = {width % 4}, L = {stacks.shape[0]})",
              shape=[list(secrets.shape), list(rand.shape)], out=list(got.shape), identical=same)
        del got, want_k1
        if not same:
            raise AssertionError(f"limb_share_sum differs from its plain version ({label} round)")
        n_blocks = window_blocks(width, p)
        keys = seed_tensor(rng.integers(0, 1 << 32, size=(P, SEED_WORDS), dtype=np.uint64).astype(np.uint32),
                           dev)
        got = chacha_blocks_cuda(keys, 0, n_blocks)
        want_k2 = chacha_blocks_torch(keys, 0, n_blocks)
        k2_err = max(k2_err, int((got.to(torch.int64) - want_k2.to(torch.int64)).abs().max()))
        same = bool(torch.equal(got, want_k2))
        _line("parity", kernel="chacha20", case=f"{label} round masking and reveal fold {P} seeds x "
              f"{n_blocks} blocks", shape=list(got.shape), identical=same)
        del got, want_k2
        if not same:
            raise AssertionError(f"chacha20 differs from its plain version ({label} round)")
        if label == "weighted":
            timing = (secrets, rand, stacks, plan.input_size, keys, n_blocks)
        else:
            del secrets, rand

    # each kernel's own time at the weighted round's shapes, its plain
    # version's, its bound
    secrets, rand, stacks, k, keys, n_blocks = timing

    def k1():
        return share_limb_sums_cuda(secrets, rand, stacks, k)

    k1_plain = _time_ms(lambda: share_limb_sums_torch(secrets, rand, stacks, k), iters=2)
    k1_ms = [_kernel_ms(k1, 10, "limb_share_sum") for _ in range(2)]
    k1_wrapper = _time_ms(k1, iters=10, warmup=2)
    moved, ops, bytes_ms, ops_ms = _k1_bound(secrets, rand, stacks)
    _line("numbers", kernel="limb_share_sum", path="model rounds", shape=[list(secrets.shape), list(rand.shape)],
          kernel_ms=k1_ms, wrapper_ms=k1_wrapper, plain_ms=k1_plain, bytes=moved, int8_ops=ops,
          bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=None,
          launches=k1_total, card=card)

    def k2():
        return chacha_blocks_cuda(keys, 0, n_blocks)

    k2_plain = _time_ms(lambda: chacha_blocks_torch(keys, 0, n_blocks), iters=2)
    k2_wrapper = [_time_ms(k2, iters=10, warmup=2) for _ in range(2)]
    seen, seen_ms = _profiled(k2, 10, "chacha20")
    moved, ops, int_ops, bytes_ms, ops_ms = _k2_bound(P, n_blocks, sm_clocks_per_ms)
    _line("numbers", kernel="chacha20", path="model rounds", shape=[P, n_blocks, 16],
          event_ms=_k2_event_ms(keys, n_blocks), wrapper_ms=k2_wrapper,
          profiler={"launches_seen": seen, "of": 10,
                    "ms_per_seen": seen_ms / seen if seen else None},
          plain_ms=k2_plain, bytes=moved, int32_ops=ops, int_pipe_ops=int_ops,
          bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=None,
          launches=k2_total, card=card)
    return k1_total, k2_total, k1_err, k2_err


# phase 11: ``python -m sda_tpu_torch.bench`` runs, by label. In this process
# (``bench.run``), without the parity items, which the first command-line run
# holds: each participant route at bench.py's participant preset (100,000 x
# 10,000 in chunks of 2,000) and the sum-first quick preset's two cheaper
# checks. Then as subprocesses, the last stdout line parsed: the north star
# and the K1 route with the ``--roofline`` decomposition, and a run with an
# injected fault, which must exit 1.
BENCH_RUNS = {
    "participant int64": ["--engine", "participant", "--no-limbs"],
    "participant limbs": ["--engine", "participant"],
    "participant kernel": ["--engine", "participant", "--kernel"],
    "participant wide": ["--engine", "participant", "--wide"],
    "sum-first quick probe": ["--quick", "--check", "probe"],
    "sum-first quick off": ["--quick", "--check", "off"],
}
BENCH_CLI_RUNS = {
    "sum-first north star roofline": ["--roofline"],
    "participant kernel roofline": ["--engine", "participant", "--kernel", "--roofline", "--no-parity"],
}
BENCH_FAULT_RUN = ["--quick", "--no-parity"]


def _module_cli(module: str, argv, timeout: int, env=None):
    """``python -m module *argv`` from the checkout's root: its exit code,
    stdout and stderr."""
    out = subprocess.run([sys.executable, "-m", module, *argv],
                         cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr


def _bench_cli(argv, env=None, timeout: int = 600):
    """``python -m sda_tpu_torch.bench *argv`` from the checkout's root:
    its exit code, its last stdout line as JSON, and its stderr."""
    rc, out, err = _module_cli("sda_tpu_torch.bench", argv, timeout, env)
    lines = out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err


def bench_phase(card: str) -> int:
    """Phase 11: ``sda_tpu_torch.bench`` on the card once per engine route
    (``BENCH_RUNS``, ``BENCH_CLI_RUNS``), each verified with its whole
    stream run (no budget cut), with one ``bench`` line each; then the fault
    run. K1's launches on the ``--kernel`` route are counted from 0 around
    the in-process run and held against its chunk count. Returns them."""
    import torch

    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.parallel import limb_cuda

    k1 = None
    for label, argv in BENCH_RUNS.items():
        args = bench.parse_args([*argv, "--no-parity"])
        limb_cuda.launches = chacha_cuda.launches = 0
        line = bench.run(args)
        launches = {"limb_share_sum": limb_cuda.launches, "chacha20": chacha_cuda.launches}
        _line("bench", run=label, argv=argv, **line)
        chunks = args.participants // args.chunk
        want = {"limb_share_sum": chunks if args.kernel else 0, "chacha20": 0}
        if not line["verified"] or line.get("partial") or line["participants"] != args.participants:
            raise AssertionError(f"bench {label}: not a whole verified stream: {line}")
        if launches != want or line["launches"] != want:
            raise AssertionError(f"bench {label}: launches {launches} (line {line['launches']}), expected {want}")
        if args.kernel:
            k1 = launches["limb_share_sum"]
    torch.cuda.empty_cache()  # the subprocesses share the card with this one
    # the device plane only: the nine protocol-plane riders run in phase 23
    quiet = {**os.environ, "SDA_BENCH_RIDERS": "0"}
    for label, argv in BENCH_CLI_RUNS.items():
        rc, line, err = _bench_cli(argv, env=quiet)
        decomposition = (line or {}).get("roofline", {}).get("decomposition", {})
        if line is not None:
            _line("bench", run=label, argv=argv, rc=rc, **line)
        if rc != 0 or not (line or {}).get("verified") or "binding_stage" not in decomposition:
            raise AssertionError(f"bench {label}: rc {rc}, line {line}; stderr tail:\n{err[-3000:]}")
    env = {**quiet, "SDA_BENCH_INJECT_FAULT": "1"}
    rc, line, err = _bench_cli(BENCH_FAULT_RUN, env=env)
    caught = rc == 1 and "verification failed" in (line or {}).get("error", "")
    _line("bench fault", argv=BENCH_FAULT_RUN, rc=rc, line=line, caught=caught, card=card)
    if not caught:
        raise AssertionError(f"bench fault run: rc {rc}, line {line}; stderr tail:\n{err[-3000:]}")
    return k1


# phase 12: the last device-plane drivers, each as a user runs it, from the
# checkout's root: the baseline ladder's device rows (``LADDER_ARGV``; every
# row at full size: 1,000 x 100,000, 10,000 x 10,000 and 100,000 x 50,000)
# and the secure-sum fabric demo on the visible cards
LADDER_ARGV = ["--configs", "2,3,4"]
DEMO_OK_LINES = 3
# config 3's scheme (scripts/baseline_ladder.py:391-460): basic Shamir t=2,
# n=5 at a 21-bit prime, dim 10,000, chunks of 2,000: K1 at K = k + t = 3,
# L = 3 limbs and 5 of a tile's 8 clerks
LADDER_K1 = {"share_count": 5, "privacy_threshold": 2, "prime_modulus": 1048583}
LADDER_K1_DIM, LADDER_K1_CHUNK = 10_000, 2_000


def drivers_phase(card: str, dev, seed: int) -> tuple[int, int]:
    """Phase 12: ``python -m sda_tpu_torch.baseline_ladder`` (one ``ladder``
    line per row; every row must be whole, verified and error-free, and
    config 3 must launch K1 once per 2,000-row chunk), K1 against its plain
    version at config 3's launch shape through both entries and its
    ``numbers`` line there, then ``python -m
    sda_tpu_torch.examples.secure_sum_fabric`` (its three OK lines). Returns
    config 3's K1 launches and the parity's largest difference."""
    import math

    import torch

    from sda_tpu_torch.parallel import make_plan
    from sda_tpu_torch.parallel.limb_cuda import (
        participant_limb_sums_cuda,
        participant_limb_sums_torch,
        share_limb_sums_cuda,
        share_limb_sums_torch,
    )
    from sda_tpu_torch.protocol import BasicShamirSharing

    torch.cuda.empty_cache()  # the subprocesses share the card with this one
    t0 = time.perf_counter()
    rc, out, err = _module_cli("sda_tpu_torch.baseline_ladder", LADDER_ARGV, timeout=900)
    ladder_s = time.perf_counter() - t0
    try:
        payload = json.loads(out)
    except json.JSONDecodeError:
        raise AssertionError(f"ladder: rc {rc}, no JSON payload; stderr tail:\n{err[-3000:]}") from None
    rows = payload["configs"]
    for row in rows:
        _line("ladder", argv=LADDER_ARGV, **row)
    k1 = None
    for row in rows:
        if not row.get("verified") or "error" in row or row.get("partial"):
            raise AssertionError(f"ladder row not whole and verified: {row}")
        if row["config"].startswith("3-device"):
            k1 = row["launches"]["limb_share_sum"]
            want = math.ceil(row["participants"] / LADDER_K1_CHUNK)
            if k1 != want:
                raise AssertionError(f"ladder config 3 launched limb_share_sum {k1} times, expected {want}")
    if rc != 0 or len(rows) != 3 or k1 is None:
        raise AssertionError(f"ladder: rc {rc}, {len(rows)} rows; stderr tail:\n{err[-3000:]}")
    _line("ladder run", argv=LADDER_ARGV, rc=rc, wall_s=ladder_s, card=payload["card"],
          power_limit=payload["power_limit"])

    # K1 at config 3's launch shape, through both entries, and its numbers
    scheme = BasicShamirSharing(**LADDER_K1)
    plan = make_plan(scheme, LADDER_K1_DIM, dev)
    p, k, t, stacks = plan.modulus, plan.input_size, plan.rand_size, plan.limb_stacks
    gen = torch.Generator(device=dev).manual_seed(seed)

    def canonical(shape):
        return torch.randint(0, p, shape, generator=gen, dtype=torch.int32, device=dev)

    C, nb = LADDER_K1_CHUNK, plan.n_batches
    secrets, rand, values = canonical((C, LADDER_K1_DIM)), canonical((C, nb, t)), canonical((C, nb, k + t))
    max_err = 0
    for entry, got, want, shape in (
        ("values", participant_limb_sums_cuda(values, stacks),
         participant_limb_sums_torch(values, stacks), [list(values.shape)]),
        ("secrets+randomness", share_limb_sums_cuda(secrets, rand, stacks, k),
         share_limb_sums_torch(secrets, rand, stacks, k), [list(secrets.shape), list(rand.shape)]),
    ):
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        max_err = max(max_err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        _line("parity", kernel="limb_share_sum", entry=entry,
              case=f"ladder config 3 (basic Shamir K={k + t}, L={stacks.shape[0]}, n={stacks.shape[2]})",
              shape=shape, out=list(got.shape), identical=same)
        if not same:
            raise AssertionError(f"limb_share_sum differs from its plain version ({entry}, ladder config 3)")
    del values

    def k1_run():
        return share_limb_sums_cuda(secrets, rand, stacks, k)

    def k1_plain():
        return share_limb_sums_torch(secrets, rand, stacks, k)

    plain_a = _time_ms(k1_plain, iters=2)
    kernel_a = _kernel_ms(k1_run, 20, "limb_share_sum")
    kernel_b = _kernel_ms(k1_run, 20, "limb_share_sum")
    plain_b = _time_ms(k1_plain, iters=2)
    wrapper = _time_ms(k1_run, iters=20, warmup=3)
    moved, ops, bytes_ms, ops_ms = _k1_bound(secrets, rand, stacks)
    _line("numbers", kernel="limb_share_sum", path="ladder config 3",
          shape=[list(secrets.shape), list(rand.shape)], kernel_ms=[kernel_a, kernel_b],
          wrapper_ms=wrapper, plain_ms=[plain_a, plain_b], bytes=moved, int8_ops=ops,
          bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=None,
          launches=k1, card=card)
    del secrets, rand

    # the fabric demo: one NCCL rank per visible card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc, out, err = _module_cli("sda_tpu_torch.examples.secure_sum_fabric", [], timeout=600)
    demo_s = time.perf_counter() - t0
    ok_lines = [text for text in out.splitlines() if " OK: " in text]
    for text in out.splitlines():
        _line("demo", line=text)
    _line("demo run", rc=rc, wall_s=demo_s, card=card)
    if rc != 0 or len(ok_lines) != DEMO_OK_LINES:
        raise AssertionError(f"secure_sum_fabric demo: rc {rc}, {len(ok_lines)} OK lines; "
                             f"stderr tail:\n{err[-3000:]}")
    return k1, max_err


# phase 21: the native batch layer (``sda_tpu_torch/native``: host C built
# at first use, with no library behind it) against its plain versions, run
# before phase 14 because phases 14, 17 and 19 ride it. Sealing cases: P
# participants x 8 clerks, messages cycling through these lengths, the
# ladder path forced by one clerk key that does not lift to a curve point
NATIVE_PARTICIPANTS = (1, 3, 16)
NATIVE_LENGTHS = (0, 1, 1_000)
NATIVE_MODULI = ((1 << 31) - 1, (1 << 61) - 1, 1 << 63)
NATIVE_DIMS = (1, 8_193)  # and the CNN's width
NATIVE_FOLD_SEEDS = 10
# key generation and signing: seeded secrets, and messages of these lengths
NATIVE_KEYS, NATIVE_SIGN_LENGTHS = 8, (0, 1, 64, 1_000, 4_096)
# modexp: moduli of these sizes (a Paillier n^2 at a 2,048-bit key is 4,096
# bits), exponents half as long (n or lambda); the batch's base count
NATIVE_MODEXP_BITS, NATIVE_MODEXP_BATCH = (2_048, 4_096), 32


def _twist_key(native) -> bytes:
    """The smallest u-coordinate that does not lift to a curve point (a
    point on the twist): sealing to it takes the ladder path."""
    from sda_tpu_torch.crypto import sodium

    lifting = sodium.box_keypair()[0]
    for u in range(2, 100):
        key = u.to_bytes(32, "little")
        if native.participation_keys(8, [key, lifting]) == 16:
            return key
    raise AssertionError("no twist point below u = 100")


def native_phase(card: str, dev, seed: int) -> None:
    """Phase 21: the native layer byte for byte against its plain versions
    (``crypto/sodium.py``, ``crypto/varint.py``, ``ops/chacha.expand_seed``)
    at fixed ephemeral keys: ``seal_participations`` at P x 8 for each P of
    ``NATIVE_PARTICIPANTS``, and ``seal_batch`` of the same P x 8 messages,
    each on the comb and the ladder path, with messages of
    ``NATIVE_LENGTHS`` bytes and one CNN-width share row, under
    ``SDA_NATIVE_THREADS=1`` and the default; ``open_batch`` of plain-sealed
    boxes, and a flipped byte refused at its index; a varint round trip at
    the CNN's width with the int64 extremes; ``chacha_expand`` at
    ``NATIVE_DIMS`` and the CNN's width for each of ``NATIVE_MODULI``; and
    the box public key, Ed25519 seed keypairs and detached signatures of
    ``NATIVE_KEYS`` seeded keys over ``NATIVE_SIGN_LENGTHS`` against the
    plain Python; ``mod_exp`` and ``mod_exp_batch`` against ``pow`` at
    ``NATIVE_MODEXP_BITS``; the C fold of ``NATIVE_FOLD_SEEDS`` CNN-width
    seeds against K2's ``combine_masks_device`` on the card, which holds K2
    against a third implementation. One ``native`` line per case with
    ``identical``; any ``false`` raises. Then one ``native rates`` line: C
    against plain for one CNN-width row (seal and open MB/s, expand ms) and
    the fold's ms beside K2's; and one for a 4,096-bit modexp."""
    import math

    import numpy as np
    import torch

    from sda_tpu_torch import native
    from sda_tpu_torch.crypto import sodium, varint
    from sda_tpu_torch.ops.chacha import expand_seed
    from sda_tpu_torch.ops.chacha_cuda import combine_masks_device

    rng = np.random.default_rng(seed + 21)
    dim = sum(math.prod(s) for leaves in FEDAVG_MODEL.values() for s in leaves.values())
    row = rng.integers(-(1 << 30), 1 << 30, size=dim, dtype=np.int64)
    cnn_message = native.varint_encode(row)

    def identical(case: str, same: bool, **fields) -> None:
        _line("native", case=case, identical=bool(same), **fields, card=card)
        if not same:
            raise AssertionError(f"the native layer differs from its plain version: {case}")

    def message(i: int) -> bytes:
        n = NATIVE_LENGTHS[i % len(NATIVE_LENGTHS)]
        return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()

    def key_at(keys: bytes, i: int) -> bytes:
        return keys[32 * i:32 * i + 32]

    pairs = [sodium.box_keypair() for _ in range(SEALED_CLERKS)]
    pks = [pk for pk, _ in pairs]
    twist = _twist_key(native)
    prior = os.environ.get("SDA_NATIVE_THREADS")
    try:
        for threads in ("1", None):
            if threads is None:
                os.environ.pop("SDA_NATIVE_THREADS", None)
            else:
                os.environ["SDA_NATIVE_THREADS"] = threads
            label = f"SDA_NATIVE_THREADS={threads or 'default'} ({native._default_threads()})"
            for P in NATIVE_PARTICIPANTS:
                for path, keys in (("comb", pks), ("ladder", pks[:-1] + [twist])):
                    matrix = [[message(p * SEALED_CLERKS + c) for c in range(SEALED_CLERKS)]
                              for p in range(P)]
                    if P == 1:
                        matrix[0][3] = cnn_message
                    n_keys = native.participation_keys(P, keys)
                    shared = n_keys == P
                    eks = os.urandom(32 * n_keys)
                    got = native.seal_participations(matrix, keys, ephemeral_keys=eks)
                    want = [[sodium.seal_with_ephemeral(
                        matrix[p][c], keys[c], key_at(eks, p if shared else p * SEALED_CLERKS + c))
                        for c in range(SEALED_CLERKS)] for p in range(P)]
                    identical(f"seal_participations P={P} C={SEALED_CLERKS} {path} {label}",
                              got == want and shared == (path == "comb"), ephemeral_keys=n_keys,
                              bytes=sum(len(m) for r in matrix for m in r))
                    # the same P x C messages as one batch to the last key,
                    # which lifts on the comb path and not on the ladder's
                    flat = [m for r in matrix for m in r]
                    eks = os.urandom(32 * len(flat))
                    got = native.seal_batch(flat, keys[-1], ephemeral_keys=eks)
                    want = [sodium.seal_with_ephemeral(m, keys[-1], key_at(eks, i))
                            for i, m in enumerate(flat)]
                    identical(f"seal_batch n={len(flat)} {path} {label}", got == want,
                              bytes=sum(len(m) for m in flat))
    finally:
        if prior is None:
            os.environ.pop("SDA_NATIVE_THREADS", None)
        else:
            os.environ["SDA_NATIVE_THREADS"] = prior

    pk, sk = pairs[0]
    msgs = [message(i) for i in range(9)] + [cnn_message]
    boxes = [sodium.seal(m, pk) for m in msgs]
    identical("open_batch of plain-sealed boxes", native.open_batch(boxes, pk, sk) == msgs,
              boxes=len(boxes))
    flipped = bytearray(boxes[5])
    flipped[len(flipped) // 2] ^= 0x01
    try:
        native.open_batch(boxes[:5] + [bytes(flipped)] + boxes[6:], pk, sk)
        refused_at = None
    except sodium.SodiumError as e:
        refused_at = e.index
    identical("open_batch refuses a flipped byte at its index", refused_at == 5, index=refused_at)

    values = row.copy()
    values[:4] = [-(1 << 63), (1 << 63) - 1, -1, 0]
    encoded = native.varint_encode(values)
    identical(f"varint round trip at {dim} with the int64 extremes",
              encoded == varint.encode_i64(values)
              and np.array_equal(native.varint_decode(encoded), values)
              and np.array_equal(varint.decode_i64(encoded), values), bytes=len(encoded))

    seed_words = rng.integers(0, 1 << 32, size=SEED_WORDS, dtype=np.uint64).astype(np.uint32)
    for m in NATIVE_MODULI:
        for d in NATIVE_DIMS + (dim,):
            identical(f"chacha_expand dim={d} m={m}",
                      np.array_equal(native.chacha_expand(seed_words, d, m),
                                     expand_seed(seed_words, d, m)))

    # key generation and Ed25519 signing: the C against the plain Python
    key_bytes = rng.integers(0, 256, size=(NATIVE_KEYS, 32), dtype=np.uint8)
    identical(f"box_public_key of {NATIVE_KEYS} seeded secret keys",
              all(native.box_public_key(sk.tobytes()) == sodium.x25519(sk.tobytes(),
                                                                        sodium._BASE_U)
                  for sk in key_bytes))
    signers = []
    for seed_bytes in key_bytes:
        seed_bytes = seed_bytes.tobytes()
        a, _ = sodium._expand_seed(seed_bytes)
        vk = sodium._encode(sodium._scalar_mult(a, sodium._B))
        signers.append((native.sign_seed_keypair(seed_bytes), (vk, seed_bytes + vk)))
    identical(f"sign_seed_keypair of {NATIVE_KEYS} seeded seeds",
              all(c == plain for c, plain in signers))
    for n in NATIVE_SIGN_LENGTHS:
        m = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        sigs = [(native.sign_detached(m, sk), sodium.sign_detached(m, sk), vk)
                for (vk, sk), _ in signers]
        identical(f"sign_detached of a {n}-byte message under {NATIVE_KEYS} keys",
                  all(c == plain and sodium.verify_detached(c, m, vk) for c, plain, vk in sigs))

    # Montgomery modexp against Python's pow, one base and a batch
    draw = random.Random(int(rng.integers(1 << 62)))
    modexp_case = {}
    for bits in NATIVE_MODEXP_BITS:
        mod = draw.getrandbits(bits) | 1 | (1 << (bits - 1))
        exp = draw.getrandbits(bits // 2) | (1 << (bits // 2 - 1))
        bases = [draw.getrandbits(bits) for _ in range(NATIVE_MODEXP_BATCH)]
        want = [pow(b, exp, mod) for b in bases]
        identical(f"mod_exp at {bits} bits, a {bits // 2}-bit exponent",
                  all(native.mod_exp(b, exp, mod) == w for b, w in zip(bases[:4], want)))
        identical(f"mod_exp_batch of {NATIVE_MODEXP_BATCH} at {bits} bits",
                  native.mod_exp_batch(bases, exp, mod) == want)
        modexp_case[bits] = (bases, exp, mod)

    seeds = rng.integers(0, 1 << 32, size=(NATIVE_FOLD_SEEDS, SEED_WORDS),
                         dtype=np.uint64).astype(np.uint32)
    fold_ms = {}
    for m in NATIVE_MODULI[:2]:  # K2's fold takes moduli below 2^62
        t0 = time.perf_counter()
        host = native.chacha_combine(seeds, dim, m)
        fold_ms[f"c_{m}"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_fold = combine_masks_device(seeds, dim, m, device=dev).cpu().numpy()
        fold_ms[f"k2_{m}"] = (time.perf_counter() - t0) * 1e3
        identical(f"chacha_combine of {NATIVE_FOLD_SEEDS} seeds x {dim} against K2's "
                  f"combine_masks_device, m={m}", np.array_equal(host, card_fold))

    # rates for one CNN-width row, C against plain
    def timed(fn, reps: int = 3) -> float:
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    mb = len(cnn_message) / 1e6
    box = native.seal_batch([cnn_message], pk)[0]
    p31 = NATIVE_MODULI[0]
    rates = {
        "row_bytes": len(cnn_message),
        "seal_mb_s": mb / timed(lambda: native.seal_batch([cnn_message], pk)),
        "seal_comb_8_mb_s": 8 * mb / timed(lambda: native.seal_participations([[cnn_message] * 8],
                                                                              pks)),
        "seal_plain_mb_s": mb / timed(lambda: sodium.seal(cnn_message, pk), reps=1),
        "open_mb_s": mb / timed(lambda: native.open_batch([box], pk, sk)),
        "open_plain_mb_s": mb / timed(lambda: sodium.seal_open(box, pk, sk), reps=1),
        "varint_encode_ms": 1e3 * timed(lambda: native.varint_encode(row)),
        "varint_encode_plain_ms": 1e3 * timed(lambda: varint.encode_i64(row), reps=1),
        "varint_decode_ms": 1e3 * timed(lambda: native.varint_decode(cnn_message)),
        "varint_decode_plain_ms": 1e3 * timed(lambda: varint.decode_i64(cnn_message), reps=1),
        "expand_ms": 1e3 * timed(lambda: native.chacha_expand(seed_words, dim, p31)),
        "expand_plain_ms": 1e3 * timed(lambda: expand_seed(seed_words, dim, p31), reps=1),
        "fold_ms": fold_ms,
        "threads": native._default_threads(),
    }
    _line("native rates", dim=dim, **rates, card=card)

    # 4,096-bit modexps with 2,048-bit exponents, Paillier's r^n mod n^2
    bases, exp, mod = modexp_case[NATIVE_MODEXP_BITS[-1]]
    _line("native rates", case="modexp", modulus_bits=mod.bit_length(),
          exponent_bits=exp.bit_length(),
          pow_ms=1e3 * timed(lambda: pow(bases[0], exp, mod), reps=2),
          c_one_thread_ms=1e3 * timed(lambda: native.mod_exp(bases[0], exp, mod)),
          batch_ms_per_modexp=1e3 * timed(lambda: native.mod_exp_batch(bases, exp, mod))
          / len(bases), batch=len(bases), threads=native._default_threads(), card=card)


# phase 14: the sealed aggregation round through the protocol plane: an
# untrusted in-memory server, a recipient and a committee of clerks with
# their own keystores, participants that mask, share and seal. Ten
# participants are the FedAvg paper's per-round cohort, C = 0.1 of its K =
# 100 clients (McMahan et al., AISTATS 2017, section 3), at the CNN's width
SEALED_COHORT, SEALED_CLERKS, SEALED_SMALL_DIM = 10, 8, 1_000


#: the labels under which the native layer counts its seals, opens and
#: mask expansions: its C paths, and no other
C_PATHS = {"comb", "batch", "native"}


def _crypto_counts(telemetry) -> dict:
    """``sda_crypto_*`` counters by ``(name, path)``."""
    return {(c["name"], c["labels"].get("path")): c["value"]
            for c in telemetry.snapshot(include_spans=0)["counters"]
            if c["name"].startswith("sda_crypto_")}


class _NativeTally:
    """Wraps the native layer's ``seal_participations``, ``seal_batch`` and
    ``open_batch`` for the length of a round: boxes, bytes (the plaintext of
    a seal, the box of an open) and summed seconds, for the rates of the
    round's crypto, counted as they were over the plain ``sodium.seal``
    and ``sodium.seal_open``, which the round no longer calls. ``checks()``
    holds the telemetry counters' growth over the same span to the boxes
    seen: every seal and open counted on a C path, none elsewhere."""

    SEALS = ("seal_participations", "seal_batch")

    def __init__(self):
        from sda_tpu_torch import native, telemetry

        self.native, self.telemetry = native, telemetry
        self.lock = threading.Lock()
        self.boxes = {"seal": 0, "open": 0}
        self.bytes = {"seal": 0, "open": 0}
        self.seconds = {"seal": 0.0, "open": 0.0}
        self.real = {}

    def _wrap(self, name: str, kind: str):
        fn = self.real[name] = getattr(self.native, name)

        def timed(items, *args, **kwargs):
            flat = [m for row in items for m in row] if name == "seal_participations" else items
            t0 = time.perf_counter()
            out = fn(items, *args, **kwargs)
            dt = time.perf_counter() - t0
            with self.lock:
                self.seconds[kind] += dt
                self.boxes[kind] += len(flat)
                self.bytes[kind] += sum(len(m) for m in flat)
            return out

        setattr(self.native, name, timed)

    def __enter__(self):
        self.before = _crypto_counts(self.telemetry)
        for name in self.SEALS:
            self._wrap(name, "seal")
        self._wrap("open_batch", "open")
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.native, name, fn)
        self.after = _crypto_counts(self.telemetry)

    def rate_mb_s(self, kind: str):
        return self.bytes[kind] / self.seconds[kind] / 1e6 if self.seconds[kind] else None

    def checks(self) -> dict:
        grew = {key: self.after[key] - self.before.get(key, 0) for key in self.after
                if self.after[key] != self.before.get(key, 0)}
        seals = sum(n for (name, _), n in grew.items() if name == "sda_crypto_seals_total")
        opens = sum(n for (name, _), n in grew.items() if name == "sda_crypto_opens_total")
        return {"seals_counted_on_c": self.boxes["seal"] > 0 and seals == self.boxes["seal"],
                "opens_counted_on_c": self.boxes["open"] > 0 and opens == self.boxes["open"],
                "only_c_paths": bool(grew) and {path for _, path in grew} <= C_PATHS}


def sealed_round(dev, root: Path, values: list, scheme, with_checks: bool = False,
                 service_for=None, batched: bool = False) -> dict:
    """One ChaCha-masked aggregation of ``values`` (field vectors) through
    ``SdaClient``s on ``dev``, in the reference's sequence
    (tests/test_full_loop.py:40-93): agents and keys uploaded, the
    aggregation uploaded and begun, one ``participate`` each, the snapshot,
    every member's ``run_chores(-1)``, the reveal. ``service_for(name)``
    gives the ``SdaService`` the member ``name`` talks to (default: one
    in-process ``new_mem_server`` for every member), so one round serves
    each transport. With ``batched``, each participant goes through
    ``participate_many`` (its build and its upload each a span) instead of
    ``participate``. Times each stage; the recipient's K2 fold by CUDA
    events around ``combine_masks_device``. With ``with_checks``, also
    tries a clerking job with one ciphertext byte flipped, a participation
    posted under another agent and a committee key whose signature was
    altered. Returns the stage seconds, the revealed vector, the sealed
    bytes (None when the server is not in this process), the seal and open
    rates of the native layer (``_NativeTally``) and the checks: always
    the tally's three (every seal and open counted on a C path), with
    ``with_checks`` the three refusals too."""
    import numpy as np
    import torch

    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import Keystore, masking, sodium
    from sda_tpu_torch.protocol import (
        B64,
        Aggregation,
        AggregationId,
        Binary,
        ChaChaMasking,
        ClerkingJob,
        Encryption,
        EncryptionKeyId,
        Labelled,
        PermissionDeniedError,
        Signature,
        Signed,
        SodiumEncryptionScheme,
    )
    from sda_tpu_torch.server import new_mem_server

    dim, p = len(values[0]), scheme.prime_modulus
    seconds, folds = {}, []
    real_combine = masking.combine_masks_device

    def timed_combine(seeds, *args, **kwargs):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = real_combine(seeds, *args, **kwargs)
        events[1].record()
        folds.append((events, np.asarray(seeds)))
        return out

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    server = None
    if service_for is None:
        server = new_mem_server()

        def service_for(name):
            return server

    def client(name):
        keystore = Keystore(root / name)
        return SdaClient(SdaClient.new_agent(keystore), keystore, service_for(name), device=dev)

    def upload():
        recipient = client("recipient")
        recipient_key = recipient.new_encryption_key()
        recipient.upload_agent()
        recipient.upload_encryption_key(recipient_key)
        clerks = [client(f"clerk{i}") for i in range(SEALED_CLERKS)]
        for clerk in clerks:
            key = clerk.new_encryption_key()
            clerk.upload_agent()
            clerk.upload_encryption_key(key)
        aggregation = Aggregation(
            id=AggregationId.random(), title="sealed round", vector_dimension=dim, modulus=p,
            recipient=recipient.agent.id, recipient_key=recipient_key,
            masking_scheme=ChaChaMasking(modulus=p, dimension=dim, seed_bitsize=32 * SEED_WORDS),
            committee_sharing_scheme=scheme,
            recipient_encryption_scheme=SodiumEncryptionScheme(),
            committee_encryption_scheme=SodiumEncryptionScheme())
        recipient.upload_aggregation(aggregation)
        recipient.begin_aggregation(aggregation.id)
        participants = [client(f"participant{i}") for i in range(len(values))]
        for participant in participants:
            participant.upload_agent()
        return recipient, clerks, participants, aggregation

    t_wall = time.perf_counter()
    with _NativeTally() as tally:
        recipient, clerks, participants, aggregation = stage("upload_s", upload)
        if batched:
            stage("participate_s", lambda: [part.participate_many([v], aggregation.id)
                                            for part, v in zip(participants, values)])
        else:
            stage("participate_s", lambda: [part.participate(v, aggregation.id)
                                            for part, v in zip(participants, values)])
        stage("snapshot_s", lambda: recipient.end_aggregation(aggregation.id))
        job = clerks[0].service.get_clerking_job(clerks[0].agent, clerks[0].agent.id)
        stage("clerking_s", lambda: [member.run_chores(-1) for member in [recipient] + clerks])
        masking.combine_masks_device = timed_combine
        try:
            out = stage("reveal_s", lambda: recipient.reveal_aggregation(aggregation.id))
        finally:
            masking.combine_masks_device = real_combine
    seconds["wall_s"] = time.perf_counter() - t_wall
    torch.cuda.synchronize()
    seconds["mask_combine_s"] = sum(a.elapsed_time(b) for (a, b), _ in folds) / 1e3 if folds else None
    checks = tally.checks()
    if with_checks:
        # a clerking job with one ciphertext byte flipped: the clerk's open
        # must refuse it
        raw = bytearray(bytes(job.encryptions[0].inner))
        raw[len(raw) // 2] ^= 0x01
        forged = ClerkingJob(id=job.id, clerk=job.clerk, aggregation=job.aggregation,
                             snapshot=job.snapshot,
                             encryptions=[Encryption(Binary(bytes(raw)))] + job.encryptions[1:])
        try:
            clerks[0].process_clerking_job(forged)
            checks["flipped_byte_refused"] = False
        except sodium.SodiumError:
            checks["flipped_byte_refused"] = True
        # a participation posted under another agent's identity: the
        # server's ACL refuses it
        part = participants[1].new_participation(values[1], aggregation.id)
        try:
            participants[0].service.create_participation(participants[0].agent, part)
            checks["foreign_participation_refused"] = False
        except PermissionDeniedError:
            checks["foreign_participation_refused"] = True
        # a clerk key uploaded with an altered signature: the server stores
        # it (it verifies no signature), the participant refuses to seal to it
        clerk_id, key_id = recipient.service.get_committee(
            recipient.agent, aggregation.id).clerks_and_keys[0]
        signed = recipient.service.get_encryption_key(recipient.agent, key_id)
        sig = bytearray(signed.signature.data)
        sig[0] ^= 0x01
        tampered = Signed(signature=Signature(B64(bytes(sig))), signer=clerk_id,
                          body=Labelled(EncryptionKeyId.random(), signed.body.body))
        owner = next(clerk for clerk in clerks if clerk.agent.id == clerk_id)
        owner.service.create_encryption_key(owner.agent, tampered)
        try:
            participants[2]._fetch_verified_key(clerk_id, tampered.body.id)
            checks["altered_signature_refused"] = False
        except ValueError:
            checks["altered_signature_refused"] = True
    sealed = None
    if server is not None:
        stored = list(server.server.aggregation_store.iter_participations(aggregation.id))
        sealed = sum(len(e.inner) for part in stored for _, e in part.clerk_encryptions)
        sealed += sum(len(part.recipient_encryption.inner) for part in stored)
    return {"seconds": seconds, "values": out.positive().values, "sealed_bytes": sealed,
            "seal_mb_s": tally.rate_mb_s("seal"), "seals": tally.boxes["seal"],
            "open_mb_s": tally.rate_mb_s("open"), "opens": tally.boxes["open"],
            "folds": folds, "checks": checks}


def _sealed_updates(dev, rng, count: int = SEALED_COHORT):
    """``count`` float updates of the ``FEDAVG_MODEL`` CNN drawn from
    ``rng``, each quantized by ``quantize_update`` under
    ``QuantizationSpec.fitted`` for ``count`` participants; returns
    ``(scheme, field vectors)``."""
    import math

    import numpy as np

    from sda_tpu_torch.models import QuantizationSpec, quantize_update

    spec, scheme = QuantizationSpec.fitted(FEDAVG_FRAC_BITS, FEDAVG_CLIP, count)
    dim = sum(math.prod(s) for leaves in FEDAVG_MODEL.values() for s in leaves.values())
    values = []
    for _ in range(count):
        update = {layer: {name: rng.normal(0.0, UPDATE_SCALE, size=shape).astype(np.float32)
                          for name, shape in leaves.items()} for layer, leaves in FEDAVG_MODEL.items()}
        values.append(quantize_update(update, spec, device=dev)[0].cpu().numpy())
    assert len(values[0]) == dim
    return scheme, values


def _k2_at_fold(card: str, dev, folds, dim: int, p: int, sm_clocks_per_ms: float, launches: int,
                path: str) -> int:
    """K2 at a reveal fold's shape, on the round's own seeds (``folds`` as
    ``sealed_round`` returns them): one ``parity`` line against the plain
    version, which must be identical, and one ``numbers`` line (wrapper by
    CUDA events, own time by the profiler, plain, bound). Returns K2's
    max_abs_err there."""
    import numpy as np
    import torch

    from sda_tpu_torch.ops.chacha import chacha_blocks_torch
    from sda_tpu_torch.ops.chacha_cuda import chacha_blocks_cuda, seed_tensor, window_blocks

    n_blocks = window_blocks(dim, p)
    keys = seed_tensor(np.concatenate([seeds for _, seeds in folds]), dev)
    got = chacha_blocks_cuda(keys, 0, n_blocks)
    want_k2 = chacha_blocks_torch(keys, 0, n_blocks)
    k2_err = int((got.to(torch.int64) - want_k2.to(torch.int64)).abs().max())
    same = bool(torch.equal(got, want_k2))
    _line("parity", kernel="chacha20", case=f"{path} reveal fold {keys.shape[0]} seeds x "
          f"{n_blocks} blocks", shape=list(got.shape), identical=same)
    del got, want_k2
    if not same:
        raise AssertionError(f"chacha20 differs from its plain version ({path} reveal fold)")

    def k2():
        return chacha_blocks_cuda(keys, 0, n_blocks)

    k2_plain = _time_ms(lambda: chacha_blocks_torch(keys, 0, n_blocks), iters=2)
    k2_wrapper = [_time_ms(k2, iters=10, warmup=2) for _ in range(2)]
    seen, seen_ms = _profiled(k2, 10, "chacha20")
    moved, ops, int_ops, bytes_ms, ops_ms = _k2_bound(keys.shape[0], n_blocks, sm_clocks_per_ms)
    _line("numbers", kernel="chacha20", path=path, shape=[keys.shape[0], n_blocks, 16],
          event_ms=_k2_event_ms(keys, n_blocks), wrapper_ms=k2_wrapper,
          profiler={"launches_seen": seen, "of": 10,
                    "ms_per_seen": seen_ms / seen if seen else None},
          plain_ms=k2_plain, bytes=moved, int32_ops=ops, int_pipe_ops=int_ops,
          bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=None,
          launches=launches, card=card)
    return k2_err


def sealed_round_phase(card: str, dev, seed: int, sm_clocks_per_ms: float):
    """Phase 14: ``sealed_round`` of ``SEALED_COHORT`` float updates of the
    ``FEDAVG_MODEL`` CNN, each quantized by ``quantize_update`` under
    ``QuantizationSpec.fitted`` (packed Shamir k=5, t=2, n=8), over 8 clerks;
    the recipient's ChaCha combine of 10 x 1,663,370 elements (4x the
    device threshold) goes to K2. Held to: the revealed sum against an
    independent numpy sum of the inputs mod p, K2 launched, a flipped
    ciphertext byte refused by the clerk's open, a participation under
    another agent refused by the server, a key with an altered signature
    refused by the participant. Then K2 against its plain version at the
    fold's shape on the round's own seeds, its times there, and a round at
    ``SEALED_SMALL_DIM`` below the threshold that must launch no K2.
    Returns ``(k2 launches, k2 max_abs_err)``."""
    import tempfile

    import numpy as np
    import torch

    from sda_tpu_torch.crypto.masking import ChaChaMasker
    from sda_tpu_torch.ops import chacha_cuda

    rng = np.random.default_rng(seed)
    scheme, values = _sealed_updates(dev, rng)
    p, dim = scheme.prime_modulus, len(values[0])
    want = np.stack(values).sum(axis=0) % p
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
        out = sealed_round(dev, Path(tmp) / "full", values, scheme, with_checks=True)
        launches, recoveries = chacha_cuda.launches, chacha_cuda.slack_recoveries
        exact = bool(np.array_equal(out["values"], want))
        elements = SEALED_COHORT * dim
        checks = {"sum": exact, "k2_launched": launches >= 1, **out["checks"]}
        _line("sealed round", participants=SEALED_COHORT, clerks=SEALED_CLERKS, dim=dim, modulus=p,
              scheme={"k": scheme.secret_count, "t": scheme.privacy_threshold, "n": scheme.share_count},
              mask_elements=elements, device_threshold=ChaChaMasker.DEVICE_COMBINE_THRESHOLD,
              **out["seconds"], sealed_bytes=out["sealed_bytes"], seals=out["seals"],
              seal_mb_s=out["seal_mb_s"], opens=out["opens"], open_mb_s=out["open_mb_s"],
              launches={"chacha20": launches}, slack_recoveries=recoveries, exact=exact,
              checks=checks, card=card)
        if not all(checks.values()):
            raise AssertionError(f"sealed round: a check failed: {checks}")

        # the round below the device threshold: the host fold, no K2
        small = [rng.integers(0, p, size=SEALED_SMALL_DIM, dtype=np.int64) for _ in range(SEALED_COHORT)]
        chacha_cuda.launches = 0
        small_out = sealed_round(dev, Path(tmp) / "small", small, scheme)
        small_exact = bool(np.array_equal(small_out["values"], np.stack(small).sum(axis=0) % p))
        _line("sealed round", participants=SEALED_COHORT, clerks=SEALED_CLERKS, dim=SEALED_SMALL_DIM,
              modulus=p, mask_elements=SEALED_COHORT * SEALED_SMALL_DIM, **small_out["seconds"],
              seals=small_out["seals"], opens=small_out["opens"],
              launches={"chacha20": chacha_cuda.launches}, exact=small_exact,
              checks=small_out["checks"], card=card)
        if not small_exact or chacha_cuda.launches or not all(small_out["checks"].values()):
            raise AssertionError(f"small sealed round: exact {small_exact}, "
                                 f"{chacha_cuda.launches} chacha20 launches (expected 0), "
                                 f"checks {small_out['checks']}")

    k2_err = _k2_at_fold(card, dev, out["folds"], dim, p, sm_clocks_per_ms, launches,
                         "sealed round")
    return launches, k2_err


# phase 15: federated training on the sealed round: ``FederatedTrainer`` over
# ``DPFederatedAveraging`` at the CNN's width, the DP setting of phase 13,
# server Adam, checkpoints in a temporary directory, the paper's per-round
# cohort of 10 (SEALED_COHORT) submitted on TRAINER_PARALLEL threads, over
# SEALED_CLERKS clerks on ``new_mem_server``; TRAINER_ROUNDS rounds, then a
# fresh trainer restores the last checkpoint. One round since phases 19-20
# came in: the script stays near half its time limit, and the restore check
# needs only one checkpoint
TRAINER_ROUNDS, TRAINER_PARALLEL = 1, 4


def _wrap(obj, name: str, before=None, after=None):
    """Replace ``obj.name`` (an instance attribute shadowing the method) by
    a call that runs ``before(*args)`` first and ``after(out)`` last."""
    real = getattr(obj, name)

    def call(*args, **kwargs):
        if before is not None:
            before(*args)
        out = real(*args, **kwargs)
        if after is not None:
            after(out)
        return out

    setattr(obj, name, call)


def _timed(obj, name: str, seconds: dict, key: str) -> None:
    """Add the seconds of every call of ``obj.name`` to ``seconds[key]``."""
    real = getattr(obj, name)

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0

    setattr(obj, name, call)


def trainer_phase(card: str, dev, seed: int, sm_clocks_per_ms: float):
    """Phase 15: ``FederatedTrainer.run_round`` ``TRAINER_ROUNDS`` times over a
    ``DPFederatedAveraging`` driver of the ``FEDAVG_MODEL`` CNN (L2 clip
    1.0, noise multiplier 1.0, δ = 1e-6, the field and packed-Shamir scheme
    from ``fitted_spec``), ``FedAdam`` applying the revealed mean, 10
    participants on ``TRAINER_PARALLEL`` threads, each update a seeded
    numpy draw; then a fresh trainer's ``restore_latest``. Held to: each
    round's revealed field sum against numpy's sum mod p of the wires the
    participants submitted (recorded as they were submitted), the global
    model after each round against a host numpy float64 replay of FedAdam
    over the revealed mean, bit for bit, one K2 launch per round (the
    recipient's fold of 10 seeds), the restored trainer bit-equal to the
    live one (model, round index, privacy ledger, FedAdam's state), the
    last checkpoint on disk; then K2 against its plain version at the
    fold's shape on the rounds' seeds, and its times there. Returns ``(k2
    launches, k2 max_abs_err)``."""
    import math
    import tempfile

    import numpy as np
    import torch

    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import Keystore, masking
    from sda_tpu_torch.models import DPConfig, DPFederatedAveraging, FedAdam, FederatedTrainer
    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.ops.chacha import chacha_blocks_torch
    from sda_tpu_torch.ops.chacha_cuda import chacha_blocks_cuda, seed_tensor, window_blocks
    from sda_tpu_torch.server import new_mem_server

    P = SEALED_COHORT
    dim = sum(math.prod(s) for leaves in FEDAVG_MODEL.values() for s in leaves.values())
    gen = torch.Generator(device=dev).manual_seed(seed)
    global0 = {layer: {name: 0.05 * torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                       for name, shape in leaves.items()} for layer, leaves in FEDAVG_MODEL.items()}
    dp = DPConfig(l2_clip=DP_L2_CLIP, noise_multiplier=DP_NOISE_MULTIPLIER, expected_participants=P,
                  delta=DP_DELTA)
    spec, scheme = DPFederatedAveraging.fitted_spec(DP_FRAC_BITS, dp, dim)
    p, scale = spec.modulus, spec.scale

    def trainer_on(ckpt):
        fed = DPFederatedAveraging(spec, global0, dp, torch.Generator(device=dev).manual_seed(seed + 2),
                                   device=dev)
        return FederatedTrainer(fed, global0, checkpoint_dir=ckpt, apply_update=FedAdam(device=dev))

    def update_fn(i):
        rng = np.random.default_rng([seed, i])  # one stream per participant: thread-safe
        return lambda model: {layer: {name: rng.normal(0.0, UPDATE_SCALE, size=shape).astype(np.float32)
                                      for name, shape in leaves.items()}
                              for layer, leaves in FEDAVG_MODEL.items()}

    k2_total, folds = 0, []
    real_combine = masking.combine_masks_device

    def timed_combine(seeds, *args, **kwargs):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = real_combine(seeds, *args, **kwargs)
        events[1].record()
        folds.append((events, np.asarray(seeds)))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt = str(root / "checkpoints")
        server = new_mem_server()

        def client(name):
            keystore = Keystore(root / name)
            member = SdaClient(SdaClient.new_agent(keystore), keystore, server, device=dev)
            member.upload_agent()
            return member

        recipient = client("recipient")
        recipient_key = recipient.new_encryption_key()
        recipient.upload_encryption_key(recipient_key)
        clerks = [client(f"clerk{i}") for i in range(SEALED_CLERKS)]
        for clerk in clerks:
            clerk.upload_encryption_key(clerk.new_encryption_key())
        workers = [recipient] + clerks
        wires, marks, seconds, revealed = [], {}, {}, []
        submitters = []
        for i in range(P):
            participant = client(f"participant{i}")
            # list.append is atomic: the submitting threads record safely
            _wrap(participant, "participate", before=lambda values, agg: wires.append(
                np.array(values, dtype=np.int64)))
            submitters.append((participant, update_fn(i)))
        trainer = trainer_on(ckpt)
        fed = trainer.fed
        _wrap(fed, "open_round", after=lambda out: marks.update(opened=time.perf_counter()))
        _wrap(fed, "close_round", before=lambda *a: seconds.update(
            submit_s=time.perf_counter() - marks["opened"]))
        for worker in workers:
            _timed(worker, "run_chores", seconds, "clerking_s")
        _timed(fed, "reveal_field_sum", seconds, "reveal_s")
        _wrap(fed, "reveal_field_sum", after=lambda out: revealed.append(out.cpu().numpy()))
        _wrap(fed, "finish_round", after=lambda out: marks.update(finished=time.perf_counter()))
        _wrap(trainer, "save", before=lambda: marks.get("finished") and seconds.update(
            apply_s=time.perf_counter() - marks.pop("finished")))
        _timed(trainer, "save", seconds, "save_s")
        host_adam = _HostFedAdam()
        host_global = _sorted_flat(global0)
        masking.combine_masks_device = timed_combine
        try:
            for round_index in range(TRAINER_ROUNDS):
                wires.clear()
                revealed.clear()
                seconds.clear()
                del folds[:]
                torch.cuda.synchronize()
                chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
                t0 = time.perf_counter()
                trainer.run_round(recipient, recipient_key, scheme, submitters, workers,
                                  parallel_submit=TRAINER_PARALLEL)
                torch.cuda.synchronize()
                seconds["wall_s"] = time.perf_counter() - t0
                launches, recoveries = chacha_cuda.launches, chacha_cuda.slack_recoveries
                seconds["mask_combine_s"] = sum(a.elapsed_time(b) for (a, b), _ in folds) / 1e3
                round_seeds = np.concatenate([s for _, s in folds]) if folds else None
                field_sum = revealed[0]
                sum_ok = len(wires) == P and bool(np.array_equal(field_sum, np.stack(wires).sum(axis=0) % p))
                mean = _centered(field_sum, p).astype(np.float64) / scale / P
                host_global = host_adam(host_global, mean)
                apply_ok = bool(np.array_equal(_sorted_flat(trainer.global_model), host_global))
                path = Path(ckpt) / f"round_{trainer.round_index:06d}.npz"
                account = fed.privacy()
                checks = {"field_sum": sum_ok, "server_step": apply_ok,
                          "k2_once": launches == 1 + recoveries and len(folds) == 1,
                          "checkpoint": path.exists(), "ledger": len(trainer.round_rhos) == round_index + 1}
                _line("trainer round", round=round_index, participants=P, clerks=SEALED_CLERKS, dim=dim,
                      modulus=p, frac_bits=spec.frac_bits,
                      scheme={"k": scheme.secret_count, "t": scheme.privacy_threshold, "n": scheme.share_count},
                      parallel_submit=TRAINER_PARALLEL, optimizer="FedAdam", **seconds,
                      checkpoint_bytes=path.stat().st_size if path.exists() else None,
                      launches={"chacha20": launches}, slack_recoveries=recoveries,
                      epsilon=account.epsilon, rho=account.rho, exact=all(checks.values()),
                      checks=checks, card=card)
                if not all(checks.values()):
                    raise AssertionError(f"trainer round {round_index}: a check failed: {checks}")
                k2_total += launches
        finally:
            masking.combine_masks_device = real_combine
        composed = trainer.cumulative_privacy()
        _line("privacy", driver="trainer", rounds=composed.rounds, epsilon=composed.epsilon,
              rho=composed.rho, delta=composed.delta)

        # a fresh trainer on the card resumes from the last checkpoint
        t0 = time.perf_counter()
        resumed = trainer_on(ckpt)
        loaded = resumed.restore_latest()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        live, back = trainer.apply_update.state(), resumed.apply_update.state()
        last = Path(ckpt) / f"round_{TRAINER_ROUNDS:06d}.npz"
        checks = {
            "loaded": loaded,
            "model": all(torch.equal(resumed.global_model[layer][name], trainer.global_model[layer][name])
                         for layer in FEDAVG_MODEL for name in FEDAVG_MODEL[layer]),
            "round_index": resumed.round_index == TRAINER_ROUNDS,
            "rhos": resumed.round_rhos == trainer.round_rhos and len(resumed.round_rhos) == TRAINER_ROUNDS,
            "delta": resumed.privacy_delta == trainer.privacy_delta == DP_DELTA,
            "fedadam": set(back) == set(live) == {"m", "v", "t"}
                       and all(np.array_equal(back[k], live[k]) for k in live),
            "last_checkpoint": last.exists(),
        }
        _line("trainer restore", restore_s=restore_s, checkpoint=last.name,
              checkpoint_bytes=last.stat().st_size if last.exists() else None,
              checkpoints=sorted(os.listdir(ckpt)), exact=all(checks.values()), checks=checks, card=card)
        if not all(checks.values()):
            raise AssertionError(f"trainer restore: a check failed: {checks}")

    # K2 at the rounds' fold shape, on the last round's seeds
    n_blocks = window_blocks(dim, p)
    keys = seed_tensor(round_seeds, dev)
    got = chacha_blocks_cuda(keys, 0, n_blocks)
    want_k2 = chacha_blocks_torch(keys, 0, n_blocks)
    k2_err = int((got.to(torch.int64) - want_k2.to(torch.int64)).abs().max())
    same = bool(torch.equal(got, want_k2))
    _line("parity", kernel="chacha20", case=f"trainer round reveal fold {keys.shape[0]} seeds x "
          f"{n_blocks} blocks", shape=list(got.shape), identical=same)
    del got, want_k2
    if not same:
        raise AssertionError("chacha20 differs from its plain version (trainer round reveal fold)")

    def k2():
        return chacha_blocks_cuda(keys, 0, n_blocks)

    k2_plain = _time_ms(lambda: chacha_blocks_torch(keys, 0, n_blocks), iters=2)
    k2_wrapper = [_time_ms(k2, iters=10, warmup=2) for _ in range(2)]
    seen, seen_ms = _profiled(k2, 10, "chacha20")
    moved, ops, int_ops, bytes_ms, ops_ms = _k2_bound(keys.shape[0], n_blocks, sm_clocks_per_ms)
    _line("numbers", kernel="chacha20", path="trainer rounds", shape=[keys.shape[0], n_blocks, 16],
          event_ms=_k2_event_ms(keys, n_blocks), wrapper_ms=k2_wrapper,
          profiler={"launches_seen": seen, "of": 10,
                    "ms_per_seen": seen_ms / seen if seen else None},
          plain_ms=k2_plain, bytes=moved, int32_ops=ops, int_pipe_ops=int_ops,
          bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=None,
          launches=k2_total, card=card)
    return k2_total, k2_err


# phase 16: the analytics entry points, each as a user runs it, in this
# process on CUDA clients at the examples' own sizes; every cohort there is
# below the reveal's device threshold, so the mask folds stay on the host
EXAMPLES = ("federated_training", "federated_analytics", "sketch_suite")
ANALYTICS_PARTICIPANTS, HISTOGRAM_BINS, HISTOGRAM_VALUES = 4, 64, 500
COUNTMIN_WIDTH, COUNTMIN_DEPTH, COUNTMIN_SEED = 256, 4, 23


def _countmin_table(items_per_party, width: int, depth: int, seed: int):
    """The check's own count-min table of every party's items, summed:
    BLAKE2b-64 of ``b"cm\\0" + seed (8 bytes) + row (4 bytes) + b"s" +
    item``, big-endian, mod ``width`` (the sketches' documented hash)."""
    import hashlib

    import numpy as np

    grid = np.zeros((depth, width), dtype=np.int64)
    for items in items_per_party:
        for item in items:
            for row in range(depth):
                digest = hashlib.blake2b(b"cm\x00" + seed.to_bytes(8, "big") + row.to_bytes(4, "big")
                                         + b"s" + item.encode(), digest_size=8).digest()
                grid[row, int.from_bytes(digest, "big") % width] += 1
    return grid.reshape(-1)


def analytics_phase(card: str, dev, seed: int) -> None:
    """Phase 16: ``main(["--device", "cuda"])`` of the port's three
    analytics examples, each of which must return 0 (they check their own
    results and raise otherwise); then one ``SecureHistogram`` round and
    one ``CountMinSketch`` round on CUDA clients, their revealed count
    vector and table held exactly against numpy on the same inputs. Every
    cohort is below the reveal's device threshold: the phase must launch
    K2 no time (the host route)."""
    import contextlib
    import importlib
    import io
    import tempfile

    import numpy as np

    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import Keystore
    from sda_tpu_torch.models import SecureHistogram
    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.server import new_mem_server
    from sda_tpu_torch.sketches import CountMinSketch, SketchQuery

    chacha_cuda.launches = 0
    walls = {}
    for name in EXAMPLES:
        module = importlib.import_module(f"sda_tpu_torch.examples.{name}")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = module.main(["--device", str(dev)])
        walls[name] = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        _line("example", name=name, rc=rc, wall_s=walls[name], lines=len(lines), last=lines[-1],
              card=card)
        if rc != 0:
            raise AssertionError(f"example {name} returned {rc}")

    rng = np.random.default_rng(seed)
    values = [rng.random(HISTOGRAM_VALUES) for _ in range(ANALYTICS_PARTICIPANTS)]
    items = [[f"item-{int(v)}" for v in rng.zipf(1.5, size=200) % 1000] for _ in range(ANALYTICS_PARTICIPANTS)]
    with tempfile.TemporaryDirectory() as tmp:
        server = new_mem_server()

        def client(name):
            keystore = Keystore(Path(tmp) / name)
            member = SdaClient(SdaClient.new_agent(keystore), keystore, server, device=dev)
            member.upload_agent()
            return member

        recipient = client("recipient")
        rkey = recipient.new_encryption_key()
        recipient.upload_encryption_key(rkey)
        clerks = [client(f"clerk{i}") for i in range(SEALED_CLERKS)]
        for clerk in clerks:
            clerk.upload_encryption_key(clerk.new_encryption_key())
        parties = [client(f"party{i}") for i in range(ANALYTICS_PARTICIPANTS)]

        def query_round(query, inputs):
            t0 = time.perf_counter()
            agg = query.open_round(recipient, rkey)
            for party, x in zip(parties, inputs):
                query.submit(party, agg, x)
            query.close_round(recipient, agg)
            for member in [recipient] + clerks:
                member.run_chores(-1)
            return query.finish(recipient, agg, len(inputs)).cpu().numpy(), time.perf_counter() - t0

        hist = SecureHistogram(HISTOGRAM_BINS, 0.0, 1.0, ANALYTICS_PARTICIPANTS, device=dev)
        counts, hist_s = query_round(hist, values)
        want = sum(np.bincount(np.clip(np.floor(v * HISTOGRAM_BINS), 0, HISTOGRAM_BINS - 1).astype(np.int64),
                               minlength=HISTOGRAM_BINS) for v in values)
        cm = CountMinSketch(COUNTMIN_WIDTH, COUNTMIN_DEPTH, seed=COUNTMIN_SEED)
        table, cm_s = query_round(SketchQuery(cm, ANALYTICS_PARTICIPANTS, device=dev), items)
        want_table = _countmin_table(items, COUNTMIN_WIDTH, COUNTMIN_DEPTH, COUNTMIN_SEED)
    checks = {"histogram": bool(np.array_equal(counts, want)) and counts.dtype == np.int64,
              "countmin": bool(np.array_equal(table, want_table)),
              "k2_launches": chacha_cuda.launches == 0}
    _line("analytics", examples_s=walls, histogram={"bins": HISTOGRAM_BINS, "total": int(counts.sum()),
                                                    "wall_s": hist_s},
          countmin={"width": COUNTMIN_WIDTH, "depth": COUNTMIN_DEPTH, "total": int(table[:COUNTMIN_WIDTH].sum()),
                    "wall_s": cm_s},
          launches={"chacha20": chacha_cuda.launches}, exact=all(checks.values()), checks=checks, card=card)
    if not all(checks.values()):
        raise AssertionError(f"analytics: a check failed: {checks}")


# phase 17: the REST deployment. Phase 14's round with every member on its
# own ``SdaHttpClient`` (binary frames on the hot routes) against an
# ``sdad`` subprocess over loopback HTTP on the sqlite store (the JSON-file
# store where this Python lacks ``sqlite3``); the recipient's fold runs on
# K2 in this process. Then the reference's CLI walkthrough
# (scripts/simple-cli-example.sh) against a second ``sdad`` on the file
# store, each ``sda`` step called in process
SDAD_START_S = 120
CLI_RESULT = "result: 0 2 2 4 4 6 6 8 8 10"


def _start_sdad(store_args, log_path: Path, env=None):
    """``python -m sda_tpu_torch.cli.sdad <store_args> httpd -b 127.0.0.1:0``
    from this checkout, with ``env`` added to its environment and its stderr
    to ``log_path``; returns ``(process, base url)`` once it prints its
    ``listening`` line."""
    import select

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, **(env or {}),
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sda_tpu_torch.cli.sdad", *store_args, "httpd", "-b",
             "127.0.0.1:0"], cwd=root, env=env, stdout=subprocess.PIPE, stderr=log, text=True)
    deadline = time.monotonic() + SDAD_START_S
    while time.monotonic() < deadline:
        if select.select([proc.stdout], [], [], 1.0)[0]:
            line = proc.stdout.readline()
            if line.startswith("sdad: listening on "):
                return proc, "http://" + line.split("listening on ", 1)[1].strip()
            if not line:
                break
    proc.kill()
    proc.wait()
    raise AssertionError(f"sdad {store_args} did not start; stderr:\n{log_path.read_text()[-3000:]}")


def _round_store(tmp: Path) -> list:
    """``sdad``'s store arguments for a round: sqlite under ``tmp``, or the
    file store where this Python has no ``sqlite3``."""
    try:
        import sqlite3  # noqa: F401
    except ImportError:
        return ["--file", str(tmp / "store")]
    return ["--sqlite", str(tmp / "sda.db")]


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


class _Traffic:
    """Counts what every ``SdaHttpClient`` of this process exchanges while
    installed: requests and bytes each way, and the range reads of paged
    jobs and results by the job or snapshot they read. Clerk threads and
    prefetch workers exchange concurrently, so every count is taken under
    one lock."""

    RANGES = re.compile(r"/(jobs|snapshots)/([^/]+)/(chunks|result/masks|result/clerks)/\d+$")

    def __init__(self):
        self.counts = {"requests": 0, "bytes_up": 0, "bytes_down": 0}
        self.ranges: dict = {}
        self._lock = threading.Lock()
        self._real = None

    def install(self) -> None:
        from sda_tpu_torch.rest import SdaHttpClient

        real = self._real = SdaHttpClient._exchange

        def counted(client, root, method, target, body, headers):
            resp = real(client, root, method, target, body, headers)
            match = self.RANGES.search(target.split("?", 1)[0])
            with self._lock:
                self.counts["requests"] += 1
                self.counts["bytes_up"] += len(body or b"")
                self.counts["bytes_down"] += len(resp.content)
                if match:
                    key = (match.group(3), match.group(2))
                    self.ranges[key] = self.ranges.get(key, 0) + 1
            return resp

        SdaHttpClient._exchange = counted

    def remove(self) -> None:
        from sda_tpu_torch.rest import SdaHttpClient

        if self._real is not None:
            SdaHttpClient._exchange = self._real
            self._real = None

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.remove()


def _prometheus_sum(text: str, name: str, **labels) -> float:
    """Sum of the samples of the series ``name`` in a Prometheus body whose
    labels include ``labels``."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            head, value = line.rsplit(" ", 1)
            if all(f'{k}="{v}"' in head for k, v in labels.items()):
                total += float(value)
    return total


def _cli_walkthrough(url: str, root: Path) -> str:
    """scripts/simple-cli-example.sh's steps through
    ``sda_tpu_torch.cli.sda.main`` in this process, on CUDA clients; returns
    the reveal's printed line."""
    import contextlib
    import io

    from sda_tpu_torch.cli import sda

    def run(who, *argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = sda.main(["-s", url, "-i", str(root / who), *argv])
        if rc != 0:
            raise AssertionError(f"sda {argv} as {who}: rc {rc}")
        return out.getvalue()

    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        run(who, "agent", "create")
        run(who, "agent", "keys", "create")
    for who in ("part-1", "part-2", "part-3"):
        run(who, "agent", "create")
    key = next(f.stem for f in (root / "recipient" / "keys").glob("*.json") if '"ek"' in f.read_text())
    agg = "ad3142d8-9a83-4f40-a64a-a8c90b701bde"
    run("recipient", "aggregations", "create", "--id", agg, "aggro", "10", "433", key, "3")
    run("recipient", "aggregations", "begin", agg)
    for who, values in (("part-1", range(10)), ("part-2", [0] * 10), ("part-3", [0, 1] * 5)):
        run(who, "participate", agg, *map(str, values))
    run("recipient", "aggregations", "end", agg)
    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        run(who, "clerk", "--once")
    return run("recipient", "aggregations", "reveal", agg).strip()


def rest_round_phase(card: str, dev, seed: int, sm_clocks_per_ms: float):
    """Phase 17: phase 14's round (``sealed_round`` with its three checks)
    over loopback HTTP to an ``sdad --sqlite`` subprocess, each member on its
    own ``SdaHttpClient``. Held to: the reveal against an independent numpy
    sum mod p, exactly one K2 launch (plus any slack recovery) in this, the
    recipient's, process, the three refusals, and the server's
    ``sda_http_requests_total`` in ``/v1/metrics`` equal to the requests
    the clients completed. One ``rest round`` line (stage seconds, requests
    and bytes each way counted at the client, wire mode, store, whether
    ``sqlite3`` imports, the card); K2 against its plain version at the
    fold's shape. Then the CLI walkthrough against an ``sdad --file``
    subprocess, which must print ``CLI_RESULT`` with no K2 launch (``cli
    walkthrough`` line). Returns ``(k2 launches, k2 max_abs_err)``."""
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.rest import SdaHttpClient, TokenStore, wire

    rng = np.random.default_rng(seed + 17)
    scheme, values = _sealed_updates(dev, rng)
    p, dim = scheme.prime_modulus, len(values[0])
    want = np.stack(values).sum(axis=0) % p
    traffic = _Traffic()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        store = _round_store(tmp)
        proc, url = _start_sdad(store, tmp / "sdad.log")
        try:
            def service_for(name):
                return SdaHttpClient(url, TokenStore(tmp / "round" / name))

            torch.cuda.synchronize()
            chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
            with traffic:
                out = sealed_round(dev, tmp / "round", values, scheme, with_checks=True,
                                   service_for=service_for)
            launches, recoveries = chacha_cuda.launches, chacha_cuda.slack_recoveries
            with urllib.request.urlopen(url + "/v1/metrics", timeout=60) as resp:
                metrics = resp.read().decode("utf-8")
        finally:
            _stop(proc)
        served = _prometheus_sum(metrics, "sda_http_requests_total")
        exact = bool(np.array_equal(out["values"], want))
        checks = {"sum": exact, "one_k2_launch": launches - recoveries == 1,
                  "metrics_count_requests": served == traffic.counts["requests"], **out["checks"]}
        _line("rest round", participants=SEALED_COHORT, clerks=SEALED_CLERKS, dim=dim, modulus=p,
              scheme={"k": scheme.secret_count, "t": scheme.privacy_threshold, "n": scheme.share_count},
              **out["seconds"], **traffic.counts, served_requests=served, wire=wire.mode(),
              store=store[0][2:], sqlite3=store[0] == "--sqlite", seals=out["seals"],
              seal_mb_s=out["seal_mb_s"],
              opens=out["opens"], open_mb_s=out["open_mb_s"], launches={"chacha20": launches},
              slack_recoveries=recoveries, exact=exact, checks=checks, card=card)
        if not all(checks.values()):
            raise AssertionError(f"rest round: a check failed: {checks}")

        proc, url = _start_sdad(["--file", str(tmp / "cli-server")], tmp / "sdad-cli.log")
        try:
            chacha_cuda.launches = 0
            t0 = time.perf_counter()
            result = _cli_walkthrough(url, tmp / "cli")
            cli_s = time.perf_counter() - t0
        finally:
            _stop(proc)
        _line("cli walkthrough", result=result, wall_s=cli_s, launches={"chacha20": chacha_cuda.launches},
              card=card)
        if result != CLI_RESULT or chacha_cuda.launches:
            raise AssertionError(f"cli walkthrough: {result!r}, {chacha_cuda.launches} chacha20 "
                                 f"launches (expected {CLI_RESULT!r}, 0)")

    k2_err = _k2_at_fold(card, dev, out["folds"], dim, p, sm_clocks_per_ms, launches, "rest round")
    return launches, k2_err


# phase 18: the scale-out plane, the SDA deployment for cohorts larger than
# one committee and one store can serve (the tree of arXiv 2201.00864).
# Two ``sdad --sqlite ROOT --shards 2 --replicas 2`` frontends over one root,
# every member on a two-root ``SdaHttpClient``; phase 14's aggregation made
# tiered (two sub-cohorts under the root, share promotion), the paper's
# per-round cohort of 10, one pool of 8 clerks wrapped over the 3 nodes.
TIER_FRONTENDS, TIER_SHARDS, TIER_REPLICAS, TIER_SUB_COHORTS = 2, 2, 2, 2
# the frontends' hinted-handoff repair interval (the reference's default is
# 0.5 s); the drain after the heal is polled until both queues read 0
TIER_HANDOFF_S, TIER_DRAIN_S = 0.2, 120
# failed replays of one hint a frontend allows before it drops the hint.
# Each frontend replays only its own hints, so a hint whose write depends on
# a write the other frontend hinted (a clerking result on its job's enqueue)
# fails until the other has replayed it. The default 8 tries span 1.6 s at
# this interval, less than one frontend's replay of this round's writes
# (~12 s on the H100's host); a dropped hint leaves the healed replica
# without the write, and the root's reveal then reads a stale result
# count. So the budget covers the drain deadline.
TIER_HANDOFF_ATTEMPTS = int(TIER_DRAIN_S / TIER_HANDOFF_S)


def _tier_agent_ids(rng, aggregation, tiers_mod, agent_id_cls, count: int, at_least: int) -> list:
    """``count`` participant ids drawn from ``rng``, redrawn until every
    sub-cohort of ``aggregation`` holds at least ``at_least`` of them, so
    every promoter's mask fold reaches the device threshold."""
    import uuid

    while True:
        ids = [agent_id_cls(str(uuid.UUID(int=int(rng.integers(0, 1 << 62)) << 64
                                          | int(rng.integers(0, 1 << 62)), version=4)))
               for _ in range(count)]
        sizes = {}
        for agent_id in ids:
            leaf = tiers_mod.leaf_aggregation_id(aggregation, agent_id)
            sizes[leaf] = sizes.get(leaf, 0) + 1
        if len(sizes) == aggregation.sub_cohort_size and min(sizes.values()) >= at_least:
            return ids


def tier_round_phase(card: str, dev, seed: int, sm_clocks_per_ms: float):
    """Phase 18: the tiered round over two sharded, replicated frontends.
    Participants route to their leaves by hashing; ``run_tier_round``
    closes the leaves (each promoter folds its sub-cohort's masks on K2 and
    submits the correction row), the leaf clerks re-share their columns to
    the root, the root's committee clerks, the recipient reveals (its fold
    on K2). After the participations one shard's down marker is touched;
    it is removed just before the root's reveal, which waits for both
    frontends' hint queues to drain. Held to: the reveal against numpy's sum
    mod p, one reconstruction in the whole round (the root's), K2 launched
    once per fold of at least 2^22 seed x dim elements and bit-identical to
    its plain version at each fold's shape, writes hinted while the shard
    was down and none left after the heal, and the servers' summed
    ``sda_http_requests_total`` equal to the requests the clients
    completed. Returns ``(k2 launches, k2 max_abs_err)``."""
    import tempfile
    import urllib.request
    import uuid

    import numpy as np
    import torch

    from sda_tpu_torch import telemetry
    from sda_tpu_torch.client import SdaClient, run_tier_round, setup_tier_round
    from sda_tpu_torch.crypto import Keystore, masking, sharing
    from sda_tpu_torch.crypto.masking import ChaChaMasker
    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.protocol import (
        Agent,
        Aggregation,
        AgentId,
        AggregationId,
        ChaChaMasking,
        SodiumEncryptionScheme,
    )
    from sda_tpu_torch.protocol import tiers as tiers_mod
    from sda_tpu_torch.rest import SdaHttpClient, TokenStore, wire
    from sda_tpu_torch.server.sharded import ShardRouter

    rng = np.random.default_rng(seed + 18)
    scheme, values = _sealed_updates(dev, rng)
    p, dim = scheme.prime_modulus, len(values[0])
    want = np.stack(values).sum(axis=0) % p
    threshold = ChaChaMasker.DEVICE_COMBINE_THRESHOLD
    at_least = -(-threshold // dim)  # rows whose fold reaches the device threshold
    traffic = _Traffic()

    folds = []
    real_combine = masking.combine_masks_device

    def timed_combine(seeds, *args, **kwargs):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = real_combine(seeds, *args, **kwargs)
        events[1].record()
        folds.append((events, np.asarray(seeds)))
        return out

    reconstructions = []
    real_reconstruct = sharing.PackedShamirReconstructor.reconstruct

    def counted_reconstruct(self, indexed_shares):
        reconstructions.append(len(indexed_shares))
        return real_reconstruct(self, indexed_shares)

    def metrics(url):
        with urllib.request.urlopen(url + "/v1/metrics", timeout=60) as resp:
            return resp.read().decode("utf-8")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "store"
        procs, urls = [], []
        try:
            for ix in range(TIER_FRONTENDS):
                proc, url = _start_sdad(["--sqlite", str(root), "--shards", str(TIER_SHARDS),
                                         "--replicas", str(TIER_REPLICAS)], tmp / f"sdad{ix}.log",
                                        env={"SDA_SHARD_HANDOFF_S": str(TIER_HANDOFF_S),
                                             "SDA_SHARD_HANDOFF_ATTEMPTS": str(TIER_HANDOFF_ATTEMPTS)})
                procs.append(proc)
                urls.append(url)
        except BaseException:
            for proc in procs:
                _stop(proc)
            raise
        polls = 0
        marker = None
        seconds = {}
        failed = True
        try:
            def client(name, agent_id=None):
                keystore = Keystore(tmp / "members" / name)
                agent = SdaClient.new_agent(keystore)
                if agent_id is not None:
                    agent = Agent(id=agent_id, verification_key=agent.verification_key)
                service = SdaHttpClient(list(urls), TokenStore(tmp / "members" / name))
                return SdaClient(agent, keystore, service, device=dev)

            def keyed(name):
                member = client(name)
                member.upload_agent()
                member.upload_encryption_key(member.new_encryption_key())
                return member

            torch.cuda.synchronize()
            chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
            telemetry.reset()
            traffic.install()
            masking.combine_masks_device = timed_combine
            sharing.PackedShamirReconstructor.reconstruct = counted_reconstruct
            t_wall = time.perf_counter()
            t0 = time.perf_counter()
            recipient = client("recipient")
            recipient.upload_agent()
            recipient_key = recipient.new_encryption_key()
            recipient.upload_encryption_key(recipient_key)
            clerks = [keyed(f"clerk{i}") for i in range(SEALED_CLERKS)]
            aggregation = Aggregation(
                id=AggregationId(str(uuid.UUID(int=int(rng.integers(0, 1 << 62)), version=4))),
                title="tier round", vector_dimension=dim, modulus=p,
                recipient=recipient.agent.id, recipient_key=recipient_key,
                masking_scheme=ChaChaMasking(modulus=p, dimension=dim, seed_bitsize=32 * SEED_WORDS),
                committee_sharing_scheme=scheme,
                recipient_encryption_scheme=SodiumEncryptionScheme(),
                committee_encryption_scheme=SodiumEncryptionScheme(),
                sub_cohort_size=TIER_SUB_COHORTS, tiers=2)
            tround = setup_tier_round(recipient, aggregation, client, clerks,
                                      frontends=TIER_FRONTENDS)
            ids = _tier_agent_ids(rng, aggregation, tiers_mod, AgentId, SEALED_COHORT, at_least)
            participants = [client(f"participant{i}", agent_id) for i, agent_id in enumerate(ids)]
            for participant in participants:
                participant.upload_agent()
            seconds["setup_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for participant, v in zip(participants, values):
                participant.participate(v, aggregation.id)
            seconds["participate_s"] = time.perf_counter() - t0

            # the mid-round fault: one shard down for every frontend, from
            # the close of the leaves to the root's reveal
            down = ShardRouter(TIER_SHARDS, replicas=TIER_REPLICAS).targets(aggregation.id)[0]
            marker = Path(ShardRouter.down_marker(str(root), down))
            marker.touch()
            hinted = {}
            real_reveal = recipient.reveal_aggregation

            def healed_reveal(aggregation_id):
                nonlocal polls
                texts = [metrics(url) for url in urls]
                polls += len(urls)
                hinted["while_down"] = sum(
                    _prometheus_sum(t, "sda_shard_replica_writes_total", outcome="hinted")
                    for t in texts)
                marker.unlink()
                deadline = time.monotonic() + TIER_DRAIN_S
                t_heal = time.perf_counter()
                while True:
                    texts = [metrics(url) for url in urls]
                    polls += len(urls)
                    depth = sum(_prometheus_sum(t, "sda_shard_handoff_queue") for t in texts)
                    if depth == 0 or time.monotonic() > deadline:
                        break
                    time.sleep(TIER_HANDOFF_S)
                seconds["drain_s"] = time.perf_counter() - t_heal
                hinted["depth_after_heal"] = depth
                return real_reveal(aggregation_id)

            recipient.reveal_aggregation = healed_reveal
            result = run_tier_round(tround)
            seconds["wall_s"] = time.perf_counter() - t_wall
            failed = False
        finally:
            traffic.remove()
            masking.combine_masks_device = real_combine
            sharing.PackedShamirReconstructor.reconstruct = real_reconstruct
            if marker is not None and marker.exists():
                marker.unlink()
            try:
                texts = [metrics(url) for url in urls]
            finally:
                for proc in procs:
                    _stop(proc)
                # the frontends' own account of any hint they gave up on
                abandoned_log = [line.split("sda.shard ", 1)[-1][:300]
                                 for ix in range(TIER_FRONTENDS)
                                 for line in (tmp / f"sdad{ix}.log").read_text().splitlines()
                                 if "abandoned after" in line]
                if failed:
                    _line("tier round failed", seconds=seconds, abandoned_log=abandoned_log,
                          card=card)
        launches, recoveries = chacha_cuda.launches, chacha_cuda.slack_recoveries
        torch.cuda.synchronize()
        layout = sorted(path.name for path in root.glob("shard-*.db"))

    spans = {name: sum(s["duration_s"] for s in telemetry.spans(name=name))
             for name in ("tier.close", "tier.promote", "tier.root_close", "tier.root_reveal")}
    reshare = [h for h in telemetry.snapshot(include_spans=0)["histograms"]
               if h["name"] == "sda_tier_reshare_seconds"]
    fold_rows = [int(seeds.shape[0]) for _, seeds in folds]
    leaf_sizes = sorted(sum(1 for i in ids if tiers_mod.leaf_aggregation_id(aggregation, i) == tn.aggregation.id)
                        for tn in tround.leaves())
    root_rows = TIER_SUB_COHORTS * (scheme.share_count + 1)
    implied = sum(1 for rows in leaf_sizes + [root_rows] if rows * dim >= threshold)
    served = sum(_prometheus_sum(t, "sda_http_requests_total") for t in texts)
    drained = sum(_prometheus_sum(t, "sda_shard_replica_writes_total", outcome="handoff")
                  for t in texts)
    abandoned = sum(_prometheus_sum(t, "sda_shard_replica_writes_total", outcome="abandoned")
                    for t in texts)
    exact = bool(np.array_equal(result.output.positive().values, want))
    checks = {
        "sum": exact,
        "nothing_skipped": result.skipped == [],
        "one_reconstruction": len(reconstructions) == 1,
        "k2_per_fold": launches - recoveries == implied == len(folds),
        "hinted_while_down": hinted.get("while_down", 0) > 0,
        "hints_drained": hinted.get("depth_after_heal") == 0,
        "no_hint_dropped": abandoned == 0,
        "metrics_count_requests": served == traffic.counts["requests"] + polls,
        "shard_layout": layout == [f"shard-{ix:02d}.db" for ix in range(TIER_SHARDS)],
    }
    _line("tier round", participants=SEALED_COHORT, clerks=SEALED_CLERKS, dim=dim, modulus=p,
          scheme={"k": scheme.secret_count, "t": scheme.privacy_threshold, "n": scheme.share_count},
          tiers=2, sub_cohorts=TIER_SUB_COHORTS, leaf_sizes=leaf_sizes, frontends=TIER_FRONTENDS,
          shards=TIER_SHARDS, replicas=TIER_REPLICAS, down_shard=down,
          setup_s=seconds["setup_s"], participate_s=seconds["participate_s"],
          promote_s=spans["tier.close"], leaf_clerking_s=spans["tier.promote"],
          reshare_s=sum(h["sum"] for h in reshare), reshares=sum(h["count"] for h in reshare),
          root_clerking_s=spans["tier.root_close"],
          reveal_s=spans["tier.root_reveal"] - seconds["drain_s"], drain_s=seconds["drain_s"],
          mask_combine_s=[a.elapsed_time(b) / 1e3 for (a, b), _ in folds], fold_rows=fold_rows,
          wall_s=seconds["wall_s"], **traffic.counts, served_requests=served, metrics_polls=polls,
          wire=wire.mode(), hints_hinted=hinted.get("while_down"), hints_drained=drained,
          hints_abandoned=abandoned, abandoned_log=abandoned_log,
          handoff_s=TIER_HANDOFF_S, handoff_attempts=TIER_HANDOFF_ATTEMPTS,
          reconstructions=len(reconstructions), k2_launches=launches, implied_folds=implied,
          slack_recoveries=recoveries, exact=exact, checks=checks, card=card)
    if not all(checks.values()):
        raise AssertionError(f"tier round: a check failed: {checks}")
    k2_err = 0
    for ix, fold in enumerate(folds):
        k2_err = max(k2_err, _k2_at_fold(card, dev, [fold], dim, p, sm_clocks_per_ms, launches,
                                         f"tier round fold {ix}"))
    return launches, k2_err


# phase 19: arrival-driven ingest against one ``sdad --sqlite`` whose every
# job and result is paged (the reference's own knobs, as
# tests/test_reveal_chunks.py sets them), the clients reading ranges
# INGEST_PREFETCH_DEPTH deep. The cohort is INGEST_PHONES phones on
# INGEST_IDENTITIES participant identities (``ingest_cohort`` cycles them),
# released on the flagship's default trace shape (scripts/flagship.py:518)
# with the base rate scaled to what this host builds at the CNN's width
INGEST_PHONES, INGEST_IDENTITIES, INGEST_WINDOW = 16, 4, 8
INGEST_TRACE = "base=0.5,diurnal=0.6@20,burst=0.15@4,churn=0.25:16"
INGEST_PREFETCH_DEPTH, INGEST_RANGE = 3, 4
INGEST_SERVER_ENV = {"SDA_JOB_PAGE_THRESHOLD": "0", "SDA_JOB_CHUNK_SIZE": str(INGEST_RANGE),
                     "SDA_RESULT_PAGE_THRESHOLD": "0", "SDA_RESULT_CHUNK_SIZE": str(INGEST_RANGE)}
# phase 20: the Packed Paillier round against the same ``sdad``. 50 components
# of 40 bits fill 2,000 of a 2,048-bit key's plaintext bits and hold 2^8
# additions of 32-bit values, more than PAILLIER_COHORT; the dimension is cut
# to PAILLIER_DIM because every ciphertext block is a 4,096-bit host modexp:
# 5.44 ms each on the native layer's 8 threads of an H100 host (phase 21's
# ``native rates``), so 20,000 values (4,000 encryptions) keep the phase
# near its 40 s, where 50,000 would take ~55 s of encryptions alone
PAILLIER_DIM, PAILLIER_COHORT, PAILLIER_KEY_BITS = 20_000, 10, 2048
PAILLIER_PACKING = {"component_count": 50, "component_bitsize": 40, "max_value_bitsize": 32,
                    "min_modulus_bitsize": PAILLIER_KEY_BITS}


def _gauge_value(telemetry, name: str):
    values = [value for (n, _), value in telemetry.get_registry().snapshot()["gauges"].items()
              if n == name]
    return values[0] if values else None


def _histogram_sum(telemetry, name: str, **labels) -> float:
    return sum(h["sum"] for h in telemetry.snapshot(include_spans=0)["histograms"]
               if h["name"] == name and all(h["labels"].get(k) == v for k, v in labels.items()))


def ingest_round_phase(card: str, dev, seed: int, sm_clocks_per_ms: float, url: str, root: Path,
                       traffic: "_Traffic"):
    """Phase 19: ``INGEST_PHONES`` quantized CNN updates through
    ``ingest_cohort(..., window=INGEST_WINDOW)`` on ``INGEST_TRACE`` against
    the paging ``sdad`` at ``url``, every member on its own
    ``SdaHttpClient``; then the snapshot, the 8 clerks on 8 threads
    (``run_committee``), each reading its paged job through the prefetch
    pipeline, and the recipient's paged reveal, which folds each mask range
    as it arrives, one K2 launch per range of at least 2^22 seed x dim
    elements. Held to: the reveal against numpy's sum mod p; K2 launched
    once per such range, on the reveal's own thread, and bit-identical to its
    plain version at each fold's shape; every job and the result read in
    more than one range; no live row handed to the service before its
    arrival less the slack, every churned row after the last live row,
    ``IngestReport.churned`` equal to the trace's churn count; the backlog
    within its bound; the requests counted here equal to the server's
    summed ``sda_http_requests_total``; and every seal and open of this
    process counted on a native C path (``_NativeTally``). Returns ``(k2
    launches, k2 max_abs_err, served requests)``."""
    import urllib.request

    import numpy as np
    import torch

    from sda_tpu_torch import telemetry
    from sda_tpu_torch.client import SdaClient, ingest_cohort, run_committee
    from sda_tpu_torch.client.ingest import arrival_slack_s, plan_arrivals
    from sda_tpu_torch.crypto import Keystore, masking
    from sda_tpu_torch.crypto.masking import ChaChaMasker
    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.protocol import (
        Aggregation,
        AggregationId,
        ChaChaMasking,
        SodiumEncryptionScheme,
    )
    from sda_tpu_torch.rest import SdaHttpClient, TokenStore, wire
    from sda_tpu_torch.utils.arrivals import ArrivalTrace

    rng = np.random.default_rng(seed + 19)
    scheme, values = _sealed_updates(dev, rng, INGEST_PHONES)
    p, dim = scheme.prime_modulus, len(values[0])
    want = np.stack(values).sum(axis=0) % p
    threshold = ChaChaMasker.DEVICE_COMBINE_THRESHOLD
    trace = ArrivalTrace.from_text(INGEST_TRACE)
    schedule = plan_arrivals(trace, {"index": 0, "t": 0.0}, INGEST_PHONES)
    slack = arrival_slack_s()
    consumer = threading.current_thread()

    folds = []
    real_combine = masking.combine_masks_device

    def timed_combine(seeds, *args, **kwargs):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = real_combine(seeds, *args, **kwargs)
        events[1].record()
        folds.append((events, np.asarray(seeds), threading.current_thread() is consumer))
        return out

    def client(name):
        keystore = Keystore(root / name)
        service = SdaHttpClient(url, TokenStore(root / name))
        return SdaClient(SdaClient.new_agent(keystore), keystore, service, device=dev)

    # which slot each built participation holds, and when each upload left
    slot_of = {id(v): s for s, v in enumerate(values)}
    slots, uploads = {}, []
    lock = threading.Lock()

    def recorded(phone):
        real_build, real_upload = phone.new_participations, phone.upload_participations

        def build(vals, aggregation_id, **kwargs):
            parts = real_build(vals, aggregation_id, **kwargs)
            with lock:
                slots.update((part.id, slot_of[id(v)]) for v, part in zip(vals, parts))
            return parts

        def upload(parts):
            t = time.perf_counter()
            real_upload(parts)
            with lock:
                uploads.append((t, [slots[part.id] for part in parts]))

        phone.new_participations, phone.upload_participations = build, upload
        return phone

    seconds = {}
    prior_depth = os.environ.get("SDA_PREFETCH_DEPTH")
    os.environ["SDA_PREFETCH_DEPTH"] = str(INGEST_PREFETCH_DEPTH)
    torch.cuda.synchronize()
    chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
    telemetry.reset()
    traffic.install()
    masking.combine_masks_device = timed_combine
    try:
        with _NativeTally() as tally:
            t_wall = time.perf_counter()
            recipient = client("recipient")
            recipient.upload_agent()
            recipient_key = recipient.new_encryption_key()
            recipient.upload_encryption_key(recipient_key)
            clerks = [client(f"clerk{i}") for i in range(SEALED_CLERKS)]
            for clerk in clerks:
                clerk.upload_agent()
                clerk.upload_encryption_key(clerk.new_encryption_key())
            aggregation = Aggregation(
                id=AggregationId.random(), title="ingest round", vector_dimension=dim, modulus=p,
                recipient=recipient.agent.id, recipient_key=recipient_key,
                masking_scheme=ChaChaMasking(modulus=p, dimension=dim,
                                             seed_bitsize=32 * SEED_WORDS),
                committee_sharing_scheme=scheme,
                recipient_encryption_scheme=SodiumEncryptionScheme(),
                committee_encryption_scheme=SodiumEncryptionScheme())
            recipient.upload_aggregation(aggregation)
            recipient.begin_aggregation(aggregation.id, chosen_clerks=[c.agent.id for c in clerks])
            phones = [recorded(client(f"phone{i}")) for i in range(INGEST_IDENTITIES)]
            for phone in phones:
                phone.upload_agent()
            seconds["setup_s"] = time.perf_counter() - t_wall

            t0 = time.perf_counter()
            cursor = {"index": 0, "t": 0.0, "t0": time.perf_counter()}
            report = ingest_cohort(phones, values, aggregation.id, trace=trace, cursor=cursor,
                                   window=INGEST_WINDOW)
            seconds["ingest_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            snapshot_id = recipient.end_aggregation(aggregation.id)
            seconds["snapshot_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            jobs = run_committee(clerks)
            seconds["clerking_s"] = time.perf_counter() - t0
            clerk_overlap = _gauge_value(telemetry, "sda_clerk_overlap_efficiency")
            t0 = time.perf_counter()
            out = recipient.reveal_aggregation(aggregation.id)
            seconds["reveal_s"] = time.perf_counter() - t0
            seconds["wall_s"] = time.perf_counter() - t_wall
            reveal_overlap = _gauge_value(telemetry, "sda_reveal_overlap_efficiency")
    finally:
        masking.combine_masks_device = real_combine
        traffic.remove()
        if prior_depth is None:
            os.environ.pop("SDA_PREFETCH_DEPTH", None)
        else:
            os.environ["SDA_PREFETCH_DEPTH"] = prior_depth
    launches, recoveries = chacha_cuda.launches, chacha_cuda.slack_recoveries
    torch.cuda.synchronize()
    with urllib.request.urlopen(url + "/v1/metrics", timeout=60) as resp:
        served = _prometheus_sum(resp.read().decode("utf-8"), "sda_http_requests_total")

    for stage in ("plan", "build", "upload"):
        seconds[stage] = _histogram_sum(telemetry, "sda_ingest_stage_seconds", stage=stage)
    job_ranges = {key: n for (kind, key), n in traffic.ranges.items() if kind == "chunks"}
    mask_ranges = traffic.ranges.get(("result/masks", str(snapshot_id)), 0)
    clerk_ranges = traffic.ranges.get(("result/clerks", str(snapshot_id)), 0)
    fold_rows = [int(seeds.shape[0]) for _, seeds, _ in folds]
    implied = sum(1 for rows in fold_rows if rows * dim >= threshold)
    live_uploads = [(t, s) for t, batch in uploads for s in batch if not schedule[s].churned]
    churned_uploads = [t for t, batch in uploads for s in batch if schedule[s].churned]
    early = [s for t, s in live_uploads if t < cursor["t0"] + schedule[s].at - slack - 1e-9]
    exact = bool(np.array_equal(out.positive().values, want))
    checks = {
        "sum": exact,
        "k2_per_mask_range": launches - recoveries == implied == mask_ranges == len(folds),
        "folds_on_consumer": all(on_consumer for _, _, on_consumer in folds),
        "jobs_paged": len(job_ranges) == SEALED_CLERKS and min(job_ranges.values()) > 1,
        "result_paged": mask_ranges > 1 and clerk_ranges > 1,
        "every_row_once": sorted(s for _, batch in uploads for s in batch)
        == list(range(INGEST_PHONES)),
        "no_early_release": not early,
        "churned_last": bool(churned_uploads) and min(churned_uploads)
        >= max(t for t, _ in live_uploads),
        "churn_count": report.churned == sum(e.churned for e in schedule),
        "backlog_bound": report.max_backlog_seen <= 4 * INGEST_WINDOW,
        "jobs_done": jobs == SEALED_CLERKS,
        "metrics_count_requests": served == traffic.counts["requests"],
        **tally.checks(),
    }
    _line("ingest round", phones=INGEST_PHONES, identities=INGEST_IDENTITIES, clerks=SEALED_CLERKS,
          dim=dim, modulus=p,
          scheme={"k": scheme.secret_count, "t": scheme.privacy_threshold, "n": scheme.share_count},
          trace=INGEST_TRACE, last_arrival_s=schedule[-1].at, window=INGEST_WINDOW,
          slack_s=slack, prefetch_depth=INGEST_PREFETCH_DEPTH, server_env=INGEST_SERVER_ENV,
          **seconds, windows=report.windows, batches=report.batches,
          deferred_batches=report.deferred_batches, churned=report.churned,
          max_backlog_seen=report.max_backlog_seen, max_lag_s=report.max_lag_s,
          sda_clerk_overlap_efficiency=clerk_overlap,
          sda_reveal_overlap_efficiency=reveal_overlap,
          job_ranges=sorted(job_ranges.values()), mask_ranges=mask_ranges,
          clerk_result_ranges=clerk_ranges, fold_rows=fold_rows,
          mask_combine_s=[a.elapsed_time(b) / 1e3 for (a, b), _, _ in folds],
          **traffic.counts, served_requests=served, wire=wire.mode(),
          k2_launches=launches, implied_folds=implied, slack_recoveries=recoveries,
          seals=tally.boxes["seal"], seal_mb_s=tally.rate_mb_s("seal"), opens=tally.boxes["open"],
          open_mb_s=tally.rate_mb_s("open"), exact=exact, checks=checks, card=card)
    if not all(checks.values()):
        raise AssertionError(f"ingest round: a check failed: {checks}")
    k2_err = 0
    for ix, (events, seeds, _) in enumerate(folds):
        k2_err = max(k2_err, _k2_at_fold(card, dev, [(events, seeds)], dim, p, sm_clocks_per_ms,
                                         launches, f"ingest round range {ix}"))
    return launches, k2_err, served


class _ModexpTally:
    """Counts the Paillier plane's modexps for the length of a ``with``
    block: ``native.mod_exp_batch`` calls and the bases they raise, and
    single ``mod_exp`` calls through ``ops.paillier._mod_exp``. Installed
    here, around the package's own calls; the package counts nothing."""

    def __init__(self):
        from sda_tpu_torch import native
        from sda_tpu_torch.ops import paillier

        self.native, self.paillier = native, paillier
        self.lock = threading.Lock()
        self.counts = {"batch_calls": 0, "batch_bases": 0, "single": 0}

    def __enter__(self):
        batch, single = self.real = self.native.mod_exp_batch, self.paillier._mod_exp

        def counted_batch(bases, *args, **kwargs):
            bases = list(bases)
            with self.lock:
                self.counts["batch_calls"] += 1
                self.counts["batch_bases"] += len(bases)
            return batch(bases, *args, **kwargs)

        def counted_single(*args, **kwargs):
            with self.lock:
                self.counts["single"] += 1
            return single(*args, **kwargs)

        self.native.mod_exp_batch, self.paillier._mod_exp = counted_batch, counted_single
        return self

    def __exit__(self, *exc):
        self.native.mod_exp_batch, self.paillier._mod_exp = self.real


def paillier_round_phase(card: str, dev, seed: int, url: str, root: Path, traffic: "_Traffic",
                         served_before: float) -> None:
    """Phase 20: the Packed Paillier round against phase 19's ``sdad``:
    ``PAILLIER_COHORT`` participants of ``PAILLIER_DIM`` field values under
    ``FullMasking``, their masks encrypted to the recipient's
    ``PAILLIER_KEY_BITS``-bit Paillier key from
    ``new_paillier_encryption_key`` (``PAILLIER_PACKING``), phase 14's packed
    Shamir sharing, 8 clerks. The server's snapshot multiplies the mask
    ciphertexts into one, and the recipient decrypts that one. Held to: the
    reveal against numpy's sum mod p, exactly one mask encryption in the
    (paged) snapshot result, no K2 launch (Full masking folds on the host),
    the server's request count, and every modexp of the participants'
    mask encryptions, of the clerks' result encryptions (the recipient's
    Paillier key encrypts both) and of the recipient's decryptions counted
    on ``native.mod_exp_batch`` (``_ModexpTally``), one call a vector."""
    import urllib.request

    import numpy as np
    import torch

    from sda_tpu_torch.client import SdaClient, run_committee
    from sda_tpu_torch.crypto import Keystore
    from sda_tpu_torch.models import QuantizationSpec
    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.protocol import (
        Aggregation,
        AggregationId,
        FullMasking,
        PackedPaillierEncryptionScheme,
        SodiumEncryptionScheme,
    )
    from sda_tpu_torch.rest import SdaHttpClient, TokenStore

    rng = np.random.default_rng(seed + 20)
    _, scheme = QuantizationSpec.fitted(FEDAVG_FRAC_BITS, FEDAVG_CLIP, SEALED_COHORT)
    p = scheme.prime_modulus
    values = rng.integers(0, p, size=(PAILLIER_COHORT, PAILLIER_DIM), dtype=np.int64)
    want = values.sum(axis=0) % p
    pscheme = PackedPaillierEncryptionScheme(**PAILLIER_PACKING)

    def client(name):
        keystore = Keystore(root / name)
        service = SdaHttpClient(url, TokenStore(root / name))
        return SdaClient(SdaClient.new_agent(keystore), keystore, service, device=dev)

    seconds = {}
    requests_before = traffic.counts["requests"]
    torch.cuda.synchronize()
    chacha_cuda.launches = 0
    traffic.install()
    try:
        t_wall = time.perf_counter()
        recipient = client("recipient")
        recipient.upload_agent()
        t0 = time.perf_counter()
        recipient_key = recipient.new_paillier_encryption_key(PAILLIER_KEY_BITS)
        seconds["keygen_s"] = time.perf_counter() - t0
        recipient.upload_encryption_key(recipient_key)
        clerks = [client(f"clerk{i}") for i in range(SEALED_CLERKS)]
        for clerk in clerks:
            clerk.upload_agent()
            clerk.upload_encryption_key(clerk.new_encryption_key())
        aggregation = Aggregation(
            id=AggregationId.random(), title="paillier round", vector_dimension=PAILLIER_DIM,
            modulus=p, recipient=recipient.agent.id, recipient_key=recipient_key,
            masking_scheme=FullMasking(p), committee_sharing_scheme=scheme,
            recipient_encryption_scheme=pscheme,
            committee_encryption_scheme=SodiumEncryptionScheme())
        recipient.upload_aggregation(aggregation)
        # the server also holds phase 19's keyed agents: name this committee
        recipient.begin_aggregation(aggregation.id, chosen_clerks=[c.agent.id for c in clerks])
        participants = [client(f"participant{i}") for i in range(PAILLIER_COHORT)]
        for participant in participants:
            participant.upload_agent()
        t0 = time.perf_counter()
        with _ModexpTally() as encrypting:
            for participant, row in zip(participants, values):
                participant.participate(row, aggregation.id)
        seconds["participate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        snapshot_id = recipient.end_aggregation(aggregation.id)
        seconds["snapshot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _ModexpTally() as clerking:
            run_committee(clerks)
        seconds["clerking_s"] = time.perf_counter() - t0
        result = recipient.service.get_snapshot_result(recipient.agent, aggregation.id, snapshot_id)
        t0 = time.perf_counter()
        with _ModexpTally() as decrypting:
            out = recipient.reveal_aggregation(aggregation.id)
        seconds["reveal_s"] = time.perf_counter() - t0
        seconds["wall_s"] = time.perf_counter() - t_wall
    finally:
        traffic.remove()
    with urllib.request.urlopen(url + "/v1/metrics", timeout=60) as resp:
        served = _prometheus_sum(resp.read().decode("utf-8"), "sda_http_requests_total")
    exact = bool(np.array_equal(out.positive().values, want))
    masks = result.mask_encryption_count if result.is_paged() else len(result.recipient_encryptions)
    # one mod_exp_batch a Paillier vector: a mask of PAILLIER_DIM values,
    # a clerk's result of one share per packed batch of k secrets
    per_block = PAILLIER_PACKING["component_count"]
    mask_blocks = -(-PAILLIER_DIM // per_block)
    share_blocks = -(-(-(-PAILLIER_DIM // scheme.secret_count)) // per_block)
    checks = {"sum": exact, "one_combined_mask": masks == 1, "no_k2": chacha_cuda.launches == 0,
              # phase 19's own metrics read is the one request not counted here
              "metrics_count_requests": served == traffic.counts["requests"] + 1,
              "encryptions_on_mod_exp_batch": encrypting.counts == {
                  "batch_calls": PAILLIER_COHORT, "batch_bases": PAILLIER_COHORT * mask_blocks,
                  "single": 0},
              "clerk_results_on_mod_exp_batch": clerking.counts == {
                  "batch_calls": SEALED_CLERKS, "batch_bases": SEALED_CLERKS * share_blocks,
                  "single": 0},
              "decryption_on_mod_exp_batch": decrypting.counts == {
                  "batch_calls": 1 + SEALED_CLERKS,
                  "batch_bases": mask_blocks + SEALED_CLERKS * share_blocks, "single": 0}}
    _line("paillier round", participants=PAILLIER_COHORT, clerks=SEALED_CLERKS, dim=PAILLIER_DIM,
          modulus=p, key_bits=PAILLIER_KEY_BITS, packing=PAILLIER_PACKING,
          scheme={"k": scheme.secret_count, "t": scheme.privacy_threshold, "n": scheme.share_count},
          **seconds, paged_result=result.is_paged(), mask_encryptions=masks,
          requests=traffic.counts["requests"] - requests_before,
          served_requests=served - served_before - 1,
          modexps={"participate": encrypting.counts, "clerking": clerking.counts,
                   "reveal": decrypting.counts},
          launches={"chacha20": chacha_cuda.launches}, exact=exact, checks=checks, card=card)
    if not all(checks.values()):
        raise AssertionError(f"paillier round: a check failed: {checks}")


def ingest_paillier_phases(card: str, dev, seed: int, sm_clocks_per_ms: float):
    """Phases 19 and 20 against one ``python -m sda_tpu_torch.cli.sdad
    --sqlite <tmp>/sda.db httpd`` (``--file`` where this Python has no
    ``sqlite3``) started with ``INGEST_SERVER_ENV``. Returns phase 19's
    ``(k2 launches, k2 max_abs_err)``."""
    import tempfile

    traffic = _Traffic()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        proc, url = _start_sdad(_round_store(tmp), tmp / "sdad.log", env=INGEST_SERVER_ENV)
        try:
            launches, k2_err, served = ingest_round_phase(card, dev, seed, sm_clocks_per_ms, url,
                                                          tmp / "ingest", traffic)
            paillier_round_phase(card, dev, seed, url, tmp / "paillier", traffic, served)
        finally:
            _stop(proc)
    return launches, k2_err


def flight_phase(card: str, dev, seed: int, sm_clocks_per_ms: float):
    """Phase 22: phase 14's sealed round once more (``SEALED_COHORT``
    CNN-width updates, 8 clerks, packed Shamir k=5, t=2, n=8, ChaCha) on
    CUDA clients, each participant through ``participate_many``, under one
    trace id, with the JSON log sink installed (``logsink.install``) for
    the round; then ``flight.round_report``, ``critical_path`` and
    ``chrome_trace_json`` over the round's spans. Held to: every finished
    span of the trace in the log exactly once with the trace id, one
    complete event per span in the Chrome trace, each stage's busy seconds
    and the stages' union at most the round's wall, the union at least half
    of it,
    the critical path inside the round's window, exactly one K2 launch (the
    recipient's fold), and the reveal against numpy's sum mod p. One
    ``flight`` line: the stages' seconds and shares, the critical path, the
    span and log-line counts. The stages nest, so "summing" reads their
    union (the report's ``busy_s``). Then K2 against its plain version at the
    fold's shape. Returns ``(k2 launches, k2 max_abs_err)``."""
    import tempfile

    import numpy as np
    import torch

    from sda_tpu_torch import telemetry
    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.telemetry import flight, logsink

    rng = np.random.default_rng(seed + 22)
    scheme, values = _sealed_updates(dev, rng)
    p, dim = scheme.prime_modulus, len(values[0])
    want = np.stack(values).sum(axis=0) % p
    with tempfile.TemporaryDirectory() as tmp:
        log_path = Path(tmp) / "telemetry.jsonl"
        torch.cuda.synchronize()
        chacha_cuda.launches = 0
        handler = logsink.install(log_path)
        try:
            with telemetry.trace() as trace_id:
                start = time.time()
                out = sealed_round(dev, Path(tmp) / "round", values, scheme, batched=True)
                end = time.time()
        finally:
            logsink.uninstall(handler)
        launches = chacha_cuda.launches
        lines = [json.loads(line) for line in log_path.read_text().splitlines()]
    spans = [s for s in telemetry.spans(trace_id=trace_id) if s.get("duration_s") is not None]
    logged = [r for r in lines if r.get("event") == "span" and r.get("trace_id") == trace_id]
    keys = [(r["name"], r["start"], r["duration_s"]) for r in logged]
    once = len(logged) == len(spans) and all(
        keys.count((s["name"], s["start"], s["duration_s"])) == 1 for s in spans)
    trace_doc = json.loads(flight.chrome_trace_json(spans))
    complete = [e for e in trace_doc["traceEvents"] if e["ph"] == "X"]
    report = flight.round_report(spans)
    wall = end - start
    # the stages nest (Metrics.phase's ``phase.clerk.*`` spans wrap the same
    # seconds as ``clerk.*``, the store's spans sit inside ``ingest.upload``),
    # so their sum counts some seconds twice; their union is the report's
    # ``busy_s``
    stage_sum = sum(row["busy_s"] for row in report["stages"])
    path = flight.critical_path(spans)
    hops = []  # the critical path, consecutive hops of one stage merged
    for hop in report["critical_path"]:
        stage = hop["name"].split(".", 1)[0]
        if hops and hops[-1]["stage"] == stage:
            hops[-1]["hops"] += 1
            hops[-1]["duration_s"] += hop["duration_s"]
            hops[-1]["names"] = sorted(set(hops[-1]["names"]) | {hop["name"]})
        else:
            hops.append({"stage": stage, "hops": 1, "offset_s": hop["offset_s"],
                         "duration_s": hop["duration_s"], "names": [hop["name"]]})
    exact = bool(np.array_equal(out["values"], want))
    checks = {"sum": exact, "one_k2_launch": launches == 1,
              "spans_logged_once_with_trace_id": bool(spans) and once,
              "chrome_trace_one_event_per_span": len(complete) == len(spans),
              "stages_within_wall": report["busy_s"] <= wall and all(
                  row["busy_s"] <= wall for row in report["stages"]),
              "stages_cover_half_the_wall": report["busy_s"] >= 0.5 * wall,
              "critical_path_inside_round": bool(path) and all(
                  start <= s["start"] and s["start"] + s["duration_s"] <= end for s in path),
              **out["checks"]}
    _line("flight", participants=SEALED_COHORT, clerks=SEALED_CLERKS, dim=dim, modulus=p,
          trace_id=trace_id, round_wall_s=wall, **out["seconds"],
          report={k: report[k] for k in ("spans", "wall_s", "busy_s", "span_s",
                                         "overlap_efficiency")},
          stages=[{k: row[k] for k in ("stage", "spans", "offset_s", "busy_s", "span_s", "share")}
                  for row in report["stages"]],
          stage_busy_sum_s=stage_sum, critical_path=hops,
          critical_path_longest=sorted(report["critical_path"], key=lambda h: -h["duration_s"])[:8],
          spans=len(spans), log_lines=len(lines), log_lines_of_trace=len(logged),
          chrome_trace_events=len(trace_doc["traceEvents"]),
          launches={"chacha20": launches}, exact=exact, checks=checks, card=card)
    if not all(checks.values()):
        raise AssertionError(f"flight: a check failed: {checks}")
    k2_err = _k2_at_fold(card, dev, out["folds"], dim, p, sm_clocks_per_ms, launches,
                         "flight round")
    return launches, k2_err


# phase 23: the protocol-plane riders as a user runs them, before the device
# run of the bench's K1 route, every size at the reference's default, the
# artifacts banked in a temporary directory
RIDER_ARGV = ["--engine", "participant", "--kernel"]
RIDER_TIMEOUT_S = 900
# K1 once a chunk of the participant preset (100,000 / 2,000), K2 never: the
# riders' folds stay on the host, below the device fold's threshold
RIDER_LAUNCHES = {"limb_share_sum": 50, "chacha20": 0}
HOST_PLANE_KEYS = {"crypto_plane": "seals_per_s", "rest_ingest": "participations_per_s"}
RIDER_KEYS = ("ingest", "wire", "clerking", "reveal", "committee", "shard", "replication", "tier",
              "sketch")
# the flags a rider's exactness checks leave in its result, every one true
EXACT_FLAGS = ("exact", "reveals_exact", "identical_reveals", "identical_to_serial", "byte_exact")


def _exact_flags(entry) -> list:
    """Every exactness flag anywhere in a rider's result."""
    if not isinstance(entry, dict):
        return []
    flags = [value for key, value in entry.items() if key in EXACT_FLAGS]
    for value in entry.values():
        flags += _exact_flags(value)
    return flags


def _per(legs: dict, field: str) -> dict:
    return {tag: leg.get(field) for tag, leg in legs.items()}


def _rider_headline(key: str, crypto: dict) -> dict:
    """The numbers a rider line carries: rates, seconds, ratios, RSS,
    per-shard counts, sketch headroom."""
    if key == "crypto_plane":
        return {k: crypto.get(k) for k in (
            "seals_per_s", "opens_per_s", "seals_per_s_4k", "seals_per_s_40k", "seal_batch_vs_scalar",
            "chacha_expand_elems_per_s", "chacha_combine_elems_per_s", "varint_encode_per_s",
            "varint_decode_per_s")}
    if key == "rest_ingest":
        return {"participations_per_s": crypto.get("participations_per_s")}
    entry = crypto[key]
    if key == "ingest":
        return {k: entry.get(k) for k in (
            "seal_batch_per_s", "seal_scalar_per_s", "seal_participations_seals_per_s", "build_per_s",
            "participate_many_per_s", "telemetry_overhead_pct", "rest_sqlite_singles_per_s",
            "rest_sqlite_batch_per_s", "rest_mem_singles_per_s", "rest_mem_batch_per_s")}
    if key == "wire":
        legs = {w: entry[w] for w in ("json", "binary")}
        return {"n": entry["n_participants"], "ingest_per_s": _per(legs, "ingest_per_s"),
                "clerking_fetch_per_s": _per(legs, "clerking_fetch_per_s"),
                "reveal_per_s": _per(legs, "reveal_per_s"), "peak_rss_mib": _per(legs, "peak_rss_mib"),
                "bytes": {w: {k: v for k, v in leg.items() if k.startswith("bytes_")}
                          for w, leg in legs.items()},
                "binary_vs_json": {k: entry[f"{k}_binary_vs_json"]
                                   for k in ("ingest", "clerking_fetch", "reveal")},
                "rss_flat": entry["rss_flat"]}
    if key in ("clerking", "reveal"):
        configs = entry["configs"]
        return {"n": entry["n_participants"], "seed_s": entry["seed_s"],
                "encryptions_per_s": _per(configs, "encryptions_per_s"),
                "wall_s": _per(configs, "wall_s"), "peak_rss_mib": _per(configs, "peak_rss_mib"),
                "overlap_efficiency": _per(configs, "overlap_efficiency")}
    if key == "committee":
        return {"n": entry["n_participants"], "seed_s": entry["seed_s"],
                "native_threads": entry["planes"]["clerking"]["w1"]["native_threads"],
                **{f"{plane}_per_s": _per(configs, "per_s") for plane, configs in entry["planes"].items()},
                "read_pool_reads_per_s": _per(entry["read_pool"], "reads_per_s")}
    if key == "shard":
        return {"n": entry["n_participations"], "ingest_per_s": _per(entry["legs"], "ingest_per_s"),
                "ingest_s": _per(entry["legs"], "ingest_s"),
                "shard_requests": _per(entry["legs"], "shard_requests"),
                "scaling_k2_vs_k1": entry["scaling_k2_vs_k1"],
                "scaling_k4_vs_k1": entry["scaling_k4_vs_k1"]}
    if key == "replication":
        return {"n": entry["n_participations"], "ingest_per_s": _per(entry["legs"], "ingest_per_s"),
                "r2_ingest_overhead_pct": entry["r2_ingest_overhead_pct"]}
    if key == "tier":
        ab = entry["promotion_ab"]
        return {"n": entry["n_participants"],
                "max_job_participations": _per(entry["configs"], "max_job_participations"),
                "wall_s": _per(entry["configs"], "wall_s"),
                "per_job_stage_s": _per(entry["configs"], "per_job_stage_s"),
                "per_node_promotion_s": _per(ab, "per_node_promotion_s"),
                "ab_wall_s": _per(ab, "wall_s")}
    legs = {**entry["families"]["countmin"]["legs"], **entry["families"]["cardinality"]["legs"]}
    return {"abs_err": {tag: leg.get("max_err", leg.get("abs_err")) for tag, leg in legs.items()},
            "bound_headroom": _per(legs, "bound_headroom"),
            "within_bound": _per(legs, "within_bound"), "items_per_s": _per(legs, "items_per_s")}


def riders_phase(card: str) -> int:
    """Phase 23: ``python -m sda_tpu_torch.bench --engine participant
    --kernel`` with the eleven protocol-plane riders on, at their default
    sizes, artifacts in a temporary directory. One ``rider`` line per rider
    with its headline numbers, then a ``riders`` line with the checks: all
    eleven present, none with an error, every exactness flag true, one
    artifact per banking rider, none written into ``bench-artifacts/``,
    CUDA uninitialised until the sketch rider, and the metric line verified
    with K1 launched once per chunk and K2 never. Returns K1's launches."""
    import tempfile

    env = {k: v for k, v in os.environ.items() if not k.startswith("SDA_BENCH_")}
    earlier = Path(__file__).resolve().parent / "bench-artifacts"
    earlier_files = sorted(earlier.iterdir()) if earlier.is_dir() else []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc, out, err = _module_cli("sda_tpu_torch.bench", [*RIDER_ARGV, "--artifacts", tmp],
                                   RIDER_TIMEOUT_S, env)
        wall_s = time.perf_counter() - t0
        banked = sorted(name.split("-", 1)[0] for name in os.listdir(tmp))
    lines = out.strip().splitlines()
    line = json.loads(lines[-1]) if lines else {}
    metric_lines = len(lines) - 1
    crypto = line.get("crypto", {})
    seconds = line.get("riders", {}).get("seconds", {})
    errors = {key: entry["error"] for key, entry in crypto.items()
              if isinstance(entry, dict) and "error" in entry}
    missing = [key for key, field in HOST_PLANE_KEYS.items() if field not in crypto]
    missing += [key for key in RIDER_KEYS if key not in crypto]
    flags = {}
    for key in (*HOST_PLANE_KEYS, *RIDER_KEYS):
        if key in missing or key in errors:
            continue
        entry = crypto.get(key, {})
        flags[key] = _exact_flags(entry)
        _line("rider", rider=key, seconds=seconds.get(key), exact_flags=len(flags[key]),
              exact=all(flags[key]), **_rider_headline(key, crypto), card=card)
    launches = line.get("launches", {})
    checks = {
        "rc_0": rc == 0,
        "verified": bool(line.get("verified")),
        "all_present": not missing,
        "no_rider_error": not errors,
        "exact": all(all(f) for f in flags.values()),
        "launches": launches == RIDER_LAUNCHES,
        "artifacts_banked": set(banked) >= {*RIDER_KEYS, "telemetry"},
        "bench_artifacts_untouched": (sorted(earlier.iterdir()) if earlier.is_dir() else []) == earlier_files,
        # only the sketch rider's clients compute on the card (its
        # FederatedAveraging dequantizes there), and it runs last
        "riders_before_cuda": not any(
            initialized for key, initialized in line.get("riders", {}).get(
                "cuda_initialized_after", {"": True}).items() if key != "sketch"),
    }
    _line("riders", argv=RIDER_ARGV, rc=rc, wall_s=wall_s, riders_s=sum(seconds.values()),
          metric_lines=metric_lines, launches=launches, value=line.get("value"),
          missing=missing, errors=errors, artifacts=banked, checks=checks, card=card)
    if not all(checks.values()):
        raise AssertionError(f"riders: checks {checks}; stderr tail:\n{err[-3000:]}")
    return launches["limb_share_sum"]


def _query_gpu(field: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sda_tpu_torch import kernels
    from sda_tpu_torch.ops import chacha_cuda, find_packed_parameters
    from sda_tpu_torch.ops.chacha import chacha_blocks_torch, expand_seed
    from sda_tpu_torch.ops.chacha_cuda import (
        chacha_blocks_cuda,
        combine_masks_device,
        expand_seeds_batch,
        expand_seeds_counts,
        seed_tensor,
    )
    from sda_tpu_torch.ops.modular import positive
    from sda_tpu_torch.ops.rng import uniform_bits_device_narrow
    from sda_tpu_torch.parallel import TorchAggregator, limb_cuda, make_plan
    from sda_tpu_torch.parallel.engine import reconstruct
    from sda_tpu_torch.parallel.limb_cuda import (
        participant_limb_sums_cuda,
        participant_limb_sums_torch,
        share_combine_limb_cuda,
        share_limb_sums_cuda,
        share_limb_sums_torch,
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
    from sda_tpu_torch import native

    t0 = time.perf_counter()
    native_build = {}

    def build_native():  # the host C beside the kernels' nvcc processes
        t = time.perf_counter()
        try:
            native.build()
        except Exception as e:  # noqa: BLE001 - re-raised on the main thread
            native_build["error"] = e
        native_build["seconds"] = time.perf_counter() - t

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    reports = kernels.build_all()
    native_thread.join()
    if "error" in native_build:
        raise native_build["error"]
    cc_version = subprocess.run([native.compiler(), "--version"], check=True, capture_output=True,
                                text=True, timeout=60).stdout.splitlines()[0]
    build_s = time.perf_counter() - t0
    # K2's integer instructions per 64-byte block, for its operations bound
    k2_body, k2_after = sass_counts(_sass(kernels.library_path("chacha20")), "chacha20_kernel",
                                    K2_SASS_FAMILIES)
    K2_PER_BLOCK.update(k2_body, int_pipe=sum(k2_body[f] for f in INT_PIPE_FAMILIES),
                        issue=sum(k2_body.values()))
    _line("build", seconds=build_s, kernels=sorted(kernels.KERNELS),
          native={"seconds": native_build["seconds"], "library": native.library_path().name,
                  "cc": native.compiler(), "cc_version": cc_version},
          k2_sass_per_block=K2_PER_BLOCK, k2_sass_after_body=k2_after)
    if not K2_PER_BLOCK["int_pipe"]:
        raise AssertionError("chacha20's SASS holds no INT-pipe instruction: the count is broken")
    for name, report in reports.items():
        for text in report.strip().splitlines():
            print(f"ptxas[{name}]: {text}", flush=True)
    k1_library = kernels.library_path("limb_share_sum")
    imma = _sass_count(k1_library, "IMMA")
    _line("sass", kernel="limb_share_sum", library=os.path.basename(k1_library), imma=imma,
          dp4a=_sass_count(k1_library, "IDP"))
    if not imma:
        raise AssertionError("limb_share_sum's SASS holds no IMMA: the tensor cores are unused")

    # -- 3. kernel vs plain on the card --------------------------------------
    p, w2, w3 = find_packed_parameters(K_SECRETS, THRESHOLD, CLERKS, min_modulus_bits=30, seed=0)
    scheme = PackedShamirSharing(K_SECRETS, CLERKS, THRESHOLD, p, w2, w3)
    plan = make_plan(scheme, DIM)  # default device: CUDA
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def canonical(shape, modulus):
        return torch.randint(0, modulus, shape, generator=gen, dtype=torch.int32, device=dev)

    p26, a26, b26 = find_packed_parameters(2, 1, 26, min_modulus_bits=30, seed=0)
    p15, a15, b15 = find_packed_parameters(10, 5, 26, min_modulus_bits=30, seed=0)
    cases = [  # (label, plan, C, dim)
        ("full", plan, CHUNK, DIM),
        ("ragged C=37 dim=23", make_plan(scheme, 23), 37, 23),
        ("ragged C=1001 dim=1003", make_plan(scheme, 1003), 1001, 1003),
        ("n=26 (4 clerk tiles)", make_plan(PackedShamirSharing(2, 26, 1, p26, a26, b26), 601), 77, 601),
        ("p=433 (L=2)", make_plan(PackedShamirSharing(3, 8, 4, 433, 354, 150), 150), 100, 150),
        ("K=15 n=26 (Kp=16, 4 clerk tiles)",
         make_plan(PackedShamirSharing(10, 26, 5, p15, a15, b15), 1003), 1700, 1003),
    ]
    max_err = 0
    full_inputs = None
    for label, case_plan, C, dim in cases:
        k, t, stacks = case_plan.input_size, case_plan.rand_size, case_plan.limb_stacks
        values = canonical((C, case_plan.n_batches, k + t), case_plan.modulus)
        secrets = canonical((C, dim), case_plan.modulus)
        rand = canonical((C, case_plan.n_batches, t), case_plan.modulus)
        for entry, got, want, shape in (
            ("values", participant_limb_sums_cuda(values, stacks),
             participant_limb_sums_torch(values, stacks), [list(values.shape)]),
            ("secrets+randomness", share_limb_sums_cuda(secrets, rand, stacks, k),
             share_limb_sums_torch(secrets, rand, stacks, k), [list(secrets.shape), list(rand.shape)]),
        ):
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            max_err = max(max_err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
            _line("parity", kernel="limb_share_sum", entry=entry, case=label, shape=shape,
                  out=list(got.shape), identical=same)
            if not same:
                raise AssertionError(f"limb_share_sum differs from its plain version ({entry}, {label})")
        if label == "full":
            full_inputs = (secrets, rand)
        del values, secrets, rand

    rng = np.random.default_rng(args.seed)

    def draw_seeds(P, w=SEED_WORDS):
        return rng.integers(0, 1 << 32, size=(P, w), dtype=np.uint64).astype(np.uint32)

    chunk_blocks = chacha_cuda.window_blocks(DIM, p)  # per seed, 1,251 here
    chunk_keys = seed_tensor(draw_seeds(CHUNK), dev)
    k2_cases = [  # (label, keys, first counter, blocks)
        (f"full chunk {CHUNK} seeds x {chunk_blocks} blocks", chunk_keys, 0, chunk_blocks),
        ("1 seed x 1 block", seed_tensor(draw_seeds(1), dev), 0, 1),
        ("7 seeds x 700 blocks, 2-word keys", seed_tensor(draw_seeds(7, 2), dev), 0, 700),
        ("first counter 2^32-3 x 7 blocks", seed_tensor(draw_seeds(3), dev), (1 << 32) - 3, 7),
        ("zero key, counter 0 (known vector)", torch.zeros(8, dtype=torch.int64, device=dev), 0, 1),
    ]
    k2_err = 0
    for label, keys, first, n_blocks in k2_cases:
        got = chacha_blocks_cuda(keys, first, n_blocks)
        want = chacha_blocks_torch(keys, first, n_blocks)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        k2_err = max(k2_err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        if keys.ndim == 1:  # djb's zero-key block 0
            stream = got[0].cpu().numpy().view(np.uint32).astype("<u4").tobytes()
            same = same and stream[:32].hex() == KNOWN_BLOCK0
        _line("parity", kernel="chacha20", case=label, shape=list(got.shape), identical=same)
        if not same:
            raise AssertionError(f"chacha20 differs from its plain version ({label})")
    host_seeds = draw_seeds(4)
    got = expand_seeds_batch(seed_tensor(host_seeds, dev), 4096, (1 << 61) - 1).cpu().numpy()
    same = bool(np.array_equal(got, np.stack([expand_seed(s, 4096, (1 << 61) - 1) for s in host_seeds])))
    _line("parity", kernel="chacha20", case="expand_seeds_batch 4 seeds x 4096 dims, m=2^61-1, "
          "against the host expand_seed", shape=list(got.shape), identical=same)
    if not same:
        raise AssertionError("expand_seeds_batch differs from the host expand_seed")

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
    limb_cuda.launches = chacha_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        acc, plain = one_chunk(acc, plain)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = limb_cuda.launches
    if chacha_cuda.launches:
        raise AssertionError("the unmasked main path launched chacha20")
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

    # -- 5. masked path: the same round with ChaCha masking -------------------
    mask_seeds = draw_seeds(PARTICIPANTS)
    mask_seeds_dev = seed_tensor(mask_seeds, dev)
    acc = torch.zeros_like(acc)
    plain = torch.zeros_like(plain)
    min_count = torch.full((), (1 << 31) - 1, dtype=torch.int32, device=dev)
    marks = []
    torch.cuda.synchronize()
    limb_cuda.launches = chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
    t0 = time.perf_counter()
    for c in range(n_chunks):
        secrets = uniform_bits_device_narrow(gen, (CHUNK, DIM), nbits)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        masks, counts = expand_seeds_counts(mask_seeds_dev[c * CHUNK : (c + 1) * CHUNK], DIM, p)
        masked = torch.fmod(secrets + masks, p).to(torch.int32)
        min_count = torch.minimum(min_count, counts.min())
        events[1].record()
        acc = torch.fmod(acc + share_combine_limb_cuda(masked, gen, plan, draw=draw), p)
        events[2].record()
        plain = torch.fmod(plain + torch.sum(secrets, dim=0, dtype=torch.int64), p)
        marks.append(events)
    torch.cuda.synchronize()
    participants_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clerk_sums = torch.as_tensor(limb_recombine_host(acc, p).T.copy(), device=dev)
    masked_total = reconstruct(clerk_sums, survivors, scheme, DIM)
    combined = combine_masks_device(mask_seeds, DIM, p, device=dev)
    out = positive(torch.fmod(masked_total - combined, p), p)
    torch.cuda.synchronize()
    unmask_s = time.perf_counter() - t0
    masked_launches = {"limb_share_sum": limb_cuda.launches, "chacha20": chacha_cuda.launches}
    exact = bool(torch.equal(out, positive(plain, p)))
    fold_chunk = chacha_cuda.default_chunk(DIM)
    want_k2 = n_chunks + -(-PARTICIPANTS // fold_chunk)
    _line("masked path", participants=PARTICIPANTS, dim=DIM, chunk=CHUNK, seed_words=SEED_WORDS,
          modulus=p, survivors=survivors, blocks_per_seed=chunk_blocks, reveal_chunk=fold_chunk,
          masking_s=sum(a.elapsed_time(b) for a, b, _ in marks) / 1e3,
          sharing_s=sum(b.elapsed_time(c) for _, b, c in marks) / 1e3,
          participants_wall_s=participants_s, reveal_s=unmask_s, launches=masked_launches,
          min_accepted=int(min_count), slack_recoveries=chacha_cuda.slack_recoveries, exact=exact)
    if int(min_count) < DIM:
        raise AssertionError("a participant's seed window held fewer than dim draws")
    if not exact:
        raise AssertionError("the ChaCha-masked round's unmasked reveal differs from the plain sum")
    if masked_launches != {"limb_share_sum": n_chunks, "chacha20": want_k2}:
        raise AssertionError(f"masked path launches {masked_launches}, expected "
                             f"{n_chunks} limb_share_sum and {want_k2} chacha20")

    # -- 6. reveal at the size K2 was written for ------------------------------
    reveal_seeds = draw_seeds(REVEAL_SEEDS)
    torch.cuda.synchronize()
    chacha_cuda.launches = chacha_cuda.slack_recoveries = 0
    t0 = time.perf_counter()
    total = combine_masks_device(reveal_seeds, REVEAL_DIM, p, device=dev)
    torch.cuda.synchronize()
    reveal_s = time.perf_counter() - t0
    reveal_launches = chacha_cuda.launches
    reveal_chunk = chacha_cuda.default_chunk(REVEAL_DIM)
    want_folds = -(-REVEAL_SEEDS // reveal_chunk)
    in_range = total.shape == (REVEAL_DIM,) and bool((total >= 0).all() and (total < p).all())
    sample = np.sort(rng.choice(REVEAL_SEEDS, size=8, replace=False))
    got_rows = expand_seeds_batch(seed_tensor(reveal_seeds[sample], dev), REVEAL_DIM, p).cpu().numpy()
    rows_match = bool(np.array_equal(
        got_rows, np.stack([expand_seed(s, REVEAL_DIM, p) for s in reveal_seeds[sample]])))
    _line("reveal", seeds=REVEAL_SEEDS, dim=REVEAL_DIM, modulus=p, chunk=reveal_chunk,
          folds=want_folds, blocks=REVEAL_SEEDS * chacha_cuda.window_blocks(REVEAL_DIM, p),
          launches=reveal_launches, wall_s=reveal_s, slack_recoveries=chacha_cuda.slack_recoveries,
          sampled_rows=sample.tolist(), rows_match=rows_match, in_range=in_range)
    if not (rows_match and in_range):
        raise AssertionError("reveal: sampled rows differ from expand_seed or the sum is out of range")
    if reveal_launches != want_folds + chacha_cuda.slack_recoveries:
        raise AssertionError(f"reveal launched chacha20 {reveal_launches} times, expected "
                             f"{want_folds} + {chacha_cuda.slack_recoveries} recoveries")
    # the kernel at both shapes the reveal launched it at, on those folds'
    # seeds, and their partials against the host expansion folded in numpy
    reveal_blocks = chacha_cuda.window_blocks(REVEAL_DIM, p)
    tail = REVEAL_SEEDS - (want_folds - 1) * reveal_chunk
    for label, rows in (("first", slice(0, reveal_chunk)),
                        ("last", slice(REVEAL_SEEDS - tail, REVEAL_SEEDS))):
        batch = seed_tensor(reveal_seeds[rows], dev)
        got = chacha_blocks_cuda(batch, 0, reveal_blocks)
        want = chacha_blocks_torch(batch, 0, reveal_blocks)
        same = bool(torch.equal(got, want))
        k2_err = max(k2_err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        _line("parity", kernel="chacha20", case=f"reveal {label} fold {batch.shape[0]} seeds x "
              f"{reveal_blocks} blocks", shape=list(got.shape), identical=same)
        del got, want
        if not same:
            raise AssertionError(f"chacha20 differs from its plain version (reveal {label} fold)")
        part, _ = chacha_cuda._fold_chunk(batch, REVEAL_DIM, p)
        host = np.zeros(REVEAL_DIM, dtype=np.int64)
        for seed in reveal_seeds[rows]:
            host = (host + expand_seed(seed, REVEAL_DIM, p)) % p
        fold_match = bool(np.array_equal(part.cpu().numpy(), host))
        _line("reveal fold", fold=label, seeds=batch.shape[0], matches_host=fold_match)
        if not fold_match:
            raise AssertionError(f"the reveal's {label} fold differs from the host expansion")
        if label == "first":
            fold_batch = batch
    _profile_chunks(lambda: chacha_cuda._fold_chunk(fold_batch, REVEAL_DIM, p), 3,
                    label="reveal", kernel="chacha20")

    # -- 7. numbers ------------------------------------------------------------
    seen = _profile_chunks(lambda: one_chunk(acc, plain), PROFILE_CHUNKS)
    cats = [name for name in seen if "CatArray" in name]
    if cats:
        raise AssertionError(f"the main path still concatenates K1's input: {cats}")
    # K1 at the main path's chunk shape through the entry the path uses: its
    # own device time per launch by the profiler, the wrapper's (checks,
    # ctypes call, output zeroing) by CUDA events, against ``_k1_bound``
    stacks = plan.limb_stacks
    k1_secrets, k1_rand = full_inputs

    def k1_run():
        return share_limb_sums_cuda(k1_secrets, k1_rand, stacks, K_SECRETS)

    def k1_plain():
        return share_limb_sums_torch(k1_secrets, k1_rand, stacks, K_SECRETS)

    plain_a = _time_ms(k1_plain, iters=2)
    kernel_a = _kernel_ms(k1_run, 20, "limb_share_sum")
    kernel_b = _kernel_ms(k1_run, 20, "limb_share_sum")
    plain_b = _time_ms(k1_plain, iters=2)
    wrapper = _time_ms(k1_run, iters=20, warmup=3)
    moved, ops, bytes_ms, ops_ms = _k1_bound(k1_secrets, k1_rand, stacks)
    kernel_ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
    _line("numbers", kernel="limb_share_sum", shape=[list(k1_secrets.shape), list(k1_rand.shape)],
          kernel_ms=[kernel_a, kernel_b], wrapper_ms=wrapper, plain_ms=[plain_a, plain_b],
          bytes=moved, int8_ops=ops, bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
          ops_ms=ops_ms, imma=imma, library_ms=None, launches=launches,
          masked_launches=masked_launches["limb_share_sum"], stream_wall_s=stream_s, card=card)

    # K2 at the masked path's chunk shape: its own device time per launch by
    # the profiler, and the wrapper's (key packing included) by CUDA events,
    # against ``_k2_bound``
    def k2_run():
        return chacha_blocks_cuda(chunk_keys, 0, chunk_blocks)

    def k2_plain():
        return chacha_blocks_torch(chunk_keys, 0, chunk_blocks)

    plain2_a = _time_ms(k2_plain, iters=2)
    kernel2_a = _kernel_ms(k2_run, 20, "chacha20")
    kernel2_b = _kernel_ms(k2_run, 20, "chacha20")
    plain2_b = _time_ms(k2_plain, iters=2)
    wrapper2 = _time_ms(k2_run, iters=20, warmup=3)
    clock_mhz = float(_query_gpu("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clocks_per_ms = sms * clock_mhz * 1e3
    moved2, ops2, int_ops2, bytes2_ms, ops2_ms = _k2_bound(CHUNK, chunk_blocks, sm_clocks_per_ms)
    kernel2_ms, plain2_ms = min(kernel2_a, kernel2_b), min(plain2_a, plain2_b)
    _line("numbers", kernel="chacha20", shape=[CHUNK, chunk_blocks, 16],
          kernel_ms=[kernel2_a, kernel2_b], event_ms=_k2_event_ms(chunk_keys, chunk_blocks),
          wrapper_ms=wrapper2, plain_ms=[plain2_a, plain2_b],
          bytes=moved2, int32_ops=ops2, int_pipe_ops=int_ops2, sms=sms, max_sm_clock_mhz=clock_mhz,
          bound_ms=max(bytes2_ms, ops2_ms), bytes_ms=bytes2_ms, ops_ms=ops2_ms, library_ms=None,
          launches=masked_launches["chacha20"], reveal_launches=reveal_launches, card=card)

    # -- 8. sum-first at full width; 9. the fabrics under NCCL ------------------
    sumfirst_phase(card, dev, args.seed)
    fabric_launches, fabric_k2_err = fabric_phase(card, dev, args.seed)
    # -- 10. a ChaCha-masked FedAvg round at the FedAvg paper's CNN width ----
    fedavg_k1, fedavg_k2, fedavg_k1_err, fedavg_k2_err = fedavg_phase(
        card, dev, args.seed, scheme, sm_clocks_per_ms)
    # -- 11. the bench entry, once per engine route ----------------------------
    bench_k1 = bench_phase(card)
    # -- 12. the baseline ladder's device rows and the fabric demo ---------------
    ladder_k1, ladder_k1_err = drivers_phase(card, dev, args.seed)
    # -- 13. weighted and DP FedAvg rounds with server optimizers ----------------
    model_k1, model_k2, model_k1_err, model_k2_err = model_rounds_phase(
        card, dev, args.seed, sm_clocks_per_ms)
    # -- 21. the native batch layer against its plain versions, which 14-19 ride ---
    native_phase(card, dev, args.seed)
    # -- 14. the sealed aggregation round through the protocol plane ---------------
    sealed_k2, sealed_k2_err = sealed_round_phase(card, dev, args.seed, sm_clocks_per_ms)
    # -- 15. DP federated training on the sealed round, checkpoints and a restore -
    trainer_k2, trainer_k2_err = trainer_phase(card, dev, args.seed, sm_clocks_per_ms)
    # -- 16. the analytics examples; every cohort below the device threshold -----
    analytics_phase(card, dev, args.seed)
    # -- 17. the REST deployment: phase 14's round over loopback HTTP, the CLIs ---
    rest_k2, rest_k2_err = rest_round_phase(card, dev, args.seed, sm_clocks_per_ms)
    # -- 18. the scale-out plane: a tiered round over two sharded frontends --------
    tier_k2, tier_k2_err = tier_round_phase(card, dev, args.seed, sm_clocks_per_ms)
    # -- 19. arrival-driven ingest, paged reads; 20. the Packed Paillier round -----
    ingest_k2, ingest_k2_err = ingest_paillier_phases(card, dev, args.seed, sm_clocks_per_ms)
    # -- 22. phase 14's round once more, traced, logged and read by the flight recorder
    flight_k2, flight_k2_err = flight_phase(card, dev, args.seed, sm_clocks_per_ms)
    # -- 23. the bench's protocol-plane riders, then its K1 route, as a user runs it
    torch.cuda.empty_cache()  # the subprocess shares the card with this one
    riders_k1 = riders_phase(card)

    print(json.dumps({"kernels": [{
        "name": "limb_share_sum",
        "route": "cuda",
        "source": "sda_tpu_torch/csrc/limb_share_sum.cu",
        "replaces": "sda_tpu/parallel/limb_pallas.py:31",
        "launches": (launches + fabric_launches["limb_share_sum"] + fedavg_k1 + bench_k1 + ladder_k1
                     + model_k1 + riders_k1),
        "max_abs_err": max(max_err, fedavg_k1_err, ladder_k1_err, model_k1_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # no single PyTorch call computes the limb split + dots + participant sum
        "library_ms": None,
    }, {
        "name": "chacha20",
        "route": "cuda",
        "source": "sda_tpu_torch/csrc/chacha20.cu",
        "replaces": "sda_tpu/ops/chacha_pallas.py:47",
        "launches": (masked_launches["chacha20"] + fabric_launches["chacha20"] + fedavg_k2 + model_k2
                     + sealed_k2 + trainer_k2 + rest_k2 + tier_k2 + ingest_k2 + flight_k2),
        "max_abs_err": max(k2_err, fabric_k2_err, fedavg_k2_err, model_k2_err, sealed_k2_err,
                           trainer_k2_err, rest_k2_err, tier_k2_err, ingest_k2_err, flight_k2_err),
        "ms": kernel2_ms,
        "plain_ms": plain2_ms,
        "bound_ms": max(bytes2_ms, ops2_ms),
        "bound_by": "bytes" if bytes2_ms >= ops2_ms else "operations",
        # no PyTorch call computes ChaCha20
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
