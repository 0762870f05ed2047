"""The device-plane benchmark on one GPU (counterpart of ``bench.py``'s
device plane): packed-Shamir secure-sum throughput over a synthetic
participant stream drawn on the device, verified against an independent
plaintext sum.

    python -m sda_tpu_torch.bench                      # north star: 1,000,000 x 100,000, 61-bit p
    python -m sda_tpu_torch.bench --quick              # 100,000 x 10,000, 31-bit p
    python -m sda_tpu_torch.bench --engine participant --kernel
    python -m sda_tpu_torch.bench --roofline
    python -m sda_tpu_torch.bench --device cpu --participants 4000 --dim 512 --chunk 1000 --no-parity

Engines (``--engine``), as in ``bench.py``:

- ``sumfirst`` (default): ``share(sum v) = sum share(v)``, so the hot loop is
  one exact limb-space reduction over the stream (``parallel/sumfirst.py``)
  and the share matmul runs once, on the host, on the tiny participant sum;
- ``participant``: every participant's shares, then the clerk sums, on one
  of three routes: the int64 share products (``--no-limbs``), the torch
  int8-limb dots (``engine.share_combine_limb``; 61-bit with ``--wide``), or
  the fused limb kernel K1 (``--kernel``, ``limb_cuda``).

The stream runs as equal segments of chunks; each segment ends in a device
synchronise before the clock is read. Segment 1 absorbs the kernels' first
build and warm-up, and the rate comes from segments 2 and later. Exactly
one JSON metric line goes to stdout, last; progress goes to stderr. A
wrong result (a parity item, the check sums, the reveal) prints an
error-tagged line and exits 1; any other failure exits 2.

The entry runs on CUDA unless ``--device cpu`` is given, and raises without
a GPU. The bench's data is drawn from a ``torch.Generator`` seeded 42.

Before the device run, and before its ``--deadline`` is armed, the
protocol-plane riders (``sda_tpu_torch/riders``, bench.py's riders) measure
the host planes: the crypto plane and the REST ingest always, then nine
riders unless ``SDA_BENCH_RIDERS=0``. Each prints its own metric lines, and
their results ride under ``crypto`` on the final line, success or error. A
failing rider never stops the device run: its entry becomes ``{"error":
"<Type>: <message>"}`` and its traceback goes to stderr. Their artifacts go
to ``bench-artifacts-torch/`` (``--artifacts DIR`` elsewhere,
``SDA_BENCH_ARTIFACTS=0`` nowhere).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

from . import riders, telemetry
from .device import resolve_device
from .ops import chacha_cuda, find_packed_parameters
from .ops.chacha import chacha_blocks_torch, expand_seed
from .ops.modular import mod_sum_wide, positive
from .ops.rng import (
    uniform_bits_device,
    uniform_bits_device_narrow,
    uniform_bits_device_pair,
    uniform_mod_device,
)
from .parallel import limb_cuda
from .parallel.engine import (
    clerk_combine,
    make_plan,
    reconstruct,
    share_combine_limb,
    share_participants,
)
from .parallel.limbmatmul import limb_count, limb_recombine_host
from .parallel.sumfirst import (
    MAX_NARROW_CHUNK,
    clerk_sums_from_limb_acc,
    exact_value_sums,
    limb_count_sum,
    reconstruct_from_clerk_sums,
    value_limb_sums_chunk,
    value_limb_sums_chunk_pair,
)
from .protocol import PackedShamirSharing
from .riders import (  # noqa: F401 - bench.py's names: bench.measure_wire_transport
    RUN_TRACE_ID,
    measure_batched_ingest,
    measure_clerking_pipeline,
    measure_committee_scaling,
    measure_crypto_plane,
    measure_replication_overhead,
    measure_rest_ingest,
    measure_reveal_pipeline,
    measure_shard_scaling,
    measure_sketch_accuracy,
    measure_tier_fanout,
    measure_wire_transport,
)
from .utils.metrics import torch_trace

METRIC_NAME = "packed_shamir_secure_sum_throughput_single_chip"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8 tensor-core ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

#: the participant engine's share routes (``--no-limbs``, default, ``--kernel``)
ROUTES = ("int64", "limbs", "kernel")

_MASK32 = (1 << 32) - 1
_MASK64 = (1 << 64) - 1
_IOTA_MUL = 2654435761  # Knuth's multiplicative hash constant, bench.py's fill


class Mismatch(Exception):
    """A result disagreed with its independent check (exit 1)."""


def _log(text: str) -> None:
    print(f"[bench] {text}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the synthetic stream ---------------------------------------------------


def _iota_mix(shape, device) -> torch.Tensor:
    """``(r * 2654435761 + c) mod 2^32`` as int32 bit patterns, ``r`` the index
    along axis 0 and ``c`` along the last axis: bench.py's uint32 lanes.
    Torch has no general uint32 arithmetic, so the row term is computed
    exactly in int64 on the ``(shape[0],)`` vector and narrowed to its bit
    pattern, and the one full-size op, the add, runs in int32 lanes, which
    wrap mod 2^32. The output is written once, in full, as a draw is."""
    r = (torch.arange(shape[0], dtype=torch.int64, device=device) * _IOTA_MUL) & _MASK32
    r = (r - ((r >> 31) << 32)).to(torch.int32).reshape((-1,) + (1,) * (len(shape) - 1))
    c = torch.arange(shape[-1], dtype=torch.int32, device=device)
    return (r + c).expand(tuple(shape)).contiguous()


def iota_fill_bits(shape, bits: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The ``--roofline`` fill (bench.py:3408-3421): a row- and lane-varying
    mix in place of the draws, masked to ``bits`` bits. An int32 output is
    capped at 31 bits so it stays nonnegative; int64 keeps up to 32."""
    mix = _iota_mix(shape, device)
    if dtype == torch.int32:
        return mix & ((1 << min(bits, 31)) - 1)
    return mix.to(dtype) & ((1 << min(bits, 32)) - 1)


def iota_fill_pair(shape, nbits: int, device):
    """The pair twin of ``iota_fill_bits`` (bench.py:3515-3520): ``lo`` is the
    full 32-bit mix and ``hi = lo & (2^(nbits-32) - 1)``, both as int32 bit
    patterns like ``rng.uniform_bits_device_pair``."""
    lo = _iota_mix(shape, device)
    return lo & ((1 << max(1, nbits - 32)) - 1), lo


def _bits_draw(narrow: bool, fill: bool, device):
    """``(generator, shape, bits) -> values`` for one body variant: the real
    masked-bit draws (int32 lanes when narrow), or the fill in the same
    dtype (``_filled``). One wiring for both engines, as bench.py's
    ``gen_selectors``."""
    if fill:
        dtype = torch.int32 if narrow else torch.int64
        return _filled(lambda generator, shape, bits: iota_fill_bits(shape, bits, dtype, device))
    return uniform_bits_device_narrow if narrow else uniform_bits_device


def _filled(make):
    """``make(generator, shape, *args)`` made once per shape and arguments for
    one stream, then handed out again. The fill depends on the indices only,
    so every chunk sees the same values, as in bench.py; where XLA fuses the
    iota into its consumer, eager torch would launch a handful of small
    kernels per draw, so reusing the tensor is what keeps the fill's own
    cost out of the decomposition: the reduction still reads a full-size
    row- and lane-varying tensor each chunk. The tensors are never written
    to by their consumers."""
    made = {}

    def draw(generator, shape, *args):
        key = (tuple(shape), *args)
        if key not in made:
            made[key] = make(generator, shape, *args)
        return made[key]

    return draw


def check_stride(dim: int, check: str) -> int:
    """Column stride of the independent check: ``--check probe`` covers
    ``range(0, dim, max(1, dim // 1024))`` (bench.py:3488-3491), full every
    column."""
    return max(1, dim // 1024) if check == "probe" else 1


def checked_columns(dim: int, check: str) -> int:
    return 0 if check == "off" else len(range(0, dim, check_stride(dim, check)))


def sumfirst_stream(plan, dim: int, chunk: int, generator, check: str = "full", fill: bool = False):
    """bench.py's sum-first scan body (``make_body``, bench.py:3494-3558) on
    ``generator``'s device: returns ``(step, acc, plain)``, where
    ``step(acc, plain) -> (acc, plain)`` draws one chunk of ``chunk x dim``
    secrets as masked bits (``nbits = p.bit_length() - 1``), adds their
    exact limb sums to ``acc`` and the independent int64 column sums
    (wrapping mod 2^64) of the checked columns to ``plain``. A field that
    fits 31 bits draws int32 values (the narrow path), a wider one ``(hi,
    lo)`` int32 word pairs (the pair path; a ``lo`` word whose int32 pattern
    is negative adds 2^32); past ``MAX_NARROW_CHUNK`` rows, int64 values.
    Per chunk the draws come in this order: the secrets, then the share
    randomness. ``check`` is ``full``, ``probe`` or ``off`` (``plain`` is
    then a 1-element carry); ``fill`` replaces the draws with
    ``iota_fill_bits``."""
    p = plan.modulus
    nbits = p.bit_length() - 1
    dev = generator.device
    stride = check_stride(dim, check)
    acc = torch.zeros((limb_count_sum(p), plan.n_batches, plan.input_size + plan.rand_size),
                      dtype=torch.int64, device=dev)
    plain = torch.zeros(max(1, checked_columns(dim, check)), dtype=torch.int64, device=dev)

    if nbits > 31 and chunk <= MAX_NARROW_CHUNK:
        def pair_draw(gen, shape):
            return uniform_bits_device_pair(gen, shape, nbits)

        if fill:
            pair_draw = _filled(lambda gen, shape: iota_fill_pair(shape, nbits, dev))

        def pair_step(acc, plain):
            hi, lo = pair_draw(generator, (chunk, dim))
            acc = acc + value_limb_sums_chunk_pair(hi, lo, generator, plan, pair_draw)
            if check == "off":
                return acc, plain
            # the check: direct int64 half-sums, not the 16-bit split under test
            chi, clo = hi[:, ::stride], lo[:, ::stride]
            lo_sum = torch.sum(clo, dim=0, dtype=torch.int64) + ((clo < 0).sum(dim=0) << 32)
            return acc, plain + lo_sum + (torch.sum(chi, dim=0, dtype=torch.int64) << 32)

        return pair_step, acc, plain

    bits_draw = _bits_draw(nbits <= 31 and chunk <= MAX_NARROW_CHUNK, fill, dev)

    def mask_draw(gen, shape, modulus):
        return bits_draw(gen, shape, modulus.bit_length() - 1)

    def step(acc, plain):
        secrets = bits_draw(generator, (chunk, dim), nbits)
        acc = acc + value_limb_sums_chunk(secrets, generator, plan, draw=mask_draw)
        if check == "off":
            return acc, plain
        return acc, plain + torch.sum(secrets[:, ::stride], dim=0, dtype=torch.int64)

    return step, acc, plain


def sumfirst_finalize(acc, plain, plan, scheme, dim: int, check: str = "full"):
    """bench.py's sum-first finalize (bench.py:3562-3580): the exact limb sums
    against the independent wrapping sums over the checked columns (none
    with ``check="off"``), then the host epilogue and a reconstruction from
    clerks 1..t+k held against the verification handle. Returns the
    ``(dim,)`` aggregate, or None on any mismatch."""
    k = plan.input_size
    exact = exact_value_sums(acc)
    flat = exact[:, :k].reshape(-1)[:dim]
    if check != "off":
        covered = flat[:: check_stride(dim, check)]
        wrap = np.array([int(v) & _MASK64 for v in covered], dtype=np.uint64)
        if not np.array_equal(wrap, _host(plain).view(np.uint64)):
            return None
    clerk_sums, vsums = clerk_sums_from_limb_acc(acc, plan, exact=exact)
    indices = list(range(1, 1 + scheme.reconstruction_threshold))
    got = positive(np.asarray(reconstruct_from_clerk_sums(clerk_sums, indices, scheme, dim)), plan.modulus)
    want = vsums[:, :k].reshape(-1)[:dim]
    return got if np.array_equal(got, want) else None


def participant_stream(plan, dim: int, chunk: int, generator, route: str, check: str = "full",
                       fill: bool = False):
    """bench.py's participant scan body (bench.py:3616-3656) on
    ``generator``'s device: returns ``(step, acc, plain)``. Each step draws
    ``chunk x dim`` secrets (masked bits; int32 on the narrow limb routes),
    shares and clerk-combines them on ``route`` (``ROUTES``), and adds the
    chunk's clerk sums to ``acc`` mod p (``(n, nb)`` on the int64 route,
    ``(W, nb, n)`` limb partials otherwise); with ``check="full"`` it adds
    the plain sum mod p to ``plain`` (bench.py's ``plain_step``: the halving
    sum at p > 2^31). Draw order per chunk: secrets, then randomness."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    p = plan.modulus
    nbits = p.bit_length() - 1
    dev = generator.device
    use_limbs = route != "int64"
    bits_draw = _bits_draw(use_limbs and p <= (1 << 31), fill, dev)
    shape = (limb_count(p), plan.n_batches, plan.share_count) if use_limbs else (plan.share_count, plan.n_batches)
    acc = torch.zeros(shape, dtype=torch.int64, device=dev)
    plain = torch.zeros(dim if check == "full" else 1, dtype=torch.int64, device=dev)

    def mask_draw(gen, shape, modulus):
        return bits_draw(gen, shape, modulus.bit_length() - 1)

    def step(acc, plain):
        secrets = bits_draw(generator, (chunk, dim), nbits)
        if route == "int64":
            shares = share_participants(secrets, generator, plan, False, draw=mask_draw)
            chunk_acc = torch.fmod(clerk_combine(shares), p)
        elif route == "limbs":
            chunk_acc = share_combine_limb(secrets, generator, plan, draw=mask_draw)
        else:
            chunk_acc = limb_cuda.share_combine_limb_cuda(secrets, generator, plan, draw=mask_draw)
        acc = torch.fmod(acc + chunk_acc, p)
        if check == "off":
            return acc, plain
        if p > (1 << 31):
            return acc, torch.fmod(plain + mod_sum_wide(secrets, p, axis=0), p)
        return acc, torch.fmod(plain + torch.fmod(torch.sum(secrets, dim=0, dtype=torch.int64), p), p)

    return step, acc, plain


def participant_finalize(acc, plain, plan, scheme, dim: int):
    """bench.py's participant finalize (bench.py:3659-3665): limb partials
    recombined exactly on the host, a reconstruction from clerks 1..t+k on
    the plan's device, held against the plain sum. Returns the ``(dim,)``
    aggregate, or None on a mismatch."""
    p = plan.modulus
    acc = _host(acc)
    if acc.ndim == 3:
        acc = limb_recombine_host(acc, p).T  # (n, B) canonical, exact
    indices = list(range(1, 1 + scheme.reconstruction_threshold))
    out = reconstruct(torch.as_tensor(np.ascontiguousarray(acc), device=plan.device), indices, scheme, dim)
    got = positive(_host(out), p)
    return got if np.array_equal(got, positive(_host(plain), p)) else None


def traffic_model(engine: str, route: str | None, plan, chunk: int) -> dict:
    """bench.py's roofline inputs (bench.py:3468-3475, 3598-3607): bytes per
    drawn value element as the stream stores it, int8 MACs per secret
    element (the limb share matmul; none for sum-first), and limb-operand
    bytes per secret element."""
    p, k, t, n = plan.modulus, plan.input_size, plan.rand_size, plan.share_count
    if engine == "sumfirst":
        narrow = p.bit_length() - 1 <= 31 and chunk <= MAX_NARROW_CHUNK
        return {"elem_bytes": 4.0 if narrow else 8.0, "macs_per_elem": 0.0, "extra_bytes_per_elem": 0.0}
    L = limb_count(p) if route != "int64" else 0
    return {
        "elem_bytes": 4.0 if route != "int64" and p <= (1 << 31) else 8.0,
        "macs_per_elem": (k + t) * n * L * L / k,
        "extra_bytes_per_elem": 2.0 * L * (k + t) / k,
    }


# -- on-card parity ----------------------------------------------------------


def device_parity(dev: torch.device) -> dict:
    """The counterpart of bench.py's ``measure_tpu_parity`` (bench.py:
    3014-3118), at its shapes and seeds: ``chacha`` (K2's batched expansion
    of 4 seeds x 4,096 dims at m = 2^61 - 1 against the host
    ``expand_seed``, and K2's keystream against its plain torch version on
    the same device), ``limb`` (K1 against the torch limb path on the same
    draws, 64 x 40, a 31-bit p) and ``wide61`` (the 61-bit device aggregate
    against a host sum). Unlike the reference, a failed item raises
    ``Mismatch``."""
    out = {}

    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 2**32, size=(4, 4), dtype=np.uint32)
    m61, dim = (1 << 61) - 1, 4096
    keys = chacha_cuda.seed_tensor(seeds, dev)
    want = np.stack([expand_seed(s, dim, m61) for s in seeds])
    got = chacha_cuda.expand_seeds_batch(keys, dim, m61).cpu().numpy()
    blocks = chacha_cuda.window_blocks(dim, m61)
    same_blocks = torch.equal(chacha_cuda.chacha_blocks_cuda(keys, 0, blocks),
                              chacha_blocks_torch(keys, 0, blocks))
    if not (np.array_equal(got, want) and same_blocks):
        raise Mismatch("parity chacha: the device expansion differs from the host expand_seed "
                       f"(expansion equal: {np.array_equal(got, want)}, keystream equal: {same_blocks})")
    out["chacha"] = "ok"

    p31, w2, w3 = find_packed_parameters(5, 2, 8, min_modulus_bits=30, seed=0)
    plan = make_plan(PackedShamirSharing(5, 8, 2, p31, w2, w3), 40, dev)
    rng = np.random.default_rng(4)
    secrets = torch.as_tensor(rng.integers(0, p31, size=(64, 40)).astype(np.int32), device=dev)
    rand = uniform_mod_device(torch.Generator(device=dev).manual_seed(9),
                              (64, plan.n_batches, plan.rand_size), p31).to(torch.int32)

    def draw(generator, shape, modulus):
        return rand

    a = share_combine_limb(secrets, None, plan, draw=draw)
    b = limb_cuda.share_combine_limb_cuda(secrets, None, plan, draw=draw)
    if not torch.equal(a, b):
        raise Mismatch("parity limb: K1 differs from the torch limb path")
    out["limb"] = "ok"

    p61, w2, w3 = find_packed_parameters(5, 2, 8, min_modulus_bits=60, seed=0)
    scheme = PackedShamirSharing(5, 8, 2, p61, w2, w3)
    dim = 25
    plan = make_plan(scheme, dim, dev)
    rng = np.random.default_rng(5)
    secrets = (p61 - rng.integers(1, 10_000, size=(32, dim))).astype(np.int64)
    acc = share_combine_limb(torch.as_tensor(secrets, device=dev), torch.Generator(device=dev).manual_seed(2), plan)
    clerk_sums = torch.as_tensor(limb_recombine_host(acc, p61).T.copy(), device=dev)
    got = positive(_host(reconstruct(clerk_sums, range(8), scheme, dim)), p61)
    want = np.array([sum(int(v) for v in secrets[:, j]) % p61 for j in range(dim)], dtype=np.int64)
    if not np.array_equal(got, want):
        raise Mismatch("parity wide61: the 61-bit device aggregate differs from the host sum")
    out["wide61"] = "ok"
    return out


# -- the run -------------------------------------------------------------------


def parse_args(argv=None) -> argparse.Namespace:
    """bench.py's flags (bench.py:3181-3344) with its presets and refusals;
    ``--kernel`` for ``--pallas``, and ``--device``."""
    parser = argparse.ArgumentParser(prog="python -m sda_tpu_torch.bench",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--participants", type=int, default=None)
    parser.add_argument("--dim", type=int, default=None)
    parser.add_argument("--chunk", type=int, default=None)
    parser.add_argument("--secret-count", type=int, default=5)
    parser.add_argument("--privacy-threshold", type=int, default=2)
    parser.add_argument("--share-count", type=int, default=8)
    parser.add_argument("--no-limbs", action="store_true",
                        help="participant engine: int64 share products instead of limbs")
    parser.add_argument("--wide", action="store_true",
                        help="61-bit modulus; forces the limb route with an exact host recombine")
    parser.add_argument("--engine", choices=["sumfirst", "participant"], default=None,
                        help="sumfirst (default) or participant (every participant's shares)")
    parser.add_argument("--northstar", action="store_true",
                        help="(the default) 1,000,000 participants x 100,000 dims, 61-bit p")
    parser.add_argument("--kernel", action="store_true",
                        help="participant engine, narrow field, limbs: the fused limb kernel K1")
    parser.add_argument("--quick", action="store_true",
                        help="100,000 x 10,000 in chunks of 2,000, 31-bit p")
    parser.add_argument("--budget", type=float, default=1200.0,
                        help="wall-clock seconds; the stream stops between segments once spent "
                        "(still verified, marked partial)")
    parser.add_argument("--segments", type=int, default=10,
                        help="split the stream into this many equal segments")
    parser.add_argument("--trace-dir", default=None, metavar="DIR",
                        help="torch.profiler trace of the steady segments into DIR")
    parser.add_argument("--deadline", type=float, default=1800.0,
                        help="if nothing is measured by then, print an error line and exit 2; 0 disables")
    parser.add_argument("--no-parity", action="store_true",
                        help="skip the on-device parity items (chacha, limb, wide61)")
    parser.add_argument("--check", choices=("full", "probe", "off"), default="full",
                        help="sumfirst engine: independent check over every column (full), "
                        "~1024 strided columns (probe) or none (off)")
    parser.add_argument("--roofline", action="store_true",
                        help="after the run, time the segment without the check and with the draws "
                        "replaced by a fill, and attribute the steady time to the stages")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA; raises without a GPU)")
    parser.add_argument("--artifacts", default=None, metavar="DIR",
                        help="bank the riders' artifacts in DIR (default: bench-artifacts-torch/)")
    args = parser.parse_args(argv)
    if args.engine is None:
        args.engine = "participant" if args.no_limbs else "sumfirst"
    elif args.no_limbs and args.engine == "sumfirst":
        parser.error("--no-limbs only applies to --engine participant")
    if args.quick and args.northstar:
        parser.error("--quick and --northstar are mutually exclusive")
    if args.check != "full" and args.engine != "sumfirst":
        parser.error("--check probe/off applies to the sumfirst engine")
    quick = args.quick or (args.engine == "participant" and not args.northstar)
    preset = (100_000, 10_000, 2_000) if quick else (1_000_000, 100_000, 500)
    if not quick:
        args.wide = True
    for name, value in zip(("participants", "dim", "chunk"), preset):
        if getattr(args, name) is None:
            setattr(args, name, value)
    if args.kernel and (args.engine != "participant" or args.no_limbs or args.wide):
        parser.error("--kernel applies to the narrow-field limb participant engine")
    return args


def card_and_power_limit(dev: torch.device):
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    ``(None, None)`` off CUDA or without ``nvidia-smi``."""
    if dev.type != "cuda":
        return None, None
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None, None
    name, _, limit = text.rpartition(",")
    return name.strip(), limit.strip()


class FinalLine:
    """Exactly one metric line on stdout, whichever thread gets there first
    (the main thread, the deadline or the decomposition's bail timer).
    ``fields`` (the riders' results) ride on it, success or error."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = False
        self.fields: dict = {}

    def emit(self, line: dict) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
        line.setdefault("trace_id", RUN_TRACE_ID)
        for key, value in self.fields.items():
            line.setdefault(key, value)
        print(json.dumps(line), flush=True)
        return True


def error_line(msg: str) -> dict:
    return {"metric": METRIC_NAME, "value": 0, "unit": "shared_elements_per_second", "error": msg}


def run_riders(device=None) -> dict:
    """The host planes (bench.py:3958-4022) as the metric line's fields:
    under ``crypto`` the crypto plane and the REST ingest merged in, then
    the nine riders under their keys unless ``SDA_BENCH_RIDERS=0``; under
    ``riders`` each plane's seconds and whether CUDA was initialised once it
    was done (they sample the process's RSS, which a CUDA context would
    swell). A rider that raises leaves ``{"error": "<Type>: <message>"}``
    under its key and its traceback on stderr, and the next one runs."""
    telemetry.set_trace_id(RUN_TRACE_ID)
    crypto, seconds, cuda_after = {}, {}, {}

    def attempt(key, label, call):
        t0 = time.perf_counter()
        try:
            with riders.stage(label):
                return call()
        except Exception as exc:  # noqa: BLE001 - a rider never stops the device run
            traceback.print_exc()
            _log(f"{label} failed: {exc}")
            return {key: {"error": f"{type(exc).__name__}: {exc}"}}
        finally:
            seconds[key] = time.perf_counter() - t0
            cuda_after[key] = torch.cuda.is_initialized()

    for key, label, rider in riders.HOST_PLANES:
        crypto.update(attempt(key, label, rider))
    if os.environ.get("SDA_BENCH_RIDERS") == "0":
        _log("protocol-plane riders skipped (SDA_BENCH_RIDERS=0)")
    else:
        for key, label, rider in riders.RIDERS:
            crypto.update(attempt(key, label, lambda: {key: rider(device=device)}))
    return {"crypto": crypto, "riders": {"seconds": seconds, "cuda_initialized_after": cuda_after}}


def arm_deadline(seconds: float, final: FinalLine):
    """bench.py's ``arm_deadline`` (bench.py:3151-3178): if no segment has
    been measured after ``seconds`` (first build or device hang), print an
    error line and exit 2 from the timer thread. ``seconds <= 0``
    disables it; the run cancels it after its first segment."""
    if seconds <= 0:
        return None

    def fire():
        _log(f"DEADLINE: no result after {seconds:.0f}s")
        final.emit(error_line(f"deadline {seconds:.0f}s exceeded before any measurement"))
        os._exit(2)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def run(args: argparse.Namespace, final: FinalLine | None = None, watchdog=None) -> dict:
    """One measured, verified run; returns the metric line. Raises
    ``Mismatch`` on a wrong result. With ``--roofline`` a decomposition that
    hangs past its bail time prints the already-measured line through
    ``final`` and exits the process (bench.py's bail, :3875-3892)."""
    final = final or FinalLine()
    dev = resolve_device(args.device)
    card, power_limit = card_and_power_limit(dev)
    _log(f"device: {dev} ({card}, {power_limit})")
    parity = None
    if not args.no_parity:
        parity = device_parity(dev)
        _log(f"parity: {parity}")

    k, t, n = args.secret_count, args.privacy_threshold, args.share_count
    p, w2, w3 = find_packed_parameters(k, t, n, min_modulus_bits=60 if args.wide else 30, seed=0)
    scheme = PackedShamirSharing(k, n, t, p, w2, w3)
    dim, chunk = args.dim, args.chunk
    plan = make_plan(scheme, dim, dev)
    # make_body(check, fill, generator) -> (step, fresh acc, fresh plain):
    # bench.py's body factory per engine (:3494, :3616) with its carries
    if args.engine == "sumfirst":
        route = None
        n_check = checked_columns(dim, args.check)

        def make_body(check, fill, generator):
            return sumfirst_stream(plan, dim, chunk, generator, check, fill)

        def finalize(acc, plain):
            return sumfirst_finalize(acc, plain, plan, scheme, dim, args.check)
    else:
        route = "kernel" if args.kernel else ("int64" if args.no_limbs and not args.wide else "limbs")
        n_check = dim

        def make_body(check, fill, generator):
            return participant_stream(plan, dim, chunk, generator, route, check, fill)

        def finalize(acc, plain):
            return participant_finalize(acc, plain, plan, scheme, dim)

    n_chunks = args.participants // chunk
    n_segments = max(1, min(args.segments, n_chunks))
    seg_chunks = n_chunks // n_segments
    dropped = n_chunks - seg_chunks * n_segments
    if dropped:
        _log(f"dropping {dropped} remainder chunks ({dropped * chunk} participants) "
             "to keep equal segments")

    def segment(step, acc, plain):
        for _ in range(seg_chunks):
            acc, plain = step(acc, plain)
        _sync(dev)
        return acc, plain

    step, acc, plain = make_body(args.check, False, torch.Generator(device=dev).manual_seed(42))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    limb_cuda.launches = chacha_cuda.launches = 0
    bench_t0 = time.perf_counter()
    acc, plain = segment(step, acc, plain)
    first_s = time.perf_counter() - bench_t0
    _log(f"segment 1/{n_segments} ({seg_chunks} chunks, with the first build): {first_s:.3f}s")
    if watchdog is not None:
        watchdog.cancel()

    seg_times = []  # segments 2 and later
    trace = contextlib.nullcontext()
    if args.trace_dir and n_segments > 1:
        trace = torch_trace(args.trace_dir)
        _log(f"tracing steady segments into {args.trace_dir}")
    with trace:
        for _ in range(1, n_segments):
            if time.perf_counter() - bench_t0 > args.budget:
                _log(f"budget {args.budget:.0f}s spent after {1 + len(seg_times)}/{n_segments} segments")
                break
            t0 = time.perf_counter()
            acc, plain = segment(step, acc, plain)
            seg_times.append(time.perf_counter() - t0)
            _log(f"segment {1 + len(seg_times)}/{n_segments}: {seg_times[-1]:.3f}s")
    wall_s = time.perf_counter() - bench_t0
    done_segments, steady_s = 1 + len(seg_times), sum(seg_times)
    launches = {"limb_share_sum": limb_cuda.launches, "chacha20": chacha_cuda.launches}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    acc_host = _host(acc).copy()
    if os.environ.get("SDA_BENCH_INJECT_FAULT"):
        # bench.py's test hook (:3757-3762): one corrupted accumulator cell
        # must make the verification below fail. As there, it is the first
        # cell; on the participant engine that is clerk 0's sum, which the
        # reveal from clerks 1..t+k does not read
        acc_host[(0,) * acc_host.ndim] += 1
        _log("FAULT INJECTED into the accumulator")
    t0 = time.perf_counter()
    got = finalize(acc_host, plain)
    finalize_s = time.perf_counter() - t0
    if got is None:
        raise Mismatch("verification failed: reconstructed aggregate does not match the "
                       "independent plaintext sum")

    participants_done = done_segments * seg_chunks * chunk
    steady_elems = (done_segments - 1) * seg_chunks * chunk * dim
    if steady_elems:
        rate, includes_compile = steady_elems / steady_s, False
    else:  # one segment: the only timing includes the first build
        rate, includes_compile = seg_chunks * chunk * dim / first_s, True

    # bench.py's traffic model (:3790-3806) at the H100's peaks: every drawn
    # value element (secrets plus the t/k randomness riding with them)
    # written once and read once, the check re-reading its columns, plus
    # the limb operands. Eager torch moves more than this, so it is an
    # upper bound on the share of the card's bandwidth.
    model = traffic_model(args.engine, route, plan, chunk)
    elem = model["elem_bytes"]
    over = 1.0 + t / k
    hbm_bps = rate * (over * 2.0 * elem + n_check / dim * elem + model["extra_bytes_per_elem"])
    drawn = (chunk * dim + chunk * plan.n_batches * t) * elem  # bytes per chunk
    floor_s = 2 * drawn * (participants_done // chunk) / HBM_BYTES_PER_S
    roofline = {
        "model": "gen(write+read) + check re-read + limb operands; H100 SXM peaks",
        "gen_gbps": rate * over * elem / 1e9,
        "hbm_gbps_model": hbm_bps / 1e9,
        "hbm_pct_h100": 100.0 * hbm_bps / HBM_BYTES_PER_S,
        "floor_s": floor_s,
    }
    if model["macs_per_elem"]:
        ops = 2.0 * rate * model["macs_per_elem"]
        roofline["int8_tops"] = ops / 1e12
        roofline["int8_pct_h100"] = 100.0 * ops / INT8_OPS_PER_S
    _log(f"verified {participants_done} participants x {dim} dims (p={p}, k={k}, t={t}, n={n}); "
         f"first segment {first_s:.3f}s, steady {steady_s:.3f}s, rate {rate:.4e} elems/s")
    result = {
        "metric": METRIC_NAME,
        "value": rate,
        "unit": "shared_elements_per_second",
        "verified": True,
        "engine": args.engine + ("+kernel" if args.kernel else ""),
        "route": route,
        "modulus_bits": p.bit_length(),
        "participants": participants_done,
        "dim": dim,
        "chunk": chunk,
        "segments": done_segments,
        "first_segment_s": first_s,
        "steady_s": steady_s,
        "wall_s": wall_s,
        "finalize_s": finalize_s,
        "peak_bytes": peak,
        "launches": launches,
        "device": str(dev),
        "card": card,
        "power_limit": power_limit,
        "roofline": roofline,
    }
    if args.check != "full":
        result["check"] = args.check
        if args.check == "probe":
            result["check_cols"] = n_check
    if done_segments < n_segments or dropped:
        result["partial"] = True
    if includes_compile:
        result["includes_compile"] = True
    if parity is not None:
        result["parity"] = parity
    if args.roofline:
        roofline["decomposition"] = _decompose(
            make_body, segment, args, seg_times, final, result, args.budget - (time.perf_counter() - bench_t0))
    return result


def _decompose(make_body, segment, args, seg_times, final, result, budget_left: float) -> dict:
    """``--roofline`` (bench.py:3857-3948): time one segment of the stream
    three ways, back to back with fresh carries: full, ``check="off"``,
    and ``check="off"`` with the fill for the draws. The deltas are the
    check's and the draws' cost, the rest the reduction (sum-first) or the
    share-and-combine (participant). In eager torch every op is its own
    kernel, so ``rng_expand`` is ``torch.randint``'s cost over the fill's.
    A variant that hangs past the bail time prints the measured line with
    the decomposition marked timed out and exits 0; any other failure
    raises."""
    if not seg_times:
        return {"skipped": "no steady segments"}
    if budget_left < 120:
        return {"skipped": f"only {budget_left:.0f}s budget left (<120)"}
    bail_s = min(300.0, budget_left)
    done = threading.Event()

    def bail():
        if done.is_set():
            return
        result["roofline"]["decomposition"] = {"error": f"timed out after {bail_s:.0f}s"}
        final.emit(result)
        os._exit(0)

    timer = threading.Timer(bail_s, bail)
    timer.daemon = True
    timer.start()
    dev = torch.device(result["device"])
    reps = 2

    def time_seg(check, fill):
        # torch compiles nothing, so each point gets the same warm segment
        step, acc, plain = make_body(check, fill, torch.Generator(device=dev).manual_seed(43))
        acc, plain = segment(step, acc, plain)
        t0 = time.perf_counter()
        for _ in range(reps):
            acc, plain = segment(step, acc, plain)
        return (time.perf_counter() - t0) / reps

    _log("roofline decomposition")
    try:
        t_full = time_seg(args.check, False)
        t_nc = time_seg("off", False)
        t_fl = time_seg("off", True)
    finally:
        done.set()
        timer.cancel()
    stage3 = "limb_reduce" if args.engine == "sumfirst" else "share_combine"
    parts = {"check": max(0.0, t_full - t_nc), "rng_expand": max(0.0, t_nc - t_fl), stage3: t_fl}
    return {
        "seg_full_s": t_full,
        "seg_steady_s": sum(seg_times) / len(seg_times),
        "seg_nocheck_s": t_nc,
        "seg_fill_s": t_fl,
        **{f"frac_{name}": v / t_full for name, v in parts.items()},
        "binding_stage": max(parts, key=parts.get),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    final = FinalLine()
    try:
        # a missing GPU fails before the riders, not after them
        resolve_device(args.device)
    except Exception as exc:  # noqa: BLE001 - the metric-line contract
        final.emit(error_line(f"{type(exc).__name__}: {exc}"))
        return 2
    if args.artifacts:
        riders.set_artifacts_dir(args.artifacts)
    # the host planes first: they must not eat the device run's deadline,
    # and no CUDA context may swell the RSS that they sample
    final.fields.update(run_riders(args.device))
    watchdog = arm_deadline(args.deadline, final)
    try:
        result = run(args, final, watchdog)
    except Mismatch as exc:
        if watchdog is not None:
            watchdog.cancel()
        _log(f"VERIFICATION FAILED: {exc}")
        final.emit(error_line(str(exc)))
        return 1
    except Exception as exc:  # noqa: BLE001 - the metric-line contract: never a bare traceback
        if watchdog is not None:
            watchdog.cancel()
        traceback.print_exc()
        final.emit(error_line(f"{type(exc).__name__}: {exc}"))
        return 2
    final.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
