"""ChaCha20 keystream on Hopper and the batched mask expansion around it.

Counterpart of ``sda_tpu/ops/chacha_pallas.py``. The ChaCha masking scheme
has each participant upload only a seed; the recipient re-expands every seed
to a dim-length mask and subtracts their sum. ``csrc/chacha20.cu`` computes
the keystream blocks, one thread per block with the state in registers;
``chacha_blocks_cuda`` is its wrapper, and on a CPU tensor runs the plain
version ``chacha.chacha_blocks_torch`` instead. On a CUDA tensor it launches
the kernel or raises: there is no probe that switches to another path.

Around the kernel, in torch: the rand-0.3 zone rejection on the u64 draws,
their stable compaction (prefix sum + scatter, so the draw order equals the
host ``expand_seed``), the ``mod m`` and the participant fold. A seed's
window is overgenerated (``_window_pairs``); a row that still holds fewer
than ``dim`` accepted draws raises ``SlackExhausted`` in
``expand_seeds_batch``, and ``combine_masks_device`` re-expands only that
chunk with a doubled window on the same device (exact, since the accepted
draws are a prefix filter of the keystream; about once in 1e9 rows).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..telemetry.device import device_span, sync
from .chacha import chacha_blocks_torch, i32_bits, pad_key, rand03_zone, u32_words
from .modular import WIDE_MAX_MODULUS, mod_sum_auto

#: launches of the chacha20 kernel; only the launching wrapper adds to it
#: (plain-version calls are not counted)
launches = 0
#: re-expansions of a ``combine_masks_device`` chunk with a doubled window,
#: made because a row's window held fewer than ``dim`` accepted draws (each
#: is one more kernel launch on a CUDA tensor)
slack_recoveries = 0

_THREADS = 256  # threads per block in the kernel
_MAX_GRID = (1 << 31) - 1


def _check_counter(first_counter: int, n_blocks: int) -> None:
    if first_counter < 0 or n_blocks < 0 or first_counter + n_blocks > (1 << 63):
        raise ValueError(f"block counters [{first_counter}, +{n_blocks}) outside [0, 2^63]")


def kernel_keys(key_words: torch.Tensor) -> torch.Tensor:
    """``(..., w <= 8)`` u32 seed words -> the kernel's ``(P, 8)`` int32 key
    rows: zero-padded words as uint32 bit patterns, contiguous."""
    return i32_bits(pad_key(key_words.reshape(-1, key_words.shape[-1]))).contiguous()


def chacha_blocks_cuda(key_words: torch.Tensor, first_counter: int, n_blocks: int) -> torch.Tensor:
    """Kernel twin of ``chacha_blocks``: key ``(w <= 8,)`` or ``(P, w)`` u32
    words -> ``(n_blocks, 16)`` or ``(P, n_blocks, 16)`` int32 keystream
    bits, seed p's blocks numbered from ``first_counter``. On a CPU tensor
    this is the plain version; on a CUDA tensor it launches the kernel or
    raises."""
    if key_words.device.type == "cpu":
        with device_span("chacha.k2"):
            return chacha_blocks_torch(key_words, first_counter, n_blocks)
    global launches
    from .. import kernels

    if key_words.device.type != "cuda":
        raise ValueError(f"unsupported device {key_words.device}")
    if key_words.ndim not in (1, 2):
        raise ValueError("key_words must be (w,) or (P, w)")
    _check_counter(first_counter, n_blocks)
    keys = kernel_keys(key_words)
    P = keys.shape[0]
    if -(-P * n_blocks // _THREADS) > _MAX_GRID:
        raise ValueError(f"{P} x {n_blocks} blocks exceed one launch's grid")
    out = torch.empty((P, n_blocks, 16), dtype=torch.int32, device=key_words.device)
    if P and n_blocks:
        fn = kernels.load("chacha20").chacha20_launch
        with torch.cuda.device(key_words.device), device_span("chacha.k2"):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(keys.data_ptr(), first_counter, n_blocks, P, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"chacha20 launch failed: cudaError {rc}")
        launches += 1
    return out[0] if key_words.ndim == 1 else out


class SlackExhausted(RuntimeError):
    """A seed's keystream window held fewer than ``dim`` accepted draws.

    About 1e-9 per row (6-sigma margin); ``combine_masks_device`` recovers
    by re-expanding only the affected chunk with a doubled window."""


def _window_pairs(dim: int, modulus: int) -> int:
    """How many u64 pairs to generate so every row holds >= dim accepted
    draws with ~6-sigma margin. The accepted sequence is a prefix filter of
    the keystream, so overgeneration never changes results. The rejection
    probability q of the rand-0.3 zone reaches 1/2 at m = 2^63, so the
    window scales with q."""
    q = ((1 << 64) - rand03_zone(modulus)) / float(1 << 64)
    expected = dim / (1.0 - q)
    margin = 6.0 * math.sqrt(expected * q) / (1.0 - q)
    return dim + int(expected - dim + margin) + 8


def window_blocks(dim: int, modulus: int) -> int:
    """ChaCha blocks per seed that hold ``_window_pairs`` u64 draws."""
    return (_window_pairs(dim, modulus) * 2 + 15) // 16


def _mod_shifted(shifted: torch.Tensor, modulus: int) -> torch.Tensor:
    """``v mod m`` for u64 draws given as ``v - 2^63`` in int64, without
    overflow for any m < 2^63: ``(v - 2^63) mod m + 2^63 mod m`` folded as
    ``r1 - (m - r2)``, plus m where negative."""
    r = torch.remainder(shifted, modulus) - (modulus - (1 << 63) % modulus)
    return torch.where(r < 0, r + modulus, r)


def expand_seeds_counts(seed_words: torch.Tensor, dim: int, modulus: int,
                        n_blocks: int | None = None):
    """``(P, w <= 8)`` u32 seeds -> ``((P, dim) int64 masks, (P,) int32
    accepted-draw counts)`` on the seeds' device, from a window of
    ``n_blocks`` keystream blocks per seed (default ``window_blocks``).

    The slack guard is NOT applied: a row with ``counts[p] < dim`` has
    undefined trailing mask values, and callers must check ``counts``
    before using the masks (``expand_seeds_batch`` does)."""
    if modulus >= (1 << 63):
        raise ValueError(f"modulus {modulus} does not fit the int64 masks")
    P = seed_words.shape[0]
    dev = seed_words.device
    if P == 0:
        return (torch.zeros((0, dim), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    zone = rand03_zone(modulus)  # rand-0.3 exact: rejection always applies
    if n_blocks is None:
        n_blocks = window_blocks(dim, modulus)
    with device_span("chacha.expand"):
        pairs = chacha_blocks_cuda(seed_words, 0, n_blocks).view(P, n_blocks * 8, 2)
        with device_span("chacha.compact"):
            hi, lo = u32_words(pairs[..., 0]), u32_words(pairs[..., 1])
            # each draw v = hi * 2^32 + lo as v - 2^63, exact in int64: unsigned
            # order and the zone test carry over, and no shift wraps a sign
            shifted = (hi - (1 << 31)) * (1 << 32) + lo
            ok = shifted < zone - (1 << 63)
            counts = torch.sum(ok, dim=1, dtype=torch.int32)
            # stable compaction: accepted draw k lands in slot (#accepted before k),
            # rejected draws in a dump column past every slot that is read
            width = max(shifted.shape[1], dim) + 1
            idx = torch.where(ok, torch.cumsum(ok, dim=1) - 1, width - 1)
            compact = torch.zeros((P, width), dtype=torch.int64, device=dev)
            compact.scatter_(1, idx, shifted)
            return _mod_shifted(compact[:, :dim], modulus), counts


def _least_count(counts: torch.Tensor, site: str) -> int:
    """The fewest accepted draws of any row: a host sync at ``site``."""
    with sync(site):
        return int(torch.min(counts))


def expand_seeds_batch(seed_words: torch.Tensor, dim: int, modulus: int) -> torch.Tensor:
    """``(P, w <= 8)`` u32 seeds -> ``(P, dim)`` int64 masks on the seeds'
    device, row p bit-equal to ``expand_seed(seed_p)``; raises
    ``SlackExhausted`` if a row's window held fewer than ``dim`` draws."""
    masks, counts = expand_seeds_counts(seed_words, dim, modulus)
    if counts.shape[0] and _least_count(counts, "batch_counts") < dim:
        raise SlackExhausted(f"seed window held < {dim} accepted draws in at least one row")
    return masks


def _fold(masks: torch.Tensor, modulus: int) -> torch.Tensor:
    """Participant fold of canonical masks: (P, dim) -> (dim,) in [0, m)."""
    return mod_sum_auto(masks, modulus, axis=0)


def _fold_chunk(batch: torch.Tensor, dim: int, modulus: int, n_blocks: int | None = None):
    """One reveal fold: expand + reduce on the device; returns the (dim,)
    partial and the (P,) accepted counts."""
    masks, counts = expand_seeds_counts(batch, dim, modulus, n_blocks)
    with device_span("chacha.fold"):
        return _fold(masks, modulus), counts


#: transient device-memory budget per fold of ``combine_masks_device``: the
#: expansion materializes ~5 chunk x dim x 8 B tensors at peak
_COMBINE_BYTES_BUDGET = 2 << 30


def default_chunk(dim: int) -> int:
    """Seeds per fold of ``combine_masks_device`` within the budget."""
    return max(16, _COMBINE_BYTES_BUDGET // (5 * 8 * dim))


def seed_tensor(seed_words, device=None) -> torch.Tensor:
    """Seeds as ``(P, w)`` nonnegative int64 words on ``device`` (CUDA
    unless the caller asks for the CPU): a tensor is moved, anything else
    is read as numpy uint32 words."""
    if not isinstance(seed_words, torch.Tensor):
        seed_words = torch.as_tensor(np.asarray(seed_words, dtype=np.uint32))
    return u32_words(seed_words).to(resolve_device(device))


def combine_masks_device(seed_words, dim: int, modulus: int, *, chunk: int | None = None,
                         device=None) -> torch.Tensor:
    """Recipient reveal loop: ``(P, w)`` u32 seeds -> ``(dim,)`` int64
    ``sum_p expand_seed(seed_p) mod m`` on ``device`` (CUDA unless the
    caller asks for the CPU; raises without a GPU), folding ``chunk`` seeds
    at a time. The default chunk keeps a fold's ~5 transient chunk x dim x
    8 B tensors within ``_COMBINE_BYTES_BUDGET``."""
    global slack_recoveries
    if modulus >= WIDE_MAX_MODULUS:
        raise ValueError(f"modulus {modulus} >= 2^62: the int64 fold is not exact")
    seeds = seed_tensor(seed_words, device)
    if chunk is None:
        chunk = default_chunk(dim)
    total = torch.zeros((dim,), dtype=torch.int64, device=seeds.device)
    for start in range(0, seeds.shape[0], chunk):
        batch = seeds[start : start + chunk]
        n_blocks = window_blocks(dim, modulus)
        part, counts = _fold_chunk(batch, dim, modulus, n_blocks)
        while _least_count(counts, "fold_counts") < dim:
            # a row's window ran dry: a longer window keeps the same first
            # draws, so re-expand just this chunk with twice the blocks
            n_blocks *= 2
            part, counts = _fold_chunk(batch, dim, modulus, n_blocks)
            slack_recoveries += 1
        total = torch.remainder(total + part, modulus)
    return total
