"""The least time the card could take for a step or a layer: the work that
any implementation of the same protocol has to do, counted from the
configuration's shapes and divided by the H100's published peaks
(``peaks.json``). Nothing here reads the port's instructions or its
intermediate buffers, so a faster implementation can lower a reading's
denominator but never push the share past 100 %.

- Bytes: each handed input read once and each output written once, at the
  HBM rate.
- ChaCha20: 20 rounds are 80 quarter rounds of 4 XORs and 4 rotations each,
  so 320 XORs and 320 rotations a 64-byte block. Only the integer pipe
  executes them (the adds may go to the FMA pipe and are not counted), at
  ``sms x int_pipe_lanes_per_sm x boost_clock_hz`` a second. A block holds
  eight 64-bit draws, and a mask of ``dim`` values needs at least ``dim``
  draws (the rejection zone only adds to that), so at least
  ``ceil(dim / 8)`` blocks a seed.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())

CHACHA_OPS_PER_BLOCK = 320 + 320
DRAWS_PER_BLOCK = 8


def bytes_s(nbytes: float, peaks: dict = PEAKS) -> float:
    return nbytes / peaks["hbm_bytes_per_s"]


def int_pipe_ops_per_s(peaks: dict = PEAKS) -> float:
    return peaks["sms"] * peaks["int_pipe_lanes_per_sm"] * peaks["boost_clock_hz"]


def chacha_blocks(dim: int) -> int:
    """Least ChaCha20 blocks that one seed's mask of ``dim`` values needs."""
    return -(-dim // DRAWS_PER_BLOCK)


def chacha_s(seeds: int, dim: int, peaks: dict = PEAKS) -> float:
    """Least time to expand ``seeds`` masks of ``dim`` values."""
    return seeds * chacha_blocks(dim) * CHACHA_OPS_PER_BLOCK / int_pipe_ops_per_s(peaks)


def sumfirst_aggregate_s(participants: int, dim: int, value_bytes: int, peaks: dict = PEAKS) -> float:
    """An aggregate of ``participants x dim`` handed secrets of
    ``value_bytes`` each: the secrets read once (the clerk sums and the
    reveal are a few megabytes)."""
    return bytes_s(participants * dim * value_bytes, peaks)


def share_s(participants: int, dim: int, share_count: int, secret_count: int, peaks: dict = PEAKS) -> float:
    """Share and combine of a round: the masked int32 inputs read once and
    the ``(n, ceil(dim / k))`` int64 clerk sums written once."""
    batches = -(-dim // secret_count)
    return bytes_s(participants * dim * 4 + share_count * batches * 8, peaks)


def masked_round_s(participants: int, dim: int, update_bytes: int, peaks: dict = PEAKS) -> float:
    """A ChaCha-masked round: the larger of the handed updates read once and
    the expansion of every participant's mask and of each seed of the
    recipient's fold."""
    return max(bytes_s(participants * dim * update_bytes, peaks), chacha_s(2 * participants, dim, peaks))
