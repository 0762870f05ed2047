"""Zigzag + LEB128 varint codec for share vectors (copy of
``sda_tpu/crypto/varint.py``).

Wire parity with the SDA client's ``integer_encoding::VarInt`` for i64
(client/src/crypto/encryption/sodium.rs:36-41, 85-91): signed values zigzag
to u64 then little-endian base-128 with continuation bits. Share payloads can
be negative (truncated-remainder representatives), so zigzag is load-bearing.

Implemented as fixed-depth vectorized numpy passes (10 columns max for u64),
not a per-element Python loop.
"""

from __future__ import annotations

import numpy as np


def zigzag_encode(values: np.ndarray) -> np.ndarray:
    v = values.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def zigzag_decode(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64)
    return ((z >> np.uint64(1)).astype(np.int64)) ^ -((z & np.uint64(1)).astype(np.int64))


def encode_i64(values: np.ndarray) -> bytes:
    """Encode an int64 vector to concatenated zigzag-LEB128 varints."""
    z = zigzag_encode(np.ascontiguousarray(values))
    n = len(z)
    cols = np.empty((n, 10), dtype=np.uint8)
    valid = np.empty((n, 10), dtype=bool)
    for i in range(10):
        shifted = z >> np.uint64(7 * i)
        more = (z >> np.uint64(min(7 * (i + 1), 63))) != 0 if i < 9 else np.zeros(n, bool)
        if i == 9:
            cols[:, i] = (shifted & np.uint64(0x7F)).astype(np.uint8)
        else:
            cols[:, i] = ((shifted & np.uint64(0x7F)) | (np.uint64(0x80) * more)).astype(
                np.uint8
            )
        valid[:, i] = (shifted != 0) if i > 0 else True
    return cols[valid].tobytes()


def decode_i64(buf: bytes) -> np.ndarray:
    """Decode concatenated zigzag-LEB128 varints to an int64 vector."""
    data = np.frombuffer(buf, dtype=np.uint8)
    if len(data) == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.nonzero(data < 0x80)[0]
    if len(ends) == 0 or ends[-1] != len(data) - 1:
        raise ValueError("truncated varint stream")
    starts = np.concatenate([[0], ends[:-1] + 1])
    lengths = ends - starts + 1
    if lengths.max() > 10:
        raise ValueError("varint too long for u64")
    z = np.zeros(len(starts), dtype=np.uint64)
    for i in range(int(lengths.max())):
        mask = lengths > i
        part = data[starts[mask] + i].astype(np.uint64) & np.uint64(0x7F)
        z[mask] |= part << np.uint64(7 * i)
    return zigzag_decode(z)
