"""The crypto-plane rider (counterpart of ``bench.py``'s
``measure_crypto_plane``): host rates of the native batch layer."""

from __future__ import annotations

import time

import numpy as np


def _rate(count: int, t0: float) -> int:
    return round(count / (time.perf_counter() - t0))


def measure_crypto_plane() -> dict:
    """Host-side crypto-plane rates, a second or so in all: sealed boxes
    (64-byte probes, then 4 KiB and 40 KiB messages, the share vectors a
    protocol seal carries), opens, the ChaCha mask expansion and fold, and
    the varint codec, all through the port's C batch layer
    (``native/_sdanative.c``).

    The "scalar" leg is ``crypto/sodium.seal``, the port's plain Python
    sealed box. In ``bench.py`` that leg was libsodium through ctypes, one
    call per box, so there ``seal_batch_vs_scalar`` priced the batch call
    against the same C per call; here it prices the C batch against the
    Python it replaces, and reads far higher."""
    from .. import native
    from ..crypto import sodium

    out = {"native_ext": native.available()}
    pk, sk = sodium.box_keypair()
    msg = b"\x42" * 64
    n_seal = 2000

    t0 = time.perf_counter()
    sealed = native.seal_batch([msg] * n_seal, pk)
    out["seals_per_s"] = _rate(n_seal, t0)
    t0 = time.perf_counter()
    opened = native.open_batch(sealed, pk, sk)
    out["opens_per_s"] = _rate(n_seal, t0)
    assert opened[0] == msg

    for size, tag, count in ((4096, "_4k", 500), (40960, "_40k", 150)):
        big = b"\x37" * size
        t0 = time.perf_counter()
        native.seal_batch([big] * count, pk)
        out[f"seals_per_s{tag}"] = _rate(count, t0)

    n_scalar = 300
    t0 = time.perf_counter()
    for _ in range(n_scalar):
        sodium.seal(msg, pk)
    scalar_rate = n_scalar / (time.perf_counter() - t0)
    out["seal_batch_vs_scalar"] = round(out["seals_per_s"] / scalar_rate, 2)

    seed = np.arange(4, dtype=np.uint32)
    dim, m = 1_000_000, (1 << 61) - 1
    t0 = time.perf_counter()
    native.chacha_expand(seed, dim, m)
    out["chacha_expand_elems_per_s"] = _rate(dim, t0)
    seeds = np.arange(64, dtype=np.uint32).reshape(16, 4)
    t0 = time.perf_counter()
    native.chacha_combine(seeds, 100_000, m)
    out["chacha_combine_elems_per_s"] = _rate(16 * 100_000, t0)

    vals = np.arange(-500_000, 500_000, dtype=np.int64)
    t0 = time.perf_counter()
    buf = native.varint_encode(vals)
    out["varint_encode_per_s"] = _rate(len(vals), t0)
    t0 = time.perf_counter()
    back = native.varint_decode(buf)
    out["varint_decode_per_s"] = _rate(len(vals), t0)
    assert np.array_equal(back, vals)
    return out
