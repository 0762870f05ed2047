"""Plain ChaCha20 and the masking protocol's draws from it, in numpy.

The block function is RFC 8439's (20 rounds, the input added back), in
D. J. Bernstein's original layout: a 64-bit block counter in words 12-13
and a 64-bit nonce in words 14-15. A participant's mask of ``dim`` values
in ``[0, p)`` comes from its seed so (the draws of rand 0.3's
``ChaChaRng::from_seed`` and ``gen_range(0, p)``, which the protocol fixes):

- the key is the seed's 32-bit words, zero-padded to eight; the nonce is
  zero and the counter starts at 0; every block's 16 words are used in order;
- each pair of words is one 64-bit draw, the first word high;
- a draw at or above ``2^64 - 1 - (2^64 - 1) mod p`` is rejected, and an
  accepted draw ``v`` gives ``v mod p``.

Nothing of the port is imported.
"""

from __future__ import annotations

import numpy as np

CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
U64_MAX = (1 << 64) - 1


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _quarter(x: list, a: int, b: int, c: int, d: int) -> None:
    x[a] += x[b]
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] += x[d]
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] += x[b]
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] += x[d]
    x[b] = _rotl(x[b] ^ x[c], 7)


def blocks(key_words, first_counter: int, count: int, nonce=(0, 0)) -> np.ndarray:
    """``count`` keystream blocks from ``first_counter`` on: ``(count, 16)``
    uint32 words."""
    key = [int(w) for w in key_words] + [0] * (8 - len(key_words))
    counters = np.arange(first_counter, first_counter + count, dtype=np.uint64)
    state = [np.full(count, w, dtype=np.uint32) for w in (*CONSTANTS, *key)]
    state += [(counters & np.uint64(0xFFFFFFFF)).astype(np.uint32), (counters >> np.uint64(32)).astype(np.uint32)]
    state += [np.full(count, w, dtype=np.uint32) for w in nonce]
    x = [w.copy() for w in state]
    with np.errstate(over="ignore"):
        for _ in range(10):
            _quarter(x, 0, 4, 8, 12)
            _quarter(x, 1, 5, 9, 13)
            _quarter(x, 2, 6, 10, 14)
            _quarter(x, 3, 7, 11, 15)
            _quarter(x, 0, 5, 10, 15)
            _quarter(x, 1, 6, 11, 12)
            _quarter(x, 2, 7, 8, 13)
            _quarter(x, 3, 4, 9, 14)
        return np.stack([a + b for a, b in zip(x, state)], axis=1)


def mask(seed_words, dim: int, p: int) -> np.ndarray:
    """A participant's ``(dim,)`` int64 mask in ``[0, p)`` from its seed."""
    zone = U64_MAX - U64_MAX % p
    accept = zone / 2.0**64
    out, counter = [], 0
    while sum(len(v) for v in out) < dim:
        need = dim - sum(len(v) for v in out)
        count = -(-int(need / accept + 64) // 8)
        words = blocks(seed_words, counter, count).reshape(-1).astype(np.uint64)
        counter += count
        draws = (words[0::2] << np.uint64(32)) | words[1::2]
        draws = draws[draws < np.uint64(zone)]
        out.append((draws % np.uint64(p)).astype(np.int64))
    return np.concatenate(out)[:dim]
