"""Deterministic ChaCha20 keystream expansion for seed-compressed masking.

Counterpart of ``sda_tpu/ops/chacha.py``. The numpy half (``rand03_zone``,
``chacha_blocks``, ``expand_seed``) is a copy: it is the host expansion that
participants mask with and the independent cross-check of every device path.
The torch half builds the same states and runs the same 20 rounds on tensors;
``chacha_rounds_torch`` is the plain version of the CUDA kernel in
``csrc/chacha20.cu`` (wrapper: ``ops/chacha_cuda.py``).

Expansion spec, bit-exact to the reference's rand-0.3
``ChaChaRng::from_seed(&seed)`` + per-element ``gen_range(0_i64, m)``:

- Key: the seed's u32 words zero-padded to 8 words (256-bit key).
- Stream: djb ChaCha20, zero nonce, a 64-bit block counter over words 12-13
  starting at 0, all 16 output words consumed in order.
- Draws: ``next_u64`` = two consecutive words as ``(w[2i] << 32) | w[2i+1]``
  (high word first), values >= zone rejected, accepted values reduced mod m,
  with zone = ``u64::MAX - u64::MAX % m`` as rand 0.3 computes it.

torch has no usable unsigned arithmetic, so the torch half carries each
word as a nonnegative int64 and masks with ``& 0xFFFFFFFF`` after every add
and rotate. Keystream tensors leave it as int32 holding the uint32 bit
patterns, the layout the kernel writes (``.numpy().view(np.uint32)`` gives
the words back).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

MASK32 = 0xFFFFFFFF


def rand03_zone(modulus: int) -> int:
    """rand 0.3's rejection zone for ``gen_range(0, modulus)`` on u64 draws:
    accept v < zone, zone = u64::MAX - u64::MAX % range."""
    if modulus <= 0:
        raise ValueError("modulus must be positive")
    if modulus > (1 << 63):
        # masks are int64 and gen_range draws i64: above 2^63 the reduced
        # draws would wrap negative
        raise ValueError(f"modulus {modulus} exceeds the int64 mask range")
    u64_max = (1 << 64) - 1
    return u64_max - (u64_max % modulus)


_CONSTANTS = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32)

_QUARTER_ROUNDS = [
    # column rounds
    (0, 4, 8, 12),
    (1, 5, 9, 13),
    (2, 6, 10, 14),
    (3, 7, 11, 15),
    # diagonal rounds
    (0, 5, 10, 15),
    (1, 6, 11, 12),
    (2, 7, 8, 13),
    (3, 4, 9, 14),
]


# ---------------------------------------------------------------------------
# numpy half (host expansion and cross-check reference)
# ---------------------------------------------------------------------------


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def chacha_blocks(key_words: np.ndarray, first_counter: int, n_blocks: int) -> np.ndarray:
    """n_blocks ChaCha20 blocks -> (n_blocks, 16) uint32 keystream words."""
    key = np.zeros(8, dtype=np.uint32)
    key[: len(key_words)] = np.asarray(key_words, dtype=np.uint32)
    counters = np.arange(first_counter, first_counter + n_blocks, dtype=np.uint64)
    state = np.zeros((n_blocks, 16), dtype=np.uint32)
    state[:, 0:4] = _CONSTANTS
    state[:, 4:12] = key
    state[:, 12] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    state[:, 13] = (counters >> np.uint64(32)).astype(np.uint32)
    # words 14-15: zero nonce

    x = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):  # 20 rounds = 10 double rounds
            for (a, b, c, d) in _QUARTER_ROUNDS:
                x[:, a] += x[:, b]
                x[:, d] = _rotl(x[:, d] ^ x[:, a], 16)
                x[:, c] += x[:, d]
                x[:, b] = _rotl(x[:, b] ^ x[:, c], 12)
                x[:, a] += x[:, b]
                x[:, d] = _rotl(x[:, d] ^ x[:, a], 8)
                x[:, c] += x[:, d]
                x[:, b] = _rotl(x[:, b] ^ x[:, c], 7)
        x += state
    return x


def expand_seed(seed_words, dim: int, modulus: int) -> np.ndarray:
    """Expand seed u32 words to a dim-length int64 mask in [0, modulus),
    bit-exact to the reference's rand-0.3 expansion (module doc)."""
    zone = rand03_zone(modulus)
    # rejection probability q = (u64::MAX % m + 1) / 2^64, up to 1/2 at the
    # maximum m = 2^63, so each refill is sized from the actual q
    q = ((1 << 64) - zone) / float(1 << 64)
    out = np.empty(0, dtype=np.int64)
    counter = 0
    while len(out) < dim:
        need = dim - len(out)
        need_pairs = int(need / (1.0 - q)) + 8
        n_blocks = (need_pairs * 2 + 15) // 16
        words = chacha_blocks(seed_words, counter, n_blocks).reshape(-1)
        counter += n_blocks
        u64 = (words[0::2].astype(np.uint64) << np.uint64(32)) | words[1::2].astype(np.uint64)
        u64 = u64[u64 < np.uint64(zone)]
        out = np.concatenate([out, (u64 % np.uint64(modulus)).astype(np.int64)])
    return out[:dim]


# ---------------------------------------------------------------------------
# torch (device) half
# ---------------------------------------------------------------------------


def u32_words(x) -> torch.Tensor:
    """u32 words (a tensor of any integer dtype holding them, as values or
    as int32 bit patterns) -> nonnegative int64 on the same device."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """Nonnegative int64 words in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pad_key(key_words: torch.Tensor) -> torch.Tensor:
    """(..., w <= 8) u32 seed words -> (..., 8) int64 key, zero-padded."""
    words = u32_words(key_words)
    w = words.shape[-1]
    if w > 8:
        raise ValueError(f"a ChaCha20 key holds at most 8 words, got {w}")
    return torch.nn.functional.pad(words, (0, 8 - w))


def chacha_state(key_words: torch.Tensor, first_counter: int, n_blocks: int) -> torch.Tensor:
    """Initial ChaCha20 states on the key's device: key ``(..., w <= 8)`` ->
    ``(..., n_blocks, 16)`` int64 words. A leading seed axis gives one
    stream per seed, each counting blocks from ``first_counter``."""
    key = pad_key(key_words)
    lead = tuple(key.shape[:-1])
    counters = torch.arange(
        first_counter, first_counter + n_blocks, dtype=torch.int64, device=key.device
    )
    state = torch.zeros(lead + (n_blocks, 16), dtype=torch.int64, device=key.device)
    state[..., 0:4] = torch.as_tensor(_CONSTANTS.astype(np.int64), device=key.device)
    state[..., 4:12] = key[..., None, :]
    state[..., 12] = counters & MASK32
    state[..., 13] = counters >> 32  # the carry out of word 12
    return state  # words 14-15: zero nonce


def apply_rounds(cols: list) -> list:
    """The 20 ChaCha rounds on a 16-list of int64 word tensors in
    [0, 2^32) (no feed-forward)."""

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & MASK32

    for _ in range(10):  # 20 rounds = 10 double rounds
        for (a, b, c, d) in _QUARTER_ROUNDS:
            cols[a] = (cols[a] + cols[b]) & MASK32
            cols[d] = rotl(cols[d] ^ cols[a], 16)
            cols[c] = (cols[c] + cols[d]) & MASK32
            cols[b] = rotl(cols[b] ^ cols[c], 12)
            cols[a] = (cols[a] + cols[b]) & MASK32
            cols[d] = rotl(cols[d] ^ cols[a], 8)
            cols[c] = (cols[c] + cols[d]) & MASK32
            cols[b] = rotl(cols[b] ^ cols[c], 7)
    return cols


def chacha_rounds_torch(state: torch.Tensor) -> torch.Tensor:
    """20 ChaCha rounds + feed-forward on ``(..., 16)`` int64 states ->
    ``(..., 16)`` int32 keystream bit patterns. The plain version of the
    ``chacha20`` kernel."""
    cols = apply_rounds([state[..., i] for i in range(16)])
    return i32_bits((torch.stack(cols, dim=-1) + state) & MASK32)


def chacha_blocks_torch(key_words: torch.Tensor, first_counter: int, n_blocks: int) -> torch.Tensor:
    """Tensor twin of ``chacha_blocks`` on the key's device: key
    ``(..., w <= 8)`` -> ``(..., n_blocks, 16)`` int32 keystream bits."""
    return chacha_rounds_torch(chacha_state(key_words, first_counter, n_blocks))


def expand_seed_device(seed_words, dim: int, modulus: int, device=None) -> torch.Tensor:
    """Device twin of ``expand_seed``: (dim,) int64 mask in [0, modulus) on
    ``device`` (CUDA unless the caller asks for the CPU; raises without a
    GPU). The batched expansion with one seed, so the same zone rejection,
    draw order and ``SlackExhausted`` guard."""
    from .chacha_cuda import expand_seeds_batch

    seeds = u32_words(np.asarray(seed_words, dtype=np.uint32)).to(resolve_device(device))
    return expand_seeds_batch(seeds[None, :], dim, modulus)[0]
