"""The port's ChaCha20 expansion (``ops/chacha.py``, ``ops/chacha_cuda.py``)
against ``sda_tpu.ops.chacha`` and ``sda_tpu.ops.chacha_pallas`` on the CPU.
Where the JAX function reaches the Pallas kernel it runs in interpret mode.
The CUDA kernel itself runs only on a GPU (``chip_smoke.py`` holds it
bit-identical to the plain version there); here the wrapper's CPU path, its
guards and the key rows the kernel reads are checked. Every comparison is
bit-exact: keystream words as uint32, masks as int64."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from sda_tpu.ops import chacha as jchacha
from sda_tpu.ops import chacha_pallas as jpallas
from sda_tpu.ops import find_packed_parameters
from sda_tpu.ops.jaxcfg import ensure_x64
from sda_tpu.parallel.engine import make_plan as jmake_plan
from sda_tpu.parallel.limb_pallas import share_combine_limb_pallas
from sda_tpu.protocol import PackedShamirSharing as JPacked
from sda_tpu_torch.ops import chacha, chacha_cuda
from sda_tpu_torch.ops.modular import positive
from sda_tpu_torch.parallel.engine import make_plan, reconstruct
from sda_tpu_torch.parallel.limb_cuda import share_combine_limb_cuda
from sda_tpu_torch.parallel.limbmatmul import limb_recombine_host
from sda_tpu_torch.protocol import PackedShamirSharing

ensure_x64()

CPU = "cpu"
HIGH_REJECTION = 2305843009213693967  # smallest prime > 2^61: q ~ 12.5 %
KNOWN_BLOCK0 = "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7"
SEEDS = np.random.default_rng(7).integers(0, 2**32, size=(5, 4), dtype=np.uint64).astype(np.uint32)

BLOCK_CASES = [  # (key words, first counter, n_blocks)
    (tuple(range(8)), 0, 1),
    ((1, 2), 5, 700),
    ((7, 8, 9), (1 << 32) - 3, 7),  # counter carries into word 13
]
EXPAND_CASES = [  # (dim, modulus): test_ops_field's tiers + the high-rejection prime
    (64, 433),
    (100, (1 << 31) - 1),
    (33, 2**61 - 1),
    (16, 1 << 32),
    (2000, HIGH_REJECTION),
]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def _jax_blocks(case: int):
    key, first, n = BLOCK_CASES[case]
    key = jnp.asarray(np.array(key, dtype=np.uint32))
    pallas = np.asarray(jpallas.chacha_blocks_pallas(key, first, n, interpret=True))
    return pallas, np.asarray(jchacha.chacha_blocks_jnp(key, first, n))


@functools.lru_cache(maxsize=None)
def _jax_combine(dim: int, m: int, chunk):
    return np.asarray(jpallas.combine_masks_device(jnp.asarray(SEEDS), dim, m, chunk=chunk))


@pytest.mark.parametrize(
    "impl",
    [
        lambda key: chacha.chacha_blocks(key, 0, 1),
        lambda key: _u32(chacha.chacha_blocks_torch(torch.as_tensor(key), 0, 1)),
        lambda key: _u32(chacha_cuda.chacha_blocks_cuda(torch.as_tensor(key), 0, 1)),
    ],
    ids=["numpy", "torch", "cuda-wrapper-cpu"],
)
def test_chacha_block_known_vector(impl):
    """djb ChaCha20, zero key, zero nonce, counter 0."""
    words = impl(np.zeros(8, dtype=np.uint32))[0]
    assert words.astype("<u4").tobytes()[:32].hex() == KNOWN_BLOCK0


@pytest.mark.parametrize("case", range(len(BLOCK_CASES)))
@pytest.mark.parametrize(
    "impl", [chacha.chacha_blocks_torch, chacha_cuda.chacha_blocks_cuda], ids=["torch", "cuda-wrapper-cpu"]
)
def test_chacha_blocks_match_jax(impl, case):
    key, first, n = BLOCK_CASES[case]
    before = chacha_cuda.launches
    got = impl(torch.tensor(key, dtype=torch.int64), first, n)
    assert chacha_cuda.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.int32 and got.shape == (n, 16)
    pallas, jnp_words = _jax_blocks(case)
    np.testing.assert_array_equal(_u32(got), pallas)
    np.testing.assert_array_equal(_u32(got), jnp_words)
    np.testing.assert_array_equal(_u32(got), chacha.chacha_blocks(np.array(key, np.uint32), first, n))


def test_batched_keys_give_one_stream_per_seed():
    got = chacha_cuda.chacha_blocks_cuda(chacha_cuda.seed_tensor(SEEDS, CPU), 3, 9)
    assert got.shape == (5, 9, 16)
    for row, seed in zip(got, SEEDS):
        np.testing.assert_array_equal(_u32(row), chacha.chacha_blocks(seed, 3, 9))


def test_rounds_match_jnp_on_full_range_states():
    rng = np.random.default_rng(3)
    states = rng.integers(0, 2**32, size=(64, 16), dtype=np.uint64).astype(np.uint32)
    states[0] = 0xFFFFFFFF  # every add wraps
    want = np.asarray(jchacha.chacha_rounds_jnp(jnp.asarray(states)))
    got = chacha.chacha_rounds_torch(chacha.u32_words(torch.as_tensor(states)))
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_kernel_key_rows(w):
    seeds = np.random.default_rng(w).integers(0, 2**32, size=(5, w), dtype=np.uint64).astype(np.uint32)
    keys = chacha_cuda.kernel_keys(torch.as_tensor(seeds))
    assert keys.dtype == torch.int32 and keys.shape == (5, 8) and keys.is_contiguous()
    want = np.zeros((5, 8), dtype=np.uint32)
    want[:, :w] = seeds
    np.testing.assert_array_equal(_u32(keys), want)
    with pytest.raises(ValueError, match="at most 8 words"):
        chacha_cuda.kernel_keys(torch.zeros((2, 9), dtype=torch.int64))


@pytest.mark.parametrize("m", [433, (1 << 31) - 1, 2**61 - 1, 1 << 32, HIGH_REJECTION, 1 << 63])
def test_zone_and_window_match_jax(m):
    assert chacha.rand03_zone(m) == jchacha.rand03_zone(m)
    for dim in (1, 103, 10_000, 100_000):
        assert chacha_cuda._window_pairs(dim, m) == jpallas._window_pairs(dim, m)


@pytest.mark.parametrize("dim,m", EXPAND_CASES)
def test_expand_seeds_match_jax(dim, m):
    want_masks, want_counts = jpallas.expand_seeds_counts(jnp.asarray(SEEDS), dim, m, "interpret")
    seeds = chacha_cuda.seed_tensor(SEEDS, CPU)
    masks, counts = chacha_cuda.expand_seeds_counts(seeds, dim, m)
    assert masks.dtype == torch.int64 and counts.dtype == torch.int32
    np.testing.assert_array_equal(masks.numpy(), np.asarray(want_masks))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    host = np.stack([chacha.expand_seed(s, dim, m) for s in SEEDS])
    np.testing.assert_array_equal(chacha_cuda.expand_seeds_batch(seeds, dim, m).numpy(), host)


@pytest.mark.parametrize("seed", [[1, 2, 3, 4], [0xFFFFFFFF, 7], list(range(8))])
def test_expand_seed_device_matches_jnp(seed):
    seed = np.array(seed, dtype=np.uint32)
    for dim, m in [(257, 2**61 - 1), (100, 433)]:
        got = chacha.expand_seed_device(seed, dim, m, device=CPU)
        want = np.asarray(jchacha.expand_seed_jnp(jnp.asarray(seed), dim, m))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), jchacha.expand_seed(seed, dim, m))


@pytest.mark.parametrize("dim,m", [(64, 433), (33, 2**61 - 1), (16, 1 << 32)])
@pytest.mark.parametrize("chunk", [2, None], ids=["chunk2", "default-chunk"])
def test_combine_masks_matches_jax(chunk, dim, m):
    got = chacha_cuda.combine_masks_device(SEEDS, dim, m, chunk=chunk, device=CPU)
    assert got.dtype == torch.int64 and got.shape == (dim,)
    np.testing.assert_array_equal(got.numpy(), _jax_combine(dim, m, chunk))
    host = np.stack([chacha.expand_seed(s, dim, m) for s in SEEDS])
    wide = host.astype(object).sum(axis=0) % m
    np.testing.assert_array_equal(got.numpy(), wide.astype(np.int64))


@pytest.mark.parametrize("m", [1 << 62, (1 << 63) - 25])
def test_combine_masks_refuses_moduli_from_2_62(m):
    """From 2^62 a fold ``(total + part) % m`` of two int64 residues can
    overflow: the reference's fold returns a wrong sum at m = 2^63 - 25, the
    port refuses such a modulus."""
    with pytest.raises(ValueError, match=r">= 2\^62"):
        chacha_cuda.combine_masks_device(SEEDS, 5, m, device=CPU)


def test_slack_exhausted_raises_and_combine_recovers(monkeypatch):
    dim, m = 64, 433
    monkeypatch.setattr(chacha_cuda, "_window_pairs", lambda d, q: d // 2)
    seeds = chacha_cuda.seed_tensor(SEEDS, CPU)
    with pytest.raises(chacha_cuda.SlackExhausted):
        chacha_cuda.expand_seeds_batch(seeds, dim, m)
    masks, counts = chacha_cuda.expand_seeds_counts(seeds, dim, m)
    assert masks.shape == (5, dim) and int(counts.max()) <= dim // 2
    before = chacha_cuda.slack_recoveries
    got = chacha_cuda.combine_masks_device(SEEDS, dim, m, chunk=2, device=CPU)
    assert chacha_cuda.slack_recoveries == before + 3  # every chunk re-expanded once
    np.testing.assert_array_equal(got.numpy(), _jax_combine(dim, m, 2))


def test_combine_recovery_doubles_the_window_until_every_row_fills(monkeypatch):
    """A one-pair window (one block, 8 draws) takes three doublings to hold
    64 draws; the recovery stays on the seeds' device and launches nothing
    on the CPU."""
    dim, m = 64, 433
    monkeypatch.setattr(chacha_cuda, "_window_pairs", lambda d, q: 1)
    before, launched = chacha_cuda.slack_recoveries, chacha_cuda.launches
    got = chacha_cuda.combine_masks_device(SEEDS, dim, m, chunk=2, device=CPU)
    assert chacha_cuda.slack_recoveries == before + 3 * 3
    assert chacha_cuda.launches == launched
    np.testing.assert_array_equal(got.numpy(), _jax_combine(dim, m, 2))


@pytest.mark.parametrize(
    "call",
    [
        lambda seeds: chacha_cuda.chacha_blocks_cuda(seeds, 0, 4),
        lambda seeds: chacha_cuda.expand_seeds_counts(seeds, 10, 433),
        lambda seeds: chacha_cuda.combine_masks_device(seeds, 10, 433, device="meta"),
    ],
    ids=["blocks", "expand", "combine"],
)
def test_non_cpu_tensor_never_takes_the_plain_version(call):
    """A tensor off the CPU goes to the kernel or raises: here a meta tensor
    (no data, no device) is refused before any launch."""
    seeds = torch.empty((3, 4), dtype=torch.int64, device="meta")
    before = chacha_cuda.launches
    with pytest.raises(ValueError, match="unsupported device"):
        call(seeds)
    assert chacha_cuda.launches == before


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chacha_cuda.combine_masks_device(SEEDS, 10, 433)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chacha.expand_seed_device(SEEDS[0], 10, 433)


def test_masked_round_matches_jax():
    """The slice as a whole at the bench scheme: seeds -> masks -> masked
    values -> fused limb share-and-reduce -> reveal from clerks 1..7 ->
    unmask by the re-expanded seeds."""
    p, w2, w3 = find_packed_parameters(5, 2, 8, min_modulus_bits=30, seed=0)
    P, dim = 64, 103
    rng = np.random.default_rng(2)
    seeds = rng.integers(0, 2**32, size=(P, 4), dtype=np.uint64).astype(np.uint32)
    secrets = rng.integers(0, 1 << 30, size=(P, dim)).astype(np.int64)
    scheme = PackedShamirSharing(5, 8, 2, p, w2, w3)
    plan = make_plan(scheme, dim, device=CPU)
    rand = rng.integers(0, p, size=(P, plan.n_batches, 2)).astype(np.int64)

    masks, counts = chacha_cuda.expand_seeds_counts(chacha_cuda.seed_tensor(seeds, CPU), dim, p)
    want_masks, want_counts = jpallas.expand_seeds_counts(jnp.asarray(seeds), dim, p, "interpret")
    np.testing.assert_array_equal(masks.numpy(), np.asarray(want_masks))
    assert int(counts.min()) >= dim and np.array_equal(counts.numpy(), np.asarray(want_counts))

    masked = torch.fmod(torch.as_tensor(secrets) + masks, p)
    acc = share_combine_limb_cuda(masked, None, plan, draw=lambda g, shape, q: torch.as_tensor(rand))
    want_acc = share_combine_limb_pallas(
        jnp.asarray(masked.numpy()), random.key(0), jmake_plan(JPacked(5, 8, 2, p, w2, w3), dim),
        draw=lambda key, shape, q: jnp.asarray(rand),
    )
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))

    survivors = list(range(1, 8))  # clerk 0 dropped
    clerk_sums = torch.as_tensor(limb_recombine_host(acc, p).T.copy())
    masked_total = reconstruct(clerk_sums, survivors, scheme, dim)
    combined = chacha_cuda.combine_masks_device(seeds, dim, p, device=CPU)
    out = positive(torch.fmod(masked_total - combined, p), p)
    np.testing.assert_array_equal(out.numpy(), secrets.sum(axis=0) % p)
