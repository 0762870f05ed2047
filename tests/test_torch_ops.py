"""Parity of the port's field ops, parameters, Shamir maps and device draws
with the JAX package, on the CPU. Integer field arithmetic: the tolerance is
exact equality (after ``positive`` where the contract is residue equality)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sda_tpu.ops import modular as jmod
from sda_tpu.ops import params as jparams
from sda_tpu.ops import shamir as jshamir
from sda_tpu.ops.jaxcfg import ensure_x64
from sda_tpu.protocol import BasicShamirSharing as JBasic
from sda_tpu.protocol import PackedShamirSharing as JPacked
from sda_tpu_torch.ops import modular as tmod
from sda_tpu_torch.ops import params as tparams
from sda_tpu_torch.ops import rng as trng
from sda_tpu_torch.ops import shamir as tshamir
from sda_tpu_torch.protocol import BasicShamirSharing, PackedShamirSharing

ensure_x64()

M31 = (1 << 31) - 1
M61 = (1 << 61) - 1


def _j(x):
    return np.asarray(x)


def _t(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("m", [433, M31, M61])
def test_rust_rem_truncates_like_reference(m):
    rng = np.random.default_rng(1)
    x = rng.integers(-(1 << 62), 1 << 62, size=(40, 7), dtype=np.int64)
    got = _t(tmod.rust_rem(torch.as_tensor(x), m))
    np.testing.assert_array_equal(got, _j(jmod.rust_rem(jnp.asarray(x), m)))
    np.testing.assert_array_equal(got, np.fmod(x, m))
    assert (got[x < 0] <= 0).all()  # truncated, not floored


@pytest.mark.parametrize("m", [433, M31])
def test_mod_sum_matches_reference(m):
    rng = np.random.default_rng(2)
    x = rng.integers(-(m - 1), m, size=(64, 23), dtype=np.int64)
    got = _t(tmod.mod_sum(torch.as_tensor(x), m, axis=0))
    np.testing.assert_array_equal(got, _j(jmod.mod_sum_jnp(jnp.asarray(x), m, axis=0)))


@pytest.mark.parametrize("rows", [1, 2, 7, 64])
def test_mod_sum_wide_61bit_matches_reference(rows):
    rng = np.random.default_rng(rows)
    x = rng.integers(-(M61 - 1), M61, size=(rows, 9), dtype=np.int64)
    got = _t(tmod.mod_sum_wide(torch.as_tensor(x), M61, axis=0))
    np.testing.assert_array_equal(
        got, _j(jmod.mod_sum_wide_jnp(jnp.asarray(x), M61, axis=0))
    )
    want = [sum(int(v) for v in x[:, j]) % M61 for j in range(x.shape[1])]
    np.testing.assert_array_equal(tmod.positive(got, M61), want)


@pytest.mark.parametrize("m,rows", [(M31, 50), (M61, 5), (M61, 300)])
def test_mod_sum_auto_matches_reference(m, rows):
    rng = np.random.default_rng(rows)
    x = rng.integers(-(m - 1), m, size=(rows, 4, 6), dtype=np.int64)
    got = tmod.mod_sum_auto(torch.as_tensor(x), m, axis=1)
    want = jmod.mod_sum_auto_jnp(jnp.asarray(x), m, axis=1)
    np.testing.assert_array_equal(
        _t(tmod.positive(got, m)), jmod.positive(_j(want), m)
    )


def test_mixed_sign_residue_equality_across_paths():
    """Narrow and wide sums agree on residues, not on signed representatives."""
    rng = np.random.default_rng(7)
    m = (1 << 55) - 55
    x = torch.as_tensor(rng.integers(-(m - 1), m, size=(64, 23), dtype=np.int64))
    narrow = tmod.mod_sum(x, m, axis=0)
    wide = tmod.mod_sum_wide(x, m, axis=0)
    want = [sum(int(v) for v in x[:, j]) % m for j in range(x.shape[1])]
    np.testing.assert_array_equal(_t(tmod.positive(narrow, m)), want)
    np.testing.assert_array_equal(_t(tmod.positive(wide, m)), want)
    assert not torch.equal(narrow, wide)


@pytest.mark.parametrize("m", [433, M31])
def test_modmatmul_matches_reference(m):
    rng = np.random.default_rng(3)
    A = rng.integers(-(m - 1), m, size=(13, 11), dtype=np.int64)
    B = rng.integers(0, m, size=(11, 5), dtype=np.int64)
    got = _t(tmod.modmatmul(torch.as_tensor(A), torch.as_tensor(B), m))
    np.testing.assert_array_equal(got, _j(jmod.modmatmul_jnp(jnp.asarray(A), jnp.asarray(B), m)))


@pytest.mark.parametrize("m", [433, M31, M61])
def test_host_half_copied_exactly(m):
    rng = np.random.default_rng(4)
    A = rng.integers(-(m - 1), m, size=(6, 5), dtype=np.int64)
    B = rng.integers(0, m, size=(5, 3), dtype=np.int64)
    np.testing.assert_array_equal(tmod.modmatmul_np(A, B, m), jmod.modmatmul_np(A, B, m))
    np.testing.assert_array_equal(
        tmod.mod_sum_wide_np(A, m, axis=0), jmod.mod_sum_wide_np(A, m, axis=0)
    )
    for v in (-7, 0, 12345):
        assert tmod.rust_rem_int(v, m) == jmod.rust_rem_int(v, m)
        assert tmod.positive(tmod.rust_rem_int(v, m), m) == v % m


def test_positive_on_tensor_numpy_and_int():
    x = np.array([-5, 0, 4], dtype=np.int64)
    np.testing.assert_array_equal(_t(tmod.positive(torch.as_tensor(x), 7)), [2, 0, 4])
    np.testing.assert_array_equal(tmod.positive(x, 7), [2, 0, 4])
    assert tmod.positive(-1, 7) == 6


@pytest.mark.parametrize(
    "k,t,n,bits,seed",
    [(5, 2, 8, 30, 0), (3, 4, 8, 60, 1), (2, 1, 26, 30, 0), (3, 4, 8, 24, 5), (1, 2, 2, 20, 3)],
)
def test_find_packed_parameters_matches_reference(k, t, n, bits, seed):
    got = tparams.find_packed_parameters(k, t, n, min_modulus_bits=bits, seed=seed)
    assert got == jparams.find_packed_parameters(k, t, n, min_modulus_bits=bits, seed=seed)


def test_bench_parameters():
    p, _, _ = tparams.find_packed_parameters(5, 2, 8, min_modulus_bits=30, seed=0)
    assert p == 1073741833 and p.bit_length() == 31


def test_is_prime_matches_reference():
    cands = list(range(0, 3000)) + [M31, M61, (1 << 30) + 3, 1073741833, 433 * 439]
    assert [tparams.is_prime(c) for c in cands] == [jparams.is_prime(c) for c in cands]


def _bench_pair():
    p, w2, w3 = tparams.find_packed_parameters(5, 2, 8, min_modulus_bits=30, seed=0)
    return PackedShamirSharing(5, 8, 2, p, w2, w3), JPacked(5, 8, 2, p, w2, w3)


def _basic_pair():
    p = (1 << 30) + 3
    while not tparams.is_prime(p):
        p += 2
    return BasicShamirSharing(6, 2, p), JBasic(share_count=6, privacy_threshold=2, prime_modulus=p)


SCHEMES = {
    "packed433": lambda: (PackedShamirSharing(3, 8, 4, 433, 354, 150), JPacked(3, 8, 4, 433, 354, 150)),
    "basic30": _basic_pair,
    "bench31": _bench_pair,
}


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_share_and_reconstruction_matrices_match_reference(name):
    ours, ref = SCHEMES[name]()
    assert ours.reconstruction_threshold == ref.reconstruction_threshold
    assert ours.input_size == ref.input_size and ours.output_size == ref.output_size
    np.testing.assert_array_equal(tshamir.share_matrix(ours), jshamir.share_matrix(ref))
    n, R = ours.share_count, ours.reconstruction_threshold
    for idx in (list(range(R)), list(range(n - R, n)), list(range(1, n))):
        np.testing.assert_array_equal(
            tshamir.reconstruction_matrix(ours, idx), jshamir.reconstruction_matrix(ref, idx)
        )
    rng = np.random.default_rng(5)
    p = ours.prime_modulus
    sums = rng.integers(0, p, size=(n, 9), dtype=np.int64)
    idx = list(range(1, 1 + R))
    np.testing.assert_array_equal(
        tshamir.reconstruct_clerk_sums_host(sums, idx, ours, 9 * ours.input_size - 1),
        jshamir.reconstruct_clerk_sums_host(sums, idx, ref, 9 * ref.input_size - 1),
    )
    with pytest.raises(ValueError):
        tshamir.reconstruction_matrix(ours, list(range(R - 1)))


@pytest.mark.parametrize("kwargs", [dict(share_count=3, privacy_threshold=3, prime_modulus=433),
                                    dict(share_count=500, privacy_threshold=2, prime_modulus=433)])
def test_basic_scheme_validation_matches_reference(kwargs):
    with pytest.raises(ValueError):
        JBasic(**kwargs)
    with pytest.raises(ValueError):
        BasicShamirSharing(**kwargs)


@pytest.mark.parametrize("nbits", [0, 63])
def test_uniform_bits_range_checks(nbits):
    from jax import random

    from sda_tpu.ops.rng import uniform_bits_device

    with pytest.raises(ValueError):
        uniform_bits_device(random.key(0), (2,), nbits)
    with pytest.raises(ValueError):
        trng.uniform_bits_device(torch.Generator().manual_seed(0), (2,), nbits)


@pytest.mark.parametrize("nbits", [0, 32])
def test_uniform_bits_narrow_range_checks(nbits):
    from jax import random

    from sda_tpu.ops.rng import uniform_bits_device_narrow

    with pytest.raises(ValueError):
        uniform_bits_device_narrow(random.key(0), (2,), nbits)
    with pytest.raises(ValueError):
        trng.uniform_bits_device_narrow(torch.Generator().manual_seed(0), (2,), nbits)


@pytest.mark.parametrize("m", [433, 1073741833, M61])
def test_uniform_mod_device_range_and_seeding(m):
    draw = trng.uniform_mod_device(torch.Generator().manual_seed(3), (4000,), m)
    again = trng.uniform_mod_device(torch.Generator().manual_seed(3), (4000,), m)
    assert draw.dtype == torch.int64 and torch.equal(draw, again)
    assert int(draw.min()) >= 0 and int(draw.max()) < m
    # a uniform draw over [0, m) reaches both halves of the range
    assert int((draw < m // 2).sum()) in range(1000, 3000)
    with pytest.raises(ValueError):
        trng.uniform_mod_device(torch.Generator(), (2,), 0)


@pytest.mark.parametrize("nbits,narrow", [(30, True), (31, True), (8, False), (60, False)])
def test_uniform_bits_device_range(nbits, narrow):
    fn = trng.uniform_bits_device_narrow if narrow else trng.uniform_bits_device
    draw = fn(torch.Generator().manual_seed(1), (3, 2000), nbits)
    assert draw.dtype == (torch.int32 if narrow else torch.int64)
    assert draw.shape == (3, 2000)
    assert int(draw.min()) >= 0 and int(draw.max()) < (1 << nbits)
    assert int(draw.max()) >= (1 << (nbits - 1))  # the top bit is drawn
