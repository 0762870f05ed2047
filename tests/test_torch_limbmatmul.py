"""Parity of the port's limb-space products with ``sda_tpu.parallel.limbmatmul``
on the CPU. Exact equality: all of it is integer field arithmetic."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sda_tpu.ops.jaxcfg import ensure_x64
from sda_tpu.parallel import limbmatmul as jlimb
from sda_tpu_torch.parallel import limbmatmul as tlimb

ensure_x64()

M31 = (1 << 31) - 1
M61 = (1 << 61) - 1


@pytest.mark.parametrize("p", [433, 1073741833, M31, M61])
def test_limb_count_and_bounds_match(p):
    assert tlimb.limb_count(p) == jlimb.limb_count(p)
    L = tlimb.limb_count(p)
    assert tlimb._max_contraction(L) == jlimb._max_contraction(L)


def test_limb_modmatmul_exact():
    p = M31
    rng = np.random.default_rng(2)
    A = rng.integers(0, p, size=(33, 20), dtype=np.int64)
    B = rng.integers(0, p, size=(20, 9), dtype=np.int64)
    got = tlimb.limb_modmatmul(torch.as_tensor(A), torch.as_tensor(B), p).numpy()
    want = (A.astype(object) @ B.astype(object)) % p
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(
        got, np.asarray(jlimb.limb_modmatmul(jnp.asarray(A), jnp.asarray(B), p))
    )


@pytest.mark.parametrize("p", [433, M31])
def test_limb_partials_match_reference(p):
    rng = np.random.default_rng(8)
    A = rng.integers(0, p, size=(17, 6), dtype=np.int64)
    B = rng.integers(0, p, size=(6, 4), dtype=np.int64)
    got = tlimb.limb_partials(torch.as_tensor(A), torch.as_tensor(B), p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlimb.limb_partials(jnp.asarray(A), jnp.asarray(B), p))
    )
    np.testing.assert_array_equal(
        tlimb.limb_recombine(got, p).numpy(),
        np.asarray(jlimb.limb_recombine(jnp.asarray(got.numpy()), p)),
    )


def test_limb_modmatmul_const_exact():
    p = M31
    rng = np.random.default_rng(12)
    A = rng.integers(0, p, size=(33, 20), dtype=np.int64)
    B = rng.integers(0, p, size=(20, 9), dtype=np.int64)
    want = ((A.astype(object) @ B.astype(object)) % p).astype(np.int64)
    got = tlimb.limb_modmatmul_const(torch.as_tensor(A), B, p).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tlimb.limb_modmatmul(torch.as_tensor(A), torch.as_tensor(B), p).numpy()
    )
    np.testing.assert_array_equal(
        got, np.asarray(jlimb.limb_modmatmul_const(jnp.asarray(A), B, p))
    )
    # wide modulus: partials + host recombine stays exact
    Aw = rng.integers(0, M61, size=(9, 6), dtype=np.int64)
    Bw = rng.integers(0, M61, size=(6, 4), dtype=np.int64)
    stacks = tlimb.fold_const_limbs(Bw, M61)
    partials = tlimb.limb_partials_const(torch.as_tensor(Aw), stacks, M61)
    np.testing.assert_array_equal(
        partials.numpy(),
        np.asarray(jlimb.limb_partials_const(jnp.asarray(Aw), stacks, M61)),
    )
    got_w = tlimb.limb_recombine_host(partials, M61)
    want_w = ((Aw.astype(object) @ Bw.astype(object)) % M61).astype(np.int64)
    np.testing.assert_array_equal(got_w, want_w)


@pytest.mark.parametrize("p", [433, 1073741833, M61])
def test_fold_const_limbs_equal(p):
    rng = np.random.default_rng(p % 1000)
    B = rng.integers(0, p, size=(7, 8), dtype=np.int64)
    got = tlimb.fold_const_limbs(B, p)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, jlimb.fold_const_limbs(B, p))


def test_exactness_guards_raise():
    p = M31
    L = tlimb.limb_count(p)
    too_wide = tlimb._max_contraction(L) + 1
    with pytest.raises(ValueError, match="overflows int32"):
        tlimb.limb_partials(torch.zeros((1, too_wide), dtype=torch.int64),
                            torch.zeros((too_wide, 1), dtype=torch.int64), p)
    # stacks contraction L*K with L*K*127^2 >= 2^31
    K = (1 << 31) // (127 * 127) // L + 1
    stacks = np.zeros((L, L * K, 2), dtype=np.int8)
    with pytest.raises(ValueError, match="overflows int32"):
        tlimb.limb_partials_const(torch.zeros((1, K), dtype=torch.int64), stacks, p)
    with pytest.raises(ValueError, match="A contraction"):
        tlimb.limb_partials_const(torch.zeros((1, K + 1), dtype=torch.int64), stacks, p)
    # int64 recombine bound L * L*K*127^2 * (p-1) >= 2^63, int32 bound still met
    K = 11_000
    with pytest.raises(ValueError, match="int64 recombine"):
        tlimb.limb_modmatmul_const(torch.zeros((1, K), dtype=torch.int64),
                                   np.zeros((K, 1), dtype=np.int64), p)
    with pytest.raises(ValueError, match="p < 2\\^31"):
        tlimb.limb_modmatmul_const(torch.zeros((1, 2), dtype=torch.int64),
                                   np.zeros((2, 2), dtype=np.int64), M61)
    with pytest.raises(ValueError, match="p < 2\\^31"):
        tlimb.limb_recombine(torch.zeros((3, 2), dtype=torch.int32), M61)


def test_int_dot_slices_exactly():
    """The sliced broadcast dot equals a float64 product (exact here)."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 128, size=(1000, 35))
    b = rng.integers(0, 128, size=(35, 8))
    want = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64)
    old = tlimb._DOT_SLICE_ELEMS
    try:
        tlimb._DOT_SLICE_ELEMS = 35 * 8 * 7  # 7 rows per slice, ragged tail
        got = tlimb._int_dot(torch.as_tensor(a), torch.as_tensor(b))
    finally:
        tlimb._DOT_SLICE_ELEMS = old
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
