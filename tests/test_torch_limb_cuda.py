"""The fused limb share-and-reduce (K1) against ``participant_limb_sums_pallas``
in interpret mode on the CPU. The CUDA kernel itself runs only on a GPU
(``chip_smoke.py`` holds it bit-identical to the plain version there); here
the wrapper's CPU path, its guards and the packed stack layout the kernel
reads are checked. Exact equality throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from sda_tpu.ops import find_packed_parameters
from sda_tpu.ops.jaxcfg import ensure_x64
from sda_tpu.parallel.engine import make_plan as jmake_plan
from sda_tpu.parallel.limb_pallas import (
    participant_limb_sums_pallas,
    share_combine_limb_pallas,
)
from sda_tpu.protocol import PackedShamirSharing as JPacked
from sda_tpu_torch.parallel import limb_cuda
from sda_tpu_torch.parallel.engine import make_plan
from sda_tpu_torch.parallel.limbmatmul import fold_const_limbs
from sda_tpu_torch.protocol import PackedShamirSharing

ensure_x64()

P_BENCH, W2, W3 = find_packed_parameters(5, 2, 8, min_modulus_bits=30, seed=0)


def _bench_stacks():
    from sda_tpu.ops.shamir import share_matrix

    S = share_matrix(JPacked(5, 8, 2, P_BENCH, W2, W3))
    return fold_const_limbs(S.T, P_BENCH)  # (5, 35, 8)


@pytest.mark.parametrize("P", [500, 37])
def test_plain_version_matches_pallas_interpret(P):
    stacks = _bench_stacks()
    nb, K = -(-23 // 5), 7  # dim = 23: pad path
    rng = np.random.default_rng(P)
    values = rng.integers(0, P_BENCH, size=(P, nb, K)).astype(np.int32)
    want = np.asarray(participant_limb_sums_pallas(jnp.asarray(values), stacks))
    before = limb_cuda.launches
    got = limb_cuda.participant_limb_sums_cuda(
        torch.as_tensor(values), torch.as_tensor(stacks)
    )
    assert limb_cuda.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.int32 and got.shape == (5, nb, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P", [500, 37])
def test_share_combine_limb_cuda_matches_pallas(P):
    scheme_j = JPacked(5, 8, 2, P_BENCH, W2, W3)
    scheme_t = PackedShamirSharing(5, 8, 2, P_BENCH, W2, W3)
    dim = 23
    rng = np.random.default_rng(17 + P)
    secrets = rng.integers(0, P_BENCH, size=(P, dim)).astype(np.int64)
    rand = rng.integers(0, P_BENCH, size=(P, -(-dim // 5), 2)).astype(np.int64)
    want = np.asarray(
        share_combine_limb_pallas(
            jnp.asarray(secrets), random.key(0), jmake_plan(scheme_j, dim),
            draw=lambda key, shape, p: jnp.asarray(rand),
        )
    )
    got = limb_cuda.share_combine_limb_cuda(
        torch.as_tensor(secrets), None, make_plan(scheme_t, dim, device="cpu"),
        draw=lambda gen, shape, p: torch.as_tensor(rand),
    )
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_overflow_guard_raises():
    stacks = _bench_stacks()
    C = (1 << 31) // (35 * 127 * 127) + 1  # C*L*K*127^2 >= 2^31
    values = np.zeros((C, 1, 7), dtype=np.int32)
    with pytest.raises(ValueError, match="overflows int32"):
        participant_limb_sums_pallas(jnp.asarray(values), stacks)
    with pytest.raises(ValueError, match="overflows int32"):
        limb_cuda.participant_limb_sums_cuda(torch.as_tensor(values), torch.as_tensor(stacks))
    # one participant fewer fits
    out = limb_cuda.participant_limb_sums_torch(
        torch.as_tensor(values[:-1]), torch.as_tensor(stacks)
    )
    assert out.shape == (5, 1, 8)


def test_wide_field_rejected():
    from sda_tpu_torch.ops import find_packed_parameters as tfind

    p, w2, w3 = tfind(3, 4, 8, min_modulus_bits=60, seed=1)
    plan = make_plan(PackedShamirSharing(3, 8, 4, p, w2, w3), 6, device="cpu")
    with pytest.raises(ValueError, match="narrow-field"):
        limb_cuda.share_combine_limb_cuda(torch.zeros((2, 6), dtype=torch.int64), None, plan)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel or raises: here a meta tensor
    (no data, no device) is refused before any launch."""
    stacks = torch.as_tensor(_bench_stacks())
    values = torch.empty((4, 3, 7), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        limb_cuda.participant_limb_sums_cuda(values, stacks)


def _emulate_kernel(values: np.ndarray, packed: np.ndarray, L: int, n: int) -> np.ndarray:
    """numpy model of limb_share_sum.cu's arithmetic over the packed layout:
    per value, words w0 = limbs 0..3 as bytes and w1 = limb 4; each (m, clerk)
    term is two signed-byte dot products (__dp4a) against the packed stacks."""
    C, nb, K = values.shape
    x = values.astype(np.int64)
    w0 = (x & 0x7F) | ((x << 1) & 0x7F00) | ((x << 2) & 0x7F0000) | ((x << 3) & 0x7F000000)
    w1 = (x >> 28) & 0x7F
    words = np.stack([w0, w1], axis=-1).astype(np.uint32)  # (C, nb, K, 2)
    a_bytes = words.view(np.uint8).reshape(C, nb, K, 8).astype(np.int8).astype(np.int64)
    s_bytes = packed.view(np.int8).astype(np.int64)  # (T, K, 5, 8, 8)
    T = s_bytes.shape[0]
    # out[m, b, t*8 + j] = sum_c sum_kk sum_byte a[c, b, kk, byte] * s[t, kk, m, j, byte]
    out = np.einsum("cbkx,tkmjx->mbtj", a_bytes, s_bytes).reshape(5, nb, T * 8)
    return out[:L, :, :n]


@pytest.mark.parametrize(
    "scheme_args,C,dim",
    [((5, 8, 2), 37, 23), ((5, 8, 2), 5, 100), ((2, 26, 1), 9, 31), ("p433", 11, 20)],
)
def test_packed_stack_layout_reproduces_plain_version(scheme_args, C, dim):
    from sda_tpu_torch.ops import find_packed_parameters as tfind

    if scheme_args == "p433":
        scheme = PackedShamirSharing(3, 8, 4, 433, 354, 150)
    else:
        k, n, t = scheme_args
        p, w2, w3 = tfind(k, t, n, min_modulus_bits=30, seed=0)
        scheme = PackedShamirSharing(k, n, t, p, w2, w3)
    plan = make_plan(scheme, dim, device="cpu")
    K = plan.input_size + plan.rand_size
    rng = np.random.default_rng(C)
    values = rng.integers(0, plan.modulus, size=(C, plan.n_batches, K)).astype(np.int32)
    packed = limb_cuda.pack_stacks(plan.limb_stacks)
    assert packed.dtype == torch.int32 and packed.is_contiguous()
    assert packed.shape == (-(-plan.share_count // 8), K, 5, 8, 2)
    L = plan.limb_stacks.shape[0]
    got = _emulate_kernel(values, packed.numpy(), L, plan.share_count)
    want = limb_cuda.participant_limb_sums_torch(torch.as_tensor(values), plan.limb_stacks)
    np.testing.assert_array_equal(got, want.numpy())
