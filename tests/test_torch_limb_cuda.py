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




def test_two_input_entry_never_takes_the_plain_version_off_the_cpu():
    stacks = torch.as_tensor(_bench_stacks())
    secrets = torch.empty((4, 23), dtype=torch.int32, device="meta")
    rand = torch.empty((4, 5, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        limb_cuda.share_limb_sums_cuda(secrets, rand, stacks, 5)


def test_stacks_are_packed_once_per_stacks_tensor():
    stacks = torch.as_tensor(_bench_stacks())
    first = limb_cuda.packed_stacks(stacks)
    assert limb_cuda.packed_stacks(stacks) is first
    assert torch.equal(first, limb_cuda.pack_stacks(stacks))
    assert first.dtype == torch.int32 and first.shape == (1, 1, 5, 5, 32, 2)
    other = stacks.clone()
    assert limb_cuda.packed_stacks(other) is not first


def _jax_scheme_stacks(k, t, n):
    from sda_tpu.ops.shamir import share_matrix

    p, w2, w3 = find_packed_parameters(k, t, n, min_modulus_bits=30, seed=0)
    return p, fold_const_limbs(share_matrix(JPacked(k, n, t, p, w2, w3)).T, p)


@pytest.mark.parametrize(
    "scheme_args,P,dim",
    [((5, 2, 8), 500, 23), ((5, 2, 8), 37, 1003), ((10, 5, 26), 37, 31)],
)
def test_two_input_plain_version_matches_pallas_interpret(scheme_args, P, dim):
    """The two-input entry's plain version against the reference kernel on
    the concatenated values, at dims with a ragged tail (d % k != 0)."""
    k, t, n = scheme_args
    p, stacks = _jax_scheme_stacks(k, t, n)
    nb = -(-dim // k)
    assert dim % k != 0
    rng = np.random.default_rng(P + dim)
    secrets = rng.integers(0, p, size=(P, dim)).astype(np.int32)
    rand = rng.integers(0, p, size=(P, nb, t)).astype(np.int32)
    values = np.concatenate(
        [np.pad(secrets, ((0, 0), (0, nb * k - dim))).reshape(P, nb, k), rand], axis=-1
    )
    want = np.asarray(participant_limb_sums_pallas(jnp.asarray(values), stacks))
    before = limb_cuda.launches
    got = limb_cuda.share_limb_sums_cuda(
        torch.as_tensor(secrets), torch.as_tensor(rand), torch.as_tensor(stacks), k
    )
    assert limb_cuda.launches == before
    assert got.dtype == torch.int32 and got.shape == (stacks.shape[0], nb, n)
    np.testing.assert_array_equal(got.numpy(), want)


# -- a numpy model of csrc/limb_share_sum.cu ----------------------------------
# It follows the kernel's arithmetic step by step: the shared-memory chunk of
# each participant as load_stage fills it (zero past d and nb, a zero word at
# the end), each lane's word offsets per A slot, the __byte_perm transpose and
# limb masks on uint32 words, and mma.sync.m16n8k32 on the PTX fragment
# layouts against pack_stacks' B fragments. Only the split of participants
# across blocks is left out: the kernel's atomicAdd makes it a plain sum.

_ROWS = 16  # kRows: one warp's mma row tile per block
_LANE = np.arange(32)
_G, _Q = _LANE // 4, _LANE % 4


def _u32(x):
    return np.asarray(x, dtype=np.int64).astype(np.uint32)


def _byte_perm(a, b, sel):
    """__byte_perm(a, b, sel) on uint32 arrays (no sign-replicate mode)."""
    src = np.stack([_u32(a), _u32(b)], -1).view(np.uint8).reshape(np.shape(a) + (8,))
    picked = src[..., [(sel >> (4 * i)) & 7 for i in range(4)]]
    return np.ascontiguousarray(picked).view(np.uint32)[..., 0]


def _transpose4(x):
    """transpose4: x (..., 4) values -> (..., 4) words, word j holding byte j
    of x_e in byte e."""
    x0, x1, x2, x3 = (x[..., e] for e in range(4))
    t0, t1 = _byte_perm(x0, x1, 0x5140), _byte_perm(x2, x3, 0x5140)
    t2, t3 = _byte_perm(x0, x1, 0x7362), _byte_perm(x2, x3, 0x7362)
    return np.stack([_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
                     _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)], -1)


def _limb_word(B, i):
    B = [B[..., j] for j in range(4)]
    if i == 0:
        return B[0] & np.uint32(0x7F7F7F7F)
    if i == 4:
        return (B[3] >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    lo_mask = np.uint32((1 << i) - 1) * np.uint32(0x01010101)
    hi_mask = np.uint32(0x7F7F7F7F) & ~lo_mask
    return ((B[i - 1] >> np.uint32(8 - i)) & lo_mask) | ((B[i] << np.uint32(i)) & hi_mask)


def _mma_m16n8k32(a, b):
    """One mma.sync.m16n8k32 s8 -> s32 warp step: A registers (32, 4) and B
    registers (32, 2) as uint32 -> D registers (32, 4), via the PTX fragment
    layouts (A: reg r is row g + 8*(r & 1), slots 4q + 16*(r >> 1) + byte;
    B: reg r is slots 4q + 16r + byte, column g; D: reg r is row
    g + 8*(r >> 1), column 2q + (r & 1))."""
    ab = _u32(a).view(np.int8).reshape(32, 4, 4).astype(np.int64)
    bb = _u32(b).view(np.int8).reshape(32, 2, 4).astype(np.int64)
    A = np.zeros((16, 32), np.int64)
    Bm = np.zeros((32, 8), np.int64)
    for e in range(4):
        for r in range(4):
            A[_G + 8 * (r & 1), 4 * _Q + 16 * (r >> 1) + e] = ab[:, r, e]
        for r in range(2):
            Bm[4 * _Q + 16 * r + e, _G] = bb[:, r, e]
    D = A @ Bm
    return np.stack([D[_G + 8 * (r >> 1), 2 * _Q + (r & 1)] for r in range(4)], -1)


def _emulate_kernel(secrets, randomness, k, packed, L, n):
    C, d = secrets.shape
    t = randomness.shape[2]
    nb, K = -(-d // k), k + t
    Kp, pps, kps = limb_cuda.kernel_geometry(K)
    ps = 2 * pps if Kp <= 32 else 1  # participants per stage
    slot = 16 * np.arange(2)[:, None] + 4 * _Q  # (h, lane)
    pofs = slot // Kp if Kp <= 32 else np.zeros_like(slot)
    kk0 = slot % Kp if Kp <= 32 else slot
    C_pad = -(-C // ps) * ps
    out = np.zeros((L, nb, n), np.int64)
    for b0 in range(0, nb, _ROWS):
        chunk = np.zeros((C_pad, _ROWS * K + 4), np.int64)
        sec_valid = min(_ROWS * k, d - b0 * k)
        chunk[:C, :sec_valid] = secrets[:, b0 * k : b0 * k + sec_valid]
        rnd_valid = min(_ROWS, nb - b0) * t
        chunk[:C, _ROWS * k : _ROWS * k + rnd_valid] = randomness[:, b0 : b0 + _ROWS].reshape(C, -1)
        for tile in range(packed.shape[0]):
            for warp in range(_ROWS // 16):
                rows = np.stack([16 * warp + _G, 16 * warp + _G + 8])  # (r, lane)
                acc = np.zeros((L, 32, 4), np.int64)
                for st in range(C_pad // ps):
                    for sl in range(kps):
                        kk = kk0[:, None, :, None] + 32 * sl + np.arange(4)  # (h, 1, lane, e)
                        r = rows[None, :, :, None]
                        off = np.where(kk < k, r * k + kk,
                                       np.where(kk < K, _ROWS * k + r * t + (kk - k), _ROWS * K))
                        for j in range(ps // pps):
                            p = st * ps + j * pps + pofs  # (h, lane)
                            words = _transpose4(chunk[p[:, None, :, None], off])  # (h, r, lane, 4)
                            for i in range(L):
                                a = np.stack([_limb_word(words[h, r], i)
                                              for h in range(2) for r in range(2)], -1)
                                for m in range(L):
                                    acc[m] += _mma_m16n8k32(a, packed[tile, sl, m, i])
                for m in range(L):
                    for reg in range(4):
                        b = b0 + rows[reg >> 1]
                        j = 8 * tile + 2 * _Q + (reg & 1)
                        ok = (b < nb) & (j < n)
                        np.add.at(out[m], (b[ok], j[ok]), acc[m, ok, reg])
    return out


def _scheme_case(args, C, dim):
    from sda_tpu_torch.ops import find_packed_parameters as tfind

    if args == "p433":
        scheme = PackedShamirSharing(3, 8, 4, 433, 354, 150)
    elif args == "basic":  # the ladder's config 3: k=1, K=3, L=3, n=5
        from sda_tpu_torch.protocol import BasicShamirSharing

        scheme = BasicShamirSharing(share_count=5, privacy_threshold=2, prime_modulus=1048583)
    else:
        k, n, t = args
        p, w2, w3 = tfind(k, t, n, min_modulus_bits=30, seed=0)
        scheme = PackedShamirSharing(k, n, t, p, w2, w3)
    plan = make_plan(scheme, dim, device="cpu")
    rng = np.random.default_rng(C + dim)
    secrets = rng.integers(0, plan.modulus, size=(C, dim)).astype(np.int32)
    rand = rng.integers(0, plan.modulus, size=(C, plan.n_batches, plan.rand_size)).astype(np.int32)
    return secrets, rand, plan.limb_stacks, plan.input_size


def _synthetic_case(C, dim, k, t, n, L):
    """Random stacks (0..127) and values below 2^(7L): K = k + t past 32
    takes the kernel's kk slices (Kp > 32)."""
    rng = np.random.default_rng(C * dim)
    stacks = torch.as_tensor(rng.integers(0, 128, size=(L, L * (k + t), n)).astype(np.int8))
    secrets = rng.integers(0, 1 << (7 * L), size=(C, dim)).astype(np.int32)
    rand = rng.integers(0, 1 << (7 * L), size=(C, -(-dim // k), t)).astype(np.int32)
    return secrets, rand, stacks, k


@pytest.mark.parametrize(
    "case",
    [
        lambda: _scheme_case((5, 8, 2), 37, 23),
        lambda: _scheme_case((5, 8, 2), 5, 100),
        lambda: _scheme_case((2, 26, 1), 9, 31),
        lambda: _scheme_case("p433", 11, 20),
        lambda: _scheme_case((10, 26, 5), 9, 31),
        lambda: _scheme_case((5, 8, 2), 3, 703),
        lambda: _synthetic_case(3, 70, 30, 7, 11, 3),
        lambda: _scheme_case("basic", 21, 37),
        lambda: _scheme_case("basic", 100, 40),
    ],
    ids=["bench-dim23", "bench-dim100", "n26-4tiles", "p433-L2", "K15-n26",
         "bench-9-row-blocks", "K37-kk-slices", "basic-K3-n5", "basic-K3-n5-100-rows"],
)
def test_kernel_model_reproduces_plain_version(case):
    secrets, rand, stacks, k = case()
    L, LK, n = stacks.shape
    packed = limb_cuda.pack_stacks(stacks)
    Kp, _, kps = limb_cuda.kernel_geometry(LK // L)
    assert packed.dtype == torch.int32 and packed.is_contiguous()
    assert packed.shape == (-(-n // 8), kps, L, L, 32, 2)
    got = _emulate_kernel(secrets, rand, k, packed.numpy(), L, n)
    want = limb_cuda.share_limb_sums_torch(
        torch.as_tensor(secrets), torch.as_tensor(rand), stacks, k
    )
    np.testing.assert_array_equal(got, want.numpy())


def test_kernel_model_one_tensor_form():
    """participant_limb_sums_cuda launches the kernel with secrets = values
    viewed (C, nb*K), k = K and no randomness."""
    stacks = torch.as_tensor(_bench_stacks())
    rng = np.random.default_rng(3)
    values = rng.integers(0, P_BENCH, size=(13, 9, 7)).astype(np.int32)
    got = _emulate_kernel(values.reshape(13, 63), np.zeros((13, 9, 0), np.int32), 7,
                          limb_cuda.pack_stacks(stacks).numpy(), 5, 8)
    want = limb_cuda.participant_limb_sums_torch(torch.as_tensor(values), stacks)
    np.testing.assert_array_equal(got, want.numpy())
