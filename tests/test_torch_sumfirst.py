"""The port's sum-first engine against ``sda_tpu.parallel.sumfirst`` on the CPU.

Mirrors tests/test_sumfirst.py. Randomness is held equal through the draw
hooks: one host-drawn array goes to the reference's ``draw=`` /
``draw_pair=`` and to the port's. Every result is an integer field element
or an exact integer sum, so every comparison is exact (tolerance zero).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from sda_tpu.ops.jaxcfg import ensure_x64
from sda_tpu.ops.modular import positive
from sda_tpu.parallel import engine as jeng
from sda_tpu.parallel import sumfirst as jsf
from sda_tpu.parallel.limbmatmul import limb_recombine_host
from sda_tpu.protocol import PackedShamirSharing as JPacked
from sda_tpu_torch import bench
from sda_tpu_torch.ops import find_packed_parameters
from sda_tpu_torch.ops import rng as trng
from sda_tpu_torch.parallel import engine as teng
from sda_tpu_torch.parallel import sumfirst as tsf
from sda_tpu_torch.protocol import PackedShamirSharing

ensure_x64()

CPU = "cpu"
MASK32 = (1 << 32) - 1


def _p433():
    return PackedShamirSharing(3, 8, 4, 433, 354, 150), JPacked(3, 8, 4, 433, 354, 150)


def _wide61():
    p, w2, w3 = find_packed_parameters(3, 4, 8, min_modulus_bits=60, seed=1)
    return PackedShamirSharing(3, 8, 4, p, w2, w3), JPacked(3, 8, 4, p, w2, w3)


def _bench(bits):
    p, w2, w3 = find_packed_parameters(5, 2, 8, min_modulus_bits=bits, seed=0)
    return PackedShamirSharing(5, 8, 2, p, w2, w3), JPacked(5, 8, 2, p, w2, w3)


SCHEMES = pytest.mark.parametrize("scheme_fn", [_p433, _wide61], ids=["p433", "wide61"])


def _plans(scheme_fn, dim):
    ours, ref = scheme_fn()
    return ours, ref, teng.make_plan(ours, dim, CPU), jeng.make_plan(ref, dim)


def _hooks(arr):
    """The same host array as a draw for both packages."""
    return (lambda key, shape, p: jnp.asarray(arr)), (lambda gen, shape, p: torch.as_tensor(arr))


def _plain_sum(secrets, p):
    return np.array([sum(int(v) for v in secrets[:, j]) % p for j in range(secrets.shape[1])],
                    dtype=np.int64)


def _i32(words):
    """uint32 words (held in int64) as int32 bit patterns, the port's form."""
    return torch.as_tensor((np.asarray(words) & MASK32).astype(np.uint32).view(np.int32))


@SCHEMES
def test_bit_identical_to_per_participant_path(scheme_fn):
    """Sum-first clerk sums equal per-participant sharing + combine (the
    port's and the reference's) and the reference's sum-first composition,
    for the same draws."""
    dim = 14  # pad path: 14 = 3*4 + 2
    ours, ref, tplan, jplan = _plans(scheme_fn, dim)
    p = ours.prime_modulus
    rng = np.random.default_rng(3)
    secrets = rng.integers(p - 100, p, size=(21, dim)).astype(np.int64)
    rand = rng.integers(0, p, size=(21, tplan.n_batches, tplan.rand_size)).astype(np.int64)
    jdraw, tdraw = _hooks(rand)

    got = tsf.clerk_sums_sum_first(torch.as_tensor(secrets), None, tplan, draw=tdraw)
    jacc = jsf.value_limb_sums_chunk(jnp.asarray(secrets), random.key(5), jplan, draw=jdraw)
    want_sf, _ = jsf.clerk_sums_from_limb_acc(np.asarray(jacc), jplan)
    np.testing.assert_array_equal(got, want_sf)

    if p < (1 << 31):
        shares = teng.share_participants(torch.as_tensor(secrets), None, tplan, draw=tdraw)
        want = positive(teng.clerk_combine_mod(shares, p).numpy(), p)
        jshares = jeng.share_participants(jnp.asarray(secrets), random.key(5), jplan, draw=jdraw)
        jwant = positive(np.asarray(jeng.clerk_combine(jshares)) % p, p)
    else:
        acc = teng.share_combine_limb(torch.as_tensor(secrets), None, tplan, draw=tdraw)
        want = limb_recombine_host(acc, p).T
        jacc = jeng.share_combine_limb(jnp.asarray(secrets), random.key(5), jplan, draw=jdraw)
        jwant = limb_recombine_host(np.asarray(jacc), p).T
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jwant)


@SCHEMES
def test_chunked_accumulation_reconstructs_plain_sum(scheme_fn):
    """The streamed shape: exact limb sums accumulated over chunks with plain
    +, one host epilogue, a reconstruction from a dropout subset; the
    accumulator, clerk sums and value sums equal the reference's."""
    dim = 9
    ours, ref, tplan, jplan = _plans(scheme_fn, dim)
    p = ours.prime_modulus
    rng = np.random.default_rng(11)
    chunks = [rng.integers(0, p, size=(13, dim)).astype(np.int64) for _ in range(4)]
    rands = [rng.integers(0, p, size=(13, tplan.n_batches, tplan.rand_size)).astype(np.int64)
             for _ in range(4)]

    acc = jacc = None
    for chunk, rand in zip(chunks, rands):
        jdraw, tdraw = _hooks(rand)
        s = tsf.value_limb_sums_chunk(torch.as_tensor(chunk), None, tplan, draw=tdraw)
        j = np.asarray(jsf.value_limb_sums_chunk(jnp.asarray(chunk), random.key(0), jplan, draw=jdraw))
        np.testing.assert_array_equal(s.numpy(), j)
        acc = s if acc is None else acc + s
        jacc = j if jacc is None else jacc + j

    clerk_sums, vsums = tsf.clerk_sums_from_limb_acc(acc, tplan)
    jclerk, jvsums = jsf.clerk_sums_from_limb_acc(jacc, jplan)
    np.testing.assert_array_equal(clerk_sums, jclerk)
    np.testing.assert_array_equal(vsums, jvsums)
    indices = list(range(1, 1 + ours.reconstruction_threshold))
    out = tsf.reconstruct_from_clerk_sums(clerk_sums, indices, ours, dim)
    want = _plain_sum(np.concatenate(chunks), p)
    np.testing.assert_array_equal(positive(np.asarray(out), p), want)
    np.testing.assert_array_equal(
        positive(np.asarray(out), p),
        positive(np.asarray(jsf.reconstruct_from_clerk_sums(jclerk, indices, ref, dim)), p),
    )
    k = ours.secret_count
    np.testing.assert_array_equal(vsums[:, :k].reshape(-1)[:dim], want)


def test_rejects_oversized_chunk():
    ours, _ = _p433()
    plan = teng.make_plan(ours, 3, CPU)

    class FakeShaped:
        shape = (tsf.MAX_PARTICIPANTS + 1, 3)

    with pytest.raises(ValueError, match="exact bound"):
        tsf.clerk_sums_sum_first(FakeShaped(), None, plan)


def test_exact_sum_narrow_matches_int64():
    """The int32 narrow reduction equals plain int64 sums and the
    reference's, at the value bound (2^31 - 1) and the row bound (2^15)."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, (1 << 31) - 1, size=(257, 33), dtype=np.int64)
    x[0, :] = (1 << 31) - 1
    got = tsf.exact_sum_narrow(torch.as_tensor(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), x.sum(axis=0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsf.exact_sum_narrow(jnp.asarray(x))))

    worst = np.full((tsf.MAX_NARROW_CHUNK, 3), (1 << 31) - 1, dtype=np.int64)
    np.testing.assert_array_equal(tsf.exact_sum_narrow(torch.as_tensor(worst)).numpy(), worst.sum(axis=0))

    with pytest.raises(ValueError, match="narrow reduction bound"):
        tsf.exact_sum_narrow(torch.zeros((tsf.MAX_NARROW_CHUNK + 1, 2), dtype=torch.int32))


def test_exact_sum_narrow_u32_on_high_words():
    """uint32 words >= 2^31 (negative as int32 patterns) sum exactly, equal to
    the reference's uint32 reduction, as int32 patterns or as int64 words."""
    rng = np.random.default_rng(6)
    words = rng.integers(1 << 31, 1 << 32, size=(301, 17), dtype=np.int64)
    words[0, :] = MASK32
    words[1, :] = 1 << 31
    want = words.sum(axis=0)
    got = tsf.exact_sum_narrow_u32(_i32(words))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tsf.exact_sum_narrow_u32(torch.as_tensor(words)).numpy(), want)
    ref = jsf.exact_sum_narrow_u32(jnp.asarray(words.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    worst = torch.full((tsf.MAX_NARROW_CHUNK, 2), -1, dtype=torch.int32)  # 2^32 - 1 each
    np.testing.assert_array_equal(tsf.exact_sum_narrow_u32(worst).numpy(), [MASK32 << 15] * 2)


def test_narrow_draws_match_wide():
    """uniform_bits_device_narrow gives the values of uniform_bits_device for
    the same generator state, as int32; the pair draw keeps hi within
    nbits - 32 bits and lo over all 32."""
    wide = trng.uniform_bits_device(torch.Generator().manual_seed(9), (64, 5), 30)
    narrow = trng.uniform_bits_device_narrow(torch.Generator().manual_seed(9), (64, 5), 30)
    assert narrow.dtype == torch.int32
    np.testing.assert_array_equal(narrow.numpy(), wide.numpy())

    hi, lo = trng.uniform_bits_device_pair(torch.Generator().manual_seed(9), (4000,), 60)
    assert hi.dtype == lo.dtype == torch.int32
    assert int(hi.min()) >= 0 and int(hi.max()) < (1 << 28) and int(hi.max()) >= (1 << 27)
    assert int(lo.min()) < -(1 << 30) and int(lo.max()) > (1 << 30)
    zero_hi, _ = trng.uniform_bits_device_pair(torch.Generator().manual_seed(9), (50,), 32)
    assert not zero_hi.any()
    for bad in (31, 63):
        with pytest.raises(ValueError, match="pair draw"):
            trng.uniform_bits_device_pair(torch.Generator(), (2,), bad)


def test_pair_chunk_matches_int64_chunk():
    """The (hi, lo) pair form of the wide hot loop gives the limb sums of the
    int64 form and of the reference's pair form for the same values and
    randomness."""
    ours, ref, tplan, jplan = _plans(_wide61, 14)  # pad path
    rng = np.random.default_rng(11)
    values = rng.integers(0, 1 << 60, size=(21, 14)).astype(np.int64)
    rand = rng.integers(0, 1 << 60, size=(21, tplan.n_batches, tplan.rand_size)).astype(np.int64)

    acc_int64 = tsf.value_limb_sums_chunk(torch.as_tensor(values), None, tplan,
                                          draw=lambda g, s, m: torch.as_tensor(rand))
    acc_pair = tsf.value_limb_sums_chunk_pair(
        _i32(values >> 32), _i32(values), None, tplan,
        draw_pair=lambda g, s: (_i32(rand >> 32), _i32(rand)),
    )
    ref_pair = jsf.value_limb_sums_chunk_pair(
        jnp.asarray((values >> 32).astype(np.uint32)), jnp.asarray((values & MASK32).astype(np.uint32)),
        random.key(0), jplan,
        draw_pair=lambda k, s: (jnp.asarray((rand >> 32).astype(np.uint32)),
                                jnp.asarray((rand & MASK32).astype(np.uint32))),
    )
    np.testing.assert_array_equal(acc_int64.numpy(), acc_pair.numpy())
    np.testing.assert_array_equal(acc_pair.numpy(), np.asarray(ref_pair))


@pytest.mark.parametrize("bits", [30, 60], ids=["quick31", "northstar61"])
def test_stream_matches_reference_chunks(bits):
    """``sda_tpu_torch.bench``'s sum-first stream (bench.py's body +
    finalize, which ``chip_smoke.py`` drives) at a small size on the CPU:
    its accumulator equals the reference's chunk functions fed the same
    draws, replayed from a generator with the same seed in the stream's
    order (secrets, then randomness), and its finalize returns the plain
    sum mod p."""
    ours, ref = _bench(bits)
    p = ours.prime_modulus
    nbits = p.bit_length() - 1
    dim, chunk, n_chunks = 23, 40, 3
    tplan, jplan = teng.make_plan(ours, dim, CPU), jeng.make_plan(ref, dim)
    step, acc, plain = bench.sumfirst_stream(tplan, dim, chunk, torch.Generator().manual_seed(7))
    for _ in range(n_chunks):
        acc, plain = step(acc, plain)

    replay = torch.Generator().manual_seed(7)
    rshape = (chunk, tplan.n_batches, tplan.rand_size)
    jacc, secrets = 0, []
    for _ in range(n_chunks):
        if bits < 32:
            s = trng.uniform_bits_device_narrow(replay, (chunk, dim), nbits).numpy()
            r = trng.uniform_bits_device_narrow(replay, rshape, nbits).numpy()
            jacc = jacc + np.asarray(jsf.value_limb_sums_chunk(
                jnp.asarray(s), random.key(0), jplan, draw=lambda k, sh, m, r=r: jnp.asarray(r)))
            secrets.append(s.astype(np.int64))
        else:
            sh, sl = (x.numpy().view(np.uint32) for x in trng.uniform_bits_device_pair(replay, (chunk, dim), nbits))
            rh, rl = (x.numpy().view(np.uint32) for x in trng.uniform_bits_device_pair(replay, rshape, nbits))
            jacc = jacc + np.asarray(jsf.value_limb_sums_chunk_pair(
                jnp.asarray(sh), jnp.asarray(sl), random.key(0), jplan,
                lambda k, shape, rh=rh, rl=rl: (jnp.asarray(rh), jnp.asarray(rl))))
            secrets.append((sh.astype(np.int64) << 32) | sl.astype(np.int64))
    np.testing.assert_array_equal(acc.numpy(), jacc)
    assert acc.shape[0] == (1 if bits < 32 else 2)

    got = bench.sumfirst_finalize(acc, plain, tplan, ours, dim)
    assert got is not None
    np.testing.assert_array_equal(got, _plain_sum(np.concatenate(secrets), p))
    # a corrupted check sum is caught
    assert bench.sumfirst_finalize(acc, plain + 1, tplan, ours, dim) is None
