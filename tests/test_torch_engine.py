"""The port's single-device engine against ``sda_tpu.parallel.engine`` on the
CPU. Randomness is held equal through the ``draw=`` hooks (one host-drawn
array handed to both packages); ``secure_sum`` has no hook, so its revealed
aggregate is held against the JAX package's and the plain sum. Exact
equality after ``positive``: all of it is integer field arithmetic."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from sda_tpu.ops.jaxcfg import ensure_x64
from sda_tpu.ops.modular import positive
from sda_tpu.parallel import TpuAggregator
from sda_tpu.parallel import engine as jeng
from sda_tpu.parallel.limbmatmul import fold_const_limbs
from sda_tpu.protocol import AdditiveSharing as JAdditive
from sda_tpu.protocol import BasicShamirSharing as JBasic
from sda_tpu.protocol import PackedShamirSharing as JPacked
from sda_tpu_torch import convert
from sda_tpu_torch.ops import find_packed_parameters, is_prime
from sda_tpu_torch.parallel import TorchAggregator
from sda_tpu_torch.parallel import engine as teng
from sda_tpu_torch.parallel.limbmatmul import limb_recombine_host
from sda_tpu_torch.protocol import AdditiveSharing, BasicShamirSharing, PackedShamirSharing

ensure_x64()

CPU = "cpu"


def _basic30():
    p = (1 << 30) + 3
    while not is_prime(p):
        p += 2
    return BasicShamirSharing(6, 2, p), JBasic(share_count=6, privacy_threshold=2, prime_modulus=p)


def _wide():
    p, w2, w3 = find_packed_parameters(3, 4, 8, min_modulus_bits=60, seed=1)
    return PackedShamirSharing(3, 8, 4, p, w2, w3), JPacked(3, 8, 4, p, w2, w3)


def _bench():
    p, w2, w3 = find_packed_parameters(5, 2, 8, min_modulus_bits=30, seed=0)
    return PackedShamirSharing(5, 8, 2, p, w2, w3), JPacked(5, 8, 2, p, w2, w3)


SCHEMES = {
    "packed433": lambda: (PackedShamirSharing(3, 8, 4, 433, 354, 150), JPacked(3, 8, 4, 433, 354, 150)),
    "additive433": lambda: (AdditiveSharing(3, 433), JAdditive(share_count=3, modulus=433)),
    "additive61": lambda: (AdditiveSharing(4, (1 << 61) - 1), JAdditive(share_count=4, modulus=(1 << 61) - 1)),
    "basic30": _basic30,
    "bench31": _bench,
    "wide60": _wide,
}


def _modulus(scheme):
    return scheme.modulus if isinstance(scheme, AdditiveSharing) else scheme.prime_modulus


def _plain_sum(secrets, p):
    return np.array(
        [sum(int(v) for v in secrets[:, j]) % p for j in range(secrets.shape[1])],
        dtype=np.int64,
    )


def _hooks(arr):
    """The same host array as a draw for both packages."""
    return (lambda key, shape, p: jnp.asarray(arr)), (lambda gen, shape, p: torch.as_tensor(arr))


@pytest.mark.parametrize("name", ["packed433", "additive433"])
def test_single_device_secure_sum(name):
    ours, ref = SCHEMES[name]()
    p = _modulus(ours)
    dim = 10
    secrets = np.random.default_rng(0).integers(0, p, size=(17, dim))
    got = TorchAggregator(ours, dim, device=CPU).secure_sum(
        torch.as_tensor(secrets), torch.Generator().manual_seed(0)
    )
    want = TpuAggregator(ref, dim).secure_sum(jnp.asarray(secrets), random.key(0))
    np.testing.assert_array_equal(positive(got.numpy(), p), _plain_sum(secrets, p))
    np.testing.assert_array_equal(positive(got.numpy(), p), positive(np.asarray(want), p))


def test_single_device_dropout():
    ours, ref = SCHEMES["packed433"]()
    p, dim = 433, 7  # pad + truncate path
    secrets = np.random.default_rng(1).integers(0, p, size=(5, dim))
    idx = [0, 2, 3, 4, 5, 6, 7]
    got = TorchAggregator(ours, dim, device=CPU).secure_sum(
        torch.as_tensor(secrets), torch.Generator().manual_seed(1), indices=idx
    )
    want = TpuAggregator(ref, dim).secure_sum(jnp.asarray(secrets), random.key(1), indices=idx)
    np.testing.assert_array_equal(positive(got.numpy(), p), _plain_sum(secrets, p))
    np.testing.assert_array_equal(positive(got.numpy(), p), positive(np.asarray(want), p))


@pytest.mark.parametrize("name", ["packed433", "bench31"])
def test_limb_path_matches_int64_path(name):
    ours, _ = SCHEMES[name]()
    p, dim = ours.prime_modulus, 30
    secrets = torch.as_tensor(np.random.default_rng(3).integers(0, p, size=(9, dim)))
    out_a = TorchAggregator(ours, dim, device=CPU, use_limbs=False).secure_sum(
        secrets, torch.Generator().manual_seed(7)
    )
    out_b = TorchAggregator(ours, dim, device=CPU, use_limbs=True).secure_sum(
        secrets, torch.Generator().manual_seed(7)
    )
    np.testing.assert_array_equal(positive(out_a.numpy(), p), positive(out_b.numpy(), p))
    np.testing.assert_array_equal(positive(out_a.numpy(), p), _plain_sum(secrets.numpy(), p))


def test_wide_modulus_limb_pipeline():
    """61-bit modulus: fused limb share+combine, exact host recombine of the
    tiny accumulator, host reconstruction; the accumulator equals the JAX
    package's for the same draws."""
    ours, ref = _wide()
    p, dim = ours.prime_modulus, 12
    rng = np.random.default_rng(7)
    secrets = rng.integers(p - 50, p, size=(40, dim)).astype(np.int64)
    rand = rng.integers(0, p, size=(40, 4, 4)).astype(np.int64)
    jdraw, tdraw = _hooks(rand)
    acc = teng.share_combine_limb(
        torch.as_tensor(secrets), None, teng.make_plan(ours, dim, CPU), draw=tdraw
    )
    jacc = jeng.share_combine_limb(
        jnp.asarray(secrets), random.key(0), jeng.make_plan(ref, dim), draw=jdraw
    )
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    acc = torch.fmod(acc, p)
    clerk_sums = torch.as_tensor(limb_recombine_host(acc, p).T.copy())
    out = teng.reconstruct(clerk_sums, [0, 1, 2, 4, 5, 6, 7], ours, dim)
    np.testing.assert_array_equal(positive(out.numpy(), p), _plain_sum(secrets, p))


def test_basic_shamir_engine_end_to_end():
    ours, ref = _basic30()
    p, dim, P = ours.prime_modulus, 37, 11
    secrets = np.random.default_rng(2).integers(0, p, size=(P, dim))
    got = TorchAggregator(ours, dim, device=CPU).secure_sum(
        torch.as_tensor(secrets), torch.Generator().manual_seed(0), indices=[0, 2, 5]
    )
    want = TpuAggregator(ref, dim).secure_sum(jnp.asarray(secrets), random.key(0), indices=[0, 2, 5])
    np.testing.assert_array_equal(positive(got.numpy(), p), secrets.sum(axis=0) % p)
    np.testing.assert_array_equal(positive(got.numpy(), p), positive(np.asarray(want), p))


@pytest.mark.parametrize(
    "name,use_limbs",
    [("packed433", False), ("packed433", True), ("bench31", True), ("basic30", False),
     ("additive433", False), ("additive61", False)],
)
def test_share_participants_matches_reference_shares(name, use_limbs):
    ours, ref = SCHEMES[name]()
    p, dim, P = _modulus(ours), 13, 6
    tplan, jplan = teng.make_plan(ours, dim, CPU), jeng.make_plan(ref, dim)
    rng = np.random.default_rng(11)
    secrets = rng.integers(0, p, size=(P, dim)).astype(np.int64)
    shape = (P, ours.share_count - 1, dim) if tplan.share_matrix is None else (
        P, tplan.n_batches, tplan.rand_size)
    rand = rng.integers(0, p, size=shape).astype(np.int64)
    jdraw, tdraw = _hooks(rand)
    got = teng.share_participants(torch.as_tensor(secrets), None, tplan, use_limbs, draw=tdraw)
    want = np.asarray(jeng.share_participants(jnp.asarray(secrets), random.key(0), jplan,
                                              use_limbs, draw=jdraw))
    assert tuple(got.shape) == want.shape == (P, ours.share_count, tplan.n_batches)
    np.testing.assert_array_equal(got.numpy(), want)
    sums = teng.clerk_combine_mod(got, p)
    np.testing.assert_array_equal(
        positive(sums.numpy(), p), positive(np.asarray(jeng.clerk_combine_mod(jnp.asarray(want), p)), p)
    )
    np.testing.assert_array_equal(
        teng.clerk_combine(got).numpy(), np.asarray(jeng.clerk_combine(jnp.asarray(want)))
    )
    survivors = list(range(ours.share_count))[-ours.reconstruction_threshold:]
    out = teng.reconstruct(sums, survivors, ours, dim)
    np.testing.assert_array_equal(positive(out.numpy(), p), _plain_sum(secrets, p))


@pytest.mark.parametrize("name", ["packed433", "bench31", "wide60", "basic30"])
def test_share_combine_limb_matches_reference(name):
    ours, ref = SCHEMES[name]()
    p, dim, P = ours.prime_modulus, 23, 29
    tplan, jplan = teng.make_plan(ours, dim, CPU), jeng.make_plan(ref, dim)
    rng = np.random.default_rng(5)
    secrets = rng.integers(0, p, size=(P, dim)).astype(np.int64)
    rand = rng.integers(0, p, size=(P, tplan.n_batches, tplan.rand_size)).astype(np.int64)
    jdraw, tdraw = _hooks(rand)
    got = teng.share_combine_limb(torch.as_tensor(secrets), None, tplan, draw=tdraw)
    want = jeng.share_combine_limb(jnp.asarray(secrets), random.key(0), jplan, draw=jdraw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batch_secrets_zero_pads_tail():
    ours, ref = SCHEMES["packed433"]()
    x = np.arange(1, 15, dtype=np.int64).reshape(2, 7)
    got = teng._batch_secrets(torch.as_tensor(x), teng.make_plan(ours, 7, CPU))
    want = jeng._batch_secrets(jnp.asarray(x), jeng.make_plan(ref, 7))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, 3, 3) and int(got[0, 2, 1]) == 0


def _reference_fields(jplan):
    fields = dataclasses.asdict(jplan)
    if jplan.share_matrix is not None:
        fields["limb_stacks"] = fold_const_limbs(jplan.share_matrix.T, jplan.modulus)
    return fields


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_plan_from_reference_round_trips(name):
    ours, ref = SCHEMES[name]()
    dim = 23
    jplan = jeng.make_plan(ref, dim)
    plan = convert.plan_from_reference(_reference_fields(jplan), device=CPU)
    own = teng.make_plan(ours, dim, CPU)
    for f in ("modulus", "dim", "input_size", "rand_size", "share_count", "n_batches"):
        assert getattr(plan, f) == getattr(own, f) == getattr(jplan, f)
    if jplan.share_matrix is None:
        assert plan.share_matrix is None and plan.limb_stacks is None
        return
    np.testing.assert_array_equal(plan.share_matrix.numpy(), jplan.share_matrix)
    assert torch.equal(plan.share_matrix, own.share_matrix)
    assert torch.equal(plan.limb_stacks, own.limb_stacks)
    # without limb_stacks they are folded from the share matrix
    fields = _reference_fields(jplan)
    del fields["limb_stacks"]
    assert torch.equal(convert.plan_from_reference(fields, device=CPU).limb_stacks, own.limb_stacks)


def test_plan_from_reference_rejects_mismatched_matrix():
    _, ref = SCHEMES["packed433"]()
    fields = _reference_fields(jeng.make_plan(ref, 9))
    fields["share_matrix"] = fields["share_matrix"][:, :-1]
    with pytest.raises(ValueError, match="share matrix"):
        convert.plan_from_reference(fields, device=CPU)


def test_accumulator_from_reference_continues_a_round():
    """Half a streamed round on the JAX package, its accumulator carried
    across, the other half on the port: the reveal is the plain sum."""
    ours, ref = _bench()
    p, dim = ours.prime_modulus, 23
    jplan = jeng.make_plan(ref, dim)
    plan = convert.plan_from_reference(_reference_fields(jplan), device=CPU)
    rng = np.random.default_rng(21)
    first = rng.integers(0, p, size=(30, dim)).astype(np.int64)
    second = rng.integers(0, p, size=(25, dim)).astype(np.int64)
    jacc = np.asarray(jeng.share_combine_limb(jnp.asarray(first), random.key(2), jplan)) % p
    acc = convert.accumulator_from_reference(jacc, device=CPU)
    assert acc.dtype == torch.int64 and tuple(acc.shape) == jacc.shape
    acc = torch.fmod(
        acc + teng.share_combine_limb(torch.as_tensor(second), torch.Generator().manual_seed(2), plan), p
    )
    clerk_sums = torch.as_tensor(limb_recombine_host(acc, p).T.copy())
    out = teng.reconstruct(clerk_sums, range(1, 8), ours, dim)
    np.testing.assert_array_equal(
        positive(out.numpy(), p), _plain_sum(np.concatenate([first, second]), p)
    )


def test_reconstruct_matches_reference_on_equal_clerk_sums():
    for name in ("packed433", "bench31", "wide60", "basic30", "additive61"):
        ours, ref = SCHEMES[name]()
        p, n, dim = _modulus(ours), ours.share_count, 11
        nb = teng.make_plan(ours, dim, CPU).n_batches
        sums = np.random.default_rng(n).integers(0, p, size=(n, nb)).astype(np.int64)
        idx = list(range(n))[: ours.reconstruction_threshold]
        got = teng.reconstruct(torch.as_tensor(sums), idx, ours, dim)
        want = jeng.reconstruct(jnp.asarray(sums), idx, ref, dim)
        np.testing.assert_array_equal(positive(got.numpy(), p), positive(np.asarray(want), p))
