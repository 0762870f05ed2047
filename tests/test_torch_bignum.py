"""The native layer's Montgomery modexp (``native.mod_exp``,
``native.mod_exp_batch``, C built here with the host's compiler) against
Python's ``pow`` and against the reference's ``BN_mod_exp``
(``sda_tpu.native.bignum``, over this host's libcrypto, loaded by the
reference and only in these tests): seeded odd moduli of 64 to 4,096 bits,
exponents 0 and 1, bases at or above the modulus, an even modulus refused;
the batch independent of its thread count; Paillier's ciphertexts at a
fixed ``r`` and its vectors on replayed randomness equal to the
reference's, its modexps all on the native layer, with no fallback; and
``is_prime`` routing moduli of at least 128 bits through it, as the
reference routes them through OpenSSL. Every comparison is exact."""

from __future__ import annotations

import random
import secrets

import pytest

from sda_tpu.native import bignum as ref_bignum
from sda_tpu.ops import paillier as jpaillier
from sda_tpu.ops import params as jparams
from sda_tpu_torch import native
from sda_tpu_torch.ops import paillier, params

BITS = [64, 65, 127, 128, 192, 256, 521, 1024, 2048, 4096]


def _odd_modulus(rng: random.Random, bits: int) -> int:
    return rng.getrandbits(bits) | 1 | (1 << (bits - 1))


def _cases(bits: int):
    """(base, exp, mod) triples at one modulus size, from a seeded stream."""
    rng = random.Random(bits)
    m = _odd_modulus(rng, bits)
    exp_bits = min(bits, 512)  # full-length exponents below, at 2,048 and 4,096
    return [
        (rng.getrandbits(bits) % m, rng.getrandbits(exp_bits), m),
        (rng.getrandbits(bits + 37), rng.getrandbits(70), m),  # base above the modulus
        (m, 5, m),
        (m - 1, 3, m),
        (rng.getrandbits(bits) % m, 0, m),
        (rng.getrandbits(bits) % m, 1, m),
        (0, 0, m),
        (0, 17, m),
        (1, rng.getrandbits(200), m),
    ]


@pytest.mark.parametrize("bits", BITS)
def test_mod_exp_equals_pow_and_bn_mod_exp(bits):
    for base, exp, mod in _cases(bits):
        want = pow(base, exp, mod)
        assert native.mod_exp(base, exp, mod) == want == ref_bignum.mod_exp(base, exp, mod)


@pytest.mark.parametrize("bits", [2048, 4096])
def test_full_length_exponents(bits):
    rng = random.Random(bits + 1)
    m = _odd_modulus(rng, bits)
    base, exp = rng.getrandbits(bits) % m, rng.getrandbits(bits // 2) | (1 << (bits // 2 - 1))
    assert native.mod_exp(base, exp, m) == pow(base, exp, m) == ref_bignum.mod_exp(base, exp, m)


@pytest.mark.parametrize("bits", BITS)
def test_mod_exp_batch_equals_pow(bits):
    rng = random.Random(bits + 2)
    m = _odd_modulus(rng, bits)
    exp = rng.getrandbits(min(bits, 256))
    bases = [rng.getrandbits(bits + 3) for _ in range(9)] + [0, 1, m, m + 1]
    want = [pow(b, exp, m) for b in bases]
    assert native.mod_exp_batch(bases, exp, m) == want
    assert [ref_bignum.mod_exp(b, exp, m) for b in bases] == want


@pytest.mark.parametrize("threads", [1, 2, 3, 8, 64])
def test_batch_independent_of_thread_count(threads):
    rng = random.Random(3)
    m = _odd_modulus(rng, 1024)
    exp = rng.getrandbits(300)
    bases = [rng.getrandbits(1024) for _ in range(11)]
    assert native.mod_exp_batch(bases, exp, m, n_threads=threads) == [pow(b, exp, m) for b in bases]


def test_small_moduli_and_empty_batch():
    for m in (1, 3, 5, 7, (1 << 61) - 1, (1 << 64) - 59):
        for base, exp in ((0, 0), (2, 0), (2, 10), (m + 1, 7), (12345, 1 << 70)):
            assert native.mod_exp(base, exp, m) == pow(base, exp, m)
    assert native.mod_exp_batch([], 5, 7) == []


@pytest.mark.parametrize("mod", [2, 1 << 64, (1 << 2048) + 2, 0, -7])
def test_even_or_nonpositive_modulus_refused(mod):
    with pytest.raises(ValueError):
        native.mod_exp(3, 5, mod)
    with pytest.raises(ValueError):
        native.mod_exp_batch([3], 5, mod)


@pytest.mark.parametrize("base,exp", [(-1, 5), (3, -1)])
def test_negative_operands_refused_as_the_reference(base, exp):
    for fn in (native.mod_exp, ref_bignum.mod_exp):
        with pytest.raises(ValueError, match="nonnegative"):
            fn(base, exp, 101)
    with pytest.raises(ValueError, match="nonnegative"):
        native.mod_exp_batch([base], exp, 101)


# -- Paillier on the native modexp -------------------------------------------------

KEY_BITS = 512


@pytest.fixture(scope="module")
def keys():
    jpk, jsk = jpaillier.keygen(KEY_BITS)
    return (jpk, jsk, paillier.PaillierPublicKey(jpk.n),
            paillier.PaillierPrivateKey(jsk.n, jsk.lam, jsk.mu))


@pytest.mark.parametrize("salt", range(4))
def test_paillier_ciphertexts_at_a_fixed_r_equal_reference(keys, salt):
    jpk, jsk, pk, sk = keys
    rng = random.Random(salt)
    m, r = rng.randrange(pk.n), rng.randrange(1, pk.n)
    c = paillier.encrypt(pk, m, r)
    assert c == jpaillier.encrypt(jpk, m, r)
    assert paillier.decrypt(sk, c) == jpaillier.decrypt(jsk, c) == m


class _Counting:
    def __init__(self, monkeypatch):
        self.calls = {"mod_exp": 0, "mod_exp_batch": 0}
        for name in self.calls:
            real = getattr(native, name)
            monkeypatch.setattr(native, name, self._counted(name, real))
        monkeypatch.setattr(paillier, "_mod_exp", native.mod_exp)

    def _counted(self, name, real):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return real(*args, **kwargs)
        return call


def test_paillier_vectors_ride_one_batch_each(keys, monkeypatch):
    jpk, jsk, pk, sk = keys
    packing, jpacking = paillier.Packing(5, 40, 32), jpaillier.Packing(5, 40, 32)
    values = [random.Random(5).getrandbits(32) for _ in range(23)]
    state = {}
    monkeypatch.setattr(secrets, "randbelow", lambda n: state["rng"].randrange(n))
    state["rng"] = random.Random(9)
    want = jpaillier.encrypt_vector(jpk, jpacking, values)
    counting = _Counting(monkeypatch)
    state["rng"] = random.Random(9)
    blocks = paillier.encrypt_vector(pk, packing, values)
    assert blocks == want and len(blocks) == 5
    assert paillier.decrypt_vector(sk, packing, blocks, 23) == values
    assert jpaillier.decrypt_vector(jsk, jpacking, blocks, 23) == values
    assert counting.calls == {"mod_exp": 0, "mod_exp_batch": 2}
    paillier.encrypt(pk, 5)
    paillier.decrypt(sk, blocks[0])
    assert counting.calls == {"mod_exp": 2, "mod_exp_batch": 2}


def test_paillier_raises_when_the_native_layer_cannot_build(keys, monkeypatch):
    _, _, pk, sk = keys

    def missing():
        raise RuntimeError("native layer unavailable")

    monkeypatch.setattr(native, "_load", missing)
    for call in (lambda: paillier.encrypt(pk, 5, 7),
                 lambda: paillier.encrypt_vector(pk, paillier.Packing(5, 40, 32), [1, 2]),
                 lambda: paillier.decrypt(sk, 12345),
                 lambda: paillier.keygen(256)):
        with pytest.raises(RuntimeError, match="native layer unavailable"):
            call()


@pytest.mark.parametrize("n", [433, (1 << 61) - 1, (1 << 89) - 1, (1 << 127) - 1,
                               2 ** 521 - 1, "pseudoprime", "composite 128"])
def test_is_prime_routes_128_bits_and_up_to_the_native_modexp(n, monkeypatch):
    if n == "pseudoprime":
        n = 3215031751  # a strong pseudoprime to bases 2, 3, 5, 7
    elif n == "composite 128":
        n = ((1 << 64) - 59) * ((1 << 64) - 83)
    want = jparams.is_prime(n, rng=random.Random(1))
    calls = []
    real = native.mod_exp
    monkeypatch.setattr(native, "mod_exp", lambda *a: calls.append(a) or real(*a))
    assert params.is_prime(n, rng=random.Random(1)) is want
    assert bool(calls) == (n.bit_length() >= params.NATIVE_MODEXP_BITS)
