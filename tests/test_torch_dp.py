"""The port's distributed-DP module (``sda_tpu_torch/models/dp.py``) against
``sda_tpu.models.dp`` on the CPU: the zCDP accountant, ``DPConfig`` and the
drivers' construction, wires and privacy bit for bit on the same inputs
(the L2 clip's norm within a stated tolerance); the samplers, which draw
from a ``torch.Generator`` where the reference draws from numpy, against
the exact discrete Laplace and Gaussian laws and against the reference's
own draws, with the tolerances stated at each test."""

import dataclasses
import math
import random

import numpy as np
import pytest
import torch

from sda_tpu.models import dp as jdp
from sda_tpu.models import QuantizationSpec as JSpec
from sda_tpu_torch.models import dp
from sda_tpu_torch.models import QuantizationSpec

CPU = "cpu"


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _astuple(x):
    return dataclasses.astuple(x)


# -- the accountant -----------------------------------------------------------

RHOS = [0.0, 1e-4, 0.02, 0.5, 1.0, 7.5, 300.0]
DELTAS = [1e-9, 1e-6, 1e-3, 0.3]


@pytest.mark.parametrize("rho", RHOS)
def test_eps_and_delta_bit_equal(rho):
    for delta in DELTAS:
        assert dp.eps_from_zcdp(rho, delta) == jdp.eps_from_zcdp(rho, delta)
    for eps in (-1.0, 0.0, 0.1, 1.0, 5.0, 50.0):
        assert dp.delta_from_zcdp(rho, eps) == jdp.delta_from_zcdp(rho, eps)


@pytest.mark.parametrize("eps,delta", [(0.5, 1e-6), (1.0, 1e-5), (3.0, 1e-6), (8.0, 1e-9), (20.0, 0.01)])
def test_noise_multiplier_and_rho_bit_equal(eps, delta):
    z = dp.noise_multiplier_for(eps, delta)
    assert z == jdp.noise_multiplier_for(eps, delta)
    assert dp.zcdp_rho(3.5, z) == jdp.zcdp_rho(3.5, z)
    assert dp.eps_from_zcdp(dp.zcdp_rho(1.0, z), delta) <= eps


@pytest.mark.parametrize("call", [
    lambda m: m.eps_from_zcdp(1.0, 0.0),
    lambda m: m.eps_from_zcdp(1.0, 1.0),
    lambda m: m.noise_multiplier_for(0.0, 1e-6),
    lambda m: m.noise_multiplier_for(1e-12, 1e-12),
    lambda m: m.zcdp_rho(1.0, 0.0),
    lambda m: m.compose_accounts([]),
], ids=["delta 0", "delta 1", "eps 0", "unreachable", "sigma 0", "nothing to compose"])
def test_accountant_refusals_match_reference(call):
    with pytest.raises(ValueError) as jerr:
        call(jdp)
    with pytest.raises(ValueError) as err:
        call(dp)
    assert str(err.value) == str(jerr.value)


def test_composition_bit_equal():
    rhos = [0.5, 0.25, 1e-3, 2.0]
    assert _astuple(dp.compose_rhos(rhos, 1e-6)) == _astuple(jdp.compose_rhos(rhos, 1e-6))
    # a release without accounting enters as rho = inf: unbounded, not understated
    inf = dp.compose_rhos([0.5, math.inf], 1e-6)
    assert _astuple(inf) == _astuple(jdp.compose_rhos([0.5, math.inf], 1e-6))
    assert inf.epsilon == math.inf
    cfg = dp.DPConfig(l2_clip=2.0, noise_multiplier=1.3, expected_participants=50, delta=1e-7)
    jcfg = jdp.DPConfig(l2_clip=2.0, noise_multiplier=1.3, expected_participants=50, delta=1e-7)
    accounts = [cfg.account(1 << 16, 1000, n) for n in (50, 40, 25)]
    jaccounts = [jcfg.account(1 << 16, 1000, n) for n in (50, 40, 25)]
    assert _astuple(dp.compose_accounts(accounts)) == _astuple(jdp.compose_accounts(jaccounts))
    assert (_astuple(dp.compose_accounts(accounts, 1e-3))
            == _astuple(jdp.compose_accounts(jaccounts, 1e-3)))


CONFIGS = [
    dict(l2_clip=1.0, noise_multiplier=1.0, expected_participants=10),
    dict(l2_clip=0.1, noise_multiplier=0.7, expected_participants=1000, delta=1e-9),
    dict(l2_clip=600.0 * math.sqrt(1663371.0), noise_multiplier=2.0, expected_participants=100),
    dict(l2_clip=5.0, noise_multiplier=1.1, expected_participants=3, mechanism="skellam",
         min_party_sigma=4.0),
]


@pytest.mark.parametrize("kwargs", CONFIGS, ids=range(len(CONFIGS)))
def test_dpconfig_bit_equal(kwargs):
    cfg, jcfg = dp.DPConfig(**kwargs), jdp.DPConfig(**kwargs)
    for scale, dim in ((1 << 16, 1663370), (1 << 8, 7), (1, 1)):
        for name in ("sensitivity_field", "sigma_total_field", "sigma_party_field"):
            assert getattr(cfg, name)(scale, dim) == getattr(jcfg, name)(scale, dim)
        for bound in (None, 600.0, 1e-3):
            assert cfg.field_need(scale, dim, bound) == jcfg.field_need(scale, dim, bound)
        if cfg.mechanism == "dgauss":
            for n in (None, 1, cfg.expected_participants):
                assert _astuple(cfg.account(scale, dim, n)) == _astuple(jcfg.account(scale, dim, n))
        else:
            with pytest.raises(NotImplementedError):
                cfg.account(scale, dim)


@pytest.mark.parametrize("kwargs", [
    dict(l2_clip=0.0, noise_multiplier=1.0, expected_participants=1),
    dict(l2_clip=1.0, noise_multiplier=-1.0, expected_participants=1),
    dict(l2_clip=1.0, noise_multiplier=1.0, expected_participants=0),
    dict(l2_clip=1.0, noise_multiplier=1.0, expected_participants=1, mechanism="laplace"),
], ids=["clip", "multiplier", "participants", "mechanism"])
def test_dpconfig_refusals_match_reference(kwargs):
    with pytest.raises(ValueError) as jerr:
        jdp.DPConfig(**kwargs)
    with pytest.raises(ValueError) as err:
        dp.DPConfig(**kwargs)
    assert str(err.value) == str(jerr.value)


def test_party_noise_refuses_a_thin_sigma_like_reference():
    kwargs = dict(l2_clip=1e-3, noise_multiplier=0.5, expected_participants=10_000)
    with pytest.raises(ValueError) as jerr:
        jdp.DPConfig(**kwargs).party_noise(1, 4, np.random.default_rng(0))
    with pytest.raises(ValueError) as err:
        dp.DPConfig(**kwargs).party_noise(1, 4, _gen())
    assert str(err.value) == str(jerr.value)


# -- the samplers -------------------------------------------------------------

N_DRAWS = 200_000


def _dgauss_pmf(sigma, xs):
    support = np.arange(-int(40 * sigma) - 40, int(40 * sigma) + 41)
    weights = np.exp(-(support.astype(np.float64) ** 2) / (2 * sigma * sigma))
    return np.exp(-(xs.astype(np.float64) ** 2) / (2 * sigma * sigma)) / weights.sum()


def _dlaplace_pmf(t, xs):
    q = math.exp(-1.0 / t)
    return (1 - q) / (1 + q) * q ** np.abs(xs)


def _assert_pmf(draws, pmf, xs):
    """Each value's empirical frequency within 5 binomial standard errors
    of its exact probability (and the mass outside ``xs`` likewise)."""
    n = draws.size
    counts = np.array([(draws == x).sum() for x in xs])
    se = np.sqrt(pmf * (1 - pmf) / n)
    assert np.all(np.abs(counts / n - pmf) <= 5 * se + 1e-12), (counts / n, pmf)
    rest, rest_p = n - counts.sum(), max(0.0, 1.0 - pmf.sum())
    assert abs(rest / n - rest_p) <= 5 * math.sqrt(max(rest_p * (1 - rest_p), 1e-12) / n) + 1e-6


@pytest.mark.parametrize("sigma", [0.8, 1.5, 4.0])
def test_discrete_gaussian_law(sigma):
    """The port's draws and the reference's follow N_Z(0, sigma^2): each
    probability within 5 standard errors, for both samplers."""
    xs = np.arange(-int(3 * sigma) - 1, int(3 * sigma) + 2)
    pmf = _dgauss_pmf(sigma, xs)
    port = dp.sample_discrete_gaussian(sigma, N_DRAWS, _gen(int(sigma * 10)))
    assert port.dtype == torch.int64 and port.shape == (N_DRAWS,)
    _assert_pmf(port.numpy(), pmf, xs)
    _assert_pmf(jdp.sample_discrete_gaussian(sigma, N_DRAWS, np.random.default_rng(1)), pmf, xs)


@pytest.mark.parametrize("t", [1.0, 2.0, 7.0])
def test_discrete_laplace_law(t):
    xs = np.arange(-int(4 * t), int(4 * t) + 1)
    pmf = _dlaplace_pmf(t, xs)
    port = dp.sample_discrete_laplace(t, N_DRAWS, _gen(int(t)))
    _assert_pmf(port.numpy(), pmf, xs)
    _assert_pmf(jdp.sample_discrete_laplace(t, N_DRAWS, np.random.default_rng(2)), pmf, xs)


def test_wide_gaussian_spread_matches_reference():
    """At a per-party sigma of a FedAvg round's scale, the port's and the
    reference's standard deviations are within 1 % of sigma (the standard
    error of either is ~0.16 % at 200,000 draws) and the means within 5
    standard errors of 0."""
    sigma = 20_928.225
    port = dp.sample_discrete_gaussian(sigma, N_DRAWS, _gen(3)).numpy().astype(np.float64)
    ref = jdp.sample_discrete_gaussian(sigma, N_DRAWS, np.random.default_rng(3)).astype(np.float64)
    for draws in (port, ref):
        assert abs(draws.std() / sigma - 1.0) < 0.01
        assert abs(draws.mean()) < 5 * sigma / math.sqrt(N_DRAWS)


def test_skellam_spread():
    mu = 9.0
    draws = dp.sample_skellam(mu, (400, 500), _gen(4))
    assert draws.shape == (400, 500) and draws.dtype == torch.int64
    for d in (draws.numpy().ravel(), jdp.sample_skellam(mu, N_DRAWS, np.random.default_rng(4))):
        assert abs(d.var() / mu - 1.0) < 0.02 and abs(d.mean()) < 5 * math.sqrt(mu / d.size)


def test_sampler_shapes_and_seeds():
    for size, shape in ((7, (7,)), ((3, 4), (3, 4)), ((), ()), (0, (0,))):
        got = dp.sample_discrete_gaussian(2.0, size, _gen())
        assert tuple(got.shape) == shape and got.dtype == torch.int64
        assert tuple(jdp.sample_discrete_gaussian(2.0, size, np.random.default_rng(0)).shape) == shape
    a = dp.sample_discrete_gaussian(3.0, 1000, _gen(5))
    assert torch.equal(a, dp.sample_discrete_gaussian(3.0, 1000, _gen(5)))
    assert not torch.equal(a, dp.sample_discrete_gaussian(3.0, 1000, _gen(6)))


@pytest.mark.parametrize("call", [
    lambda m, g: m.sample_discrete_gaussian(0.0, 4, g),
    lambda m, g: m.sample_discrete_laplace(-1.0, 4, g),
    lambda m, g: m.sample_skellam(0.0, 4, g),
], ids=["sigma", "scale", "mu"])
def test_sampler_refusals_match_reference(call):
    with pytest.raises(ValueError) as jerr:
        call(jdp, np.random.default_rng(0))
    with pytest.raises(ValueError) as err:
        call(dp, _gen())
    assert str(err.value) == str(jerr.value)


def test_party_noise_draws_on_the_generator():
    cfg = dp.DPConfig(l2_clip=1.0, noise_multiplier=1.0, expected_participants=10)
    a = cfg.party_noise(1 << 16, 5000, _gen(7))
    assert a.shape == (5000,) and torch.equal(a, dp.sample_discrete_gaussian(
        cfg.sigma_party_field(1 << 16, 5000), 5000, _gen(7)))
    sk = dataclasses.replace(cfg, mechanism="skellam").party_noise(1 << 16, 5000, _gen(7))
    assert torch.equal(sk, dp.sample_skellam(cfg.sigma_party_field(1 << 16, 5000) ** 2, 5000, _gen(7)))
    assert cfg.party_noise(1 << 16, 3, device=CPU).shape == (3,)


def test_l2_clip_vector_matches_reference():
    """Inside the clip the vector is returned as is; outside, it is scaled by
    clip / norm, with the norm summed in torch's order: within 4 ulps of the
    reference's (numpy's BLAS order)."""
    rng = np.random.default_rng(8)
    inside = 0.01 * rng.standard_normal(1000)
    assert np.array_equal(dp.l2_clip_vector(inside, 1.0, CPU).numpy(), jdp.l2_clip_vector(inside, 1.0))
    for n in (3, 1000, 100_000):
        outside = rng.standard_normal(n)
        got, want = dp.l2_clip_vector(outside, 0.5, CPU).numpy(), jdp.l2_clip_vector(outside, 0.5)
        assert np.all(np.abs(got - want) <= 4 * np.spacing(np.abs(want)))
        assert abs(np.linalg.norm(got) - 0.5) < 1e-12


# -- the drivers ---------------------------------------------------------------


@pytest.fixture
def seeded_roots(monkeypatch):
    real = random.Random
    monkeypatch.setattr(random, "Random", lambda seed=None: real(0 if seed is None else seed))


TEMPLATE = {"w": np.zeros((40, 30)), "b": np.zeros(30), "s": np.zeros(())}
DIM = 1231


@pytest.mark.parametrize("frac_bits,bound", [(16, None), (12, 600.0), (20, 0.05)])
def test_fitted_spec_matches_reference(seeded_roots, frac_bits, bound):
    kwargs = dict(l2_clip=1.0, noise_multiplier=1.0, expected_participants=10)
    spec, scheme = dp.DPFederatedAveraging.fitted_spec(frac_bits, dp.DPConfig(**kwargs), DIM, bound)
    jspec, jscheme = jdp.DPFederatedAveraging.fitted_spec(frac_bits, jdp.DPConfig(**kwargs), DIM, bound)
    assert (spec.modulus, spec.clip, spec.n_participants) == (jspec.modulus, jspec.clip, jspec.n_participants)
    assert (scheme.omega_secrets, scheme.omega_shares) == (jscheme.omega_secrets, jscheme.omega_shares)


def test_fitted_dp_matches_reference(seeded_roots):
    kwargs = dict(noise_multiplier=1.2, delta=1e-7)
    fed, scheme = dp.DPWeightedFederatedAveraging.fitted_dp(16, 0.01, 2.0, 10, TEMPLATE, device=CPU, **kwargs)
    jfed, jscheme = jdp.DPWeightedFederatedAveraging.fitted_dp(16, 0.01, 2.0, 10, TEMPLATE, **kwargs)
    assert (fed.spec.modulus, fed.spec.clip) == (jfed.spec.modulus, jfed.spec.clip)
    assert scheme.omega_shares == jscheme.omega_shares
    assert _astuple(fed.dp) == _astuple(jfed.dp)
    assert _astuple(fed.privacy()) == _astuple(jfed.privacy())


def _plain_pair(l2_clip=1.0, frac_bits=16):
    cfg = dict(l2_clip=l2_clip, noise_multiplier=1.0, expected_participants=10)
    spec, _ = dp.DPFederatedAveraging.fitted_spec(frac_bits, dp.DPConfig(**cfg), DIM)
    jspec = JSpec(spec.modulus, spec.frac_bits, spec.clip, spec.n_participants)
    fed = dp.DPFederatedAveraging(spec, TEMPLATE, dp.DPConfig(**cfg), _gen(9), device=CPU)
    jfed = jdp.DPFederatedAveraging(jspec, TEMPLATE, jdp.DPConfig(**cfg), np.random.default_rng(9))
    return fed, jfed


def _update(rng, scale):
    return {"w": scale * rng.standard_normal((40, 30)), "b": scale * rng.standard_normal(30),
            "s": np.array(scale)}


def test_dp_wire_is_reference_wire_plus_the_noise():
    """The DP wire is the reference's clipped quantization plus the party's
    noise, drawn here from the same generator seed: exact for an update
    inside the clip; outside it, within one field unit per coordinate (the
    clip's norm sums in another order, which can move a rounding)."""
    fed, jfed = _plain_pair()
    rng = np.random.default_rng(10)
    p, scale = fed.spec.modulus, fed.spec.scale
    for update, tol in ((_update(rng, 1e-3), 0), (_update(rng, 1.0), 1)):
        got = fed.wire(update, generator=_gen(11)).numpy()
        noise = fed.dp.party_noise(scale, DIM, _gen(11)).numpy()
        flat = jdp.l2_clip_vector(jfed._validated_flat(update), jfed.dp.l2_clip)
        want = (jfed.spec.quantize(flat).astype(np.int64) + noise) % p
        diff = (got - want) % p
        assert np.all(np.minimum(diff, p - diff) <= tol)
        assert got.min() >= 0 and got.max() < p


def test_dp_weighted_wire_is_reference_wire_plus_the_noise():
    fed, _ = dp.DPWeightedFederatedAveraging.fitted_dp(16, 0.05, 3.0, 10, TEMPLATE, noise_multiplier=1.0,
                                                       generator=_gen(12), device=CPU)
    jfed = jdp.DPWeightedFederatedAveraging(
        JSpec(fed.spec.modulus, 16, fed.spec.clip, 10), TEMPLATE, 0.05, 3.0,
        jdp.DPConfig(**dataclasses.asdict(fed.dp)))
    update = {k: np.clip(v, -0.05, 0.05) for k, v in _update(np.random.default_rng(13), 0.04).items()}
    got = fed.wire(update, 2.5, generator=_gen(14)).numpy()
    noise = fed.dp.party_noise(fed.spec.scale, fed.wire_dimension, _gen(14)).numpy()
    assert np.array_equal(got, (jfed._quantized_wire(update, 2.5).astype(np.int64) + noise) % fed.spec.modulus)
    # a noisy total weight at or below 0 gives NaN means, as the reference's
    sums = torch.zeros(fed.wire_dimension, dtype=torch.float64)
    assert torch.isnan(fed._weighted_flat(sums, 0.0)).all()
    assert np.isnan(jfed._weighted_flat(sums.numpy(), 0.0)).all()


def test_dp_finish_round_and_privacy_match_reference():
    fed, jfed = _plain_pair()
    rng = np.random.default_rng(15)
    wires = [fed.wire(_update(rng, 0.5)).numpy() for _ in range(7)]
    field_sum = np.sum(wires, axis=0) % fed.spec.modulus
    assert _astuple(fed.privacy()) == _astuple(jfed.privacy())  # configured cohort
    mean = fed.mean_from_field_sum(torch.from_numpy(field_sum), 7)
    from sda_tpu.models import dequantize_mean as jdequantize_mean

    want = jdequantize_mean(field_sum, 7, jfed.spec, jfed.treedef, jfed.shapes)
    for key in want:
        assert np.array_equal(mean[key].numpy(), want[key])
    # the realized cohort after the reveal: 7 of 10, a larger epsilon
    assert _astuple(fed.privacy()) == _astuple(jfed.privacy(7))
    assert fed.privacy().epsilon > fed.dp.account(fed.spec.scale, DIM).epsilon


def test_dp_driver_refusals_match_reference():
    # per-party sigma below the floor
    cfg = dict(l2_clip=1e-4, noise_multiplier=0.1, expected_participants=1000)
    spec_args = (1073741833, 8, 1.0, 1000)
    with pytest.raises(ValueError) as jerr:
        jdp.DPFederatedAveraging(JSpec(*spec_args), TEMPLATE, jdp.DPConfig(**cfg))
    with pytest.raises(ValueError) as err:
        dp.DPFederatedAveraging(QuantizationSpec(*spec_args), TEMPLATE, dp.DPConfig(**cfg), device=CPU)
    assert str(err.value) == str(jerr.value)
    # a data-only field without the noise tail's headroom
    cfg = dict(l2_clip=1.0, noise_multiplier=3.0, expected_participants=10)
    jspec, _ = JSpec.fitted(16, 1.0, 10)
    spec = QuantizationSpec(jspec.modulus, 16, 1.0, 10)
    with pytest.raises(ValueError) as jerr:
        jdp.DPFederatedAveraging(JSpec(spec.modulus, 16, 1.0, 10), TEMPLATE, jdp.DPConfig(**cfg))
    with pytest.raises(ValueError, match="lacks noise headroom") as err:
        dp.DPFederatedAveraging(spec, TEMPLATE, dp.DPConfig(**cfg), device=CPU)
    assert str(err.value) == str(jerr.value)


def test_dp_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    cfg = dp.DPConfig(l2_clip=1.0, noise_multiplier=1.0, expected_participants=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.fresh_generator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.party_noise(1 << 16, 10)
    spec, _ = dp.DPFederatedAveraging.fitted_spec(16, cfg, DIM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.DPFederatedAveraging(spec, TEMPLATE, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.l2_clip_vector(np.ones(3), 1.0)
