"""The port's chunk-level DP wire (``sda_tpu_torch/models/dp.py``) on the
CPU: the batched discrete Gaussian sampler against the law, the row clip
against the one-vector clip, ``DPFederatedAveraging.wire`` through the same
code at P = 1, the engine's two steps against the benchmark's plain
reference (``sdabench/reference/fedavg_dp.py``), and the sampler's host
syncs, ranges and counters under a CPU profiler."""

import math

import numpy as np
import pytest
import torch
from scipy import stats

from sda_tpu.models import dp as jdp
from sda_tpu_torch import telemetry
from sda_tpu_torch.models import dp
from sdabench.reference import fedavg_dp as ref

CPU = "cpu"


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _chi2_pvalue(draws: np.ndarray, sigma: float) -> float:
    """Pearson's χ² of ``draws`` against N_Z(0, σ²): one bin per integer
    whose expected count is at least 20, the two tails beyond as one bin
    each."""
    n = draws.size
    reach = int(sigma * math.sqrt(2 * math.log(n * ref.dgauss_pmf(sigma, [0])[0] / 20)))
    xs = np.arange(-reach, reach + 1)
    expected = n * ref.dgauss_pmf(sigma, xs)
    tail = (n - expected.sum()) / 2
    counts = np.bincount(draws[np.abs(draws) <= reach] + reach, minlength=xs.size)
    observed = np.concatenate([counts, [(draws < -reach).sum(), (draws > reach).sum()]])
    expected = np.concatenate([expected, [tail, tail]])
    chi2 = float(np.sum((observed - expected) ** 2 / expected))
    return float(stats.chi2.sf(chi2, observed.size - 1))


@pytest.mark.parametrize("sigma", [3.0, 40.0])
def test_batched_sampler_follows_the_law(sigma):
    """10^6 draws as one (100, 10,000) block of parties: a χ² goodness of
    fit against the reference's pmf. At a p-value of 1e-6 a sound sampler
    fails once in a million seeds; the discrete Laplace proposal unfiltered
    (its tails e^(-|x|/t)) reads far below it, as does a σ 1 % off."""
    draws = dp.sample_discrete_gaussian(sigma, (100, 10_000), _gen(int(sigma))).numpy().ravel()
    assert _chi2_pvalue(draws, sigma) > 1e-6
    laplace = dp.sample_discrete_laplace(math.floor(sigma) + 1, 1_000_000, _gen(1)).numpy()
    assert _chi2_pvalue(laplace, sigma) < 1e-12
    wide = dp.sample_discrete_gaussian(1.01 * sigma, 1_000_000, _gen(2)).numpy()
    assert _chi2_pvalue(wide, sigma) < 1e-6


@pytest.mark.parametrize("dim", [3, 6000, 100_003])
def test_l2_clip_rows_is_l2_clip_vector_row_by_row(dim):
    """Rows inside the clip come back bit for bit, the others scaled by
    clip / norm: each row as ``l2_clip_vector`` gives it alone, float32 rows
    as their float64 values."""
    rng = np.random.default_rng(dim)
    rows = rng.standard_normal((6, dim)) * np.array([0.1, 0.5, 2.0, 8.0, 1e-3, 30.0])[:, None] / math.sqrt(dim)
    for flat in (torch.from_numpy(rows), torch.from_numpy(rows).to(torch.float32)):
        got = dp.l2_clip_rows(flat, 1.0)
        assert got.dtype == torch.float64 and got.shape == flat.shape
        for i in range(flat.shape[0]):
            assert torch.equal(got[i], dp.l2_clip_vector(flat[i], 1.0, CPU))
        inside = torch.linalg.vector_norm(flat.to(torch.float64), dim=1) <= 1.0
        assert inside.any() and not inside.all()
        assert torch.equal(got[inside], flat[inside].to(torch.float64))
        assert torch.allclose(torch.linalg.vector_norm(got[~inside], dim=1), torch.ones(int((~inside).sum()),
                                                                                        dtype=torch.float64))


TEMPLATE = {"w": np.zeros((40, 30)), "b": np.zeros(30), "s": np.zeros(())}
DIM = 1231


def _fed(l2_clip=1.0, frac_bits=16, n=10, dim=DIM, template=TEMPLATE, seed=9):
    cfg = dp.DPConfig(l2_clip=l2_clip, noise_multiplier=1.0, expected_participants=n)
    spec, _ = dp.DPFederatedAveraging.fitted_spec(frac_bits, cfg, dim)
    return dp.DPFederatedAveraging(spec, template, cfg, _gen(seed), device=CPU)


def _update(rng, scale):
    return {"w": scale * rng.standard_normal((40, 30)), "b": scale * rng.standard_normal(30),
            "s": np.array(scale)}


def test_wire_is_the_chunk_path_at_one_party():
    """``wire`` is ``dp_clip_quantize`` then ``dp_add_noise`` of one row,
    draw for draw on one generator seed; its quantized part is the JAX
    package's clip and quantization (exact inside the clip, within one
    field unit outside, where the norm sums in another order)."""
    fed = _fed()
    jspec = jdp.QuantizationSpec(fed.spec.modulus, fed.spec.frac_bits, fed.spec.clip, fed.spec.n_participants)
    rng = np.random.default_rng(10)
    p = fed.spec.modulus
    for update, tol in ((_update(rng, 1e-3), 0), (_update(rng, 1.0), 1)):
        flat = fed._validated_flat(update)
        q = fed.dp_clip_quantize(flat.unsqueeze(0))
        assert torch.equal(fed.wire(update, generator=_gen(11)), fed.dp_add_noise(q, generator=_gen(11))[0])
        noise = fed.dp.party_noise(fed.spec.scale, DIM, _gen(11))
        assert torch.equal(fed.wire(update, generator=_gen(11)), torch.remainder(q[0] + noise, p))
        want = jspec.quantize(jdp.l2_clip_vector(flat.numpy(), fed.dp.l2_clip)).astype(np.int64)
        diff = (q[0].numpy() - want) % p
        assert np.all(np.minimum(diff, p - diff) <= tol)


def test_wire_noise_follows_the_law():
    """2,000 wires of one party at σ_party ≈ 18.7 (2 fractional bits, 20,000
    coordinates): the wire less its quantized part, centered, passes the χ²
    fit against N_Z(0, σ_party²) at a p-value of 1e-6."""
    template = {"w": np.zeros(20_000)}
    fed = _fed(frac_bits=2, n=16, dim=20_000, template=template)
    sigma = fed.dp.sigma_party_field(fed.spec.scale, 20_000)
    assert 18 < sigma < 19
    update = {"w": np.full(20_000, 0.001)}
    q = fed.dp_clip_quantize(fed._validated_flat(update).unsqueeze(0))[0]
    generator = _gen(12)
    noise = [ref.centered(fed.wire(update, generator=generator) - q, fed.spec.modulus) for _ in range(50)]
    assert _chi2_pvalue(torch.cat(noise).numpy(), sigma) > 1e-6


#: the toy layout of the chunk test: three leaves, 6,000 coordinates
LAYOUT = {"emb": {"embeddings": (40, 100)}, "out": {"kernel": (100, 19), "bias": (100,)}}
TOY_DIM, PARTIES, CHUNK = 6000, 6, 4


def test_the_chunk_path_against_the_plain_reference():
    """Six parties in chunks of 4 and 2 through the engine's two steps, on
    seeded updates of norms 0.5-2 x the clip (three clipped): each
    noise-free row is the reference's clip and quantization exactly, and
    each row's noise (36,000 values at σ_party ≈ 26,770) follows the
    mechanism, within 6 of each number's standard errors at this size (a
    false alarm about once in 10^8 runs a number): the mean square's ratio
    to σ² within 6·√(2/N) = 0.045 of 1, the mean within 6 standard errors of
    0, the excess kurtosis within 6·√(24/N) = 0.16 of 0, and the
    correlation of two parties in a chunk within 6/√6,000 = 0.077 of 0."""
    template = {layer: {name: np.zeros(shape) for name, shape in leaves.items()} for layer, leaves in LAYOUT.items()}
    fed = _fed(n=PARTIES, dim=TOY_DIM, template=template, seed=13)
    assert fed.dim == TOY_DIM
    p, frac_bits = fed.spec.modulus, fed.spec.frac_bits
    updates = torch.randn((PARTIES, TOY_DIM), generator=_gen(14))
    norms = torch.tensor([[0.5], [0.8], [0.95], [1.3], [2.0], [1.7]])
    updates *= norms / torch.linalg.vector_norm(updates, dim=1, keepdim=True)
    rows, wires = [], []
    for start in range(0, PARTIES, CHUNK):
        q = fed.dp_clip_quantize(updates[start: start + CHUNK])
        rows.append(q)
        wires.append(fed.dp_add_noise(q))
    q, wire = torch.cat(rows), torch.cat(wires)
    assert torch.equal(q, ref.quantize_rows(updates, 1.0, frac_bits, p))
    assert wire.min() >= 0 and wire.max() < p
    noise = ref.centered(wire - q, p).to(torch.float64)
    sigma = fed.dp.sigma_party_field(fed.spec.scale, TOY_DIM)
    assert sigma == ref.sigma_party({"dp": {"l2_clip": 1.0, "noise_multiplier": 1.0, "expected_participants": PARTIES},
                                     "quantization": {"frac_bits": frac_bits}, "parameters": TOY_DIM})
    moments = ref.Moments()
    moments.add(noise)
    mean, square, kurtosis = moments.stats()
    n = noise.numel()
    assert abs(square / sigma**2 - 1) < 6 * math.sqrt(2 / n)
    assert abs(mean) < 6 * sigma / math.sqrt(n)
    assert abs(kurtosis) < 6 * math.sqrt(24 / n)
    assert abs(ref.correlation(noise[0], noise[1])) < 6 / math.sqrt(TOY_DIM)
    # the sum of the wires is the reference's data sum plus the noise's sum
    total = ref.centered(torch.remainder(wire.sum(0), p) - ref.data_sum(updates, 1.0, frac_bits, p), p)
    assert torch.equal(total, noise.sum(0).to(torch.int64))


def _ranges(run) -> dict:
    counts = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    for event in prof.events():
        if event.name.startswith("sda.dp") or event.name == "sda.sync.dp_noise_leftover":
            counts[event.name] = counts.get(event.name, 0) + 1
    return counts


def _counter(name):
    return telemetry.counter(name).value()


NAMES = ("sda_dp_noise_proposals_total", "sda_dp_noise_accepted_total", "sda_dp_noise_leftover_passes_total")


def test_a_chunk_syncs_once_and_counts_its_draws():
    """25 parties' noise in one call: one ``sync.dp_noise_leftover`` range,
    not one a party, inside ``dp.noise`` with one ``draw`` and one
    ``accept``; the counters add the pass's proposal budget, 25 x dim
    accepted values and no leftover pass."""
    fed = _fed(seed=15)
    q = fed.dp_clip_quantize(torch.zeros((25, DIM)))
    before = [_counter(name) for name in NAMES]
    counts = _ranges(lambda: fed.dp_add_noise(q))
    after = [_counter(name) for name in NAMES]
    assert counts == {"sda.dp.noise": 1, "sda.dp.noise.draw": 1, "sda.dp.noise.accept": 1,
                      "sda.sync.dp_noise_leftover": 1}
    sigma = fed.dp.sigma_party_field(fed.spec.scale, DIM)
    assert [b - a for a, b in zip(before, after)] == [dp.proposal_budget(sigma, 25 * DIM), 25 * DIM, 0]
    clip = _ranges(lambda: fed.dp_clip_quantize(torch.ones((25, DIM))))
    assert clip == {"sda.dp.clip": 1, "sda.dp.quantize": 1}


def test_leftover_passes_sync_once_each(monkeypatch):
    """With a budget of one proposal a value, a pass leaves about 30 % of them:
    the sampler redraws them in further passes, each with one sync, until
    none remain; the values still follow the law, and the counters count
    every pass's proposals and the values kept."""
    monkeypatch.setattr(dp, "proposal_budget", lambda sigma, n: n)
    before = [_counter(name) for name in NAMES]
    holder = {}
    counts = _ranges(lambda: holder.update(x=dp.sample_discrete_gaussian(3.0, (40, 2_500), _gen(16))))
    after = [_counter(name) for name in NAMES]
    proposals, accepted, leftover = (b - a for a, b in zip(before, after))
    assert accepted == 100_000 and leftover >= 5
    assert counts["sda.sync.dp_noise_leftover"] == leftover + 1 == counts["sda.dp.noise.draw"]
    assert 100_000 < proposals < 2 * 100_000
    draws = holder["x"]
    assert draws.shape == (40, 2_500) and _chi2_pvalue(draws.numpy().ravel(), 3.0) > 1e-6


def test_empty_and_scalar_draws():
    before = _counter("sda_dp_noise_proposals_total")
    assert dp.sample_discrete_gaussian(2.0, (0, 5), _gen()).shape == (0, 5)
    assert _counter("sda_dp_noise_proposals_total") == before  # nothing to draw, no pass, no sync
    assert dp.sample_discrete_gaussian(2.0, (), _gen()).shape == ()


def test_acceptance_rate_and_budget():
    """The acceptance rate against a direct sum of the proposal's law at
    small σ, its limit √(π/2)·e^-½ at large σ, and a budget that leaves
    more than ten standard deviations of the accepted count to spare."""
    for sigma in (0.5, 3.0, 40.0):
        t = math.floor(sigma) + 1
        y = np.arange(-200 * t, 200 * t + 1)
        pmf = (1 - math.exp(-1 / t)) / (1 + math.exp(-1 / t)) * np.exp(-np.abs(y) / t)
        direct = float(np.sum(pmf * np.exp(-((np.abs(y) - sigma**2 / t) ** 2) / (2 * sigma**2))))
        assert abs(dp.acceptance_rate(sigma) - direct) < 1e-12
    limit = math.sqrt(math.pi / 2) * math.exp(-0.5)
    assert 0 < limit - dp.acceptance_rate(6654.23) < 1e-7
    assert dp.acceptance_rate(1e6) == dp.acceptance_rate(1e4)
    n, a = 25 * 4_050_748, dp.acceptance_rate(6654.23)
    m = dp.proposal_budget(6654.23, n)
    assert (m * a - n) / math.sqrt(m * a * (1 - a)) > 10
    assert m < 1.32 * n
