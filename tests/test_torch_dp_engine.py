"""The port's chunk-level DP wire (``sda_tpu_torch/models/dp.py``) on the
CPU: the batched discrete Gaussian sampler against the law, the row clip
against the one-vector clip, ``DPFederatedAveraging.wire`` through the same
code at P = 1, the engine's two steps against the benchmark's plain
reference (``sdabench/reference/fedavg_dp.py``), the sampler's ranges under
a CPU profiler and its count of proposals, and its segment fill
(``sda_tpu_torch/ops/dgauss_cuda.py``, the kernel's plain twin) against
torch's own Philox4x32-10 and a scalar loop over the same stream."""

import math

import numpy as np
import pytest
import torch
from scipy import stats

from sda_tpu.models import dp as jdp
from sda_tpu_torch import telemetry
from sda_tpu_torch.models import dp
from sda_tpu_torch.ops import dgauss_cuda
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


@pytest.mark.parametrize("sigma", [0.5, 3.0, 40.0])
def test_batched_sampler_follows_the_law(sigma):
    """10^6 draws as one (100, 10,000) block of parties: a χ² goodness of
    fit against the reference's pmf. At a p-value of 1e-6 a sound sampler
    fails once in a million seeds; the discrete Laplace proposal unfiltered
    (its tails e^(-|x|/t)) reads far below it, as does a σ 1 % off. At
    σ = 0.5 the segment fill keeps about a third of its proposals."""
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
        if event.name.startswith(("sda.dp", "sda.sync.")):
            counts[event.name] = counts.get(event.name, 0) + 1
    return counts


def test_a_chunk_syncs_once_and_counts_its_draws():
    """25 parties' noise in one call: no ``sync.`` range at all (the segment
    fill keeps no count on the host), ``dp.noise`` with one ``draw`` for
    the 25 x dim values; the CPU's count of proposals (``proposals``) grows
    by the call's, a multiple of 32, and proposals over values read
    1.30-1.50 (1/0.760 for the acceptance, plus the last step's surplus of
    each 256-value segment)."""
    fed = _fed(seed=15)
    q = fed.dp_clip_quantize(torch.zeros((25, DIM)))
    before = dgauss_cuda.proposals("cpu")
    launched = dgauss_cuda.launches
    wires = []
    counts = _ranges(lambda: wires.append(fed.dp_add_noise(q)))
    proposals = dgauss_cuda.proposals("cpu") - before
    assert counts == {"sda.dp.noise": 1, "sda.dp.noise.draw": 1}
    assert wires[0].shape == (25, DIM)
    assert 1.30 < proposals / (25 * DIM) < 1.50
    assert proposals % dgauss_cuda.LANES == 0
    assert dgauss_cuda.launches == launched  # the CPU runs the plain twin
    clip = _ranges(lambda: fed.dp_clip_quantize(torch.ones((25, DIM))))
    assert clip == {"sda.dp.clip": 1, "sda.dp.quantize": 1, "sda.sync.quantize_finite": 1}


def _philox_int(key: int, counter) -> list:
    """Philox4x32-10 in Python integers (Random123's philox4x32_R, R = 10)."""
    k0, k1 = key & 0xFFFFFFFF, key >> 32
    c = list(counter)
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
    return c


def _segment_fill_loop(sigma: float, n: int, key: int):
    """The sampler as a scalar loop: segment by segment, step by step, lane
    by lane over the Philox stream at counter (32 step + lane, segment),
    each accepted proposal taking the segment's next slot until the segment
    holds its ``SEGMENT`` values (fewer in the last); returns the values and
    the proposals drawn (32 a step)."""
    t = math.floor(sigma) + 1
    center, scale = sigma * sigma / t, -1.0 / (2.0 * sigma * sigma)
    size = dgauss_cuda.SEGMENT
    out, drawn = [], 0
    for segment in range(-(-n // size)):
        length, kept, step = min(size, n - segment * size), [], 0
        while len(kept) < length:
            for lane in range(32):
                offset = 32 * step + lane
                w = _philox_int(key, (offset & 0xFFFFFFFF, offset >> 32, segment & 0xFFFFFFFF, segment >> 32))
                a, b, negative = (w[0] << 21) | (w[1] >> 11), (w[2] << 21) | (w[3] >> 11), w[1] & 1
                g = math.floor(math.log((a + 1) * 2.0**-53) * -t)
                dev = g - center
                if not (negative and g == 0) and b * 2.0**-53 < math.exp((dev * dev) * scale) and len(kept) < length:
                    kept.append(-g if negative else g)
            step += 1
            drawn += 32
        out += kept
    return out, drawn


def test_leftover_passes_sync_once_each():
    """The segment fill that took the place of the leftover passes: the
    twin's values equal a scalar loop over the same Philox stream, accepted
    proposals in (step, lane) order, segment by segment, and so does its
    count of proposals; at n not a multiple of the segment, at a
    low-acceptance σ (0.5, a third kept), at σ = 3 and at the DP cell's σ."""
    for sigma, n, seed in ((0.5, 700, 16), (3.0, 513, 17), (6654.23, 300, 18), (40.0, 31, 19)):
        key = dgauss_cuda.draw_key(_gen(seed))
        values, drawn = dgauss_cuda.dgauss_plain(sigma, n, key)
        want, want_drawn = _segment_fill_loop(sigma, n, int(key) % (1 << 64))
        assert values.tolist() == want and int(drawn) == want_drawn, (sigma, n)
        before = dgauss_cuda.proposals("cpu")  # ``sample`` draws the same key first
        assert dgauss_cuda.sample(sigma, n, _gen(seed)).tolist() == want
        assert dgauss_cuda.proposals("cpu") - before == want_drawn, (sigma, n)


#: (key, subsequence, offset) -> the four words of torch's ``at::Philox4_32``
#: (``ATen/core/PhiloxRNGEngine.h``: key = seed, counter = (offset as two
#: words, subsequence as two words)), from a C++ program built against it
PHILOX_VECTORS = {
    (0x0000000000000000, 0x0, 0x0): (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8),
    (0x00003D30F19CD101, 0x0, 0x0): (0x64A3E0F6, 0xD72E25AB, 0x0BE1367B, 0x53ECCF2D),
    (0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF): (0xA426518D, 0x56F1532C, 0x771887B1, 0xCD81A4C4),
    (0x0123456789ABCDEF, 0x6092D, 0x1F): (0x4CD4331C, 0x05592A16, 0x314C0929, 0x2F2D6DF6),
    (0xDEADBEEFCAFEF00D, 0x7, 0x7D11): (0x4E975ED8, 0xDFB4E12A, 0x2CB3A546, 0x2559E2AF),
    (0x8000000000000000, 0x10000000000, 0x100000005): (0xB1261262, 0xE69DFF44, 0xB02D3E64, 0x01663D35),
}


@pytest.mark.parametrize("case", list(PHILOX_VECTORS), ids=lambda c: f"{c[0]:x}-{c[1]:x}-{c[2]:x}")
def test_twin_philox_matches_torch_philox4_32(case):
    """The twin's Philox4x32-10 (int64 tensors, 48-bit partial products)
    and the scalar loop's both give torch's words; the first is Random123's
    known answer for a zero key and counter."""
    key, subsequence, offset = case
    as_i64 = key - (1 << 64) if key >> 63 else key

    def word(v):
        return torch.tensor(v, dtype=torch.int64)

    got = dgauss_cuda.philox(word(as_i64), word(offset & 0xFFFFFFFF), word(offset >> 32),
                             word(subsequence & 0xFFFFFFFF), word(subsequence >> 32))
    want = list(PHILOX_VECTORS[case])
    assert [int(w) for w in got] == want
    assert _philox_int(key, (offset & 0xFFFFFFFF, offset >> 32, subsequence & 0xFFFFFFFF, subsequence >> 32)) == want


def test_moments_at_the_dp_cells_sigma():
    """10^6 draws at σ_party = 6,654.23: the mean square within 6·√(2/N) of
    σ² (N_Z(0, σ²)'s variance is σ² to 1e-300 at this σ), the mean within 6
    standard errors of 0, the excess kurtosis within 6·√(24/N) of 0; the
    discrete Laplace proposal unfiltered reads a kurtosis of 3."""
    sigma, n = 6654.23, 1_000_000
    draws = dp.sample_discrete_gaussian(sigma, (4, n // 4), _gen(21)).to(torch.float64).ravel()
    moments = ref.Moments()
    moments.add(draws)
    mean, square, kurtosis = moments.stats()
    assert abs(square / sigma**2 - 1) < 6 * math.sqrt(2 / n)
    assert abs(mean) < 6 * sigma / math.sqrt(n)
    assert abs(kurtosis) < 6 * math.sqrt(24 / n)
    laplace = ref.Moments()
    laplace.add(dp.sample_discrete_laplace(6655, n, _gen(22)).to(torch.float64))
    assert laplace.stats()[2] > 2.5


def test_same_seed_same_draws_and_successive_calls_differ():
    """A generator seeded alike gives the same draws; each call takes a
    fresh key from it, so two successive calls differ, and a call after
    other draws on the generator differs too."""
    a = dp.sample_discrete_gaussian(20.0, (3, 1000), _gen(23))
    assert torch.equal(a, dp.sample_discrete_gaussian(20.0, (3, 1000), _gen(23)))
    generator = _gen(23)
    first = dp.sample_discrete_gaussian(20.0, (3, 1000), generator)
    second = dp.sample_discrete_gaussian(20.0, (3, 1000), generator)
    assert torch.equal(first, a) and not torch.equal(first, second)
    assert (first == second).double().mean() < 0.1


def test_empty_and_scalar_draws():
    before = dgauss_cuda.proposals("cpu")
    assert dp.sample_discrete_gaussian(2.0, (0, 5), _gen()).shape == (0, 5)
    assert dgauss_cuda.proposals("cpu") == before  # nothing to draw, no key, no launch
    assert dp.sample_discrete_gaussian(2.0, (), _gen()).shape == ()


def test_a_registry_read_calls_nothing_in_the_sampler():
    """After a draw, reading the registry (a snapshot, the Prometheus text)
    runs no code of ``ops/dgauss_cuda.py``, and no ``sda_dp_noise_*`` series is registered:
    the sampler's count stays with ``proposals``, read on demand."""
    import sys

    dp.sample_discrete_gaussian(40.0, (2, 300), _gen(24))
    called = []

    def profile(frame, event, arg):
        if event == "call" and frame.f_code.co_filename == dgauss_cuda.__file__:
            called.append(frame.f_code.co_name)

    sys.setprofile(profile)
    try:
        snap = telemetry.snapshot()
        telemetry.prometheus_text()
    finally:
        sys.setprofile(None)
    assert called == []
    names = {row["name"] for kind in ("counters", "gauges", "histograms") for row in snap[kind]}
    names |= set(telemetry.get_registry().snapshot()["meta"])
    assert not [name for name in names if name.startswith("sda_dp_noise")]


def test_acceptance_rate_and_budget():
    """The acceptance rate against a direct sum of the proposal's law at
    small σ and its limit √(π/2)·e^-½ at large σ; the segment fill's share
    of proposals kept is that rate times the sign test's (1 + e^(-1/t))/2."""
    for sigma in (0.5, 3.0, 40.0):
        t = math.floor(sigma) + 1
        y = np.arange(-200 * t, 200 * t + 1)
        pmf = (1 - math.exp(-1 / t)) / (1 + math.exp(-1 / t)) * np.exp(-np.abs(y) / t)
        direct = float(np.sum(pmf * np.exp(-((np.abs(y) - sigma**2 / t) ** 2) / (2 * sigma**2))))
        assert abs(dp.acceptance_rate(sigma) - direct) < 1e-12
        assert dgauss_cuda.draw_rate(sigma) == (1 + math.exp(-1 / t)) / 2 * dp.acceptance_rate(sigma)
    limit = math.sqrt(math.pi / 2) * math.exp(-0.5)
    assert 0 < limit - dp.acceptance_rate(6654.23) < 1e-7
    assert dp.acceptance_rate(1e6) == dp.acceptance_rate(1e4)
    assert 0.7600 < dgauss_cuda.draw_rate(6654.23) < 0.7602
