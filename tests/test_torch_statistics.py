"""The port's statistics, evaluation and DP statistics drivers against
``sda_tpu`` on the CPU.

Each noise-free class runs one sealed round in each package on the same
seeded inputs (a recipient and 8 clerks on each package's memory server):
integer results (counts, frequencies, distinct-count bins) must be equal
exactly, float results bit-equal where the reference computes elementwise;
the correlation is within 4 ulps (torch's CPU ``sqrt`` is not correctly
rounded at ~1 % of inputs; CUDA's is), and ``principal_components`` within
1e-9 after its sign normalisation. Each DP class runs one round in the
port, and is held to its law (the revealed sum less the reference's
noise-free quantization of the same inputs), to the reference's accountant
within 1e-12 relative, and its ``finish`` to the reference's ``finish`` of
the same revealed sum, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sda_tpu.models import dp as jdp
from sda_tpu.models import evaluation as jevaluation
from sda_tpu.models import statistics as jstatistics
from sda_tpu.models.dp import l2_clip_vector
from sda_tpu_torch.models import dp as tdp
from sda_tpu_torch.models import evaluation as tevaluation
from sda_tpu_torch.models import statistics as tstatistics
from test_torch_fedavg_round import Deployment

CPU = "cpu"
N = 4  # participants a round


def _both(tmp_path, cls_name, args, kwargs, inputs, finish="finish", finish_args=()):
    """One round of ``cls_name`` in each package on the same inputs;
    returns (port result, reference result, port object, reference object)."""
    port_mod = {"SecureEvaluation": tevaluation}.get(cls_name, tstatistics)
    ref_mod = {"SecureEvaluation": jevaluation}.get(cls_name, jstatistics)
    ours = getattr(port_mod, cls_name)(*args, **kwargs, device=CPU)
    theirs = getattr(ref_mod, cls_name)(*args, **kwargs)
    results = []
    for package, query in (("port", ours), ("ref", theirs)):
        deployment = Deployment(tmp_path / package, package)
        submit = (lambda part, agg, x, q=query: q.submit(part, agg, *x)) if cls_name == "SecureEvaluation" \
            else None
        agg = deployment.round(query, inputs, submit=submit)
        results.append(getattr(query, finish)(deployment.recipient, agg, len(inputs), *finish_args))
    return results[0], results[1], ours, theirs


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rng(seed):
    return np.random.default_rng(seed)


def test_secure_statistics(tmp_path):
    inputs = [_rng(i).uniform(-4.0, 4.0, size=6) for i in range(N)]
    got, want, _, _ = _both(tmp_path, "SecureStatistics", (6, 4.0, 5), {}, inputs)
    assert got["count"] == want["count"] == N
    np.testing.assert_array_equal(_host(got["mean"]), want["mean"])
    np.testing.assert_array_equal(_host(got["variance"]), want["variance"])
    assert got["mean"].dtype == torch.float64


def test_secure_covariance_correlation_and_components(tmp_path):
    base = _rng(2).uniform(-1.0, 1.0, size=(N, 1))
    inputs = [np.clip(np.concatenate([b, 0.8 * b + 0.1 * _rng(10 + i).standard_normal(3)]), -2.0, 2.0)
              for i, b in enumerate(base)]
    got, want, ours, theirs = _both(tmp_path, "SecureCovariance", (4, 2.0, 5), {}, inputs,
                                    finish="finish_correlation")
    assert got["count"] == want["count"]
    np.testing.assert_array_equal(_host(got["mean"]), want["mean"])
    np.testing.assert_array_equal(_host(got["covariance"]), want["covariance"])
    np.testing.assert_array_max_ulp(_host(got["correlation"]), want["correlation"], maxulp=4)
    values, components = tstatistics.SecureCovariance.principal_components(got["covariance"], 2)
    jvalues, jcomponents = jstatistics.SecureCovariance.principal_components(want["covariance"], 2)
    np.testing.assert_allclose(_host(values), jvalues, rtol=0, atol=1e-9)
    np.testing.assert_allclose(_host(components), jcomponents, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match=r"k must be in \[1, 4\]"):
        tstatistics.SecureCovariance.principal_components(got["covariance"], 5)


def test_secure_histogram_counts_are_exact(tmp_path):
    # values outside [lo, hi) clamp to the edge bins, as the reference's do
    inputs = [np.concatenate([_rng(20 + i).uniform(-1.5, 3.5, size=40), [1e300, -1e300]]) for i in range(N)]
    got, want, ours, theirs = _both(tmp_path, "SecureHistogram", (12, -1.0, 3.0, 5), {}, inputs)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for values in inputs:
        np.testing.assert_array_equal(ours.local_counts(values).numpy(), theirs.local_counts(values))


def test_secure_quantiles(tmp_path):
    inputs = [_rng(30 + i).gamma(2.0, 1.0, size=50) for i in range(N)]
    qs = [0.0, 0.25, 0.5, 0.9, 1.0]
    got, want, _, _ = _both(tmp_path, "SecureQuantiles", (16, 0.0, 8.0, 5), {}, inputs,
                            finish="finish_quantiles", finish_args=(qs,))
    np.testing.assert_array_equal(_host(got), want)


def test_secure_frequency_top_k(tmp_path):
    inputs = [_rng(40 + i).zipf(1.6, size=30) % 20 for i in range(N)]
    got, want, ours, theirs = _both(tmp_path, "SecureFrequency", (20, 5), {}, inputs,
                                    finish="finish_top_k", finish_args=(5,))
    assert got == want
    for bad in (np.array([0.5]), np.array([20]), np.array([-1])):
        with pytest.raises(ValueError) as err:
            ours.local_counts(bad)
        with pytest.raises(ValueError) as jerr:
            theirs.local_counts(bad)
        assert str(err.value) == str(jerr.value)


def test_secure_count_distinct(tmp_path):
    rng = _rng(50)
    inputs = [[f"user-{int(v)}" for v in rng.integers(0, 90, size=40)] + [3, 3.0, 2.5, b"raw"]
              for _ in range(N)]
    kwargs = {"salt": "round-7"}
    got, want, ours, theirs = _both(tmp_path, "SecureCountDistinct", (256, 5), kwargs, inputs,
                                    finish="finish_estimate")
    assert got == want
    for items in inputs:
        np.testing.assert_array_equal(ours.local_counts(items).numpy(), theirs.local_counts(items))


def test_secure_grouped_mean(tmp_path):
    rng = _rng(60)
    # category 2 gets no observation: its mean row is NaN in both
    inputs = [[(int(c), rng.uniform(-3.0, 3.0, size=2)) for c in rng.integers(0, 2, size=3)]
              for _ in range(N)]
    got, want, _, _ = _both(tmp_path, "SecureGroupedMean", (3, 2, 3.0, 5), {}, inputs)
    assert got["counts"].dtype == torch.int64
    np.testing.assert_array_equal(got["counts"].numpy(), want["counts"])
    np.testing.assert_array_equal(_host(got["means"]), want["means"])
    assert np.isnan(want["means"][2]).all()


def test_secure_evaluation(tmp_path):
    rng = _rng(70)
    inputs = [({"loss": float(rng.uniform(0, 3)), "acc": float(rng.uniform(0, 1))}, int(n))
              for n in rng.integers(1, 500, size=N)]
    got, want, _, _ = _both(tmp_path, "SecureEvaluation", (["loss", "acc"], 5),
                            {"max_examples": 1000}, inputs)
    assert set(got) == set(want) == {"loss", "acc", "examples"}
    assert got["examples"] == want["examples"] == sum(n for _, n in inputs)
    for name in ("loss", "acc"):
        assert float(got[name]) == float(want[name])


# -- the DP drivers ----------------------------------------------------------------


def _dp_case(name):
    """(port class, reference class, args, kwargs, inputs)."""
    rng = _rng(80)
    kw = {"noise_multiplier": 1.0}
    if name == "DPSecureStatistics":
        inputs = [rng.uniform(-1.0, 1.0, size=64) for _ in range(N)]
        return tdp.DPSecureStatistics, jdp.DPSecureStatistics, (64, 1.0, 5), kw, inputs
    if name == "DPSecureCovariance":
        inputs = [rng.uniform(-1.0, 1.0, size=6) for _ in range(N)]
        return tdp.DPSecureCovariance, jdp.DPSecureCovariance, (6, 1.0, 5), kw, inputs
    if name == "DPSecureHistogram":
        inputs = [rng.uniform(0.0, 1.0, size=30) for _ in range(N)]
        return (tdp.DPSecureHistogram, jdp.DPSecureHistogram, (128, 0.0, 1.0, 5),
                {**kw, "max_values_per_participant": 30}, inputs)
    if name == "DPSecureGroupedMean":
        inputs = [[(int(c), rng.uniform(-1.0, 1.0, size=4)) for c in rng.integers(0, 3, size=5)]
                  for _ in range(N)]
        return (tdp.DPSecureGroupedMean, jdp.DPSecureGroupedMean, (4, 4, 1.0, 5),
                {**kw, "max_values_per_participant": 8}, inputs)
    inputs = [({"loss": float(rng.uniform(0, 3)), "acc": float(rng.uniform(0, 1))}, int(n))
              for n in rng.integers(1, 500, size=N)]
    return (tevaluation.DPSecureEvaluation, jevaluation.DPSecureEvaluation, (["loss", "acc"], 5),
            {**kw, "max_examples": 1000}, inputs)


def _reference_tree(theirs, x):
    """The reference's channel for one input, before quantization."""
    if isinstance(theirs, jdp.DPSecureHistogram):
        return {"counts": theirs.local_counts(x)}
    if isinstance(theirs, jdp.DPSecureGroupedMean):
        return theirs.local_scatter(x)
    return theirs._checked_tree(x)


def _clean_sum(theirs, inputs) -> np.ndarray:
    fed = theirs.fed
    if isinstance(theirs, jevaluation.DPSecureEvaluation):
        rows = [fed._quantized_wire({"metrics": np.array([m[k] for k in theirs.metric_names])}, n)
                for m, n in inputs]
    else:
        rows = [fed.spec.quantize(l2_clip_vector(fed._validated_flat(_reference_tree(theirs, x)),
                                                 fed.dp.l2_clip)) for x in inputs]
    return np.sum(rows, axis=0) % fed.spec.modulus


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _assert_same(got[key], want[key])
    else:
        np.testing.assert_array_equal(_host(got), np.asarray(want))


@pytest.mark.parametrize("name", ["DPSecureStatistics", "DPSecureCovariance", "DPSecureHistogram",
                                  "DPSecureGroupedMean", "DPSecureEvaluation"])
def test_dp_driver_holds_its_law_accountant_and_finish(tmp_path, name):
    port_cls, ref_cls, args, kwargs, inputs = _dp_case(name)
    ours = port_cls(*args, **kwargs, generator=torch.Generator().manual_seed(9), device=CPU)
    theirs = ref_cls(*args, **kwargs, rng=np.random.default_rng(9))
    assert ours.fed.spec.modulus == theirs.fed.spec.modulus
    assert dataclasses.asdict(ours.fed.dp) == dataclasses.asdict(theirs.fed.dp)
    deployment = Deployment(tmp_path, "port")
    submit = (lambda part, agg, x: ours.submit(part, agg, *x)) if "Evaluation" in name else None
    agg = deployment.round(ours, inputs, submit=submit)
    field_sum = ours.fed.reveal_field_sum(deployment.recipient, agg, N).numpy()
    p = ours.fed.spec.modulus
    noise = (field_sum - _clean_sum(theirs, inputs)) % p
    noise = np.where(noise > p // 2, noise - p, noise).astype(np.float64)
    account = ours.privacy()
    sigma = account.sigma_total
    assert abs(noise.std() / sigma - 1.0) < 5.0 / np.sqrt(2 * noise.size)
    assert abs(noise.mean()) < 5.0 * sigma / np.sqrt(noise.size)
    assert np.abs(noise).max() < 12.0 * sigma and np.count_nonzero(noise) > 0
    want_account = theirs.privacy(N)
    assert account.n_parties == want_account.n_parties == N
    for field in ("epsilon", "delta", "rho", "sigma_total", "l2_sensitivity"):
        assert getattr(account, field) == pytest.approx(getattr(want_account, field), rel=1e-12)
    # the same revealed sum through each package's finish
    got = ours.finish(deployment.recipient, agg, N)
    theirs.fed.reveal_field_sum = lambda *a: field_sum
    _assert_same(got, theirs.finish(None, None, N))


@pytest.mark.parametrize("make", [
    lambda: tstatistics.SecureStatistics(4, 1.0, 5),
    lambda: tstatistics.SecureHistogram(8, 0.0, 1.0, 5),
    lambda: tstatistics.SecureCountDistinct(64, 5),
    lambda: tevaluation.SecureEvaluation(["loss"], 5),
    lambda: tdp.DPSecureHistogram(8, 0.0, 1.0, 5, noise_multiplier=1.0),
], ids=["statistics", "histogram", "count-distinct", "evaluation", "dp-histogram"])
def test_drivers_default_to_cuda(make):
    """Without ``device``, a driver is made for CUDA: on a host without a
    GPU that raises instead of running elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default driver is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
