"""The port's FedAvg drivers (``FederatedAveraging``,
``WeightedFederatedAveraging``) and server optimizers (``FedAvgM``,
``FedAdam``) against ``sda_tpu.models`` on the CPU, on the same
numpy-seeded inputs: wire vectors, means and refusals bit for bit, the
optimizers' steps and states bit for bit (FedAdam's CPU square root is
numpy's, as the reference's); and the slice as a whole: ``chip_smoke.model_round``
with the kernels' plain versions against the reference's protocol-plane
rounds through the mem server."""

import dataclasses
import random

import jax  # noqa: F401  (the reference's drivers flatten with jax)
import numpy as np
import pytest
import torch

import chip_smoke
from sda_fixtures import new_client, new_committee_setup, with_service
from sda_tpu.models import FedAdam as JFedAdam
from sda_tpu.models import FedAvgM as JFedAvgM
from sda_tpu.models import FederatedAveraging as JFed
from sda_tpu.models import QuantizationSpec as JSpec
from sda_tpu.models import WeightedFederatedAveraging as JWeighted
from sda_tpu.models import flatten_pytree as jflatten
from sda_tpu.models import unflatten_pytree as junflatten
from sda_tpu_torch.models import (
    FedAdam,
    FedAvgM,
    FederatedAveraging,
    QuantizationSpec,
    WeightedFederatedAveraging,
    flatten_pytree,
)

CPU = "cpu"
# a narrow model of the FedAvg paper's CNN (tests/test_torch_models.py's),
# keys out of sorted order
NARROW_CNN = {
    "dense2": {"kernel": (16, 10), "bias": (10,)},
    "conv1": {"kernel": (3, 3, 1, 4), "bias": (4,)},
    "dense1": {"kernel": (392, 16), "bias": (16,)},
    "conv2": {"kernel": (3, 3, 4, 8), "bias": (8,)},
}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _tree(rng, scale, dtype=np.float64, clip=None):
    def leaf(shape):
        x = scale * rng.standard_normal(shape)
        return (x if clip is None else np.clip(x, -clip, clip)).astype(dtype)

    return {layer: {name: leaf(shape) for name, shape in leaves.items()}
            for layer, leaves in NARROW_CNN.items()}


def _flat(tree) -> np.ndarray:
    return np.asarray(flatten_pytree(tree, CPU)[0])


def _assert_trees_equal(got, want):
    for layer, leaves in NARROW_CNN.items():
        for name in leaves:
            assert np.array_equal(np.asarray(got[layer][name]), want[layer][name]), (layer, name)


@pytest.fixture
def seeded_roots(monkeypatch):
    """``fitted`` draws its roots of unity unseeded in both packages: pin the
    unseeded ``random.Random`` for both."""
    real = random.Random
    monkeypatch.setattr(random, "Random", lambda seed=None: real(0 if seed is None else seed))


def _weighted_pair(frac_bits=15, clip=1.0, max_weight=600.0, n=10, template=None):
    template = _tree(_rng(0), 0.0) if template is None else template
    jfed, _ = JWeighted.fitted(frac_bits, clip, max_weight, n, template)
    spec = QuantizationSpec(jfed.spec.modulus, jfed.spec.frac_bits, jfed.spec.clip, n)
    return jfed, WeightedFederatedAveraging(spec, template, clip, max_weight, device=CPU)


@pytest.mark.parametrize("frac_bits,clip,max_weight,n",
                         [(15, 1.0, 600.0, 10), (16, 0.5, 1.0, 100), (8, 4.0, 3.5, 7), (20, 2.0, 50.0, 1000)])
def test_weighted_fitted_matches_reference(seeded_roots, frac_bits, clip, max_weight, n):
    template = {"w": np.zeros((3, 2)), "b": np.zeros(2)}
    jfed, jscheme = JWeighted.fitted(frac_bits, clip, max_weight, n, template)
    fed, scheme = WeightedFederatedAveraging.fitted(frac_bits, clip, max_weight, n, template, device=CPU)
    assert (fed.spec.modulus, fed.spec.clip, fed.spec.frac_bits, fed.spec.n_participants) == (
        jfed.spec.modulus, jfed.spec.clip, jfed.spec.frac_bits, jfed.spec.n_participants)
    assert (scheme.prime_modulus, scheme.omega_secrets, scheme.omega_shares) == (
        jscheme.prime_modulus, jscheme.omega_secrets, jscheme.omega_shares)
    assert (fed.dim, fed.wire_dimension, fed.clip, fed.max_weight) == (
        jfed.dim, jfed.wire_dimension, jfed.clip, jfed.max_weight)


def _weighted_cases():
    rng = _rng(1)
    s = 2.0 ** -15
    edge = _tree(rng, 0.3, clip=1.0)
    # coordinates at the clip and products landing on exact halves of the grid
    edge["conv1"]["bias"][:] = [1.0, -1.0, 0.5 * s, -2.5 * s / 3.0]
    return {
        "integer weight": (_tree(rng, 0.3, clip=1.0), 600),
        "fractional weight": (_tree(rng, 0.3, clip=1.0), 17.25),
        "small weight": (_tree(rng, 0.3, clip=1.0), 1e-3),
        "edges": (edge, 3),
        "float32 leaves": (_tree(rng, 0.3, np.float32, clip=1.0), 250),
    }


@pytest.mark.parametrize("name", list(_weighted_cases()))
def test_weighted_wire_bit_equal(name):
    tree, weight = _weighted_cases()[name]
    jfed, fed = _weighted_pair()
    got = fed.wire(tree, weight)
    assert got.dtype == torch.int64 and got.shape == (fed.wire_dimension,)
    assert np.array_equal(got.numpy(), jfed._quantized_wire(tree, weight))


def _refusals():
    rng = _rng(2)
    ok = _tree(rng, 0.3, clip=1.0)
    big = _tree(rng, 0.3, clip=1.0)
    big["dense2"]["bias"][3] = 1.5
    transposed = _tree(rng, 0.3, clip=1.0)
    transposed["dense2"]["kernel"] = transposed["dense2"]["kernel"].T.copy()
    missing = _tree(rng, 0.3, clip=1.0)
    del missing["conv2"]
    return {
        "zero weight": (ok, 0.0),
        "negative weight": (ok, -1.0),
        "weight above max": (ok, 600.5),
        "coordinate above clip": (big, 5.0),
        "transposed leaf": (transposed, 5.0),
        "missing layer": (missing, 5.0),
    }


@pytest.mark.parametrize("name", list(_refusals()))
def test_weighted_refusals_match_reference(name):
    tree, weight = _refusals()[name]
    jfed, fed = _weighted_pair()
    with pytest.raises(ValueError) as jerr:
        jfed._quantized_wire(tree, weight)
    with pytest.raises(ValueError) as err:
        fed.wire(tree, weight)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("clip,max_weight", [(0.0, 1.0), (1.0, -2.0), (2.0, 600.0), (1.0, 700.0)])
def test_weighted_constructor_refusals_match_reference(clip, max_weight):
    spec_args = (1073741833, 15, 600.0, 10)
    template = {"w": np.zeros(3)}
    with pytest.raises(ValueError) as jerr:
        JWeighted(JSpec(*spec_args), template, clip, max_weight)
    with pytest.raises(ValueError) as err:
        WeightedFederatedAveraging(QuantizationSpec(*spec_args), template, clip, max_weight, device=CPU)
    assert str(err.value) == str(jerr.value)


def _reference_weighted_finish(jfed, field_sum):
    """``WeightedFederatedAveraging.finish_round`` after the reveal."""
    sums = jfed.spec.dequantize_sum(field_sum)
    total = float(sums[-1])
    return junflatten(jfed._weighted_flat(sums, total), jfed.treedef, jfed.shapes), total


def test_weighted_finish_bit_equal():
    jfed, fed = _weighted_pair()
    rng = _rng(3)
    wires = [jfed._quantized_wire(_tree(rng, 0.3, clip=1.0), w) for w in (600, 1.5, 42, 0.125)]
    field_sum = np.sum(wires, axis=0) % jfed.spec.modulus
    want, want_total = _reference_weighted_finish(jfed, field_sum)
    got, total = fed.mean_from_field_sum(torch.from_numpy(field_sum), len(wires))
    assert total == want_total == 643.625
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("n,total", [(0, 1), (11, 1), (3, 0), (3, -2)])
def test_finish_refusals_match_reference(n, total):
    """No submission, more than the field holds, and a non-positive revealed
    weight: refused as ``reveal_field_sum`` and ``_weighted_flat`` refuse."""
    jfed, fed = _weighted_pair()
    field_sum = np.zeros(fed.wire_dimension, dtype=np.int64)
    field_sum[-1] = (total * jfed.spec.scale) % jfed.spec.modulus
    with pytest.raises(ValueError) as err:
        fed.mean_from_field_sum(torch.from_numpy(field_sum), n)
    if n <= 0:
        assert str(err.value) == "no updates were submitted; nothing to reveal"
    elif n > jfed.spec.n_participants:
        assert "the field only holds 10 without wraparound" in str(err.value)
    else:
        with pytest.raises(ValueError) as jerr:
            _reference_weighted_finish(jfed, field_sum)
        assert str(err.value) == str(jerr.value)


def test_plain_driver_matches_reference():
    jspec = JSpec(268_435_873, 16, 8.0, 100)
    spec = QuantizationSpec(268_435_873, 16, 8.0, 100)
    rng = _rng(4)
    template = _tree(rng, 0.0)
    jfed, fed = JFed(jspec, template), FederatedAveraging(spec, template, device=CPU)
    assert (fed.dim, fed.wire_dimension, fed.shapes) == (jfed.dim, jfed.wire_dimension, jfed.shapes)
    updates = [_tree(rng, 3.0) for _ in range(5)]
    wires = []
    for u in updates:
        got = fed.wire(u)
        want = jspec.quantize(jfed._validated_flat(u))
        assert np.array_equal(got.numpy(), want)
        wires.append(want)
    field_sum = np.sum(wires, axis=0) % spec.modulus
    from sda_tpu.models import dequantize_mean as jdequantize_mean

    want_mean = jdequantize_mean(field_sum, 5, jspec, jfed.treedef, jfed.shapes)
    _assert_trees_equal(fed.mean_from_field_sum(torch.from_numpy(field_sum), 5), want_mean)


# -- server optimizers --------------------------------------------------------


def _steps(rng, count=3):
    return [_tree(rng, 0.01) for _ in range(count)]


@pytest.mark.parametrize("kind", ["FedAvgM", "FedAvgM lr=0.5", "FedAdam", "FedAdam exact sqrt"])
def test_optimizer_steps_match_reference(kind, monkeypatch):
    if kind == "FedAdam exact sqrt":
        # the port's CPU step takes numpy's sqrt whatever torch.sqrt does
        monkeypatch.setattr(torch, "sqrt", lambda x: torch.from_numpy(np.sqrt(x.numpy())))
    rng = _rng(5)
    model = _tree(rng, 0.05, np.float32)
    port, ref = {
        "FedAvgM": (FedAvgM(device=CPU), JFedAvgM()),
        "FedAvgM lr=0.5": (FedAvgM(momentum=0.5, lr=0.5, device=CPU), JFedAvgM(momentum=0.5, lr=0.5)),
        "FedAdam": (FedAdam(device=CPU), JFedAdam()),
        "FedAdam exact sqrt": (FedAdam(lr=0.05, tau=1e-4, device=CPU), JFedAdam(lr=0.05, tau=1e-4)),
    }[kind]
    got_model, want_model = model, model
    for update in _steps(rng):
        got_model = port(got_model, update)
        want_model = ref(want_model, update)
        got, want = _flat(got_model), jflatten(want_model)[0]
        assert np.array_equal(got, want)
    state = port.state()
    assert set(state) == set(ref.state())
    for key, value in ref.state().items():
        assert np.array_equal(np.asarray(state[key]), np.asarray(value)), key


@pytest.mark.parametrize("kind", ["FedAvgM", "FedAdam"])
def test_optimizer_state_crosses_packages(kind):
    """A state saved by one package resumes in the other: one step of each
    from the other's state gives what the saver's next step gives."""
    rng = _rng(6)
    model = _tree(rng, 0.05)
    first, second = _steps(rng, 2)
    make = {"FedAvgM": (lambda: FedAvgM(device=CPU), JFedAvgM),
            "FedAdam": (lambda: FedAdam(device=CPU), JFedAdam)}[kind]
    ref = make[1]()
    mid = ref(model, first)
    state = ref.state()
    port = make[0]()
    assert port.state() == {}
    port.load_state(state)
    got = _flat(port(mid, second))
    want = jflatten(ref(mid, second))[0]
    assert np.array_equal(got, want)
    # and back: the port's state loads into the reference
    port_state = port.state()
    assert set(port_state) == set(ref.state())
    back = make[1]()
    back.load_state(port_state)
    for key, value in ref.state().items():
        assert np.array_equal(np.asarray(back.state()[key]), np.asarray(value)), key


@pytest.mark.parametrize("kwargs", [{"momentum": 1.0}, {"momentum": -0.1}])
def test_fedavgm_refusals_match_reference(kwargs):
    with pytest.raises(ValueError) as jerr:
        JFedAvgM(**kwargs)
    with pytest.raises(ValueError) as err:
        FedAvgM(**kwargs, device=CPU)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("kwargs", [{"beta1": 1.0}, {"beta2": -0.5}, {"tau": 0.0}])
def test_fedadam_refusals_match_reference(kwargs):
    with pytest.raises(ValueError) as jerr:
        JFedAdam(**kwargs)
    with pytest.raises(ValueError) as err:
        FedAdam(**kwargs, device=CPU)
    assert str(err.value) == str(jerr.value)


# -- the slice as a whole ------------------------------------------------------


def _reference_round(tmp_path, jfed, jscheme, updates, weights=None, wires=None):
    """The reference's protocol-plane round through the mem server: each
    participant submits its update through ``submit_update`` or, given
    ``wires``, participates with that field vector as it stands."""
    with with_service() as ctx:
        recipient, rkey, clerks = new_committee_setup(tmp_path, ctx.service)
        agg_id = jfed.open_round(recipient, rkey, jscheme)
        for i, update in enumerate(updates):
            part = new_client(tmp_path / f"part{i}", ctx.service)
            part.upload_agent()
            if wires is not None:
                part.participate(wires[i], agg_id)
            elif weights is None:
                jfed.submit_update(part, agg_id, update)
            else:
                jfed.submit_update(part, agg_id, update, weights[i])
        jfed.close_round(recipient, agg_id)
        for worker in [recipient] + clerks:
            worker.run_chores(-1)
        return jfed.finish_round(recipient, agg_id, len(updates))


def test_weighted_round_matches_reference_protocol_round(tmp_path, seeded_roots):
    rng = _rng(7)
    global_model = _tree(rng, 0.05, np.float32)
    updates = [_tree(rng, 0.3, clip=1.0) for _ in range(4)]
    weights = [600, 17, 1, 333]
    jfed, jscheme = JWeighted.fitted(15, 1.0, 600, 10, global_model)
    fed, scheme = WeightedFederatedAveraging.fitted(15, 1.0, 600, 10, global_model, device=CPU)
    assert (scheme.prime_modulus, scheme.omega_secrets) == (jscheme.prime_modulus, jscheme.omega_secrets)

    want_mean, want_total = _reference_round(tmp_path, jfed, jscheme, updates, weights)
    want_global = JFedAvgM()(global_model, want_mean)
    seeds = rng.integers(0, 1 << 32, size=(4, 4), dtype=np.uint64).astype(np.uint32)
    out = chip_smoke.model_round(fed, updates, global_model, FedAvgM(device=CPU), scheme, seeds,
                                 torch.Generator().manual_seed(0), weights, chunk=3)
    assert out["total_weight"] == want_total == 951.0
    _assert_trees_equal(out["mean"], want_mean)
    _assert_trees_equal(out["new_global"], want_global)
    wires = np.stack([jfed._quantized_wire(u, w) for u, w in zip(updates, weights)])
    assert np.array_equal(out["wires"].numpy(), wires)
    assert np.array_equal(out["field_sum"].numpy(), wires.sum(axis=0) % fed.spec.modulus)
    assert set(out["seconds"]) == {"wire_s", "masking_s", "sharing_s", "reveal_s", "finish_s",
                                   "apply_s", "wall_s"}


def test_dp_round_wires_through_reference_protocol_round(tmp_path):
    """The port's DP wires (clipped, quantized, noised on a seeded generator)
    through the port's engine round and, as raw participations, through the
    reference's protocol round: one field sum, bit-equal means, and FedAdam
    steps bit for bit."""
    from sda_tpu.models import DPConfig as JDPConfig
    from sda_tpu.models import DPFederatedAveraging as JDPFed
    from sda_tpu_torch.models import DPConfig, DPFederatedAveraging

    rng = _rng(8)
    global_model = _tree(rng, 0.05, np.float32)
    updates = [_tree(rng, 0.3) for _ in range(4)]
    dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, expected_participants=4)
    jdp = JDPConfig(l2_clip=1.0, noise_multiplier=1.0, expected_participants=4)
    spec, scheme = DPFederatedAveraging.fitted_spec(16, dp, _flat(global_model).size)
    jspec = JSpec(spec.modulus, spec.frac_bits, spec.clip, spec.n_participants)
    from sda_tpu.protocol import PackedShamirSharing as JPacked

    jscheme = JPacked(scheme.secret_count, scheme.share_count, scheme.privacy_threshold,
                      scheme.prime_modulus, scheme.omega_secrets, scheme.omega_shares)
    fed = DPFederatedAveraging(spec, global_model, dp, torch.Generator().manual_seed(9), device=CPU)
    jfed = JDPFed(jspec, global_model, jdp, rng=_rng(10))
    seeds = rng.integers(0, 1 << 32, size=(4, 4), dtype=np.uint64).astype(np.uint32)
    out = chip_smoke.model_round(fed, updates, global_model, FedAdam(device=CPU), scheme, seeds,
                                 torch.Generator().manual_seed(0), chunk=3)
    wires = out["wires"].numpy()
    want_mean = _reference_round(tmp_path, jfed, jscheme, updates, wires=list(wires))
    assert np.array_equal(out["field_sum"].numpy(), wires.sum(axis=0) % spec.modulus)
    _assert_trees_equal(out["mean"], want_mean)
    want_global = jflatten(JFedAdam()(global_model, want_mean))[0]
    assert np.array_equal(_flat(out["new_global"]), want_global)
    assert fed.privacy().n_parties == 4
    assert dataclasses.astuple(fed.privacy()) == dataclasses.astuple(jfed.privacy())


def test_drivers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    spec = QuantizationSpec(1073741833, 15, 600.0, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedAveraging(spec, {"w": np.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WeightedFederatedAveraging(spec, {"w": np.zeros(2)}, 1.0, 600)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedAvgM()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedAdam()
