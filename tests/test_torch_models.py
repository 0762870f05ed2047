"""The port's model plane (``sda_tpu_torch/models``, ``ops/shamir.verify_scheme``)
against ``sda_tpu.models`` and ``sda_tpu.ops.verify_scheme`` on the CPU, on
the same numpy-seeded inputs. Flattening, quantization, dequantization and
``fedavg_apply`` are compared bit for bit; so is the slice as a whole: the
reference's protocol-plane FedAvg round through the mem server against
``chip_smoke.fedavg_round`` with the kernels' plain versions."""

import random
from collections import OrderedDict, namedtuple

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from sda_fixtures import new_client, with_service
from sda_tpu.models import FederatedAveraging
from sda_tpu.models import QuantizationSpec as JSpec
from sda_tpu.models import dequantize_mean as jdequantize_mean
from sda_tpu.models import flatten_pytree as jflatten
from sda_tpu.models import quantize_update as jquantize_update
from sda_tpu.models import unflatten_pytree as junflatten
from sda_tpu.models.federated import tree_layout as jtree_layout
from sda_tpu.models.trainer import FederatedTrainer
from sda_tpu.ops import verify_scheme as jverify_scheme
from sda_tpu.protocol import BasicShamirSharing as JBasic
from sda_tpu.protocol import PackedShamirSharing as JPacked
from sda_tpu_torch.models import (
    QuantizationSpec,
    dequantize_mean,
    fedavg_apply,
    flatten_pytree,
    quantize_update,
    tree_flatten,
    tree_layout,
    tree_unflatten,
    unflatten_pytree,
)
from sda_tpu_torch.ops import verify_scheme
from sda_tpu_torch.protocol import BasicShamirSharing, PackedShamirSharing

CPU = "cpu"
Pair = namedtuple("Pair", "weight offset")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _trees():
    """The reference's test trees, the leaf-order hazard tree, and the other
    node kinds, with numpy, torch and Python-scalar leaves."""
    rng = _rng(1)
    arr = lambda *shape: rng.standard_normal(shape)  # noqa: E731
    return {
        "template": {"w": np.zeros((3, 2)), "b": np.zeros(2), "scalar": np.zeros(())},
        "roundtrip": {"w": np.arange(6.0).reshape(3, 2), "b": np.array([7.0, 8.0]),
                      "scalar": np.array(9.0)},
        "hazard": {"b": arr(2), "a": (arr(1), None), "c": [arr(2, 2)]},
        "ordered": OrderedDict([("z", arr(3)), ("a", arr(2, 1))]),
        "namedtuple": Pair(weight=arr(2, 3), offset={"y": arr(1), "x": 0.25}),
        "empty dict": {},
        "empty list": [],
        "empty subtrees": {"k": {}, "j": [], "i": None, "h": arr(2)},
        "scalars": [1.5, (2, -3.25), {"q": 7}],
        "torch leaves": {"t": torch.from_numpy(arr(4, 2)), "s": torch.tensor(0.5),
                         "n": [torch.from_numpy(arr(3)).float(), arr(1)]},
    }


TREES = _trees()


def _np_leaves(tree):
    return [np.asarray(leaf) for leaf in tree_flatten(tree)[0]]


@pytest.mark.parametrize("name", list(TREES))
def test_flatten_matches_jax(name):
    tree = TREES[name]
    jflat, jdef, jshapes = jflatten(tree)
    flat, treedef, shapes = flatten_pytree(tree, CPU)
    assert flat.dtype == torch.float64
    assert np.array_equal(flat.numpy(), jflat)
    assert shapes == jshapes
    assert treedef.num_leaves == jdef.num_leaves
    _, lshapes, size = tree_layout(tree)
    _, jlshapes, jsize = jtree_layout(tree)
    assert lshapes == jlshapes and size == jsize == flat.numel()
    # the round trip: the same leaves in the same places, and JAX's structure
    back = unflatten_pytree(flat, treedef, shapes)
    jback = junflatten(jflat, jdef, jshapes)
    got = _np_leaves(back)
    want = jax.tree_util.tree_leaves(jback)
    assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))
    as_numpy = tree_unflatten(treedef, got)
    assert jax.tree_util.tree_structure(as_numpy) == jdef
    assert repr(type(as_numpy)) == repr(type(jback))


def _variants():
    """(base, variant) pairs: one structure in another insertion order, a
    transposed leaf, and changed structures."""
    rng = _rng(2)
    w, b = rng.standard_normal((3, 2)), rng.standard_normal(2)
    base = {"w": w, "b": b}
    return {
        "reordered keys": (base, {"b": b, "w": w}),
        "transposed leaf": (base, {"w": w.T, "b": b}),
        "extra key": (base, {"w": w, "b": b, "c": b}),
        "list for tuple": ((w, b), [w, b]),
        "ordered for dict": (base, OrderedDict([("b", b), ("w", w)])),
        "none for leaf": (base, {"w": w, "b": None}),
        "nested": (base, {"w": {"v": w}, "b": b}),
    }


@pytest.mark.parametrize("name", list(_variants()))
def test_layout_checks_match_jax(name):
    """The checks ``FederatedAveraging._validated_flat`` makes: the treedefs
    and the leaf shapes compare as JAX's do, so a transposed leaf and a
    changed structure are both rejected."""
    base, variant = _variants()[name]
    _, tdef, tshapes = flatten_pytree(base, CPU)
    _, vdef, vshapes = flatten_pytree(variant, CPU)
    _, jdef, jshapes = jflatten(base)
    _, jvdef, jvshapes = jflatten(variant)
    assert (tdef == vdef) == (jdef == jvdef)
    assert (tshapes == vshapes) == (jshapes == jvshapes)
    if name != "reordered keys":
        assert not (tdef == vdef and tshapes == vshapes)


@pytest.fixture
def seeded_roots(monkeypatch):
    """Both packages draw their roots of unity from ``random.Random(seed)``;
    ``fitted`` passes no seed, so pin the unseeded generator for both."""
    real = random.Random
    monkeypatch.setattr(random, "Random", lambda seed=None: real(0 if seed is None else seed))


FITTED_GRID = [(16, 8.0, 100), (8, 1.0, 2), (16, 2.0, 8), (20, 100.0, 1000),
               (24, 4.0, 10_000), (39, 1024.0, 1024)]


@pytest.mark.parametrize("frac_bits,clip,n", FITTED_GRID)
def test_fitted_matches_reference(seeded_roots, frac_bits, clip, n):
    jspec, jscheme = JSpec.fitted(frac_bits, clip, n)
    spec, scheme = QuantizationSpec.fitted(frac_bits, clip, n)
    assert (spec.modulus, spec.frac_bits, spec.clip, spec.n_participants) == (
        jspec.modulus, jspec.frac_bits, jspec.clip, jspec.n_participants)
    assert (scheme.prime_modulus, scheme.omega_secrets, scheme.omega_shares) == (
        jscheme.prime_modulus, jscheme.omega_secrets, jscheme.omega_shares)
    assert (scheme.secret_count, scheme.privacy_threshold, scheme.share_count) == (5, 2, 8)
    if (frac_bits, clip, n) == (16, 8.0, 100):
        assert spec.modulus == 268_435_873


@pytest.mark.parametrize("frac_bits,clip,n", [(40, 1024.0, 1024), (60, 8.0, 100)])
def test_fitted_refuses_wide_fields(frac_bits, clip, n):
    with pytest.raises(ValueError) as jerr:
        JSpec.fitted(frac_bits, clip, n)
    with pytest.raises(ValueError, match="exceeds 61") as err:
        QuantizationSpec.fitted(frac_bits, clip, n)
    assert str(err.value) == str(jerr.value)


def test_field_too_small_matches_reference():
    with pytest.raises(ValueError) as jerr:
        JSpec(modulus=433, frac_bits=16, clip=1.0, n_participants=100)
    with pytest.raises(ValueError, match="field too small") as err:
        QuantizationSpec(modulus=433, frac_bits=16, clip=1.0, n_participants=100)
    assert str(err.value) == str(jerr.value)


def _spec_pair(frac_bits=16, clip=8.0, n=100):
    p = 268_435_873 if (frac_bits, clip, n) == (16, 8.0, 100) else None
    jspec = JSpec(p, frac_bits, clip, n) if p else JSpec.fitted(frac_bits, clip, n)[0]
    return jspec, QuantizationSpec(jspec.modulus, frac_bits, clip, n)


def test_quantize_bit_equal():
    jspec, spec = _spec_pair()
    s = float(spec.scale)
    edges = [8.0, -8.0, 8.5, -1e9, 1e300, 0.0, -0.0, 0.5 / s, -0.5 / s, 1.5 / s, -2.5 / s,
             2.5 / s, 8.0 - 0.5 / s, -8.0 + 0.5 / s, 5e-324]
    values = np.concatenate([edges, 3.0 * _rng(3).standard_normal(2000)])
    got = spec.quantize(torch.from_numpy(values))
    want = jspec.quantize(values)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    # numpy input goes to the caller's device
    assert np.array_equal(spec.quantize(values, device=CPU).numpy(), want)
    # half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2 (as a high residue)
    assert got[7:11].tolist() == [0, 0, 2, spec.modulus - 2]


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_quantize_rejects_non_finite(bad):
    jspec, spec = _spec_pair()
    values = np.array([0.0, bad, 1.0])
    with pytest.raises(ValueError) as jerr:
        jspec.quantize(values)
    with pytest.raises(ValueError, match="non-finite") as err:
        spec.quantize(torch.from_numpy(values))
    assert str(err.value) == str(jerr.value)


def test_dequantize_sum_bit_equal():
    jspec, spec = _spec_pair()
    p = spec.modulus
    residues = np.array([0, 1, p // 2, p // 2 + 1, p - 1, 12345, p - 12345], dtype=np.int64)
    got = spec.dequantize_sum(torch.from_numpy(residues))
    want = jspec.dequantize_sum(residues)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
    assert got[2] > 0 and got[3] < 0  # the centered lift's edge


def test_quantize_update_and_dequantize_mean_match_reference():
    jspec, spec = _spec_pair(frac_bits=12, clip=2.0, n=7)
    rng = _rng(4)
    trees = [{"w": 3.0 * rng.standard_normal((4, 3)), "b": rng.standard_normal(3),
              "s": np.array(rng.standard_normal())} for _ in range(5)]
    total = np.zeros(16, dtype=np.int64)
    for tree in trees:
        jvec, jdef, jshapes = jquantize_update(tree, jspec)
        vec, tdef, shapes = quantize_update(tree, spec, CPU)
        assert np.array_equal(vec.numpy(), jvec) and shapes == jshapes
        total = (total + jvec) % spec.modulus
    jmean = jdequantize_mean(total, len(trees), jspec, jdef, jshapes)
    mean = dequantize_mean(torch.from_numpy(total), len(trees), spec, tdef, shapes)
    for key in jmean:
        assert np.array_equal(mean[key].numpy(), jmean[key])


def test_fedavg_apply_matches_trainer():
    rng = _rng(5)
    global_model = {"dense": {"kernel": rng.standard_normal((6, 4)).astype(np.float32),
                              "bias": np.zeros(4, dtype=np.float32)},
                    "conv": [rng.standard_normal((3, 3, 1, 2)), 0.5]}
    mean = {"dense": {"kernel": rng.standard_normal((6, 4)), "bias": rng.standard_normal(4)},
            "conv": [torch.from_numpy(rng.standard_normal((3, 3, 1, 2))), np.float64(-0.25)]}
    want = FederatedTrainer._fedavg_apply(global_model, jax.tree_util.tree_map(np.asarray, mean))
    got = fedavg_apply(global_model, mean, device=CPU)
    got_leaves, want_leaves = _np_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == np.float64 and np.array_equal(g, w)
    with pytest.raises(ValueError, match="structure"):
        fedavg_apply(global_model, {"dense": mean["dense"]}, device=CPU)


def _schemes():
    """Fitted schemes, a basic one, and packed schemes with a wrong omega."""
    out = {}
    for frac_bits, clip, n in [(16, 8.0, 100), (8, 1.0, 2), (24, 4.0, 10_000)]:
        jspec, jscheme = JSpec.fitted(frac_bits, clip, n)
        out[f"fitted {frac_bits}/{clip}/{n}"] = jscheme
    j = out["fitted 16/8.0/100"]
    p, w2, w3 = j.prime_modulus, j.omega_secrets, j.omega_shares
    for label, (a, b) in {
        "omega_secrets of order 4": (pow(w2, 2, p), w3),
        "omega_secrets = 1": (1, w3),
        "omega_shares of order 3": (w2, pow(w3, 3, p)),
        "omega_shares = 1": (w2, 1),
        "another root of order 8": (pow(w2, 3, p), w3),
    }.items():
        out[label] = JPacked(secret_count=5, share_count=8, privacy_threshold=2,
                             prime_modulus=p, omega_secrets=a, omega_shares=b)
    out["basic"] = JBasic(share_count=6, privacy_threshold=2, prime_modulus=p)
    return out


def _port_scheme(j):
    if isinstance(j, JBasic):
        return BasicShamirSharing(j.share_count, j.privacy_threshold, j.prime_modulus)
    return PackedShamirSharing(j.secret_count, j.share_count, j.privacy_threshold,
                               j.prime_modulus, j.omega_secrets, j.omega_shares)


SCHEMES = _schemes()


def _outcome(fn, scheme):
    try:
        fn(scheme)
    except Exception as exc:  # the outcome itself is compared
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("name", list(SCHEMES))
def test_verify_scheme_matches_reference(name):
    j = SCHEMES[name]
    want = _outcome(jverify_scheme, j)
    assert _outcome(verify_scheme, _port_scheme(j)) == want
    if name.startswith("fitted") or name in ("basic", "another root of order 8"):
        assert want is None
    else:
        assert want is not None


# a narrow model of the FedAvg paper's CNN shape: 3x3 convolutions of 4 and
# 8 channels, a 16-unit dense layer over the 7 x 7 x 8 pooled maps, 10
# outputs; keys out of sorted order
NARROW_CNN = {
    "dense2": {"kernel": (16, 10), "bias": (10,)},
    "conv1": {"kernel": (3, 3, 1, 4), "bias": (4,)},
    "dense1": {"kernel": (392, 16), "bias": (16,)},
    "conv2": {"kernel": (3, 3, 4, 8), "bias": (8,)},
}


def _cnn_tree(rng, scale, dtype=np.float64):
    return {layer: {name: (scale * rng.standard_normal(shape)).astype(dtype)
                    for name, shape in leaves.items()} for layer, leaves in NARROW_CNN.items()}


def _reference_round(tmp_path, jspec, jscheme, template, updates):
    """The reference's protocol-plane FedAvg round through the mem server."""
    fed = FederatedAveraging(jspec, template)
    with with_service() as ctx:
        recipient = new_client(tmp_path / "recipient", ctx.service)
        recipient.upload_agent()
        rkey = recipient.new_encryption_key()
        recipient.upload_encryption_key(rkey)
        clerks = [new_client(tmp_path / f"clerk{i}", ctx.service) for i in range(8)]
        for c in clerks:
            c.upload_agent()
            c.upload_encryption_key(c.new_encryption_key())
        agg_id = fed.open_round(recipient, rkey, jscheme)
        for i, upd in enumerate(updates):
            part = new_client(tmp_path / f"part{i}", ctx.service)
            part.upload_agent()
            fed.submit_update(part, agg_id, upd)
        fed.close_round(recipient, agg_id)
        for worker in [recipient] + clerks:
            worker.run_chores(-1)
        return fed.finish_round(recipient, agg_id, len(updates))


def test_fedavg_round_matches_reference_protocol_round(tmp_path):
    rng = _rng(6)
    updates = [_cnn_tree(rng, 2.0) for _ in range(4)]
    # clipped values and exact halves on the grid
    updates[0]["conv1"]["bias"][:] = [20.0, -20.0, 8.0, -8.0]
    updates[1]["dense2"]["bias"][:4] = np.array([0.5, 1.5, -2.5, -0.5]) / 2**16
    global_model = _cnn_tree(rng, 0.05, np.float32)
    jspec, jscheme = JSpec.fitted(16, 8.0, 100)
    spec, scheme = QuantizationSpec.fitted(16, 8.0, 100)
    assert spec.modulus == jspec.modulus

    want_mean = _reference_round(tmp_path, jspec, jscheme, global_model, updates)
    want_global = FederatedTrainer._fedavg_apply(global_model, want_mean)
    seeds = rng.integers(0, 1 << 32, size=(4, 4), dtype=np.uint64).astype(np.uint32)
    out = chip_smoke.fedavg_round(updates, spec, scheme, seeds, global_model,
                                  torch.Generator().manual_seed(0), chunk=3)
    for layer, leaves in NARROW_CNN.items():
        for name in leaves:
            assert np.array_equal(out["mean"][layer][name].numpy(), want_mean[layer][name])
            assert np.array_equal(out["new_global"][layer][name].numpy(), want_global[layer][name])
    flats = np.stack([jflatten(u)[0] for u in updates])
    residues = np.stack([jspec.quantize(f) for f in flats])
    assert np.array_equal(out["residues"].numpy(), residues)
    assert np.array_equal(out["field_sum"].numpy(), residues.sum(axis=0) % spec.modulus)
    assert set(out["seconds"]) == {"quantize_s", "masking_s", "sharing_s", "reveal_s",
                                   "dequantize_s", "wall_s"}


def test_fedavg_round_rejects_a_transposed_leaf():
    rng = _rng(7)
    updates = [_cnn_tree(rng, 1.0) for _ in range(2)]
    updates[1]["dense2"]["kernel"] = updates[1]["dense2"]["kernel"].T.copy()
    spec, scheme = QuantizationSpec.fitted(16, 8.0, 100)
    seeds = rng.integers(0, 1 << 32, size=(2, 4), dtype=np.uint64).astype(np.uint32)
    with pytest.raises(ValueError, match="layout"):
        chip_smoke.fedavg_round(updates, spec, scheme, seeds, _cnn_tree(rng, 0.05),
                                torch.Generator().manual_seed(0))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    spec = QuantizationSpec(268_435_873, 16, 8.0, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flatten_pytree({"w": np.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.quantize(np.zeros(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fedavg_apply({"w": np.zeros(2)}, {"w": np.zeros(2)})
