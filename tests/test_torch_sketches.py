"""The port's sketch plane against ``sda_tpu.sketches`` on the CPU.

``sketch_hash`` and ``canonical_item_bytes`` must give the reference's
bytes and hashes for every accepted item type, so a participant of either
package lands an item in the same cell; each of the five families'
``encode`` must equal the reference's on the same values, and its
``decode`` the reference's on the same summed sketch; and one
``SketchQuery`` round of each family in each package (a recipient and 8
clerks on each package's memory server) must reveal the same summed
sketch, exactly, and decode to the same answers.
"""

import numpy as np
import pytest
import torch

import sda_tpu.sketches as js
import sda_tpu_torch.sketches as ts
from sda_tpu.models.statistics import canonical_item_bytes as j_canonical
from sda_tpu_torch.models.statistics import canonical_item_bytes
from test_torch_fedavg_round import Deployment

ITEMS = ["maps", "", "é-unicode", b"\x00raw", 0, 7, -3, 2 ** 70, True, np.int32(5), np.uint8(200),
         3.0, 2.5, -0.0, float("inf"), np.float32(0.25), np.float64(1e-300)]


@pytest.mark.parametrize("item", ITEMS, ids=[repr(i) for i in ITEMS])
def test_canonical_bytes_and_hash_match_reference(item):
    assert canonical_item_bytes(item) == j_canonical(item)
    for seed, row, tag in ((0, 0, b""), (17, 3, b"cm"), (2 ** 63, 2 ** 31, b"sg")):
        assert ts.sketch_hash(seed, row, item, tag) == js.sketch_hash(seed, row, item, tag)


def test_unhashable_types_are_refused_alike():
    for bad in (None, [1], (1,), {"a": 1}, np.array([1, 2])):
        with pytest.raises(TypeError) as err:
            canonical_item_bytes(bad)
        with pytest.raises(TypeError) as jerr:
            j_canonical(bad)
        assert str(err.value) == str(jerr.value)


def _phones(seed=17, count=4):
    """Per phone: app launches (hot apps dominate), latencies in [0, 256)
    and device ids, as the sketch suite draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        apps = [h for h in ("maps", "chat", "camera") for _ in range(6 + 2 * i)]
        apps += [f"app-{int(v)}" for v in rng.integers(0, 40, size=20)]
        latencies = [int(v) for v in np.clip(rng.gamma(4.0, 12.0, size=30), 0, 255)]
        devices = [f"device-{int(v)}" for v in rng.integers(0, 300, size=40)]
        out.append((apps, latencies, devices))
    return out


def _family(pkg, kind):
    """(a maker of ``kind``'s sketch in ``pkg``, the index of the phone
    stream it reads)."""
    candidates = ["maps", "chat", "camera"] + [f"app-{i}" for i in range(40)]
    return {
        "countmin": (lambda: pkg.CountMinSketch(width=128, depth=4, seed=17), 0),
        "countsketch": (lambda: pkg.CountSketch(width=128, depth=5, seed=17), 0),
        "quantiles": (lambda: pkg.DyadicQuantiles(universe_bits=8, width=64, depth=3, seed=17), 1),
        "cardinality": (lambda: pkg.LinearCountingSketch(m=512, seed=17), 2),
        "topk": (lambda: pkg.TopKSketch(k=3, candidates=candidates, width=128, depth=4, seed=17), 0),
    }[kind]


KINDS = ["countmin", "countsketch", "quantiles", "cardinality", "topk"]


def _plain(decoded):
    """A decode dict with numpy scalars as Python numbers, for equality."""
    if isinstance(decoded, dict):
        return {k: _plain(v) for k, v in decoded.items()}
    if isinstance(decoded, (list, tuple)):
        return [_plain(v) for v in decoded]
    return decoded.item() if isinstance(decoded, np.generic) else decoded


@pytest.mark.parametrize("kind", KINDS)
def test_sketch_round_matches_reference(tmp_path, kind):
    make, stream = _family(ts, kind)
    jmake, _ = _family(js, kind)
    sketch, jsketch = make(), jmake()
    assert sketch.dim == jsketch.dim
    datasets = [phone[stream] for phone in _phones()]
    for values in datasets:
        np.testing.assert_array_equal(sketch.encode(values), jsketch.encode(values))
    query = ts.SketchQuery(sketch, n_participants=6, max_values_per_participant=256, device="cpu")
    jquery = js.SketchQuery(jsketch, n_participants=6, max_values_per_participant=256)
    assert query.spec.modulus == jquery.spec.modulus
    results = []
    for package, q in (("port", query), ("ref", jquery)):
        deployment = Deployment(tmp_path / package, package)
        agg = deployment.round(q, datasets)
        results.append(q.finish_decoded(deployment.recipient, agg, len(datasets)))
    got, want = results
    assert got["summed"].dtype == torch.int64
    np.testing.assert_array_equal(got["summed"].numpy(), want["summed"])
    np.testing.assert_array_equal(want["summed"], sum(jquery.local_sketch(d) for d in datasets))
    got.pop("summed"), want.pop("summed")
    assert _plain(got) == _plain(want)
    # and on a host array as well as on the revealed tensor
    one = jquery.local_sketch(datasets[0])
    assert _plain(sketch.decode(one, 1)) == _plain(jsketch.decode(one, 1))


def test_query_refuses_more_values_than_it_was_sized_for():
    query = ts.SketchQuery(ts.CountMinSketch(width=8, depth=2), n_participants=3,
                           max_values_per_participant=4, device="cpu")
    jquery = js.SketchQuery(js.CountMinSketch(width=8, depth=2), n_participants=3,
                            max_values_per_participant=4)
    with pytest.raises(ValueError) as err:
        query.local_sketch(["a"] * 5)
    with pytest.raises(ValueError) as jerr:
        jquery.local_sketch(["a"] * 5)
    assert str(err.value) == str(jerr.value)
    np.testing.assert_array_equal(query.local_sketch(["a"] * 4), jquery.local_sketch(["a"] * 4))
