"""The port's device spans (``telemetry/device.py``) on the CPU: under a
CPU-only ``torch.profiler`` each device-plane entry opens its ``sda.``
ranges, nested as the layers nest; with no profiler a span is one shared
null context and no ``record_function``; results are bit-equal with the
profiler on and off; each host sync opens one ``sda.sync.<site>`` range.
"""

import contextlib

import numpy as np
import pytest
import torch

from sda_tpu_torch import telemetry
from sda_tpu_torch.models import QuantizationSpec, dequantize_mean, fedavg_apply, tree_layout
from sda_tpu_torch.ops import chacha_cuda, find_packed_parameters
from sda_tpu_torch.ops import rng as trng
from sda_tpu_torch.parallel import engine, limbmatmul, sumfirst
from sda_tpu_torch.protocol import PackedShamirSharing
from sda_tpu_torch.telemetry import device as tdevice

CPU = "cpu"
DIM = 23
SEEDS = (np.arange(20, dtype=np.uint64).reshape(5, 4) * 2654435761 % (1 << 32)).astype(np.uint32)


def _scheme(bits):
    p, w2, w3 = find_packed_parameters(5, 2, 8, min_modulus_bits=bits, seed=0)
    return PackedShamirSharing(5, 8, 2, p, w2, w3)


NARROW, WIDE = _scheme(28), _scheme(60)


def _gen(seed=5):
    return torch.Generator(device=CPU).manual_seed(seed)


def _profiled(fn):
    """``fn()`` under a CPU-only profiler: (result, [(name, start, end)] of
    the ``sda.`` ranges in the order they opened)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name.startswith(tdevice.PREFIX)]
    return out, sorted(ranges, key=lambda r: (r[1], -r[2]))


def _tree(ranges):
    """[(name, parent name or None)] in opening order: each range's parent is
    the innermost ``sda.`` range that holds it."""
    out = []
    for i, (name, s, e) in enumerate(ranges):
        holders = [r for r in ranges[:i] if r[1] <= s and e <= r[2]]
        out.append((name, min(holders, key=lambda r: r[2] - r[1])[0] if holders else None))
    return out


def _sumfirst_pair():
    plan = engine.make_plan(WIDE, DIM, CPU)
    nbits = WIDE.prime_modulus.bit_length() - 1
    x = torch.randint(0, 1 << 28, (6, DIM), generator=_gen(1), dtype=torch.int32)
    return sumfirst.value_limb_sums_chunk_pair(
        x, x ^ 0x5A5A5A5A, _gen(), plan, lambda g, shape: trng.uniform_bits_device_pair(g, shape, nbits))


def _sumfirst_narrow():
    plan = engine.make_plan(NARROW, DIM, CPU)
    secrets = torch.randint(0, NARROW.prime_modulus, (6, DIM), generator=_gen(2), dtype=torch.int64)
    return sumfirst.value_limb_sums_chunk(secrets, _gen(), plan)


def _sumfirst_epilogue():
    plan = engine.make_plan(WIDE, DIM, CPU)
    acc = torch.randint(0, 1 << 40, (2, plan.n_batches, plan.input_size + plan.rand_size),
                        generator=_gen(3), dtype=torch.int64)
    clerk_sums, _ = sumfirst.clerk_sums_from_limb_acc(acc, plan)
    return sumfirst.reconstruct_from_clerk_sums(torch.as_tensor(clerk_sums), range(1, 8), WIDE, DIM)


def _expand():
    return chacha_cuda.expand_seeds_counts(chacha_cuda.seed_tensor(SEEDS, CPU), DIM, NARROW.prime_modulus)


def _expand_batch():
    return chacha_cuda.expand_seeds_batch(chacha_cuda.seed_tensor(SEEDS, CPU), DIM, NARROW.prime_modulus)


def _combine():
    return chacha_cuda.combine_masks_device(SEEDS, DIM, NARROW.prime_modulus, chunk=2, device=CPU)


def _share():
    plan = engine.make_plan(NARROW, DIM, CPU)
    secrets = torch.randint(0, NARROW.prime_modulus, (6, DIM), generator=_gen(4), dtype=torch.int32)
    return engine.share_combine_limb_streamed(secrets, _gen(), plan)


def _quantize():
    spec, _ = QuantizationSpec.fitted(16, 8.0, 10)
    return spec.quantize(torch.randn(DIM, generator=_gen(6), dtype=torch.float32) * 3, device=CPU)


def _reveal():
    """A round's reveal and apply, as the engine's FedAvg round runs them."""
    spec, scheme = QuantizationSpec.fitted(16, 8.0, 10)
    p, plan = spec.modulus, engine.make_plan(scheme, DIM, CPU)
    updates = torch.randn((4, DIM), generator=_gen(7), dtype=torch.float64)
    acc = engine.share_combine_limb_streamed(spec.quantize(updates, device=CPU), _gen(), plan)
    clerk_sums = limbmatmul.limb_recombine(acc, p).T
    field_sum = engine.reconstruct(clerk_sums, range(1, 8), scheme, DIM)
    treedef, shapes, _ = tree_layout({"w": torch.zeros(DIM, dtype=torch.float64)})
    mean = dequantize_mean(field_sum, 4, spec, treedef, shapes, device=CPU)
    return fedavg_apply({"w": torch.ones(DIM, dtype=torch.float64)}, mean, device=CPU)["w"]


S = "sda."
CALLS = {
    "sumfirst_pair": (_sumfirst_pair, [(S + "sumfirst.draw", None), (S + "sumfirst.reduce", None)]),
    "sumfirst_narrow": (_sumfirst_narrow, [(S + "sumfirst.draw", None), (S + "sumfirst.reduce", None)]),
    "sumfirst_epilogue": (_sumfirst_epilogue, [
        (S + "sumfirst.clerk_sums", None), (S + "sync.sumfirst_host", S + "sumfirst.clerk_sums"),
        (S + "sumfirst.reconstruct", None), (S + "sync.sumfirst_host", S + "sumfirst.reconstruct")]),
    "expand": (_expand, [
        (S + "chacha.expand", None), (S + "chacha.k2", S + "chacha.expand"),
        (S + "chacha.compact", S + "chacha.expand")]),
    "expand_batch": (_expand_batch, [
        (S + "chacha.expand", None), (S + "chacha.k2", S + "chacha.expand"),
        (S + "chacha.compact", S + "chacha.expand"), (S + "sync.batch_counts", None)]),
    "combine": (_combine, [
        (S + "chacha.expand", None), (S + "chacha.k2", S + "chacha.expand"),
        (S + "chacha.compact", S + "chacha.expand"), (S + "chacha.fold", None),
        (S + "sync.fold_counts", None)] * 3),
    "share": (_share, [
        (S + "engine.share_combine", None), (S + "limb.draw", S + "engine.share_combine"),
        (S + "limb.k1", S + "engine.share_combine")]),
    "quantize": (_quantize, [(S + "fl.quantize", None), (S + "sync.quantize_finite", S + "fl.quantize")]),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_entry_opens_its_ranges_nested(call):
    fn, want = CALLS[call]
    _, ranges = _profiled(fn)
    assert _tree(ranges) == want


def test_reveal_and_apply_ranges():
    _, ranges = _profiled(_reveal)
    tops = [name for name, parent in _tree(ranges) if parent is None]
    assert tops == [S + "fl.quantize", S + "engine.share_combine", S + "limb.recombine",
                    S + "engine.reconstruct", S + "fl.dequantize_mean", S + "fl.apply"]


def test_wide_reconstruct_and_host_recombine_are_syncs():
    plan = engine.make_plan(WIDE, DIM, CPU)
    clerk_sums = torch.randint(0, 1 << 40, (8, plan.n_batches), generator=_gen(8), dtype=torch.int64)
    partials = torch.randint(0, 1 << 20, (3, plan.n_batches, 8), generator=_gen(9), dtype=torch.int64)
    _, ranges = _profiled(lambda: (engine.reconstruct(clerk_sums, range(1, 8), WIDE, DIM),
                                   limbmatmul.limb_recombine_host(partials, WIDE.prime_modulus)))
    assert _tree(ranges) == [(S + "engine.reconstruct", None),
                             (S + "sync.reconstruct_host", S + "engine.reconstruct"),
                             (S + "sync.recombine_host", None)]


@pytest.mark.parametrize("call", sorted(CALLS) + ["reveal"])
def test_results_bit_equal_with_the_profiler_on_and_off(call):
    fn = _reveal if call == "reveal" else CALLS[call][0]
    off = _tensors(fn())
    on, ranges = _profiled(fn)
    assert ranges
    on = _tensors(on)
    assert len(on) == len(off)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _tensors(out) -> list:
    return [torch.as_tensor(np.asarray(v, dtype=np.int64)) if isinstance(v, np.ndarray) else v
            for v in (out if isinstance(out, tuple) else (out,))]


def test_no_profiler_gives_the_shared_null_context(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    span = tdevice.device_span("x")
    assert span is tdevice.device_span("y") is tdevice.sync("z")
    assert isinstance(span, contextlib.nullcontext)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for fn, _ in CALLS.values():
        fn()
    _reveal()
    with telemetry.span("engine.secure_sum"):
        pass


def test_profiler_turns_the_span_into_a_record_function():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        span = tdevice.device_span("x")
    assert isinstance(span, torch.profiler.record_function)
    assert span.name == "sda.x"


def _sync_counts(ranges) -> dict:
    """Occurrences of each ``sda.sync.<site>`` range, by site."""
    prefix = S + "sync."
    sites = [name[len(prefix):] for name, _, _ in ranges if name.startswith(prefix)]
    return {site: sites.count(site) for site in sites}


@pytest.mark.parametrize("telemetry_on", [False, True], ids=["off", "on"])
def test_syncs_count_every_site_visit(telemetry_on):
    """One ``sync.<site>`` range a host sync, whether or not the host
    telemetry (``SDA_TELEMETRY``) is on."""
    was = telemetry.enabled()
    telemetry.set_enabled(telemetry_on)
    try:
        _, ranges = _profiled(lambda: [fn() for fn in (_combine, _expand_batch, _quantize, _sumfirst_epilogue)])
    finally:
        telemetry.set_enabled(was)
    # five seeds in folds of two: three folds, one count sync each
    assert _sync_counts(ranges) == {"fold_counts": 3, "batch_counts": 1, "quantize_finite": 1,
                                    "sumfirst_host": 2}


def test_slack_recovery_counts_its_extra_sync(monkeypatch):
    """A fold whose window runs dry syncs once more on its counts."""
    want = chacha_cuda.combine_masks_device(SEEDS[:2], DIM, NARROW.prime_modulus, device=CPU)
    monkeypatch.setattr(chacha_cuda, "window_blocks", lambda dim, m: 1)
    got, ranges = _profiled(lambda: chacha_cuda.combine_masks_device(SEEDS[:2], DIM, NARROW.prime_modulus,
                                                                      device=CPU))
    # a block holds 8 draws: 1 and 2 blocks run dry, 4 hold the 23 a row needs
    assert _sync_counts(ranges) == {"fold_counts": 3}
    assert torch.equal(got, want)


def test_plain_keystream_adds_no_launches():
    """``launches`` counts the kernel's launches; the plain version on a
    CPU tensor, spanned as ``chacha.k2`` all the same, adds none."""
    before = chacha_cuda.launches
    _, ranges = _profiled(_combine)
    assert chacha_cuda.launches == before
    assert [name for name, _, _ in ranges].count(S + "chacha.k2") == 3


def test_telemetry_span_lands_in_the_profiler_trace_and_its_log():
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        def body():
            with telemetry.trace("t-1"), telemetry.span("engine.secure_sum", dim=3) as record:
                assert record["name"] == "engine.secure_sum"

        _, ranges = _profiled(body)
        body()
        records = telemetry.spans("engine.secure_sum")
    finally:
        telemetry.set_enabled(was)
        telemetry.reset()
    assert [r[0] for r in ranges] == ["sda.engine.secure_sum"]
    assert len(records) == 2
    for record in records:
        assert set(record) == {"name", "trace_id", "start", "attrs", "duration_s"}
        assert (record["name"], record["trace_id"], record["attrs"]) == ("engine.secure_sum", "t-1", {"dim": 3})


def test_disabled_telemetry_still_spans_the_profiler_trace():
    """``SDA_TELEMETRY=0`` silences the host log only; a profiler that the
    operator started still sees the range."""
    was = telemetry.enabled()
    telemetry.set_enabled(False)
    try:
        def body():
            with telemetry.span("http.request") as record:
                assert record is None

        _, ranges = _profiled(body)
    finally:
        telemetry.set_enabled(was)
    assert [r[0] for r in ranges] == ["sda.http.request"]


def test_torch_trace_captures_the_port_ranges(tmp_path):
    from sda_tpu_torch.utils import torch_trace

    with torch_trace(str(tmp_path)):
        _combine()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    text = trace.read_text()
    for name in ("chacha.expand", "chacha.k2", "chacha.compact", "chacha.fold", "sync.fold_counts"):
        assert f'"sda.{name}"' in text
