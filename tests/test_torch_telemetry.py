"""The port's telemetry (``sda_tpu_torch/telemetry``), the engine's hooks in
``sda_tpu_torch/parallel/engine.py`` and ``utils.torch_trace`` against
``sda_tpu.telemetry`` and ``sda_tpu.parallel.engine`` on the CPU: the same
series names, labels and observation counts in ``snapshot()``, and the same
spans, for the same calls on the same inputs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from sda_tpu import telemetry as jtelemetry
from sda_tpu.ops.jaxcfg import ensure_x64
from sda_tpu.parallel import TpuAggregator
from sda_tpu.parallel import engine as jeng
from sda_tpu.protocol import PackedShamirSharing as JPacked
from sda_tpu_torch import telemetry
from sda_tpu_torch.parallel import TorchAggregator
from sda_tpu_torch.parallel import engine as teng
from sda_tpu_torch.protocol import PackedShamirSharing
from sda_tpu_torch.utils import torch_trace

ensure_x64()

CPU = "cpu"
SCHEME = (3, 8, 4, 433, 354, 150)  # k, n, t, p, omega_secrets, omega_shares


@pytest.fixture
def clean():
    """Both registries empty and on, and left as found."""
    was = (telemetry.enabled(), jtelemetry.enabled())
    telemetry.set_enabled(True)
    jtelemetry.set_enabled(True)
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.set_enabled(was[0])
    jtelemetry.set_enabled(was[1])
    telemetry.reset()
    jtelemetry.reset()


def _series(snap):
    """Every series as (kind, name, labels, observation count or value)."""
    out = {("counter", c["name"], tuple(sorted(c["labels"].items())), c["value"])
           for c in snap["counters"]}
    out |= {("histogram", h["name"], tuple(sorted(h["labels"].items())), h["count"])
            for h in snap["histograms"]}
    return out


def _spans(snap):
    return [(s["name"], s["attrs"]) for s in snap["spans"]]


def _secure_sums(calls=2):
    k, n, t, p, w2, w3 = SCHEME
    secrets = np.random.default_rng(0).integers(0, p, size=(5, 13))
    for i in range(calls):
        TorchAggregator(PackedShamirSharing(k, n, t, p, w2, w3), 13, device=CPU).secure_sum(
            torch.from_numpy(secrets), torch.Generator().manual_seed(i))
        TpuAggregator(JPacked(secret_count=k, share_count=n, privacy_threshold=t, prime_modulus=p,
                              omega_secrets=w2, omega_shares=w3), 13).secure_sum(
            jnp.asarray(secrets), random.key(i))


def test_secure_sum_series_and_spans_match_reference(clean):
    _secure_sums()
    snap, jsnap = telemetry.snapshot(), jtelemetry.snapshot()
    assert _series(snap) == _series(jsnap)
    assert {s[2] for s in _series(snap)} == {(("step", st),) for st in ("share", "combine", "reconstruct")}
    assert all(s[3] == 2 for s in _series(snap))
    assert _spans(snap) == _spans(jsnap) == [("engine.secure_sum", {"dim": 13})] * 2
    assert all(s["duration_s"] >= 0 for s in snap["spans"])
    # the snapshot's layout: the reference's keys, and its histogram fields
    assert set(snap) <= set(jsnap)
    assert [list(h) for h in snap["histograms"]] == [list(h) for h in jsnap["histograms"]]
    for h, jh in zip(snap["histograms"], jsnap["histograms"]):
        assert h["buckets"] == jh["buckets"] == list(telemetry.DEFAULT_BUCKETS)
        assert sum(h["counts"]) == h["count"] and len(h["counts"]) == len(jh["counts"])


def test_disabled_records_nothing(clean):
    telemetry.set_enabled(False)
    TorchAggregator(PackedShamirSharing(*SCHEME), 13, device=CPU).secure_sum(
        torch.zeros((2, 13), dtype=torch.int64), torch.Generator().manual_seed(0))
    fn = teng.instrument_fabric(lambda s, k, d=None: torch.zeros(4), "off", 2)
    fn(None, 0)
    snap = telemetry.snapshot()
    assert snap["enabled"] is False
    assert snap["counters"] == snap["histograms"] == snap["spans"] == []
    assert teng.fabric_bytes() == teng.fabric_calls() == {}


def test_kill_switch_read_at_start(monkeypatch):
    monkeypatch.setenv("SDA_TELEMETRY", "0")
    assert telemetry.Registry().enabled is False
    monkeypatch.setenv("SDA_TELEMETRY", "1")
    assert telemetry.Registry().enabled is True


def test_instrument_fabric_counts_like_reference(clean):
    result = np.arange(24, dtype=np.int64).reshape(8, 3)
    ours = teng.instrument_fabric(lambda s, k, d=None: torch.from_numpy(result), "local", 4)
    theirs = jeng._instrument_fabric(lambda s, k: jnp.asarray(result), "local", 4)
    for _ in range(3):
        ours(None, 0)
        theirs(None, 0)
    assert teng.fabric_bytes() == {"local": 3 * result.nbytes * 4}
    assert teng.fabric_calls() == {"local": 3}
    assert _series(telemetry.snapshot()) == _series(jtelemetry.snapshot())


def test_torch_trace_writes_a_trace(tmp_path):
    with torch_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert os.path.getsize(tmp_path / files[0]) > 0


# -- the REST plane's telemetry: gauges, Prometheus text, time series ---------

from sda_tpu.telemetry import timeseries as jtimeseries  # noqa: E402
from sda_tpu_torch.telemetry import timeseries  # noqa: E402

BUCKETS = (0.1, 1.0, 10.0)


def _bucketize(values, buckets=telemetry.DEFAULT_BUCKETS):
    import bisect

    counts = [0] * (len(buckets) + 1)
    for v in values:
        counts[bisect.bisect_left(buckets, v)] += 1
    return counts


def _feed(registry, rng_seed=0):
    """The same series into a registry of either package: counters with
    label values that need escaping, a gauge, histograms."""
    rng = np.random.default_rng(rng_seed)
    registry.counter("sda_http_requests_total", "REST requests", method="GET", route="/v1/ping",
                     status="200").inc(7)
    registry.counter("sda_http_requests_total", "REST requests", method="POST",
                     route='/v1/"quoted"\\path\nx', status="201").inc(3)
    registry.counter("sda_wire_bytes_total", direction="in").inc(4096)
    registry.counter("sda_fault_injections_total", kind="drop", side="server").inc(2)
    registry.gauge("sda_pool_utilization", "pool busy share").set(0.375)
    registry.gauge("sda_tier_depth").set(3)
    for v in rng.lognormal(-4.0, 1.0, size=50):
        registry.histogram("sda_http_request_seconds", method="GET", route="/v1/ping").observe(float(v))
    registry.histogram("sda_store_op_seconds", buckets=BUCKETS, store="sqlite", op="get").observe(0.5)
    registry.histogram("sda_unobserved_seconds", "registered, never observed")


def test_prometheus_text_equals_reference():
    ours, theirs = telemetry.Registry(enabled=True), jtelemetry.Registry(enabled=True)
    _feed(ours)
    _feed(theirs)
    text = telemetry.render_prometheus(ours.snapshot())
    assert text == jtelemetry.render_prometheus(theirs.snapshot())
    assert 'route="/v1/\\"quoted\\"\\\\path\\nx"' in text
    assert "# TYPE sda_pool_utilization gauge" in text and "sda_pool_utilization 0.375" in text
    assert "# TYPE sda_unobserved_seconds histogram" in text
    assert telemetry.PROMETHEUS_CONTENT_TYPE == jtelemetry.PROMETHEUS_CONTENT_TYPE


def test_gauge_and_snapshot_layout_match_reference(clean):
    telemetry.gauge("sda_pool_utilization").set(0.5)
    jtelemetry.gauge("sda_pool_utilization").set(0.5)
    snap, jsnap = telemetry.snapshot(), jtelemetry.snapshot()
    assert snap["gauges"] == jsnap["gauges"] == [
        {"name": "sda_pool_utilization", "labels": {}, "value": 0.5}]
    assert set(snap) == set(jsnap)
    telemetry.set_enabled(False)
    telemetry.gauge("sda_pool_utilization").set(9.0)
    assert telemetry.snapshot()["gauges"][0]["value"] == 0.5


def test_trace_ids_follow_the_reference(clean):
    assert telemetry.TRACE_HEADER == jtelemetry.TRACE_HEADER == "X-SDA-Trace"
    for raw in ("abc-123", "a" * 64, "a" * 65, "bad id", "x;y", "", None, " ok.id:7 "):
        assert telemetry.sanitize_trace_id(raw) == jtelemetry.sanitize_trace_id(raw)
    with telemetry.trace("trace-one") as tid:
        assert telemetry.current_trace_id() == tid == "trace-one"
        with telemetry.span("store.get"):
            pass
    assert telemetry.current_trace_id() is None
    assert [s["trace_id"] for s in telemetry.spans(name="store.")] == ["trace-one"]
    assert telemetry.spans(trace_id="nope") == []


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.99, 1.0, 2.0, -1.0])
@pytest.mark.parametrize("case", ["lognormal", "empty", "one bucket", "inf bucket", "first bucket"])
def test_histogram_quantile_equals_reference(case, q):
    buckets = telemetry.DEFAULT_BUCKETS if case == "lognormal" else BUCKETS
    counts = {
        "lognormal": _bucketize(np.random.default_rng(7).lognormal(-4.0, 1.0, size=5000)),
        "empty": [0, 0, 0, 0],
        "one bucket": [0, 10, 0, 0],
        "inf bucket": [0, 0, 0, 5],
        "first bucket": [1, 0, 0, 0],
    }[case]
    got = timeseries.histogram_quantile(q, buckets, counts)
    assert got == jtimeseries.histogram_quantile(q, buckets, counts)


def _history(seed, procs):
    rng = np.random.default_rng(seed)
    out = []
    for p in range(procs):
        samples = []
        for i in range(6):
            t = 1000.0 + 0.7 * i + 0.1 * p
            samples.append({
                "t": t, "dt_s": 0.7, "rss_mib": float(rng.integers(50, 90)),
                "routes": {"/v1/ping": {"rps": float(rng.integers(1, 9)), "p50_s": 0.001,
                                        "p99_s": float(rng.random())}},
                "store_ops": {"mem.get": {"ops_s": 2.0, "p99_s": float(rng.random())}},
                "wire_bytes_per_s": {"in": 10.0 * i, "out": 5.0},
                "rates": {"sda_rest_retries_total": 0.5},
                **({"shards": {"0": 1.5}} if p else {}),
            })
        out.append({"running": True, "interval_s": 0.7, "samples": samples} if p % 2 == 0
                   else samples)
    return out


@pytest.mark.parametrize("bucket_s", [None, 1.0, 2.5])
@pytest.mark.parametrize("procs", [1, 3])
def test_merge_histories_equals_reference(procs, bucket_s):
    histories = _history(procs, procs)
    assert (timeseries.merge_histories(histories, bucket_s)
            == jtimeseries.merge_histories(histories, bucket_s))


def test_sampler_windows_equal_reference():
    """The same events into both packages' registries: every banked window
    equals the reference sampler's (RSS aside, which is the process's)."""
    ours, theirs = telemetry.Registry(enabled=True), jtelemetry.Registry(enabled=True)
    samplers = [timeseries.TimeSeriesSampler(registry=ours, interval_s=60, window=8),
                jtimeseries.TimeSeriesSampler(registry=theirs, interval_s=60, window=8)]
    t0 = 1000.0
    for s in samplers:
        s._prev_t = t0
    for tick in range(3):
        for reg in (ours, theirs):
            _feed(reg, rng_seed=tick)
        got, want = (s.sample_once(now=t0 + 2.0 * (tick + 1)) for s in samplers)
        got.pop("rss_mib")
        want.pop("rss_mib")
        assert got == want
    assert [s["t"] for s in samplers[0].history()] == [s["t"] for s in samplers[1].history()]
