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
