"""``python -m sda_tpu_torch.scripts.flagship`` against the reference's
``scripts/flagship.py``: the same rung payloads, the flat control's
revealed bytes equal to the reference's on the same values, the flat
control's overlap and memoisation, and one ``--smoke --device cpu``
campaign over two port ``sdad`` frontends and five committee daemons that
passes the checks of the reference CI's flagship stage."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sda_tpu_torch.scripts import flagship

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_flagship", ROOT / "scripts" / "flagship.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("workload", ["dense", "sketch"])
@pytest.mark.parametrize("rung, cohort", [(0, 4), (1, 8), (5, 33)])
def test_rung_values_are_the_references(workload, rung, cohort, reference):
    assert flagship.rung_values(rung, cohort, workload) == reference.rung_values(rung, cohort, workload)
    assert flagship.WORKLOAD_SKETCH_SHAPE == reference.WORKLOAD_SKETCH_SHAPE


@pytest.mark.parametrize("rung, cohort", [(0, 3), (2, 5)])
def test_flat_baseline_reveals_the_references_bytes(rung, cohort, reference):
    values = flagship.rung_values(rung, cohort)
    ours = flagship.flat_baseline(values, "cpu")
    assert ours == reference.flat_baseline(values)
    want = np.asarray(values, dtype=np.int64).sum(axis=0) % flagship.MODULUS
    assert ours == want.tobytes()


def test_flat_baseline_overlap_joins_matches_and_memoizes(monkeypatch):
    """As the reference's: result() joins the background control and
    returns its bytes; a second construction for the same (rung, cohort,
    workload) is a memo hit; a worker's failure is raised at join."""
    values = [[1, 2, 3, 4], [5, 6, 7, 8]]
    expected = np.array([6, 8, 10, 12], dtype=np.int64).tobytes()
    ctx = {"workload": "dense", "device": "cpu"}
    fb = flagship._FlatBaseline(0, 2, ctx, values)
    assert fb._thread is not None  # overlapped, not inline
    assert fb.result() == expected
    assert fb._thread is None  # joined
    assert ctx["baseline_memo"][(0, 2, "dense")] == expected

    def explode(_values, _device):
        raise AssertionError("memoized baseline recomputed")

    monkeypatch.setattr(flagship, "flat_baseline", explode)
    again = flagship._FlatBaseline(0, 2, ctx, values)
    assert again._thread is None and again.result() == expected

    def boom(_values, _device):
        raise RuntimeError("baseline failed")

    monkeypatch.setattr(flagship, "flat_baseline", boom)
    failing = flagship._FlatBaseline(1, 2, ctx, values)
    with pytest.raises(RuntimeError, match="baseline failed"):
        failing.result()


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    root = tmp_path_factory.mktemp("flagship")
    out = subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.scripts.flagship", "--smoke", "--device", "cpu",
         "--artifacts", str(root)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    (path,) = sorted(root.glob("flagship-*.json"))
    assert out.stdout.strip().splitlines()[-1] == str(path)
    return json.loads(path.read_text()), out.stderr


def test_smoke_certifies_over_two_processes(smoke):
    """The reference CI's flagship checks, on the port's artifact."""
    d, _ = smoke
    assert d["topology"]["frontend_processes"] >= 2
    assert d["topology"]["shards"] >= 2 and d["topology"]["replicas"] >= 2
    assert d["certified_max_cohort"] >= 4
    assert d["ladder"][0]["certified"] and d["ladder"][0]["cohort"] == 4
    assert all(r["exact"] and r["flat_byte_match"] for r in d["ladder"])
    assert d.get("ingest_pipeline") is True
    assert all(r.get("ingest_pipeline") for r in d["ladder"])
    assert isinstance(d["arrivals_ab"]["arrivals_pipeline_speedup"], (int, float))
    assert isinstance(d["tier_close_ab"]["tier_close_fanout_speedup"], (int, float))
    merged = d["merged_samples"]
    assert merged and max(s.get("procs", 0) for s in merged) >= 2
    assert d["fleet_timeseries"]["max_procs_in_bucket"] >= 2


def test_smoke_placement_and_spans(smoke):
    d, stderr = smoke
    assert "5 committee daemons launched (2 clerks each)" in stderr
    for r in d["ladder"]:
        assert set(r["placement"].values()) <= {0, 1}
        assert r["trace_id"] == f"rung{r['rung']}-c{r['cohort']}"
        assert r["stages"]["rung.round"] > 0
    assert {s["trace_id"] for s in d["spans"]} == {d["ladder"][-1]["trace_id"]}

