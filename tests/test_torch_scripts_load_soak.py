"""``python -m sda_tpu_torch.scripts.load_soak`` against the reference's
``scripts/load_soak.py``: the same round payloads, sample thinning and
summary on seeded inputs; one round through ``run_round(values=...)`` at a
width of the caller's, exact; a short ``--device cpu`` soak whose every
round is exact and whose artifact has the keys of the reference's, and
renders through ``trace_report`` as the reference's renderer renders it."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sda_tpu_torch.scripts import load_soak

ROOT = Path(__file__).resolve().parent.parent
SOAK_ARGV = ["--duration", "2", "--rate", "40", "--round-size", "10", "--interval", "0.5",
             "--ab-rounds", "0"]


@pytest.fixture(scope="module")
def reference():
    """The reference module, without letting its module-level env writes
    (``SDA_TS=0``) leak into this process."""
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location("ref_load_soak",
                                                      ROOT / "scripts" / "load_soak.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return module


@pytest.mark.parametrize("workload", ["dense", "sketch"])
@pytest.mark.parametrize("ix, n", [(0, 1), (3, 80), (17, 13)])
def test_workload_values_are_the_references(workload, ix, n, reference):
    assert load_soak.workload_values(ix, n, workload) == reference.workload_values(ix, n, workload)
    assert load_soak.workload_items(ix, n) == reference.workload_items(ix, n)


def _samples(rng, count):
    return [{"t": float(i), "rss_mib": float(rng.integers(100, 200)) if i % 4 else 0.0,
             "routes": {r: {"rps": float(rng.random() * 50), "p99_s": float(rng.random())}
                        for r in ("POST /v1/a", "GET /v1/b")[: 1 + i % 2]}}
            for i in range(count)]


@pytest.mark.parametrize("count, cap", [(0, 5), (7, 10), (50, 10), (50, 1), (51, 2), (9, 0)])
def test_downsample_and_summarize_are_the_references(count, cap, reference):
    samples = _samples(np.random.default_rng(count * 31 + cap), count)
    assert load_soak.downsample(samples, cap) == reference.downsample(samples, cap)
    assert load_soak.summarize(samples) == reference.summarize(samples)


def test_run_round_takes_the_callers_values(tmp_path):
    from sda_tpu_torch.rest import serve_background
    from sda_tpu_torch.server import new_sqlite_server

    rng = np.random.default_rng(5)
    values = rng.integers(0, load_soak.MODULUS, size=(4, 300), dtype=np.int64)
    with serve_background(new_sqlite_server(str(tmp_path / "db"))) as url:
        stack = load_soak.build_stack(tmp_path, url, "cpu")
        record = load_soak.run_round(0, stack, len(values), None, values=values)
        default = load_soak.run_round(1, stack, 6, None)
    assert record["exact"] and record["n"] == 4
    assert default["exact"] and default["n"] == 6


@pytest.fixture(scope="module")
def soaks(tmp_path_factory):
    """One short soak of each package, run side by side."""
    root = tmp_path_factory.mktemp("soaks")
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-m", "sda_tpu_torch.scripts.load_soak", *SOAK_ARGV,
             "--device", "cpu", "--artifacts", str(root / "port")],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "reference": subprocess.Popen(
            [sys.executable, "scripts/load_soak.py", *SOAK_ARGV, "--artifacts", str(root / "ref")],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"}),
    }
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, f"{name}: {stderr[-3000:]}"
        out[name] = Path(stdout.strip().splitlines()[-1])
    return out


def test_cpu_soak_is_exact_with_the_references_keys(soaks):
    ours = json.loads(soaks["port"].read_text())
    theirs = json.loads(soaks["reference"].read_text())
    assert soaks["port"].name.startswith("soak-")
    assert set(ours) == set(theirs)
    assert set(ours["config"]) == set(theirs["config"])
    assert set(ours["rounds"][0]) == set(theirs["rounds"][0])
    assert set(ours["summary"]) == set(theirs["summary"])
    assert ours["total_rounds"] >= 1 and ours["exact_rounds"] == ours["total_rounds"]
    ts = [s["t"] for s in ours["samples"]]
    assert ts and ts == sorted(ts) and len(set(ts)) == len(ts)
    assert ours["history_route"]["samples_served"] >= 1 and ours["readyz"]["ready"]
    assert all(r["trace_id"] == f"soak-round-{r['round']}" for r in ours["rounds"])


def test_soak_artifact_renders_as_the_reference_renders_it(soaks, tmp_path):
    outs = []
    for cmd in (["-m", "sda_tpu_torch.scripts.trace_report"], ["scripts/trace_report.py"]):
        trace = tmp_path / "round.trace.json"
        out = subprocess.run([sys.executable, *cmd, str(soaks["port"]), "--out", str(trace)],
                             cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        outs.append((out.stdout, trace.read_text()))
    assert outs[0] == outs[1]
    assert json.loads(outs[0][1])["traceEvents"]


def test_bad_flag_combinations_are_refused():
    for argv in (["--kill-shard", "2"], ["--grow-shards", "1", "--kill-shard", "2", "--shards", "2",
                                          "--replicas", "2"]):
        with pytest.raises(SystemExit) as exc:
            load_soak.main([*argv, "--device", "cpu"])
        assert exc.value.code == 2
