"""Whole runs of both cells on the CPU at tiny sizes (the port's kernels run
as their plain versions), the result line, the command without a card, and
a cell, a mix and a metric added as files alone."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from conftest import REPO
from sdabench import catalog, harness

SEED = (1 << 31) + 12345  # seeds of the checks pass 32 bits


def run(root: Path, workload: str, trace: bool, seconds: float = 0.4, seed: int = SEED, device="cpu",
        **kw) -> dict:
    bench = catalog.load_benchmark(root)
    return harness.run_cell(bench, catalog.workload(bench, workload), seed=seed, seconds=seconds, trace=trace,
                            device=device, t0=time.perf_counter(), root=root, **kw)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", ["northstar.sumfirst", "cnn.engine"])
def test_result_line(tiny_root, workload, trace):
    result = run(tiny_root, workload, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys  # the compared numbers come last
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = catalog.load_benchmark(tiny_root)
    allowed = {m["name"]: m["unit"] for m in catalog.metrics_of(bench, workload, trace)}
    assert set(result["metrics"]) <= set(allowed)
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == allowed[name]
    if not trace:
        assert set(result["metrics"]) == set(allowed)  # every end-to-end metric, every run
    else:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in result["breakdown"].values())
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]
    json.dumps(result)


def test_same_seed_same_inputs(tiny_root):
    """The seed fixes the pools and orders: two runs judge the same data."""
    from sdabench.tracing import Tracer

    bench = catalog.load_benchmark(tiny_root)
    cfg = catalog.config(bench, "northstar-1m-100k", tiny_root)
    mix = catalog.traffic("sumfirst", tiny_root)
    loop = catalog.loop(mix["loop"], tiny_root)
    ref = catalog.reference(cfg["reference"], tiny_root)
    a, b = (loop.Cell(cfg, mix, SEED, "cpu", Tracer(False, "cpu"), ref) for _ in range(2))
    assert a.hi.equal(b.hi) and a.lo.equal(b.lo)
    assert (a.order.integers(0, 3, 10) == b.order.integers(0, 3, 10)).all()


def _tree_digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "sdabench").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_mix_and_metric_added_as_files(tiny_root):
    """A later change adds a configuration, a traffic mix and a per-layer and
    an end-to-end metric by new files and new entries, editing no file."""
    before = _tree_digest(tiny_root)
    cfg = json.loads((tiny_root / "sdabench/configs/cnn-mnist-fedavg.json").read_text())
    (tiny_root / "sdabench/configs/cnn-other.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny_root / "sdabench/traffic/engine.json").read_text())
    mix.update(chunk=8, pool_cohorts=1)
    (tiny_root / "sdabench/traffic/engine_whole.json").write_text(json.dumps(mix))
    (tiny_root / "sdabench/metrics/units_done.py").write_text(
        'UNIT, SOURCE, LAYER, MOVES = "units", "host_clock", None, None\n\n\n'
        "def read(run):\n    return len(run.units)\n")
    (tiny_root / "sdabench/metrics/slowest_unit_s.py").write_text(
        'UNIT, SOURCE, LAYER, MOVES = "s", "host_clock", "whole step", "units_done"\n\n\n'
        "def read(run):\n    return max(u.wall_s for u in run.units)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cnn-other", "source": "a copy", "file": "sdabench/configs/cnn-other.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "cnn.whole", "config": "cnn-other", "traffic": "engine_whole",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "units_done", "unit": "units", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["cnn.whole"]})
    bench["per_layer"].append({"name": "slowest_unit_s", "unit": "s", "better": "lower", "source": "host_clock",
                               "layer": "whole step", "moves": "units_done"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _tree_digest(tiny_root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    plain = run(tiny_root, "cnn.whole", trace=False)
    assert plain["correct"] and plain["metrics"]["units_done"]["value"] == plain["attempted"]
    assert set(plain["metrics"]) == {"secure_sum_elems_per_s", "setup_s", "units_done"}
    traced = run(tiny_root, "cnn.whole", trace=True)
    assert traced["correct"] and "slowest_unit_s" in traced["metrics"]
    # the metric without a workloads key reaches only cells that report what it moves
    assert "slowest_unit_s" not in run(tiny_root, "cnn.engine", trace=True)["metrics"]


def _env(tmp_path: Path) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("CUDA", "TORCH", "TRITON"))}
    for key in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        (tmp_path / key).mkdir()
        env[key] = str(tmp_path / key)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_command_without_a_card(tmp_path):
    """No CUDA device: exit 2, the missing device named, no result, no CPU
    fallback, and nothing written under the run's HOME, cache, TMPDIR, the
    checkout or /dev/shm."""
    env = _env(tmp_path)
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    checkout = _written(REPO)
    cmd = [sys.executable, *json.loads((REPO / "BENCHMARK.json").read_text())["command"][1:],
           "--workload", "cnn.engine", "--seed", str(SEED), "--seconds", "1", "--trace", "0"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr
    for key in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        assert not any((tmp_path / key).iterdir())
    if shm:
        assert set(os.listdir("/dev/shm")) <= shm
    assert _written(REPO) <= checkout


def _written(root: Path) -> set:
    """The checkout's top level and what lies under ``build/``, where the
    benchmark keeps its caches."""
    return set(root.iterdir()) | set((root / "build").rglob("*") if (root / "build").is_dir() else [])


def test_command_needs_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and sdabench/, the
    command fails and prints no result."""
    import shutil

    shutil.copytree(REPO / "sdabench", tmp_path / "sdabench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "env").mkdir()
    env = _env(tmp_path / "env")
    proc = subprocess.run([sys.executable, "-m", "sdabench", "--workload", "cnn.engine", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_unknown_workload_fails():
    with pytest.raises(catalog.CatalogError):
        catalog.workload(catalog.load_benchmark(), "no.such.cell")
