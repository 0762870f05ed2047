"""``sdabench.port_spans``: the port's ``sda.`` ranges read from a traced
run's profiler trace, on a trace written by hand and in tiny CPU runs of
both cells; the benchmark's own reading of the trace does not change."""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import pytest

from sdabench import catalog, harness, port_spans, tracing
from sdabench.record import Unit

REPO = Path(__file__).resolve().parents[1]


def X(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


BENCH = [X("user_annotation", tracing.WINDOW, 0, 1000), X("user_annotation", "sdabench.round", 0, 1000)]
PORT = [
    X("user_annotation", "sda.chacha.expand", 0, 240),
    X("user_annotation", "sda.chacha.k2", 10, 30),
    X("user_annotation", "sda.chacha.compact", 50, 180),
    X("user_annotation", "sda.sync.fold_counts", 240, 80),
    X("user_annotation", "sda.limb.k1", 400, 100),
    X("user_annotation", "sda.limb.k1", 1200, 100),  # after the window
]
DEVICE = [
    X("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
    X("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=2),
    X("cuda_driver", "cuLaunchKernel", 410, 5, corr=3),
    X("cuda_runtime", "cudaLaunchKernel", 700, 5, corr=4),
    X("kernel", "chacha20_kernel", 100, 50, corr=1),
    X("kernel", "cumsum", 150, 100, corr=2),
    X("kernel", "limb_share_sum_kernel", 450, 100, corr=3),
    X("kernel", "add", 800, 50, corr=4),
]


def test_port_ranges_read_by_innermost_range():
    got = port_spans.summarize(BENCH + PORT + DEVICE)
    assert got["window_s"] == pytest.approx(1000e-6)
    assert got["busy_s"] == pytest.approx(300e-6)
    assert got["device_s"] == pytest.approx({"chacha.k2": 50e-6, "chacha.compact": 100e-6, "limb.k1": 100e-6,
                                             port_spans.OUTSIDE: 50e-6})
    assert got["counts"] == {"chacha.expand": 1, "chacha.k2": 1, "chacha.compact": 1, "sync.fold_counts": 1,
                             "limb.k1": 1}
    # 0-100 begins inside chacha.expand, 250-450 inside the sync, 550-800 and 850-1000 in no port range:
    # the benchmark's own span does not count
    assert got["idle_s"] == pytest.approx({"chacha.expand": 100e-6, "sync.fold_counts": 200e-6,
                                           port_spans.OUTSIDE: 400e-6})
    assert got["outside_share"] == pytest.approx(50 / 300)
    assert got["top_ops"]["chacha.compact"] == [["cumsum", pytest.approx(100e-6)]]


def test_port_ranges_leave_the_benchmarks_reading_as_it_was():
    assert tracing.summarize(BENCH + PORT + DEVICE, [0]) == tracing.summarize(BENCH + DEVICE, [0])


def test_no_window_is_refused():
    with pytest.raises(ValueError):
        port_spans.summarize(PORT + DEVICE)


CNN_UNIT = Unit(wall_s=0.1, elems=1, least_s=2e-6, layer_least_s={"expand": 40e-6, "share": 20e-6})


def test_yardsticks_of_a_round():
    got = port_spans.yardsticks(port_spans.summarize(BENCH + PORT + DEVICE), [CNN_UNIT, CNN_UNIT])
    assert got == pytest.approx({"expand.k2.roofline": 160.0, "expand.compact_ms": 0.05,
                                 "share.k1.roofline": 40.0, "sync.idle_ms": 0.1})


def test_yardsticks_of_an_aggregate():
    port = {"busy_s": 3.7, "device_s": {"sumfirst.draw": 0.5, "sumfirst.reduce": 3.2},
            "counts": {"sumfirst.draw": 2000, "sumfirst.reduce": 2000}, "idle_s": {}}
    got = port_spans.yardsticks(port, [Unit(wall_s=4.3, elems=1, least_s=0.24)])
    assert got == pytest.approx({"sumfirst.reduce.roofline": 7.5, "sumfirst.draw_ms": 0.25})


@pytest.mark.parametrize("missing", ["records", "ranges", "units"])
def test_yardsticks_left_out(missing):
    port = port_spans.summarize(BENCH + (PORT if missing != "ranges" else []) + DEVICE)
    units = [] if missing == "units" else [CNN_UNIT]
    got = port_spans.yardsticks(port, units, missing_records=1 if missing == "records" else 0)
    assert got == {}


def _tiny_root(tmp_path):
    spec = importlib.util.spec_from_file_location("sdabench_tiny_conftest", REPO / "sdabench/tests/conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.make_tiny_root(tmp_path)


WANT = {
    "northstar.sumfirst": {"sumfirst.draw", "sumfirst.reduce"},
    "cnn.engine": {"fl.quantize", "sync.quantize_finite", "chacha.expand", "chacha.k2", "chacha.compact",
                   "chacha.fold", "sync.fold_counts", "engine.share_combine", "limb.draw", "limb.k1",
                   "limb.recombine", "engine.reconstruct", "fl.dequantize_mean", "fl.apply"},
}


@pytest.mark.parametrize("cell", sorted(WANT))
def test_a_traced_cpu_run_reports_the_port_ranges(cell, tmp_path):
    """The cell at a tiny size on the CPU, traced, inside ``reading()``: one
    report holding the port's ranges, the same result line's keys as without,
    and the harness's functions put back afterwards."""
    root = _tiny_root(tmp_path)
    bench = catalog.load_benchmark(root)
    workload = catalog.workload(bench, cell)

    def run():
        return harness.run_cell(bench, workload, seed=2**31 + 9, seconds=0.2, trace=True, device="cpu",
                                t0=time.perf_counter(), root=root)

    plain = run()
    with port_spans.reading() as reports:
        result = run()
    assert tracing.summarize.__module__ == "sdabench.tracing"
    assert harness.read_metrics.__module__ == "sdabench.harness"
    assert result["correct"] and plain["correct"]
    assert set(result["metrics"]) == set(plain["metrics"])
    (report,) = reports
    assert WANT[cell] <= set(report["counts"])
    assert report["missing_records"] == 0 and report["units"] >= 1
    assert report["metrics"] == {}  # no device ops on the CPU
