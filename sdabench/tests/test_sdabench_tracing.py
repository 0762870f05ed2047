"""The reading of a profiler trace, on a trace written by hand."""

from __future__ import annotations

import pytest

from sdabench import catalog
from sdabench.record import Run, Unit
from sdabench.tracing import PREFIX, WINDOW, _innermost, _at, summarize


def X(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_innermost_span():
    index = _innermost([(0, 100, "round"), (10, 20, "expand"), (30, 60, "share"), (40, 50, "inner")])
    assert [_at(index, t) for t in (5, 15, 25, 35, 45, 55, 70, 150)] == \
        ["round", "expand", "round", "share", "inner", "share", "round", None]


def test_summarize():
    events = [
        X("user_annotation", WINDOW, 0, 1000),
        X("user_annotation", PREFIX + "expand", 0, 300),
        X("user_annotation", PREFIX + "share", 300, 400),
        X("user_annotation", PREFIX + "reveal", 700, 300),
        X("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
        X("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=2),
        X("cuda_driver", "cuLaunchKernel", 310, 5, corr=3),
        X("kernel", "chacha20_kernel", 100, 100, corr=1),  # expand: 100 us
        X("kernel", "compact", 150, 100, corr=2),  # expand: overlaps, busy to 250
        X("kernel", "limb_share_sum", 400, 200, corr=3),  # share
        X("gpu_memcpy", "Memcpy DtoH", 900, 200, corr=99),  # no launch record; clipped at 1000
        X("kernel", "outside", 2000, 10, corr=1),  # after the window
    ]
    s = summarize(events, [0, 1])
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((250 - 100 + 200 + 100) * 1e-6)
    assert s.span_device_s == pytest.approx({"expand": 200e-6, "share": 200e-6})
    assert s.unattributed_ops == 1
    assert dict(s.device_ops) == pytest.approx({"chacha20_kernel": 100e-6, "compact": 100e-6,
                                                "limb_share_sum": 200e-6, "Memcpy DtoH": 100e-6})
    # idle: 0-100 (expand open), 250-400 (expand until 300, then share), 600-900 (share until 700, then reveal):
    # each gap goes to what the host was doing when the device went idle
    assert dict(s.idle_gaps) == pytest.approx({"expand": 100e-6 + 150e-6, "share": 300e-6})
    assert s.units == [0, 1]


def _launched(corrs_recorded, corrs_launched, kernel="chacha20_kernel"):
    events = [X("user_annotation", WINDOW, 0, 1000), X("user_annotation", PREFIX + "expand", 0, 1000)]
    events += [X("cuda_runtime", "cudaLaunchKernel", 10 * c, 5, corr=c) for c in corrs_launched]
    events += [X("kernel", f"{kernel}(int const*, int*)", 100 + 10 * c, 5, corr=c) for c in corrs_recorded]
    return events


def test_missing_device_records():
    """Kernel records held against the port's launch counts and against the
    trace's own launches: a dropped record is counted, not hidden."""
    whole = summarize(_launched([1, 2, 3], [1, 2, 3]), [0], {"chacha20_kernel": 3})
    assert whole.missing_records == 0 and whole.kernel_launches == {"chacha20_kernel": [3, 3]}
    dropped = summarize(_launched([1, 3], [1, 2, 3]), [0], {"chacha20_kernel": 3})
    assert dropped.orphan_launches == 1 and dropped.kernel_launches == {"chacha20_kernel": [3, 2]}
    assert dropped.missing_records == 2
    # a launch the trace did not see either: only the port's count shows it
    unseen = summarize(_launched([1, 2], [1, 2]), [0], {"chacha20_kernel": 3})
    assert unseen.orphan_launches == 0 and unseen.missing_records == 1


@pytest.mark.parametrize("name", ["expand.roofline", "share.roofline", "device.idle_share"])
def test_trace_metrics_left_out_where_records_are_missing(name):
    run = Run(units=[Unit(wall_s=1.0, elems=1, least_s=0.1, layer_least_s={"expand": 1e-6, "share": 1e-6})])
    events = _launched([1, 2], [1, 2])
    events.append(X("user_annotation", PREFIX + "share", 500, 100))
    events.append(X("kernel", "limb_share_sum_kernel", 510, 5, corr=9))
    events.append(X("cuda_runtime", "cudaLaunchKernel", 505, 2, corr=9))
    reader = catalog.metric(name)
    run.trace = summarize(events, [0], {"chacha20_kernel": 2})
    assert reader.read(run) is not None
    run.trace = summarize(events, [0], {"chacha20_kernel": 3})
    assert reader.read(run) is None
