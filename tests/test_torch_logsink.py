"""The port's telemetry tail against ``sda_tpu``'s: the JSON log sink
(``telemetry.logsink``: ``emit``, ``install``, ``uninstall``) writes the
reference's lines for the same records, and every finished span of the
port reaches it once with its trace id; ``Metrics.report()`` and
``reset()`` give the reference's windows over the same counts and phases
(on one fake clock, so the seconds are equal too); ``Counter.value()``
reads the merged count. Every comparison is exact."""

import importlib
import json
import logging
import time
import types

import pytest

from sda_tpu import telemetry as ref_telemetry
from sda_tpu.telemetry import logsink as ref_logsink
from sda_tpu.utils import metrics as ref_metrics
from sda_tpu.utils.metrics import Metrics as RefMetrics
from sda_tpu_torch import telemetry
from sda_tpu_torch.telemetry import logsink
from sda_tpu_torch.utils import metrics as port_metrics
from sda_tpu_torch.utils.metrics import Metrics

# the modules, not the packages' ``spans()`` functions of the same name
ref_spans = importlib.import_module("sda_tpu.telemetry.spans")
port_spans = importlib.import_module("sda_tpu_torch.telemetry.spans")

RECORDS = [
    ("span", {"name": "clerk.decrypt", "trace_id": "t1", "start": 100.25, "attrs": {"rows": 8},
              "duration_s": 0.5}),
    ("span", {"name": "reveal.fold", "trace_id": None, "start": 101.0, "attrs": None,
              "duration_s": 0.125}),
    ("request", {"trace_id": "t2", "path": "/v1/ping", "status": 200}),
    ("odd", {"trace_id": "t3", "value": object.__new__(type("Opaque", (), {"__repr__":
                                                                         lambda self: "<opaque>"}))}),
]


@pytest.fixture(autouse=True)
def _logger_level():
    """``install`` lowers the shared ``sda.telemetry`` logger to DEBUG and
    ``uninstall`` leaves it there, in both packages: restore it after each
    case."""
    logger = logging.getLogger("sda.telemetry")
    level = logger.level
    yield
    logger.setLevel(level)


def _cyclic():
    d = {}
    d["self"] = d
    return d


def _lines(module, path, records) -> list:
    handler = module.install(path)
    try:
        for event, fields in records:
            module.emit(event, fields)
    finally:
        module.uninstall(handler)
    return path.read_text().splitlines()


@pytest.mark.parametrize("case", range(len(RECORDS) + 1))
def test_logsink_lines_equal_reference(case, tmp_path):
    if case == len(RECORDS):
        records = [("bad", {"trace_id": "t5", "cycle": _cyclic()})]  # unserializable
    else:
        records = [RECORDS[case]]
    got = _lines(logsink, tmp_path / "port.jsonl", records)
    want = _lines(ref_logsink, tmp_path / "ref.jsonl", records)
    assert got == want and len(got) == 1


def test_logsink_is_silent_until_installed(caplog):
    logging.getLogger("sda.telemetry").setLevel(logging.WARNING)
    with caplog.at_level(logging.WARNING, logger="sda.telemetry"):
        logsink.emit("span", {"trace_id": "t"})
    assert not caplog.records


def test_every_finished_span_reaches_the_sink_once(tmp_path):
    telemetry.reset()
    path = tmp_path / "telemetry.jsonl"
    handler = logsink.install(path)
    try:
        with telemetry.trace() as trace_id:
            for i in range(5):
                with telemetry.span("clerk.combine", i=i):
                    pass
            with telemetry.span("reveal.fold"):
                with telemetry.span("reveal.decrypt", what="masks"):
                    pass
    finally:
        logsink.uninstall(handler)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    spans = telemetry.spans(trace_id=trace_id)
    assert len(lines) == len(spans) == 7
    keys = [(s["name"], s["start"], s["duration_s"]) for s in spans]
    assert sorted(keys) == sorted((r["name"], r["start"], r["duration_s"]) for r in lines)
    assert all(r["event"] == "span" and r["trace_id"] == trace_id for r in lines)


def test_disabled_telemetry_emits_nothing(tmp_path):
    path = tmp_path / "telemetry.jsonl"
    handler = logsink.install(path)
    telemetry.set_enabled(False)
    try:
        with telemetry.span("clerk.combine"):
            pass
    finally:
        telemetry.set_enabled(True)
        logsink.uninstall(handler)
    assert path.read_text() == ""


class _Clock:
    """A perf_counter that moves by a fixed step on every read (patched into
    the metrics and span modules only, so no other thread moves it)."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.125
        return self.t


def _drive(metrics, windows):
    """Each window: reset or not, then its counts and phases; the report."""
    reports = []
    for reset, counts, phases in windows:
        if reset:
            metrics.reset()
        for name, delta in counts:
            metrics.count(name, delta)
        for name in phases:
            with metrics.phase(name):
                pass
        reports.append(metrics.report())
    return reports


WINDOWS = {
    "one window": [(True, [("snapshots", 1), ("clerk.participations", 4)], ["snapshot.freeze"])],
    "growing": [(True, [("a", 1)], ["p"]), (False, [("a", 2), ("b", 5)], ["p", "q"])],
    "reset between": [(True, [("a", 3)], ["p", "p"]), (True, [], []), (True, [("a", 1)], ["p"])],
    "phases only": [(True, [], ["x", "y", "x"]), (False, [], ["y"])],
}


@pytest.mark.parametrize("label", list(WINDOWS))
def test_metrics_report_and_reset_windows_equal_reference(label, monkeypatch):
    telemetry.reset()
    ref_telemetry.reset()
    clock = _Clock()
    fake = types.SimpleNamespace(perf_counter=clock, time=time.time)
    for module in (port_metrics, port_spans, ref_metrics, ref_spans):
        monkeypatch.setattr(module, "time", fake)
    got = _drive(Metrics(), WINDOWS[label])
    clock.t = 1000.0
    want = _drive(RefMetrics(), WINDOWS[label])
    assert got == want
    assert set(got[-1]) == {"counters", "phases"}


def test_metrics_reset_leaves_the_registry():
    telemetry.reset()
    m = Metrics()
    m.count("snapshots", 2)
    m.reset()
    assert m.report() == {"counters": {}, "phases": {}}
    snap = telemetry.get_registry().snapshot()
    assert snap["counters"][("sda_events_total", (("event", "snapshots"),))] == 2


@pytest.mark.parametrize("incs", [[], [1], [1, 2, 3], [7, 0, 5]])
def test_counter_value_equals_reference(incs):
    telemetry.reset()
    ref_telemetry.reset()
    port_counter = telemetry.counter("sda_test_total", "test", path="x")
    ref_counter = ref_telemetry.counter("sda_test_total", "test", path="x")
    for n in incs:
        port_counter.inc(n)
        ref_counter.inc(n)
    assert port_counter.value() == ref_counter.value() == sum(incs)
    assert telemetry.counter("sda_test_total", "test", path="y").value() == 0
