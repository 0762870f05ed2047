"""The port's round flight recorder (``sda_tpu_torch.telemetry.flight``)
against ``sda_tpu.telemetry.flight``: ``chrome_trace_json`` byte-equal, and
``chrome_trace``, ``round_report``, ``critical_path`` and ``traces_in``
equal, on the span lists of ``tests/test_flight.py`` and on the spans a
small sealed round of the port records under one trace id. The export is
deterministic for a fixed span list, so every comparison is exact."""

import json

import pytest

import test_flight as ref_cases
from sda_tpu.telemetry import flight as ref
from sda_tpu_torch import telemetry
from sda_tpu_torch.telemetry import flight as port

_span = ref_cases._span

SPAN_LISTS = {
    "pipelined round": ref_cases.ROUND,
    "pipelined round reversed": list(reversed(ref_cases.ROUND)),
    "with an unfinished span": ref_cases.ROUND + [_span("clerk.download", 103.0, None)],
    "empty": [],
    "sequential": [_span("a.x", 0.0, 1.0), _span("b.y", 1.0, 1.0)],
    "containment": [_span("svc.outer", 0.0, 5.0), _span("svc.inner", 1.0, 1.0)],
    "three traces": [_span("a.x", 10.0, 1.0, trace_id="r1"), _span("b.y", 11.0, 2.0, trace_id="r2"),
                     _span("a.z", 10.5, 1.0, trace_id="r1"), _span("c.w", 12.0, 1.0, trace_id=None)],
    "tier close": [_span("tier.close", 5.0, 2.0, tier=1, mode="fanout", width=4, nodes=3,
                         overlap_efficiency=0.5), _span("store.get", 5.5, 0.25),
                   _span("http.request", 6.0, 0.5, method="GET"), _span("crypto.seal", 7.5, 0.1),
                   _span("other.thing", 7.0, 0.7)],
}
FUNCTIONS = ["chrome_trace_json", "chrome_trace", "round_report", "critical_path", "traces_in"]


@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("label", list(SPAN_LISTS))
def test_flight_equals_reference(label, function):
    spans = SPAN_LISTS[label]
    got, want = getattr(port, function)(spans), getattr(ref, function)(spans)
    assert got == want
    if function == "chrome_trace_json":
        assert isinstance(got, str) and json.loads(got) == port.chrome_trace(spans)


def test_chrome_trace_json_pid_and_order_insensitive():
    spans = ref_cases.ROUND
    assert port.chrome_trace_json(spans, pid=7) == ref.chrome_trace_json(spans, pid=7)
    assert port.chrome_trace_json(spans) == port.chrome_trace_json(list(reversed(spans)))


def _round_spans(tmp_path) -> tuple:
    """The spans of a small ChaCha-masked packed-Shamir round of the port,
    recorded under one trace id; and that id."""
    import test_torch_round as rounds

    telemetry.reset()
    with telemetry.trace() as trace_id:
        out = rounds.run_round(tmp_path, "packed", "chacha")
    assert list(out) == list(rounds._inputs().sum(axis=0) % rounds.P)
    return telemetry.spans(trace_id=trace_id), trace_id


@pytest.fixture(scope="module")
def round_spans(tmp_path_factory):
    return _round_spans(tmp_path_factory.mktemp("flight"))


@pytest.mark.parametrize("function", FUNCTIONS)
def test_flight_of_a_port_round_equals_reference(round_spans, function):
    spans, _ = round_spans
    assert getattr(port, function)(spans) == getattr(ref, function)(spans)


def test_a_port_round_reads_as_one_trace(round_spans):
    spans, trace_id = round_spans
    stages = {row["stage"] for row in port.round_report(spans)["stages"]}
    assert {"store", "clerk", "reveal"} <= stages
    (trace,) = port.traces_in(spans)
    assert trace["trace_id"] == trace_id and trace["spans"] == len(spans)
    report = port.round_report(spans)
    assert report["busy_s"] <= report["wall_s"] and report["spans"] == len(spans)
    xs = [e for e in port.chrome_trace(spans)["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(spans)
