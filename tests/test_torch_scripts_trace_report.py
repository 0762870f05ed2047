"""``python -m sda_tpu_torch.scripts.trace_report`` against the reference's
``scripts/trace_report.py``: the same banked span artifacts (a soak
artifact with per-round trace ids, a metrics snapshot, a bare span array)
render to the same stdout, stderr, exit code and Chrome trace JSON."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from sda_tpu_torch.scripts import trace_report

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_trace_report",
                                                  ROOT / "scripts" / "trace_report.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(name, trace_id, start, duration, **attrs):
    return {"name": name, "trace_id": trace_id, "start": start, "duration_s": duration,
            "attrs": attrs}


def _round_spans(trace_id, t0):
    """One round's spans: ingest, http, store, clerk, reveal and a tier
    close level, nested and overlapping as a live round's are."""
    return [
        _span("http.request", trace_id, t0, 0.004, route="/v1/ping"),
        _span("ingest.build", trace_id, t0 + 0.005, 0.020, rows=8),
        _span("ingest.upload", trace_id, t0 + 0.026, 0.003, rows=1),
        _span("store.create_participation", trace_id, t0 + 0.027, 0.001),
        _span("ingest.upload", trace_id, t0 + 0.030, 0.004, rows=1),
        _span("phase.snapshot", trace_id, t0 + 0.040, 0.006),
        _span("clerk.download", trace_id, t0 + 0.047, 0.008),
        _span("clerk.decrypt", trace_id, t0 + 0.050, 0.010),
        _span("tier.close", trace_id, t0 + 0.052, 0.012, tier=1, nodes=2, mode="fanout",
              width=2, overlap_efficiency=0.75),
        _span("tier.close", trace_id, t0 + 0.066, 0.004, tier=0, nodes=1, mode="serial",
              width=1),
        _span("reveal.fold", trace_id, t0 + 0.071, 0.005),
        _span("reveal.reconstruct", trace_id, t0 + 0.076, 0.002),
    ]


def _artifacts(tmp_path) -> dict:
    spans = _round_spans("soak-round-0", 100.0) + _round_spans("soak-round-1", 101.0)
    spans += [_span("http.request", None, 102.0, 0.001)]
    docs = {
        "soak": {"kind": "soak", "rounds": [{"round": 0, "trace_id": "soak-round-0"},
                                            {"round": 1, "trace_id": "soak-round-1"}],
                 "spans": spans},
        "snapshot": {"counters": [], "spans": _round_spans("t-a", 5.0) + _round_spans("t-b", 9.0)[:4]},
        "array": _round_spans("only", 0.5),
        "no spans": {"spans": []},
        "untraced": [_span("http.request", None, 1.0, 0.001)],
    }
    paths = {}
    for label, doc in docs.items():
        paths[label] = tmp_path / f"{label.replace(' ', '-')}.json"
        paths[label].write_text(json.dumps(doc))
    paths["unreadable"] = tmp_path / "missing.json"
    return paths


CASES = [
    ("soak", []),
    ("soak", ["--list"]),
    ("soak", ["--trace", "soak-round-0"]),
    ("soak", ["--trace", "nope"]),
    ("soak", ["--out", "{out}"]),
    ("snapshot", []),
    ("snapshot", ["--out", "{out}"]),
    ("array", ["--list"]),
    ("array", ["--out", "{out}"]),
    ("no spans", []),
    ("untraced", []),
    ("unreadable", []),
]


@pytest.mark.parametrize("label, extra", CASES, ids=[f"{a}-{' '.join(b)}" for a, b in CASES])
def test_renders_as_the_reference_does(label, extra, tmp_path, reference, monkeypatch, capsys):
    path = _artifacts(tmp_path)[label]

    def run(main, out, name):
        argv = [str(path)] + [a.replace("{out}", str(out)) for a in extra]
        if main is reference.main:
            monkeypatch.setattr(sys, "argv", ["trace_report.py", *argv])
            rc = main()
        else:
            rc = main(argv)
        captured = capsys.readouterr()
        text = out.read_text() if out.exists() else None
        return rc, captured.out.replace(str(out), name), captured.err, text

    ours = run(trace_report.main, tmp_path / "ours.trace.json", "OUT")
    theirs = run(reference.main, tmp_path / "theirs.trace.json", "OUT")
    assert ours == theirs
    if "--out" in extra:
        assert json.loads(ours[3])  # loads as Chrome trace JSON
