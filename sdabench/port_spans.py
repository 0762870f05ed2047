"""The port's own ranges in a traced run, read beside the benchmark's spans.

    python3 -m sdabench.port_spans --workload cnn.engine --seed 7 --seconds 10 --trace 1

runs the cell as ``python3 -m sdabench`` does, with the same arguments, exit
codes and result line, and reads from the same profiler trace the ``sda.``
ranges that the port opens while a profiler records
(``sda_tpu_torch.telemetry.device_span``). It prints one more line to
stderr, before the checks::

    [port_spans] {"metrics": {...}, "device_s": {...}, "counts": {...}, "idle_s": {...}, ...}

- ``device_s``: the device seconds of the ops launched while each port range
  was the innermost port range open; ``outside_any_port_span`` where none
  was (``outside_share`` is its part of the busy time);
- ``counts``: the ranges of each name that opened inside the window; the
  ``sync.<site>`` ranges count the host's syncs by site;
- ``idle_s``: each idle gap of the device, charged to the innermost port
  range open when the gap began (when the device's op before it ended), as
  ``tracing.summarize`` charges its gaps to the benchmark's spans;
- ``top_ops``: the longest device ops launched inside each port range;
- ``metrics``: the yardsticks of ROADMAP B1-B3 (``yardsticks``), each left
  out where the trace lacks device records or its range is absent.

None of these is in ``BENCHMARK.json``: the harness's readers see only the
benchmark's own ``sdabench.`` spans. This module wraps
``tracing.summarize`` and ``harness.read_metrics`` for the one run it makes,
and changes nothing of either.
"""

from __future__ import annotations

import contextlib
import json
import sys
from collections import defaultdict

from . import harness, tracing

PREFIX = "sda."
OUTSIDE = "outside_any_port_span"
TOP = 4


def summarize(events: list) -> dict:
    """Chrome-trace events of one profiled window -> the port ranges' device
    seconds, occurrences and idle gaps (see the module's docstring)."""
    spans, launches, ops = [], {}, []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            if name == tracing.WINDOW:
                window = (ts, ts + dur)
            elif name.startswith(PREFIX):
                spans.append((ts, ts + dur, name[len(PREFIX):]))
        elif cat in tracing.LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in tracing.DEVICE_CATS:
            ops.append((ts, ts + dur, name, (ev.get("args") or {}).get("correlation")))
    if window is None:
        raise ValueError("the trace holds no window span")
    ws, we = window
    index = tracing._innermost(spans)
    counts = defaultdict(int)
    for s, _, name in spans:
        if ws <= s < we:
            counts[name] += 1
    device = defaultdict(float)
    by_op = defaultdict(lambda: defaultdict(float))
    intervals = []
    for s, e, name, corr in ops:
        s, e = max(s, ws), min(e, we)
        if e <= s:
            continue
        intervals.append((s, e))
        launched = launches.get(corr)
        where = (tracing._at(index, launched) if launched is not None else None) or OUTSIDE
        device[where] += (e - s) / 1e6
        by_op[where][name[:tracing.NAME_CHARS]] += (e - s) / 1e6
    intervals.sort()
    busy, cursor = 0.0, ws
    idle = defaultdict(float)
    for s, e in intervals:
        if s > cursor:
            idle[tracing._at(index, cursor) or OUTSIDE] += (s - cursor) / 1e6
        if e > cursor:
            busy += (e - max(s, cursor)) / 1e6
            cursor = e
    if we > cursor:
        idle[tracing._at(index, cursor) or OUTSIDE] += (we - cursor) / 1e6
    top_ops = {where: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
               for where, d in by_op.items()}
    return {"window_s": (we - ws) / 1e6, "busy_s": busy, "device_s": dict(device), "counts": dict(counts),
            "idle_s": dict(idle), "top_ops": top_ops,
            "outside_share": device.get(OUTSIDE, 0.0) / busy if busy else None}


def yardsticks(port: dict, units: list, missing_records: int = 0) -> dict:
    """The traced ``units`` (``record.Unit``) and their port summary -> the
    yardsticks that the ranges hold; none where records are missing or the
    trace holds no device op.

    - ``sumfirst.reduce.roofline`` (%): the whole step's least time (the
      secrets read once) over the ``sumfirst.reduce`` device seconds;
    - ``sumfirst.draw_ms``: ``sumfirst.draw`` device ms over its ranges;
    - ``expand.k2.roofline`` (%): ChaCha20's least time (the layer
      ``expand``) over the ``chacha.k2`` device seconds;
    - ``expand.compact_ms``: ``chacha.compact`` device ms a unit;
    - ``share.k1.roofline`` (%): share and combine's least time over the
      ``limb.k1`` device seconds;
    - ``sync.idle_ms``: the idle of the gaps that began inside a
      ``sync.<site>`` range, ms a unit.
    """
    if missing_records or not units or not port["busy_s"]:
        return {}
    device, counts, idle = port["device_s"], port["counts"], port["idle_s"]

    def least(layer=None):
        return sum(u.least_s if layer is None else u.layer_least_s.get(layer, 0.0) for u in units)

    out = {}
    if device.get("sumfirst.reduce"):
        out["sumfirst.reduce.roofline"] = 100.0 * least() / device["sumfirst.reduce"]
    if device.get("sumfirst.draw") and counts.get("sumfirst.draw"):
        out["sumfirst.draw_ms"] = 1e3 * device["sumfirst.draw"] / counts["sumfirst.draw"]
    if device.get("chacha.k2"):
        out["expand.k2.roofline"] = 100.0 * least("expand") / device["chacha.k2"]
    if device.get("chacha.compact"):
        out["expand.compact_ms"] = 1e3 * device["chacha.compact"] / len(units)
    if device.get("limb.k1"):
        out["share.k1.roofline"] = 100.0 * least("share") / device["limb.k1"]
    if any(name.startswith("sync.") for name in counts):
        out["sync.idle_ms"] = 1e3 * sum(v for k, v in idle.items() if k.startswith("sync.")) / len(units)
    return out


@contextlib.contextmanager
def reading():
    """Within the block, each traced run of the harness also reads the port's
    ranges: yields the list that each run's report is appended to (and
    printed to stderr as ``[port_spans] {json}``)."""
    reports, seen = [], []
    summarize_trace, read_metrics = tracing.summarize, harness.read_metrics

    def summarize_both(events, units, counted=None):
        seen.append(summarize(events))
        return summarize_trace(events, units, counted)

    def read_both(entries, run, root):
        out = read_metrics(entries, run, root)
        if run.trace is not None and seen:
            port = seen.pop()
            units = [run.units[i] for i in run.trace.units]
            report = {"metrics": yardsticks(port, units, run.trace.missing_records), "units": len(units),
                      "missing_records": run.trace.missing_records,
                      "walls_s": [u.wall_s for u in units], **port}
            reports.append(report)
            print("[port_spans] " + json.dumps(report), file=sys.stderr, flush=True)
        return out

    tracing.summarize, harness.read_metrics = summarize_both, read_both
    try:
        yield reports
    finally:
        tracing.summarize, harness.read_metrics = summarize_trace, read_metrics


def main(argv=None) -> int:
    with reading():
        return harness.main(argv)


if __name__ == "__main__":
    sys.exit(main())
