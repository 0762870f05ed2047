"""Round flight recorder CLI: render one trace's timeline from a banked
artifact (counterpart of ``scripts/trace_report.py``).

Input is anything that carries span records in the SpanLog shape
({name, trace_id, start, duration_s, attrs}):

- a soak artifact (``soak-<stamp>.json`` as ``load_soak`` banks it,
  which embeds the span ring and per-round trace ids),
- a ``/v1/metrics.json`` snapshot saved to a file,
- or a bare JSON array of span records.

Picks the trace to render by ``--trace``, else the artifact's last
round's trace id (soak artifacts), else the trace with the most spans —
then prints the stage waterfall, overlap efficiency, and critical path,
and (with ``--out``) writes Chrome trace-event JSON loadable in
``chrome://tracing`` or https://ui.perfetto.dev.

It reads JSON and touches no device, so it takes no ``--device``.

Usage:
  python -m sda_tpu_torch.scripts.trace_report soak-xyz.json          # report
  python -m sda_tpu_torch.scripts.trace_report soak-xyz.json --list   # traces in file
  python -m sda_tpu_torch.scripts.trace_report soak-xyz.json --trace t1 --out round.trace.json
"""

from __future__ import annotations

import argparse
import json
import sys

from ..telemetry import flight


def extract_spans(doc):
    """Span records from any supported artifact shape."""
    if isinstance(doc, list):
        return doc
    if isinstance(doc, dict):
        spans = doc.get("spans")
        if isinstance(spans, list):
            return spans
    return []


def default_trace(doc, spans):
    """The trace worth looking at when --trace is absent: the last soak
    round's id if recorded, else the busiest trace in the span list."""
    if isinstance(doc, dict):
        rounds = doc.get("rounds")
        if isinstance(rounds, list):
            for r in reversed(rounds):
                if isinstance(r, dict) and r.get("trace_id"):
                    if any(s.get("trace_id") == r["trace_id"] for s in spans):
                        return r["trace_id"]
    traces = flight.traces_in(spans)
    if not traces:
        return None
    return max(traces, key=lambda t: t["spans"])["trace_id"]


def print_report(trace_id: str, spans: list) -> None:
    report = flight.round_report(spans)
    print(f"trace {trace_id}: {report['spans']} spans, "
          f"wall {report['wall_s'] * 1000:.1f} ms, "
          f"busy {report['busy_s'] * 1000:.1f} ms, "
          f"span-sum {report['span_s'] * 1000:.1f} ms, "
          f"overlap efficiency {report['overlap_efficiency']:.2f}")

    print("\nstage waterfall (offset-ordered; bar spans offset..offset+busy):")
    wall = report["wall_s"] or 1e-9
    width = 40
    print(f"{'stage':>12} {'spans':>5} {'offset_ms':>10} {'busy_ms':>9} "
          f"{'share':>6}  timeline")
    for row in report["stages"]:
        lo = int(width * row["offset_s"] / wall)
        # draw the stage's busy time from its first start; clamp into frame
        ln = max(1, int(width * row["busy_s"] / wall))
        lo = min(lo, width - 1)
        bar = " " * lo + "#" * min(ln, width - lo)
        print(f"{row['stage']:>12} {row['spans']:>5} "
              f"{row['offset_s'] * 1000:>10.1f} {row['busy_s'] * 1000:>9.1f} "
              f"{row['share']:>6.2f}  |{bar:<{width}}|")

    if report.get("tier_close"):
        print("\ntier close levels (dispatch mode / lane occupancy):")
        for row in report["tier_close"]:
            eff = ("-" if row["overlap_efficiency"] is None
                   else f"{row['overlap_efficiency']:.2f}")
            print(f"  tier {row['tier']}: {row['nodes']} nodes, "
                  f"mode={row['mode']} width={row['width']} "
                  f"overlap={eff} in {row['duration_s'] * 1000:.1f} ms")

    print("\ncritical path (the span holding the wall clock at each moment):")
    for hop in report["critical_path"]:
        print(f"  +{hop['offset_s'] * 1000:>9.1f} ms  "
              f"{hop['name']:<24} {hop['duration_s'] * 1000:>9.1f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sda_tpu_torch.scripts.trace_report",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("artifact", help="soak-*.json / metrics.json / span array")
    ap.add_argument("--trace", help="trace id to render (default: last round)")
    ap.add_argument("--list", action="store_true",
                    help="list the traces present and exit")
    ap.add_argument("--out", help="write Chrome trace-event JSON here")
    args = ap.parse_args(argv)

    try:
        with open(args.artifact) as fh:
            doc = json.loads(fh.read())
    except (OSError, ValueError) as e:
        print(f"trace_report: cannot read {args.artifact}: {e}", file=sys.stderr)
        return 1
    spans = extract_spans(doc)
    if not spans:
        print(f"trace_report: no span records in {args.artifact}", file=sys.stderr)
        return 1

    if args.list:
        print(f"{'spans':>6} {'wall_ms':>9}  trace")
        for t in flight.traces_in(spans):
            print(f"{t['spans']:>6} {t['wall_s'] * 1000:>9.1f}  {t['trace_id']}")
        return 0

    trace_id = args.trace or default_trace(doc, spans)
    if trace_id is None:
        print("trace_report: no trace ids recorded on any span", file=sys.stderr)
        return 1
    selected = [s for s in spans if s.get("trace_id") == trace_id]
    if not selected:
        print(f"trace_report: no spans carry trace id {trace_id!r} "
              f"(try --list)", file=sys.stderr)
        return 1

    print_report(trace_id, selected)

    if args.out:
        with open(args.out, "w") as fh:
            fh.write(flight.chrome_trace_json(selected))
        print(f"\nchrome trace written to {args.out} "
              f"(open in chrome://tracing or ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # e.g. piped into head
        raise SystemExit(0)
