"""Round flight recorder: per-trace span assembly and export (copy of
``sda_tpu/telemetry/flight.py``).

The SpanLog ring answers "what spans happened recently"; a soak
investigation needs "what did round 317 *look like*" — which stage was
the critical path, how well did the download/compute pipeline overlap,
where did the wall-clock go. This module stitches the flat span records
sharing one trace id into that picture:

- ``chrome_trace(spans)`` exports Chrome trace-event JSON (load it in
  ``chrome://tracing`` or https://ui.perfetto.dev): one "X" complete
  event per span with microsecond timestamps, grouped into per-stage
  tracks (``ingest``, ``clerk``, ``reveal``, ``rest``, ``store``, ...)
  via thread-name metadata events;
- ``round_report(spans)`` computes the numbers the reference's
  ``scripts/trace_report.py`` prints: a per-stage waterfall
  (offset/duration/share of wall clock), overlap efficiency (how much span
  time ran concurrently with other spans), and the greedy critical path
  through the timeline.

Input is the plain span-record shape the ring stores —
``{name, trace_id, start (epoch s), duration_s, attrs}`` — so both the
live ring (``telemetry.spans(trace_id=...)``) and spans banked inside a
``soak-*.json`` artifact feed it unchanged. Export is deterministic for
a fixed span list: ties sort on (start, name), ids are assigned in
sorted order, and nothing consults the clock.
"""

from __future__ import annotations

import json

#: span-name prefix -> display track (tid) for the trace viewer; prefixes
#: are matched longest-first so e.g. "clerk.chunk" beats "clerk"
_TRACKS = (
    ("ingest", 1),
    ("client", 2),
    ("clerk", 3),
    ("reveal", 4),
    ("rest", 5),
    ("http", 5),
    ("service", 6),
    ("store", 7),
    ("crypto", 8),
)
_OTHER_TRACK = 9

_TRACK_NAMES = {
    1: "ingest",
    2: "client",
    3: "clerk",
    4: "reveal",
    5: "rest",
    6: "service",
    7: "store",
    8: "crypto",
    9: "other",
}


def _track_of(name: str) -> int:
    for prefix, tid in _TRACKS:
        if name == prefix or name.startswith(prefix + "."):
            return tid
    return _OTHER_TRACK


def _stage_of(name: str) -> str:
    """Waterfall grouping key: the first dotted component."""
    return name.split(".", 1)[0]


def _finished(spans) -> list:
    """Finished spans only (a live ring may hold records mid-flight),
    sorted deterministically by (start, name)."""
    out = [s for s in spans if s.get("duration_s") is not None]
    out.sort(key=lambda s: (s["start"], s["name"]))
    return out


# -- Chrome trace-event export ----------------------------------------------


def chrome_trace(spans, pid: int = 1) -> dict:
    """Chrome trace-event JSON for a span list (Perfetto-loadable).

    Timestamps are microseconds relative to the earliest span start, so
    the viewer opens at t=0 regardless of wall-clock epoch.
    """
    spans = _finished(spans)
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": "sda-round"},
        }
    ]
    used_tracks = sorted({_track_of(s["name"]) for s in spans})
    for tid in used_tracks:
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": _TRACK_NAMES[tid]},
            }
        )
        events.append(
            {
                "name": "thread_sort_index",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"sort_index": tid},
            }
        )
    t0 = spans[0]["start"] if spans else 0.0
    for s in spans:
        args = {"trace_id": s.get("trace_id")}
        if s.get("attrs"):
            args.update(s["attrs"])
        events.append(
            {
                "name": s["name"],
                "cat": _stage_of(s["name"]),
                "ph": "X",
                "pid": pid,
                "tid": _track_of(s["name"]),
                "ts": round((s["start"] - t0) * 1e6, 1),
                "dur": round(s["duration_s"] * 1e6, 1),
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def chrome_trace_json(spans, pid: int = 1) -> str:
    return json.dumps(chrome_trace(spans, pid=pid), indent=1, sort_keys=True)


# -- interval math -----------------------------------------------------------


def _union_coverage(intervals) -> float:
    """Total length covered by a union of (start, end) intervals."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    covered = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            covered += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    return covered + (cur_e - cur_s)


def critical_path(spans) -> list:
    """Greedy walk over the timeline: at each point pick, among spans
    covering it, the one reaching furthest; gaps jump to the next start.

    Returns the chosen span records in order. For a pipelined round this
    reads as "the stage that was holding the wall clock at each moment".
    """
    spans = _finished(spans)
    if not spans:
        return []
    path = []
    t = spans[0]["start"]
    i = 0
    n = len(spans)
    while i < n:
        best = None
        j = i
        while j < n and spans[j]["start"] <= t + 1e-12:
            end = spans[j]["start"] + spans[j]["duration_s"]
            if best is None or end > best["start"] + best["duration_s"]:
                best = spans[j]
            j += 1
        if best is None:
            t = spans[i]["start"]  # gap: jump to the next span's start
            continue
        path.append(best)
        t = max(t, best["start"] + best["duration_s"])
        while i < n and spans[i]["start"] <= t + 1e-12 and (
            spans[i]["start"] + spans[i]["duration_s"] <= t + 1e-12
        ):
            i += 1
    return path


# -- round report ------------------------------------------------------------


def round_report(spans) -> dict:
    """The numbers behind the reference's ``scripts/trace_report.py``:

    - ``wall_s`` — earliest start to latest end;
    - ``busy_s`` — union coverage (time with >=1 span running);
    - ``span_s`` — sum of all span durations;
    - ``overlap_efficiency`` — (span_s - busy_s) / span_s: 0 means fully
      sequential, ->1 means heavily pipelined;
    - ``stages`` — per-stage waterfall rows, ordered by first start:
      {stage, spans, offset_s, busy_s, span_s, share} where share is
      busy_s / wall_s;
    - ``tier_close`` — one row per ``tier.close`` span: the level's
      dispatch mode/width and the per-level ``overlap_efficiency`` the
      fanned-out driver stamped on the span (client/tiers.py);
    - ``critical_path`` — {name, offset_s, duration_s} hops.
    """
    spans = _finished(spans)
    if not spans:
        return {
            "spans": 0,
            "wall_s": 0.0,
            "busy_s": 0.0,
            "span_s": 0.0,
            "overlap_efficiency": 0.0,
            "stages": [],
            "tier_close": [],
            "critical_path": [],
        }
    t0 = spans[0]["start"]
    t1 = max(s["start"] + s["duration_s"] for s in spans)
    wall = t1 - t0
    span_sum = sum(s["duration_s"] for s in spans)
    busy = _union_coverage(
        [(s["start"], s["start"] + s["duration_s"]) for s in spans]
    )

    stages: dict = {}
    order: list = []
    for s in spans:
        stage = _stage_of(s["name"])
        if stage not in stages:
            stages[stage] = {"spans": [], "first": s["start"]}
            order.append(stage)
        stages[stage]["spans"].append(s)
    stage_rows = []
    for stage in order:
        group = stages[stage]["spans"]
        g_busy = _union_coverage(
            [(s["start"], s["start"] + s["duration_s"]) for s in group]
        )
        stage_rows.append(
            {
                "stage": stage,
                "spans": len(group),
                "offset_s": round(stages[stage]["first"] - t0, 6),
                "busy_s": round(g_busy, 6),
                "span_s": round(sum(s["duration_s"] for s in group), 6),
                "share": round(g_busy / wall, 4) if wall > 0 else 0.0,
            }
        )

    tier_rows = []
    for s in spans:
        if s["name"] != "tier.close":
            continue
        attrs = s.get("attrs") or {}
        tier_rows.append(
            {
                "tier": attrs.get("tier"),
                "mode": attrs.get("mode"),
                "width": attrs.get("width"),
                "nodes": attrs.get("nodes"),
                "overlap_efficiency": attrs.get("overlap_efficiency"),
                "duration_s": round(s["duration_s"], 6),
            }
        )

    path = [
        {
            "name": s["name"],
            "offset_s": round(s["start"] - t0, 6),
            "duration_s": round(s["duration_s"], 6),
        }
        for s in critical_path(spans)
    ]
    return {
        "spans": len(spans),
        "wall_s": round(wall, 6),
        "busy_s": round(busy, 6),
        "span_s": round(span_sum, 6),
        "overlap_efficiency": round((span_sum - busy) / span_sum, 4)
        if span_sum > 0
        else 0.0,
        "stages": stage_rows,
        "tier_close": tier_rows,
        "critical_path": path,
    }


def traces_in(spans) -> list:
    """Distinct trace ids in a span list, ordered by first appearance,
    with span counts: [{trace_id, spans, wall_s}]."""
    seen: dict = {}
    order: list = []
    for s in _finished(spans):
        tid = s.get("trace_id")
        if tid is None:
            continue
        if tid not in seen:
            seen[tid] = []
            order.append(tid)
        seen[tid].append(s)
    out = []
    for tid in order:
        group = seen[tid]
        t0 = min(s["start"] for s in group)
        t1 = max(s["start"] + s["duration_s"] for s in group)
        out.append({"trace_id": tid, "spans": len(group), "wall_s": round(t1 - t0, 6)})
    return out
