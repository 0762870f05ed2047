"""Spans, CUDA events and the profiler's trace, recorded from the benchmark's
own calls into each layer of the port. All of it is off in a run with
``--trace 0``, whose end-to-end metrics are taken with nothing added.

- ``span(name)``: a ``torch.profiler.record_function`` range named
  ``sdabench.<name>`` while the profiler runs. A device op belongs to the
  innermost span that was open when the host launched it.
- ``timed(name)``: CUDA events around a section (on a CPU tensor run, the
  host clock), totalled per occurrence into ``Run.events_ms``.
- ``start()``/``stop()``: the profiler around the window's first units
  (``add_unit`` marks each); ``summary()`` reads the exported trace once
  the window has closed.

The profiler can drop a device record, and a dropped one would not show
as an op without a launch: it would shrink a span's device time, raising a
roofline share and lowering the idle share. So the trace is held against
the port's own counts of its kernels' launches over the traced units (the
loop's ``launches()``), by kernel name, and every kernel launch that the
trace records needs a device record; ``missing_records`` counts what
falls short, and the readers of the trace leave their metrics out where it
is not 0.

The trace is written under ``$TMPDIR`` and removed once read.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import tempfile
import time
from collections import defaultdict

from .record import Run, TraceSummary

PREFIX = "sdabench."
WINDOW = PREFIX + "window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
KERNEL_LAUNCH = "LaunchKernel"  # in the name of every runtime and driver call that launches a kernel
OUTSIDE = "outside_any_span"
TOP = 10
NAME_CHARS = 64


class Tracer:
    def __init__(self, enabled: bool, device):
        import torch

        self.torch = torch
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self._pending = []
        self._prof = None
        self._units: list = []
        self._dir = None  # holds the exported trace once ``stop`` has run
        self._launches = None  # the port's launch counts, read at ``start`` and ``stop``
        self._counted: dict = {}  # kernel name -> launches while the profiler ran

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is None:
            yield
            return
        with self.torch.profiler.record_function(PREFIX + name):
            yield

    @contextlib.contextmanager
    def timed(self, name: str):
        if not self.enabled:
            yield
            return
        if not self.cuda:
            t0 = time.perf_counter()
            yield
            self._pending.append((name, (time.perf_counter() - t0) * 1e3))
            return
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._pending.append((name, (start, end)))

    def collect(self, run: Run) -> None:
        """Adds the finished sections' times to ``run`` (after a sync)."""
        for name, timing in self._pending:
            ms = timing if isinstance(timing, float) else timing[0].elapsed_time(timing[1])
            run.events_ms.setdefault(name, []).append(ms)
        self._pending.clear()

    def start(self, launches=None) -> None:
        """Starts the profiler; ``launches()``, where given, returns the
        port's counts of its kernels' launches by kernel name."""
        if not self.enabled or self._prof is not None or self._dir is not None:
            return
        self._launches = (launches, launches()) if launches else None
        activities = [self.torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(self.torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._prof = self.torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self._window = self.torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def add_unit(self, unit: int) -> None:
        """Marks a unit of the window as one the profiler sees whole."""
        if self._prof is not None:
            self._units.append(unit)

    def stop(self) -> None:
        if self._prof is None:
            return
        self._sync()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if self._launches:
            read, before = self._launches
            self._counted = {name: count - before[name] for name, count in read().items()}
        self._dir = tempfile.mkdtemp(prefix="sdabench-trace-")
        self._prof.export_chrome_trace(os.path.join(self._dir, "trace.json"))
        self._prof = None

    def summary(self) -> TraceSummary | None:
        """The trace, read, and its file removed; ``None`` without one."""
        if self._dir is None:
            return None
        try:
            with open(os.path.join(self._dir, "trace.json")) as f:
                events = json.load(f)
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None
        events = events["traceEvents"] if isinstance(events, dict) else events
        return summarize(events, self._units, self._counted)


def _innermost(spans: list) -> tuple[list, list]:
    """Properly nested ``(start, end, name)`` host spans -> disjoint
    segments ``(starts, [(start, end, name)])`` naming the innermost span
    at each point."""
    segments = []
    stack: list = []
    cursor = None

    def emit(a, b, name):
        if b > a:
            segments.append((a, b, name))

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            emit(cursor, top[1], top[2])
            cursor = top[1]
        if stack:
            emit(cursor, s, stack[-1][2])
        cursor = s
        stack.append((s, e, name))
    while stack:
        top = stack.pop()
        emit(cursor, top[1], top[2])
        cursor = top[1]
    return [seg[0] for seg in segments], segments


def _at(index: tuple[list, list], t: float) -> str | None:
    starts, segments = index
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segments[i][0] <= t < segments[i][1]:
        return segments[i][2]
    return None


def summarize(events: list, units: list, counted: dict | None = None) -> TraceSummary:
    """Chrome-trace events of one profiled window -> the window's busy
    seconds, each span's device seconds, the longest device ops by name, the
    idle gaps by what the host was doing, and the device records missing
    against ``counted`` (kernel name -> launches the port counted) and
    against the trace's own kernel launches."""
    spans, launches, ops = [], {}, []
    kernel_launches = []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            if name == WINDOW:
                window = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, name[len(PREFIX):]))
        elif cat in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
                if KERNEL_LAUNCH in name:
                    kernel_launches.append(corr)
        elif cat in DEVICE_CATS:
            ops.append((ts, ts + dur, name, (ev.get("args") or {}).get("correlation")))
    if window is None:
        raise ValueError("the trace holds no window span")
    index = _innermost(spans)
    ws, we = window
    recorded = {op[3] for op in ops}
    orphans = sum(corr not in recorded for corr in kernel_launches)
    seen = {name: sum(name in op[2] for op in ops) for name in counted or {}}
    checked = {name: [count, seen[name]] for name, count in (counted or {}).items()}
    missing = orphans + sum(max(0, count - got) for count, got in checked.values())
    span_device = defaultdict(float)
    by_name = defaultdict(float)
    intervals = []
    unattributed = 0
    for s, e, name, corr in ops:
        s, e = max(s, ws), min(e, we)
        if e <= s:
            continue
        seconds = (e - s) / 1e6
        by_name[name[:NAME_CHARS]] += seconds
        intervals.append((s, e))
        launched = launches.get(corr)
        if launched is None:
            unattributed += 1
            continue
        span_device[_at(index, launched) or OUTSIDE] += seconds
    intervals.sort()
    busy = 0.0
    gaps = defaultdict(float)
    cursor = ws
    for s, e in intervals:
        if s > cursor:
            gaps[_at(index, cursor) or OUTSIDE] += (s - cursor) / 1e6
        if e > cursor:
            busy += (e - max(s, cursor)) / 1e6
            cursor = e
    if we > cursor:
        gaps[_at(index, cursor) or OUTSIDE] += (we - cursor) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return TraceSummary(window_s=(we - ws) / 1e6, busy_s=busy, units=list(units),
                        span_device_s=dict(span_device), device_ops=top(by_name),
                        idle_gaps=top(gaps), unattributed_ops=unattributed, kernel_launches=checked,
                        orphan_launches=orphans, missing_records=missing)
