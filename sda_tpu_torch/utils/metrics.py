"""Phase metrics over the telemetry registry, and device profiling
(counterpart of ``sda_tpu/utils/metrics.py``).

``Metrics`` is the part of the reference's facade that the snapshot pipeline
and the clerk call:

- ``count(name)``  -> ``sda_events_total{event=name}``
- ``phase(name)``  -> ``sda_phase_seconds{phase=name}`` plus a
  ``phase.<name>`` span.

``report()`` keeps the reference's shape (``counters`` + ``phases`` with
count/total/mean/max) and ``reset()`` its windowing by baseline subtraction:
it never wipes the process registry out from under other consumers.
``max_s`` is the max since process start, not since ``reset()`` (histogram
cells keep a running max, not a window). ``torch_trace`` is the
counterpart of ``jax_trace``.
"""

from __future__ import annotations

import contextlib
import time

from .. import telemetry

_EVENTS = "sda_events_total"
_PHASES = "sda_phase_seconds"


def _collect() -> tuple:
    """(counters by event, phases by name -> (count, total_s, max_s))
    from the current registry snapshot."""
    snap = telemetry.get_registry().snapshot()
    counters = {
        dict(labels)["event"]: value
        for (name, labels), value in snap["counters"].items()
        if name == _EVENTS
    }
    phases = {
        dict(labels)["phase"]: (hist["count"], hist["sum"], hist["max"])
        for (name, labels), hist in snap["histograms"].items()
        if name == _PHASES
    }
    return counters, phases


class Metrics:
    def __init__(self):
        # report() windows: totals at the last reset(), subtracted out
        self._base_counters: dict = {}
        self._base_phases: dict = {}

    def count(self, name: str, delta: int = 1) -> None:
        telemetry.counter(_EVENTS, "legacy Metrics.count events", event=name).inc(
            delta
        )

    @contextlib.contextmanager
    def phase(self, name: str):
        hist = telemetry.histogram(
            _PHASES, "legacy Metrics.phase timers", phase=name
        )
        t0 = time.perf_counter()
        with telemetry.span(f"phase.{name}"):
            try:
                yield
            finally:
                # observed even when the phase body raises (legacy semantics)
                hist.observe(time.perf_counter() - t0)

    def report(self) -> dict:
        counters, phases = _collect()
        out_counters = {}
        for name, value in counters.items():
            windowed = value - self._base_counters.get(name, 0)
            if windowed:
                out_counters[name] = windowed
        out_phases = {}
        for name, (count, total, mx) in phases.items():
            base_count, base_total = self._base_phases.get(name, (0, 0.0))
            c = count - base_count
            if not c:
                continue
            total = total - base_total
            out_phases[name] = {
                "count": c,
                "total_s": round(total, 6),
                "mean_s": round(total / c, 6),
                "max_s": round(mx, 6),
            }
        return {"counters": out_counters, "phases": out_phases}

    def reset(self) -> None:
        counters, phases = _collect()
        self._base_counters = counters
        self._base_phases = {
            name: (count, total) for name, (count, total, _) in phases.items()
        }


_GLOBAL = Metrics()


def get_metrics() -> Metrics:
    return _GLOBAL


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block: CPU activity, plus
    CUDA activity when a GPU is present, written on exit as a Chrome trace
    (``*.pt.trace.json``, TensorBoard's profiler format) under
    ``log_dir``, with the port's ``sda.*`` device spans and sync ranges
    (``telemetry.device_span``, ``telemetry.sync``). Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
