"""Phase metrics over the telemetry registry, and device profiling
(counterpart of ``sda_tpu/utils/metrics.py``).

``Metrics`` is the part of the reference's facade that the snapshot pipeline
and the clerk call:

- ``count(name)``  -> ``sda_events_total{event=name}``
- ``phase(name)``  -> ``sda_phase_seconds{phase=name}`` plus a
  ``phase.<name>`` span.

Its ``report()``/``reset()`` windows serve ``bench.py``'s protocol riders,
which are not ported. ``torch_trace`` is the counterpart of ``jax_trace``.
"""

from __future__ import annotations

import contextlib
import time

from .. import telemetry

_EVENTS = "sda_events_total"
_PHASES = "sda_phase_seconds"


class Metrics:
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


_GLOBAL = Metrics()


def get_metrics() -> Metrics:
    return _GLOBAL


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block: CPU activity, plus
    CUDA activity when a GPU is present, written on exit as a Chrome trace
    (``*.pt.trace.json``, TensorBoard's profiler format) under
    ``log_dir``. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
