"""What one run hands the metric readers (``metrics/<name>.py``).

A loop (``loops/<name>.py``) fills a ``Run``: one ``Unit`` per whole aggregate or round that
finished in the window, the CUDA-event and host-clock totals of named
sections (traced runs only), and the summary of the profiler's trace.
Readers return a number, or ``None`` when the run holds nothing to read.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Unit:
    """One aggregate or round of the window."""

    wall_s: float  # host clock, start to its synchronised end
    elems: int  # participants x dims aggregated and revealed
    least_s: float  # the whole step's least time at the card's peaks
    layer_least_s: dict = field(default_factory=dict)  # span name -> least time


@dataclass
class TraceSummary:
    """The profiler's trace of ``units`` (indices into ``Run.units``)."""

    window_s: float
    busy_s: float
    units: list
    span_device_s: dict  # span name -> device seconds of the ops launched inside it
    device_ops: list  # [[name, seconds]], longest first
    idle_gaps: list  # [[what the host was doing, seconds]], longest first
    unattributed_ops: int  # device ops whose launch the trace did not hold
    kernel_launches: dict = field(default_factory=dict)  # kernel -> [launches counted, device records]
    orphan_launches: int = 0  # kernel launches in the trace without a device record
    missing_records: int = 0  # device records the trace lacks; the trace's metrics are left out unless 0


@dataclass
class Run:
    setup_s: float = 0.0
    window_s: float = 0.0
    units: list = field(default_factory=list)
    events_ms: dict = field(default_factory=dict)  # section -> [ms per occurrence]
    host_s: dict = field(default_factory=dict)  # section -> [s per occurrence]
    trace: TraceSummary | None = None
