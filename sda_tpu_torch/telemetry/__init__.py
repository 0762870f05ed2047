"""The measurement plane (counterpart of ``sda_tpu/telemetry``): a
process-global registry of counters, gauges and histograms, a log of timed
spans carrying a trace id propagated client -> REST (``X-SDA-Trace``) ->
service -> store, the Prometheus text exposition served at
``GET /v1/metrics``, the time-series sampler behind
``GET /v1/metrics/history``, a structured JSON log sink keyed by trace id
(``logsink``: every finished span, once ``install``ed) and the round flight
recorder (``flight``: Chrome trace export, the per-stage waterfall and the
critical path of a round's spans). ``device`` puts the port's layers into a
``torch.profiler`` trace: ``device_span`` ranges (``sda.<name>``) at the
device plane's boundaries and at its host syncs (``sync``); every ``span``
opens the same range while a profiler records.

Start the process with ``SDA_TELEMETRY=0`` (or call ``set_enabled(False)``)
and every operation becomes a branch-and-return. ``snapshot()`` has the
reference's layout.
"""

from __future__ import annotations

from .device import device_span, sync
from .prom import CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE
from .prom import render as render_prometheus
from .registry import DEFAULT_BUCKETS, Counter, Gauge, Histogram, Registry
from .spans import (
    TRACE_HEADER,
    SpanLog,
    current_trace_id,
    new_trace_id,
    sanitize_trace_id,
    set_trace_id,
    trace,
)
from .timeseries import TimeSeriesSampler, histogram_quantile, read_rss_mib

_REGISTRY = Registry()
_SPANS = SpanLog(_REGISTRY)


def get_registry() -> Registry:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY.enabled


def set_enabled(value: bool) -> None:
    _REGISTRY.enabled = bool(value)


def counter(name: str, help: str = "", **labels) -> Counter:
    return _REGISTRY.counter(name, help=help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return _REGISTRY.gauge(name, help=help, **labels)


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
    return _REGISTRY.histogram(name, help=help, buckets=buckets, **labels)


def span(name: str, **attrs):
    """Context manager: time a block and record it as a span carrying the
    current trace id; while a profiler records, also a ``device_span``."""
    return _SPANS.span(name, **attrs)


def spans(name: str | None = None, trace_id: str | None = None) -> list:
    return _SPANS.recent(name=name, trace_id=trace_id)


def snapshot(include_spans: int = 200) -> dict:
    """JSON-ready merged view: every series and the newest ``include_spans``
    span records."""
    snap = _REGISTRY.snapshot()
    out = {
        "enabled": _REGISTRY.enabled,
        "counters": [
            {"name": name, "labels": dict(labels), "value": value}
            for (name, labels), value in sorted(snap["counters"].items())
        ],
        "gauges": [
            {"name": name, "labels": dict(labels), "value": value}
            for (name, labels), value in sorted(snap["gauges"].items())
        ],
        "histograms": [
            {"name": name, "labels": dict(labels), **hist}
            for (name, labels), hist in sorted(snap["histograms"].items())
        ],
    }
    if include_spans:
        out["spans"] = _SPANS.recent()[-include_spans:]
    return out


def prometheus_text() -> str:
    return render_prometheus(_REGISTRY.snapshot())


def reset() -> None:
    """Zero every series and drop recorded spans."""
    _REGISTRY.reset()
    _SPANS.reset()


__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "PROMETHEUS_CONTENT_TYPE",
    "Registry",
    "SpanLog",
    "TRACE_HEADER",
    "TimeSeriesSampler",
    "counter",
    "current_trace_id",
    "device_span",
    "enabled",
    "gauge",
    "get_registry",
    "histogram",
    "histogram_quantile",
    "new_trace_id",
    "prometheus_text",
    "read_rss_mib",
    "render_prometheus",
    "reset",
    "sanitize_trace_id",
    "set_enabled",
    "set_trace_id",
    "snapshot",
    "span",
    "spans",
    "sync",
    "trace",
]
