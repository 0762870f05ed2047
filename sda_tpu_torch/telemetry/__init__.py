"""The measurement hooks: a process-global registry of counters and
histograms and a log of timed spans (counterpart of the part of
``sda_tpu/telemetry`` the engine and the protocol plane's roles use; the
gauges, Prometheus exposition, flight recorder, time series, log sink and
trace-id propagation serve the REST plane, the prefetch pipelines and the
tiers, none of them ported).

Start the process with ``SDA_TELEMETRY=0`` (or call ``set_enabled(False)``)
and every operation becomes a branch-and-return. ``snapshot()`` has the
reference's layout for the series kinds the port has.
"""

from __future__ import annotations

from .registry import DEFAULT_BUCKETS, Counter, Histogram, Registry
from .spans import SpanLog

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


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
    return _REGISTRY.histogram(name, help=help, buckets=buckets, **labels)


def span(name: str, **attrs):
    """Context manager: time a block and record it as a span."""
    return _SPANS.span(name, **attrs)


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
        "histograms": [
            {"name": name, "labels": dict(labels), **hist}
            for (name, labels), hist in sorted(snap["histograms"].items())
        ],
    }
    if include_spans:
        out["spans"] = _SPANS.recent()[-include_spans:]
    return out


def reset() -> None:
    """Zero every series and drop recorded spans."""
    _REGISTRY.reset()
    _SPANS.reset()


__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Histogram",
    "Registry",
    "SpanLog",
    "counter",
    "enabled",
    "get_registry",
    "histogram",
    "reset",
    "set_enabled",
    "snapshot",
    "span",
]
