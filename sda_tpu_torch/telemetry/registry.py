"""Process-wide metrics registry: counters, gauges and histograms.

Copy of the part of ``sda_tpu/telemetry/registry.py`` the engine uses, with
the same series identity ``(name, sorted(label items))``, the same
``DEFAULT_BUCKETS`` and the same ``snapshot()`` layout. Writes take one lock
instead of the reference's thread-local shards: an uncontended lock costs
well under a microsecond, against milliseconds for the REST request or
store operation that records it. ``SDA_TELEMETRY=0`` at start
(or ``enabled = False``) makes every write a branch-and-return.
"""

from __future__ import annotations

import bisect
import os
import threading

#: default histogram buckets (seconds), from ~100 us to tens of seconds
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    __slots__ = ("_registry", "name", "labels", "_key")

    def __init__(self, registry: "Registry", name: str, labels: dict):
        self._registry = registry
        self.name = name
        self.labels = dict(labels)
        self._key = (name, _labels_key(labels))

    def inc(self, delta: int = 1) -> None:
        reg = self._registry
        if not reg.enabled:
            return
        with reg._lock:
            reg._counters[self._key] = reg._counters.get(self._key, 0) + delta

    def value(self) -> int:
        """Merged current value (snapshot-priced; not for hot paths)."""
        return self._registry.snapshot()["counters"].get(self._key, 0)


class Gauge:
    """Last-write-wins (merging gauges is meaningless)."""

    __slots__ = ("_registry", "name", "labels", "_key")

    def __init__(self, registry: "Registry", name: str, labels: dict):
        self._registry = registry
        self.name = name
        self.labels = dict(labels)
        self._key = (name, _labels_key(labels))

    def set(self, value: float) -> None:
        reg = self._registry
        if not reg.enabled:
            return
        with reg._lock:
            reg._gauges[self._key] = value


class Histogram:
    __slots__ = ("_registry", "name", "labels", "_key", "buckets")

    def __init__(self, registry: "Registry", name: str, labels: dict, buckets: tuple):
        self._registry = registry
        self.name = name
        self.labels = dict(labels)
        self._key = (name, _labels_key(labels))
        self.buckets = buckets

    def observe(self, value: float) -> None:
        reg = self._registry
        if not reg.enabled:
            return
        with reg._lock:
            cell = reg._hists.get(self._key)
            if cell is None:
                cell = reg._hists[self._key] = {
                    "counts": [0] * (len(self.buckets) + 1),  # +1: the +Inf bucket
                    "sum": 0.0, "count": 0, "max": 0.0,
                }
            cell["counts"][bisect.bisect_left(self.buckets, value)] += 1
            cell["sum"] += value
            cell["count"] += 1
            cell["max"] = max(cell["max"], value)


class Registry:
    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("SDA_TELEMETRY", "1") != "0"
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}
        #: name -> (kind, buckets | None, help), registered at handle creation
        self._meta: dict = {}
        self._handles: dict = {}

    def _handle(self, kind: str, cls, name: str, labels: dict, buckets=None, help=""):
        key = (kind, name, _labels_key(labels))
        with self._lock:
            handle = self._handles.get(key)
            if handle is None:
                prior = self._meta.get(name)
                if prior is not None and prior[0] != kind:
                    raise ValueError(f"metric {name} already registered as {prior[0]}")
                self._meta[name] = (kind, buckets, help or (prior[2] if prior else ""))
                args = (self, name, labels) if buckets is None else (self, name, labels, buckets)
                handle = self._handles[key] = cls(*args)
        return handle

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._handle("counter", Counter, name, labels, help=help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._handle("gauge", Gauge, name, labels, help=help)

    def histogram(
        self, name: str, help: str = "", buckets: tuple = DEFAULT_BUCKETS, **labels
    ) -> Histogram:
        return self._handle("histogram", Histogram, name, labels, buckets=tuple(buckets), help=help)

    def snapshot(self) -> dict:
        """``{"counters": {key: int}, "gauges": {key: float}, "histograms":
        {key: {buckets, counts, sum, count, max}}, "meta": {name: (kind,
        buckets, help)}}`` with
        ``key = (name, ((label, value), ...))``."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {key: dict(cell, counts=list(cell["counts"])) for key, cell in self._hists.items()}
            meta = dict(self._meta)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {
                key: {"buckets": list(meta[key[0]][1]), **cell} for key, cell in hists.items()
            },
            "meta": meta,
        }

    def reset(self) -> None:
        """Clear every series; handles and metadata survive, so held
        references stay valid."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
