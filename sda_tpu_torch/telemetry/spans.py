"""Timed spans in a bounded log (the part of ``sda_tpu/telemetry/spans.py``
the engine uses; the trace-id propagation serves the REST plane and is not
ported)."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque


class SpanLog:
    """Bounded ring of finished spans plus the ``span()`` timing entry."""

    def __init__(self, registry, maxlen: int = 4096):
        self._registry = registry
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=maxlen)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a block; record ``{name, start, attrs, duration_s}``.
        Disabled telemetry yields without reading a clock or recording."""
        if not self._registry.enabled:
            yield None
            return
        record = {"name": name, "start": time.time(), "attrs": attrs or None}
        t0 = time.perf_counter()
        try:
            yield record
        finally:
            record["duration_s"] = time.perf_counter() - t0
            with self._lock:
                self._spans.append(record)

    def recent(self) -> list:
        """Finished spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
