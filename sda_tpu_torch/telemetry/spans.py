"""Timed spans in a bounded log, with a propagated trace id (copy of
``sda_tpu/telemetry/spans.py``). Every finished span is also handed to the
JSON log sink (``logsink.emit``), which writes it only when a handler
listens at DEBUG.

A *trace id* is an opaque token that follows one logical operation across
layers: the REST client stamps it on every request (``X-SDA-Trace``), the
REST server adopts it for the handler, and every ``span()`` recorded below
— service, stores — carries it. Propagation rides a ``ContextVar``, so it
is correct per thread and per async task without locking.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
import threading
import time
import uuid
from collections import deque

from .device import device_span

#: the wire header carrying the trace id (client -> REST -> service -> store)
TRACE_HEADER = "X-SDA-Trace"

#: accepted wire shape for an incoming trace id — anything else is replaced
#: rather than stored or logged verbatim (header values end up in log lines)
_TRACE_RE = re.compile(r"[A-Za-z0-9_.:-]{1,64}")

_trace_var: contextvars.ContextVar = contextvars.ContextVar("sda_trace_id", default=None)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def current_trace_id():
    """The trace id bound to this context, or None."""
    return _trace_var.get()


def sanitize_trace_id(raw) -> str | None:
    """A safe trace id from an untrusted wire value, or None."""
    if not raw:
        return None
    raw = str(raw).strip()
    return raw if _TRACE_RE.fullmatch(raw) else None


@contextlib.contextmanager
def trace(trace_id: str | None = None):
    """Bind ``trace_id`` (a fresh one if None) for the dynamic extent;
    yields the bound id."""
    token = _trace_var.set(trace_id or new_trace_id())
    try:
        yield _trace_var.get()
    finally:
        _trace_var.reset(token)


def set_trace_id(trace_id: str | None):
    """Imperatively bind a trace id (REST handler threads, where the
    request lifecycle does not nest as a ``with`` block)."""
    return _trace_var.set(trace_id)


class SpanLog:
    """Bounded ring of finished spans plus the ``span()`` timing entry."""

    def __init__(self, registry, maxlen: int = 4096):
        self._registry = registry
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=maxlen)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a block; record ``{name, trace_id, start, attrs,
        duration_s}``. Disabled telemetry yields without reading a clock or
        recording. While a profiler records, the block is also the
        ``device_span`` ``sda.<name>``, whether or not telemetry is on."""
        with device_span(name):
            if not self._registry.enabled:
                yield None
                return
            record = {"name": name, "trace_id": _trace_var.get(), "start": time.time(),
                      "attrs": attrs or None}
            t0 = time.perf_counter()
            try:
                yield record
            finally:
                record["duration_s"] = time.perf_counter() - t0
                with self._lock:
                    self._spans.append(record)
                from .logsink import emit as _log_emit

                _log_emit("span", record)

    def recent(self, name: str | None = None, trace_id: str | None = None) -> list:
        """Finished spans, oldest first, optionally filtered by name prefix
        and/or exact trace id."""
        with self._lock:
            spans = list(self._spans)
        if name is not None:
            spans = [s for s in spans if s["name"].startswith(name)]
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        return spans

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
