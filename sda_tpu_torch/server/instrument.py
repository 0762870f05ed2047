"""Telemetry wrapper for store backends (copy of ``sda_tpu/server/instrument.py``).

``instrument_store(inner, store)`` returns a proxy that times every
public store method into ``sda_store_op_seconds{store,op}``, counts rows
on write ops into ``sda_store_rows_written_total{store,op}``, and records
a ``store.<op>`` span carrying the current trace id — the server-side end
of the ``X-SDA-Trace`` propagation chain. One wrapper serves all three
backends (mem/file/sqlite): instrumentation lives at the interface seam,
not in each backend, so new backends inherit it for free.

The proxy is attribute-transparent: non-callable and dunder attributes
pass through, and wrapped methods are cached on the proxy instance so
steady-state dispatch is one instance-dict hit. Exceptions count in the
latency histogram too (a failing store op is still an op) and re-raise
unchanged.
"""

from __future__ import annotations

import functools
import time

from .. import telemetry

#: ops whose first argument is a batch — rows written = len(arg)
_BATCH_OPS = frozenset({"create_participations"})

#: op-name prefixes that count as writes (rows_written series)
_WRITE_PREFIXES = (
    "create_",
    "upsert_",
    "register_",
    "enqueue_",
    "delete_",
    "snapshot_",
)


class InstrumentedStore:
    """Timing/span proxy around one store backend instance."""

    def __init__(self, inner, store: str):
        self._inner = inner
        self._store = store

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name.startswith("_") or not callable(attr):
            return attr
        wrapped = self._wrap(name, attr)
        # cache: later lookups skip __getattr__ entirely
        object.__setattr__(self, name, wrapped)
        return wrapped

    def _wrap(self, op: str, fn):
        store = self._store
        latency = telemetry.histogram(
            "sda_store_op_seconds",
            "store operation latency by backend and op",
            store=store,
            op=op,
        )
        rows = None
        if op.startswith(_WRITE_PREFIXES):
            rows = telemetry.counter(
                "sda_store_rows_written_total",
                "rows written to a store backend",
                store=store,
                op=op,
            )
        batch = op in _BATCH_OPS
        span_name = f"store.{op}"

        @functools.wraps(fn)
        def instrumented(*args, **kwargs):
            if not telemetry.enabled():
                return fn(*args, **kwargs)
            with telemetry.span(span_name, store=store):
                t0 = time.perf_counter()
                try:
                    result = fn(*args, **kwargs)
                finally:
                    latency.observe(time.perf_counter() - t0)
                if rows is not None:
                    n = len(args[0]) if batch and args else 1
                    rows.inc(n)
                return result

        return instrumented


def instrument_store(inner, store: str) -> InstrumentedStore:
    """Wrap one backend instance for the given store label (mem/file/sqlite)."""
    return InstrumentedStore(inner, store)
