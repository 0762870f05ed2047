"""Bounded-depth chunk prefetch shared by the clerk and reveal pipelines
(counterpart of ``sda_tpu/client/prefetch.py``).

``iter_chunks(fetch, total)`` yields a paged column as decrypt-ready
blocks while keeping up to ``SDA_PREFETCH_DEPTH`` (default 3) range
requests in flight. Chunk 0 is fetched synchronously to learn the
server's actual stride; later fetches are issued speculatively at
stride boundaries and consumed strictly in order. Correctness never
depends on the guess: the cursor advances by the length the server
actually returned, and if a non-final chunk comes back with a different
length (server re-configured its chunk size mid-column) every in-flight
speculative fetch is discarded and the window resynchronizes from the
actual cursor. In-flight memory is bounded to depth+1 chunks.

``fetch(start)`` must return a non-empty sized chunk or raise (both
call sites validate and time the range read inside their fetch).
Worker threads start with a fresh contextvars context, so the caller's
trace id is rebound before each speculative fetch — chunk GETs keep
carrying X-SDA-Trace. The fetches themselves are wire-format agnostic:
the REST binding negotiates ``application/x-sda-binary`` per request
underneath, and each speculative GET rides its own pooled keep-alive
connection, so depth-N prefetch means N pipelined binary chunk reads.
Only the fetches run on the worker threads: the consumer decrypts and
folds on its own thread, so a mask fold's device launch never comes from
a prefetch worker.
"""

from __future__ import annotations

import os
import threading
from collections import deque

from .. import telemetry


def depth() -> int:
    """Prefetch window: ``SDA_PREFETCH_DEPTH`` env, else 3."""
    raw = os.environ.get("SDA_PREFETCH_DEPTH")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            raise ValueError(
                f"SDA_PREFETCH_DEPTH must be an integer, got {raw!r}"
            ) from None
    return 3


def iter_chunks(fetch, total: int):
    """Yield chunks of a paged column ``[0, total)``, K-deep pipelined."""
    if total <= 0:
        return
    chunk = fetch(0)
    cursor = len(chunk)
    k = depth()
    trace_id = telemetry.current_trace_id()

    def worker(start: int, box: list) -> None:
        if trace_id:
            telemetry.set_trace_id(trace_id)
        try:
            box.append(fetch(start))
        except BaseException as exc:  # re-raised (or discarded) by the consumer
            box.append(exc)

    inflight: deque = deque()  # (start, box, thread), ascending starts
    stride = len(chunk)
    next_start = cursor

    def launch() -> None:
        nonlocal next_start
        while len(inflight) < k and next_start < total:
            box: list = []
            t = threading.Thread(target=worker, args=(next_start, box), daemon=True)
            t.start()
            inflight.append((next_start, box, t))
            next_start += stride

    launch()
    yield chunk
    while cursor < total:
        if not inflight:  # defensive: resync and refill the window
            next_start = cursor
            launch()
        start, box, t = inflight.popleft()
        t.join()
        got = box[0]
        if isinstance(got, BaseException):
            raise got
        chunk = got
        cursor = start + len(chunk)
        if len(chunk) != stride and cursor < total:
            # the server changed its chunk size mid-column: speculative
            # starts no longer line up — a stale window could skip or
            # double-count items, so drain it unread and resync
            while inflight:
                _, _, stale = inflight.popleft()
                stale.join()
            stride = len(chunk)
            next_start = cursor
        launch()
        yield chunk
