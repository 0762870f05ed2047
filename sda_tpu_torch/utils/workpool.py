"""Shared worker pool for sub-range dispatch and fan-out (counterpart of
``sda_tpu/utils/workpool.py``).

Callers hand :func:`map_items` a list and a kernel that processes a
contiguous sub-range, and get back the concatenated results in input
order; :func:`scatter` runs independent whole tasks (per-node tier closes,
per-clerk committee drains) through a bounded pool. A thread pool buys
parallelism where the work releases the GIL: numpy's bulk loops, socket
I/O and the device's kernels. The port's sealed boxes are Python
(``crypto/sodium.py``), so they overlap with I/O rather than with each
other.

Sizing: ``SDA_WORKERS`` in the environment, else ``os.cpu_count()``.
``SDA_WORKERS=1`` (or a single-item batch) bypasses the pool entirely —
the kernel is invoked once on the whole list with ``n_threads=None``,
the serial call, bit for bit.

Determinism: sub-ranges are contiguous and results are gathered in
submission order, so output item *i* always corresponds to input item
*i* exactly as in the serial path. Deterministic kernels are therefore
byte-identical at any worker count; randomized kernels (sealing draws an
ephemeral keypair per box) differ only by that randomness and open to
identical plaintexts.

Oversubscription: when this pool is active each sub-range kernel
receives ``n_threads=1``, so a kernel that would spawn threads of its own
keeps the total at the pool size; the serial path passes ``None``.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, TypeVar

from .. import telemetry

T = TypeVar("T")
R = TypeVar("R")

_WORKERS_HELP = "configured crypto worker-pool size"
_TASK_HELP = "per-sub-range pool task latency, by operation"
_UTIL_HELP = "busy-time fraction of the last pooled dispatch (sum(task)/(wall*workers))"


def workers() -> int:
    """Configured pool size: ``SDA_WORKERS`` env, else ``os.cpu_count()``."""
    raw = os.environ.get("SDA_WORKERS")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            raise ValueError(f"SDA_WORKERS must be an integer, got {raw!r}") from None
    return os.cpu_count() or 1


_pool: ThreadPoolExecutor | None = None
_pool_size = 0
_pool_lock = threading.Lock()


def _executor(size: int) -> ThreadPoolExecutor:
    """The shared executor, rebuilt if the configured size changed
    (a caller may flip ``SDA_WORKERS`` between runs)."""
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None or _pool_size != size:
            if _pool is not None:
                _pool.shutdown(wait=False)
            _pool = ThreadPoolExecutor(max_workers=size, thread_name_prefix="sda-pool")
            _pool_size = size
        return _pool


def split_ranges(n: int, parts: int) -> List[tuple]:
    """Balanced contiguous ``[start, end)`` bounds covering ``range(n)``."""
    parts = max(1, min(parts, n))
    base, extra = divmod(n, parts)
    bounds, start = [], 0
    for i in range(parts):
        end = start + base + (1 if i < extra else 0)
        bounds.append((start, end))
        start = end
    return bounds


def map_items(
    op: str,
    items: Sequence[T],
    kernel: Callable[[Sequence[T], "int | None"], List[R]],
) -> List[R]:
    """Run ``kernel(sub_range, n_threads)`` over ``items``, pooled.

    ``kernel`` must map a contiguous sub-list to a result list of the
    same length. With one worker (or one item) it is called exactly once
    as ``kernel(items, None)`` — the unchanged serial path. Otherwise the
    list is split into at most ``workers()`` contiguous sub-ranges, each
    dispatched to the shared pool with ``n_threads=1``, and the result
    lists are concatenated in input order. The first failing sub-range's
    exception propagates.

    ``op`` is a small fixed label ("seal"/"open"/"share_matrix") for the
    ``sda_pool_task_seconds`` series — never unbounded values.
    """
    n = workers()
    telemetry.gauge("sda_pool_workers", _WORKERS_HELP).set(n)
    if n <= 1 or len(items) <= 1:
        return kernel(items, None)

    bounds = split_ranges(len(items), n)
    task_hist = telemetry.histogram("sda_pool_task_seconds", _TASK_HELP, op=op)
    busy = [0.0] * len(bounds)

    def run(ix: int, lo: int, hi: int) -> List[R]:
        t0 = time.perf_counter()
        try:
            return kernel(items[lo:hi], 1)
        finally:
            busy[ix] = time.perf_counter() - t0
            task_hist.observe(busy[ix])

    wall0 = time.perf_counter()
    pool = _executor(n)
    futures = [pool.submit(run, ix, lo, hi) for ix, (lo, hi) in enumerate(bounds)]
    out: List[R] = []
    for f in futures:  # submission order: deterministic in-order reassembly
        out.extend(f.result())
    wall = time.perf_counter() - wall0
    if wall > 0:
        telemetry.gauge("sda_pool_utilization", _UTIL_HELP).set(
            min(1.0, sum(busy) / (wall * n))
        )
    return out


@dataclass
class TaskOutcome:
    """One :func:`scatter` task's result: exactly one of ``value`` /
    ``error`` is meaningful unless the task was ``cancelled`` before it
    ran (then both stay None). ``seconds`` is the task's busy time — the
    per-lane numerator of the dispatch's overlap efficiency."""

    value: object = None
    error: Optional[BaseException] = None
    seconds: float = 0.0
    cancelled: bool = False


def scatter(
    op: str,
    tasks: Sequence[Callable[[], object]],
    width: int,
    *,
    cancel_on_error: bool = False,
) -> List[TaskOutcome]:
    """Run independent zero-arg ``tasks`` through a bounded pool of
    ``width`` threads; returns one :class:`TaskOutcome` per task, in
    task order regardless of completion order.

    Unlike :func:`map_items` (contiguous sub-ranges of one kernel), this
    is whole-task dispatch for heterogeneous work — per-node tier closes,
    per-clerk committee drains — where each task blocks on its own I/O.
    The caller's trace id is rebound into every worker, so all tasks'
    spans join the dispatching round's trace.

    ``cancel_on_error=True`` makes the first failing task cancel every
    sibling that has not started yet (queued futures are cancelled AND
    workers re-check before running); already-running siblings finish.
    Failures never raise here — the caller inspects the outcomes so it
    can keep strict re-raise / non-strict skip semantics deterministic.

    A dedicated short-lived executor is used instead of the shared
    crypto pool above: tasks routinely call back into :func:`map_items`,
    and queueing them on the pool their own sub-ranges need is a
    textbook nested-dispatch deadlock.

    ``width <= 1`` (or a single task) runs everything inline on the
    caller's thread in order — the serial path, bit for bit.
    """
    tasks = list(tasks)
    outcomes = [TaskOutcome() for _ in tasks]
    if not tasks:
        return outcomes
    width = max(1, min(width, len(tasks)))
    task_hist = telemetry.histogram("sda_pool_task_seconds", _TASK_HELP, op=op)
    stop = threading.Event()
    trace_id = telemetry.current_trace_id()

    def run(ix: int, task: Callable[[], object]) -> None:
        if cancel_on_error and stop.is_set():
            outcomes[ix].cancelled = True
            return
        if trace_id:
            telemetry.set_trace_id(trace_id)
        t0 = time.perf_counter()
        try:
            outcomes[ix].value = task()
        except BaseException as exc:  # noqa: BLE001 — surfaced via outcome
            outcomes[ix].error = exc
            if cancel_on_error:
                stop.set()
        finally:
            outcomes[ix].seconds = time.perf_counter() - t0
            task_hist.observe(outcomes[ix].seconds)

    if width <= 1 or len(tasks) <= 1:
        for ix, task in enumerate(tasks):
            run(ix, task)
            if cancel_on_error and stop.is_set():
                for rest in outcomes[ix + 1:]:
                    rest.cancelled = True
                break
        return outcomes

    wall0 = time.perf_counter()
    with ThreadPoolExecutor(
        max_workers=width, thread_name_prefix="sda-fanout"
    ) as pool:
        futures = [pool.submit(run, ix, t) for ix, t in enumerate(tasks)]
        for ix, f in enumerate(futures):
            try:
                f.result()
            except Exception:
                # a future cancelled before its worker started
                pass
            if cancel_on_error and stop.is_set():
                for rest in futures[ix + 1:]:
                    rest.cancel()
        for ix, f in enumerate(futures):
            if f.cancelled():
                outcomes[ix].cancelled = True
    wall = time.perf_counter() - wall0
    if wall > 0:
        telemetry.gauge("sda_pool_utilization", _UTIL_HELP).set(
            min(1.0, sum(o.seconds for o in outcomes) / (wall * width))
        )
    return outcomes
