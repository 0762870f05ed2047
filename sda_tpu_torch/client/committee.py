"""Concurrent committee runner: drain every clerk's queue in parallel
(counterpart of ``sda_tpu/client/committee.py``).

``run_committee`` dispatches each clerk's drain as one task through
``workpool.scatter`` (one worker per clerk), so committee wall time
approaches the slowest member instead of the sum where the work releases
the GIL (numpy, socket I/O). The scatter layer rebinds the caller's trace
id, so every clerk's job processing joins the same trace. Per-clerk work
stays independent (distinct keys, distinct jobs, distinct HTTP
connections), so no state is shared between the threads.
"""

from __future__ import annotations

import functools

from ..utils import workpool


def run_committee(clerks, max_iterations: int = -1) -> int:
    """Run every clerk's queue drain concurrently.

    ``clerks`` is a sequence of clerk-capable clients (anything with
    ``clerk_once``); ``max_iterations`` follows ``run_chores`` semantics
    (negative = drain until no work is left). Returns the total number of
    jobs processed across the committee. The lowest-index worker exception
    is re-raised after all workers finish (the drains are never cancelled
    mid-committee — a half-drained clerk queue would leave durable jobs in
    limbo).
    """
    clerks = list(clerks)
    if not clerks:
        return 0

    def drain(clerk) -> int:
        n = 0
        if max_iterations < 0:
            while clerk.clerk_once():
                n += 1
        else:
            for _ in range(max_iterations):
                if not clerk.clerk_once():
                    break
                n += 1
        return n

    outcomes = workpool.scatter(
        "committee",
        [functools.partial(drain, c) for c in clerks],
        len(clerks),
    )
    for out in outcomes:
        if out.error is not None:
            raise out.error
    return sum(out.value for out in outcomes)
