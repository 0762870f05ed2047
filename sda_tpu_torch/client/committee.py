"""Concurrent committee runner: drain every clerk's queue in parallel
(counterpart of ``sda_tpu/client/committee.py``).

``run_committee`` runs each clerk's drain as one task on a thread pool of
one worker per clerk, so committee wall time approaches the slowest member
instead of the sum where the work releases the GIL (numpy). The reference
dispatches through its worker-pool layer, which the port does not have.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


def run_committee(clerks, max_iterations: int = -1) -> int:
    """Run ``run_chores(max_iterations)`` for every clerk concurrently.

    ``clerks`` is a sequence of clerk-capable clients; ``max_iterations``
    follows ``run_chores`` semantics (negative = drain until no work is
    left). Returns the total number of jobs processed across the committee.
    The lowest-index worker exception is re-raised after all workers finish
    (the drains are never cancelled mid-committee — a half-drained clerk
    queue would leave durable jobs in limbo).
    """
    clerks = list(clerks)
    if not clerks:
        return 0
    with ThreadPoolExecutor(max_workers=len(clerks)) as pool:
        futures = [pool.submit(c.run_chores, max_iterations) for c in clerks]
    for f in futures:
        if f.exception() is not None:
            raise f.exception()
    return sum(f.result() for f in futures)
