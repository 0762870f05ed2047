"""Arrival-driven cohort ingest: plan, build ahead, micro-batch upload
(counterpart of ``sda_tpu/client/ingest.py``).

Building every phone's participation as a batch of one forfeits the
amortization of ``new_participations`` (one aggregation and committee
fetch, one share-matrix pass for many rows), and serializing each build
with its arrival sleep and its POST puts all three on one core. But arrival
times are a *pure function* of ``(seed, index)``
(:mod:`sda_tpu_torch.utils.arrivals`), so nothing about the trace requires
building at arrival time. This module is the pipelined discipline:

* **plan** — precompute the whole arrival schedule up front by stepping
  the trace cursor without sleeping: ``(slot, trace index, arrival
  offset, churned?)`` per phone.
* **build** — construct participations *ahead of* their arrival times
  in windows of W phones: within a window, rows are grouped by owning
  participant and each group is ONE ``new_participations`` engine call
  (one committee fetch and one share-matrix pass per group), the
  groups optionally fanned over ``SDA_WORKERS`` via the workpool.
  A per-participant resource cache skips the repeated
  aggregation/committee fetches across windows.
* **upload** — release built rows as micro-batches on the bulk batch
  route. The batch-route ACL requires every row of one POST to belong
  to the calling participant, and one participant's real rows all land
  on its single leaf aggregation — so per-participant grouping IS
  per-frontend grouping under the deterministic tier placement. A row
  is held until its arrival time has passed, within a bounded release
  tolerance (``SDA_ARRIVAL_SLACK_S``, default 0.05s: a row may leave at
  most that much early, never more). Churned phones are deferred to a
  bulk drain at the end of the round, exactly like the serial path.

Backpressure invariant: the builder blocks once ``max_backlog`` rows
are built but unreleased, so build-ahead never grows RSS with the
cohort — the in-flight window is bounded regardless of how far the
trace sleeps fall behind the build rate.

Trace-fidelity contract: release order is slot order (arrival times are
monotone in the trace index), no row is handed to the service before
``arrival_time - slack``, and churned rows upload only after every live
row — byte-identical reveals to the serial path by construction.

``SDA_INGEST_PIPELINE=0`` keeps callers on their legacy serial loop
(the A/B baseline); the knob is read by the drivers, not here.

Telemetry: ``sda_ingest_stage_seconds{stage=plan|build|upload}`` (plan:
the whole schedule; build: per window; upload: per micro-batch),
``sda_arrival_lag_seconds`` (per-row release lag behind the planned
arrival), and the ``sda_ingest_backlog`` gauge (rows built but not yet
released).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from .. import telemetry
from ..utils import workpool

_STAGE_SERIES = "sda_ingest_stage_seconds"
_STAGE_HELP = (
    "arrival-pipeline stage latency (plan: whole schedule; build: per "
    "window; upload: per micro-batch)"
)
_LAG_SERIES = "sda_arrival_lag_seconds"
_LAG_HELP = "per-row release lag behind the planned arrival time"
_BACKLOG_SERIES = "sda_ingest_backlog"
_BACKLOG_HELP = "rows built but not yet released to the service"

#: phones per builder engine call — the share-matrix amortization unit
DEFAULT_WINDOW = 64
DEFAULT_SLACK_S = 0.05


def pipeline_enabled() -> bool:
    """Whether callers should take the pipelined ingest path (default
    on; ``SDA_INGEST_PIPELINE=0`` pins the legacy serial loop as the
    A/B baseline)."""
    return os.environ.get("SDA_INGEST_PIPELINE", "1") != "0"


def arrival_slack_s() -> float:
    """Bounded release tolerance: a row may be handed to the service at
    most this many seconds before its planned arrival time."""
    raw = os.environ.get("SDA_ARRIVAL_SLACK_S")
    if raw is None or not raw.strip():
        return DEFAULT_SLACK_S
    try:
        return max(0.0, float(raw))
    except ValueError:
        raise ValueError(
            f"SDA_ARRIVAL_SLACK_S must be a number, got {raw!r}"
        ) from None


@dataclass(frozen=True)
class PlannedArrival:
    """One planned phone: its position in the cohort (``slot`` indexes
    the values/participants lists), the global trace index its draws
    came from, the arrival offset in trace time, and the churn flag."""

    slot: int
    index: int
    at: float
    churned: bool


def plan_arrivals(trace, cursor: dict, n: int) -> list:
    """Advance the shared trace cursor ``n`` arrivals WITHOUT sleeping
    and return the schedule. ``cursor`` is the drivers' persistent
    ``{"index": k, "t": last trace time, ...}`` dict — mutated exactly
    as the serial loop would, so serial and pipelined rounds interleave
    on one continuous trace."""
    out = []
    for slot in range(n):
        k = cursor["index"]
        cursor["index"] = k + 1
        cursor["t"] = trace.next_arrival(k, cursor["t"])
        out.append(
            PlannedArrival(
                slot=slot, index=k, at=cursor["t"], churned=trace.is_churned(k)
            )
        )
    return out


@dataclass
class IngestReport:
    """What one pipelined cohort did: row/churn counts, how many build
    windows and upload POSTs it took, the peak built-but-unreleased
    backlog (the backpressure bound held iff ``max_backlog_seen <=
    max_backlog``), and the worst per-row release lag."""

    rows: int = 0
    churned: int = 0
    windows: int = 0
    batches: int = 0
    deferred_batches: int = 0
    max_backlog_seen: int = 0
    max_lag_s: float = 0.0


def ingest_cohort(
    participants,
    values_list,
    aggregation_id,
    *,
    trace=None,
    cursor: Optional[dict] = None,
    window: int = DEFAULT_WINDOW,
    slack_s: Optional[float] = None,
    max_backlog: Optional[int] = None,
    route: bool = True,
) -> IngestReport:
    """Ingest a cohort through the plan/build/upload pipeline.

    ``values_list[i]`` belongs to ``participants[i % len(participants)]``
    — the flagship's identity-cycling convention; a single-participant
    cohort is the ``[participant]`` special case. With ``trace`` (an
    :class:`~sda_tpu_torch.utils.arrivals.ArrivalTrace`) and its ``cursor``
    (``{"index", "t", "t0"}``, mutated in place), rows are released on
    the arrival schedule; without a trace every row is immediately
    releasable and the pipeline degenerates to windowed batch submit.

    The builder runs on a worker thread so window k+1 seals while
    window k's rows wait out their arrival sleeps or ride the wire;
    ``max_backlog`` (default ``4 * window``) bounds how far it may run
    ahead. Build or upload failures propagate to the caller after the
    other stage is stopped; rows already uploaded stay stored and are
    idempotently replayable, exactly like ``participate_many``.
    """
    values_list = list(values_list)
    n = len(values_list)
    report = IngestReport(rows=n)
    if n == 0:
        return report
    if not participants:
        raise ValueError("ingest_cohort needs at least one participant")
    n_p = len(participants)
    if trace is not None and cursor is None:
        raise ValueError("a trace needs its cursor ({'index','t','t0'})")
    window = max(1, int(window))
    slack = arrival_slack_s() if slack_s is None else max(0.0, float(slack_s))
    bound = max(window, int(max_backlog) if max_backlog is not None else 4 * window)

    plan_hist = telemetry.histogram(_STAGE_SERIES, _STAGE_HELP, stage="plan")
    build_hist = telemetry.histogram(_STAGE_SERIES, _STAGE_HELP, stage="build")
    upload_hist = telemetry.histogram(_STAGE_SERIES, _STAGE_HELP, stage="upload")
    lag_hist = telemetry.histogram(_LAG_SERIES, _LAG_HELP)
    backlog_gauge = telemetry.gauge(_BACKLOG_SERIES, _BACKLOG_HELP)
    built_total = telemetry.counter(
        "sda_client_participations_total",
        "participations built by the batched client path",
    )

    # -- plan: the whole schedule up front, no sleeping ------------------
    t_plan = time.perf_counter()
    with telemetry.span("ingest.plan", rows=n):
        if trace is not None:
            schedule = plan_arrivals(trace, cursor, n)
            t0 = cursor["t0"]
        else:
            schedule = [PlannedArrival(s, s, 0.0, False) for s in range(n)]
            t0 = None
    plan_hist.observe(time.perf_counter() - t_plan)

    buf: deque = deque()
    cv = threading.Condition()
    state = {"done": False, "stop": False, "error": None}
    # one resource cache per participant slot: the aggregation record,
    # leaf resolution, and committee are fetched once per phone per
    # cohort instead of once per engine call
    caches: dict = {}
    trace_id = telemetry.current_trace_id()

    def _note_backlog_locked() -> None:
        backlog_gauge.set(len(buf))
        if len(buf) > report.max_backlog_seen:
            report.max_backlog_seen = len(buf)

    def _build() -> None:
        # worker threads start with a fresh contextvars context: rebind
        # the caller's trace id so build spans join the round's trace
        if trace_id:
            telemetry.set_trace_id(trace_id)
        try:
            for lo in range(0, n, window):
                entries = schedule[lo : lo + window]
                groups: dict = {}
                for e in entries:
                    groups.setdefault(e.slot % n_p, []).append(e)
                group_list = list(groups.items())

                def kernel(sub, n_threads):
                    out = []
                    for pix, es in sub:
                        p = participants[pix]
                        parts = p.new_participations(
                            [values_list[e.slot] for e in es],
                            aggregation_id,
                            route=route,
                            cache=caches.setdefault(pix, {}),
                        )
                        out.append(parts)
                    return out

                t_b = time.perf_counter()
                with telemetry.span("ingest.build", rows=len(entries)):
                    built = workpool.map_items("ingest_build", group_list, kernel)
                build_hist.observe(time.perf_counter() - t_b)
                built_total.inc(len(entries))
                report.windows += 1
                rows = [
                    (e, pix, part)
                    for (pix, es), parts in zip(group_list, built)
                    for e, part in zip(es, parts)
                ]
                rows.sort(key=lambda r: r[0].slot)
                with cv:
                    for row in rows:
                        while len(buf) >= bound and not state["stop"]:
                            cv.wait(0.5)
                        if state["stop"]:
                            return
                        buf.append(row)
                        _note_backlog_locked()
                        cv.notify_all()
        except BaseException as e:  # surfaced by the uploader
            with cv:
                state["error"] = e
                cv.notify_all()
        finally:
            with cv:
                state["done"] = True
                cv.notify_all()

    # -- upload: release at arrival time, per-participant micro-batches --
    deferred: dict = {}
    pending: list = []

    def _flush() -> None:
        if not pending:
            return
        by_phone: dict = {}
        for e, pix, part in pending:
            by_phone.setdefault(pix, []).append((e, part))
        now = time.perf_counter()
        for pix, rows in by_phone.items():
            t_u = time.perf_counter()
            with telemetry.span("ingest.upload", rows=len(rows)):
                participants[pix].upload_participations([p for _, p in rows])
            upload_hist.observe(time.perf_counter() - t_u)
            report.batches += 1
            if t0 is not None:
                for e, _ in rows:
                    lag = max(0.0, now - (t0 + e.at))
                    lag_hist.observe(lag)
                    if lag > report.max_lag_s:
                        report.max_lag_s = lag
        pending.clear()

    builder = threading.Thread(target=_build, name="sda-ingest-build")
    builder.start()
    try:
        taken = 0
        while taken < n:
            with cv:
                while not buf and state["error"] is None and not state["done"]:
                    cv.wait()
                if state["error"] is not None:
                    raise state["error"]
                if not buf:
                    raise RuntimeError(
                        "ingest builder exited before the schedule drained"
                    )
                row = buf.popleft()
                _note_backlog_locked()
                cv.notify_all()
            taken += 1
            e, pix, part = row
            if e.churned:
                deferred.setdefault(pix, []).append(part)
                report.churned += 1
                continue
            if t0 is not None:
                delay = t0 + e.at - slack - time.perf_counter()
                if delay > 0:
                    # arrivals are monotone in slot, so everything
                    # pending is already due: flush it, then sleep
                    _flush()
                    time.sleep(delay)
            pending.append(row)
            if len(pending) >= window:
                _flush()
        _flush()
        # churned phones reconnect after every live arrival: one bulk
        # POST per participant (= per frontend under tier placement)
        for pix, parts in deferred.items():
            t_u = time.perf_counter()
            with telemetry.span("ingest.upload", rows=len(parts), deferred=True):
                participants[pix].upload_participations(parts)
            upload_hist.observe(time.perf_counter() - t_u)
            report.deferred_batches += 1
    finally:
        with cv:
            state["stop"] = True
            cv.notify_all()
        builder.join()
        backlog_gauge.set(0)
    if state["error"] is not None:
        raise state["error"]
    return report
