"""Longitudinal telemetry: a background sampler over the registry (copy of
``sda_tpu/telemetry/timeseries.py``).

The registry answers point-in-time questions only — counters and
histograms accumulate since process start. The *time-series sampler* is a
daemon thread that scrapes the process-global registry on a fixed interval
(``SDA_TS_INTERVAL_S``, default 5s), subtracts the previous scrape to get
per-window deltas, and derives:

- per-route request throughput (``sda_http_requests_total`` deltas) and
  windowed p50/p95/p99 latency via bucket interpolation over the
  window's ``sda_http_request_seconds`` bucket deltas;
- per-(store, op) rates and windowed p99 from ``sda_store_op_seconds``;
- wire payload bytes/s in each direction (``sda_wire_bytes_total``);
- process RSS (VmRSS from ``/proc/self/status``) and the
  ``sda_pool_utilization`` gauge where a process sets it;
- window rates for a small allowlist of volume counters.

Samples land in a bounded in-memory window (``SDA_TS_WINDOW``, default
720 — one hour at the default interval) served by the unauthenticated
``GET /v1/metrics/history`` REST route, and optionally in a bounded
on-disk JSONL ring (``SDA_TS_FILE`` / ``SDA_TS_FILE_MAX_BYTES``): when the
file outgrows the bound it is atomically rewritten keeping the newest
half. Every banked window also increments ``sda_ts_samples_total``.

Lifecycle: the REST server acquires the process-wide sampler in
``serve_forever`` and releases it at shutdown (refcounted — N in-process
servers share one thread); ``SDA_TS=0`` disables the autostart.
``TimeSeriesSampler`` is also directly constructible, with an explicit
registry and manual ``sample_once()`` ticks.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

# -- knobs -------------------------------------------------------------------


def _interval_s() -> float:
    """Sampling interval (``SDA_TS_INTERVAL_S``, default 5s)."""
    try:
        return max(0.01, float(os.environ.get("SDA_TS_INTERVAL_S", "5")))
    except ValueError:
        return 5.0


def _window() -> int:
    """In-memory samples retained (``SDA_TS_WINDOW``, default 720)."""
    try:
        return max(1, int(os.environ.get("SDA_TS_WINDOW", "720")))
    except ValueError:
        return 720


def _file_max_bytes() -> int:
    """On-disk JSONL ring bound (``SDA_TS_FILE_MAX_BYTES``, default 16 MiB)."""
    try:
        return max(4096, int(os.environ.get("SDA_TS_FILE_MAX_BYTES", str(16 << 20))))
    except ValueError:
        return 16 << 20


# -- process RSS -------------------------------------------------------------


def read_rss_kib() -> int:
    """Current VmRSS in KiB from /proc/self/status (0 where unreadable)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return 0


def read_rss_mib() -> float:
    return round(read_rss_kib() / 1024.0, 2)


# -- windowed quantile math --------------------------------------------------


def histogram_quantile(q: float, buckets, counts):
    """Bucket-interpolated quantile over one window's bucket-count deltas.

    ``buckets`` are the finite upper edges; ``counts`` has one extra
    trailing entry for the +Inf bucket (the registry's layout: value v
    lands in the first bucket whose edge >= v, i.e. bucket i covers
    (edge[i-1], edge[i]]). Linear interpolation inside the containing
    bucket, Prometheus ``histogram_quantile`` style; observations in the
    +Inf bucket clamp to the top finite edge. Returns None on an empty
    window.
    """
    total = sum(counts)
    if total <= 0:
        return None
    q = min(1.0, max(0.0, q))
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c and cum + c >= target:
            if i >= len(buckets):
                return float(buckets[-1])  # +Inf bucket: clamp
            lo = 0.0 if i == 0 else float(buckets[i - 1])
            hi = float(buckets[i])
            return lo + (hi - lo) * ((target - cum) / c)
        cum += c
    return float(buckets[-1])


def _delta_counts(new: list, old) -> list:
    """Element-wise window delta, clamped at zero (a registry reset mid-
    window must yield an empty-ish window, not negative counts)."""
    if not old:
        return list(new)
    return [max(0, n - o) for n, o in zip(new, old)]


# -- the sampler -------------------------------------------------------------

#: counter families whose window *rates* ride along in every sample
#: (labels summed away)
_RATE_COUNTERS = (
    "sda_client_participations_total",
    "sda_crypto_seals_total",
    "sda_crypto_opens_total",
    "sda_store_rows_written_total",
    "sda_fault_injections_total",
    "sda_rest_retries_total",
    "sda_rest_shed_total",
    "sda_slow_requests_total",
)


class TimeSeriesSampler:
    """Scrape-and-difference sampler over one registry.

    ``start()``/``stop()`` manage the daemon thread; ``sample_once()``
    is the synchronous tick (tests and the thread both call it).
    """

    def __init__(self, registry=None, interval_s: float | None = None,
                 window: int | None = None, path: str | None = None,
                 max_bytes: int | None = None):
        if registry is None:
            from .. import telemetry

            registry = telemetry.get_registry()
        self.registry = registry
        self.interval_s = float(interval_s if interval_s is not None else _interval_s())
        self.path = path if path is not None else os.environ.get("SDA_TS_FILE")
        self.max_bytes = int(max_bytes if max_bytes is not None else _file_max_bytes())
        self._samples: deque = deque(maxlen=window if window is not None else _window())
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._file_bytes = 0
        self._samples_total = registry.counter(
            "sda_ts_samples_total",
            "time-series windows banked by the background sampler",
        )
        # baseline: deltas of the first sample are measured against the
        # state at construction, not against zero (a sampler attached to
        # a warm process must not report the whole history as one window)
        self._prev_t = time.time()
        self._prev = self._scrape()

    # -- scrape + delta ------------------------------------------------------

    def _scrape(self) -> dict:
        snap = self.registry.snapshot()
        return {
            "counters": dict(snap["counters"]),
            "gauges": dict(snap["gauges"]),
            "hists": {
                key: (hist["buckets"], list(hist["counts"]))
                for key, hist in snap["histograms"].items()
            },
        }

    @staticmethod
    def _label(labels: tuple, name: str):
        for k, v in labels:
            if k == name:
                return v
        return None

    def sample_once(self, now: float | None = None) -> dict:
        """One synchronous tick: scrape, difference against the previous
        scrape, bank the sample (memory + optional JSONL ring)."""
        now = time.time() if now is None else now
        cur = self._scrape()
        prev, prev_t = self._prev, self._prev_t
        self._prev, self._prev_t = cur, now
        dt = max(1e-9, now - prev_t)

        counter_deltas: dict = {}
        for key, value in cur["counters"].items():
            d = value - prev["counters"].get(key, 0)
            if d > 0:
                counter_deltas[key] = d

        hist_deltas: dict = {}
        for key, (buckets, counts) in cur["hists"].items():
            old = prev["hists"].get(key)
            d = _delta_counts(counts, old[1] if old else None)
            if sum(d) > 0:
                hist_deltas[key] = (buckets, d)

        # per-route throughput + windowed latency quantiles
        routes: dict = {}
        for (name, labels), d in counter_deltas.items():
            if name != "sda_http_requests_total":
                continue
            route = self._label(labels, "route")
            if route:
                entry = routes.setdefault(route, {"rps": 0.0})
                entry["rps"] = round(entry["rps"] + d / dt, 3)
        for (name, labels), (buckets, d) in hist_deltas.items():
            if name != "sda_http_request_seconds":
                continue
            route = self._label(labels, "route")
            if not route:
                continue
            entry = routes.setdefault(route, {"rps": 0.0})
            merged = entry.setdefault("_counts", [0] * len(d))
            entry.setdefault("_buckets", buckets)
            for i, c in enumerate(d):
                merged[i] += c
        for entry in routes.values():
            counts = entry.pop("_counts", None)
            buckets = entry.pop("_buckets", None)
            if counts:
                for q, field in ((0.5, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s")):
                    v = histogram_quantile(q, buckets, counts)
                    if v is not None:
                        entry[field] = round(v, 6)

        # per-(store, op) rates + windowed p99
        store_ops: dict = {}
        for (name, labels), (buckets, d) in hist_deltas.items():
            if name != "sda_store_op_seconds":
                continue
            key = f"{self._label(labels, 'store')}.{self._label(labels, 'op')}"
            n = sum(d)
            entry = {"ops_s": round(n / dt, 3)}
            p99 = histogram_quantile(0.99, buckets, d)
            if p99 is not None:
                entry["p99_s"] = round(p99, 6)
            store_ops[key] = entry

        wire = {"in": 0, "out": 0}
        for (name, labels), d in counter_deltas.items():
            if name == "sda_wire_bytes_total":
                direction = self._label(labels, "direction")
                if direction in wire:
                    wire[direction] += d

        rates: dict = {}
        for (name, labels), d in counter_deltas.items():
            if name in _RATE_COUNTERS:
                rates[name] = round(rates.get(name, 0.0) + d / dt, 3)

        # per-shard routing rates (the sharded store's request split);
        # empty on unsharded deployments, so the column only appears when
        # there are shards to observe
        shards: dict = {}
        for (name, labels), d in counter_deltas.items():
            if name != "sda_shard_requests_total":
                continue
            shard = self._label(labels, "shard")
            if shard is not None:
                shards[shard] = round(shards.get(shard, 0.0) + d / dt, 3)

        pool_util = None
        for (name, labels), value in cur["gauges"].items():
            if name == "sda_pool_utilization":
                pool_util = value

        sample = {
            "t": round(now, 3),
            "dt_s": round(dt, 3),
            "rss_mib": read_rss_mib(),
            "routes": routes,
            "store_ops": store_ops,
            "wire_bytes_per_s": {
                k: round(v / dt, 1) for k, v in wire.items()
            },
            "rates": rates,
        }
        if shards:
            sample["shards"] = shards
        if pool_util is not None:
            sample["pool_utilization"] = round(pool_util, 4)

        with self._lock:
            self._samples.append(sample)
        self._samples_total.inc()
        if self.path:
            self._append_to_ring(sample)
        return sample

    # -- on-disk JSONL ring --------------------------------------------------

    def _append_to_ring(self, sample: dict) -> None:
        line = json.dumps(sample, separators=(",", ":")) + "\n"
        try:
            if self._file_bytes == 0 and os.path.exists(self.path):
                self._file_bytes = os.path.getsize(self.path)
            with open(self.path, "a") as fh:
                fh.write(line)
            self._file_bytes += len(line)
            if self._file_bytes > self.max_bytes:
                self._truncate_ring()
        except OSError:
            pass  # a full/read-only disk must never kill the sampler

    def _truncate_ring(self) -> None:
        """Atomically rewrite the ring keeping the newest lines that fit
        in half the bound — amortized O(1) per append."""
        with open(self.path) as fh:
            lines = fh.readlines()
        keep: list = []
        budget = self.max_bytes // 2
        size = 0
        for line in reversed(lines):
            if size + len(line) > budget:
                break
            keep.append(line)
            size += len(line)
        keep.reverse()
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as fh:
            fh.writelines(keep)
        os.replace(tmp, self.path)
        self._file_bytes = size

    # -- reads ---------------------------------------------------------------

    def history(self, n: int | None = None) -> list:
        """Newest-last banked samples (the last ``n`` if given)."""
        with self._lock:
            samples = list(self._samples)
        return samples[-n:] if n else samples

    # -- thread lifecycle ----------------------------------------------------

    def start(self) -> "TimeSeriesSampler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample_once()
                except Exception:
                    pass  # a bad scrape must not kill the series

        self._thread = threading.Thread(
            target=run, name="sda-ts-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)


# -- process-wide sampler (refcounted: N in-process servers, one thread) -----

_global_lock = threading.Lock()
_global_sampler: TimeSeriesSampler | None = None
_global_refs = 0


def acquire() -> TimeSeriesSampler:
    """Start (or join) the process-wide sampler; pair with ``release()``."""
    global _global_sampler, _global_refs
    with _global_lock:
        if _global_sampler is None:
            _global_sampler = TimeSeriesSampler().start()
        _global_refs += 1
        return _global_sampler


def release() -> None:
    global _global_sampler, _global_refs
    with _global_lock:
        if _global_refs > 0:
            _global_refs -= 1
        if _global_refs == 0 and _global_sampler is not None:
            _global_sampler.stop()
            _global_sampler = None


def get() -> TimeSeriesSampler | None:
    return _global_sampler


def merge_histories(histories, bucket_s: float | None = None) -> list:
    """Merge per-process ``/v1/metrics/history`` bodies into one fleet
    series.

    A multi-process deployment (N ``sdad httpd`` frontends plus committee
    daemons) has N independent samplers, each banking its own windows on
    its own clock. This aligns them on wall-clock buckets of ``bucket_s``
    seconds (default: the largest ``interval_s`` reported, else 5s) and
    folds every bucket's samples into one:

    - additive columns are **summed** across processes: route ``rps``,
      ``rates``, ``wire_bytes_per_s``, per-shard request rates, store-op
      ``ops_s``, and ``rss_mib`` (total fleet RSS);
    - latency quantiles are **maxed** — per-process quantiles cannot be
      re-aggregated without the underlying buckets, and the conservative
      fleet p99 is the slowest process's p99;
    - ``procs`` counts the processes contributing to the bucket, so a
      gap (dead frontend, late scrape) is visible instead of silently
      deflating the fleet rate.

    Accepts either full history bodies (``{"samples": [...]}``) or bare
    sample lists. Returns merged samples sorted by bucket time.
    """
    sample_lists = []
    intervals = []
    for h in histories:
        if isinstance(h, dict):
            sample_lists.append(h.get("samples") or [])
            if h.get("interval_s"):
                intervals.append(float(h["interval_s"]))
        else:
            sample_lists.append(list(h or []))
    if bucket_s is None:
        bucket_s = max(intervals) if intervals else 5.0
    bucket_s = max(1e-3, float(bucket_s))

    _QUANTS = ("p50_s", "p95_s", "p99_s")
    buckets: dict = {}
    for samples in sample_lists:
        for s in samples:
            key = int(s["t"] // bucket_s)
            m = buckets.setdefault(
                key,
                {
                    "t": (key + 1) * bucket_s,
                    "dt_s": bucket_s,
                    "procs": 0,
                    "rss_mib": 0.0,
                    "routes": {},
                    "store_ops": {},
                    "wire_bytes_per_s": {},
                    "rates": {},
                },
            )
            m["procs"] += 1
            m["rss_mib"] = round(m["rss_mib"] + s.get("rss_mib", 0.0), 2)
            for route, entry in (s.get("routes") or {}).items():
                out = m["routes"].setdefault(route, {"rps": 0.0})
                out["rps"] = round(out["rps"] + entry.get("rps", 0.0), 3)
                for q in _QUANTS:
                    if q in entry:
                        out[q] = max(out.get(q, 0.0), entry[q])
            for op, entry in (s.get("store_ops") or {}).items():
                out = m["store_ops"].setdefault(op, {"ops_s": 0.0})
                out["ops_s"] = round(out["ops_s"] + entry.get("ops_s", 0.0), 3)
                if "p99_s" in entry:
                    out["p99_s"] = max(out.get("p99_s", 0.0), entry["p99_s"])
            for k, v in (s.get("wire_bytes_per_s") or {}).items():
                m["wire_bytes_per_s"][k] = round(
                    m["wire_bytes_per_s"].get(k, 0.0) + v, 1
                )
            for k, v in (s.get("rates") or {}).items():
                m["rates"][k] = round(m["rates"].get(k, 0.0) + v, 3)
            for k, v in (s.get("shards") or {}).items():
                m.setdefault("shards", {})
                m["shards"][k] = round(m["shards"].get(k, 0.0) + v, 3)
    return [buckets[k] for k in sorted(buckets)]


def history(n: int | None = None) -> dict:
    """The ``/v1/metrics/history`` response body: sampler state + the
    newest ``n`` samples (all retained samples when ``n`` is omitted)."""
    sampler = _global_sampler
    if sampler is None:
        return {"running": False, "interval_s": None, "samples": []}
    return {
        "running": sampler._thread is not None,
        "interval_s": sampler.interval_s,
        "samples": sampler.history(n),
    }
