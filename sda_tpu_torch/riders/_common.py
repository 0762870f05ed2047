"""What the protocol-plane riders share (counterpart of the helpers around
``bench.py``'s riders): the run's trace id, the rider metric line, artifact
banking, the stderr heartbeat, the peak-RSS sampler, registry reads, scoped
environment knobs and the small deployment every rider stands up.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import sys
import tempfile
import threading
import time

from .. import telemetry

#: one trace id for the whole bench run, stamped on every rider line and
#: bound by the bench's ``main`` so server-side spans correlate with it
RUN_TRACE_ID = telemetry.new_trace_id()

#: where the riders bank their JSON artifacts: a directory of the checkout's
#: root of its own (``bench-artifacts/`` is the earlier benchmark's folder and
#: is never written); ``set_artifacts_dir`` (the bench's ``--artifacts``) moves it
ARTIFACTS_DIR = pathlib.Path(__file__).resolve().parents[2] / "bench-artifacts-torch"


def artifacts_dir() -> pathlib.Path | None:
    """The banking directory, or None under ``SDA_BENCH_ARTIFACTS=0``."""
    if os.environ.get("SDA_BENCH_ARTIFACTS") == "0":
        return None
    return ARTIFACTS_DIR


def set_artifacts_dir(path) -> None:
    """Bank this process's artifacts in ``path`` from now on."""
    global ARTIFACTS_DIR
    ARTIFACTS_DIR = pathlib.Path(path)


def bank(files: dict) -> None:
    """Write ``{prefix: payload}`` as ``<prefix>-<stamp>.json`` each. A
    read-only checkout keeps the stdout evidence and says so on stderr."""
    here = artifacts_dir()
    if here is None:
        return
    stamp = time.strftime("%Y%m%d-%H%M%S")
    try:
        here.mkdir(parents=True, exist_ok=True)
        for prefix, payload in files.items():
            (here / f"{prefix}-{stamp}.json").write_text(
                json.dumps(payload, indent=2, default=repr))
    except OSError as exc:
        print(f"[bench] {', '.join(files)} artifact not written: {exc}", file=sys.stderr)


def emit_line(metric: str, value, unit: str, **fields) -> None:
    """One rider metric line on stdout. These are not the run's final line:
    a reader of the bench takes only the last line, so riders may narrate
    as they finish."""
    line = {"metric": metric, "value": value, "unit": unit, **fields}
    line.setdefault("trace_id", RUN_TRACE_ID)
    print(json.dumps(line), flush=True)


@contextlib.contextmanager
def stage(name: str, interval: float = 30.0):
    """A stderr breadcrumb per stage, and a tick every ``interval`` seconds
    while it runs, so a stall is attributable to a stage."""
    t0 = time.perf_counter()
    print(f"[bench] {name}...", file=sys.stderr, flush=True)
    done = threading.Event()

    def tick():
        while not done.wait(interval):
            print(f"[bench] {name} still running ({time.perf_counter() - t0:.0f}s)",
                  file=sys.stderr, flush=True)

    threading.Thread(target=tick, daemon=True).start()
    try:
        yield
    finally:
        done.set()
        print(f"[bench] {name} done in {time.perf_counter() - t0:.2f}s", file=sys.stderr, flush=True)


class RssSampler:
    """Peak VmRSS over a window, sampled by a daemon thread. The clients and
    the loopback server share this process, so the peak bounds both sides
    of a pipeline."""

    def __init__(self, interval_s: float = 0.02):
        self.interval_s = interval_s
        self.peak_kib = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def _rss_kib() -> int:
        from ..telemetry.timeseries import read_rss_kib

        return read_rss_kib()

    def __enter__(self):
        self.peak_kib = self._rss_kib()
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                self.peak_kib = max(self.peak_kib, self._rss_kib())

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        return False

    @property
    def peak_mib(self) -> float:
        return round(self.peak_kib / 1024.0, 1)


def wire_bytes_by_direction() -> dict:
    """``sda_wire_bytes_total`` summed per ``<wire>_<direction>``; a rider
    diffs two of these around a leg."""
    totals: dict = {}
    if not telemetry.enabled():
        return totals
    for c in telemetry.snapshot(include_spans=0)["counters"]:
        if c["name"] == "sda_wire_bytes_total":
            key = f'{c["labels"].get("wire")}_{c["labels"].get("direction")}'
            totals[key] = totals.get(key, 0) + c["value"]
    return totals


def gauge_value(name: str):
    for g in telemetry.snapshot(include_spans=0)["gauges"]:
        if g["name"] == name:
            return g["value"]
    return None


def hist_totals(name: str, label: str) -> dict:
    """``{label value: (sum, count)}`` of one histogram family."""
    return {h["labels"].get(label): (h["sum"], h["count"])
            for h in telemetry.snapshot(include_spans=0)["histograms"] if h["name"] == name}


@contextlib.contextmanager
def scoped_env(*keys):
    """Restore ``keys`` in ``os.environ`` to what they were, on exit."""
    saved = {k: os.environ.get(k) for k in keys}
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


class Deployment:
    """The members a rider stands up against one service: every identity in
    its own keystore under ``root``, every client on ``device``."""

    def __init__(self, root, service, device=None):
        self.root = pathlib.Path(root)
        self.service = service
        self.device = device

    def client(self, name: str, upload: bool = False):
        from ..client import SdaClient
        from ..crypto import Keystore

        ks = Keystore(str(self.root / name))
        member = SdaClient(SdaClient.new_agent(ks), ks, self.service, device=self.device)
        if upload:
            member.upload_agent()
        return member

    def keyed(self, name: str):
        """A member with its agent and one encryption key uploaded; returns
        ``(member, key id)``."""
        member = self.client(name, upload=True)
        key = member.new_encryption_key()
        member.upload_encryption_key(key)
        return member, key

    def committee(self, count: int, prefix: str = "c", staged: bool = False) -> list:
        """``count`` keyed members, each made and keyed in turn, or with
        ``staged`` every agent first and then every key (the order in which
        each rider draws its ids, as its reference counterpart does)."""
        if not staged:
            return [self.keyed(f"{prefix}{i}")[0] for i in range(count)]
        members = [self.client(f"{prefix}{i}", upload=True) for i in range(count)]
        for member in members:
            member.upload_encryption_key(member.new_encryption_key())
        return members


def aggregation(recipient, key, title: str, dim: int, modulus: int, masking, sharing, **extra):
    """An aggregation to ``recipient`` under ``key`` with sodium encryption
    on both legs, as every rider builds it."""
    from ..protocol import Aggregation, AggregationId, SodiumEncryptionScheme

    return Aggregation(
        id=extra.pop("id", None) or AggregationId.random(),
        title=title,
        vector_dimension=dim,
        modulus=modulus,
        recipient=recipient.agent.id,
        recipient_key=key,
        masking_scheme=masking,
        committee_sharing_scheme=sharing,
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme(),
        **extra,
    )


@contextlib.contextmanager
def rest_deployment(make_server, device=None):
    """A loopback REST server over ``make_server(root)`` on a daemon thread
    and a ``Deployment`` whose members reach it through ``SdaHttpClient``,
    all under one temporary directory ``root``."""
    from ..rest.client import SdaHttpClient
    from ..rest.server import serve_background
    from ..rest.tokenstore import TokenStore

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        with serve_background(make_server(root)) as url:
            yield Deployment(root, SdaHttpClient(url, TokenStore(str(root / "tokens"))), device)


def set_env(name: str, value) -> None:
    """Set an environment knob, or drop it for ``None``."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)
