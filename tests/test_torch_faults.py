"""The port's fault plane, backoff and hash ring (``sda_tpu_torch/utils``)
against ``sda_tpu.utils`` on the same inputs, and the port's REST client
retry loop held to the reference's contract: backoff floored by
Retry-After, transient 5xx and transport failures retried on idempotent
routes only, 4xx and non-idempotent POSTs never retried, every retry
counted, failing roots quarantined with full jitter."""

from __future__ import annotations

import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from sda_tpu.utils import faults as jfaults
from sda_tpu.utils import hashring as jhashring
from sda_tpu_torch import telemetry
from sda_tpu_torch.protocol import InvalidRequestError, SdaError
from sda_tpu_torch.rest import SdaHttpClient, TokenStore, serve_background
from sda_tpu_torch.server import new_mem_server
from sda_tpu_torch.utils import faults, hashring

SPECS = [
    "e503=0.1@0.2:42",
    "client.drop=0.05,latency=0.2@0.01,truncate=0.05:7",
    "drop=0.5",
    "drop=0.05,e503=0.05@0.01,truncate=0.05:17",
    "reset=0.3,client.reset=0.2:13",
    "drop=0.2,e503=0.3@0.1,latency=0.2:99",
    "client.drop=1.0,e503=1.0:5",
]
BAD_SPECS = ["", "drop", "frobnicate=0.1", "proxy.drop=0.1", "drop=1.5", "drop=-0.1",
             "e503=0.1@-2", "drop=0.1:not-a-seed", "drop=0.6,e503=0.6"]


def _rules(rules):
    return [(r.side, r.kind, r.rate, r.param) for r in rules]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equals_reference(spec):
    rules, seed = faults.parse_spec(spec)
    jrules, jseed = jfaults.parse_spec(spec)
    assert seed == jseed and _rules(rules) == _rules(jrules)


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_parse_spec_rejects_like_reference(bad):
    with pytest.raises(ValueError):
        jfaults.parse_spec(bad)
    with pytest.raises(ValueError):
        faults.parse_spec(bad)


@pytest.mark.parametrize("side", ["client", "server"])
@pytest.mark.parametrize("spec", SPECS)
def test_fault_draws_equal_reference(spec, side):
    """Same spec and seed: the same fault, in the same order, on each side,
    both for the pure ``decide(n)`` and the stateful ``draw()``."""
    rules, seed = faults.parse_spec(spec)
    jrules, jseed = jfaults.parse_spec(spec)
    ours, theirs = faults.FaultPlane(rules, seed, side), jfaults.FaultPlane(jrules, jseed, side)
    want = [(f.kind, f.param) if f else None for f in (theirs.draw() for _ in range(300))]
    assert [(f.kind, f.param) if f else None for f in (ours.draw() for _ in range(300))] == want
    assert [(f.kind, f.param) if f else None for f in map(ours.decide, range(300))] == want


def test_fault_planes_follow_the_environment(monkeypatch):
    monkeypatch.delenv(faults.SPEC_ENV, raising=False)
    assert faults.client_draw() is None and faults.server_draw() is None
    monkeypatch.setenv(faults.SPEC_ENV, "client.drop=1.0:0")
    assert faults.client_draw().kind == "drop"
    assert faults.server_draw() is None  # no server-side rule


@pytest.mark.parametrize("base,factor,cap", [(0.05, 2.0, 2.0), (0.001, 3.0, 0.01), (0.5, 1.5, 1.0)])
def test_backoff_equals_reference(base, factor, cap):
    ours = faults.Backoff(base=base, factor=factor, cap=cap, rng=random.Random(7))
    theirs = jfaults.Backoff(base=base, factor=factor, cap=cap, rng=random.Random(7))
    for i in range(10):
        assert ours.ceiling() == theirs.ceiling()
        floor = 0.3 if i == 4 else 0.0
        assert ours.next_delay(floor) == theirs.next_delay(floor)
    ours.reset()
    theirs.reset()
    assert ours.ceiling() == theirs.ceiling() == base


@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_hash_ring_equals_reference(shards):
    ours, theirs = hashring.HashRing(shards), jhashring.HashRing(shards)
    for key in [f"0d000000-0000-4000-8000-{i:012d}" for i in range(200)]:
        assert ours.shard_for(key) == theirs.shard_for(key)
        assert ours.preference(key) == theirs.preference(key)


# -- the client's retry loop against a scripted stub server -------------------


class _StubHandler(BaseHTTPRequestHandler):
    """Answers from a shared script of (status, headers) entries; once the
    script drains, every request succeeds with a pong body."""

    protocol_version = "HTTP/1.1"
    script: list = []
    calls: list = []
    lock = threading.Lock()

    def _serve(self):
        with self.lock:
            type(self).calls.append((self.command, self.path, time.monotonic()))
            step = self.script.pop(0) if self.script else None
        status, headers = step if step else (200, {})
        body = b'{"running": true}' if status == 200 else b"unwell"
        self.send_response(status)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._serve()

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self._serve()

    def log_message(self, *args):
        pass


@pytest.fixture
def stub_client(tmp_path):
    _StubHandler.script = []
    _StubHandler.calls = []
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _StubHandler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    client = SdaHttpClient(f"http://{host}:{port}", TokenStore(str(tmp_path)))
    try:
        yield client
    finally:
        client.close()
        httpd.shutdown()
        httpd.server_close()
        thread.join()


@pytest.fixture
def fast_retries(monkeypatch):
    monkeypatch.setenv("SDA_REST_BACKOFF_BASE_S", "0.001")
    monkeypatch.setenv("SDA_REST_BACKOFF_CAP_S", "0.005")
    telemetry.set_enabled(True)
    telemetry.reset()
    yield monkeypatch
    telemetry.reset()


def _counters(name):
    return {tuple(sorted(c["labels"].items())): c["value"]
            for c in telemetry.snapshot(include_spans=0)["counters"] if c["name"] == name}


def test_retry_on_503_honors_retry_after(stub_client, fast_retries):
    fast_retries.setenv("SDA_REST_RETRIES", "4")
    _StubHandler.script = [(503, {"Retry-After": "0.3"}), (503, {"Retry-After": "0.1"})]
    t0 = time.monotonic()
    assert stub_client.ping().running is True
    assert len(_StubHandler.calls) == 3
    assert time.monotonic() - t0 >= 0.4  # both floors honored; backoff alone caps at 5 ms
    assert _StubHandler.calls[1][2] - _StubHandler.calls[0][2] >= 0.3


def test_retry_counter_and_exhaustion(stub_client, fast_retries):
    fast_retries.setenv("SDA_REST_RETRIES", "2")
    _StubHandler.script = [(503, {})] * 10
    with pytest.raises(SdaError, match="503"):
        stub_client.ping()
    assert len(_StubHandler.calls) == 3  # the first attempt and 2 retries
    retries = _counters("sda_rest_retries_total")
    assert retries == {(("method", "GET"), ("reason", "status_503"), ("route", "/v1/ping")): 2}


def test_non_idempotent_post_never_retried(stub_client, fast_retries):
    fast_retries.setenv("SDA_REST_RETRIES", "4")
    _StubHandler.script = [(503, {})] * 5
    with pytest.raises(SdaError, match="503"):
        stub_client._request("POST", "/v1/unsafe", None, {"x": 1})
    assert len(_StubHandler.calls) == 1


def test_4xx_never_retried(stub_client, fast_retries):
    fast_retries.setenv("SDA_REST_RETRIES", "4")
    _StubHandler.script = [(400, {})] * 5
    with pytest.raises(InvalidRequestError):
        stub_client.ping()
    assert len(_StubHandler.calls) == 1


def test_keepalive_connection_is_reused(stub_client):
    for _ in range(5):
        assert stub_client.ping().running
    pool = next(iter(stub_client._pools.values()))
    assert len(pool._idle) == 1  # one connection served all five


@pytest.mark.parametrize("kind", ["truncate", "reset", "drop"])
def test_server_faults_are_retried_transport_failures(tmp_path, fast_retries, kind):
    """A body cut short (truncate), a connection aborted mid-body (reset) or
    dropped without a response surfaces as a retryable transport failure,
    never a half-decoded response; at rate 1.0 the budget exhausts into
    ``SdaError``, and with the plane lifted the same client recovers."""
    fast_retries.setenv("SDA_REST_RETRIES", "2")
    with serve_background(new_mem_server()) as url:
        client = SdaHttpClient(url, TokenStore(str(tmp_path)))
        assert client.ping().running
        fast_retries.setenv("SDA_FAULTS", f"{kind}=1.0:3")
        with pytest.raises(SdaError, match="transport failure"):
            client.ping()
        fast_retries.delenv("SDA_FAULTS")
        assert client.ping().running


def test_reset_storm_retries_through(tmp_path, fast_retries):
    fast_retries.setenv("SDA_REST_RETRIES", "8")
    with serve_background(new_mem_server()) as url:
        client = SdaHttpClient(url, TokenStore(str(tmp_path)))
        fast_retries.setenv("SDA_FAULTS", "reset=0.5,client.reset=0.2:3")
        for _ in range(5):
            assert client.ping().running
    injections = _counters("sda_fault_injections_total")
    assert injections[(("kind", "reset"), ("side", "server"))] > 0
    assert injections[(("kind", "reset"), ("side", "client"))] > 0
    assert sum(_counters("sda_rest_retries_total").values()) > 0


def test_quarantine_expiry_full_jitter(tmp_path, monkeypatch):
    monkeypatch.setenv("SDA_REST_QUARANTINE_S", "3.0")
    client = SdaHttpClient("http://127.0.0.1:9", TokenStore(str(tmp_path)))
    now = 1000.0
    draws = [client._quarantine_expiry(now) - now for _ in range(200)]
    assert all(0.0 <= d <= 3.0 for d in draws)
    assert len(set(draws)) > 190 and min(draws) < 1.0 and max(draws) > 2.0
    monkeypatch.setenv("SDA_REST_QUARANTINE_S", "0")
    assert client._quarantine_expiry(now) == now


def test_transport_failure_fails_over_and_quarantines(tmp_path, fast_retries):
    fast_retries.setenv("SDA_REST_RETRIES", "4")
    fast_retries.setenv("SDA_REST_QUARANTINE_S", "30.0")
    with serve_background(new_mem_server()) as url:
        dead = "http://127.0.0.1:9"
        client = SdaHttpClient([dead, url], TokenStore(str(tmp_path)))
        client._jitter = random.Random(7)
        t0 = time.monotonic()
        assert client.ping().running  # failed over to the survivor
        sit_out = client._quarantined[dead] - t0
        assert abs(sit_out - random.Random(7).uniform(0.0, 30.0)) < 2.0
        # the quarantined root is tried last now
        assert client._candidate_roots(None) == [url, dead]
        # keyed requests follow the reference's ring over the same roots
        key = "0d000000-0000-4000-8000-000000000004"
        assert client.route_index(key) == jhashring.HashRing(2).shard_for(key)
