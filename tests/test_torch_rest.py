"""The port's REST binding (``sda_tpu_torch/rest``) against ``sda_tpu/rest``.

A ChaCha-masked packed-Shamir round (dim 1,000, 5 participants, one
committee clerk dropped) over loopback HTTP in all four pairings of the
port's and the reference's client and server, on the binary wire, the JSON
wire and the paged chunk routes; every reveal equals numpy's sum mod p.
Then the reference's ``test_rest.py`` cases on the port's server and
client (route table, auth and error mapping, malformed bodies as 400s,
keep-alive shutdown and reaping, trace ids, health, metrics, history, slow
requests), the tier routes answering as the reference's do, and a round under injected faults
that still reveals exactly. Servers run on ``serve_background`` threads.
"""

from __future__ import annotations

import base64
import json
import logging
import socket
import threading
import time
import uuid
from urllib.parse import urlparse

import numpy as np
import pytest
import requests

import sda_tpu.protocol as jp
import sda_tpu.rest as jrest
import sda_tpu_torch.protocol as tp
import sda_tpu_torch.rest as trest
from sda_tpu.client import SdaClient as JClient
from sda_tpu.crypto import Keystore as JKeystore
from sda_tpu.server import new_mem_server as j_server
from sda_tpu_torch import telemetry
from sda_tpu_torch.client import SdaClient as TClient
from sda_tpu_torch.crypto import Keystore as TKeystore
from sda_tpu_torch.protocol import (
    AgentId,
    InvalidCredentialsError,
    PermissionDeniedError,
    SdaError,
)
from sda_tpu_torch.rest import SdaHttpClient, TokenStore, serve_background
from sda_tpu_torch.rest.client import _is_dropped
from sda_tpu_torch.rest.server import listen
from sda_tpu_torch.server import new_mem_server

P, DIM, PARTICIPANTS, CLERKS, DROP = 433, 1_000, 5, 8, 2
PORT = {"proto": tp, "client": TClient, "keystore": TKeystore, "rest": trest,
        "server": new_mem_server}
REFERENCE = {"proto": jp, "client": JClient, "keystore": JKeystore, "rest": jrest,
             "server": j_server}
PACKAGES = {"port": PORT, "reference": REFERENCE}


def _member(pkg, root, url):
    keystore = pkg["keystore"](root)
    agent = pkg["client"].new_agent(keystore)
    service = pkg["rest"].SdaHttpClient(url, pkg["rest"].TokenStore(root))
    if pkg is PORT:
        return TClient(agent, keystore, service, device="cpu")
    return JClient(agent, keystore, service)


def _inputs():
    return np.random.default_rng(12).integers(0, P, size=(PARTICIPANTS, DIM))


def http_round(root, client_pkg, url, values=None, participants_pkg=None):
    """One ChaCha-masked packed-Shamir round through ``client_pkg``'s
    ``SdaClient``s (the participants' through ``participants_pkg``'s when
    given), each on its own ``SdaHttpClient`` to ``url``, with the
    committee clerk at position ``DROP`` never running its chores."""
    proto = client_pkg["proto"]
    participants_pkg = participants_pkg or client_pkg
    recipient = _member(client_pkg, root / "recipient", url)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    clerks = [_member(client_pkg, root / f"clerk{i}", url) for i in range(CLERKS)]
    for clerk in clerks:
        key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(key)
    agg = proto.Aggregation(
        id=proto.AggregationId.random(), title="rest round", vector_dimension=DIM, modulus=P,
        recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=proto.ChaChaMasking(modulus=P, dimension=DIM, seed_bitsize=128),
        committee_sharing_scheme=proto.PackedShamirSharing(3, 8, 4, P, 354, 150),
        recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
        committee_encryption_scheme=proto.SodiumEncryptionScheme())
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)
    values = _inputs() if values is None else values
    for i, row in enumerate(values):
        part = _member(participants_pkg, root / f"participant{i}", url)
        part.upload_agent()
        part.participate([int(v) for v in row],
                         participants_pkg["proto"].AggregationId(str(agg.id)))
    recipient.end_aggregation(agg.id)
    committee = recipient.service.get_committee(recipient.agent, agg.id)
    dropped = committee.clerks_and_keys[DROP][0]
    for clerk in clerks:
        if clerk.agent.id != dropped:
            clerk.run_chores(-1)
    return recipient.reveal_aggregation(agg.id).positive().values


WIRES = {
    "binary": {},
    "json": {"SDA_WIRE": "json"},
    "paged": {"SDA_JOB_PAGE_THRESHOLD": "2", "SDA_JOB_CHUNK_SIZE": "2",
              "SDA_RESULT_PAGE_THRESHOLD": "2", "SDA_RESULT_CHUNK_SIZE": "3"},
}


@pytest.mark.parametrize("wire_mode", sorted(WIRES))
@pytest.mark.parametrize("client,server", [("port", "port"), ("port", "reference"),
                                           ("reference", "port"), ("reference", "reference")])
def test_round_in_every_pairing(tmp_path, monkeypatch, client, server, wire_mode):
    for key, value in WIRES[wire_mode].items():
        monkeypatch.setenv(key, value)
    service = PACKAGES[server]["server"]()
    with PACKAGES[server]["rest"].serve_background(service) as url:
        out = http_round(tmp_path, PACKAGES[client], url)
    np.testing.assert_array_equal(out, _inputs().sum(axis=0) % P)


def _crypto_counts() -> dict:
    return {(c["name"], c["labels"].get("path")): c["value"]
            for c in telemetry.snapshot(include_spans=0)["counters"]
            if c["name"].startswith("sda_crypto_")}


@pytest.mark.parametrize("layout", ["port participants, reference committee",
                                    "reference participants, port committee"])
def test_mixed_round_over_http_rides_the_native_layer(tmp_path, layout):
    """Port participants with a reference clerk committee and recipient,
    and the reverse, over HTTP to the port's server: the reveal is exact
    and every seal, open and mask expansion of the port's half is counted
    on the native layer's C paths."""
    port_participates = layout.startswith("port")
    members, participants = (REFERENCE, PORT) if port_participates else (PORT, REFERENCE)
    before = _crypto_counts()
    with serve_background(new_mem_server()) as url:
        out = http_round(tmp_path, members, url, participants_pkg=participants)
    np.testing.assert_array_equal(out, _inputs().sum(axis=0) % P)
    after = _crypto_counts()
    grew = {key: after[key] - before.get(key, 0) for key in after
            if after[key] != before.get(key, 0)}
    assert {path for _, path in grew} <= {"comb", "batch", "native"}
    if port_participates:
        assert grew[("sda_crypto_seals_total", "comb")] == PARTICIPANTS * CLERKS
        assert grew[("sda_crypto_seals_total", "batch")] == PARTICIPANTS
        assert grew[("sda_crypto_chacha_expands_total", "native")] >= PARTICIPANTS
        assert ("sda_crypto_opens_total", "batch") not in grew
    else:
        # the CLERKS - 1 working clerks open every share and seal a result
        assert grew[("sda_crypto_opens_total", "batch")] >= (CLERKS - 1) * PARTICIPANTS
        assert grew[("sda_crypto_seals_total", "batch")] == CLERKS - 1
        assert grew[("sda_crypto_chacha_expands_total", "native")] >= PARTICIPANTS
        assert ("sda_crypto_seals_total", "comb") not in grew


def test_faulted_round_reveals_exactly(tmp_path, monkeypatch):
    """Under ``drop=0.05,e503=0.05@0.01,truncate=0.05:17`` on the server and
    client drops, every call retries through and the reveal is exact; the
    injection and retry counters show the storm was real."""
    monkeypatch.setenv("SDA_REST_RETRIES", "8")
    monkeypatch.setenv("SDA_REST_BACKOFF_BASE_S", "0.001")
    monkeypatch.setenv("SDA_REST_BACKOFF_CAP_S", "0.05")
    telemetry.set_enabled(True)
    telemetry.reset()
    with serve_background(new_mem_server()) as url:
        monkeypatch.setenv("SDA_FAULTS", "drop=0.05,e503=0.05@0.01,truncate=0.05,client.drop=0.05:17")
        out = http_round(tmp_path, PORT, url)
        monkeypatch.delenv("SDA_FAULTS")
    np.testing.assert_array_equal(out, _inputs().sum(axis=0) % P)
    counters = telemetry.snapshot(include_spans=0)["counters"]
    kinds = {c["labels"]["kind"] for c in counters if c["name"] == "sda_fault_injections_total"}
    assert {"drop", "e503", "truncate"} <= kinds
    assert sum(c["value"] for c in counters if c["name"] == "sda_rest_retries_total") > 0
    telemetry.reset()


# -- the reference's test_rest.py cases on the port ----------------------------


@pytest.fixture()
def http_ctx(tmp_path):
    server = new_mem_server()
    with serve_background(server) as base_url:
        yield server, base_url, tmp_path


def _client(root, url):
    return _member(PORT, root, url)


def test_ping_unauthenticated(http_ctx):
    _, base_url, tmp_path = http_ctx
    assert SdaHttpClient(base_url, TokenStore(tmp_path)).ping().running


def test_full_loop_and_listing(http_ctx):
    _, base_url, tmp_path = http_ctx
    recipient = _client(tmp_path / "recipient", base_url)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    agg = tp.Aggregation(
        id=tp.AggregationId.random(), title="http-loop", vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=rkey, masking_scheme=tp.NoMasking(),
        committee_sharing_scheme=tp.AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=tp.SodiumEncryptionScheme(),
        committee_encryption_scheme=tp.SodiumEncryptionScheme())
    recipient.upload_aggregation(agg)
    clerks = [_client(tmp_path / f"clerk{i}", base_url) for i in range(3)]
    for clerk in clerks:
        key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(key)
    recipient.begin_aggregation(agg.id)
    for i in range(2):
        part = _client(tmp_path / f"part{i}", base_url)
        part.upload_agent()
        part.participate([1, 2, 3, 4], agg.id)
    recipient.end_aggregation(agg.id)
    for c in [recipient] + clerks:
        c.run_chores(-1)
    np.testing.assert_array_equal(recipient.reveal_aggregation(agg.id).positive().values, [2, 4, 6, 8])
    assert recipient.service.list_aggregations(recipient.agent, "http-") == [agg.id]
    assert recipient.service.list_aggregations(recipient.agent, "nope") == []
    assert recipient.service.list_aggregations(recipient.agent, None, recipient.agent.id) == [agg.id]
    assert recipient.service.get_agent(recipient.agent, recipient.agent.id) == recipient.agent


def test_auth_and_error_mapping(http_ctx):
    _, base_url, tmp_path = http_ctx
    alice = _client(tmp_path / "alice", base_url)
    alice.upload_agent()
    # a second client claiming the same agent id with a fresh token
    impostor = SdaHttpClient(base_url, TokenStore(tmp_path / "b"))
    with pytest.raises(InvalidCredentialsError):
        impostor.get_agent(alice.agent, alice.agent.id)
    with pytest.raises(InvalidCredentialsError):  # trust on first use: no re-registration
        impostor.create_agent(alice.agent, alice.agent)
    assert requests.get(f"{base_url}/v1/agents/{alice.agent.id}").status_code == 401
    assert alice.service.get_agent(alice.agent, AgentId.random()) is None
    resp = requests.get(f"{base_url}/v1/nope", auth=(str(alice.agent.id), "x"))
    assert resp.status_code == 404 and "Resource-not-found" not in resp.headers
    bob = _client(tmp_path / "bob", base_url)
    bob.upload_agent()
    with pytest.raises(PermissionDeniedError):  # a profile for somebody else: 403
        bob.service.upsert_profile(bob.agent, tp.Profile(owner=alice.agent.id, name="x"))


def test_malformed_requests_are_400s_not_500s(http_ctx):
    _, base_url, tmp_path = http_ctx
    alice = _client(tmp_path / "alice", base_url)
    alice.upload_agent()
    auth = (str(alice.agent.id), TokenStore(tmp_path / "alice").get())
    url = f"{base_url}/v1/agents/me/keys"
    r = requests.post(url, data=b"{not json", auth=auth, headers={"Content-Type": "application/json"})
    assert r.status_code == 400 and "malformed JSON" in r.text
    r = requests.post(url, json={"zzz": 1}, auth=auth)
    assert r.status_code == 400 and "malformed body" in r.text
    assert requests.post(url, data=b"", auth=auth).status_code == 400
    r = requests.post(f"{base_url}/v1/aggregations/participations/batch", data=b"SDAW\x01\x02\x05",
                      auth=auth, headers={"Content-Type": "application/x-sda-binary"})
    assert r.status_code == 400 and "malformed binary body" in r.text
    parsed = urlparse(base_url)
    cred = base64.b64encode(f"{auth[0]}:{auth[1]}".encode()).decode()
    with socket.create_connection((parsed.hostname, parsed.port), timeout=10) as s:
        s.sendall(b"POST /v1/agents/me/keys HTTP/1.1\r\n" + f"Host: {parsed.hostname}\r\n".encode()
                  + f"Authorization: Basic {cred}\r\n".encode() + b"Content-Length: zzz\r\n\r\n")
        assert b"400" in s.makefile("rb").readline()
    r = requests.post(url, data=b"", auth=auth, headers={"Content-Length": str(1 << 40)})
    assert r.status_code == 400 and "limit" in r.text
    for header in ("Basic !!notb64!!", "Bearer abc"):
        r = requests.get(f"{base_url}/v1/agents/{alice.agent.id}", headers={"Authorization": header})
        assert r.status_code == 401


def test_clerking_result_route_job_must_match_body(http_ctx):
    _, base_url, tmp_path = http_ctx
    recipient = _client(tmp_path / "recipient", base_url)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    agg = tp.Aggregation(
        id=tp.AggregationId.random(), title="route-body-mismatch", vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=rkey, masking_scheme=tp.NoMasking(),
        committee_sharing_scheme=tp.AdditiveSharing(share_count=2, modulus=433),
        recipient_encryption_scheme=tp.SodiumEncryptionScheme(),
        committee_encryption_scheme=tp.SodiumEncryptionScheme())
    recipient.upload_aggregation(agg)
    clerks = [_client(tmp_path / f"clerk{i}", base_url) for i in range(2)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())
    recipient.begin_aggregation(agg.id)
    part = _client(tmp_path / "part", base_url)
    part.upload_agent()
    part.participate([1, 2, 3, 4], agg.id)
    recipient.end_aggregation(agg.id)
    jobs = [c.service.get_clerking_job(c.agent, c.agent.id) for c in clerks]
    results = [c.process_clerking_job(j) for c, j in zip(clerks, jobs)]
    auths = [(str(c.agent.id), TokenStore(tmp_path / f"clerk{i}").get()) for i, c in enumerate(clerks)]
    body = json.dumps(results[0].to_json())
    post = lambda job, auth: requests.post(  # noqa: E731
        f"{base_url}/v1/aggregations/implied/jobs/{job}/result", data=body, auth=auth,
        headers={"Content-Type": "application/json"})
    r = post(jobs[1].id, auths[0])
    assert r.status_code == 400 and str(jobs[1].id) in r.text
    assert post(tp.AggregationId.random(), auths[0]).status_code == 400
    assert post(jobs[0].id, auths[1]).status_code == 403
    assert post(jobs[0].id, auths[0]).status_code == 201
    clerks[1].service.create_clerking_result(clerks[1].agent, results[1])
    recipient.run_chores(-1)
    np.testing.assert_array_equal(recipient.reveal_aggregation(agg.id).positive().values, [1, 2, 3, 4])


REFERENCE_ROUTES = [
    ("GET", "/v1/ping"), ("GET", "/v1/agents/{u}"), ("POST", "/v1/agents/me"),
    ("GET", "/v1/agents/{u}/profile"), ("POST", "/v1/agents/me/profile"),
    ("GET", "/v1/agents/any/keys/{u}"), ("POST", "/v1/agents/me/keys"),
    ("POST", "/v1/aggregations"), ("GET", "/v1/aggregations"), ("GET", "/v1/aggregations/{u}"),
    ("DELETE", "/v1/aggregations/{u}"), ("GET", "/v1/aggregations/{u}/committee/suggestions"),
    ("POST", "/v1/aggregations/implied/committee"), ("GET", "/v1/aggregations/{u}/committee"),
    ("POST", "/v1/aggregations/participations"), ("GET", "/v1/aggregations/{u}/status"),
    ("POST", "/v1/aggregations/implied/snapshot"), ("GET", "/v1/aggregations/any/jobs"),
    ("POST", "/v1/aggregations/implied/jobs/{u}/result"),
    ("GET", "/v1/aggregations/{u}/snapshots/{u}/result"),
]
ADDITIVE_ROUTES = [
    ("POST", "/v1/aggregations/participations/batch"),
    ("GET", "/v1/aggregations/implied/jobs/{u}/chunks/0"),
    ("GET", "/v1/aggregations/{u}/snapshots/{u}/result/masks/0"),
    ("GET", "/v1/aggregations/{u}/snapshots/{u}/result/clerks/0"),
    ("GET", "/v1/metrics"), ("GET", "/v1/metrics.json"), ("GET", "/v1/metrics/history"),
    ("GET", "/v1/healthz"), ("GET", "/v1/readyz"),
    ("GET", "/v1/aggregations/{u}/tiers"), ("POST", "/v1/aggregations/implied/jobs/{u}/complete"),
]


def test_route_table_served_like_reference(http_ctx):
    """Every route of the SDA server and of ``sda_tpu``'s additions is
    routed (no plain 404), and answers with the reference server's status."""
    _, base_url, tmp_path = http_ctx
    alice = _client(tmp_path / "alice", base_url)
    alice.upload_agent()
    ref_service = j_server()
    with jrest.serve_background(ref_service) as ref_url:
        jalice = _member(REFERENCE, tmp_path / "jalice", ref_url)
        jalice.upload_agent()
        for method, template in REFERENCE_ROUTES + ADDITIVE_ROUTES:
            path = template
            while "{u}" in path:
                path = path.replace("{u}", str(uuid.uuid4()), 1)
            ours = requests.request(method, f"{base_url}{path}", json={}, timeout=30,
                                    auth=(str(alice.agent.id), TokenStore(tmp_path / "alice").get()))
            theirs = requests.request(method, f"{ref_url}{path}", json={}, timeout=30,
                                      auth=(str(jalice.agent.id), jrest.TokenStore(tmp_path / "jalice").get()))
            assert not (ours.status_code == 404 and "Resource-not-found" not in ours.headers), template
            assert ours.status_code == theirs.status_code, (method, template, ours.text)


def _outcome(call):
    """What a service call gave: its wire JSON, or its error's class and text."""
    try:
        out = call()
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("error", type(e).__name__, str(e))
    return ("ok", None if out is None else json.dumps(out.to_json(), sort_keys=True))


def test_tier_routes_refused_with_the_roadmap_item(http_ctx):
    """Both tier routes answer as ``sda_tpu``'s do, over HTTP and in
    process: a tiered root's status is byte-equal wire JSON, a flat
    aggregation has none, an unknown job cannot be completed, and a
    stranger may not read the tree."""
    _, base_url, tmp_path = http_ctx
    root_id, job_id = "0e5d7c1a-8b7f-4c1e-9a55-3f2b1d6c4e70", "7d0a4c2e-1f3b-4a5d-8e6f-9c8b7a6d5e4f"
    outcomes = []
    with jrest.serve_background(j_server()) as ref_url:
        for name, pkg, url in (("port", PORT, base_url), ("reference", REFERENCE, ref_url)):
            proto = pkg["proto"]
            alice = _member(pkg, tmp_path / f"alice-{name}", url)
            alice.upload_agent()
            key = alice.new_encryption_key()
            alice.upload_encryption_key(key)
            stranger = _member(pkg, tmp_path / f"bob-{name}", url)
            stranger.upload_agent()

            def aggregation(agg_id, **tier):
                return proto.Aggregation(
                    id=proto.AggregationId(agg_id), title="tiers", vector_dimension=4,
                    modulus=P, recipient=alice.agent.id, recipient_key=key,
                    masking_scheme=proto.NoMasking(),
                    committee_sharing_scheme=proto.AdditiveSharing(share_count=2, modulus=P),
                    recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
                    committee_encryption_scheme=proto.SodiumEncryptionScheme(), **tier)

            flat = aggregation(str(uuid.UUID(int=1)))
            alice.upload_aggregation(aggregation(root_id, tiers=2, sub_cohort_size=3))
            alice.upload_aggregation(flat)
            svc = alice.service
            outcomes.append([
                _outcome(lambda: svc.get_tier_status(alice.agent, proto.AggregationId(root_id))),
                _outcome(lambda: svc.get_tier_status(alice.agent, flat.id)),
                _outcome(lambda: svc.complete_clerking_job(alice.agent, proto.ClerkingJobId(job_id))),
                _outcome(lambda: stranger.service.get_tier_status(
                    stranger.agent, proto.AggregationId(root_id)))[:2],
            ])
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0][0] == "ok" and '"tiers": 2' in outcomes[0][0][1]
    assert outcomes[0][1] == ("ok", None)
    # the in-process services agree before any transport
    agent = tp.Agent(id=AgentId.random(), verification_key=None)
    ours = _outcome(lambda: new_mem_server().get_tier_status(agent, tp.AggregationId(root_id)))
    theirs = _outcome(lambda: j_server().get_tier_status(
        jp.Agent(id=jp.AgentId(str(agent.id)), verification_key=None), jp.AggregationId(root_id)))
    assert ours == theirs


def test_transport_failures_are_sda_errors(tmp_path):
    client = SdaHttpClient("http://127.0.0.1:1", TokenStore(tmp_path), timeout=2)
    with pytest.raises(SdaError, match="transport failure"):
        client.ping()
    with pytest.raises(SdaError, match="transport failure"):
        client.get_readyz()


def test_shutdown_is_prompt_with_live_keepalive_connections(tmp_path):
    httpd = listen(("127.0.0.1", 0), new_mem_server())
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    try:
        service = SdaHttpClient(f"http://{host}:{port}", TokenStore(tmp_path))
        assert service.ping().running  # a pooled keep-alive connection
        parked = socket.create_connection((host, port), timeout=10)
        try:
            parked.sendall(b"GET /v1/ping HTTP/1.1\r\nHost: x\r\n\r\n")
            parked.settimeout(5)
            assert parked.recv(4096).startswith(b"HTTP/1.1 200")
            t0 = time.perf_counter()
            httpd.shutdown()
            httpd.server_close()
            assert time.perf_counter() - t0 < 5.0
            thread.join(timeout=5)
            assert not thread.is_alive()
            try:
                assert parked.recv(1) == b""
            except ConnectionError:
                pass
        finally:
            parked.close()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_idle_keepalive_connections_are_reaped(tmp_path, monkeypatch):
    monkeypatch.setenv("SDA_REST_IDLE_TIMEOUT_S", "0.2")
    with serve_background(new_mem_server()) as base_url:
        parsed = urlparse(base_url)
        with socket.create_connection((parsed.hostname, parsed.port), timeout=10) as s:
            s.sendall(b"GET /v1/ping HTTP/1.1\r\n" + f"Host: {parsed.hostname}\r\n\r\n".encode())
            s.settimeout(5)
            first = s.recv(4096)
            assert first.startswith(b"HTTP/1.1 200") and b"connection: close" not in first.lower()
            t0 = time.perf_counter()
            while s.recv(4096):
                pass
            assert time.perf_counter() - t0 < 5.0
        # the client notices the reaped pooled connection and reconnects:
        # wait until the server has closed the pooled socket (it reads as
        # ready), rather than sleeping a fixed time that a loaded host may
        # not honour before the reaper runs
        client = SdaHttpClient(base_url, TokenStore(tmp_path))
        assert client.ping().running
        (pool,) = client._pools.values()
        deadline = time.monotonic() + 10.0
        while not all(_is_dropped(c) for c in pool._idle) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pool._idle and all(_is_dropped(c) for c in pool._idle)
        assert client.ping().running


def _recv_response(sock, buf: bytes):
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        assert chunk, "server closed mid-response"
        buf += chunk
    head, _, buf = buf.partition(b"\r\n\r\n")
    clen = 0
    for line in head.decode("latin-1").split("\r\n")[1:]:
        name, _, value = line.partition(":")
        if name.strip().lower() == "content-length":
            clen = int(value.strip())
    while len(buf) < clen:
        chunk = sock.recv(4096)
        assert chunk, "server closed mid-body"
        buf += chunk
    return head, buf[clen:]


def test_trace_id_adopted_per_request_under_keepalive(http_ctx):
    _, base_url, tmp_path = http_ctx
    parsed = urlparse(base_url)
    telemetry.reset()
    ids = ("trace-keepalive-one", "trace-keepalive-two")
    with socket.create_connection((parsed.hostname, parsed.port), timeout=10) as s:
        s.settimeout(10)
        buf = b""
        for tid in ids:
            s.sendall(b"GET /v1/ping HTTP/1.1\r\n" + f"Host: {parsed.hostname}\r\n".encode()
                      + f"{telemetry.TRACE_HEADER}: {tid}\r\n\r\n".encode())
            head, buf = _recv_response(s, buf)
            assert head.startswith(b"HTTP/1.1 200")
            assert f"{telemetry.TRACE_HEADER.lower()}: {tid}" in head.decode("latin-1").lower()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and not all(
            telemetry.spans(name="http.request", trace_id=t) for t in ids):
        time.sleep(0.01)
    for tid in ids:
        assert telemetry.spans(name="http.request", trace_id=tid), tid


def test_client_trace_id_reaches_store_spans(http_ctx):
    _, base_url, tmp_path = http_ctx
    alice = _client(tmp_path / "alice", base_url)
    with telemetry.trace("trace-roundtrip-1"):
        alice.upload_agent()
    spans = telemetry.spans(name="store.", trace_id="trace-roundtrip-1")
    assert spans and all(s["attrs"]["store"] == "mem" for s in spans)


def test_health_readiness_and_metrics_routes(http_ctx):
    _, base_url, tmp_path = http_ctx
    r = requests.get(f"{base_url}/v1/healthz")
    assert r.status_code == 200 and r.json() == {"status": "ok"}
    r = requests.get(f"{base_url}/v1/readyz")
    assert r.status_code == 200 and r.json()["status"] == "ready"
    client = SdaHttpClient(base_url, TokenStore(tmp_path))
    assert client.get_healthz()["status"] == "ok"
    assert client.get_readyz() == (True, {"status": "ready"})
    requests.get(f"{base_url}/v1/ping")
    resp = requests.get(f"{base_url}/v1/metrics")
    assert resp.status_code == 200 and resp.headers["Content-Type"].startswith("text/plain")
    assert 'sda_http_requests_total{method="GET",route="/v1/ping",status="200"}' in resp.text
    snap = requests.get(f"{base_url}/v1/metrics.json").json()
    assert {"counters", "gauges", "histograms"} <= set(snap)


def test_metrics_history_route(http_ctx):
    _, base_url, tmp_path = http_ctx
    body = requests.get(f"{base_url}/v1/metrics/history").json()
    assert {"running", "interval_s", "samples"} <= set(body) and body["running"] is True
    for bad in ("zzz", "-1", "0"):
        assert requests.get(f"{base_url}/v1/metrics/history?n={bad}").status_code == 400, bad
    assert isinstance(SdaHttpClient(base_url, TokenStore(tmp_path)).get_metrics_history(n=5)["samples"],
                      list)


def test_slow_request_threshold(http_ctx, monkeypatch, caplog):
    _, base_url, tmp_path = http_ctx
    telemetry.set_enabled(True)
    monkeypatch.setenv("SDA_SLOW_REQUEST_S", "0.000001")
    with caplog.at_level(logging.WARNING, logger="sda.rest.server"):
        assert requests.get(f"{base_url}/v1/ping").status_code == 200
    assert any("slow request" in rec.message for rec in caplog.records)
    snap = telemetry.get_registry().snapshot()
    assert sum(v for (name, _), v in snap["counters"].items() if name == "sda_slow_requests_total") >= 1
    monkeypatch.setenv("SDA_SLOW_REQUEST_S", "0")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="sda.rest.server"):
        requests.get(f"{base_url}/v1/ping")
    assert not any("slow request" in rec.message for rec in caplog.records)


def test_admission_control_sheds_with_retry_after(tmp_path, monkeypatch):
    """``SDA_REST_MAX_INFLIGHT`` bounds executing requests: with one slot and
    a stalled handler, a concurrent request is shed with 429 and the
    configured Retry-After, while the probes stay exempt."""
    monkeypatch.setenv("SDA_REST_MAX_INFLIGHT", "1")
    monkeypatch.setenv("SDA_REST_RETRY_AFTER_S", "0.7")
    service = new_mem_server()
    entered, gate = threading.Event(), threading.Event()
    real_ping = service.ping

    def slow_ping():
        entered.set()
        gate.wait(10)
        return real_ping()

    service.ping = slow_ping
    with serve_background(service) as base_url:
        stalled = threading.Thread(target=lambda: requests.get(f"{base_url}/v1/ping", timeout=30))
        stalled.start()
        assert entered.wait(10)  # the one slot is taken
        r = requests.get(f"{base_url}/v1/agents/{uuid.uuid4()}")
        assert r.status_code == 429 and r.headers["Retry-After"] == "0.7"
        assert requests.get(f"{base_url}/v1/healthz").status_code == 200  # exempt
        gate.set()
        stalled.join(10)
