"""The port's sharded coordination plane (``sda_tpu_torch/server/sharded.py``)
against ``sda_tpu``'s.

The cases of ``tests/test_sharding.py`` on the port: the hash ring and the
shard router place every key as the reference does, a round over K store
partitions (memory, file, sqlite; in process and over REST; one or several
frontends; a frontend killed mid-round; a cold second process; a shard
added mid-round) reveals exactly the single-store sum, and admission
control sheds with 429 over a sharded service. Then the deployment
crosses packages: a sharded file root and a sharded sqlite root that one
package writes mid-round are finished by the other, revealing the same
bytes, with ``sda_tpu``'s partition layout on disk.
"""

from __future__ import annotations

import http.client
import pathlib
import tempfile
import threading
import time
import uuid
from urllib.parse import urlsplit

import pytest

import sda_tpu.protocol as jp
import sda_tpu.rest as jrest
import sda_tpu.server as jserver
import sda_tpu_torch.protocol as tp
import sda_tpu_torch.rest as trest
import sda_tpu_torch.server as tserver
from sda_tpu.client import SdaClient as JClient
from sda_tpu.crypto import Keystore as JKeystore
from sda_tpu.server.sharded import ShardRouter as JShardRouter
from sda_tpu.utils.hashring import HashRing as JHashRing
from sda_tpu_torch.client import SdaClient as TClient
from sda_tpu_torch.crypto import Keystore as TKeystore
from sda_tpu_torch.server.sharded import ShardRouter
from sda_tpu_torch.utils.hashring import HashRing

DIM = 4
MODULUS = 433
VALUES = [[i % 5, i + 1, 2, (3 * i) % 7] for i in range(4)]
EXPECTED = [sum(v[d] for v in VALUES) % MODULUS for d in range(DIM)]

PORT = {"proto": tp, "client": TClient, "keystore": TKeystore, "rest": trest, "server": tserver}
REFERENCE = {"proto": jp, "client": JClient, "keystore": JKeystore, "rest": jrest,
             "server": jserver}


def new_client(pkg, root, service):
    """A crypto-enabled client of ``pkg`` over a keystore at ``root``; the
    port's runs its mask combine on the CPU."""
    keystore = pkg["keystore"](root)
    agent = pkg["client"].new_agent(keystore)
    if pkg is PORT:
        return TClient(agent, keystore, service, device="cpu")
    return JClient(agent, keystore, service)


def open_aggregation(pkg, tmp, service, n_clerks=2, agg_id=None):
    """Recipient + ``n_clerks`` keyed clerks and a begun ChaCha-masked
    additive aggregation; returns (recipient, clerks, aggregation)."""
    proto = pkg["proto"]
    recipient = new_client(pkg, tmp / "r", service)
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    clerks = [new_client(pkg, tmp / f"c{i}", service) for i in range(n_clerks)]
    for c in clerks:
        c.upload_agent()
        c.upload_encryption_key(c.new_encryption_key())
    agg = proto.Aggregation(
        id=proto.AggregationId.random() if agg_id is None else proto.AggregationId(agg_id),
        title="sharding-test", vector_dimension=DIM, modulus=MODULUS,
        recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=proto.ChaChaMasking(modulus=MODULUS, dimension=DIM, seed_bitsize=128),
        committee_sharing_scheme=proto.AdditiveSharing(share_count=n_clerks, modulus=MODULUS),
        recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
        committee_encryption_scheme=proto.SodiumEncryptionScheme(),
    )
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in clerks])
    return recipient, clerks, agg


def ingest(pkg, tmp, service, agg, values=VALUES):
    participant = new_client(pkg, tmp / "p", service)
    participant.upload_agent()
    participant.upload_participations(participant.new_participations(values, agg.id))


def finish(recipient, clerks, agg) -> list:
    recipient.end_aggregation(agg.id)
    for c in clerks:
        c.run_chores(-1)
    return [int(v) for v in recipient.reveal_aggregation(agg.id).positive().values]


def run_round(pkg, tmp, service, values=VALUES) -> list:
    """One full round over ``service``; returns the revealed ints."""
    recipient, clerks, agg = open_aggregation(pkg, tmp, service)
    ingest(pkg, tmp, service, agg, values)
    return finish(recipient, clerks, agg)


def sharded_server(pkg, kind, shards, tmp, **kw):
    if kind == "mem":
        return pkg["server"].new_sharded_server("mem", shards, **kw)
    return pkg["server"].new_sharded_server(kind, shards, str(tmp / "store"), **kw)


# -- hash ring and placement --------------------------------------------------


def test_hashring_deterministic_balanced():
    """Placement is a pure function of the key string, preference order
    starts at the home shard and covers every shard once, uuid keys spread,
    and every placement equals the reference ring's."""
    a, ref = HashRing(4), JHashRing(4)
    keys = [str(uuid.UUID(int=i * 7919)) for i in range(1000)]
    assert [a.shard_for(k) for k in keys] == [ref.shard_for(k) for k in keys]
    counts = [0, 0, 0, 0]
    for k in keys:
        pref = a.preference(k)
        assert pref == ref.preference(k)
        assert sorted(pref) == [0, 1, 2, 3] and pref[0] == a.shard_for(k)
        counts[pref[0]] += 1
    assert min(counts) > 100, counts
    assert HashRing(1).shard_for("anything") == 0
    with pytest.raises(ValueError):
        HashRing(0)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_hashring_grow_moves_bounded_fraction(shards):
    """Growing K -> K+1 moves about 1/(K+1) of the keys, all onto the new
    shard."""
    old, grown = HashRing(shards), HashRing(shards + 1)
    keys = [str(uuid.UUID(int=i * 104729)) for i in range(2000)]
    moved = [k for k in keys if old.shard_for(k) != grown.shard_for(k)]
    assert len(moved) <= 1.8 * len(keys) / (shards + 1)
    assert all(grown.shard_for(k) == shards for k in moved)


@pytest.mark.parametrize("shards", [2, 4])
def test_hashring_grow_preserves_surviving_preference_order(shards):
    old, grown = HashRing(shards), HashRing(shards + 1)
    for i in range(500):
        k = str(uuid.UUID(int=i * 7919 + 13))
        assert [ix for ix in grown.preference(k) if ix != shards] == old.preference(k), k


@pytest.mark.parametrize("shards,replicas", [(1, 1), (2, 2), (3, 2), (4, 3), (5, 9)])
def test_router_targets_equal_reference(shards, replicas):
    """The write/read set of every key, and of every key moved by a grow in
    flight, equals the reference router's."""
    ours, theirs = ShardRouter(shards, replicas=replicas), JShardRouter(shards, replicas=replicas)
    assert ours.replicas == theirs.replicas
    keys = [str(uuid.UUID(int=i * 6151 + 7)) for i in range(300)]
    assert [ours.targets(k) for k in keys] == [theirs.targets(k) for k in keys]
    ours._next_ring, theirs._next_ring = HashRing(shards + 1), JHashRing(shards + 1)
    assert [ours.targets(k) for k in keys] == [theirs.targets(k) for k in keys]
    assert ShardRouter.down_marker("/x", 3) == JShardRouter.down_marker("/x", 3)


# -- equivalence matrix -------------------------------------------------------


@pytest.fixture(scope="module")
def baseline():
    """The reference's single-store reveal every sharded cell must match."""
    with tempfile.TemporaryDirectory() as td:
        out = run_round(REFERENCE, pathlib.Path(td), jserver.new_mem_server())
    assert out == EXPECTED
    return out


@pytest.mark.parametrize("kind", ["mem", "file", "sqlite"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_round_matches_single_store(kind, shards, tmp_path, baseline):
    server = sharded_server(PORT, kind, shards, tmp_path)
    assert run_round(PORT, tmp_path, server) == baseline


@pytest.mark.parametrize("kind", ["mem", "sqlite"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_round_over_rest(kind, shards, tmp_path, baseline):
    server = sharded_server(PORT, kind, shards, tmp_path)
    with trest.serve_background(server) as url:
        client = trest.SdaHttpClient(url, trest.TokenStore(str(tmp_path / "tok")))
        assert run_round(PORT, tmp_path, client) == baseline


def test_sharded_partitions_actually_split(tmp_path):
    """With K=4 and several aggregations, every partition holds data."""
    server = tserver.new_sharded_server("sqlite", 4, str(tmp_path / "store"))
    for tag in "abc":
        sub = tmp_path / f"round-{tag}"
        sub.mkdir()
        assert run_round(PORT, sub, server) == EXPECTED
    sizes = [(tmp_path / "store" / f"shard-{i:02d}.db").stat().st_size for i in range(4)]
    assert all(s > 0 for s in sizes)


def test_sharded_cold_process_reveal(tmp_path):
    """A fresh server over the same partition files starts with empty
    routing maps; every read resolves through ring placement or fan-out."""
    first = tserver.new_sharded_server("sqlite", 3, str(tmp_path / "store"))
    recipient, clerks, agg = open_aggregation(PORT, tmp_path, first)
    ingest(PORT, tmp_path, first, agg)
    recipient.end_aggregation(agg.id)
    for c in clerks:
        c.run_chores(-1)
    recipient.service = tserver.new_sharded_server("sqlite", 3, str(tmp_path / "store"))
    assert [int(v) for v in recipient.reveal_aggregation(agg.id).positive().values] == EXPECTED


# -- multi-frontend plane -----------------------------------------------------


def test_multi_frontend_round(tmp_path, baseline):
    server = tserver.new_sharded_server("mem", 2)
    with trest.serve_background_multi(server, 3) as urls:
        assert len(set(urls)) == 3
        client = trest.SdaHttpClient(urls, trest.TokenStore(str(tmp_path / "tok")))
        assert run_round(PORT, tmp_path, client) == baseline


def test_frontend_failover_mid_round(tmp_path):
    """Kill one of two frontends after ingest: the client quarantines the
    dead root, reruns against the survivor, and reveals exactly."""
    server = tserver.new_sharded_server("mem", 2)
    httpds = [trest.listen(("127.0.0.1", 0), server) for _ in range(2)]
    for h in httpds:
        threading.Thread(target=h.serve_forever, daemon=True).start()
    urls = [f"http://{h.server_address[0]}:{h.server_address[1]}" for h in httpds]
    try:
        client = trest.SdaHttpClient(urls, trest.TokenStore(str(tmp_path / "tok")))
        recipient, clerks, agg = open_aggregation(PORT, tmp_path, client)
        ingest(PORT, tmp_path, client, agg)
        httpds[1].shutdown()
        httpds[1].server_close()
        assert finish(recipient, clerks, agg) == EXPECTED
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()


# -- elastic scale-out --------------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("pre_snap", [False, True])
@pytest.mark.parametrize("clerk_mid", [False, True])
def test_live_shard_grow_reveals_exact(tmp_path, shards, replicas, pre_snap, clerk_mid):
    """A shard added in the middle of a live round — before or after the
    snapshot cut, clerking during the migration window or after the flip —
    drains its handoff queue to zero and reveals exactly (the repair thread
    stopped: every step is driven here)."""
    svc = tserver.new_sharded_server("mem", shards, replicas=replicas)
    router = svc.shard_router
    router.stop_repair()
    recipient, clerks, agg = open_aggregation(PORT, tmp_path, svc)
    ingest(PORT, tmp_path, svc, agg)
    if pre_snap:
        recipient.end_aggregation(agg.id)
    assert router.add_shard() == shards
    router.migrate_once()
    if not pre_snap:
        recipient.end_aggregation(agg.id)
    if clerk_mid:
        for c in clerks:
            c.run_chores(-1)
        router.finish_add_shard()
    else:
        router.finish_add_shard()
        for c in clerks:
            c.run_chores(-1)
    assert router.hint_depth() == 0 and router.shards == shards + 1
    assert [int(v) for v in recipient.reveal_aggregation(agg.id).positive().values] == EXPECTED


def test_grow_convenience_returns_new_index(tmp_path):
    """``grow()`` = add + migrate + finish; a round opened before the grow
    stays revealable through the grown ring."""
    svc = tserver.new_sharded_server("mem", 2, replicas=2)
    try:
        recipient, clerks, agg = open_aggregation(PORT, tmp_path, svc)
        ingest(PORT, tmp_path, svc, agg)
        assert svc.shard_router.grow(timeout=30.0) == 2
        assert finish(recipient, clerks, agg) == EXPECTED
        assert svc.shard_router.hint_depth() == 0
    finally:
        svc.shard_router.stop_repair()


# -- admission control over a sharded service ---------------------------------


def _get(url, path):
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), resp.read()
    finally:
        conn.close()


def test_admission_sheds_429(tmp_path, monkeypatch):
    """Under a one-request ceiling and injected server latency, a 6-wide
    burst against a sharded service sheds with 429 + Retry-After while
    ``/v1/ping`` keeps answering, and ``sda_rest_shed_total`` ticks."""
    monkeypatch.setenv("SDA_REST_MAX_INFLIGHT", "1")
    monkeypatch.setenv("SDA_REST_QUEUE_HIGH_WATER", "0")
    monkeypatch.setenv("SDA_FAULTS", "server.latency=1.0@0.3:7")
    service = tserver.new_sharded_server("mem", 2, replicas=2)
    try:
        with trest.serve_background(service) as url:
            answers = []
            threads = [threading.Thread(target=lambda: answers.append(
                _get(url, f"/v1/aggregations/{uuid.uuid4()}"))) for _ in range(6)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 5
            while any(t.is_alive() for t in threads) and time.monotonic() < deadline:
                assert _get(url, "/v1/ping")[0] == 200
                time.sleep(0.02)
            for t in threads:
                t.join(timeout=10)
            statuses = [a[0] for a in answers]
            assert statuses.count(429) >= 1 and any(s != 429 for s in statuses), statuses
            assert all(float(a[1]) > 0 for a in answers if a[0] == 429)
            assert b"sda_rest_shed_total" in _get(url, "/v1/metrics")[2]
    finally:
        service.shard_router.stop_repair()


def test_admission_off_by_default(monkeypatch):
    from sda_tpu.rest.server import _max_inflight as ref_max_inflight
    from sda_tpu_torch.rest.server import _max_inflight

    monkeypatch.delenv("SDA_REST_MAX_INFLIGHT", raising=False)
    assert _max_inflight() == 0 == ref_max_inflight()


# -- one sharded root, two packages -------------------------------------------


@pytest.mark.parametrize("kind", ["file", "sqlite"])
@pytest.mark.parametrize("first,second", [("port", "reference"), ("reference", "port")])
def test_sharded_root_finished_by_the_other_package(tmp_path, kind, first, second):
    """One package opens the round over a sharded, replicated root and
    ingests; the other package's server over the same root cuts the
    snapshot, its clerks clerk, its recipient reveals — the same bytes as a
    round kept in one package, over ``sda_tpu``'s partition layout."""
    pkgs = {"port": PORT, "reference": REFERENCE}
    a, b = pkgs[first], pkgs[second]
    root = tmp_path / "store"
    agg_id = str(uuid.UUID(int=0xC0FFEE))
    svc_a = a["server"].new_sharded_server(kind, 3, str(root), replicas=2)
    svc_a.shard_router.stop_repair()
    recipient, clerks, agg = open_aggregation(a, tmp_path / "a", svc_a, agg_id=agg_id)
    ingest(a, tmp_path / "a", svc_a, agg)
    svc_b = b["server"].new_sharded_server(kind, 3, str(root), replicas=2)
    svc_b.shard_router.stop_repair()
    # the second package's members: the same identities, read back from
    # their keystores by the other package's client
    proto_b = b["proto"]

    def adopt(client):
        agent = proto_b.Agent.from_json(client.agent.to_json())
        keystore = b["keystore"](client.crypto.keystore.path)
        if b is PORT:
            return TClient(agent, keystore, svc_b, device="cpu")
        return JClient(agent, keystore, svc_b)

    out = finish(adopt(recipient), [adopt(c) for c in clerks], proto_b.Aggregation.from_json(
        agg.to_json()))
    assert out == EXPECTED
    if kind == "file":
        assert sorted(p.name for p in root.iterdir() if p.is_dir()) == [
            f"shard-{i:02d}" for i in range(3)]
    else:
        assert sorted(p.name for p in root.glob("shard-*.db")) == [
            f"shard-{i:02d}.db" for i in range(3)]
