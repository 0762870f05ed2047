"""The port's stores (``sda_tpu_torch/server``: memory, JSON file, sqlite)
against ``sda_tpu/server``.

The reference's store contract (its CRUD, ACL, auth-token, durability and
paging tests) parametrised over the port's three stores; then store
directories and sqlite databases that one package writes, opened by the
other, with a ChaCha-masked round begun in one package and revealed in the
other, both ways.
"""

from __future__ import annotations

import inspect
import json
import os

import numpy as np
import pytest

import sda_tpu.protocol as jp
import sda_tpu.server as jserver
import sda_tpu_torch.server as tserver
from sda_tpu.client import SdaClient as JClient
from sda_tpu.crypto import Keystore as JKeystore
from sda_tpu_torch.client import SdaClient as TClient
from sda_tpu_torch.crypto import Keystore as TKeystore
from sda_tpu_torch.protocol import (
    B32,
    B64,
    AdditiveSharing,
    Agent,
    AgentId,
    Aggregation,
    AggregationId,
    EncryptionKey,
    EncryptionKeyId,
    InvalidCredentialsError,
    InvalidRequestError,
    Labelled,
    NoMasking,
    PermissionDeniedError,
    Profile,
    ServerError,
    Signature,
    Signed,
    SodiumEncryptionScheme,
    VerificationKey,
    VerificationKeyId,
)
from sda_tpu_torch.server.service import SdaServer

STORES = ["mem", "file", "sqlite"]


def _boot(pkg, store, tmp):
    if store == "file":
        return pkg.new_file_server(str(tmp / "store"))
    if store == "sqlite":
        return pkg.new_sqlite_server(str(tmp / "store.db"))
    return pkg.new_mem_server()


@pytest.fixture(params=STORES)
def service(request, tmp_path):
    return _boot(tserver, request.param, tmp_path)


def _agent() -> Agent:
    return Agent(id=AgentId.random(), verification_key=Labelled(
        VerificationKeyId.random(), VerificationKey(B32(bytes(32)))))


def _key_for(agent):
    return Signed(signature=Signature(B64(bytes(64))), signer=agent.id,
                  body=Labelled(EncryptionKeyId.random(), EncryptionKey(B32(bytes(32)))))


def _client(root, service):
    keystore = TKeystore(root)
    return TClient(TClient.new_agent(keystore), keystore, service, device="cpu")


def test_ping_and_store_label(service):
    assert service.ping().running
    assert service.server.agents_store._store in STORES


def test_agent_crud(service):
    alice = _agent()
    service.create_agent(alice, alice)
    service.create_agent(alice, alice)  # identical re-creation is a no-op
    assert service.get_agent(alice, alice.id) == alice
    assert service.get_agent(alice, AgentId.random()) is None
    other = Agent(id=alice.id, verification_key=_agent().verification_key)
    with pytest.raises(ServerError, match="already exists"):
        service.create_agent(other, other)


def test_profile_crud_and_acl(service):
    alice, bob = _agent(), _agent()
    service.create_agent(alice, alice)
    service.create_agent(bob, bob)
    assert service.get_profile(alice, alice.id) is None
    for profile in (Profile(owner=alice.id, name="alice"), Profile(owner=alice.id, name="still")):
        service.upsert_profile(alice, profile)
        assert service.get_profile(bob, alice.id) == profile
    with pytest.raises(PermissionDeniedError):
        service.upsert_profile(bob, Profile(owner=alice.id, name="bob"))


def test_encryption_key_crud_and_committee_candidates(service):
    alice, bob = _agent(), _agent()
    service.create_agent(alice, alice)
    service.create_agent(bob, bob)
    key = _key_for(alice)
    service.create_encryption_key(alice, key)
    assert service.get_encryption_key(bob, key.body.id) == key
    with pytest.raises(PermissionDeniedError):
        service.create_encryption_key(bob, _key_for(alice))
    candidates = service.server.agents_store.suggest_committee()
    assert [(c.id, c.keys) for c in candidates] == [(alice.id, [key.body.id])]


def test_auth_tokens_crud(service):
    server = service.server
    alice = _agent()
    token = Labelled(alice.id, "tok")
    with pytest.raises(InvalidCredentialsError):
        server.check_auth_token(token)
    service.create_agent(alice, alice)
    server.upsert_auth_token(token)
    assert server.check_auth_token(token) == alice
    token_new = Labelled(alice.id, "token")
    with pytest.raises(InvalidCredentialsError):
        server.check_auth_token(token_new)
    server.upsert_auth_token(token_new)
    assert server.check_auth_token(token_new) == alice
    with pytest.raises(InvalidCredentialsError):
        server.check_auth_token(token)
    server.delete_auth_token(alice.id)
    for t in (token, token_new):
        with pytest.raises(InvalidCredentialsError):
            server.check_auth_token(t)


def test_auth_token_registration_is_trust_on_first_use(service):
    server = service.server
    alice = _agent()
    service.create_agent(alice, alice)
    server.register_auth_token(Labelled(alice.id, "first"))
    server.register_auth_token(Labelled(alice.id, "first"))  # identical: accepted
    with pytest.raises(InvalidCredentialsError, match="already registered"):
        server.register_auth_token(Labelled(alice.id, "second"))
    assert server.check_auth_token(Labelled(alice.id, "first")) == alice
    with pytest.raises(InvalidCredentialsError, match="malformed"):
        server.check_auth_token(Labelled(alice.id, ["first"]))


def test_auth_token_compare_is_constant_time(service):
    assert "compare_digest" in inspect.getsource(SdaServer.check_auth_token)
    server = service.server
    alice = _agent()
    service.create_agent(alice, alice)
    server.upsert_auth_token(Labelled(alice.id, "secret-token-A"))
    with pytest.raises(InvalidCredentialsError):
        server.check_auth_token(Labelled(alice.id, "secret-token-B"))
    assert server.check_auth_token(Labelled(alice.id, "secret-token-A")) == alice


def test_aggregation_crud(service):
    alice = _agent()
    service.create_agent(alice, alice)
    key = _key_for(alice)
    service.create_encryption_key(alice, key)
    assert service.list_aggregations(alice, None, None) == []
    agg = Aggregation(
        id=AggregationId.random(), title="foo", vector_dimension=4, modulus=13,
        recipient=alice.id, recipient_key=key.body.id, masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=13),
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme())
    service.create_aggregation(alice, agg)
    assert len(service.list_aggregations(alice, "bar", None)) == 0
    assert len(service.list_aggregations(alice, "oo", None)) == 1
    assert len(service.list_aggregations(alice, None, AgentId.random())) == 0
    assert service.list_aggregations(alice, None, alice.id) == [agg.id]
    assert service.get_aggregation(alice, agg.id) == agg
    service.delete_aggregation(alice, agg.id)
    assert service.get_aggregation(alice, agg.id) is None
    assert service.list_aggregations(alice, None, None) == []


def _to_snapshot(tmp, service, title="durable", values=((1, 2, 3, 4), (1, 2, 3, 4))):
    recipient = _client(tmp / "recipient", service)
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    clerks = [_client(tmp / f"clerk{i}", service) for i in range(3)]
    for c in clerks:
        c.upload_agent()
        c.upload_encryption_key(c.new_encryption_key())
    agg = Aggregation(
        id=AggregationId.random(), title=title, vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=rkey, masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme())
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)
    for i, row in enumerate(values):
        p = _client(tmp / f"p{i}", service)
        p.upload_agent()
        p.participate(list(row), agg.id)
    recipient.end_aggregation(agg.id)
    return recipient, clerks, agg


def test_batch_ingest_is_atomic(service, tmp_path):
    recipient, clerks, agg = _to_snapshot(tmp_path, service, values=())
    part = _client(tmp_path / "part", service)
    part.upload_agent()
    agg2 = Aggregation.from_json({**agg.to_json(), "id": str(AggregationId.random()),
                                  "title": "open"})
    recipient.upload_aggregation(agg2)
    recipient.begin_aggregation(agg2.id)
    good = part.new_participations([[1, 1, 1, 1], [2, 2, 2, 2]], agg2.id)
    clash = part.new_participation([3, 3, 3, 3], agg2.id)
    store = service.server.aggregation_store
    store.create_participations([good[0]])
    clash.id = good[0].id  # same id, different body: the whole batch is refused
    with pytest.raises(ServerError, match="already exists"):
        store.create_participations([good[1], clash])
    assert store.count_participations(agg2.id) == 1
    store.create_participations(good)  # an identical replay is absorbed
    assert store.count_participations(agg2.id) == 2
    orphan = part.new_participation([0, 0, 0, 0], agg2.id)
    orphan.aggregation = AggregationId.random()
    with pytest.raises(InvalidRequestError, match="no aggregation"):
        store.create_participations([orphan])


@pytest.mark.parametrize("paged", [False, True])
def test_round_on_every_store(service, tmp_path, monkeypatch, paged):
    if paged:
        for key, value in (("SDA_JOB_PAGE_THRESHOLD", "1"), ("SDA_JOB_CHUNK_SIZE", "1"),
                           ("SDA_RESULT_PAGE_THRESHOLD", "1"), ("SDA_RESULT_CHUNK_SIZE", "2")):
            monkeypatch.setenv(key, value)
    values = ((1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12))
    recipient, clerks, agg = _to_snapshot(tmp_path, service, values=values)
    for clerk in [recipient] + clerks:
        clerk.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id).positive().values
    np.testing.assert_array_equal(out, [15, 18, 21, 24])
    # the snapshot freeze is write-once
    store = service.server.aggregation_store
    snap = store.list_snapshots(agg.id)[0]
    store.snapshot_participations(agg.id, snap)
    assert store.count_participations_snapshot(agg.id, snap) == 3


@pytest.mark.parametrize("store", ["file", "sqlite"])
def test_server_restart_mid_protocol(tmp_path, store):
    service = _boot(tserver, store, tmp_path)
    recipient, clerks, agg = _to_snapshot(tmp_path, service)
    service2 = _boot(tserver, store, tmp_path)  # a new process over the same store
    rebind = lambda c: TClient(c.agent, c.crypto.keystore, service2, device="cpu")  # noqa: E731
    recipient2 = rebind(recipient)
    for clerk in [recipient2] + [rebind(c) for c in clerks]:
        clerk.run_chores(-1)
    np.testing.assert_array_equal(recipient2.reveal_aggregation(agg.id).positive().values, [2, 4, 6, 8])
    # auth state survived too
    service2.server.upsert_auth_token(Labelled(recipient.agent.id, "t"))
    assert _boot(tserver, store, tmp_path).server.check_auth_token(
        Labelled(recipient.agent.id, "t")) == recipient.agent


@pytest.mark.parametrize("store", ["file", "sqlite"])
def test_clerk_crash_before_result_repolls_same_job(tmp_path, store):
    service = _boot(tserver, store, tmp_path)
    recipient, clerks, agg = _to_snapshot(tmp_path, service)
    members = {c for c, _ in service.get_committee(recipient.agent, agg.id).clerks_and_keys}
    crashed = next(c for c in clerks if c.agent.id in members)
    job1 = service.get_clerking_job(crashed.agent, crashed.agent.id)
    reborn = TClient(crashed.agent, crashed.crypto.keystore, service, device="cpu")
    job2 = service.get_clerking_job(reborn.agent, reborn.agent.id)
    assert job1 is not None and job2.id == job1.id
    for w in clerks:
        if w.agent.id in members and w is not crashed:
            w.run_chores(-1)
    reborn.run_chores(-1)
    np.testing.assert_array_equal(recipient.reveal_aggregation(agg.id).positive().values, [2, 4, 6, 8])
    for w in [recipient] + clerks:
        assert service.get_clerking_job(w.agent, w.agent.id) is None


def test_file_store_snapped_participation_missing_payload_raises(tmp_path):
    from sda_tpu_torch.server.filestore import FileAggregationsStore

    store = FileAggregationsStore(tmp_path / "aggs")
    agg_id = AggregationId.random()
    table = store._participations(agg_id)
    table.create("p1", {"fake": 1})
    store.snapshot_participations(agg_id, "snap1")
    os.unlink(os.path.join(table.path, "p1.json"))
    with pytest.raises(ServerError, match="no payload"):
        list(store.iter_snapped_participations(agg_id, "snap1"))
    assert store.count_participations_snapshot(agg_id, "snap1") == 1


def test_sqlite_refuses_a_partial_transpose(tmp_path):
    service = _boot(tserver, "sqlite", tmp_path)
    recipient, clerks, agg = _to_snapshot(tmp_path, service, values=((1, 1, 1, 1),))
    store = service.server.aggregation_store
    snap = store.list_snapshots(agg.id)[0]
    with pytest.raises(ServerError, match="partial transpose"):
        store.validate_snapshot_clerk_jobs(agg.id, snap, 4)
    store.validate_snapshot_clerk_jobs(agg.id, snap, 3)


def test_sqlite_backend_pragmas(tmp_path):
    from sda_tpu_torch.server.sqlstore import BUSY_TIMEOUT_S, SqliteBackend

    backend = SqliteBackend(tmp_path / "x.db")
    assert backend.conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
    assert backend.conn.execute("PRAGMA busy_timeout").fetchone()[0] == int(BUSY_TIMEOUT_S * 1000)
    assert backend._read_conn() is backend._read_conn()  # one read connection per thread


def test_layouts_equal_reference(tmp_path):
    """The same sqlite schema, and the same JSON-file directory layout."""
    import sqlite3

    from sda_tpu.server import sqlstore as jsql
    from sda_tpu_torch.server import sqlstore as tsql

    assert tsql._SCHEMA == jsql._SCHEMA
    for pkg, name in ((tserver, "port"), (jserver, "ref")):
        _boot(pkg, "sqlite", tmp_path / name)
        _boot(pkg, "file", tmp_path / name)
    tables = [sorted(sqlite3.connect(tmp_path / n / "store.db").execute(
        "SELECT name, sql FROM sqlite_master").fetchall()) for n in ("port", "ref")]
    assert tables[0] == tables[1]
    walk = [sorted(os.path.relpath(d, tmp_path / n) for d, _, _ in os.walk(tmp_path / n / "store"))
            for n in ("port", "ref")]
    assert walk[0] == walk[1]


# -- a store one package writes, the other opens and finishes a round on -------

P, DIM = 433, 11
PACKAGES = {
    "port": (tserver, TClient, TKeystore, __import__("sda_tpu_torch.protocol", fromlist=["x"])),
    "reference": (jserver, JClient, JKeystore, jp),
}


def _member(pkg, root, service, agent_json=None):
    _, client_cls, keystore_cls, proto = PACKAGES[pkg]
    keystore = keystore_cls(root)
    agent = client_cls.new_agent(keystore) if agent_json is None else proto.Agent.from_json(agent_json)
    if client_cls is TClient:
        return TClient(agent, keystore, service, device="cpu")
    return client_cls(agent, keystore, service)


@pytest.mark.parametrize("store", ["file", "sqlite"])
@pytest.mark.parametrize("first,second", [("reference", "port"), ("port", "reference")])
def test_round_begun_in_one_package_revealed_in_the_other(tmp_path, store, first, second):
    """``first``'s server and clients upload keys, open a ChaCha-masked
    packed-Shamir aggregation, take the participations and cut the
    snapshot; ``second``'s server opens the same store, and ``second``'s
    clients — over the same keystores — clerk and reveal."""
    proto = PACKAGES[first][3]
    service = _boot(PACKAGES[first][0], store, tmp_path)
    recipient = _member(first, tmp_path / "recipient", service)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    clerks = [_member(first, tmp_path / f"clerk{i}", service) for i in range(8)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())
    agg = proto.Aggregation(
        id=proto.AggregationId.random(), title="cross", vector_dimension=DIM, modulus=P,
        recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=proto.ChaChaMasking(modulus=P, dimension=DIM, seed_bitsize=128),
        committee_sharing_scheme=proto.PackedShamirSharing(3, 8, 4, P, 354, 150),
        recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
        committee_encryption_scheme=proto.SodiumEncryptionScheme())
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)
    values = np.random.default_rng(4).integers(0, P, size=(4, DIM))
    for i, row in enumerate(values):
        part = _member(first, tmp_path / f"p{i}", service)
        part.upload_agent()
        part.participate([int(v) for v in row], agg.id)
    recipient.end_aggregation(agg.id)

    service2 = _boot(PACKAGES[second][0], store, tmp_path)
    agg_id = PACKAGES[second][3].AggregationId(str(agg.id))
    members = [_member(second, tmp_path / name, service2, c.agent.to_json())
               for name, c in [("recipient", recipient)] + [(f"clerk{i}", c) for i, c in enumerate(clerks)]]
    for member in members:
        member.run_chores(-1)
    out = members[0].reveal_aggregation(agg_id).positive().values
    np.testing.assert_array_equal(out, values.sum(axis=0) % P)
    assert json.dumps(service2.get_aggregation(members[0].agent, agg_id).to_json()) == json.dumps(
        agg.to_json())
