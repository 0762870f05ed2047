"""Whole sealed aggregation rounds in the port against ``sda_tpu``.

The same inputs (seeded numpy draws) go through a round in each package —
recipient, 8 clerks with their own keystores, participants that mask, share
and seal, the in-memory server, the chores, the reveal — over every sharing
x masking pair, and the revealed field sums must be identical and equal the
plain sum mod p (exact: no tolerance). Then: a committee clerk dropped, the
paged delivery of jobs and results, the ChaCha combine's device route on the
CPU's plain version, and mixed deployments through the wire JSON, where the
port's participants seal for ``sda_tpu``'s server, clerks and recipient, and
the reverse, with the port's half sealing and opening in its native layer.
"""

import numpy as np
import pytest

import sda_tpu.protocol as jp
import sda_tpu_torch.protocol as tp
from sda_tpu.client import SdaClient as JClient
from sda_tpu.crypto import Keystore as JKeystore
from sda_tpu.server import new_mem_server as j_server
from sda_tpu_torch import telemetry as ttelemetry
from sda_tpu_torch.client import SdaClient as TClient
from sda_tpu_torch.crypto import Keystore as TKeystore
from sda_tpu_torch.crypto import masking as tmasking
from sda_tpu_torch.server import new_mem_server as t_server

P, DIM, PARTICIPANTS, CLERKS = 433, 11, 3, 8
SHARINGS = {
    "additive": lambda pr: pr.AdditiveSharing(share_count=3, modulus=P),
    "basic": lambda pr: pr.BasicShamirSharing(share_count=5, privacy_threshold=2, prime_modulus=P),
    "packed": lambda pr: pr.PackedShamirSharing(3, 8, 4, P, 354, 150),
}
MASKINGS = {
    "none": lambda pr: pr.NoMasking(),
    "full": lambda pr: pr.FullMasking(modulus=P),
    "chacha": lambda pr: pr.ChaChaMasking(modulus=P, dimension=DIM, seed_bitsize=128),
}
PORT = (tp, TClient, TKeystore, t_server)
REFERENCE = (jp, JClient, JKeystore, j_server)


def _client(pkg, root, service):
    proto, client_cls, keystore_cls, _ = pkg
    keystore = keystore_cls(root)
    agent = client_cls.new_agent(keystore)
    if client_cls is TClient:
        return TClient(agent, keystore, service, device="cpu")
    return client_cls(agent, keystore, service)


def _inputs(seed=0):
    return np.random.default_rng(seed).integers(0, P, size=(PARTICIPANTS, DIM))


def run_round(tmp_path, sharing, masking, *, members=PORT, participants=PORT, server=None,
              drop=None, values=None, drain=None):
    """One round; ``members`` is the package of the recipient and the
    clerks, ``participants`` that of the participants, ``server`` the
    service each side sees (default: ``members``' memory server, shared).
    ``drop`` names a committee position whose clerk never runs its chores;
    ``drain(clerks)`` runs the others' chores (default: one after the
    other). Returns the revealed canonical vector."""
    proto = members[0]
    service = members[3]() if server is None else server[0]
    part_service = service if server is None else server[1]
    recipient = _client(members, tmp_path / "recipient", service)
    recipient_key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)
    clerks = [_client(members, tmp_path / f"clerk{i}", service) for i in range(CLERKS)]
    for clerk in clerks:
        key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(key)
    aggregation = proto.Aggregation(
        id=proto.AggregationId.random(), title="round", vector_dimension=DIM, modulus=P,
        recipient=recipient.agent.id, recipient_key=recipient_key,
        masking_scheme=MASKINGS[masking](proto), committee_sharing_scheme=SHARINGS[sharing](proto),
        recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
        committee_encryption_scheme=proto.SodiumEncryptionScheme())
    recipient.upload_aggregation(aggregation)
    recipient.begin_aggregation(aggregation.id)
    values = _inputs() if values is None else values
    for i, row in enumerate(values):
        part = _client(participants, tmp_path / f"participant{i}", part_service)
        part.upload_agent()
        part.participate([int(v) for v in row], _id_for(participants, aggregation.id))
    recipient.end_aggregation(aggregation.id)
    committee = service.get_committee(recipient.agent, aggregation.id)
    dropped = None if drop is None else committee.clerks_and_keys[drop][0]
    working = [clerk for clerk in clerks if clerk.agent.id != dropped]
    if drain is None:
        for clerk in working:
            clerk.run_chores(-1)
    else:
        drain(working)
    return recipient.reveal_aggregation(aggregation.id).positive().values


def _id_for(pkg, aggregation_id):
    return pkg[0].AggregationId(str(aggregation_id))


@pytest.mark.parametrize("masking", sorted(MASKINGS))
@pytest.mark.parametrize("sharing", sorted(SHARINGS))
def test_round_reveals_the_reference_sum(tmp_path, sharing, masking):
    ours = run_round(tmp_path / "port", sharing, masking)
    theirs = run_round(tmp_path / "ref", sharing, masking, members=REFERENCE, participants=REFERENCE)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, _inputs().sum(axis=0) % P)


@pytest.mark.parametrize("drop", [0, 5])
def test_round_with_a_committee_clerk_dropped(tmp_path, drop):
    ours = run_round(tmp_path / "port", "packed", "chacha", drop=drop)
    theirs = run_round(tmp_path / "ref", "packed", "chacha", members=REFERENCE,
                       participants=REFERENCE, drop=drop)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, _inputs().sum(axis=0) % P)


def test_committee_drained_concurrently(tmp_path):
    """``run_committee`` drains every clerk's queue on a thread of its own:
    each committee member runs its one job, and the reveal is exact."""
    from sda_tpu_torch.client import run_committee

    done = []
    got = run_round(tmp_path, "packed", "full", drain=lambda clerks: done.append(run_committee(clerks)))
    assert done == [8]
    np.testing.assert_array_equal(got, _inputs().sum(axis=0) % P)


def test_additive_round_refuses_a_dropped_clerk(tmp_path):
    with pytest.raises(ValueError, match="not ready"):
        run_round(tmp_path, "additive", "none", drop=1)


def test_paged_jobs_and_results(tmp_path, monkeypatch):
    """Every job and snapshot result paged, one ciphertext per range: the
    clerks and the recipient fetch the ranges in a plain loop."""
    for name in ("SDA_JOB_PAGE_THRESHOLD", "SDA_RESULT_PAGE_THRESHOLD"):
        monkeypatch.setenv(name, "0")
    for name in ("SDA_JOB_CHUNK_SIZE", "SDA_RESULT_CHUNK_SIZE"):
        monkeypatch.setenv(name, "1")
    ours = run_round(tmp_path / "port", "packed", "full")
    theirs = run_round(tmp_path / "ref", "packed", "full", members=REFERENCE, participants=REFERENCE)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, _inputs().sum(axis=0) % P)


def test_chacha_device_route_on_the_cpu(monkeypatch):
    """A CPU masker with its threshold lowered routes the combine through
    ``combine_masks_device`` (the kernel's plain version on a CPU tensor);
    the result equals the reference's host fold of the same seeds."""
    from sda_tpu.crypto.masking import ChaChaMasker as JMasker

    calls = []
    real = tmasking.combine_masks_device

    def counted(*args, **kwargs):
        calls.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tmasking, "combine_masks_device", counted)
    seeds = np.random.default_rng(3).integers(0, 1 << 32, size=(6, 4), dtype=np.uint64)
    masker = tmasking.ChaChaMasker(P, 500, 128, device="cpu")
    host = masker.combine(list(seeds.astype(np.int64)))
    assert calls == []  # 3,000 elements: the host fold
    masker.DEVICE_COMBINE_THRESHOLD = 1
    device = masker.combine(list(seeds.astype(np.int64)))
    assert [str(d) for d in calls] == ["cpu"]
    want = JMasker(P, 500, 128).combine(list(seeds.astype(np.int64)))
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(device, want)


def test_chacha_combine_takes_the_host_fold_from_2_62(monkeypatch):
    """A cohort above the device threshold at m = 2^63 - 25: the device
    fold's int64 sums cannot hold it, so the combine takes the exact host
    fold (no launch), equal to the reference's host fold of the same
    seeds (its threshold left as it is)."""
    from sda_tpu.crypto.masking import ChaChaMasker as JMasker

    calls = []
    monkeypatch.setattr(tmasking, "combine_masks_device", lambda *a, **k: calls.append(1))
    m, dim = (1 << 63) - 25, 8
    masker = tmasking.ChaChaMasker(m, dim, 128, device="cpu")
    seeds = [masker.mask(np.zeros(dim, dtype=np.int64))[0] for _ in range(3)]
    masker.DEVICE_COMBINE_THRESHOLD = 1
    got = masker.combine(seeds)
    assert calls == []
    np.testing.assert_array_equal(got, JMasker(m, dim, 128).combine(seeds))


def test_round_through_the_device_route(tmp_path, monkeypatch):
    calls = []
    real = tmasking.combine_masks_device
    monkeypatch.setattr(tmasking, "combine_masks_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tmasking.ChaChaMasker, "DEVICE_COMBINE_THRESHOLD", PARTICIPANTS * DIM)
    ours = run_round(tmp_path, "packed", "chacha")
    assert len(calls) == 1
    np.testing.assert_array_equal(ours, _inputs().sum(axis=0) % P)


def test_maskers_default_to_cuda():
    """Without ``device``, a masker is made for CUDA: on a host without a
    GPU that raises instead of running the combine elsewhere."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default masker is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmasking.ChaChaMasker(P, DIM, 128)


def test_tiered_aggregation_not_ported(tmp_path):
    """A tiered root is accepted by the port's server as by ``sda_tpu``'s,
    and each serves it back with the same wire JSON."""
    stored = []
    for pkg in (PORT, REFERENCE):
        proto = pkg[0]
        service = pkg[3]()
        recipient = _client(pkg, tmp_path / pkg[0].__name__, service)
        recipient.upload_agent()
        key = recipient.new_encryption_key()
        recipient.upload_encryption_key(key)
        aggregation = proto.Aggregation(
            id=proto.AggregationId("5b8e7bd6-3f36-4f4b-9c1c-0d3a4f0e2a11"), title="t",
            vector_dimension=DIM, modulus=P, recipient=recipient.agent.id, recipient_key=key,
            masking_scheme=proto.NoMasking(), committee_sharing_scheme=SHARINGS["packed"](proto),
            recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
            committee_encryption_scheme=proto.SodiumEncryptionScheme(), sub_cohort_size=2, tiers=2)
        recipient.upload_aggregation(aggregation)
        got = service.get_aggregation(recipient.agent, aggregation.id).to_json()
        stored.append({**got, "recipient": None, "recipient_key": None})
        assert got["tiers"] == 2 and got["sub_cohort_size"] == 2
    assert stored[0] == stored[1]


class WireBridge:
    """An ``SdaService`` of one package seen from the other: every argument
    and result crosses as wire JSON, decoded by the receiving package."""

    def __init__(self, target, proto_in, proto_out):
        self.target, self.proto_in, self.proto_out = target, proto_in, proto_out

    @staticmethod
    def _convert(obj, proto):
        if obj is None or isinstance(obj, (bool, int, str)):
            return obj
        if isinstance(obj, (list, tuple)):
            return type(obj)(WireBridge._convert(o, proto) for o in obj)
        name = type(obj).__name__
        if name == "Signed":
            return proto.signed_encryption_key_from_json(obj.to_json())
        return getattr(proto, name).from_json(obj.to_json())

    def __getattr__(self, name):
        method = getattr(self.target, name)

        def call(*args):
            out = method(*[self._convert(a, self.proto_in) for a in args])
            return self._convert(out, self.proto_out)

        return call


@pytest.mark.parametrize("masking", ["none", "chacha"])
@pytest.mark.parametrize("layout", ["port participants, reference round",
                                    "reference participants, port round"])
def test_mixed_deployment_through_the_wire(tmp_path, layout, masking):
    if layout.startswith("port"):
        members, participants = REFERENCE, PORT
    else:
        members, participants = PORT, REFERENCE
    service = members[3]()
    bridge = WireBridge(service, members[0], participants[0])
    got = run_round(tmp_path, "packed", masking, members=members, participants=participants,
                    server=(service, bridge))
    np.testing.assert_array_equal(got, _inputs().sum(axis=0) % P)


def _crypto_counts() -> dict:
    return {(c["name"], c["labels"].get("path")): c["value"]
            for c in ttelemetry.snapshot(include_spans=0)["counters"]
            if c["name"].startswith("sda_crypto_")}


@pytest.mark.parametrize("layout", ["port participants, reference round",
                                    "reference participants, port round"])
def test_mixed_deployment_rides_the_native_layer(tmp_path, layout):
    """A mixed deployment reveals exactly while the port's half seals,
    opens and expands masks in the native layer's C: port participants seal
    each 1 x 8 share matrix on the comb path and their ChaCha seed as a
    batch of one; port clerks and a port recipient open in batches and the
    recipient folds the seeds in C. No other path is counted."""
    port_participates = layout.startswith("port")
    members, participants = (REFERENCE, PORT) if port_participates else (PORT, REFERENCE)
    service = members[3]()
    bridge = WireBridge(service, members[0], participants[0])
    before = _crypto_counts()
    got = run_round(tmp_path, "packed", "chacha", members=members, participants=participants,
                    server=(service, bridge))
    np.testing.assert_array_equal(got, _inputs().sum(axis=0) % P)
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
        # every clerk opens its PARTICIPANTS shares and seals one result
        assert grew[("sda_crypto_opens_total", "batch")] >= CLERKS * PARTICIPANTS
        assert grew[("sda_crypto_seals_total", "batch")] == CLERKS
        assert grew[("sda_crypto_chacha_expands_total", "native")] == PARTICIPANTS
        assert ("sda_crypto_seals_total", "comb") not in grew
