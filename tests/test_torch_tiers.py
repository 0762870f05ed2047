"""The port's tiered round (``sda_tpu_torch/protocol/tiers.py``,
``client/tiers.py``, the clerks' share promotion, ``utils/workpool.py``)
against ``sda_tpu``'s.

First the pure parts, bit for bit on seeded roots: the derived tree (ids,
sub-cohort hashing, leaf routing, frontend placement, child records, the
promotion rule), the tier status records' wire JSON, and
``reshare_coefficients``/``reshare_column`` at a small and at a 61-bit
prime. Then the cases of ``tests/test_tiers.py``,
``tests/test_tier_fanout.py`` and ``tests/test_workpool.py`` on the port:
server-side validation, tiered reveals byte-equal to the flat reveal and to
``sda_tpu``'s tiered reveal for packed Shamir, basic Shamir and additive
sharing (reveal promotion), leaf routing, tier status, the delete cascade,
vanished sub-cohorts, clerk deaths (epoch-1 reissue, below-threshold skip),
no partial reconstructed below the root, the fan-out's ordering,
cancellation and telemetry, the worker pool and the committee runner. Then
deployments: the tiered round over the sharded store, port clients against
``sda_tpu``'s REST server and the reverse, and a promoter's mask fold
through ``combine_masks_device``'s plain version equal to the host fold.
The reference's ``flagship`` fixture case needs its benchmark script and
is not ported.
"""

from __future__ import annotations

import random
import threading
import uuid

import numpy as np
import pytest

import sda_tpu.client as jclient
import sda_tpu.protocol as jp
import sda_tpu.protocol.tiers as jtiers
import sda_tpu.rest as jrest
import sda_tpu.server as jserver
import sda_tpu_torch.protocol as tp
import sda_tpu_torch.rest as trest
import sda_tpu_torch.server as tserver
from sda_tpu.ops import params as jparams
from sda_tpu.ops import shamir as jshamir
from sda_tpu_torch import telemetry
from sda_tpu_torch.client import run_committee, run_tier_round, setup_tier_round
from sda_tpu_torch.client.tiers import _poll_backoff, tier_fanout
from sda_tpu_torch.crypto import masking as tmasking
from sda_tpu_torch.crypto import sharing as tsharing
from sda_tpu_torch.ops import params as tparams
from sda_tpu_torch.ops import shamir as tshamir
from sda_tpu_torch.protocol import tiers as tiers_mod
from sda_tpu_torch.utils import workpool
from test_torch_sharding import PORT, REFERENCE, new_client

MODULUS = 433
DIM = 4
VALUES = [[i + 1, (2 * i) % 7, 5, (3 * i + 2) % 11] for i in range(5)]

SHARINGS = {
    "additive": lambda pr: pr.AdditiveSharing(share_count=3, modulus=MODULUS),
    "shamir": lambda pr: pr.BasicShamirSharing(share_count=5, privacy_threshold=2,
                                               prime_modulus=MODULUS),
    "packed": lambda pr: pr.PackedShamirSharing(3, 8, 4, MODULUS, 354, 150),
}


def expected_sum(values):
    return np.array([sum(v[d] for v in values) % MODULUS for d in range(DIM)], dtype=np.int64)


def aggregation(proto, sharing, tiers=None, m=None, agg_id=None):
    return proto.Aggregation(
        id=proto.AggregationId.random() if agg_id is None else proto.AggregationId(agg_id),
        title="tiers-test", vector_dimension=DIM, modulus=MODULUS,
        recipient=proto.AgentId.random(), recipient_key=proto.EncryptionKeyId.random(),
        masking_scheme=proto.ChaChaMasking(modulus=MODULUS, dimension=DIM, seed_bitsize=128),
        committee_sharing_scheme=sharing,
        recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
        committee_encryption_scheme=proto.SodiumEncryptionScheme(),
        sub_cohort_size=m, tiers=tiers)


def _keyed(pkg, root, service):
    client = new_client(pkg, root, service)
    client.upload_agent()
    client.upload_encryption_key(client.new_encryption_key())
    return client


def flat_round(pkg, tmp, service, sharing, values):
    recipient = new_client(pkg, tmp / "flat-r", service)
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    agg = aggregation(pkg["proto"], sharing)
    agg.recipient, agg.recipient_key = recipient.agent.id, rkey
    recipient.upload_aggregation(agg)
    pool = [_keyed(pkg, tmp / f"flat-c{i}", service) for i in range(sharing.output_size)]
    recipient.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in pool])
    for i, v in enumerate(values):
        p = new_client(pkg, tmp / f"flat-p{i}", service)
        p.upload_agent()
        p.participate(v, agg.id)
    recipient.end_aggregation(agg.id)
    (jclient.run_committee if pkg is REFERENCE else run_committee)(pool, -1)
    return recipient.reveal_aggregation(agg.id).positive()


def setup_tiered(pkg, tmp, service, sharing, tiers, m, promotion=None, disjoint=False,
                 frontends=1, agg_id=None):
    recipient = new_client(pkg, tmp / "r", service)
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    agg = aggregation(pkg["proto"], sharing, tiers=tiers, m=m, agg_id=agg_id)
    agg.recipient, agg.recipient_key = recipient.agent.id, rkey
    agg.tier_promotion = promotion
    size = sharing.output_size * (sum(m**t for t in range(tiers)) if disjoint else 1)
    pool = [_keyed(pkg, tmp / f"c{i}", service) for i in range(size)]
    setup = jclient.setup_tier_round if pkg is REFERENCE else setup_tier_round
    rnd = setup(recipient, agg, lambda name: new_client(pkg, tmp / name, service), pool,
                disjoint_committees=disjoint, frontends=frontends)
    return rnd, agg


def participate_all(pkg, tmp, service, agg, values):
    participants = []
    for i, v in enumerate(values):
        p = new_client(pkg, tmp / f"p{i}", service)
        p.upload_agent()
        p.participate(v, agg.id)
        participants.append(p)
    return participants


def tiered_round(pkg, tmp, service, sharing, values, tiers, m, promotion=None, **kw):
    rnd, agg = setup_tiered(pkg, tmp, service, sharing, tiers, m, promotion=promotion, **kw)
    participants = participate_all(pkg, tmp, service, agg, values)
    result = (jclient.run_tier_round if pkg is REFERENCE else run_tier_round)(rnd)
    assert result.skipped == []
    return agg, rnd, participants, result.output.positive()


# -- pure topology, bit for bit ------------------------------------------------


def test_constants_equal_reference():
    assert tiers_mod.TIER_NAMESPACE == jtiers.TIER_NAMESPACE
    for name in ("MAX_TIERS", "MAX_SUB_COHORTS", "PROMOTION_REVEAL", "PROMOTION_RESHARE",
                 "MAX_RESHARE_EPOCHS"):
        assert getattr(tiers_mod, name) == getattr(jtiers, name), name


@pytest.mark.parametrize("seed", range(6))
def test_topology_equals_reference(seed):
    """Child ids, sub-cohort hashing, leaf routing, placement over 1-5
    frontends, the BFS enumeration, the derived child records' wire JSON,
    the promotion rule and the promotion-row ids, on seeded roots."""
    rng = random.Random(seed)
    tiers, m = rng.choice([(2, 2), (2, 5), (3, 2), (3, 3), (4, 2)])
    root_id = str(uuid.UUID(int=rng.getrandbits(128), version=4))
    scheme = rng.choice(sorted(SHARINGS))
    promotion = rng.choice([None, "reveal", "reshare" if scheme != "additive" else None])
    ours = aggregation(tp, SHARINGS[scheme](tp), tiers=tiers, m=m, agg_id=root_id)
    theirs = jp.Aggregation.from_json(ours.to_json())
    ours.tier_promotion = theirs.tier_promotion = promotion
    assert tiers_mod.effective_promotion(ours) == jtiers.effective_promotion(theirs)
    nodes, jnodes = tiers_mod.iter_tier_nodes(ours), jtiers.iter_tier_nodes(theirs)
    as_tuples = lambda ns: [(str(n.aggregation_id), n.tier, n.index, str(n.parent))  # noqa: E731
                            for n in ns]
    assert as_tuples(nodes) == as_tuples(jnodes)
    for frontends in range(1, 6):
        assert ({str(k): v for k, v in tiers_mod.tier_placement(ours, frontends).items()}
                == {str(k): v for k, v in jtiers.tier_placement(theirs, frontends).items()})
        assert [tiers_mod.frontend_for(n.aggregation_id, frontends) for n in nodes] == \
               [jtiers.frontend_for(n.aggregation_id, frontends) for n in jnodes]
    for _ in range(64):
        who = str(uuid.UUID(int=rng.getrandbits(128), version=4))
        assert str(tiers_mod.leaf_aggregation_id(ours, tp.AgentId(who))) == \
               str(jtiers.leaf_aggregation_id(theirs, jp.AgentId(who)))
        node = nodes[rng.randrange(len(nodes))].aggregation_id
        k = rng.randrange(1, 65)
        assert tiers_mod.assign_sub_cohort(node, who, k) == jtiers.assign_sub_cohort(
            jp.AggregationId(str(node)), who, k)
    owner, key = str(uuid.UUID(int=seed + 1)), str(uuid.UUID(int=seed + 2))
    for ix in range(m):
        child = tiers_mod.child_aggregation(ours, ix, tp.AgentId(owner), tp.EncryptionKeyId(key))
        jchild = jtiers.child_aggregation(theirs, ix, jp.AgentId(owner), jp.EncryptionKeyId(key))
        assert tp.canonical_bytes(child) == jp.canonical_bytes(jchild)
        assert tiers_mod.is_reshare_child(child) == jtiers.is_reshare_child(jchild)
        for epoch, position in ((0, None), (0, ix), (1, ix + 1), (15, 3)):
            assert str(tiers_mod.reshare_participation_id(child.id, epoch, position)) == \
                   str(jtiers.reshare_participation_id(jchild.id, epoch, position))


def test_tier_status_json_equals_reference():
    ids = [str(uuid.UUID(int=i)) for i in (7, 8, 9)]
    ours = tp.TierStatus(tp.AggregationId(ids[0]), 2, 2, [
        tp.TierNodeStatus(tp.AggregationId(ids[0]), 0, None, True, 6, True),
        tp.TierNodeStatus(tp.AggregationId(ids[1]), 1, tp.AggregationId(ids[0]), True, 3, False),
        tp.TierNodeStatus(tp.AggregationId(ids[2]), 1, tp.AggregationId(ids[0]), False, 0, False)])
    theirs = jp.TierStatus.from_json(ours.to_json())
    assert tp.canonical_bytes(ours) == jp.canonical_bytes(theirs)
    assert tp.TierStatus.from_json(theirs.to_json()) == ours


def _wide_packed(proto, pmod):
    p, ws, wn = pmod.find_packed_parameters(3, 4, 8, 60, seed=11)
    return proto.PackedShamirSharing(3, 8, 4, p, ws, wn)


@pytest.mark.parametrize("scheme", ["shamir", "packed", "wide-shamir", "wide-packed"])
def test_reshare_equals_reference(scheme):
    """Lagrange re-share weights and column expansions equal the
    reference's on seeded survivor sets, are exact Python-int products at a
    61-bit prime, and the survivors' expansions sum to the reconstruction."""
    if scheme == "wide-packed":
        ours, theirs = _wide_packed(tp, tparams), _wide_packed(jp, jparams)
    elif scheme == "wide-shamir":
        ours = tp.BasicShamirSharing(share_count=5, privacy_threshold=2, prime_modulus=(1 << 61) - 1)
        theirs = jp.BasicShamirSharing.from_json(ours.to_json())
    else:
        ours, theirs = SHARINGS[scheme](tp), SHARINGS[scheme](jp)
    p = ours.modulus if hasattr(ours, "modulus") else ours.prime_modulus
    n, threshold = ours.output_size, ours.reconstruction_threshold
    rng = np.random.default_rng(len(scheme))
    batches, k = 5, ours.input_size
    dim = batches * k - 1
    for _ in range(4):
        survivors = sorted(rng.choice(n, size=int(rng.integers(threshold, n + 1)), replace=False))
        survivors = [int(s) for s in survivors]
        columns = {s: rng.integers(0, min(p, 1 << 62), size=batches) for s in survivors}
        total = np.zeros(dim, dtype=object)
        for s in survivors:
            coef = tshamir.reshare_coefficients(ours, survivors, s)
            np.testing.assert_array_equal(coef, jshamir.reshare_coefficients(theirs, survivors, s))
            col = tshamir.reshare_column(columns[s], coef, p, dim)
            np.testing.assert_array_equal(col, jshamir.reshare_column(columns[s], coef, p, dim))
            exact = [int(c) * int(w) % p for c in columns[s] for w in coef][:dim]
            assert [int(v) for v in col] == exact
            total = (total + col.astype(object)) % p
        rows = np.stack([columns[s] for s in survivors])
        want = tshamir.reconstruct_batches(rows.T, tshamir.reconstruction_matrix(ours, survivors), p)
        assert [int(v) for v in total] == [int(v) % p for v in np.asarray(want).reshape(-1)[:dim]]
    assert not tshamir.reshare_column([], [1, 2, 3], p, 7).any()


# -- server-side validation ---------------------------------------------------


def test_tier_validation_rejections(tmp_path):
    """The reference's rejections, each also refused by ``sda_tpu``."""
    for pkg in (PORT, REFERENCE):
        service = pkg["server"].new_mem_server()
        recipient = new_client(pkg, tmp_path / pkg["proto"].__name__, service)
        recipient.upload_agent()
        rkey = recipient.new_encryption_key()
        recipient.upload_encryption_key(rkey)

        def submit(sharing, tiers, m, promotion=None):
            agg = aggregation(pkg["proto"], SHARINGS[sharing](pkg["proto"]), tiers=tiers, m=m)
            agg.recipient, agg.recipient_key = recipient.agent.id, rkey
            agg.tier_promotion = promotion
            recipient.upload_aggregation(agg)

        for sharing, tiers, m, promotion in [
            ("additive", 2, None, None), ("additive", None, 2, None), ("additive", 1, 2, None),
            ("additive", tiers_mod.MAX_TIERS + 1, 2, None), ("additive", 2, 1, None),
            ("additive", 2, tiers_mod.MAX_SUB_COHORTS + 1, None),
            ("additive", 2, 2, "reshare"), ("shamir", 2, 2, "promote-harder"),
            ("shamir", None, None, "reshare"),
        ]:
            with pytest.raises(pkg["proto"].InvalidRequestError):
                submit(sharing, tiers, m, promotion)
        submit("additive", 2, 2)
        submit("additive", 2, 2, "reveal")
        submit("shamir", 2, 2, "reshare")


def test_tier_reshare_rows_gated_at_the_door(tmp_path):
    """A tagged row aimed at a flat aggregation, or naming a child that
    is not derived from the target, is refused."""
    service = tserver.new_mem_server()
    rnd, agg = setup_tiered(PORT, tmp_path, service, SHARINGS["shamir"](tp), 2, 2)
    owner = rnd.nodes[1].owner
    flat = flat_round(PORT, tmp_path / "flat", service, SHARINGS["shamir"](tp), VALUES[:1])
    assert flat.values.tolist() == expected_sum(VALUES[:1]).tolist()
    tag = tp.TierReshare(child=tp.AggregationId.random(), epoch=0)
    with pytest.raises(tp.InvalidRequestError, match="not a derived child"):
        owner.upload_participations(owner.new_participations(
            [[0] * DIM], agg.id, route=False, tier_reshare=tag))


# -- full rounds: tiered == flat == sda_tpu's tiered ---------------------------


@pytest.mark.parametrize("scheme,m", [("additive", 2), ("additive", 3), ("additive", 8),
                                      ("shamir", 2), ("shamir", 3), ("shamir", 8), ("packed", 2)])
def test_tiered_reveal_matches_flat_bytes(scheme, m, tmp_path):
    """For each sharing scheme the 2-tier round at fan-out m reveals the
    bytes of the flat round and of ``sda_tpu``'s tiered round over the same
    values (Shamir: share promotion; additive: reveal promotion). m=8 over
    five participants leaves sub-cohorts empty."""
    flat = flat_round(PORT, tmp_path / "flat", tserver.new_mem_server(), SHARINGS[scheme](tp),
                      VALUES)
    assert flat.values.tobytes() == expected_sum(VALUES).tobytes()
    *_, ours = tiered_round(PORT, tmp_path / "port", tserver.new_mem_server(),
                            SHARINGS[scheme](tp), VALUES, 2, m)
    *_, theirs = tiered_round(REFERENCE, tmp_path / "ref", jserver.new_mem_server(),
                              SHARINGS[scheme](jp), VALUES, 2, m)
    assert ours.values.tobytes() == flat.values.tobytes() == theirs.values.tobytes()
    assert ours.modulus == flat.modulus == theirs.modulus


def test_three_tier_round_exact(tmp_path):
    *_, out = tiered_round(PORT, tmp_path, tserver.new_mem_server(), SHARINGS["additive"](tp),
                           VALUES, 3, 2)
    assert out.values.tobytes() == expected_sum(VALUES).tobytes()


def test_participations_route_to_leaves_and_promotions_to_root(tmp_path):
    service = tserver.new_mem_server()
    agg, rnd, participants, _ = tiered_round(PORT, tmp_path, service, SHARINGS["additive"](tp),
                                             VALUES, 2, 2)
    status = service.get_tier_status(rnd.recipient.agent, agg.id)
    assert status is not None and (status.tiers, status.sub_cohort_size) == (2, 2)
    by_id = {n.aggregation: n for n in status.nodes}
    assert [n.tier for n in status.nodes] == [0, 1, 1]
    for p in participants:
        assert by_id[tiers_mod.leaf_aggregation_id(agg, p.agent.id)].tier == 1
    assert sum(n.number_of_participations for n in status.nodes if n.tier == 1) == len(VALUES)
    root = by_id[agg.id]
    assert root.number_of_participations == 2
    assert root.result_ready and all(n.result_ready for n in status.nodes)


def test_tier_status_unprovisioned_and_flat(tmp_path):
    service = tserver.new_mem_server()
    recipient = new_client(PORT, tmp_path / "r", service)
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    flat = aggregation(tp, SHARINGS["additive"](tp))
    flat.recipient, flat.recipient_key = recipient.agent.id, rkey
    recipient.upload_aggregation(flat)
    assert service.get_tier_status(recipient.agent, flat.id) is None
    agg = aggregation(tp, SHARINGS["additive"](tp), tiers=2, m=4)
    agg.recipient, agg.recipient_key = recipient.agent.id, rkey
    recipient.upload_aggregation(agg)
    status = service.get_tier_status(recipient.agent, agg.id)
    assert len(status.nodes) == 5 and status.nodes[0].exists
    assert all(not n.exists for n in status.nodes[1:])


def test_delete_cascades_over_derived_tree(tmp_path):
    service = tserver.new_mem_server()
    agg, rnd, _, _ = tiered_round(PORT, tmp_path, service, SHARINGS["additive"](tp), VALUES, 2, 2)
    children = [tn.aggregation.id for tn in rnd.nodes if tn.node.parent]
    assert all(service.get_aggregation(rnd.recipient.agent, c) is not None for c in children)
    rnd.recipient.delete_aggregation(agg.id)
    assert service.get_aggregation(rnd.recipient.agent, agg.id) is None
    assert all(service.get_aggregation(rnd.recipient.agent, c) is None for c in children)


def _both_leaves_populated(tmp, service, agg, count=32):
    """Participants until both sub-cohorts of a 2-way root hold someone;
    returns {leaf id: [values]}."""
    by_leaf, values = {}, [list(v) for v in VALUES]
    for i in range(count):
        if len(by_leaf) == 2 and i >= len(VALUES):
            break
        v = values[i] if i < len(values) else [i % 7, 1, i % 5, 2]
        p = new_client(PORT, tmp / f"p{i}", service)
        p.upload_agent()
        p.participate(v, agg.id)
        by_leaf.setdefault(tiers_mod.leaf_aggregation_id(agg, p.agent.id), []).append(v)
    assert len(by_leaf) == 2
    return by_leaf


def test_vanished_sub_cohort_survival(tmp_path):
    service = tserver.new_mem_server()
    rnd, agg = setup_tiered(PORT, tmp_path, service, SHARINGS["additive"](tp), 2, 2)
    by_leaf = _both_leaves_populated(tmp_path, service, agg)
    lost = rnd.nodes[1]
    lost.owner.delete_aggregation(lost.aggregation.id)
    result = run_tier_round(rnd, strict=False)
    assert result.skipped == [lost.aggregation.id]
    survivors = [v for leaf, vals in by_leaf.items() if leaf != lost.aggregation.id for v in vals]
    assert result.output.positive().values.tolist() == expected_sum(survivors).tolist()
    with pytest.raises(Exception):
        run_tier_round(rnd, strict=True)


def _counter(name, **labels):
    return sum(c["value"] for c in telemetry.snapshot(include_spans=0)["counters"]
               if c["name"] == name and all(c["labels"].get(k) == v for k, v in labels.items()))


@pytest.fixture
def telemetry_on():
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    telemetry.reset()
    yield
    telemetry.reset()
    telemetry.set_enabled(was)


def test_promotions_counted(tmp_path, telemetry_on):
    tiered_round(PORT, tmp_path, tserver.new_mem_server(), SHARINGS["additive"](tp), VALUES, 2, 2)
    assert _counter("sda_tier_promotions_total", path="reveal") == 2
    telemetry.reset()
    tiered_round(PORT, tmp_path / "r2", tserver.new_mem_server(), SHARINGS["shamir"](tp),
                 VALUES, 2, 2)
    # five re-shared columns and one mask correction per child
    assert _counter("sda_tier_promotions_total", path="reshare") == 2 * (5 + 1)
    assert any(h["name"] == "sda_tier_reshare_seconds" and h["count"] == 10
               for h in telemetry.snapshot(include_spans=0)["histograms"])


def test_explicit_reveal_promotion_matches_default_reshare(tmp_path):
    *_, reshared = tiered_round(PORT, tmp_path / "a", tserver.new_mem_server(),
                                SHARINGS["shamir"](tp), VALUES, 2, 2)
    *_, revealed = tiered_round(PORT, tmp_path / "b", tserver.new_mem_server(),
                                SHARINGS["shamir"](tp), VALUES, 2, 2, promotion="reveal")
    assert revealed.values.tobytes() == reshared.values.tobytes() == expected_sum(VALUES).tobytes()


def test_share_promotion_never_reconstructs_partials(tmp_path, monkeypatch):
    """Across a share-promoted round, secrets are reconstructed exactly
    once: the root recipient's reveal."""
    calls = []
    for cls in (tsharing.AdditiveReconstructor, tsharing.PackedShamirReconstructor):
        orig = cls.reconstruct

        def counted(self, indexed_shares, _orig=orig):
            calls.append(type(self).__name__)
            return _orig(self, indexed_shares)

        monkeypatch.setattr(cls, "reconstruct", counted)
    *_, out = tiered_round(PORT, tmp_path, tserver.new_mem_server(), SHARINGS["shamir"](tp),
                           VALUES, 2, 2)
    assert out.values.tobytes() == expected_sum(VALUES).tobytes()
    assert calls == ["PackedShamirReconstructor"]


def test_children_never_result_ready_under_reshare(tmp_path):
    service = tserver.new_mem_server()
    sharing = SHARINGS["shamir"](tp)
    agg, rnd, _, out = tiered_round(PORT, tmp_path, service, sharing, VALUES, 2, 2)
    assert out.values.tobytes() == expected_sum(VALUES).tobytes()
    status = service.get_tier_status(rnd.recipient.agent, agg.id)
    root = next(n for n in status.nodes if n.tier == 0)
    children = [n for n in status.nodes if n.tier == 1]
    assert root.number_of_participations == len(children) * (sharing.output_size + 1)
    assert root.result_ready and not any(n.result_ready for n in children)


@pytest.mark.parametrize("fanout", ["1", "4"])
def test_clerk_death_epoch1_reissue_exact(tmp_path, monkeypatch, fanout):
    """One leaf clerk dies after ingest: the survivors reissue their cached
    columns as epoch 1, the parent's prepare stage keeps that epoch, and the
    strict round reveals the exact sum — serially and fanned out."""
    monkeypatch.setenv("SDA_TIER_FANOUT", fanout)
    sharing = tp.BasicShamirSharing(share_count=3, privacy_threshold=1, prime_modulus=MODULUS)
    service = tserver.new_mem_server()
    rnd, agg = setup_tiered(PORT, tmp_path, service, sharing, 2, 2, disjoint=True)
    participate_all(PORT, tmp_path, service, agg, VALUES)
    victim = rnd.nodes[1]
    assert victim.node.parent == agg.id
    victim.clerks = victim.clerks[1:]
    result = run_tier_round(rnd, strict=True)
    assert result.skipped == []
    assert result.output.positive().values.tobytes() == expected_sum(VALUES).tobytes()


def test_clerk_death_below_threshold_skips_subtree(tmp_path):
    sharing = tp.BasicShamirSharing(share_count=3, privacy_threshold=1, prime_modulus=MODULUS)
    service = tserver.new_mem_server()
    rnd, agg = setup_tiered(PORT, tmp_path, service, sharing, 2, 2, disjoint=True)
    participants = participate_all(PORT, tmp_path, service, agg, VALUES)
    victim = rnd.nodes[1]
    victim.clerks = victim.clerks[:1]
    result = run_tier_round(rnd, strict=False)
    assert result.skipped == [victim.aggregation.id]
    survivors = [v for p, v in zip(participants, VALUES)
                 if tiers_mod.leaf_aggregation_id(agg, p.agent.id) != victim.aggregation.id]
    assert result.output.positive().values.tobytes() == expected_sum(survivors).tobytes()


# -- concurrent tier close -----------------------------------------------------

@pytest.mark.parametrize("scheme,promotion", [("additive", None), ("shamir", None),
                                              ("shamir", "reveal")])
def test_fanout_reveal_matches_serial_bytes(scheme, promotion, tmp_path, monkeypatch):
    """Fanned out over three siblings, both promotion paths reveal the
    plain sum."""
    monkeypatch.setenv("SDA_TIER_FANOUT", "4")
    *_, out = tiered_round(PORT, tmp_path, tserver.new_mem_server(), SHARINGS[scheme](tp),
                           VALUES, 2, 3, promotion=promotion)
    assert out.values.tobytes() == expected_sum(VALUES).tobytes()


def test_fanout_and_serial_legs_byte_identical(tmp_path, monkeypatch):
    service = tserver.new_mem_server()
    monkeypatch.setenv("SDA_TIER_FANOUT", "1")
    *_, serial = tiered_round(PORT, tmp_path / "s", service, SHARINGS["shamir"](tp), VALUES, 2, 2)
    monkeypatch.setenv("SDA_TIER_FANOUT", "8")
    *_, fanned = tiered_round(PORT, tmp_path / "f", service, SHARINGS["shamir"](tp), VALUES, 2, 2)
    assert fanned.values.tobytes() == serial.values.tobytes() == expected_sum(VALUES).tobytes()


def test_three_tier_fanout_exact(tmp_path, monkeypatch):
    monkeypatch.setenv("SDA_TIER_FANOUT", "4")
    *_, out = tiered_round(PORT, tmp_path, tserver.new_mem_server(), SHARINGS["additive"](tp),
                           VALUES, 3, 2)
    assert out.values.tobytes() == expected_sum(VALUES).tobytes()


def _recording_scatter(monkeypatch):
    ops, real = [], workpool.scatter

    def wrapper(op, tasks, width, **kwargs):
        ops.append(op)
        return real(op, tasks, width, **kwargs)

    monkeypatch.setattr(workpool, "scatter", wrapper)
    return ops


@pytest.mark.parametrize("fanout,m", [("1", 2), ("4", 3)])
def test_fanout_dispatch_follows_the_kill_switch(tmp_path, monkeypatch, fanout, m):
    """``SDA_TIER_FANOUT=1`` takes the serial loop (no tier_close or
    tier_promote dispatch); a wider fan-out dispatches both."""
    ops = _recording_scatter(monkeypatch)
    monkeypatch.setenv("SDA_TIER_FANOUT", fanout)
    *_, out = tiered_round(PORT, tmp_path, tserver.new_mem_server(), SHARINGS["additive"](tp),
                           VALUES, 2, m)
    assert out.values.tobytes() == expected_sum(VALUES).tobytes()
    dispatched = {"tier_close", "tier_promote"} & set(ops)
    assert dispatched == (set() if fanout == "1" else {"tier_close", "tier_promote"})


def test_fanout_skip_accounting_order_stable(tmp_path, monkeypatch):
    monkeypatch.setenv("SDA_TIER_FANOUT", "4")
    service = tserver.new_mem_server()
    rnd, agg = setup_tiered(PORT, tmp_path, service, SHARINGS["additive"](tp), 2, 3)
    participants = participate_all(PORT, tmp_path, service, agg, VALUES)
    lost_lo, lost_hi = rnd.nodes[1], rnd.nodes[3]
    lost_lo.owner.delete_aggregation(lost_lo.aggregation.id)
    lost_hi.owner.delete_aggregation(lost_hi.aggregation.id)
    result = run_tier_round(rnd, strict=False)
    assert result.skipped == [lost_lo.aggregation.id, lost_hi.aggregation.id]
    lost = set(result.skipped)
    survivors = [v for p, v in zip(participants, VALUES)
                 if tiers_mod.leaf_aggregation_id(agg, p.agent.id) not in lost]
    assert result.output.positive().values.tolist() == expected_sum(survivors).tolist()


def test_fanout_strict_failure_is_loud(tmp_path, monkeypatch):
    monkeypatch.setenv("SDA_TIER_FANOUT", "4")
    service = tserver.new_mem_server()
    rnd, agg = setup_tiered(PORT, tmp_path, service, SHARINGS["additive"](tp), 2, 3)
    participate_all(PORT, tmp_path, service, agg, VALUES)
    rnd.nodes[1].owner.delete_aggregation(rnd.nodes[1].aggregation.id)
    with pytest.raises(Exception):
        run_tier_round(rnd, strict=True)


def _hist(snap, name, **labels):
    return next((h for h in snap["histograms"] if h["name"] == name
                 and all(h["labels"].get(k) == v for k, v in labels.items())), None)


def test_promote_samples_on_success_only_and_close_mode_labels(tmp_path, monkeypatch,
                                                               telemetry_on):
    monkeypatch.setenv("SDA_TIER_FANOUT", "4")
    sharing = tp.BasicShamirSharing(share_count=3, privacy_threshold=1, prime_modulus=MODULUS)
    service = tserver.new_mem_server()
    rnd, agg = setup_tiered(PORT, tmp_path, service, sharing, 2, 2, disjoint=True)
    participate_all(PORT, tmp_path, service, agg, VALUES)
    victim = rnd.nodes[1]
    victim.clerks = victim.clerks[:1]
    assert run_tier_round(rnd, strict=False).skipped == [victim.aggregation.id]
    snap = telemetry.snapshot(include_spans=0)
    promote = _hist(snap, "sda_tier_promote_seconds", path=tiers_mod.PROMOTION_RESHARE)
    assert promote is not None and promote["count"] == 3
    assert _hist(snap, "sda_tier_close_seconds", mode="fanout")["count"] == 1
    assert _hist(snap, "sda_tier_close_seconds", mode="serial") is None
    assert [g["value"] for g in snap["gauges"] if g["name"] == "sda_tier_fanout_nodes"] == [2]
    attrs = telemetry.spans(name="tier.close")[-1].get("attrs", {})
    assert attrs.get("mode") == "fanout" and attrs.get("width") == 2
    assert 0.0 < attrs.get("overlap_efficiency", -1.0) <= 1.0


def test_tier_fanout_env_and_default(monkeypatch):
    monkeypatch.setenv("SDA_TIER_FANOUT", "6")
    assert (tier_fanout(10), tier_fanout(4), tier_fanout(0)) == (6, 4, 1)
    monkeypatch.setenv("SDA_TIER_FANOUT", "0")
    assert tier_fanout(5) == 1
    monkeypatch.setenv("SDA_TIER_FANOUT", "many")
    with pytest.raises(ValueError):
        tier_fanout(5)
    monkeypatch.delenv("SDA_TIER_FANOUT")
    monkeypatch.setenv("SDA_WORKERS", "3")
    assert (tier_fanout(100), tier_fanout(2)) == (6, 2)


def test_poll_backoff_schedule():
    b = _poll_backoff(0.1)
    ceilings = []
    for _ in range(7):
        ceilings.append(b.ceiling())
        assert 0.0 <= b.next_delay() <= ceilings[-1]
    assert ceilings == pytest.approx([0.1, 0.2, 0.4, 0.8, 1.6, 2.0, 2.0])
    b.reset()
    assert b.ceiling() == pytest.approx(0.1)
    assert b.next_delay(floor=3.0) == 3.0
    assert _poll_backoff(5.0).cap == 5.0


# -- the worker pool -----------------------------------------------------------


def test_split_ranges_cover_contiguously():
    from sda_tpu.utils import workpool as jworkpool

    for n in (1, 2, 5, 16, 17, 100):
        for parts in (1, 2, 3, 8, n, n + 5):
            bounds = workpool.split_ranges(n, parts)
            assert bounds == jworkpool.split_ranges(n, parts)
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            sizes = [b - a for a, b in bounds]
            assert min(sizes) > 0 and max(sizes) - min(sizes) <= 1


def test_workers_env_knob(monkeypatch):
    monkeypatch.setenv("SDA_WORKERS", "5")
    assert workpool.workers() == 5
    monkeypatch.setenv("SDA_WORKERS", "0")
    assert workpool.workers() == 1
    monkeypatch.setenv("SDA_WORKERS", "nope")
    with pytest.raises(ValueError):
        workpool.workers()
    monkeypatch.delenv("SDA_WORKERS")
    assert workpool.workers() >= 1


@pytest.mark.parametrize("workers,items,serial", [("1", 10, True), ("8", 1, True), ("4", 23, False)])
def test_map_items_paths(monkeypatch, workers, items, serial):
    """One worker or one item: a single ``kernel(items, None)`` call;
    otherwise contiguous sub-ranges with ``n_threads=1``, reassembled in
    input order."""
    monkeypatch.setenv("SDA_WORKERS", workers)
    calls, lock = [], threading.Lock()

    def kernel(sub, n_threads):
        with lock:
            calls.append((list(sub), n_threads))
        return [x * 3 for x in sub]

    data = list(range(items))
    assert workpool.map_items("test", data, kernel) == [x * 3 for x in data]
    if serial:
        assert calls == [(data, None)]
    else:
        assert 1 < len(calls) <= 4 and all(n == 1 for _, n in calls)
        assert sorted(x for sub, _ in calls for x in sub) == data


def test_map_items_propagates_errors(monkeypatch):
    monkeypatch.setenv("SDA_WORKERS", "3")

    def kernel(sub, n_threads):
        if 7 in sub:
            raise RuntimeError("boom")
        return list(sub)

    with pytest.raises(RuntimeError, match="boom"):
        workpool.map_items("test", list(range(12)), kernel)


def test_scatter_outcomes_in_task_order():
    import time

    def make(i):
        def task():
            time.sleep((4 - i) * 0.01)
            return i
        return task

    outcomes = workpool.scatter("test_order", [make(i) for i in range(5)], 4)
    assert [o.value for o in outcomes] == list(range(5))
    assert all(o.error is None and not o.cancelled and o.seconds >= 0.0 for o in outcomes)


def test_scatter_width_one_runs_inline():
    names = []
    outcomes = workpool.scatter(
        "test_inline", [lambda: names.append(threading.current_thread().name) or "ok"] * 3, 1)
    assert [o.value for o in outcomes] == ["ok"] * 3
    assert names == [threading.current_thread().name] * 3


def test_scatter_rebinds_trace_id():
    orig = telemetry.current_trace_id()
    telemetry.set_trace_id("fanout-test-trace")
    try:
        outcomes = workpool.scatter("test_trace", [telemetry.current_trace_id] * 4, 2)
        assert [o.value for o in outcomes] == ["fanout-test-trace"] * 4
    finally:
        telemetry.set_trace_id(orig)


def test_scatter_strict_failure_cancels_pending_siblings():
    started, release = threading.Event(), threading.Event()
    ran = []

    def fail():
        assert started.wait(5)
        release.set()
        raise RuntimeError("boom")

    def block():
        started.set()
        assert release.wait(5)
        return "ran"

    def never():
        ran.append(1)

    outcomes = workpool.scatter("test_cancel", [fail, block] + [never] * 4, 2,
                                cancel_on_error=True)
    assert isinstance(outcomes[0].error, RuntimeError)
    assert outcomes[1].value == "ran" and not outcomes[1].cancelled
    assert all(o.cancelled and o.value is None and o.error is None for o in outcomes[2:])
    assert ran == []


_POOL_MATRIX = [
    ("additive-nomask", lambda pr: pr.AdditiveSharing(share_count=3, modulus=MODULUS),
     lambda pr: pr.NoMasking()),
    ("additive-chacha", lambda pr: pr.AdditiveSharing(share_count=3, modulus=MODULUS),
     lambda pr: pr.ChaChaMasking(modulus=MODULUS, dimension=DIM, seed_bitsize=128)),
    ("shamir-full", lambda pr: pr.BasicShamirSharing(share_count=3, privacy_threshold=1,
                                                     prime_modulus=MODULUS),
     lambda pr: pr.FullMasking(modulus=MODULUS)),
]


@pytest.mark.parametrize("paged", [False, True], ids=["monolithic", "paged"])
@pytest.mark.parametrize("tag,sharing,masking", _POOL_MATRIX, ids=[m[0] for m in _POOL_MATRIX])
def test_pooled_round_matches_serial_reveal(tmp_path, monkeypatch, tag, sharing, masking, paged):
    """A round drained by ``run_committee`` at ``SDA_WORKERS=3``, revealed
    pooled and serially: identical arrays, equal to the plain sum."""
    if paged:
        monkeypatch.setenv("SDA_JOB_PAGE_THRESHOLD", "0")
        monkeypatch.setenv("SDA_JOB_CHUNK_SIZE", "3")
        monkeypatch.setenv("SDA_RESULT_PAGE_THRESHOLD", "0")
    else:
        monkeypatch.setenv("SDA_JOB_PAGE_THRESHOLD", "1000000")
        monkeypatch.setenv("SDA_RESULT_PAGE_THRESHOLD", "1000000")
    monkeypatch.setenv("SDA_WORKERS", "3")
    service = tserver.new_mem_server()
    recipient = new_client(PORT, tmp_path / "r", service)
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    agg = aggregation(tp, sharing(tp))
    agg.masking_scheme = masking(tp)
    agg.recipient, agg.recipient_key = recipient.agent.id, rkey
    recipient.upload_aggregation(agg)
    clerks = [_keyed(PORT, tmp_path / f"c{i}", service) for i in range(3)]
    recipient.begin_aggregation(agg.id)
    for i in range(5):
        p = new_client(PORT, tmp_path / f"p{i}", service)
        p.upload_agent()
        p.participate([1, 2, 3, 4], agg.id)
    recipient.end_aggregation(agg.id)
    assert run_committee(clerks, -1) == 3
    assert run_committee(clerks, -1) == 0
    pooled = recipient.reveal_aggregation(agg.id).positive().values
    monkeypatch.setenv("SDA_WORKERS", "1")
    serial = recipient.reveal_aggregation(agg.id).positive().values
    np.testing.assert_array_equal(pooled, serial)
    np.testing.assert_array_equal(pooled, [5, 10, 15, 20])


def test_run_committee_empty_error_and_bounded_paths():
    assert run_committee([]) == 0

    class Broken:
        def clerk_once(self):
            raise RuntimeError("dead service")

    class Quiet:
        def clerk_once(self):
            return False

    class Endless:
        n = 0

        def clerk_once(self):
            self.n += 1
            return True

    with pytest.raises(RuntimeError, match="dead service"):
        run_committee([Quiet(), Broken(), Quiet()], -1)
    clerks = [Endless(), Endless()]
    assert run_committee(clerks, 4) == 8 and [c.n for c in clerks] == [4, 4]


# -- deployments ---------------------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
def test_tiered_round_over_sharded_store(tmp_path, replicas):
    service = tserver.new_sharded_server("mem", 2, replicas=replicas)
    try:
        *_, out = tiered_round(PORT, tmp_path, service, SHARINGS["shamir"](tp), VALUES, 2, 2)
        assert out.values.tobytes() == expected_sum(VALUES).tobytes()
    finally:
        service.shard_router.stop_repair()


@pytest.mark.parametrize("scheme,promotion", [("shamir", None), ("additive", None)])
@pytest.mark.parametrize("clients,server", [("port", "reference"), ("reference", "port")])
def test_mixed_deployment_over_rest(tmp_path, clients, server, scheme, promotion):
    """A tiered round over two frontends of one sharded service: one
    package's clients against the other package's REST server. Each node's
    placement is the multi-root client's routing, and the root reveals
    the plain sum."""
    cpkg = PORT if clients == "port" else REFERENCE
    spkg = PORT if server == "port" else REFERENCE
    service = spkg["server"].new_sharded_server("mem", 2, replicas=2)
    try:
        with spkg["rest"].serve_background_multi(service, 2) as urls:
            client = cpkg["rest"].SdaHttpClient(list(urls), cpkg["rest"].TokenStore(
                str(tmp_path / "tok")))
            rnd, agg = setup_tiered(cpkg, tmp_path, client, SHARINGS[scheme](cpkg["proto"]), 2, 2,
                                    promotion=promotion, frontends=2)
            assert [tn.frontend for tn in rnd.nodes] == [
                client.route_index(tn.aggregation.id) for tn in rnd.nodes]
            participate_all(cpkg, tmp_path, client, agg, VALUES)
            result = (run_tier_round if cpkg is PORT else jclient.run_tier_round)(rnd)
            assert result.skipped == []
            assert result.output.positive().values.tobytes() == expected_sum(VALUES).tobytes()
    finally:
        service.shard_router.stop_repair()


def test_promoter_fold_through_the_device_route(tmp_path, monkeypatch):
    """With the device threshold lowered, each promoter's mask fold and the
    root's reveal fold go through ``combine_masks_device``'s plain version
    (CPU tensors); a promoter's fold equals the host fold of the same
    snapshot, and the round reveals exactly."""
    routed = []
    real = tmasking.combine_masks_device

    def counting(seeds, dim, modulus, device=None):
        routed.append(len(seeds))
        return real(seeds, dim, modulus, device=device)

    monkeypatch.setattr(tmasking, "combine_masks_device", counting)
    service = tserver.new_mem_server()
    rnd, agg = setup_tiered(PORT, tmp_path, service, SHARINGS["shamir"](tp), 2, 2)
    by_leaf = _both_leaves_populated(tmp_path, service, agg)
    leaf = rnd.nodes[1]
    snapshot_id = leaf.owner.end_aggregation(leaf.aggregation.id)
    host = leaf.owner.combined_snapshot_mask(leaf.aggregation.id, snapshot_id=snapshot_id)
    assert routed == []
    monkeypatch.setattr(tmasking.ChaChaMasker, "DEVICE_COMBINE_THRESHOLD", 1)
    device = leaf.owner.combined_snapshot_mask(leaf.aggregation.id, snapshot_id=snapshot_id)
    assert routed == [len(by_leaf[leaf.aggregation.id])]
    np.testing.assert_array_equal(device, host)
    routed.clear()
    result = run_tier_round(rnd)
    values = [v for vals in by_leaf.values() for v in vals]
    assert result.output.positive().values.tobytes() == expected_sum(values).tobytes()
    # two promoters' folds, then the root's fold of 2 x (n columns + 1 correction)
    n = rnd.root.committee_sharing_scheme.output_size
    assert sorted(routed) == sorted([len(v) for v in by_leaf.values()] + [2 * (n + 1)])


def test_scatter_is_what_run_committee_dispatches(monkeypatch):
    ops = _recording_scatter(monkeypatch)

    class Once:
        done = False

        def clerk_once(self):
            if self.done:
                return False
            self.done = True
            return True

    assert run_committee([Once(), Once()], -1) == 2
    assert ops == ["committee"]


def test_partial_helper_is_route_free(tmp_path):
    """``promote_partial`` targets the named node itself (``route=False``),
    never the promoter's hashed leaf."""
    from sda_tpu_torch.client import promote_partial

    service = tserver.new_mem_server()
    rnd, agg = setup_tiered(PORT, tmp_path, service, SHARINGS["additive"](tp), 2, 2,
                            promotion="reveal")
    owner = rnd.nodes[1].owner
    pid = promote_partial(owner, [1, 2, 3, 4], agg.id)
    assert pid is not None
    status = service.get_aggregation_status(rnd.recipient.agent, agg.id)
    assert status.number_of_participations == 1
