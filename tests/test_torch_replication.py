"""The port's replicated shard plane against ``sda_tpu``'s.

The cases of ``tests/test_replication.py`` on the port: with
``replicas=R`` every aggregation's state lives on the first R shards of its
ring preference, a write needs a quorum with at least one real
acknowledgement, and losing any one shard mid-round never loses the round —
the reveal stays exact off the survivor while the victim's writes wait as
hints, replayed when it returns. Over memory, file and sqlite partitions,
in process and over REST; the hint queue is drained with
``drain_hints_once`` (the repair thread stopped), except in the one test of
the thread itself. Each reveal is also held against the reference's
replicated round over the same values.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

import pytest

import sda_tpu_torch.protocol as tp
import sda_tpu_torch.rest as trest
import sda_tpu_torch.server as tserver
from sda_tpu.server.sharded import ShardRouter as JShardRouter
from sda_tpu_torch import telemetry
from sda_tpu_torch.server.sharded import ShardDownError, ShardRouter
from sda_tpu_torch.server.sqlstore import SqliteAggregationsStore, SqliteBackend
from test_torch_sharding import (
    EXPECTED,
    PORT,
    REFERENCE,
    VALUES,
    finish,
    ingest,
    new_client,
    open_aggregation,
    sharded_server,
)


def replicated(pkg, kind, shards, tmp, replicas=2):
    """A sharded, replicated service whose hint queue the test drains."""
    service = sharded_server(pkg, kind, shards, tmp, replicas=replicas)
    service.shard_router.stop_repair()
    return service


# -- routing + defaults -------------------------------------------------------


def test_replica_targets_and_defaults(monkeypatch):
    """R defaults to 1 (one home shard); ``SDA_SHARD_REPLICAS`` and the
    argument widen the target set to a prefix of the ring preference,
    clamped to K — as in ``sda_tpu``."""
    router = tserver.new_sharded_server("mem", 3).shard_router
    assert router.replicas == 1
    for key in "abcd":
        assert router.targets(key) == (router.aggregation_shard(key),)
    monkeypatch.setenv("SDA_SHARD_REPLICAS", "2")
    s2 = tserver.new_sharded_server("mem", 3)
    ref = REFERENCE["server"].new_sharded_server("mem", 3)
    try:
        assert s2.shard_router.replicas == 2 == ref.shard_router.replicas
        for key in "abcd":
            t = s2.shard_router.targets(key)
            assert t == tuple(s2.shard_router.ring.preference(key)[:2]) == ref.shard_router.targets(key)
            assert t[0] == s2.shard_router.aggregation_shard(key)
    finally:
        s2.shard_router.stop_repair()
        ref.shard_router.stop_repair()
    s3 = tserver.new_sharded_server("mem", 2, replicas=9)
    try:
        assert s3.shard_router.replicas == 2
    finally:
        s3.shard_router.stop_repair()


# -- a healthy replicated round -----------------------------------------------


@pytest.mark.parametrize("kind", ["mem", "file", "sqlite"])
def test_replicated_round_matches_baseline(kind, tmp_path):
    outs = []
    for name, pkg in (("port", PORT), ("reference", REFERENCE)):
        service = replicated(pkg, kind, 3, tmp_path / name)
        recipient, clerks, agg = open_aggregation(pkg, tmp_path / name, service)
        ingest(pkg, tmp_path / name, service, agg)
        outs.append(finish(recipient, clerks, agg))
        assert service.shard_router.hint_depth() == 0
    assert outs[0] == outs[1] == EXPECTED


# -- lose the home shard mid-round --------------------------------------------


@pytest.mark.parametrize("kind", ["mem", "file", "sqlite"])
def test_lose_home_shard_mid_round(kind, tmp_path):
    """Wedge the home shard after ingest: snapshot, clerking and reveal
    complete exactly off the surviving replica with the victim's writes
    queued; healing and one drain replay them, after which the repaired
    victim serves the reveal alone."""
    service = replicated(PORT, kind, 3, tmp_path)
    router = service.shard_router
    recipient, clerks, agg = open_aggregation(PORT, tmp_path, service)
    ingest(PORT, tmp_path, service, agg)
    home, survivor = router.targets(agg.id)
    router.wedge(home)
    try:
        assert finish(recipient, clerks, agg) == EXPECTED
        assert router.hint_depth() > 0
        before = router.hint_depth()
        assert router.drain_hints_once() == 0  # still down: nothing applied
        assert router.hint_depth() == before
    finally:
        router.heal(home)
    assert router.drain_hints_once() == before
    assert router.hint_depth() == 0
    router.wedge(survivor)
    try:
        assert [int(v) for v in recipient.reveal_aggregation(agg.id).positive().values] == EXPECTED
    finally:
        router.heal(survivor)


def test_lose_secondary_shard_mid_round(tmp_path):
    service = replicated(PORT, "sqlite", 3, tmp_path)
    router = service.shard_router
    recipient, clerks, agg = open_aggregation(PORT, tmp_path, service)
    ingest(PORT, tmp_path, service, agg)
    home, secondary = router.targets(agg.id)
    router.wedge(secondary)
    try:
        assert finish(recipient, clerks, agg) == EXPECTED
        assert router.hint_depth() > 0
    finally:
        router.heal(secondary)
    assert router.drain_hints_once() > 0
    assert router.hint_depth() == 0
    router.wedge(home)
    try:
        assert [int(v) for v in recipient.reveal_aggregation(agg.id).positive().values] == EXPECTED
    finally:
        router.heal(home)


def test_background_repair_thread_drains(tmp_path):
    """The factory's repair thread (R > 1) replays the hints once the
    shard heals, with no explicit drain; the wait polls the queue depth."""
    service = tserver.new_sharded_server("mem", 3, replicas=2)
    router = service.shard_router
    try:
        router.stop_repair()
        router.start_repair(interval=0.05)
        recipient, clerks, agg = open_aggregation(PORT, tmp_path, service)
        ingest(PORT, tmp_path, service, agg)
        home = router.targets(agg.id)[0]
        router.wedge(home)
        assert finish(recipient, clerks, agg) == EXPECTED
        assert router.hint_depth() > 0
        router.heal(home)
        deadline = time.monotonic() + 30.0
        while router.hint_depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.hint_depth() == 0
    finally:
        router.stop_repair()
    assert router._repair_thread is None


# -- quorum + fault-hook semantics --------------------------------------------


def test_both_replicas_down_fails_the_write(tmp_path):
    service = replicated(PORT, "mem", 3, tmp_path)
    router = service.shard_router
    recipient, clerks, agg = open_aggregation(PORT, tmp_path, service)
    for ix in router.targets(agg.id):
        router.wedge(ix)
    try:
        with pytest.raises(ShardDownError):
            ingest(PORT, tmp_path, service, agg)
    finally:
        for ix in router.targets(agg.id):
            router.heal(ix)
    ingest(PORT, tmp_path / "retry", service, agg)
    assert finish(recipient, clerks, agg) == EXPECTED


def test_logical_rejections_are_never_hinted(tmp_path):
    """A conflicting create and a participation of an unknown aggregation
    are rejected identically by every replica and never queued."""
    service = replicated(PORT, "mem", 3, tmp_path)
    router = service.shard_router
    recipient, clerks, agg = open_aggregation(PORT, tmp_path, service)
    with pytest.raises(tp.SdaError):
        service.server.aggregation_store.create_aggregation(
            dataclasses.replace(agg, title="someone else's round"))
    participant = new_client(PORT, tmp_path / "p", service)
    participant.upload_agent()
    [part] = participant.new_participations(VALUES[:1], agg.id)
    with pytest.raises(tp.InvalidRequestError):
        service.server.aggregation_store.create_participation(
            dataclasses.replace(part, aggregation=tp.AggregationId.random()))
    assert router.hint_depth() == 0


@pytest.mark.parametrize("marker_by", ["port", "reference"])
def test_marker_file_wedges_across_process_boundary(tmp_path, marker_by):
    """``shard-NN.down`` in the deployment root wedges the shard as the
    in-process hook does; the marker is named by either package's router."""
    service = replicated(PORT, "sqlite", 3, tmp_path)
    router = service.shard_router
    recipient, clerks, agg = open_aggregation(PORT, tmp_path, service)
    ingest(PORT, tmp_path, service, agg)
    home = router.targets(agg.id)[0]
    named = ShardRouter if marker_by == "port" else JShardRouter
    marker = pathlib.Path(named.down_marker(router.root, home))
    marker.touch()
    try:
        assert router.shard_down(home)
        assert finish(recipient, clerks, agg) == EXPECTED
        assert router.hint_depth() > 0
    finally:
        marker.unlink()
    assert not router.shard_down(home)
    assert router.drain_hints_once() > 0


# -- read repair --------------------------------------------------------------


def test_read_repair_restores_lost_record(tmp_path):
    service = replicated(PORT, "sqlite", 3, tmp_path)
    recipient, clerks, agg = open_aggregation(PORT, tmp_path, service)
    home = service.shard_router.targets(agg.id)[0]
    part = SqliteAggregationsStore(SqliteBackend(str(tmp_path / "store" / f"shard-{home:02d}.db")))
    assert part.get_aggregation(agg.id) is not None
    part.delete_aggregation(agg.id)
    assert part.get_aggregation(agg.id) is None
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        got = service.server.aggregation_store.get_aggregation(agg.id)
        assert got is not None and got.id == agg.id
        repairs = sum(c["value"] for c in telemetry.snapshot(include_spans=0)["counters"]
                      if c["name"] == "sda_shard_read_repairs_total")
        assert repairs >= 1
    finally:
        telemetry.reset()
        telemetry.set_enabled(was)
    assert part.get_aggregation(agg.id) is not None


# -- REST transport -----------------------------------------------------------


def test_lose_home_shard_mid_round_over_rest(tmp_path):
    """The wedge through the full REST stack, both directions of the
    replica counters visible on the server's metrics: hinted writes while
    down, handoff replays after the heal."""
    service = replicated(PORT, "sqlite", 3, tmp_path)
    router = service.shard_router
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        with trest.serve_background(service) as url:
            client = trest.SdaHttpClient(url, trest.TokenStore(str(tmp_path / "tok")))
            recipient, clerks, agg = open_aggregation(PORT, tmp_path, client)
            ingest(PORT, tmp_path, client, agg)
            home = router.targets(agg.id)[0]
            router.wedge(home)
            try:
                assert finish(recipient, clerks, agg) == EXPECTED
                assert router.hint_depth() > 0
            finally:
                router.heal(home)
            assert router.drain_hints_once() > 0
            assert router.hint_depth() == 0
            outcomes = {c["labels"]["outcome"] for c in telemetry.snapshot(include_spans=0)["counters"]
                        if c["name"] == "sda_shard_replica_writes_total"}
            assert {"hinted", "handoff"} <= outcomes
    finally:
        telemetry.reset()
        telemetry.set_enabled(was)


def test_shard_down_answers_like_the_reference(tmp_path):
    """With every replica of an aggregation down, a read answers with the
    reference's status (a retryable 500) on both packages' servers, and
    answers normally again after the heal."""
    import requests

    statuses = []
    for name, pkg in (("port", PORT), ("reference", REFERENCE)):
        service = replicated(pkg, "mem", 3, tmp_path / name)
        router = service.shard_router
        with pkg["rest"].serve_background(service) as url:
            client = pkg["rest"].SdaHttpClient(url, pkg["rest"].TokenStore(str(tmp_path / name / "t")))
            recipient, _, agg = open_aggregation(pkg, tmp_path / name, client)
            auth = (str(recipient.agent.id), pkg["rest"].TokenStore(str(tmp_path / name / "t")).get())
            for ix in router.targets(agg.id):
                router.wedge(ix)
            down = requests.get(f"{url}/v1/aggregations/{agg.id}", auth=auth, timeout=30)
            for ix in router.targets(agg.id):
                router.heal(ix)
            up = requests.get(f"{url}/v1/aggregations/{agg.id}", auth=auth, timeout=30)
            statuses.append((down.status_code, up.status_code))
    assert statuses[0] == statuses[1] == (500, 200)


@pytest.mark.parametrize("attempts,dropped", [("1", True), ("8", False)])
def test_cross_frontend_hints_replay_within_the_attempt_budget(tmp_path, monkeypatch, attempts,
                                                               dropped):
    """Two frontends over one sqlite root keep a hint queue each. The jobs
    are enqueued through one and the clerking results posted through the
    other while a shard is down, so a result's replay fails until the other
    frontend has replayed its job. Within ``SDA_SHARD_HANDOFF_ATTEMPTS`` the
    result waits for it; past the budget it is dropped and the healed
    replica lacks it — in the port as in ``sda_tpu``."""
    monkeypatch.setenv("SDA_SHARD_HANDOFF_ATTEMPTS", attempts)
    outcomes = []
    for name, pkg in (("port", PORT), ("reference", REFERENCE)):
        tmp = tmp_path / name
        jobs_side = replicated(pkg, "sqlite", 2, tmp)
        results_side = replicated(pkg, "sqlite", 2, tmp)
        recipient, clerks, agg = open_aggregation(pkg, tmp, jobs_side)
        ingest(pkg, tmp, jobs_side, agg)
        down = jobs_side.shard_router.targets(agg.id)[1]
        marker = pathlib.Path(ShardRouter.down_marker(jobs_side.shard_router.root, down))
        marker.touch()
        recipient.end_aggregation(agg.id)
        for c in clerks:
            c.service = results_side
            c.run_chores(-1)
        marker.unlink()
        first = results_side.shard_router.drain_hints_once()  # its jobs are not there yet
        jobs = jobs_side.shard_router.drain_hints_once()
        later = results_side.shard_router.drain_hints_once()
        depths = (jobs_side.shard_router.hint_depth(), results_side.shard_router.hint_depth())
        home = jobs_side.shard_router.targets(agg.id)[0]
        jobs_side.shard_router.wedge(home)  # read the healed replica alone
        status = jobs_side.get_aggregation_status(recipient.agent, agg.id)
        outcomes.append((first, jobs > 0, later, depths, status.snapshots[0].result_ready))
    assert outcomes[0] == outcomes[1]
    first, replayed_jobs, later, depths, ready = outcomes[0]
    assert first == 0 and replayed_jobs and depths == (0, 0)
    assert (later, ready) == ((0, False) if dropped else (2, True))
