"""The REST-heavy protocol-plane riders (wire transport, the clerking and
reveal pipelines, shard scaling over ``sdad`` processes, tier fan-out)
against ``bench.py``'s, as ``test_torch_bench_riders.py`` holds the others:
the same schema less the baseline keys, every exactness flag true, equal
deterministic quantities under the same seeded ids, payload bytes within
1 %, rates positive. A file of its own so that a parallel run spreads the
two."""

import pytest

from test_torch_bench_riders import CHECKS, RiderRuns

REST = ("wire", "clerking", "reveal", "shard", "tier")


@pytest.fixture(scope="module")
def runs():
    return RiderRuns()


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("key", REST)
def test_rider_against_reference(runs, key, check):
    """The port's rider against bench.py's: ``check`` as
    ``test_torch_bench_riders``' docstring says."""
    CHECKS[check](key, *runs(key))


def test_shard_split_reaches_every_shard(runs):
    """Every sharded leg's frontends report requests on every shard, and the
    unsharded leg on none."""
    ours, _ = runs("shard")
    assert ours["legs"]["k1"]["shard_requests"] == {}
    for k in (2, 4):
        counts = ours["legs"][f"k{k}"]["shard_requests"]
        assert sorted(counts) == [str(i) for i in range(k)] and min(counts.values()) > 0


def test_tiers_bound_the_clerk_job(runs):
    """Tiering never grows the largest clerk job past the flat round's."""
    ours, _ = runs("tier")
    flat = ours["configs"]["flat"]["max_job_participations"]
    assert flat == ours["n_participants"]
    assert all(ours["configs"][f"m{m}"]["max_job_participations"] <= flat for m in (2, 4, 8))


def test_wire_legs_negotiate_their_format(runs):
    """The JSON leg moves no binary frame; the binary leg moves its bulk as
    frames."""
    ours, _ = runs("wire")
    assert not any(k.startswith("bytes_binary") for k in ours["json"])
    assert ours["binary"]["bytes_binary_in"] > ours["binary"]["bytes_json_in"]
