"""The churn harness's cells over REST, as the reference CI's churn stage
runs them (``ci.sh`` stage 5): the five ``scenarios`` invocations against
port ``sdad`` subprocesses (mem, sqlite, and a K=3/R=2 sqlite plane), once
per module, each cell green and exact, then the stage's own checks over
the banked artifacts. The clerk killed mid-chunk is a child process of the
port (``--kill-child``) that must die by ``os._exit(9)``."""

import json
from pathlib import Path

import pytest

from sda_tpu_torch.scripts import scenarios

#: ``ci.sh``'s stage-5 invocations: (scenarios, store)
CI_RUNS = (
    ("vanish-after-sharing", "mem"),
    ("clerk-kill-mid-chunk", "sqlite"),
    ("saturated-frontend", "mem"),
    ("kill-shard-mid-round", "sqlite"),
    ("sub-committee-clerk-killed,sub-cohort-vanishes", "sqlite"),
)
CELLS = [(name, store) for names, store in CI_RUNS for name in names.split(",")]


@pytest.fixture(scope="module")
def banked(tmp_path_factory):
    artifacts = tmp_path_factory.mktemp("scenarios")
    rcs = [scenarios.main(["--scenarios", names, "--stores", store, "--transports", "rest",
                           "--artifacts", str(artifacts), "--device", "cpu"])
           for names, store in CI_RUNS]
    return artifacts, rcs


def _cell(artifacts: Path, name: str) -> dict:
    (path,) = sorted(artifacts.glob(f"scenario-{name}-*.json"))
    return json.loads(path.read_text())


def test_every_invocation_exits_0(banked):
    assert banked[1] == [0] * len(CI_RUNS)


@pytest.mark.parametrize("name, store", CELLS)
def test_cell_is_green_and_exact(name, store, banked):
    d = _cell(banked[0], name)
    assert (d["scenario"], d["store"], d["transport"]) == (name, store, "rest")
    assert d["ok"] and d["exact"] is True and d["error"] is None, d


def test_ci_stage_checks_hold(banked):
    """The reference CI's checks over the banked artifacts, as it states
    them."""
    arts = sorted(banked[0].glob("scenario-*.json"))
    assert len(arts) >= 6, f"expected six scenario artifacts, found {arts}"
    for f in arts:
        d = json.loads(f.read_text())
        assert d["ok"] and d["exact"] is True, f"{f.name}: {d}"
    tiered = [json.loads(f.read_text()) for f in arts
              if "sub-committee" in f.name or "sub-cohort" in f.name]
    assert len(tiered) >= 2, "hierarchical scenario cells missing"
    assert all(d["exact"] is True for d in tiered)
    sat = [json.loads(f.read_text()) for f in arts if "saturated" in f.name]
    assert sat and sat[0]["details"]["sheds"] >= 1, "saturated cell never shed"
    rep = [json.loads(f.read_text()) for f in arts if "kill-shard" in f.name]
    assert rep and rep[0]["details"]["hinted_while_down"] >= 1, \
        "kill-shard cell never exercised hinted handoff"


def test_clerk_killed_mid_chunk_by_a_port_child(banked):
    d = _cell(banked[0], "clerk-kill-mid-chunk")["details"]
    assert d["death"] == "os._exit(9) after 2 chunks"
    assert d["resumed_jobs"] == 1
    assert d["aggregate"] == [sum(i % 7 for i in range(10)) % 433, 10, sum(i % 3 for i in range(10)), 20]


def test_kill_shard_drained_within_the_references_limit(banked):
    d = _cell(banked[0], "kill-shard-mid-round")["details"]
    assert (d["shards"], d["replicas"]) == (3, 2)
    assert d["victim"] != d["survivor"]
    assert d["drain_s"] <= 30.0


def test_vanish_reveals_the_references_aggregates(banked):
    d = _cell(banked[0], "vanish-after-sharing")["details"]
    want = [sum(i % 5 for i in range(5)), sum((i + 2) % 5 for i in range(5)), 5, 0]
    assert d["basic"] == {"committee": 5, "vanished": [0, 3], "threshold": 3, "aggregate": want}
    assert d["packed"] == {"committee": 8, "vanished": [5], "threshold": 7, "aggregate": want}


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="checks the no-GPU refusal")
def test_kill_child_refuses_without_a_gpu(tmp_path, capsys):
    """The child defaults to CUDA like every client of the script."""
    with pytest.raises(SystemExit) as exc:
        scenarios.main(["--kill-child", str(tmp_path), str(tmp_path), "http://127.0.0.1:9", "2"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
