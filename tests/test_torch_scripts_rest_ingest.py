"""``python -m sda_tpu_torch.scripts.rest_ingest`` against the reference's
``scripts/rest_ingest.py``: on each backend every POST is accepted and the
store holds exactly ``--n`` rows, and the artifact has the reference's
keys and values but the timings."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from sda_tpu_torch.scripts import rest_ingest

ROOT = Path(__file__).resolve().parent.parent
TIMINGS = {"wall_s", "participations_per_s", "per_worker", "store_bytes_after"}


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_rest_ingest",
                                                  ROOT / "scripts" / "rest_ingest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("backend", ["sqlite", "mem", "file"])
@pytest.mark.parametrize("threads", [1, 3])
def test_each_backend_stores_exactly_n_rows(backend, threads, tmp_path, capsys):
    out = tmp_path / "nested" / "ingest.json"
    argv = ["--n", "60", "--threads", str(threads), "--backend", backend, "--out", str(out)]
    assert rest_ingest.main(argv) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    artifact = json.loads(out.read_text())
    assert artifact == printed
    assert artifact["n"] == 60 and artifact["backend"] == backend
    assert artifact["stored_rows_verified"] is True
    assert sum(w["ok"] for w in artifact["per_worker"]) == 60
    assert len(artifact["per_worker"]) == threads
    assert (artifact["store_bytes_after"] is None) == (backend == "mem")


def test_artifact_is_the_references_but_the_timings(reference, tmp_path, monkeypatch, capsys):
    argv = ["--n", "40", "--threads", "2", "--backend", "sqlite"]
    assert rest_ingest.main(argv) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(sys, "argv", ["rest_ingest.py", *argv])
    assert reference.main() == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(theirs)
    assert {k: v for k, v in ours.items() if k not in TIMINGS} == \
        {k: v for k, v in theirs.items() if k not in TIMINGS}


def test_a_dropped_row_fails_the_run(tmp_path, monkeypatch, capsys):
    """The row count, not the statuses, decides: a store that acks and
    drops one row exits 1."""
    from sda_tpu_torch.server import sqlstore

    real = sqlstore.SqliteAggregationsStore.count_participations
    monkeypatch.setattr(sqlstore.SqliteAggregationsStore, "count_participations",
                        lambda self, agg: real(self, agg) - 1)
    assert rest_ingest.main(["--n", "20", "--backend", "sqlite"]) == 1
    assert "FAILED: 19/20 rows stored" in capsys.readouterr().err
