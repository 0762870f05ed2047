"""``python -m sda_tpu_torch.scripts.crash_soak`` against the reference's
``scripts/crash_soak.py``: for seeds 20,000-20,029 the port draws the
reference's kill phase, victim, participant count and vectors (read from
the reference's own ``one_round`` through a recording generator, its two
servers stood in by one in-process reference server, stopped once the
vectors are drawn); one exact round with ``integrity_check`` ok in each
of the four kill phases over two port ``sdad --sqlite`` processes on one
file; ``main``'s line, stderr and exit codes as the reference's; and the
sqlite backend's boot wait against a rival holding the fresh file in
``BEGIN EXCLUSIVE`` (the counterpart of the reference's
``tests/test_shared_store.py`` boot-race test)."""

import importlib.util
import sqlite3
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from sda_tpu_torch.scripts import crash_soak

ROOT = Path(__file__).resolve().parent.parent
SEEDS = range(20_000, 20_030)


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_crash_soak", ROOT / "scripts" / "crash_soak.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Drawn(Exception):
    """Raised by the recording generator once the round's draws are done."""


class _FakeServer:
    """Stands in for one ``sdad`` process of the reference's round."""

    def __init__(self):
        self.alive = True

    def poll(self):
        return None if self.alive else -9

    def send_signal(self, _sig):
        self.alive = False

    def terminate(self):
        self.alive = False

    kill = terminate

    def wait(self, timeout=None):
        return 0


def _reference_draws(reference, seed, tmp_path, monkeypatch) -> list:
    """What the reference's ``one_round(seed)`` draws from its generator,
    in order: phase index, victim, participant count, vectors."""
    import sda_fixtures  # noqa: F401 - the reference round imports it
    import test_shared_store

    from sda_tpu.server import new_mem_server

    server = new_mem_server()
    draws = []
    real_rng = np.random.default_rng

    class Recording:
        def __init__(self, seed):
            self._rng = real_rng(seed)

        def integers(self, *args, **kwargs):
            draws.append(self._rng.integers(*args, **kwargs))
            if len(draws) == 4:
                raise _Drawn
            return draws[-1]

    with monkeypatch.context() as mp:
        mp.setattr(np.random, "default_rng", Recording)
        mp.setattr(test_shared_store, "_spawn_sdad", lambda db, extra_args=(): _FakeServer())
        mp.setattr(test_shared_store, "_bound_port", lambda proc, deadline_s=30.0: 1)
        mp.setattr(test_shared_store, "_wait_ready", lambda port, proc, deadline_s=30.0: None)
        mp.setattr(test_shared_store, "_http_client", lambda tmpdir, url: server)
        with pytest.raises(_Drawn):
            reference.one_round(seed, tmp_path)
    return draws


def test_draws_are_the_references(reference, tmp_path, monkeypatch):
    for seed in SEEDS:
        phase_ix, victim, n_parts, vectors = _reference_draws(
            reference, seed, tmp_path / str(seed), monkeypatch)
        ours = crash_soak.draw_round(seed)
        assert ours[:3] == (reference.PHASES[int(phase_ix)], int(victim), int(n_parts)), seed
        assert np.array_equal(ours[3], vectors), seed
    assert crash_soak.PHASES == reference.PHASES
    assert (crash_soak.DIM, crash_soak.MODULUS) == (reference.DIM, reference.MODULUS)


def _first_seed(phase: str) -> int:
    return next(s for s in SEEDS if crash_soak.draw_round(s)[0] == phase)


@pytest.mark.parametrize("phase", crash_soak.PHASES)
def test_round_is_exact_in_every_kill_phase(phase, tmp_path):
    seed = _first_seed(phase)
    drawn = crash_soak.one_round(seed, tmp_path, device="cpu")
    assert drawn["phase"] == phase and drawn["seed"] == seed
    assert crash_soak.integrity_ok(tmp_path / "shared.db")
    if phase == "restart":
        assert (tmp_path / "sdad-cold.stderr").exists()


def test_main_counts_an_exact_round(capsys):
    assert crash_soak.main(["1", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert captured.out == "crash-soak: 1/1 randomized crash rounds exact\n"
    assert "[crash-soak] round 1/1 done, 0 failures" in captured.err


def test_main_reports_a_failing_seed_as_the_reference(reference, capsys, monkeypatch):
    def fail_one(seed, *_args):
        if seed == 20_001:
            raise AssertionError("aggregate mismatch (phase=enqueue, victim=0)")

    monkeypatch.setattr(reference, "one_round", fail_one)
    monkeypatch.setattr(sys, "argv", ["crash_soak.py", "3"])
    assert reference.main() == 1
    theirs = capsys.readouterr()
    monkeypatch.setattr(crash_soak, "one_round", fail_one)
    assert crash_soak.main(["3", "--device", "cpu"]) == 1
    ours = capsys.readouterr()
    assert ours.out == theirs.out == "crash-soak: 2/3 randomized crash rounds exact\n"
    assert ours.err == theirs.err
    assert "FAIL seed=20001: AssertionError('aggregate mismatch" in ours.err


def test_sqlite_boot_waits_out_a_rival_holding_the_fresh_file(tmp_path):
    """A rival connection holds a fresh file in ``BEGIN EXCLUSIVE`` (still
    rollback-journal mode) for half a second: the backend's boot waits it
    out and comes up in WAL mode instead of failing 'database is locked'."""
    from sda_tpu_torch.server.sqlstore import SqliteBackend

    db = tmp_path / "fresh.db"
    rival = sqlite3.connect(str(db), isolation_level=None, check_same_thread=False)
    rival.execute("BEGIN EXCLUSIVE")

    def release():
        time.sleep(0.5)
        rival.execute("COMMIT")

    t = threading.Thread(target=release)
    t.start()
    try:
        t0 = time.monotonic()
        backend = SqliteBackend(db)
        assert time.monotonic() - t0 >= 0.4
        assert backend.conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
    finally:
        t.join()
        rival.close()


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="checks the no-GPU refusal")
def test_one_round_defaults_to_cuda_and_refuses_without_a_gpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crash_soak.one_round(20_000, tmp_path)
