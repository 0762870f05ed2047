"""``python -m sda_tpu_torch.scripts.soak`` against the reference's
``scripts/soak.py``: ``random_round`` draws the reference's configuration
(``tests/test_property_fuzz._random_round``) for the same seed, scheme kind
and parameters, masking, cohort, values and the committee members kept,
and every round reveals the exact sum; the CLI counts its rounds as the
reference's does."""

import re

import numpy as np
import numpy.testing
import pytest

from sda_tpu_torch.scripts import soak

SEEDS = range(10_000, 10_020)
_MSG = re.compile(r"seed=(\d+) kind=(\w+) mask=(\w+) dim=(\d+) n=(\d+) participants=(\d+) kept=(\d+)")


def _reference_round(seed, tmp_path, monkeypatch, **kw) -> dict:
    """Run the reference's ``_random_round`` and read the configuration it
    drew from the message it hands its final assertion."""
    import test_property_fuzz

    seen = {}
    check = numpy.testing.assert_array_equal

    def recording(got, want, err_msg="", **kwargs):
        seen["msg"], seen["want"] = err_msg, np.asarray(want)
        check(got, want, err_msg=err_msg, **kwargs)

    monkeypatch.setattr(numpy.testing, "assert_array_equal", recording)
    test_property_fuzz._random_round(seed, tmp_path, **kw)
    monkeypatch.undo()
    fields = _MSG.fullmatch(seen["msg"]).groups()
    drawn = dict(zip(("seed", "kind", "mask", "dim", "n", "participants", "kept"), fields))
    return {k: v if k in ("kind", "mask") else int(v) for k, v in drawn.items()}


def _ours(drawn: dict) -> dict:
    return {k: v for k, v in drawn.items() if k != "modulus"}


def test_random_rounds_draw_the_references_configuration(tmp_path, monkeypatch):
    for seed in SEEDS:
        ours = soak.random_round(seed, tmp_path / f"port{seed}", device="cpu")
        theirs = _reference_round(seed, tmp_path / f"ref{seed}", monkeypatch)
        assert _ours(ours) == theirs, seed


@pytest.mark.parametrize("kind", ["additive", "basic", "packed", "packed_gen"])
@pytest.mark.parametrize("keep_min", [False, True])
def test_forced_kinds_draw_the_references_configuration(kind, keep_min, tmp_path, monkeypatch):
    ours = soak.random_round(300, tmp_path / "port", kind=kind, keep_min=keep_min, device="cpu")
    theirs = _reference_round(300, tmp_path / "ref", monkeypatch, kind=kind, keep_min=keep_min)
    assert _ours(ours) == theirs


@pytest.mark.parametrize("dim, n_participants", [(1, 1), (1, 3), (3, 1)])
def test_degenerate_shapes_draw_the_references_configuration(dim, n_participants, tmp_path,
                                                             monkeypatch):
    seed = 200 + dim * 7 + n_participants
    ours = soak.random_round(seed, tmp_path / "port", dim=dim, n_participants=n_participants,
                             device="cpu")
    theirs = _reference_round(seed, tmp_path / "ref", monkeypatch, dim=dim,
                              n_participants=n_participants)
    assert _ours(ours) == theirs


def test_cli_counts_exact_rounds(capsys):
    assert soak.main(["3", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "soak: 3/3 random rounds exact"


def test_cli_reports_a_failing_round(capsys, monkeypatch):
    def fail_one(seed, tmp, device):
        if seed == 10_001:
            raise AssertionError("inexact")
        return {}

    monkeypatch.setattr(soak, "random_round", fail_one)
    assert soak.main(["2", "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "FAIL seed=10001" in captured.err
    assert captured.out.strip() == "soak: 1/2 random rounds exact"


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="checks the no-GPU refusal")
def test_random_round_defaults_to_cuda_and_refuses_without_a_gpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.random_round(10_000, tmp_path)
