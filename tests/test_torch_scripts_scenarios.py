"""``python -m sda_tpu_torch.scripts.scenarios`` against the reference's
``scripts/scenarios.py`` on in-process cells: every one of the ten
scenarios green in both packages under the same seeded stream of protocol
ids (``TypedId.random`` in both draws from one ``random.Random``), with
the same artifact keys and the same deterministic details; the CLI's
``--list``, its parser error, its survivability matrix and its exit codes;
``scripts/sweep_report.py`` reading the port's artifacts; the
``--overhead-ab`` record's keys; and the width seam of vanish-after-sharing
against the reference package's round on the same values and committee.
The six cells the reference CI runs over REST are in
``test_torch_scripts_scenarios_rest.py``."""

import ast
import contextlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from sda_tpu_torch.crypto import masking
from sda_tpu_torch.crypto.masking import ChaChaMasker
from sda_tpu_torch.scripts import scenarios
from test_torch_bench_riders import seeded_ids

ROOT = Path(__file__).resolve().parent.parent
ID_SEED = 11
#: details that hang on thread timing (the concurrent cut's subset, the
#: 429 count, the drain wait) or on the repair thread's progress
TIMED = {"included", "value", "sheds", "drain_s", "hinted_while_down"}


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_scenarios", ROOT / "scripts" / "scenarios.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inproc_store(name: str) -> str:
    return "file" if name == "kill-shard-mid-round" else "mem"


def _artifact(directory: Path) -> dict:
    (path,) = sorted(directory.glob("scenario-*.json"))
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", list(scenarios.SCENARIOS))
def test_cell_matches_the_references(name, reference, tmp_path):
    store = _inproc_store(name)
    with seeded_ids(ID_SEED):
        assert scenarios.run_cell(name, store, "inproc", 0, tmp_path / "port", device="cpu")
    with seeded_ids(ID_SEED):
        assert reference.run_cell(name, store, "inproc", 0, tmp_path / "ref")
    ours, theirs = _artifact(tmp_path / "port"), _artifact(tmp_path / "ref")
    assert set(ours) == set(theirs)
    assert ours["ok"] and ours["exact"] is True and ours["error"] is None
    assert set(ours["details"]) == set(theirs["details"])
    for key in set(ours["details"]) - TIMED:
        assert ours["details"][key] == theirs["details"][key], key
    for key in ("scenario", "store", "transport", "seed"):
        assert ours[key] == theirs[key]
    name_parts = sorted(tmp_path.joinpath("port").glob("*.json"))[0].name.split("-")
    assert name_parts[-2:] == [store, "inproc.json"]


def test_scenarios_are_the_references_in_order(reference):
    assert list(scenarios.SCENARIOS) == list(reference.SCENARIOS)
    assert scenarios._SCENARIO_ENV == reference._SCENARIO_ENV
    assert scenarios._SCENARIO_DEPLOY == reference._SCENARIO_DEPLOY
    assert scenarios._SCENARIO_STORES == reference._SCENARIO_STORES
    assert (scenarios.DIM, scenarios.MODULUS, scenarios.STORES, scenarios.TRANSPORTS) == (
        reference.DIM, reference.MODULUS, reference.STORES, reference.TRANSPORTS)


def test_list_prints_the_references_names(reference, capsys):
    assert reference.main(["--list"]) == 0
    theirs = capsys.readouterr().out
    assert scenarios.main(["--list"]) == 0
    assert capsys.readouterr().out == theirs


def test_unknown_scenario_is_a_parser_error(capsys):
    with pytest.raises(SystemExit) as exc:
        scenarios.main(["--scenarios", "no-such-churn", "--device", "cpu"])
    assert exc.value.code == 2
    assert "unknown scenarios: ['no-such-churn']" in capsys.readouterr().err


def test_matrix_skips_mem_for_kill_shard_as_the_reference(reference, tmp_path, capsys):
    argv = ["--scenarios", "register-never-submit,kill-shard-mid-round", "--stores", "mem,file",
            "--transports", "inproc"]
    with seeded_ids(ID_SEED):
        assert reference.main([*argv, "--artifacts", str(tmp_path / "ref")]) == 0
    theirs = capsys.readouterr()
    with seeded_ids(ID_SEED):
        assert scenarios.main([*argv, "--artifacts", str(tmp_path / "port"), "--device", "cpu"]) == 0
    ours = capsys.readouterr()
    assert ours.out == theirs.out
    assert "3/3 cells green" in ours.out
    skip = "[scenarios] skip kill-shard-mid-round         mem    inproc (store not applicable)"
    assert skip in ours.err and skip in theirs.err
    assert len(list((tmp_path / "port").glob("scenario-*.json"))) == 3


def test_failing_cell_is_recorded_and_exits_1(tmp_path, monkeypatch, capsys):
    def broken(dep, seed):
        raise AssertionError("aggregate mismatch: got [1], want [2]")

    monkeypatch.setitem(scenarios.SCENARIOS, "register-never-submit", broken)
    rc = scenarios.main(["--scenarios", "register-never-submit", "--stores", "mem",
                         "--transports", "inproc", "--artifacts", str(tmp_path), "--device", "cpu"])
    assert rc == 1
    record = _artifact(tmp_path)
    assert record["ok"] is False and record["exact"] is False and record["details"] is None
    assert "aggregate mismatch" in record["error"]
    captured = capsys.readouterr()
    assert "FAIL" in captured.err and "0/1 cells green" in captured.out


def test_sweep_report_reads_the_port_artifacts(tmp_path):
    spec = importlib.util.spec_from_file_location("ref_sweep_report",
                                                  ROOT / "scripts" / "sweep_report.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    for name in ("vanish-after-sharing", "sub-cohort-vanishes"):
        assert scenarios.run_cell(name, "mem", "inproc", 0, tmp_path, device="cpu")
    cells, overheads = sweep.load_scenarios(tmp_path)
    assert set(cells) == {("vanish-after-sharing", "mem", "inproc"),
                          ("sub-cohort-vanishes", "mem", "inproc")}
    assert all(c["ok"] and c["exact"] and c["error"] is None for c in cells.values())
    assert overheads == []


def _reference_record_keys(reference, function: str) -> set:
    """The keys of the ``record = {...}`` literal in one of the reference's
    functions, read from its source."""
    tree = ast.parse(Path(reference.__file__).read_text())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function]
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [ast.unparse(t) for t in node.targets] == ["record"]):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no record literal in {function}")


def test_overhead_ab_record_has_the_references_keys(reference, tmp_path):
    scenarios.run_overhead_ab(tmp_path)
    (path,) = sorted(tmp_path.glob("overhead-ab-*.json"))
    record = json.loads(path.read_text())
    assert set(record) == _reference_record_keys(reference, "run_overhead_ab")
    assert record["requests_per_arm"] == 1000
    assert record["retries_enabled_s"] > 0 and record["retries_disabled_s"] > 0
    assert record["ok"] == (record["overhead_pct"] < 2.0)


# -- the width seam --------------------------------------------------------


WIDTH_DIM, WIDTH_ROWS, VANISHED = 48, 10, (5,)


@contextlib.contextmanager
def _reveals():
    """Every ``reveal_aggregation`` output of the port's clients, in order."""
    from sda_tpu_torch.client import SdaClient

    outputs, real = [], SdaClient.reveal_aggregation

    def recorded(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        outputs.append(out)
        return out

    SdaClient.reveal_aggregation = recorded
    try:
        yield outputs
    finally:
        SdaClient.reveal_aggregation = real


def _reference_vanish(reference, tmp_path, params, values, monkeypatch):
    """The reference package's vanish round on one committee: its own
    ``Deployment`` and ``_setup_round`` at this width and prime, the
    seam's sequence after them; returns (degraded, full) reveals."""
    from sda_tpu.protocol import PackedShamirSharing

    p, w2, w3 = params
    monkeypatch.setattr(reference, "DIM", len(values[0]))
    monkeypatch.setattr(reference, "MODULUS", p)
    sharing = PackedShamirSharing(5, 8, 2, p, w2, w3)
    with reference.Deployment("mem", "inproc", tmp_path) as dep:
        recipient, clerks, agg = reference._setup_round(dep, sharing, reference._chacha(), tag="-w")
        participant = dep.client("subm-w")
        participant.upload_agent()
        participant.upload_participations(participant.new_participations(values, agg.id))
        recipient.end_aggregation(agg.id)
        for i, c in enumerate(clerks):
            if i not in VANISHED:
                c.run_chores(-1)
        partial = recipient.reveal_aggregation(agg.id)
        for i in VANISHED:
            clerks[i].run_chores(-1)
        return partial, recipient.reveal_aggregation(agg.id)


def test_width_seam_reveals_as_the_reference(reference, tmp_path, monkeypatch):
    """The seam with phase 25's committee shape (packed Shamir k=5, t=2,
    n=8, threshold 7, position 5 vanishing) at a small width: the port's
    degraded and full reveals equal numpy's sum, each other (dtype and
    values) and the reference package's two reveals on the same values.
    Both port reveals fold their masks through ``combine_masks_device``
    (the K2 path on the card; the threshold lowered here to reach it)."""
    from sda_tpu_torch.ops import find_packed_parameters
    from sda_tpu_torch.protocol import PackedShamirSharing

    params = find_packed_parameters(5, 2, 8, min_modulus_bits=30, seed=0)
    p = params[0]
    sharing = PackedShamirSharing(5, 8, 2, *params)
    values = list(np.random.default_rng(25).integers(0, p, size=(WIDTH_ROWS, WIDTH_DIM)))
    want = np.stack(values).sum(axis=0) % p

    folds = []
    real_combine = masking.combine_masks_device

    def counted(seeds, *args, **kwargs):
        folds.append(len(seeds))
        return real_combine(seeds, *args, **kwargs)

    monkeypatch.setattr(masking, "combine_masks_device", counted)
    monkeypatch.setattr(ChaChaMasker, "DEVICE_COMBINE_THRESHOLD", WIDTH_ROWS * WIDTH_DIM)
    with scenarios.Deployment("mem", "inproc", tmp_path / "port", device="cpu") as dep, \
            _reveals() as outputs:
        details = scenarios.scenario_vanish_after_sharing(
            dep, 0, cases={"packed": (sharing, VANISHED, values)})
    assert folds == [WIDTH_ROWS, WIDTH_ROWS]
    degraded, full = outputs
    assert details["packed"] == {"committee": 8, "vanished": [5], "threshold": 7,
                                 "aggregate": [int(v) for v in want]}
    assert np.array_equal(degraded.positive().values, want)
    assert full.values.dtype == degraded.values.dtype
    assert np.array_equal(full.values, degraded.values)

    ref_degraded, ref_full = _reference_vanish(reference, tmp_path / "ref", params, values,
                                               monkeypatch)
    assert np.array_equal(np.asarray(ref_degraded.positive().values), degraded.positive().values)
    assert np.array_equal(np.asarray(ref_full.positive().values), full.positive().values)


def test_width_seam_defaults_are_the_references_cases(reference):
    """Without ``cases`` the seam runs the reference's two committees on
    the reference's values."""
    cases = scenarios.vanish_cases()
    assert list(cases) == ["basic", "packed"]
    basic, packed = cases["basic"][0], cases["packed"][0]
    assert (basic.share_count, basic.privacy_threshold, basic.prime_modulus) == (5, 2, 433)
    assert (packed.secret_count, packed.share_count, packed.privacy_threshold, packed.prime_modulus,
            packed.omega_secrets, packed.omega_shares) == (3, 8, 4, 433, 354, 150)
    assert cases["basic"][1] == (0, 3) and cases["packed"][1] == (5,)
    for _, _, values in cases.values():
        assert values == [[i % 5, (i + 2) % 5, 1, 0] for i in range(5)]


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="checks the no-GPU refusal")
def test_deployment_clients_default_to_cuda_and_refuse_without_a_gpu(tmp_path):
    with scenarios.Deployment("mem", "inproc", tmp_path) as dep:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dep.client("recipient")


def test_helpers_have_one_copy_and_carry_the_device(tmp_path):
    """``flagship`` takes ``persistent_client`` from ``scenarios``, as the
    reference's does; a client rebound to another service keeps its
    identity, keystore and device."""
    from sda_tpu_torch.scripts import flagship
    from sda_tpu_torch.server import new_mem_server

    assert flagship.persistent_client is scenarios.persistent_client
    first = scenarios.persistent_client(tmp_path / "id", new_mem_server(), "cpu")
    again = scenarios.persistent_client(tmp_path / "id", new_mem_server(), "cpu")
    assert again.agent.id == first.agent.id
    moved = scenarios.rebind(first, new_mem_server())
    assert moved.agent is first.agent and moved.crypto.keystore is first.crypto.keystore
    assert moved.crypto.device == first.crypto.device == __import__("torch").device("cpu")
