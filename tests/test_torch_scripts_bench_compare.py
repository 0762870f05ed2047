"""The reference's ``scripts/bench_compare.py`` over the artifacts the
port's scripts bank on the CPU: a ``load_soak`` soak and a ``flagship
--smoke`` campaign parse into the same rider families, with the same
metrics, as the newest reference artifacts of those families in
``bench-artifacts/``, and the gate compares two of each without a
regression beyond its threshold. So neither ``bench_compare.py`` nor
``sweep_report.py`` needs a port."""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = ("soak", "flagship")


@pytest.fixture(scope="module")
def bench_compare():
    spec = importlib.util.spec_from_file_location("ref_bench_compare",
                                                  ROOT / "scripts" / "bench_compare.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def banked(tmp_path_factory):
    """The port's soak and flagship smoke, run side by side, banking into
    one directory."""
    root = tmp_path_factory.mktemp("banked")
    runs = [
        ["sda_tpu_torch.scripts.load_soak", "--duration", "2", "--rate", "40", "--round-size", "10",
         "--interval", "0.5", "--ab-rounds", "0"],
        ["sda_tpu_torch.scripts.flagship", "--smoke"],
    ]
    procs = [subprocess.Popen([sys.executable, "-m", *argv, "--device", "cpu", "--artifacts", str(root)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for argv in runs]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    return root


def _family(bench_compare, path: Path):
    matches = [fam for fam, (glob, _) in bench_compare.RIDERS.items() if path.match(glob)]
    assert len(matches) == 1, (path.name, matches)
    return matches[0]


@pytest.mark.parametrize("family", FAMILIES)
def test_port_artifacts_parse_into_the_references_families(family, banked, bench_compare):
    glob, extract = bench_compare.RIDERS[family]
    (ours,) = sorted(banked.glob(glob))
    newest_reference = sorted((ROOT / "bench-artifacts").glob(glob))[-1]
    assert _family(bench_compare, ours) == _family(bench_compare, newest_reference) == family
    got = extract(json.loads(ours.read_text()))
    want = extract(json.loads(newest_reference.read_text()))
    assert got and set(got) == set(want)


def test_gate_compares_the_port_artifacts(banked, tmp_path):
    """Two artifacts of each family (the banked one under an earlier stamp
    and itself): the gate compares both families and passes."""
    for family in FAMILIES:
        (path,) = sorted(banked.glob(f"{family}-*.json"))
        shutil.copy(path, tmp_path / path.name)
        shutil.copy(path, tmp_path / f"{family}-00000000-000000.json")
    out = subprocess.run([sys.executable, "scripts/bench_compare.py", str(tmp_path),
                          "--gate", ",".join(FAMILIES)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for family in FAMILIES:
        assert f"\n{family}: {family}-00000000-000000.json -> " in out.stdout
    assert "no throughput regressions beyond threshold" in out.stdout


SWEEP_LOADERS = {"soak": ("load_soak",), "flagship": ("load_flagship", "load_arrivals_ab",
                                                       "load_tier_close_ab")}


@pytest.mark.parametrize("family", FAMILIES)
def test_sweep_report_tabulates_the_port_artifacts(family, banked, tmp_path):
    """``scripts/sweep_report.py`` reads the port's artifact into rows with
    the columns it reads from the newest reference artifact."""
    spec = importlib.util.spec_from_file_location("ref_sweep_report",
                                                  ROOT / "scripts" / "sweep_report.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    (ours,) = sorted(banked.glob(f"{family}-*.json"))
    reference = tmp_path / "reference"
    reference.mkdir()
    shutil.copy(sorted((ROOT / "bench-artifacts").glob(f"{family}-*.json"))[-1], reference)
    for loader in SWEEP_LOADERS[family]:
        (got,) = getattr(sweep, loader)(banked)
        (want,) = getattr(sweep, loader)(reference)
        assert set(got) == set(want), loader
