"""``python -m sda_tpu_torch.scripts.check_metrics`` against the reference's
``scripts/check_metrics.py``: the same required series and line grammar,
the same verdicts from ``check_exposition`` on fixed good and bad lines,
and a whole ``--device cpu`` run that finds every series and exits 0."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

from sda_tpu_torch.scripts import check_metrics

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_check_metrics",
                                                  ROOT / "scripts" / "check_metrics.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_required_series_and_grammar_are_the_references(reference):
    assert check_metrics.REQUIRED_SERIES == reference.REQUIRED_SERIES
    assert len(check_metrics.REQUIRED_SERIES) == 26
    assert check_metrics._LINE.pattern == reference._LINE.pattern


_ALL_SERIES = "".join(f"{name} 1\n" for name in check_metrics.REQUIRED_SERIES)

EXPOSITIONS = {
    "every series": _ALL_SERIES,
    "help and type lines": "# HELP sda_x A help text.\n# TYPE sda_x counter\n" + _ALL_SERIES,
    "labels with braces in a value": 'sda_http_requests_total{route="/v1/agents/{id}",code="200"} 3\n'
                                     + _ALL_SERIES,
    "histogram suffixes": "".join(f"{n}_bucket{{le=\"+Inf\"}} 2\n{n}_sum 0.5\n{n}_count 2\n"
                                  for n in check_metrics.REQUIRED_SERIES),
    "special values": "sda_a +Inf\nsda_b NaN\nsda_c -1.5e-3\n" + _ALL_SERIES,
    "no trailing newline": _ALL_SERIES.rstrip("\n"),
    "one series missing": "".join(f"{name} 1\n" for name in check_metrics.REQUIRED_SERIES[1:]),
    "empty": "",
    "bad metric name": "9sda 1\n" + _ALL_SERIES,
    "unquoted label": "sda_x{route=/v1} 1\n" + _ALL_SERIES,
    "no value": "sda_x\n" + _ALL_SERIES,
    "bad comment": "# NOTE free text\n" + _ALL_SERIES,
    "escaped quote in a label": 'sda_x{a="q\\"uote"} 1\n' + _ALL_SERIES,
}


@pytest.mark.parametrize("label", sorted(EXPOSITIONS))
def test_check_exposition_gives_the_references_errors(label, reference):
    text = EXPOSITIONS[label]
    assert check_metrics.check_exposition(text) == reference.check_exposition(text)


def test_label_errors_name_each_missing_label():
    body = ('sda_tier_promotions_total{path="reveal"} 1\n'
            'sda_tier_close_seconds_count{mode="serial"} 1\n')
    errors = check_metrics.label_errors(body)
    assert len(errors) == 2
    assert 'path="reshare"' in errors[0] and 'mode="fanout"' in errors[1]
    assert check_metrics.label_errors(
        body + 'sda_tier_promotions_total{path="reshare"} 1\n'
        'sda_tier_close_seconds_count{le="1",mode="fanout"} 1\n') == []


def test_cpu_run_finds_every_series():
    out = subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.scripts.check_metrics", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("check_metrics OK: ")
    assert all(name in line for name in check_metrics.REQUIRED_SERIES)

