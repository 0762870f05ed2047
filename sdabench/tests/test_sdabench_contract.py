"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
against the file that the harness finds by that name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import REPO
from sdabench import catalog

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|per_tok")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert (REPO / path).is_dir() and not path.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(word) for word in BENCH["command"])
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:  # a file of the repo named by the command lies under paths
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"]) and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        body = catalog.config(BENCH, c["name"])
        assert body["reduced"] == c["reduced"]
        assert (REPO / "sdabench" / "reference" / f"{body['reference']}.py").is_file()


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        mix = catalog.traffic(w["traffic"])
        assert (REPO / "sdabench" / "loops" / f"{mix['loop']}.py").is_file()


def test_metrics_entries():
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e_names = {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in e2e if m["name"] == "setup_s")["bound"] == 0.25
    by_layer: dict = {}
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e_names and _line(m["layer"])
        by_layer.setdefault(m["layer"], []).append(m["name"])
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in catalog.metrics_of(BENCH, w["name"], trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert catalog.metrics_of(BENCH, w["name"], trace=True)
        for m in catalog.metrics_of(BENCH, w["name"], trace=True):
            assert m["moves"] in e2e


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_declares_its_entry(entry):
    module = catalog.metric(entry["name"])
    assert module.UNIT == entry["unit"] and module.SOURCE == entry["source"]
    if "layer" in entry:
        assert module.LAYER == entry["layer"] and module.MOVES == entry["moves"]
    assert callable(module.read)


def test_check_fits_the_budget():
    """A full check with 24 cells at this length fits 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
