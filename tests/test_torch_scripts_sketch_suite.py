"""``python -m sda_tpu_torch.examples.sketch_suite`` over REST against the
reference's ``examples/sketch_suite.py``: on the memory and the sqlite
store the five sketch rounds run through ``serve_background`` and
``SdaHttpClient``, and the JSON summary equals the reference's; the
summary passes the reference CI's sketch-stage checks."""

import importlib.util
import json
import os
import sys
from pathlib import Path

import pytest

from sda_tpu_torch.examples import sketch_suite

ROOT = Path(__file__).resolve().parent.parent


def _reference_summary(store, out, monkeypatch):
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location("ref_sketch_suite",
                                                      ROOT / "examples" / "sketch_suite.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        monkeypatch.setattr(sys, "argv", ["sketch_suite.py", "--store", store, "--json", str(out)])
        assert module.main() == 0
    finally:
        os.environ.clear()
        os.environ.update(env)
    return json.loads(out.read_text())


def _ci_checks(d) -> None:
    """The reference CI's checks of the banked summary."""
    cm = d["countmin"]
    for app, est in cm["hits"].items():
        assert cm["true"][app] <= est <= cm["true"][app] + cm["bound"]
    cs = d["countsketch"]
    for app, est in cs["estimates"].items():
        assert abs(est - cs["true"][app]) <= cs["bound"]
    qt = d["quantiles"]
    assert qt["ranks"]
    for r in qt["ranks"].values():
        assert r["lo"] - qt["rank_bound"] <= r["target"] <= r["hi"] + qt["rank_bound"]
    lc = d["cardinality"]
    assert abs(lc["estimate"] - lc["true"]) <= lc["bound"]
    tk = d["topk"]
    assert {a for a, _ in tk["topk"]} == set(tk["true_hot"])


@pytest.mark.parametrize("store", ["sqlite", "mem"])
def test_summary_over_rest_is_the_references(store, tmp_path, monkeypatch, capsys):
    out = tmp_path / "ours.json"
    assert sketch_suite.main(["--store", store, "--device", "cpu", "--json", str(out)]) == 0
    assert capsys.readouterr().out.startswith(f"live REST stack at http://127.0.0.1:")
    ours = json.loads(out.read_text())
    assert ours["store"] == store
    _ci_checks(ours)
    assert ours == _reference_summary(store, tmp_path / "theirs.json", monkeypatch)


def test_every_client_rides_http(tmp_path, monkeypatch):
    """No round reaches the service but through ``SdaHttpClient``."""
    from sda_tpu_torch.rest import client as rest_client

    calls = []
    real = rest_client.SdaHttpClient.__init__

    def counting(self, *args, **kwargs):
        calls.append(args[0])
        real(self, *args, **kwargs)

    monkeypatch.setattr(rest_client.SdaHttpClient, "__init__", counting)
    sketch_suite.run("cpu", store="mem")
    assert calls and all(str(url).startswith("http://127.0.0.1:") for url in calls)
