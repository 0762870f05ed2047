"""The benchmark's own tests, on the CPU at tiny sizes:

    python3 -m pytest sdabench/tests -q

``tiny_root`` is a temporary checkout: a copy of ``sdabench/`` with the
real ``BENCHMARK.json``'s cells pointed at tiny configurations of the same
shape (the north star's 61-bit field over 40 x 25, the CNN round over 8
clients of a 26-parameter model). Tests that need the card carry the
``card`` marker and decide inside the test whether to skip.
"""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_LAYERS = {"b": {"kernel": [4, 2], "bias": [2]}, "a": {"kernel": [3, 4], "bias": [4]}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips inside the test without one")


def tiny_configs() -> dict:
    from sda_tpu_torch.ops import find_packed_parameters

    p, w_secrets, w_shares = find_packed_parameters(5, 2, 8, min_modulus_bits=24, seed=0)
    north = json.loads((REPO / "sdabench/configs/northstar-1m-100k.json").read_text())
    north.update(participants=40, dim=25)
    cnn = json.loads((REPO / "sdabench/configs/cnn-mnist-fedavg.json").read_text())
    cnn.update(participants=8, parameters=26, model={"layers": TINY_LAYERS})
    cnn["scheme"] = {**cnn["scheme"], "prime_modulus": p, "omega_secrets": w_secrets, "omega_shares": w_shares}
    return {"northstar-1m-100k": north, "cnn-mnist-fedavg": cnn}


def tiny_traffic() -> dict:
    sumfirst = json.loads((REPO / "sdabench/traffic/sumfirst.json").read_text())
    sumfirst.update(chunk=10, pool_chunks=3, warm_chunks=2)
    engine = json.loads((REPO / "sdabench/traffic/engine.json").read_text())
    engine.update(cohort=8, chunk=4, pool_cohorts=2, trace_units=2, kept_rounds=4)
    return {"sumfirst": sumfirst, "engine": engine}


def make_tiny_root(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "sdabench", root / "sdabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = copy.deepcopy(json.loads((REPO / "BENCHMARK.json").read_text()))
    for name, cfg in tiny_configs().items():
        entry = next(c for c in bench["configs"] if c["name"] == name)
        (root / entry["file"]).write_text(json.dumps(cfg))
    for name, mix in tiny_traffic().items():
        (root / "sdabench/traffic" / f"{name}.json").write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)
