"""The port's examples against the reference's (``examples/``) on the CPU.

``python -m sda_tpu_torch.examples.secure_sum_fabric`` against the
reference demo ``examples/secure_sum_fabric.py``:

The port runs with ``--device cpu``: stages 1 and 2 in this process, stage 3
over 8 gloo ranks (one spawn, in a module fixture) as a 4 x 2 mesh. The
reference runs on the 8 virtual CPU devices of tests/conftest.py, so it fits
the same 4 x 2 mesh. Both draw the same secrets from ``default_rng(0)`` and
verify each stage against the plain sum; their stage lines must be
identical.

The protocol-plane examples (``federated_training``, ``federated_analytics``,
``sketch_suite``) run their ``main`` with ``--device cpu`` and must print
the reference example's lines, but for the lines that carry a DP noise draw
(the port's generator is not numpy's stream), a temporary path, or the
address of the server the sketch suite runs over.
"""

import contextlib
import importlib
import importlib.util
import io
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sda_tpu_torch.examples import secure_sum_fabric as demo

ROOT = Path(__file__).resolve().parent.parent


def _lines(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    assert rc in (None, 0)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def port_lines():
    return _lines(lambda: demo.main(["--device", "cpu"]))


@pytest.fixture(scope="module")
def ref_lines():
    """The reference demo, loaded from its file; its module top sets jax's
    platform variables, which are put back afterwards."""
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location("ref_secure_sum_fabric",
                                                      ROOT / "examples" / "secure_sum_fabric.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return _lines(module.main)
    finally:
        os.environ.clear()
        os.environ.update(env)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_line_matches_reference(port_lines, ref_lines, stage):
    assert len(port_lines) == len(ref_lines) == 3
    assert port_lines[stage - 1] == ref_lines[stage - 1]
    assert port_lines[stage - 1].startswith(f"{stage}. ") and " OK: " in port_lines[stage - 1]


def test_cpu_ranks_fit_the_reference_mesh(port_lines):
    assert "mesh p=4 x d=2" in port_lines[2]


def test_ranks_replay_stage_3_secrets():
    """The ranks' replay of stage 3's secrets is the array the reference
    demo draws after stages 1 and 2 (examples/secure_sum_fabric.py:76, 89, 111)."""
    p = demo._scheme().prime_modulus
    rng = np.random.default_rng(0)
    rng.integers(0, p, size=(256, 2_000))
    for _ in range(0, 2_048, 512):
        rng.integers(0, p, size=(512, 2_000))
    want = rng.integers(0, p, size=(1_024, 2_000))
    np.testing.assert_array_equal(demo._stage3_shard(p), want)


def test_without_a_gpu_exits_2_before_any_stage(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert demo.main([]) == 2
    assert capsys.readouterr().out == ""


# the lines each protocol-plane example prints that differ by design: a DP
# draw, a temporary path, the server's address and the summary's path
UNSHARED = {
    "federated_training": re.compile(r"^(DP training|checkpoints in)"),
    "federated_analytics": re.compile(r"^DP latency histogram"),
    "sketch_suite": re.compile(r"^(live REST stack|summary written)"),
}


def _reference_lines(name, monkeypatch) -> list[str]:
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "examples" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        monkeypatch.setattr(sys, "argv", [f"{name}.py"])
        return _lines(module.main)
    finally:
        os.environ.clear()
        os.environ.update(env)


@pytest.mark.parametrize("name", sorted(UNSHARED))
def test_protocol_example_prints_the_reference_lines(name, monkeypatch):
    module = importlib.import_module(f"sda_tpu_torch.examples.{name}")
    ours = _lines(lambda: module.main(["--device", "cpu"]))
    theirs = _reference_lines(name, monkeypatch)
    assert len(ours) == len(theirs)
    shared = [(a, b) for a, b in zip(ours, theirs) if not UNSHARED[name].match(b)]
    assert len(shared) >= len(ours) - 2
    for a, b in shared:
        assert a == b


@pytest.mark.parametrize("name", sorted(UNSHARED))
def test_protocol_example_without_a_gpu_exits_2(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"sda_tpu_torch.examples.{name}")
    assert module.main([]) == 2
    assert capsys.readouterr().out == ""
