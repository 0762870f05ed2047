"""The port's CLIs (``sda_tpu_torch/cli``) against ``scripts/
simple-cli-example.sh`` and ``sda_tpu/cli``: the walkthrough on the port's
``sda`` with ``--device cpu`` reveals ``0 2 2 4 4 6 6 8 8 10`` (each step
called in process, the committee drained by ``sda clerk --once`` or by
``sdad committee --once``); a recipient identity made by the reference's
``agent create`` and ``keys create`` serves the port's CLI; ``python -m
sda_tpu_torch.cli.sdad`` starts as a process and prints its ``listening``
line, and with ``--shards 2 --replicas 2`` serves the walkthrough over a
sharded, replicated store; a missing GPU is refused."""

from __future__ import annotations

import contextlib
import io
import os
import select
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from sda_tpu.cli import sda as jsda
from sda_tpu_torch.cli import sda, sdad
from sda_tpu_torch.rest import SdaHttpClient, TokenStore, serve_background
from sda_tpu_torch.server import new_file_server

ROOT = Path(__file__).resolve().parent.parent
AGG = "ad3142d8-9a83-4f40-a64a-a8c90b701bde"
EXPECTED = "result: 0 2 2 4 4 6 6 8 8 10"


def _run(main, url, identity, *argv, device=("--device", "cpu")):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["-s", url, *device, "-i", str(identity), *argv])
    assert rc == 0, (argv, out.getvalue())
    return out.getvalue()


def _walkthrough(url, data, drain, reference_recipient=False):
    """The steps of scripts/simple-cli-example.sh; ``drain(clerk dirs)``
    runs the committee. Returns the reveal's printed line."""
    port = lambda who, *argv: _run(sda.main, url, data / who, *argv)  # noqa: E731
    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        if who == "recipient" and reference_recipient:
            _run(jsda.main, url, data / who, "agent", "create", device=())
            _run(jsda.main, url, data / who, "agent", "keys", "create", device=())
            continue
        port(who, "agent", "create")
        port(who, "agent", "keys", "create")
    for who in ("part-1", "part-2", "part-3"):
        port(who, "agent", "create")
    key = next(f.stem for f in (data / "recipient" / "keys").glob("*.json") if '"ek"' in f.read_text())
    assert port("recipient", "aggregations", "create", "--id", AGG, "aggro", "10", "433", key, "3") \
        == f"aggregation created. id: {AGG}\n"
    port("recipient", "aggregations", "begin", AGG)
    port("part-1", "participate", AGG, *map(str, range(10)))
    port("part-2", "participate", AGG, *["0"] * 10)
    port("part-3", "participate", AGG, *["0", "1"] * 5)
    port("recipient", "aggregations", "end", AGG)
    drain([data / who for who in ("recipient", "clerk-1", "clerk-2", "clerk-3")])
    return port("recipient", "aggregations", "reveal", AGG).strip()


@pytest.fixture
def file_server(tmp_path):
    with serve_background(new_file_server(str(tmp_path / "server"))) as url:
        yield url, tmp_path / "agent"


def test_walkthrough_with_sda_clerk(file_server):
    url, data = file_server

    def drain(dirs):
        for d in dirs:
            _run(sda.main, url, d, "clerk", "--once")

    assert _walkthrough(url, data, drain) == EXPECTED


def test_walkthrough_with_sdad_committee_and_a_reference_identity(file_server):
    """The recipient's identity and keys come from the reference's CLI; the
    committee (recipient included) is drained by one ``sdad committee``."""
    url, data = file_server

    def drain(dirs):
        argv = ["committee", "-s", url, "--once", "--device", "cpu"]
        for d in dirs:
            argv += ["-i", str(d)]
        assert sdad.main(argv) == 0

    assert _walkthrough(url, data, drain, reference_recipient=True) == EXPECTED
    shown = _run(sda.main, url, data / "recipient", "agent", "show")
    assert shown == _run(jsda.main, url, data / "recipient", "agent", "show", device=())


def test_profile_and_keys_commands(file_server):
    url, data = file_server
    _run(sda.main, url, data / "alice", "agent", "create")
    key = _run(sda.main, url, data / "alice", "agent", "keys", "create").split(": ")[1].strip()
    assert key in _run(sda.main, url, data / "alice", "agent", "keys", "show")
    _run(sda.main, url, data / "alice", "agent", "profile", "set", "--name", "alice",
         "--website", "https://a.example")
    _run(sda.main, url, data / "alice", "agent", "profile", "set", "--name", "al")
    assert _run(sda.main, url, data / "alice", "agent", "profile", "show") == \
        "name: al\nwebsite: https://a.example\n"
    _run(sda.main, url, data / "alice", "ping")


def test_sda_needs_a_gpu_unless_asked_for_the_cpu(file_server):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    url, data = file_server
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sda.main(["-s", url, "-i", str(data / "x"), "ping"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sdad.main(["committee", "-s", url, "--once", "-i", str(data / "x")])


def _spawn_sdad(*argv):
    """Start ``python -m sda_tpu_torch.cli.sdad ARGV`` and return the
    process and the URL of its ``listening`` line."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sda_tpu_torch.cli.sdad", *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline, line = time.monotonic() + 60, ""
    while time.monotonic() < deadline and not line.startswith("sdad: listening on "):
        if select.select([proc.stdout], [], [], 1.0)[0]:
            line = proc.stdout.readline()
    if not line.startswith("sdad: listening on "):
        proc.terminate()
        raise AssertionError(proc.stderr.read() if proc.poll() is not None else line)
    return proc, "http://" + line.split("listening on ", 1)[1].strip()


def test_sdad_refuses_shards(tmp_path):
    """``sdad --sqlite ROOT --shards 2 --replicas 2 httpd`` serves the CLI
    walkthrough as ``sda_tpu``'s sdad does, and lays the shards out as
    ``sda_tpu`` does: ``shard-00.db`` and ``shard-01.db`` under ROOT."""
    root = tmp_path / "store"
    proc, url = _spawn_sdad("--sqlite", str(root), "--shards", "2", "--replicas", "2",
                            "httpd", "-b", "127.0.0.1:0")
    try:
        def drain(dirs):
            for d in dirs:
                _run(sda.main, url, d, "clerk", "--once")

        assert _walkthrough(url, tmp_path / "agent", drain) == EXPECTED
    finally:
        proc.terminate()
        proc.wait(timeout=20)
    assert sorted(p.name for p in root.glob("shard-*.db")) == ["shard-00.db", "shard-01.db"]


def test_sdad_module_entry(tmp_path):
    """``python -m sda_tpu_torch.cli.sdad --sqlite DB httpd -b 127.0.0.1:0``:
    the parent parses the ``listening`` line and the port's client talks to
    it; terminating the process stops it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sda_tpu_torch.cli.sdad", "--sqlite", str(tmp_path / "sda.db"),
         "httpd", "-b", "127.0.0.1:0"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline, line = time.monotonic() + 60, ""
        while time.monotonic() < deadline and not line.startswith("sdad: listening on "):
            if select.select([proc.stdout], [], [], 1.0)[0]:
                line = proc.stdout.readline()
        assert line.startswith("sdad: listening on "), proc.stderr.read() if proc.poll() else line
        url = "http://" + line.split("listening on ", 1)[1].strip()
        assert SdaHttpClient(url, TokenStore(tmp_path / "t")).ping().running
        assert (tmp_path / "sda.db").exists()
    finally:
        proc.terminate()
        proc.wait(timeout=20)
    assert proc.returncode is not None
