"""The one helper that starts a port ``sdad httpd`` for the riders and the
scripts: it runs ``python -m sda_tpu_torch.cli.sdad``, returns a URL that
answers, and reports an early exit with the daemon's stderr."""

import urllib.request

import pytest

from sda_tpu_torch.riders._common import SDAD_MODULE, start_sdad


def test_start_sdad_returns_a_live_frontend(tmp_path):
    proc, url = start_sdad(["--mem"], errlog=tmp_path / "sdad.stderr")
    try:
        assert proc.args[1:3] == ["-m", SDAD_MODULE] == ["-m", "sda_tpu_torch.cli.sdad"]
        with urllib.request.urlopen(url + "/v1/ping", timeout=10) as resp:
            assert resp.status == 200
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_start_sdad_reports_an_early_exit_with_its_stderr(tmp_path):
    tail = r"(?s)sdad exited rc=2; stderr tail:\n.*unrecognized arguments: --no-such-store"
    with pytest.raises(RuntimeError, match=tail):
        start_sdad(["--no-such-store"], errlog=tmp_path / "sdad.stderr")
