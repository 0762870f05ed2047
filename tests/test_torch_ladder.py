"""``python -m sda_tpu_torch.baseline_ladder`` (the baseline ladder's device
rows) on the CPU, against the reference ladder ``scripts/baseline_ladder.py``
and the reference engine functions its rows call.

Each row's chunk step is held bit for bit against the reference's step on
the same numpy secrets, with the share randomness replayed through both
packages' ``draw=`` hooks: config 2's additive shares and mod-p clerk sums,
config 3's fused limb share and participant sum (K1's plain version here,
the tensors lying on the CPU), config 4's sum-first limb sums. Whole rows
run at small participant counts at the reference's full dimensions, beside
the reference's rows. Every result is a field element or an exact integer
sum: tolerance zero.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from sda_tpu.ops.jaxcfg import ensure_x64
from sda_tpu.parallel import engine as jeng
from sda_tpu.parallel import sumfirst as jsf
from sda_tpu.protocol import AdditiveSharing as JAdditive
from sda_tpu.protocol import BasicShamirSharing as JBasic
from sda_tpu.protocol import PackedShamirSharing as JPacked
from sda_tpu_torch import baseline_ladder as bl
from sda_tpu_torch.parallel import engine as teng
from sda_tpu_torch.parallel.sumfirst import clerk_sums_from_limb_acc, value_limb_sums_chunk
from sda_tpu_torch.protocol import AdditiveSharing, BasicShamirSharing

ensure_x64()

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.fixture(scope="module")
def ref_ladder():
    """The reference ladder, loaded from its file (it is not a package)."""
    spec = importlib.util.spec_from_file_location("ref_baseline_ladder",
                                                  ROOT / "scripts" / "baseline_ladder.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _schemes(config):
    """(port scheme, reference scheme, modulus) of a ladder row."""
    if config == "2":
        p = 4294967291
        return AdditiveSharing(share_count=3, modulus=p), JAdditive(share_count=3, modulus=p), p
    if config == "3":
        p = 1048583
        return (BasicShamirSharing(share_count=5, privacy_threshold=2, prime_modulus=p),
                JBasic(share_count=5, privacy_threshold=2, prime_modulus=p), p)
    ours = bl.config4_scheme()
    args = (ours.secret_count, ours.share_count, ours.privacy_threshold, ours.prime_modulus,
            ours.omega_secrets, ours.omega_shares)
    return ours, JPacked(*args), ours.prime_modulus


def _replay(rand):
    """Draw hooks that hand both packages the same host randomness."""
    return (lambda generator, shape, p: torch.as_tensor(rand),
            lambda key, shape, p: jnp.asarray(rand))


# -- (a) each row's step against the reference's, on replayed draws ------------


@pytest.mark.parametrize("config,dim", [("2", 100), ("2", 1001), ("3", 37), ("3", 1000),
                                        ("4", 23), ("4", 1000)])
def test_step_matches_reference_step(config, dim):
    ours, ref, p = _schemes(config)
    plan, rplan = teng.make_plan(ours, dim, CPU), jeng.make_plan(ref, dim)
    rng = np.random.default_rng(int(config) * 1000 + dim)
    acc = racc = None
    for rows in (7, 5):  # two chunks, accumulated as the row accumulates them
        secrets = rng.integers(0, p, size=(rows, dim))
        if config == "2":
            rand = rng.integers(0, p, size=(rows, plan.share_count - 1, dim))
            draw, rdraw = _replay(rand)
            if acc is None:
                acc = torch.zeros((plan.share_count, dim), dtype=torch.int64)
                racc = jnp.zeros((plan.share_count, dim), dtype=jnp.int64)
            acc = bl.config2_step(acc, torch.as_tensor(secrets), None, plan, draw=draw)
            shares = jeng.share_participants(jnp.asarray(secrets), None, rplan, draw=rdraw)
            racc = lax.rem(racc + jeng.clerk_combine_mod(shares, p), jnp.int64(p))
            continue
        rand = rng.integers(0, p, size=(rows, plan.n_batches, plan.rand_size))
        draw, rdraw = _replay(rand)
        if config == "3":
            a = teng.share_combine_limb_streamed(torch.as_tensor(secrets), None, plan, draw=draw)
            ra = jeng.share_combine_limb(jnp.asarray(secrets), None, rplan, draw=rdraw)
        else:
            a = value_limb_sums_chunk(torch.as_tensor(secrets), None, plan, draw=draw)
            ra = jsf.value_limb_sums_chunk(jnp.asarray(secrets), None, rplan, draw=rdraw)
        assert a.dtype == torch.int64
        acc = a if acc is None else acc + a
        racc = ra if racc is None else racc + ra
    np.testing.assert_array_equal(acc.numpy(), np.asarray(racc))


# -- (b) whole rows at small counts, beside the reference's rows ----------------


@pytest.mark.parametrize("config,participants", [("2", 4), ("3", 50), ("4", 600)])
def test_row_verified_beside_reference_row(ref_ladder, config, participants):
    ref_row = {"2": ref_ladder.config2_device, "3": ref_ladder.config3_device,
               "4": ref_ladder.config4}[config](participants)
    row = bl.ROWS[config](participants, CPU)
    assert row["verified"] is True and ref_row["verified"] is True
    assert row["backend"] == "cpu" and "partial" not in row
    assert (row["participants"], row["elements"]) == (ref_row["participants"], ref_row["elements"])
    # plain versions only on the CPU: no kernel launched
    assert row["launches"] == {"limb_share_sum": 0, "chacha20": 0}
    assert row["device_s"] is None and row["host_draw_s"] > 0


# -- (c) config 4 never reads the dropped clerk's row -------------------------


@pytest.mark.parametrize("garbage", [-7, 0, "p-1", "random"])
def test_config4_reveal_ignores_the_dropped_row(garbage):
    ours, ref, p = _schemes("4")
    dim = 60
    plan = teng.make_plan(ours, dim, CPU)
    rng = np.random.default_rng(44)
    secrets = rng.integers(0, p, size=(30, dim))
    clerk_sums, _ = clerk_sums_from_limb_acc(
        value_limb_sums_chunk(torch.as_tensor(secrets), torch.Generator().manual_seed(1), plan), plan)
    clean = clerk_sums.copy()
    if garbage == "p-1":
        garbage = p - 1
    elif garbage == "random":
        garbage = rng.integers(-(1 << 62), 1 << 62, size=clerk_sums.shape[1])
    clerk_sums[bl.DROPPED_CLERK] = garbage
    got = bl.dropout_reveal(clerk_sums, ours, dim)
    np.testing.assert_array_equal(got, secrets.sum(axis=0) % p)
    want = jsf.reconstruct_from_clerk_sums(clean, range(ours.share_count), ref, dim)
    np.testing.assert_array_equal(got, np.asarray(want) % p)


# -- (d) main on the CPU ----------------------------------------------------------


def _main(argv, capsys):
    rc = bl.main(argv)
    return rc, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("configs", ["1", "sumfirst-1m", "2,5"])
def test_main_refuses_other_configs(configs, capsys):
    with pytest.raises(SystemExit) as exc:
        bl.main(["--device", "cpu", "--configs", configs])
    assert exc.value.code == 2
    assert "supports configs 2,3,4 only" in capsys.readouterr().err


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    """One ``--quick`` ladder on the CPU with ``--out``: (rc, stdout
    payload, file payload)."""
    out = tmp_path_factory.mktemp("ladder") / "sub" / "ladder.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bl.main(["--device", "cpu", "--quick", "--out", str(out)])
    return rc, json.loads(buf.getvalue()), json.loads(out.read_text())


def test_main_quick_divides_counts_by_100(quick_run):
    rc, payload, _ = quick_run
    assert rc == 0 and payload["quick"] is True
    assert [c["participants"] for c in payload["configs"]] == [10, 100, 1_000]
    assert [c["elements"] for c in payload["configs"]] == [1_000_000, 1_000_000, 50_000_000]
    assert all(c["verified"] is True and "partial" not in c for c in payload["configs"])


def test_main_writes_out_and_names_the_device(quick_run):
    _, payload, written = quick_run
    assert written == payload
    assert payload["backend"] == "cpu" and payload["card"] is None and payload["power_limit"] is None


def test_main_budget_cut_row_is_partial_and_verified(monkeypatch, capsys):
    monkeypatch.setenv("SDA_LADDER_BUDGET", "0")
    monkeypatch.setitem(bl.CHUNKS, "2", 4)
    rc, payload = _main(["--device", "cpu", "--quick", "--configs", "2"], capsys)
    (row,) = payload["configs"]
    assert rc == 0
    assert row["partial"] is True and row["verified"] is True and row["participants"] == 4


def test_main_exits_1_on_an_unverified_row(monkeypatch, capsys):
    monkeypatch.setitem(bl.ROWS, "2", lambda n, device, budget: {"config": "2", "verified": False})
    rc, payload = _main(["--device", "cpu", "--quick", "--configs", "2,3"], capsys)
    assert rc == 1
    assert payload["configs"][0]["verified"] is False and payload["configs"][1]["verified"] is True


def test_main_records_a_raising_row_and_goes_on(monkeypatch, capsys):
    def boom(n, device, budget):
        raise ValueError("injected")

    monkeypatch.setitem(bl.ROWS, "3", boom)
    rc, payload = _main(["--device", "cpu", "--quick", "--configs", "3,2"], capsys)
    assert rc == 1
    assert payload["configs"][0] == {"config": "3", "error": "ValueError: injected"}
    assert payload["configs"][1]["verified"] is True


def test_main_watchdog_dumps_and_exits_3(tmp_path):
    out = tmp_path / "ladder.json"
    env = {**os.environ, "SDA_LADDER_DEADLINE": "0.001"}
    run = subprocess.run([sys.executable, "-m", "sda_tpu_torch.baseline_ladder", "--device", "cpu",
                          "--quick", "--configs", "4", "--out", str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 3, run.stderr[-2000:]
    payload = json.loads(run.stdout)
    assert "deadline" in payload["watchdog"] and payload["configs"] == []
    assert json.loads(out.read_text()) == payload


def test_main_without_a_gpu_exits_before_any_row(monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(bl.ROWS, "2", lambda *args: ran.append(args))
    assert bl.main(["--quick", "--configs", "2"]) == 2
    assert ran == [] and capsys.readouterr().out == ""
