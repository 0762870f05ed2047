"""``python -m sda_tpu_torch.bench`` (bench.py's device plane) on the CPU.

Each engine route's streamed accumulator is held against the reference's
chunk functions fed the same draws: the port's stream draws from a
``torch.Generator``, and the test replays that generator from the same seed
in the stream's order (secrets, then randomness) and hands the numbers to
the reference through its ``draw=`` hooks. The K1 route runs its plain
version here (the tensors lie on the CPU) and is held against the Pallas
kernel in interpret mode, as the JAX package's own tests run it. Every
result is a field element or an exact integer sum: tolerance zero.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from sda_tpu.ops.jaxcfg import ensure_x64
from sda_tpu.parallel import engine as jeng
from sda_tpu.parallel import sumfirst as jsf
from sda_tpu.parallel.limb_pallas import share_combine_limb_pallas
from sda_tpu.protocol import PackedShamirSharing as JPacked
from sda_tpu_torch import bench
from sda_tpu_torch.ops import find_packed_parameters
from sda_tpu_torch.ops import rng as trng
from sda_tpu_torch.parallel import engine as teng
from sda_tpu_torch.protocol import PackedShamirSharing

ensure_x64()

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--participants", "400", "--dim", "30", "--chunk", "100"]


def _bench_scheme(bits):
    p, w2, w3 = find_packed_parameters(5, 2, 8, min_modulus_bits=bits, seed=0)
    return PackedShamirSharing(5, 8, 2, p, w2, w3), JPacked(5, 8, 2, p, w2, w3)


def _plans(bits, dim):
    ours, ref = _bench_scheme(bits)
    return ours, teng.make_plan(ours, dim, "cpu"), jeng.make_plan(ref, dim)


def _plain_sum(secrets, p):
    return np.array([sum(int(v) for v in secrets[:, j]) % p for j in range(secrets.shape[1])],
                    dtype=np.int64)


def _cli(argv, env=None):
    # the device plane only: the protocol-plane riders have their own tests
    env = {**(env or os.environ), "SDA_BENCH_RIDERS": "0", "SDA_BENCH_ARTIFACTS": "0"}
    out = subprocess.run([sys.executable, "-m", "sda_tpu_torch.bench", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    return out.returncode, out.stdout.strip().splitlines(), out.stderr


@pytest.mark.parametrize("check", ["full", "probe", "off"])
def test_sumfirst_check_modes(check):
    """The narrow sum-first stream under each ``--check``: the accumulator
    equals the reference's ``value_limb_sums_chunk`` on the same draws; the
    check sums cover exactly ``range(0, dim, max(1, dim // 1024))`` (every
    column for ``full``, none for ``off``); finalize returns the plain sum
    and catches a corrupted check sum wherever there is one."""
    dim, chunk, n_chunks = 2100, 4, 2
    ours, tplan, jplan = _plans(30, dim)
    p = ours.prime_modulus
    nbits = p.bit_length() - 1
    step, acc, plain = bench.sumfirst_stream(tplan, dim, chunk, torch.Generator().manual_seed(3), check)
    for _ in range(n_chunks):
        acc, plain = step(acc, plain)

    replay = torch.Generator().manual_seed(3)
    jacc, secrets = 0, []
    for _ in range(n_chunks):
        s = trng.uniform_bits_device_narrow(replay, (chunk, dim), nbits).numpy()
        r = trng.uniform_bits_device_narrow(replay, (chunk, tplan.n_batches, 2), nbits).numpy()
        jacc = jacc + np.asarray(jsf.value_limb_sums_chunk(
            jnp.asarray(s), random.key(0), jplan, draw=lambda k, sh, m, r=r: jnp.asarray(r)))
        secrets.append(s.astype(np.int64))
    secrets = np.concatenate(secrets)
    np.testing.assert_array_equal(acc.numpy(), jacc)

    columns = {"full": range(dim), "probe": range(0, dim, max(1, dim // 1024)), "off": []}[check]
    assert bench.checked_columns(dim, check) == len(columns)
    if check == "off":
        np.testing.assert_array_equal(plain.numpy(), [0])
    else:
        np.testing.assert_array_equal(plain.numpy(), secrets[:, list(columns)].sum(axis=0))
    got = bench.sumfirst_finalize(acc, plain, tplan, ours, dim, check)
    np.testing.assert_array_equal(got, _plain_sum(secrets, p))
    if check != "off":
        assert bench.sumfirst_finalize(acc, plain + 1, tplan, ours, dim, check) is None


@pytest.mark.parametrize("dim", [100, 1024, 2047, 2048, 100_000])
def test_probe_columns_match_the_reference_definition(dim):
    """``--check probe`` covers bench.py's strided columns (bench.py:3488-3491)."""
    want = range(0, dim, max(1, dim // 1024))
    assert bench.checked_columns(dim, "probe") == len(want)
    assert bench.check_stride(dim, "probe") == want.step
    assert bench.checked_columns(dim, "full") == dim and bench.checked_columns(dim, "off") == 0


def _reference_chunk(route, s, r, jplan):
    """The reference's chunk function of ``route`` on secrets ``s`` and
    randomness ``r`` (numpy), as bench.py's participant body calls it."""
    draw = lambda key, shape, m: jnp.asarray(r)  # noqa: E731
    if route == "int64":
        shares = jeng.share_participants(jnp.asarray(s), random.key(0), jplan, False, draw=draw)
        return np.fmod(np.asarray(jeng.clerk_combine(shares)), jplan.modulus)
    fn = share_combine_limb_pallas if route == "kernel" else jeng.share_combine_limb
    return np.asarray(fn(jnp.asarray(s), random.key(0), jplan, draw=draw))


@pytest.mark.parametrize("route,bits", [("int64", 30), ("limbs", 30), ("kernel", 30), ("limbs", 60)],
                         ids=["int64", "limbs", "kernel", "wide"])
def test_participant_stream_matches_reference_chunks(route, bits):
    """Each participant route of the bench (``--no-limbs``, default,
    ``--kernel``, ``--wide``) at a few chunks of 40 x 23: the accumulator,
    reduced mod p after every chunk, equals the reference's chunk function
    (``share_participants`` + ``clerk_combine``, ``share_combine_limb``,
    ``share_combine_limb_pallas``) on the same draws, and finalize returns
    the plain sum mod p (and None once a surviving clerk's sum is off by
    one)."""
    dim, chunk, n_chunks = 23, 40, 3
    ours, tplan, jplan = _plans(bits, dim)
    p = ours.prime_modulus
    nbits = p.bit_length() - 1
    step, acc, plain = bench.participant_stream(tplan, dim, chunk, torch.Generator().manual_seed(5), route)
    for _ in range(n_chunks):
        acc, plain = step(acc, plain)

    narrow = route != "int64" and p <= (1 << 31)
    draw = trng.uniform_bits_device_narrow if narrow else trng.uniform_bits_device
    replay = torch.Generator().manual_seed(5)
    jacc, secrets = 0, []
    for _ in range(n_chunks):
        s = draw(replay, (chunk, dim), nbits).numpy()
        r = draw(replay, (chunk, tplan.n_batches, tplan.rand_size), nbits).numpy()
        jacc = np.fmod(jacc + _reference_chunk(route, s, r, jplan), p)
        secrets.append(s.astype(np.int64))
    assert acc.dtype == torch.int64
    np.testing.assert_array_equal(acc.numpy(), jacc)

    got = bench.participant_finalize(acc, plain, tplan, ours, dim)
    np.testing.assert_array_equal(got, _plain_sum(np.concatenate(secrets), p))
    bad = acc.clone()
    bad[(0, 0, 1) if bad.ndim == 3 else (1, 0)] += 1  # clerk 1's sum: clerk 0 is dropped
    assert bench.participant_finalize(bad, plain, tplan, ours, dim) is None


def _fill_model(shape, bits, cap):
    """bench.py's ``iota_fill_bits`` in numpy uint32 lanes."""
    r = np.arange(shape[0], dtype=np.uint32).reshape((-1,) + (1,) * (len(shape) - 1))
    c = np.arange(shape[-1], dtype=np.uint32)
    u = (r * np.uint32(2654435761) + c) & np.uint32((1 << min(bits, cap)) - 1)
    return np.broadcast_to(u, shape).astype(np.int64)


@pytest.mark.parametrize("bits", [31, 32])
def test_iota_fill_matches_uint32_model(bits):
    """The ``--roofline`` fill and its pair form equal a numpy uint32 model
    at 31 and 32 bits, on shapes whose rows wrap the 32-bit product: int32
    output capped at 31 bits (nonnegative), int64 at 32, and the pair's
    ``lo`` the full 32-bit mix as int32 bit patterns with ``hi`` its top
    field bits."""
    for shape in [(3001, 7), (41, 5, 2)]:
        narrow = bench.iota_fill_bits(shape, bits, torch.int32, "cpu")
        wide = bench.iota_fill_bits(shape, bits, torch.int64, "cpu")
        assert narrow.dtype == torch.int32 and wide.dtype == torch.int64
        assert int(narrow.min()) >= 0
        np.testing.assert_array_equal(narrow.numpy(), _fill_model(shape, bits, 31))
        np.testing.assert_array_equal(wide.numpy(), _fill_model(shape, bits, 32))
        nbits = 28 + bits  # 59- and 60-bit fields
        hi, lo = bench.iota_fill_pair(shape, nbits, "cpu")
        full = _fill_model(shape, 32, 32)
        np.testing.assert_array_equal(lo.numpy().view(np.uint32), full)
        np.testing.assert_array_equal(hi.numpy().view(np.uint32), full & ((1 << (nbits - 32)) - 1))


@pytest.mark.parametrize("engine", [["--engine", "sumfirst"], ["--engine", "participant", "--kernel"]],
                         ids=["sumfirst", "participant-kernel"])
def test_roofline_decomposition_names_the_stages(engine):
    """``--roofline`` times the segment full, without the check and with the
    fill, and names the binding stage among its three."""
    args = bench.parse_args([*engine, *TINY, "--no-parity", "--roofline"])
    line = bench.run(args)
    assert line["verified"] and line["launches"] == {"limb_share_sum": 0, "chacha20": 0}
    dec = line["roofline"]["decomposition"]
    stage3 = "limb_reduce" if engine[1] == "sumfirst" else "share_combine"
    assert dec["binding_stage"] in ("check", "rng_expand", stage3)
    for key in ("seg_full_s", "seg_nocheck_s", "seg_fill_s", "frac_check", "frac_rng_expand", f"frac_{stage3}"):
        assert dec[key] >= 0
    assert line["roofline"]["floor_s"] > 0 and line["peak_bytes"] is None and line["card"] is None


def test_cli_prints_one_verified_line():
    """The command line on the CPU, with the parity items: exactly one
    stdout line, a verified metric line, exit 0."""
    rc, lines, err = _cli(["--device", "cpu", "--participants", "4000", "--dim", "512", "--chunk", "1000"])
    assert rc == 0, err
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["verified"] is True and line["metric"] == bench.METRIC_NAME
    assert line["participants"] == 4000 and line["modulus_bits"] == 61 and line["segments"] == 4
    assert line["parity"] == {"chacha": "ok", "limb": "ok", "wide61": "ok"}
    assert "vs_baseline" not in line and "partial" not in line and line["value"] > 0


def test_injected_fault_exits_1():
    """``SDA_BENCH_INJECT_FAULT`` corrupts one accumulator cell: the run must
    print an error line and exit 1."""
    rc, lines, err = _cli([*TINY, "--no-parity"], env={**os.environ, "SDA_BENCH_INJECT_FAULT": "1"})
    assert rc == 1, err
    line = json.loads(lines[-1])
    assert line["value"] == 0 and line["error"].startswith("verification failed")
    assert "FAULT INJECTED" in err


def test_failed_parity_item_fails_the_run(monkeypatch, capsys):
    """Unlike bench.py, a parity item that disagrees fails the run: an
    error line naming the item and exit 1, before any stream runs."""
    real = bench.limb_cuda.share_combine_limb_cuda
    monkeypatch.setattr(bench.limb_cuda, "share_combine_limb_cuda", lambda *a, **k: real(*a, **k) + 1)
    monkeypatch.setenv("SDA_BENCH_RIDERS", "0")
    assert bench.main(["--device", "cpu", "--participants", "400", "--dim", "30", "--chunk", "100"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0 and line["error"].startswith("parity limb")


def test_deadline_exits_2():
    """``--deadline``: nothing measured in time -> an error line and exit 2."""
    rc, lines, _ = _cli([*TINY, "--deadline", "0.001"])
    assert rc == 2
    assert json.loads(lines[-1])["error"].startswith("deadline")


def test_exits_nonzero_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    rc, lines, _ = _cli(["--quick", "--no-parity"])
    assert rc == 2
    assert "no CUDA device" in json.loads(lines[-1])["error"]


@pytest.mark.parametrize("argv", [
    ["--kernel", "--wide", "--engine", "participant"],
    ["--kernel"],
    ["--kernel", "--engine", "participant", "--no-limbs"],
    ["--check", "probe", "--engine", "participant"],
    ["--check", "off", "--no-limbs"],
    ["--no-limbs", "--engine", "sumfirst"],
    ["--quick", "--northstar"],
], ids=lambda a: " ".join(a))
def test_refusals(argv):
    """bench.py's ``parser.error`` rules, with ``--kernel`` for ``--pallas``."""
    with pytest.raises(SystemExit) as exc:
        bench.parse_args(argv)
    assert exc.value.code == 2


def test_presets():
    """The north star by default (61-bit), the participant engine and
    ``--quick`` at 100,000 x 10,000 in chunks of 2,000; explicit flags win."""
    north = bench.parse_args([])
    assert (north.engine, north.participants, north.dim, north.chunk, north.wide) == (
        "sumfirst", 1_000_000, 100_000, 500, True)
    part = bench.parse_args(["--engine", "participant", "--kernel"])
    assert (part.participants, part.dim, part.chunk, part.wide) == (100_000, 10_000, 2_000, False)
    assert bench.parse_args(["--no-limbs"]).engine == "participant"
    quick = bench.parse_args(["--quick", "--dim", "77"])
    assert (quick.participants, quick.dim, quick.chunk, quick.wide) == (100_000, 77, 2_000, False)
    assert bench.parse_args(["--engine", "participant", "--northstar"]).wide
