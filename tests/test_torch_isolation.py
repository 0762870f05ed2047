"""The port stands alone: no module of ``sda_tpu_torch`` nor ``chip_smoke.py``
imports ``jax``, ``sda_tpu`` or ``requests`` (which the card's machine may
lack), or names a module of ``sda_tpu`` in a string (a ``-m`` argument, an
``import_module`` name), spawns one or puts the repo's ``tests/`` on
``sys.path``, none loads a system crypto library (``libcrypto``,
``libsodium``) and the native layer's C sources include, declare and open
none; entry points default to CUDA and raise without it; ``chip_smoke.py``
fails on a host without a GPU."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "sda_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "sda_tpu", "requests")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


#: ``sda_tpu`` or ``sda_tpu.<module>`` as a token: not ``sda_tpu_torch``, not
#: a path such as ``sda_tpu/ops/chacha_pallas.py``
REFERENCE_MODULE = re.compile(r"(?<![\w/.])sda_tpu(?:\.\w+)*(?![\w/])")


def _docstrings(tree) -> set:
    nodes = (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, nodes) and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_reference_module(path):
    """A string that names a module of the JAX package (the reference's
    shard rider spawns ``-m sda_tpu.cli.sdad``) would run the reference from
    the port: no string literal but a docstring may name one."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            found = REFERENCE_MODULE.search(node.value)
            assert not found, f"{path.relative_to(ROOT)}:{node.lineno} names {found.group(0)}"


@pytest.mark.parametrize("text, names", [
    ("sda_tpu.cli.sdad", True), ("-m sda_tpu.cli.sdad", True), ("sda_tpu", True),
    ("sda_tpu_torch.cli.sdad", False), ("sda_tpu/ops/chacha_pallas.py:47", False),
    ("bench-artifacts-torch", False),
])
def test_reference_module_pattern(text, names):
    assert bool(REFERENCE_MODULE.search(text)) is names


def test_model_plane_drivers_are_scanned():
    """The FedAvg drivers, server optimizers and DP module hold the port's
    own copies of reference code: the scan above covers each of them."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("federated", "optimizers", "dp", "trainer"):
        assert f"sda_tpu_torch/models/{name}.py" in scanned


def test_rest_plane_modules_are_scanned():
    """The REST deployment's modules hold the port's own copies of
    reference code: the scan above covers each of them."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("rest/wire", "rest/tokenstore", "rest/server", "rest/client",
                 "server/filestore", "server/sqlstore", "server/instrument", "telemetry/prom",
                 "telemetry/timeseries", "utils/faults", "utils/hashring", "cli/sda", "cli/sdad"):
        assert f"sda_tpu_torch/{name}.py" in scanned


def test_ingest_and_paillier_modules_are_scanned():
    """The ingest pipeline, the prefetch pipeline, the arrival traces and
    the Paillier arithmetic hold the port's own copies of reference code:
    the scan above covers each of them."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("client/ingest", "client/prefetch", "utils/arrivals", "ops/paillier"):
        assert f"sda_tpu_torch/{name}.py" in scanned


def test_rider_modules_are_scanned():
    """The bench's protocol-plane riders hold the port's own copies of
    ``bench.py``'s: both scans above cover each of them."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("__init__", "_common", "crypto", "ingest", "wire", "pipelines", "committee",
                 "scaleout", "tiers", "sketches"):
        assert f"sda_tpu_torch/riders/{name}.py" in scanned


def test_script_modules_are_scanned():
    """The CI gate's drivers hold the port's own copies of the reference's
    ``scripts/``: every scan here covers each of them."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("__init__", "check_metrics", "trace_report", "load_soak", "flagship", "soak",
                 "rest_ingest", "scenarios", "crash_soak"):
        assert f"sda_tpu_torch/scripts/{name}.py" in scanned


#: ``"-m", "sda_tpu.<module>"``: a spawn of a module of the JAX package
SPAWNS_REFERENCE = re.compile(r"""["']-m["']\s*,\s*["']sda_tpu\.""")


@pytest.mark.parametrize("text, spawns", [
    ('[sys.executable, "-m", "sda_tpu.cli.sdad"]', True), ("('-m','sda_tpu.bench')", True),
    ('[sys.executable, "-m", "sda_tpu_torch.cli.sdad"]', False),
])
def test_spawn_pattern(text, spawns):
    assert bool(SPAWNS_REFERENCE.search(text)) is spawns


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_spawns_a_reference_module(path):
    """Every process the port spawns runs the port (``-m
    sda_tpu_torch...``), never a module of the JAX package; docstrings
    included."""
    found = SPAWNS_REFERENCE.search(path.read_text())
    assert not found, f"{path.relative_to(ROOT)} spawns {found.group(0)}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_puts_tests_on_sys_path(path):
    """No port file reaches the repo's test helpers (which import the JAX
    package) by putting ``tests/`` on ``sys.path`` or ``PYTHONPATH``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if not isinstance(node, ast.Call):
            continue
        target = ast.unparse(node.func)
        if target in ("sys.path.insert", "sys.path.append", "sys.path.extend", "site.addsitedir"):
            assert "tests" not in ast.unparse(node), \
                f"{path.relative_to(ROOT)}:{node.lineno} puts tests/ on sys.path"
    assert not re.search(r"PYTHONPATH[^\n]*tests", path.read_text()), path


def test_no_port_file_loads_a_system_crypto_library():
    """The port's crypto is its own (sealed boxes, key generation, Ed25519
    signing and Paillier's modexp in the native layer's C, their plain
    versions in Python): no file looks up
    a system library by name, and every ctypes load opens
    ``str(library_path(...))``, a library the port built under
    ``build/sda_tpu_torch/`` from its own sources (the kernels from
    ``csrc/``, the native layer from ``native/``)."""
    loads = []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if not isinstance(node, ast.Call):
                continue
            name = getattr(node.func, "attr", getattr(node.func, "id", None))
            where = f"{path.relative_to(ROOT)}:{node.lineno}"
            assert name != "find_library", f"{where} looks up a system library"
            if name in ("CDLL", "LoadLibrary", "PyDLL", "WinDLL", "dlopen"):
                (arg,) = node.args
                assert ast.unparse(arg).startswith("str(library_path("), where
                loads.append(where)
    assert sorted(where.split(":")[0] for where in loads) == [
        "sda_tpu_torch/kernels.py", "sda_tpu_torch/native/__init__.py"]


C_SOURCES = sorted((ROOT / "sda_tpu_torch").rglob("*.c"))
#: the C standard library and POSIX threads, and the layer's own sources
C_HEADERS = ("stddef.h", "stdint.h", "stdlib.h", "string.h", "pthread.h", "sodium_prims.c",
             "curve25519_comb.c", "ed25519.c", "bignum.c")


def test_native_sources_are_scanned():
    names = {p.relative_to(ROOT).as_posix() for p in C_SOURCES}
    assert names == {f"sda_tpu_torch/native/{n}.c"
                     for n in ("_sdanative", "sodium_prims", "curve25519_comb", "ed25519",
                               "bignum")}


@pytest.mark.parametrize("path", C_SOURCES, ids=lambda p: p.name)
def test_native_sources_bind_no_system_library(path):
    """The C carries its own primitives: it includes no libsodium or
    OpenSSL header, opens no library at run time and declares no
    ``extern`` symbol (the reference's ``_sdanative.c`` declares
    libsodium's)."""
    text = path.read_text()
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', text, re.M)
    assert includes, path
    for header in includes:
        assert header in C_HEADERS, f"{path.name} includes {header}"
    assert "dlopen" not in text and "dlsym" not in text
    assert not re.search(r"^\s*extern\b", text, re.M), f"{path.name} declares an extern symbol"


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")


def test_import_leaves_jax_out():
    code = (
        "import sys, pkgutil, importlib, sda_tpu_torch\n"
        "for m in pkgutil.walk_packages(sda_tpu_torch.__path__, 'sda_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sda_tpu', 'requests')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('sda_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_default_device_raises_without_gpu():
    _no_gpu()
    from sda_tpu_torch import convert
    from sda_tpu_torch.device import resolve_device
    from sda_tpu_torch.parallel import TorchAggregator, make_plan
    from sda_tpu_torch.protocol import PackedShamirSharing

    scheme = PackedShamirSharing(3, 8, 4, 433, 354, 150)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchAggregator(scheme, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_plan(scheme, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.accumulator_from_reference([[[0]]])
    assert resolve_device("cpu") == torch.device("cpu")
    assert TorchAggregator(scheme, 10, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("module, argv", [
    ("check_metrics", []), ("load_soak", ["--duration", "1"]), ("flagship", ["--smoke"]),
    ("soak", ["1"]),
    ("scenarios", ["--scenarios", "register-never-submit", "--stores", "mem", "--transports",
                   "inproc"]),
    ("crash_soak", ["1"]),
])
def test_scripts_exit_2_without_gpu(module, argv, capsys):
    """A script that builds clients defaults to CUDA: without a GPU it
    exits 2 with ``resolve_device``'s message and runs nothing."""
    import importlib

    _no_gpu()
    script = importlib.import_module(f"sda_tpu_torch.scripts.{module}")
    with pytest.raises(SystemExit) as exc:
        script.main(argv)
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_chip_smoke_fails_without_gpu():
    _no_gpu()
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
