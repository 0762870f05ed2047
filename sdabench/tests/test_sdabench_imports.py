"""No module that the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level names are compared whole:
``sda_tpu_torch`` begins with ``sda_tpu`` and is the port, not the JAX
package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from conftest import REPO
from sdabench import harness

PACKAGE = REPO / "sdabench"
MODULES = sorted(p for p in PACKAGE.rglob("*.py") if "tests" not in p.relative_to(PACKAGE).parts)
REFERENCE = sorted((PACKAGE / "reference").glob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "sda_tpu"}


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_whole_name_is_compared():
    assert harness.forbidden_modules(["sda_tpu_torch", "sda_tpu_torch.ops", "sdabench"]) == []
    assert harness.forbidden_modules(["sda_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "sda_tpu"]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def reference_imports(path) -> set:
    """Top-level names, but the benchmark's own modules named whole: a
    reference may share the ``sdabench.reference`` modules and nothing else
    of the benchmark."""
    names = top_level_imports(path) - {"sdabench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module.split(".")[0] == "sdabench":
            names |= {f"{node.module}.{alias.name}" for alias in node.names}
        elif isinstance(node, ast.Import):
            names |= {alias.name for alias in node.names if alias.name.split(".")[0] == "sdabench"}
    return names


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    """Plain libraries, and the reference's own modules beside it."""
    own = {f"sdabench.reference.{p.stem}" for p in REFERENCE}
    assert reference_imports(path) <= {"__future__", "math", "numpy", "torch"} | own


def test_a_run_loads_none_of_them(tmp_path):
    """Both cells run at tiny sizes in a fresh process, which then holds no
    forbidden module."""
    code = f"""
import json, sys, time
from pathlib import Path
sys.path[:0] = [{str(REPO)!r}, {str(REPO / "sdabench" / "tests")!r}]
import conftest
from sdabench import catalog, harness
root = conftest.make_tiny_root(Path({str(tmp_path)!r}))
bench = catalog.load_benchmark(root)
ok = []
for w in bench["workloads"]:
    for trace in (False, True):
        r = harness.run_cell(bench, w, seed=7, seconds=0.2, trace=trace, device="cpu", t0=time.perf_counter(),
                             root=root)
        ok.append(r["correct"])
print(json.dumps({{"ok": ok, "forbidden": harness.forbidden_modules()}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"ok": [True] * 4, "forbidden": []}
