"""Finds every part of the benchmark by the name ``BENCHMARK.json`` gives it.

``root`` is the checkout's root (the directory that holds ``BENCHMARK.json``
and ``sdabench/``); tests pass a temporary copy. Nothing here imports torch.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class CatalogError(ValueError):
    """A name that ``BENCHMARK.json`` or the files under ``sdabench/`` lack."""


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise CatalogError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise CatalogError(f"unknown {what} {name!r}; known: {[e['name'] for e in entries]}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file as it is run, with its entry's ``name``."""
    entry = _named(bench["configs"], name, "configuration")
    return {**json.loads((Path(root) / entry["file"]).read_text()), "name": name}


def traffic(name: str, root: Path = ROOT) -> dict:
    path = Path(root) / "sdabench" / "traffic" / f"{name}.json"
    if not path.is_file():
        raise CatalogError(f"no traffic mix {name!r} ({path})")
    return {**json.loads(path.read_text()), "name": name}


def _module(kind: str, name: str, root: Path):
    """``sdabench/<kind>/<name>.py`` loaded by its path (a metric's name may
    hold dots), once per process and path."""
    path = Path(root) / "sdabench" / kind / f"{name}.py"
    if not path.is_file():
        raise CatalogError(f"no {kind[:-1]} {name!r} ({path})")
    key = f"sdabench_{kind}_{abs(hash(str(path.resolve())))}_{name.replace('.', '_').replace('-', '_')}"
    module = sys.modules.get(key)
    if module is None:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module  # dataclasses look their module up here
        spec.loader.exec_module(module)
    return module


def loop(name: str, root: Path = ROOT):
    return _module("loops", name, root)


def metric(name: str, root: Path = ROOT):
    return _module("metrics", name, root)


def reference(name: str, root: Path = ROOT):
    return _module("reference", name, root)


def metrics_of(bench: dict, workload_name: str, trace: bool) -> list:
    """The cell's metrics for a run: its end-to-end ones with ``trace``
    off, its per-layer ones with it on. An entry without ``workloads``
    applies to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if workload_name in m.get("workloads", [workload_name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload_name in m.get("workloads", [workload_name] if m["moves"] in reported else [])]
