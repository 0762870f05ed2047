"""One run of one cell: set-up, the measured window, the check against the
plain reference, one JSON line.

    python3 -m sdabench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``) runs from the start of ``main`` to the window's start:
the imports, the pools drawn on the card, the port's plan and kernels
(built once into ``build/`` inside the checkout, then loaded), and the
warm-up of the cell's own shapes. The window runs whole units (aggregates
or rounds) back to back and closes after the last one that ends within
``--seconds``. Then the peak memory is read, the program's state freed,
and the reference judges every unit of the window. The numbers compared
go to stderr, beside their limits, as its last lines, and into the result
line under ``checks``, its last key. The result line is stdout's last.

Exit codes: 0 with a result (``correct`` true or false); 2 without a CUDA
device, with fewer than the cell asks for, or without the port; 3 when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from . import catalog

#: top-level module names that must not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "sda_tpu")


def log(text: str) -> None:
    print(f"[sdabench] {text}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python3 -m sdabench", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def read_metrics(entries: list, run, root: Path) -> dict:
    """Each entry's reader over the run; a reader that finds nothing to
    read leaves its metric out."""
    out = {}
    for entry in entries:
        value = catalog.metric(entry["name"], root).read(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def run_cell(bench: dict, workload: dict, *, seed: int, seconds: float, trace: bool, device,
             t0: float, root: Path = catalog.ROOT, control: bool = False) -> dict:
    """One run of ``workload`` on ``device``; returns the result line.
    With ``control``, the reference's control (``reference.control``) takes
    the place of the system under test."""
    import torch

    from .tracing import Tracer

    cfg = catalog.config(bench, workload["config"], root)
    mix = catalog.traffic(workload["traffic"], root)
    loop = catalog.loop(mix["loop"], root)
    reference = catalog.reference(cfg["reference"], root)
    cuda = torch.device(device).type == "cuda"
    tracer = Tracer(trace, device)
    program = reference.control(cfg, device) if control else None
    t_cell = time.perf_counter()
    cell = loop.Cell(cfg, mix, seed, device, tracer, reference, program)
    if cuda:
        torch.cuda.synchronize()
    t_warm = time.perf_counter()
    cell.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"{workload['name']}: set-up {setup_s:.3f} s (before the cell {t_cell - t0:.3f}, inputs and plan "
        f"{t_warm - t_cell:.3f}, warm-up {t0 + setup_s - t_warm:.3f}); window of {seconds} s")
    run = cell.window(seconds)
    run.setup_s = setup_s
    walls = sorted(u.wall_s for u in run.units)
    log(f"{len(walls)} units in {run.window_s:.3f} s; wall min {walls[0]:.6f}, median "
        f"{walls[len(walls) // 2]:.6f}, max {walls[-1]:.6f} s")
    for name, values in run.host_s.items():
        log(f"{name}: {len(values)} in {sum(values):.6f} s on the host clock")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    cell.release()
    if trace:
        run.trace = tracer.summary()
    checks, failed = cell.check()
    entries = catalog.metrics_of(bench, workload["name"], trace)
    result = {
        "correct": failed == 0 and all(v is not None and v <= limit for v, limit in checks.values()),
        "attempted": len(run.units),
        "failed": failed,
        "metrics": read_metrics(entries, run, root),
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": workload["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
        log(f"traced units {run.trace.units}: device seconds by span {run.trace.span_device_s}")
        if run.trace.unattributed_ops:
            log(f"{run.trace.unattributed_ops} device ops in the trace had no launch record")
        log(f"kernel launches counted by the port and device records in the trace: {run.trace.kernel_launches}; "
            f"kernel launches without a device record: {run.trace.orphan_launches}")
        if run.trace.missing_records:
            log(f"the trace lacks {run.trace.missing_records} device records: its metrics are left out")
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    return result


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = parse_args(argv)
    bench = catalog.load_benchmark()
    wl = catalog.workload(bench, args.workload)
    import torch

    log(f"torch imported at {time.perf_counter() - t0:.3f} s")
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false; the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        log(f"{wl['name']} needs {wl['chips']} CUDA devices, found {torch.cuda.device_count()}")
        return 2
    torch.cuda.init()
    log(f"CUDA initialised at {time.perf_counter() - t0:.3f} s")
    try:
        import sda_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"the port is missing: {exc}")
        return 2
    result = run_cell(bench, wl, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t0=t0)
    result["device"]["power"] = power_limit()
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
