"""The control of ``correct``: each cell run with the plain reference in the
program's place, computed in the precision below the configuration's
(``reference/<name>.py`` ``control``). Every seed has to come out not
correct; the numbers it prints set the upper reading of each limit.

    python3 -m sdabench.control --workload cnn.engine --seeds 11,12,13 --seconds 30

One JSON line a seed, then exit 0 if every seed came out not correct, 1
otherwise. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import catalog
from .harness import log, run_cell


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m sdabench.control", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    bench = catalog.load_benchmark()
    wl = catalog.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run_cell(bench, wl, seed=seed, seconds=args.seconds, trace=False, device="cuda",
                          t0=time.perf_counter(), control=True)
        failed_all &= not result["correct"]
        print(json.dumps({"workload": wl["name"], "seed": seed, "control": True, "correct": result["correct"],
                          "attempted": result["attempted"], "failed": result["failed"],
                          "checks": result["checks"]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
