"""The sketch-accuracy rider (counterpart of ``bench.py``'s
``measure_sketch_accuracy``): accuracy against wire dimension, each leg a
full secure round over loopback REST."""

from __future__ import annotations

import os
import time
from collections import Counter

import numpy as np

from ._common import bank, emit_line, rest_deployment

SEED = 20260806


def measure_sketch_accuracy(device=None) -> dict:
    """Two dimension sweeps at fixed seeds and fixed data:

    - count-min at widths {64, 256, 1024} (depth 4): the largest point-query
      error over the whole domain against the analytic eps * N bound;
    - linear-counting cardinality at m in {256, 1024, 4096}: the estimate's
      error against its 3-sigma bound.

    Every leg's securely summed sketch must be byte-identical to the plain
    sum of the phones' own sketches before its numbers count, and
    ``bound_headroom`` (the bound over the observed error, at least 1 within
    bound) is the accuracy metric: shrinking headroom at fixed seeds means
    a broken estimator, not noise. Throughput is encoded items per wall
    second through the whole stack."""
    from ..protocol import AdditiveSharing
    from ..server import new_mem_server
    from ..sketches import CountMinSketch, LinearCountingSketch, SketchQuery

    n_phones, n_clerks, domain = 4, 3, 128
    rng = np.random.default_rng(SEED)
    # skewed categorical streams: 3 planted heavy hitters per phone
    cm_data = [[int(h) for h in (3, 17, 41) for _ in range(30)]
               + [int(v) for v in rng.integers(0, domain, size=60)] for _ in range(n_phones)]
    cm_true = Counter(x for data in cm_data for x in data)
    cm_total = sum(len(data) for data in cm_data)
    distinct = [f"device-{i}" for i in range(200)]
    lc_data = [distinct[i::n_phones] + distinct[:40] for i in range(n_phones)]
    lc_true = len(distinct)
    out: dict = {"families": {"countmin": {"legs": {}}, "cardinality": {"legs": {}}}}

    with rest_deployment(lambda root: new_mem_server(), device) as d:
        recipient, rkey = d.keyed("r")
        clerks = d.committee(n_clerks, staged=True)
        phones = [d.client(f"p{i}", upload=True) for i in range(n_phones)]

        def run_leg(sketch, datasets, title):
            query = SketchQuery(sketch, n_participants=8, max_values_per_participant=1 << 10,
                                device=device)
            sharing = AdditiveSharing(share_count=n_clerks, modulus=query.spec.modulus)
            t0 = time.perf_counter()
            agg = query.open_round(recipient, rkey, sharing, title=title)
            for phone, values in zip(phones, datasets):
                query.submit(phone, agg, values)
            query.close_round(recipient, agg)
            for member in [recipient] + clerks:
                member.run_chores(-1)
            summed = query.finish(recipient, agg, len(datasets)).cpu().numpy()
            wall = time.perf_counter() - t0
            expected = sum(query.local_sketch(data) for data in datasets)
            assert summed.tobytes() == expected.tobytes(), f"{title}: secure sum != central sum"
            return summed, wall

        for width in (64, 256, 1024):
            cm = CountMinSketch(width=width, depth=4, seed=SEED)
            summed, wall = run_leg(cm, cm_data, f"bench-countmin-w{width}")
            bound = cm.error_bound(summed)
            max_err = float(max(cm.point_query(summed, x) - cm_true[x] for x in range(domain)))
            leg = {
                "dim": cm.dim,
                "width": width,
                "depth": 4,
                "wall_s": round(wall, 3),
                "items_per_s": round(cm_total / wall),
                "total": cm_total,
                "max_err": max_err,
                "bound": round(bound, 2),
                "within_bound": bool(max_err <= bound),
                # an observed error can be 0 at large widths: floored at one
                # count, so headroom stays finite and comparable
                "bound_headroom": round(bound / max(max_err, 1.0), 3),
                "byte_exact": True,
            }
            out["families"]["countmin"]["legs"][f"w{width}"] = leg
            emit_line(f"sketch_countmin_w{width}", leg["max_err"], "counts_abs_err", dim=leg["dim"],
                      bound=leg["bound"], within_bound=leg["within_bound"],
                      items_per_s=leg["items_per_s"], wall_s=leg["wall_s"])

        for m in (256, 1024, 4096):
            lc = LinearCountingSketch(m=m, seed=SEED)
            summed, wall = run_leg(lc, lc_data, f"bench-cardinality-m{m}")
            dec = lc.decode(summed, n_phones)
            err = abs(dec["estimate"] - lc_true)
            leg = {
                "dim": m,
                "wall_s": round(wall, 3),
                "items_per_s": round(sum(len(data) for data in lc_data) / wall),
                "true": lc_true,
                "estimate": round(dec["estimate"], 1),
                "abs_err": round(err, 1),
                "bound": round(dec["error_bound"], 1),
                "within_bound": bool(err <= dec["error_bound"]),
                "bound_headroom": round(dec["error_bound"] / max(err, 1.0), 3),
                "byte_exact": True,
            }
            out["families"]["cardinality"]["legs"][f"m{m}"] = leg
            emit_line(f"sketch_cardinality_m{m}", leg["abs_err"], "distinct_abs_err", dim=m,
                      bound=leg["bound"], within_bound=leg["within_bound"],
                      items_per_s=leg["items_per_s"], wall_s=leg["wall_s"])

    bank({"sketch": {
        "metric": "sketch_accuracy",
        "config": {"n_phones": n_phones, "seed": SEED, "committee": f"additive x{n_clerks}",
                   "store": "mem", "transport": "loopback_rest", "cpu_count": os.cpu_count(),
                   "multi_core_host": (os.cpu_count() or 1) > 1},
        **out,
    }})
    return out
