"""Runnable demo: the sketch-plane workload suite (counterpart of
``examples/sketch_suite.py``).

    python -m sda_tpu_torch.examples.sketch_suite [--device cpu] [--json OUT]

Six phones hold private app-event streams; the recipient answers five
federated-analytics questions (heavy hitters, point queries, quantiles,
cohort cardinality and top-k), each as one secure round of a linear
sketch (``sda_tpu_torch.sketches``) through the whole protocol: committee
election, ChaCha masking, packed-Shamir sharing, sealed boxes, clerking,
reveal. Every decoded answer is checked against its analytic error bound,
and every summed sketch against the central numpy sum, byte for byte.

The reference serves the round over its REST stack; the port has no REST
binding, so the same rounds run in process on the memory server. The
phones' events are the reference's numpy draws; the queries run on the
device (CUDA unless ``--device cpu``; without a GPU and without
``--device cpu`` it exits 2).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from collections import Counter

import numpy as np

from ..client import SdaClient
from ..crypto import Keystore
from ..device import resolve_device
from ..server import new_mem_server
from ..sketches import (
    CountMinSketch,
    CountSketch,
    DyadicQuantiles,
    LinearCountingSketch,
    SketchQuery,
    TopKSketch,
)

SEED = 17
N_PHONES = 6
HOT_APPS = ["maps", "chat", "camera"]


def make_client(service, path, device):
    keystore = Keystore(path)
    client = SdaClient(SdaClient.new_agent(keystore), keystore, service, device=device)
    client.upload_agent()
    return client


def phone_events(rng, i):
    """One phone's private stream: app launches (hot apps dominate),
    integer latencies in [0, 256) ms, and device-cohort ids."""
    apps = [h for h in HOT_APPS for _ in range(12 + 2 * i)]
    apps += [f"app-{int(v)}" for v in rng.integers(0, 40, size=30)]
    latencies = [int(v) for v in np.clip(rng.gamma(4.0, 12.0, size=50), 0, 255)]
    devices = [f"device-{int(v)}" for v in rng.integers(0, 300, size=80)]
    return apps, latencies, devices


def run_round(query, recipient, rkey, clerks, phones, datasets, title):
    agg = query.open_round(recipient, rkey, title=title)
    for phone, values in zip(phones, datasets):
        query.submit(phone, agg, values)
    query.close_round(recipient, agg)
    for w in [recipient] + clerks:
        w.run_chores(-1)
    summed = query.finish(recipient, agg, len(datasets)).cpu().numpy()
    # the aggregate must be byte-identical to the central sum: the
    # protocol's only job is to compute it without seeing the parts
    expected = sum(query.local_sketch(d) for d in datasets)
    if summed.tobytes() != expected.tobytes():
        raise AssertionError(f"{title}: sum mismatch")
    return summed


def _check(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def run(device, json_out=None) -> dict:
    device = resolve_device(device)
    tmp = tempfile.mkdtemp()
    service = new_mem_server()

    rng = np.random.default_rng(SEED)
    per_phone = [phone_events(rng, i) for i in range(N_PHONES)]
    all_apps = [a for apps, _, _ in per_phone for a in apps]
    all_lat = [v for _, lat, _ in per_phone for v in lat]
    all_dev = {d for _, _, devs in per_phone for d in devs}
    true_apps = Counter(all_apps)
    summary = {"store": "mem", "phones": N_PHONES}

    print("in-process memory server (store=mem)")
    recipient = make_client(service, f"{tmp}/recipient", device)
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    clerks = [make_client(service, f"{tmp}/clerk{i}", device) for i in range(8)]
    for clerk in clerks:
        clerk.upload_encryption_key(clerk.new_encryption_key())
    phones = [make_client(service, f"{tmp}/phone{i}", device) for i in range(N_PHONES)]

    def query(sketch, **kw):
        return SketchQuery(sketch, n_participants=8, device=device, **kw)

    # --- 1. count-min: which apps are hot, and how hot?
    cm = CountMinSketch(width=512, depth=4, seed=SEED)
    summed = run_round(query(cm, max_values_per_participant=512), recipient, rkey, clerks, phones,
                       [apps for apps, _, _ in per_phone], "suite-countmin")
    bound = cm.error_bound(summed)
    hits = cm.heavy_hitters(summed, HOT_APPS + ["app-0", "app-1"], threshold=50)
    for app, est in hits:
        _check(true_apps[app] <= est <= true_apps[app] + bound, f"count-min {app}: {est}")
    print(f"count-min heavy hitters (±{bound:.1f}): {[(a, c) for a, c in hits]}")
    summary["countmin"] = {"bound": bound, "hits": {a: c for a, c in hits},
                           "true": {a: true_apps[a] for a, _ in hits}}

    # --- 2. count-sketch: unbiased point queries (L2 bound)
    cs = CountSketch(width=512, depth=5, seed=SEED)
    summed = run_round(query(cs, max_values_per_participant=512), recipient, rkey, clerks, phones,
                       [apps for apps, _, _ in per_phone], "suite-countsketch")
    cs_bound = cs.error_bound(summed)
    ests = {a: cs.point_query(summed, a) for a in HOT_APPS}
    for a, est in ests.items():
        _check(abs(est - true_apps[a]) <= cs_bound, f"count-sketch {a}: {est}")
    print(f"count-sketch estimates (±{cs_bound:.1f}): {ests}")
    summary["countsketch"] = {"bound": cs_bound, "estimates": ests,
                              "true": {a: true_apps[a] for a in ests}}

    # --- 3. dyadic quantiles: cohort latency p50/p90/p99
    dq = DyadicQuantiles(universe_bits=8, width=512, depth=4, seed=SEED)
    summed = run_round(query(dq, max_values_per_participant=512), recipient, rkey, clerks, phones,
                       [lat for _, lat, _ in per_phone], "suite-quantiles")
    rank_bound = dq.rank_error_bound(summed)
    svals = sorted(all_lat)
    quants, ranks = {}, {}
    for qq in (0.5, 0.9, 0.99):
        est = dq.quantile_query(summed, qq)
        target = max(1, int(np.ceil(qq * len(svals))))
        lo_rank = int(np.searchsorted(svals, est, side="left"))
        hi_rank = int(np.searchsorted(svals, est, side="right"))
        _check(lo_rank - rank_bound <= target <= hi_rank + rank_bound, f"quantile {qq}: {est}")
        quants[qq] = est
        ranks[str(qq)] = {"target": target, "lo": lo_rank, "hi": hi_rank}
    print(f"latency quantiles (rank ±{rank_bound:.0f} of {len(svals)}): "
          f"p50={quants[0.5]}ms p90={quants[0.9]}ms p99={quants[0.99]}ms")
    summary["quantiles"] = {
        "rank_bound": rank_bound, "n": len(svals),
        "estimates": {str(k): v for k, v in quants.items()},
        "true": {str(k): int(np.quantile(svals, k, method="inverted_cdf")) for k in quants},
        "ranks": ranks,
    }

    # --- 4. linear counting: how many distinct devices in the cohort?
    lc = LinearCountingSketch(m=2048, seed=SEED)
    summed = run_round(query(lc), recipient, rkey, clerks, phones,
                       [devs for _, _, devs in per_phone], "suite-cardinality")
    dec = lc.decode(summed, N_PHONES)
    _check(abs(dec["estimate"] - len(all_dev)) <= dec["error_bound"], f"cardinality: {dec}")
    print(f"distinct devices: ~{dec['estimate']:.0f} ±{dec['error_bound']:.0f} "
          f"(true {len(all_dev)})")
    summary["cardinality"] = {"estimate": dec["estimate"], "bound": dec["error_bound"],
                              "true": len(all_dev)}

    # --- 5. top-k: the three most-launched apps
    candidates = HOT_APPS + [f"app-{i}" for i in range(40)]
    tk = TopKSketch(k=3, candidates=candidates, width=512, depth=4, seed=SEED)
    summed = run_round(query(tk, max_values_per_participant=512), recipient, rkey, clerks, phones,
                       [apps for apps, _, _ in per_phone], "suite-topk")
    dec = tk.decode(summed, N_PHONES)
    got = [a for a, _ in dec["topk"]]
    _check(set(got) == set(HOT_APPS), (got, HOT_APPS))
    print(f"top-3 apps: {dec['topk']} (±{dec['error_bound']:.1f})")
    summary["topk"] = {"topk": dec["topk"], "bound": dec["error_bound"], "true_hot": HOT_APPS}

    print("all five sketch families decoded within their analytic bounds,")
    print("every secure sum byte-identical to the central sum: OK")
    if json_out:
        with open(json_out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"summary written to {json_out}")
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sda_tpu_torch.examples.sketch_suite",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA; exits 2 without a GPU)")
    parser.add_argument("--json", help="write a machine-readable summary here")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"sketch_suite: {exc}", file=sys.stderr)
        return 2
    run(args.device, args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
