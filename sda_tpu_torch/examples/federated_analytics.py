"""Runnable demo: private cohort analytics without any party seeing an
individual's data (counterpart of ``examples/federated_analytics.py``).

    python -m sda_tpu_torch.examples.federated_analytics [--device cpu]

Five organizations each hold response-time measurements; together they
compute, each query one round of the whole protocol: the cohort mean and
variance per endpoint, the latency histogram (exact, checked against the
plaintext counts) and its quantiles, the same histogram under distributed
differential privacy, the cross-endpoint covariance with its leading
principal component, and per-region mean latencies. The data are the
reference's numpy draws; the queries run on the device (CUDA unless
``--device cpu``; without a GPU and without ``--device cpu`` it exits 2).
It prints the reference's lines.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from ..client import SdaClient
from ..crypto import Keystore
from ..device import resolve_device
from ..models import (
    DPSecureHistogram,
    SecureCovariance,
    SecureGroupedMean,
    SecureHistogram,
    SecureStatistics,
    quantiles_from_histogram,
)
from ..server import new_mem_server


def make_client(service, path, device):
    keystore = Keystore(path)
    client = SdaClient(SdaClient.new_agent(keystore), keystore, service, device=device)
    client.upload_agent()
    return client


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def run(device) -> None:
    device = resolve_device(device)
    service = new_mem_server()
    tmp = tempfile.mkdtemp()

    recipient = make_client(service, f"{tmp}/recipient", device)
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    clerks = [make_client(service, f"{tmp}/clerk{i}", device) for i in range(8)]
    for clerk in clerks:
        clerk.upload_encryption_key(clerk.new_encryption_key())

    def chores():
        for w in [recipient] + clerks:
            w.run_chores(-1)

    # each org: per-endpoint mean latencies (dim=8 endpoints), plus raw samples
    rng = np.random.default_rng(1)
    orgs = []
    for i in range(5):
        endpoint_means = np.clip(rng.normal(2.0, 0.5, size=8), 0.0, 8.0)
        raw_samples = np.clip(rng.gamma(2.0, 1.0, size=200), 0.0, 10.0)
        orgs.append((make_client(service, f"{tmp}/org{i}", device), endpoint_means, raw_samples))

    # --- query 1: cohort mean + variance of per-endpoint latencies
    stats = SecureStatistics(dim=8, clip=8.0, n_participants=8, frac_bits=20, device=device)
    agg = stats.open_round(recipient, rkey)
    for org, means, _ in orgs:
        stats.submit(org, agg, means)
    stats.close_round(recipient, agg)
    chores()
    result = stats.finish(recipient, agg, len(orgs))
    print("cohort mean latency/endpoint:", np.round(_host(result["mean"]), 3))
    print("cohort variance/endpoint:   ", np.round(_host(result["variance"]), 3))

    # --- query 2: cohort latency histogram (exact counts)
    hist = SecureHistogram(bins=10, lo=0.0, hi=10.0, n_participants=8, device=device)
    agg = hist.open_round(recipient, rkey)
    for org, _, samples in orgs:
        hist.submit(org, agg, samples)
    hist.close_round(recipient, agg)
    chores()
    counts = hist.finish(recipient, agg, len(orgs))
    print("cohort latency histogram:   ", counts.tolist(), f"(n={int(counts.sum())})")

    # --- query 3: cohort latency quantiles off the same secure histogram
    p50, p95 = quantiles_from_histogram(counts, 0.0, 10.0, [0.5, 0.95]).tolist()
    print(f"cohort latency p50={p50:.2f} p95={p95:.2f} (one-bin-width sketch)")

    # sanity: the exact plaintext histogram matches
    want = sum(hist.local_counts(s) for _, _, s in orgs).to(torch.int64)
    if not torch.equal(counts, want):
        raise AssertionError("histogram mismatch")
    print("verified against plaintext aggregation: OK")

    # --- query 4: the same histogram under distributed differential
    # privacy: every org adds its own share of the noise, so no party can
    # strip it from the cohort sum
    dph = DPSecureHistogram(
        bins=10, lo=0.0, hi=10.0, n_participants=8,
        noise_multiplier=1.0, max_values_per_participant=200,
        generator=torch.Generator(device=device).manual_seed(7), device=device,
    )
    agg = dph.open_round(recipient, rkey)
    for org, _, samples in orgs:
        dph.submit(org, agg, samples)
    dph.close_round(recipient, agg)
    chores()
    noisy = dph.finish(recipient, agg, len(orgs))
    acct = dph.privacy(len(orgs))
    print("DP latency histogram:       ", np.round(_host(noisy), 1).tolist())
    print(f"DP guarantee: eps={acct.epsilon:.2f} delta={acct.delta:g} "
          f"(noise std ~{acct.sigma_total / dph.spec.scale:.0f} counts/bin)")

    # --- query 5: cross-endpoint covariance + leading principal component
    # (federated PCA): which endpoints' latencies move together?
    sc = SecureCovariance(dim=8, clip=8.0, n_participants=8, frac_bits=18, device=device)
    agg = sc.open_round(recipient, rkey)
    for org, means, _ in orgs:
        sc.submit(org, agg, means)
    sc.close_round(recipient, agg)
    chores()
    result = sc.finish_correlation(recipient, agg, len(orgs))
    evals, comps = SecureCovariance.principal_components(result["covariance"], 1)
    correlation = _host(result["correlation"])
    i, j = np.unravel_index(np.abs(np.triu(correlation, 1)).argmax(), correlation.shape)
    print(f"top correlation pair:        endpoints {int(i)} and {int(j)} "
          f"(r={correlation[i, j]:.2f})")
    trace = float(torch.trace(result["covariance"]))
    print(f"PC1 explains {float(evals[0]) / max(trace, 1e-12):.0%} "
          f"of cohort latency variance; direction={np.round(_host(comps[0]), 2)}")

    # --- query 6: per-region mean latency (grouped means): the scatter
    # channel hides which regions an org even operates in
    gm = SecureGroupedMean(groups=3, dim=1, clip=10.0, n_participants=8,
                           max_values_per_participant=8, device=device)
    agg = gm.open_round(recipient, rkey)
    for idx, (org, means, _) in enumerate(orgs):
        obs = [(idx % 3, [float(means[0])]), ((idx + 1) % 3, [float(means[1])])]
        gm.submit(org, agg, obs)
    gm.close_round(recipient, agg)
    chores()
    grouped = gm.finish(recipient, agg, len(orgs))
    print("per-region mean latency:     "
          f"{np.round(_host(grouped['means'][:, 0]), 2).tolist()} "
          f"(n per region: {grouped['counts'].tolist()})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sda_tpu_torch.examples.federated_analytics",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA; exits 2 without a GPU)")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"federated_analytics: {exc}", file=sys.stderr)
        return 2
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
