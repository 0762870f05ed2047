"""The tier fan-out rider (counterpart of ``bench.py``'s
``measure_tier_fanout``): flat against 2-tier rounds, and the two
promotion paths head to head."""

from __future__ import annotations

import os
import time

import numpy as np

from ._common import aggregation, bank, emit_line, env_int, hist_totals, rest_deployment

FANOUTS = [2, 4, 8]


def _modular_sum(values, modulus: int) -> np.ndarray:
    dim = len(values[0])
    return np.array([sum(v[d] for v in values) % modulus for d in range(dim)], dtype=np.int64)


def _exact(output, expected: np.ndarray) -> bool:
    return np.asarray(output.values).astype(np.int64).tobytes() == expected.tobytes()


def measure_tier_fanout(n_participants: int | None = None, device=None) -> dict:
    """Flat against 2-tier rounds at fan-out m in {2, 4, 8}: the same N
    participants and values every leg, over a loopback REST server on the
    mem store.

    What tiers break is the per-clerk job: in a flat round every clerk's
    job carries all N columns; at fan-out m each leaf committee clerks its
    sub-cohort (~N/m) and the root clerks m promoted partials. The clerk's
    work is read from the ``sda_clerk_stage_seconds`` histograms around
    each leg and checked structurally through the tier-status route (the
    most participations on any one node). Every leg's reveal is held
    byte-exact against the plain modular sum. Each leg runs
    ``SDA_BENCH_TIER_REPS`` rounds (default 3) and rates come from the
    summed samples. Round wall grows with fan-out where committees share
    cores, and the rider says so.

    Then the promotion A/B: the same 2-tier Shamir round under reveal
    promotion and under share promotion, interleaved over
    ``SDA_BENCH_TIER_AB_REPS`` rounds (default 3) at
    ``SDA_BENCH_TIER_AB_DIM`` (default 1,024) and ``SDA_BENCH_TIER_AB_N``
    participants (default 16), the per-node promotion seconds read from the
    driver's ``sda_tier_promote_seconds{path}`` and the clerks'
    ``sda_tier_reshare_seconds`` beside them. N is ``SDA_BENCH_TIER_N``
    (default 48)."""
    from ..client import run_committee, run_tier_round, setup_tier_round
    from ..protocol import AdditiveSharing, BasicShamirSharing, ChaChaMasking
    from ..server import new_mem_server

    n = n_participants or env_int("SDA_BENCH_TIER_N", 48)
    dim, modulus, n_clerks = 32, 433, 3
    out: dict = {"n_participants": n, "configs": {}}
    values = [[(i * 31 + d * 7 + 3) % modulus for d in range(dim)] for i in range(n)]
    expected = _modular_sum(values, modulus)

    with rest_deployment(lambda root: new_mem_server(), device) as d:
        service = d.service
        recipient, rkey = d.keyed("r")
        pool = d.committee(n_clerks)
        # one identity per participant: leaf routing hashes the agent id, so
        # a shared identity would collapse every cohort onto one leaf
        participants = [d.client(f"p{i}", upload=True) for i in range(n)]

        def new_aggregation(m, sharing=None, promotion=None, dim_=None):
            dim_ = dim_ or dim
            return aggregation(
                recipient, rkey, f"tier-bench-{m or 'flat'}", dim_, modulus,
                ChaChaMasking(modulus=modulus, dimension=dim_, seed_bitsize=128),
                sharing or AdditiveSharing(share_count=n_clerks, modulus=modulus),
                sub_cohort_size=m, tiers=2 if m else None, tier_promotion=promotion)

        def run_leg(tag: str, m: int | None) -> dict:
            # the per-clerk stage sums are ~10 ms here and one shot swings
            # with allocator and GC jitter, so each leg runs several rounds
            reps = env_int("SDA_BENCH_TIER_REPS", 3)
            stages_acc: dict = {}
            walls = []
            n_nodes = max_job = 0
            for rep in range(reps):
                agg = new_aggregation(m)
                if m is None:
                    recipient.upload_aggregation(agg)
                    recipient.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in pool])
                    round_ = None
                else:
                    round_ = setup_tier_round(recipient, agg, lambda name: d.client(f"{tag}{rep}-{name}"),
                                              pool)
                before = hist_totals("sda_clerk_stage_seconds", "stage")
                t0 = time.perf_counter()
                for p, v in zip(participants, values):
                    p.participate(v, agg.id)
                if m is None:
                    recipient.end_aggregation(agg.id)
                    run_committee(pool, -1)
                    output = recipient.reveal_aggregation(agg.id).positive()
                else:
                    result = run_tier_round(round_)
                    assert result.skipped == [], f"leg {tag} skipped {result.skipped}"
                    output = result.output.positive()
                walls.append(time.perf_counter() - t0)
                after = hist_totals("sda_clerk_stage_seconds", "stage")
                assert _exact(output, expected), f"leg {tag}: reveal diverged from the modular sum"

                status = service.get_tier_status(recipient.agent, agg.id)
                if status is None:  # flat: one node carries every column
                    n_nodes, max_job = 1, n
                else:
                    n_nodes = len(status.nodes)
                    max_job = max(node.number_of_participations for node in status.nodes)
                for stage_name, (s, count) in after.items():
                    acc = stages_acc.setdefault(stage_name, [0.0, 0])
                    s0, c0 = before.get(stage_name, (0, 0))
                    acc[0] += s - s0
                    acc[1] += count - c0
            clerk_stage_s = sum(acc[0] for acc in stages_acc.values())
            clerk_jobs = n_clerks * n_nodes * reps
            # every committee input is clerked once per seat: N reals at the
            # leaves (or the flat root) plus one promotion per non-root node
            clerked_inputs = (n + (n_nodes - 1)) * n_clerks * reps
            return {
                "fanout": m,
                "exact": True,
                "reps": reps,
                "wall_s": round(sum(walls) / len(walls), 3),
                "nodes": n_nodes,
                "clerk_jobs": clerk_jobs,
                "max_job_participations": max_job,
                "clerk_stage_s": round(clerk_stage_s, 4),
                "per_job_stage_s": round(clerk_stage_s / clerk_jobs, 5) if clerk_jobs else None,
                "inputs_per_clerk_s": round(clerked_inputs / clerk_stage_s) if clerk_stage_s else None,
                "stages": {name: {"s": round(acc[0], 4), "observations": acc[1]}
                           for name, acc in stages_acc.items()},
            }

        flat = run_leg("flat", None)
        out["configs"]["flat"] = flat
        for m in FANOUTS:
            cfg = run_leg(f"m{m}", m)
            cfg["vs_flat_max_job"] = round(cfg["max_job_participations"] / flat["max_job_participations"], 3)
            cfg["vs_flat_wall"] = round(cfg["wall_s"] / flat["wall_s"], 2)
            out["configs"][f"m{m}"] = cfg
            emit_line(f"tier_fanout_m{m}", cfg["max_job_participations"], "participations_per_clerk_job",
                      vs_flat=cfg["vs_flat_max_job"], n_participants=n, nodes=cfg["nodes"],
                      per_job_stage_s=cfg["per_job_stage_s"],
                      inputs_per_clerk_s=cfg["inputs_per_clerk_s"], wall_s=cfg["wall_s"],
                      vs_flat_wall=cfg["vs_flat_wall"],
                      roofline={"plane": "loopback_rest", "bound": "max(N/m, m) columns per clerk job",
                                "cpu_count": os.cpu_count()})
        emit_line("tier_fanout_flat", flat["max_job_participations"], "participations_per_clerk_job",
                  vs_flat=1.0, n_participants=n, nodes=1, per_job_stage_s=flat["per_job_stage_s"],
                  inputs_per_clerk_s=flat["inputs_per_clerk_s"], wall_s=flat["wall_s"],
                  roofline={"plane": "loopback_rest", "bound": "N columns per clerk job",
                            "cpu_count": os.cpu_count()})

        # -- promotion A/B: reveal round trip against share promotion ---------
        # both legs one shape (2 tiers, fan-out 2, a Shamir committee so
        # both paths are legal), a wider vector so payloads are realistic,
        # a small cohort (it only scales the mask fold both paths share),
        # the legs interleaved so slow host drift cancels
        ab_dim = env_int("SDA_BENCH_TIER_AB_DIM", 1024)
        ab_reps = env_int("SDA_BENCH_TIER_AB_REPS", 3)
        ab_n = min(n, env_int("SDA_BENCH_TIER_AB_N", 16))
        ab_values = [[(i * 131 + d * 17 + 5) % modulus for d in range(ab_dim)] for i in range(ab_n)]
        ab_expected = _modular_sum(ab_values, modulus)
        shamir = BasicShamirSharing(share_count=n_clerks, privacy_threshold=1, prime_modulus=modulus)
        acc = {path: {"promote_s": 0.0, "nodes": 0, "obs": 0, "walls": [], "clerk_reshare_s": 0.0}
               for path in ("reveal", "reshare")}
        for rep in range(ab_reps):
            for path in ("reveal", "reshare"):
                agg = new_aggregation(2, sharing=shamir, promotion=path, dim_=ab_dim)
                round_ = setup_tier_round(recipient, agg, lambda name: d.client(f"ab-{path}{rep}-{name}"),
                                          pool)
                p_before = hist_totals("sda_tier_promote_seconds", "path")
                r_before = hist_totals("sda_tier_reshare_seconds", "stage")
                t0 = time.perf_counter()
                for p, v in zip(participants, ab_values):
                    p.participate(v, agg.id)
                result = run_tier_round(round_)
                assert result.skipped == [], f"ab {path} skipped {result.skipped}"
                a = acc[path]
                a["walls"].append(time.perf_counter() - t0)
                assert _exact(result.output.positive(), ab_expected), \
                    f"ab {path}: reveal diverged from the modular sum"
                p_after = hist_totals("sda_tier_promote_seconds", "path")
                r_after = hist_totals("sda_tier_reshare_seconds", "stage")
                a["promote_s"] += p_after.get(path, (0.0, 0))[0] - p_before.get(path, (0.0, 0))[0]
                a["obs"] += p_after.get(path, (0.0, 0))[1] - p_before.get(path, (0.0, 0))[1]
                a["clerk_reshare_s"] += sum(r_after[k][0] - r_before.get(k, (0.0, 0))[0] for k in r_after)
                # per node, not per sample: share promotion logs two samples
                # per node (the correction and the survivor check)
                a["nodes"] += len(round_.nodes) - 1
        ab: dict = {}
        for path, a in acc.items():
            ab[path] = {
                "exact": True,
                "reps": ab_reps,
                "dim": ab_dim,
                "n_participants": ab_n,
                "wall_s": round(sum(a["walls"]) / len(a["walls"]), 3),
                "promoted_nodes": a["nodes"],
                "promote_observations": a["obs"],
                "promotion_s": round(a["promote_s"], 4),
                "per_node_promotion_s": round(a["promote_s"] / a["nodes"], 5) if a["nodes"] else None,
                "promote_nodes_per_s": round(a["nodes"] / a["promote_s"], 2) if a["promote_s"] else None,
                "clerk_reshare_s": round(a["clerk_reshare_s"], 4),
            }
        ab["reshare"]["vs_reveal_per_node"] = round(
            ab["reshare"]["per_node_promotion_s"] / ab["reveal"]["per_node_promotion_s"], 3)
        ab["reshare"]["vs_reveal_wall"] = round(ab["reshare"]["wall_s"] / ab["reveal"]["wall_s"], 3)
        out["promotion_ab"] = ab
        for path in ("reveal", "reshare"):
            emit_line(f"tier_fanout_promote-{path}", ab[path]["per_node_promotion_s"],
                      "s_per_promoted_node", vs_flat=ab[path].get("vs_reveal_per_node", 1.0),
                      n_participants=n, wall_s=ab[path]["wall_s"],
                      promoted_nodes=ab[path]["promoted_nodes"],
                      promote_nodes_per_s=ab[path]["promote_nodes_per_s"],
                      clerk_reshare_s=ab[path]["clerk_reshare_s"],
                      roofline={"plane": "loopback_rest",
                                "bound": ("reveal: reconstruct + re-mask + re-share per node; "
                                          "reshare: one mask-correction row per node"),
                                "cpu_count": os.cpu_count()})

    best = min((c for t, c in out["configs"].items() if t != "flat"),
               key=lambda c: c["max_job_participations"])
    out["single_core_verdict"] = (
        f"on {os.cpu_count()} CPU(s) every committee serializes, so tiered wall-clock is "
        f"{best['vs_flat_wall']}x flat — no speedup is claimed here; the certified win is the "
        f"per-clerk bound: the largest clerk job fell {flat['max_job_participations']} -> "
        f"{best['max_job_participations']} columns ({best['vs_flat_max_job']}x) at fanout "
        f"m={best['fanout']}")
    out["promotion_verdict"] = (
        f"share-promotion per-node promotion is {ab['reshare']['vs_reveal_per_node']}x the reveal "
        f"round-trip ({ab['reveal']['per_node_promotion_s']}s -> "
        f"{ab['reshare']['per_node_promotion_s']}s per node); round wall "
        f"{ab['reshare']['vs_reveal_wall']}x")

    bank({"tier": {
        "metric": "tier_fanout",
        "config": {"n_participants": n, "fanouts": FANOUTS, "tiers": 2, "dim": dim,
                   "committee": f"additive x{n_clerks}",
                   "promotion_ab_committee": f"basic-shamir x{n_clerks} (t=1)", "store": "mem",
                   "transport": "loopback_rest", "cpu_count": os.cpu_count()},
        **out,
    }})
    return out
