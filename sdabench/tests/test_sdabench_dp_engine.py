"""The DP-FedAvg cell (``sonwp.dp-engine``): its files found by name, its
configuration against the port's sizing, and whole runs at a tiny size (8
parties of a 6,000-parameter model of three leaves, 22 fractional bits) on
the CPU, where the port runs its kernels' plain versions: the result line
and its checks, and ``correct`` false for the control and for each fault
planted under the timed path (no noise, the proposal without rejection, σ
sized for the chunk, one noise row a chunk, the same noise every round, the
clip in float32, zero masks). The ``card`` variants repeat the runs on a card:

    python3 -m pytest sdabench/tests/test_sdabench_dp_engine.py -q -m card
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from conftest import make_tiny_root
from sdabench import catalog, harness

CELL, CONFIG, MIX = "sonwp.dp-engine", "sonwp-lstm-dpfedavg", "dp-engine"
SEED = (1 << 31) + 2025  # seeds of the checks pass 32 bits
TINY_LAYERS = {"embedding": {"embeddings": [40, 100]}, "output": {"kernel": [100, 19], "bias": [100]}}
TINY_DIM, TINY_COHORT, TINY_FRAC_BITS = 6000, 8, 22
REPO = Path(__file__).resolve().parents[2]


def _fitted(frac_bits: int, dp: dict, dim: int):
    from sda_tpu_torch.models.dp import DPConfig, DPFederatedAveraging

    config = DPConfig(l2_clip=dp["l2_clip"], noise_multiplier=dp["noise_multiplier"],
                      expected_participants=dp["expected_participants"], delta=dp["delta"])
    return config, DPFederatedAveraging.fitted_spec(frac_bits, config, dim)[0]


def tiny_dp_root(tmp: Path) -> Path:
    """The tiny checkout with the DP cell cut to 8 parties of 6,000
    parameters in chunks of 4, in the field the port fits to that size."""
    from sda_tpu_torch.ops import find_packed_parameters

    root = make_tiny_root(tmp)
    path = root / "sdabench/configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg.update(participants=TINY_COHORT, parameters=TINY_DIM, model={"layers": TINY_LAYERS})
    cfg["dp"] = {**cfg["dp"], "expected_participants": TINY_COHORT}
    # 22 fractional bits: at 6,000 coordinates a float32 clip's last-bit
    # errors, 64x larger in field units than at 16, flip dozens of roundings
    cfg["quantization"] = {**cfg["quantization"], "frac_bits": TINY_FRAC_BITS}
    _, spec = _fitted(cfg["quantization"]["frac_bits"], cfg["dp"], TINY_DIM)
    p, ws, wn = find_packed_parameters(5, 2, 8, min_modulus_bits=spec.modulus.bit_length() - 1, seed=0)
    assert p == spec.modulus
    cfg["scheme"] = {**cfg["scheme"], "prime_modulus": p, "omega_secrets": ws, "omega_shares": wn}
    path.write_text(json.dumps(cfg))
    mix_path = root / "sdabench/traffic" / f"{MIX}.json"
    mix = json.loads(mix_path.read_text())
    mix.update(cohort=TINY_COHORT, chunk=4, pool_cohorts=2, trace_units=2, kept_rounds=4, probed_rounds=2)
    mix_path.write_text(json.dumps(mix))
    return root


@pytest.fixture
def dp_root(tmp_path) -> Path:
    return tiny_dp_root(tmp_path)


def run(root: Path, trace: bool = False, seed: int = SEED, device="cpu", **kw) -> dict:
    bench = catalog.load_benchmark(root)
    return harness.run_cell(bench, catalog.workload(bench, CELL), seed=seed, seconds=0.4, trace=trace,
                            device=device, t0=time.perf_counter(), root=root, **kw)


CHECKS = ["quantize_mismatches", "noise_var_ratio_err", "party_var_ratio_err", "noise_mean_sigmas",
          "party_excess_kurtosis", "party_noise_corr", "round_noise_corr", "mask_mismatches", "share_mismatches",
          "randomness_zero_share", "randomness_mean_sigmas", "global_max_abs_err"]


# -- the files and the configuration ------------------------------------------


def test_the_cell_is_found_by_name():
    bench = catalog.load_benchmark()
    workload = catalog.workload(bench, CELL)
    assert (workload["config"], workload["traffic"], workload["chips"]) == (CONFIG, MIX, 1)
    cfg = catalog.config(bench, CONFIG)
    mix = catalog.traffic(MIX)
    assert catalog.loop(mix["loop"]).Cell and catalog.reference(cfg["reference"]).control
    names = [m["name"] for m in catalog.metrics_of(bench, CELL, trace=True)]
    assert names == ["dp.ms_per_round", "dp.roofline", "dp.step_mfu"]
    assert [m["name"] for m in catalog.metrics_of(bench, CELL, trace=False)] == ["secure_sum_elems_per_s", "setup_s"]


def test_the_configuration_is_the_ports_sizing():
    """Nothing is cut; the layers add up to the published 4,050,748; the
    field is the one the port fits, with the roots drawn from seed 0; the
    per-party σ and ε are the ones the guarantees state."""
    from sda_tpu_torch.ops import find_packed_parameters

    cfg = catalog.config(catalog.load_benchmark(), CONFIG)
    assert cfg["reduced"] == [] and cfg["participants"] == cfg["dp"]["expected_participants"] == 100
    sizes = [math.prod(shape) for leaves in cfg["model"]["layers"].values() for shape in leaves.values()]
    assert len(sizes) == 8 and sum(sizes) == cfg["parameters"] == 4050748
    dp, spec = _fitted(16, cfg["dp"], cfg["parameters"])
    s = cfg["scheme"]
    assert spec.modulus == s["prime_modulus"] == 33554593
    assert find_packed_parameters(5, 2, 8, min_modulus_bits=25, seed=0) == \
        (s["prime_modulus"], s["omega_secrets"], s["omega_shares"])
    sigma = dp.sigma_party_field(spec.scale, cfg["parameters"])
    assert round(sigma, 2) == 6654.23 and catalog.reference("fedavg_dp").sigma_party(cfg) == sigma
    assert round(dp.account(spec.scale, cfg["parameters"]).epsilon, 2) == 5.22


def test_the_full_size_pool_is_refused_on_the_cpu():
    """The cell's own size runs on the card only: on the CPU the loop
    refuses it before it draws its 6.5 GB pool."""
    from sdabench.tracing import Tracer

    bench = catalog.load_benchmark()
    cfg, mix = catalog.config(bench, CONFIG), catalog.traffic(MIX)
    loop = catalog.loop(mix["loop"])
    with pytest.raises(ValueError, match="runs on the card only"):
        loop.Cell(cfg, mix, SEED, "cpu", Tracer(False, "cpu"), catalog.reference(cfg["reference"]),
                  program=object())


# -- whole runs ----------------------------------------------------------------


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line(dp_root, trace):
    result = run(dp_root, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result["checks"]) == CHECKS
    for check in result["checks"].values():
        assert check["value"] is not None and check["value"] <= check["limit"]
    assert result["checks"]["quantize_mismatches"]["value"] == 0
    assert result["checks"]["global_max_abs_err"]["value"] == 0.0
    if trace:
        # the CPU has no device ops: the trace's share is left out
        assert set(result["metrics"]) == {"dp.ms_per_round", "dp.step_mfu"}
        assert result["metrics"]["dp.ms_per_round"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"secure_sum_elems_per_s", "setup_s"}
    json.dumps(result)


def test_a_port_without_the_dp_wire_fails_at_once(dp_root, monkeypatch):
    """A port whose ``DPFederatedAveraging`` lacks the chunk-level wire (the
    parent's) is refused as the program is built, before the pool."""
    from sda_tpu_torch.models.dp import DPFederatedAveraging

    monkeypatch.delattr(DPFederatedAveraging, "dp_add_noise")
    with pytest.raises(RuntimeError, match="chunk-level DP wire"):
        run(dp_root)


def test_control_is_not_correct(dp_root):
    """The reference in the program's place, clipping in float32: it hands
    back no masks or clerk sums, and its noise reads as the mechanism's."""
    result = run(dp_root, control=True)
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["mask_mismatches"]["value"] is None
    assert checks["noise_var_ratio_err"]["value"] <= checks["noise_var_ratio_err"]["limit"]


def _faults(chunks_a_round: int = TINY_COHORT // 4) -> dict:
    from sda_tpu_torch.models import dp
    from sda_tpu_torch.ops import chacha_cuda

    real_rows = dp.DPConfig.party_noise_rows
    real_noise = dp.DPFederatedAveraging.dp_add_noise
    calls = itertools.count()

    def same_noise_every_round(self, q, *, generator=None):
        seed = 2024 + next(calls) % chunks_a_round  # a seed of its own for each chunk of a round
        return real_noise(self, q, generator=torch.Generator(device=q.device).manual_seed(seed))

    def float32_clip(flat, clip):
        rows = flat.to(torch.float32)
        norm = torch.linalg.vector_norm(rows, dim=1, keepdim=True)
        return (rows * torch.where(norm > clip, clip / norm, torch.ones_like(norm))).to(torch.float64)

    def zero_masks(seed_words, dim, modulus, n_blocks=None):
        P = seed_words.shape[0]
        return (torch.zeros((P, dim), dtype=torch.int64, device=seed_words.device),
                torch.full((P,), dim, dtype=torch.int32, device=seed_words.device))

    return {
        # the wire carries no noise
        "no_noise": (dp.DPConfig, "party_noise_rows",
                     lambda self, scale, dim, rows, gen: torch.zeros((rows, dim), dtype=torch.int64,
                                                                     device=gen.device)),
        # every discrete Laplace proposal kept
        "no_rejection": (dp, "_dgauss_pass",
                         lambda sigma, n, gen: dp.sample_discrete_laplace(math.floor(sigma) + 1, n, gen)),
        # sigma_total split over the chunk's parties, not the cohort's
        "sigma_for_the_chunk": (dp.DPConfig, "party_noise_rows",
                                lambda self, scale, dim, rows, gen: dp.sample_discrete_gaussian(
                                    self.sigma_total_field(scale, dim) / math.sqrt(rows), (rows, dim), gen)),
        # one noise row for every party of a chunk
        "one_noise_row_a_chunk": (dp.DPConfig, "party_noise_rows",
                                  lambda self, scale, dim, rows, gen: real_rows(self, scale, dim, 1, gen)
                                  .expand(rows, dim)),
        # every round's noise drawn again from the same seeds
        "same_noise_every_round": (dp.DPFederatedAveraging, "dp_add_noise", same_noise_every_round),
        # the row norms and the scaling in float32
        "clip_in_float32": (dp, "l2_clip_rows", float32_clip),
        # every mask zero, on both sides
        "zero_masks": (chacha_cuda, "expand_seeds_counts", zero_masks),
    }


FAULTS = ["no_noise", "no_rejection", "sigma_for_the_chunk", "one_noise_row_a_chunk", "same_noise_every_round",
          "clip_in_float32", "zero_masks"]
#: the number each fault has to fail, beside any other
CAUGHT_BY = {"no_noise": "noise_var_ratio_err", "no_rejection": "party_excess_kurtosis",
             "sigma_for_the_chunk": "noise_var_ratio_err", "one_noise_row_a_chunk": "party_noise_corr",
             "same_noise_every_round": "round_noise_corr", "clip_in_float32": "quantize_mismatches", "zero_masks": "mask_mismatches"}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(dp_root, monkeypatch, fault):
    """The harness's run with the timed path broken underneath: each fault
    fails the number that is there to catch it."""
    module, name, broken = _faults()[fault]
    monkeypatch.setattr(module, name, broken)
    result = run(dp_root)
    assert result["correct"] is False, result["checks"]
    check = result["checks"][CAUGHT_BY[fault]]
    assert check["value"] is None or check["value"] > check["limit"], result["checks"]


def test_faults_reach_the_timed_path(dp_root):
    """Each planted function is one the cell calls: a run that counts the
    calls sees them all."""
    calls = {}

    def counting(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        return wrapped

    planted = {(module, name) for module, name, _ in _faults().values()}
    mp = pytest.MonkeyPatch()
    try:
        for module, name in planted:
            mp.setattr(module, name, counting(module, name))
        assert run(dp_root)["correct"]
    finally:
        mp.undo()
    assert set(calls) == {name for _, name in planted}


def test_a_run_loads_nothing_forbidden(tmp_path):
    """The cell at its tiny size, traced and not, in a fresh process, which
    then holds no module of JAX or of the JAX package."""
    code = f"""
import json, sys
from pathlib import Path
sys.path[:0] = [{str(REPO)!r}, {str(REPO / "sdabench" / "tests")!r}]
import test_sdabench_dp_engine as t
from sdabench import harness
root = t.tiny_dp_root(Path({str(tmp_path)!r}))
ok = [t.run(root, trace)["correct"] for trace in (False, True)]
print(json.dumps({{"ok": ok, "forbidden": harness.forbidden_modules()}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"ok": [True, True], "forbidden": []}


# -- on the card -----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_cell_on_the_card(dp_root, trace):
    _card()
    result = run(dp_root, trace, device="cuda")
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
        assert 0 < result["metrics"]["dp.roofline"]["value"] <= 100


@pytest.mark.card
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_on_the_card(dp_root, seed):
    _card()
    assert run(dp_root, seed=seed, device="cuda", control=True)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_on_the_card(dp_root, monkeypatch, fault):
    _card()
    module, name, broken = _faults()[fault]
    monkeypatch.setattr(module, name, broken)
    result = run(dp_root, device="cuda")
    assert result["correct"] is False, result["checks"]
    check = result["checks"][CAUGHT_BY[fault]]
    assert check["value"] is None or check["value"] > check["limit"], result["checks"]
