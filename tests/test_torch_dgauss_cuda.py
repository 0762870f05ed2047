"""The discrete Gaussian kernel ``dgauss_kernel`` (``csrc/dgauss.cu``), which
``dgauss_cuda.sample`` launches on a CUDA generator.

On the CPU: the kernel entry's refusals, and a CPU generator's draws build
and load nothing. On the card (marker ``card``; each such test skips inside
itself without a CUDA device): the kernel bit for bit against its plain
twin run on the CPU from the same key, at the DP cell's chunk, the
CNN-width wire, a tiny shape at a low σ and an empty one, with the
proposals it counts on the card (``dgauss_cuda.proposals``) equal to the
twin's; the launch counter; and a traced ``dp_add_noise``: a kernel record per launch, the
launch inside ``sda.dp.noise`` > ``sda.dp.noise.draw``, no ``sda.sync.``
range.
The file imports no JAX; the suite's ``conftest.py`` does, so on a machine
without JAX it runs as

    python -m pytest tests/test_torch_dgauss_cuda.py -m card --noconftest -q
"""

import json
import math
import os
import tempfile

import numpy as np
import pytest
import torch

from sda_tpu_torch import kernels
from sda_tpu_torch.models import dp
from sda_tpu_torch.ops import dgauss_cuda

#: σ_party of the DP cell (sdabench/configs/sonwp-lstm-dpfedavg.json)
CELL_SIGMA = 6654.23


def _cnn_wire_sigma() -> float:
    """σ_party of ``chip_smoke.py``'s DP model rounds at the CNN's width (10
    parties, clip 1, noise multiplier 1, 16 fractional bits)."""
    return dp.DPConfig(l2_clip=1.0, noise_multiplier=1.0, expected_participants=10).sigma_party_field(
        1 << 16, 1_663_370)


def test_the_kernel_entry_refuses_what_it_does_not_take():
    cpu_key = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        dgauss_cuda.dgauss_cuda(3.0, 10, cpu_key)


def test_a_cpu_generator_builds_and_loads_nothing(monkeypatch):
    """The plain twin runs on a CPU generator: no ``nvcc``, no library, no
    launch counted."""
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(kernels, "load", refuse)
    launched = dgauss_cuda.launches
    draws = dgauss_cuda.sample(CELL_SIGMA, 1000, torch.Generator().manual_seed(1))
    assert draws.shape == (1000,) and draws.dtype == torch.int64
    assert dgauss_cuda.launches == launched


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _explain(sigma: float, key: torch.Tensor, index: int) -> str:
    """For the segment that holds ``index``: the proposals nearest a floor
    or compare boundary (the geometric's quotient -t·log(u) against its
    floor, the acceptance uniform against its exp), for a mismatch's
    report."""
    segment = index // dgauss_cuda.SEGMENT
    offsets = torch.arange(64 * dgauss_cuda.LANES)
    w0, w1, w2, w3 = dgauss_cuda.philox(key, offsets & 0xFFFFFFFF, offsets >> 32,
                                        torch.tensor(segment & 0xFFFFFFFF), torch.tensor(segment >> 32))
    t, center, scale = dgauss_cuda.constants(sigma)
    u = ((w0 << 21) | (w1 >> 11)).add(1).to(torch.float64) * 2.0**-53
    quotient = torch.log(u) * -t
    g = torch.floor(quotient)
    accept_u = ((w2 << 21) | (w3 >> 11)).to(torch.float64) * 2.0**-53
    bound = torch.exp(((g - center) ** 2) * scale)
    floor_gap = torch.minimum(quotient - g, g + 1 - quotient)
    lines = [f"segment {segment} (index {index})"]
    for j in torch.argsort(floor_gap)[:3].tolist():
        lines.append(f"offset {j}: u {u[j].item()!r} quotient {quotient[j].item()!r}")
    for j in torch.argsort((accept_u - bound).abs())[:3].tolist():
        lines.append(f"offset {j}: acceptance u {accept_u[j].item()!r} exp {bound[j].item()!r}")
    return "\n".join(lines)


SHAPES = {  # id -> ((rows, dim), sigma)
    "dp-cell-chunk": ((25, 4_050_748), CELL_SIGMA),
    "cnn-wire": ((1, 1_663_370), None),
    "tiny-low-sigma": ((3, 7), 0.5),
    "empty": ((0, 5), 3.0),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(SHAPES))
def test_kernel_matches_the_plain_twin(case):
    """The kernel from a key drawn on a CUDA generator against the twin on
    the CPU from the same key: every value, and the proposals drawn."""
    _card()
    shape, sigma = SHAPES[case]
    sigma = _cnn_wire_sigma() if sigma is None else sigma
    n = math.prod(shape)
    generator = torch.Generator(device="cuda").manual_seed(len(case))
    key = dgauss_cuda.draw_key(generator)
    before_count, launched = dgauss_cuda.proposals(key.device), dgauss_cuda.launches
    got = dgauss_cuda.dgauss_cuda(sigma, n, key)
    torch.cuda.synchronize()
    assert dgauss_cuda.launches == launched + (1 if n else 0)
    assert got.shape == (n,) and got.dtype == torch.int64 and got.is_cuda
    want, drawn = dgauss_cuda.dgauss_plain(sigma, n, key.cpu())
    got = got.cpu()
    differ = torch.nonzero(got != want).ravel()
    if differ.numel():
        print(_explain(sigma, key.cpu(), int(differ[0])))
    assert differ.numel() == 0, f"{differ.numel()} of {n} values differ, first at {differ[:8].tolist()}"
    assert dgauss_cuda.proposals(key.device) - before_count == int(drawn)
    if n > 1_000_000:
        assert 1.30 < int(drawn) / n < 1.50


@pytest.mark.card
def test_sample_on_a_cuda_generator_launches_once_a_call():
    _card()
    generator = torch.Generator(device="cuda").manual_seed(3)
    launched = dgauss_cuda.launches
    a = dp.sample_discrete_gaussian(40.0, (4, 10_000), generator)
    b = dp.sample_discrete_gaussian(40.0, (4, 10_000), generator)
    assert dgauss_cuda.launches == launched + 2
    assert a.is_cuda and not torch.equal(a, b)
    again = dp.sample_discrete_gaussian(40.0, (4, 10_000), torch.Generator(device="cuda").manual_seed(3))
    assert torch.equal(a, again)


def _traced(fn):
    """``fn()`` under a CPU and CUDA profiler: the exported trace's events."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


@pytest.mark.card
def test_traced_noise_has_a_record_per_launch_and_no_sync():
    """``dp_add_noise`` of a (25, 6,000) chunk: one ``dgauss_kernel`` record
    for its one launch, inside ``sda.dp.noise.draw`` > ``sda.dp.noise``,
    and no ``sda.sync.`` range."""
    _card()
    cfg = dp.DPConfig(l2_clip=1.0, noise_multiplier=1.0, expected_participants=25)
    spec, _ = dp.DPFederatedAveraging.fitted_spec(16, cfg, 6000)
    fed = dp.DPFederatedAveraging(spec, {"w": np.zeros(6000)}, cfg,
                                  torch.Generator(device="cuda").manual_seed(5), device="cuda")
    q = fed.dp_clip_quantize(torch.zeros((25, 6000), device="cuda"))
    fed.dp_add_noise(q)  # the build and the first launch, outside the trace
    torch.cuda.synchronize()
    launched = dgauss_cuda.launches
    events = _traced(lambda: fed.dp_add_noise(q))
    assert dgauss_cuda.launches == launched + 1
    xs = [e for e in events if e.get("ph") == "X"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
              if e.get("cat") == "user_annotation" and e["name"].startswith("sda.")]
    assert not [r for r in ranges if r[2].startswith("sda.sync.")]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in xs
                   if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    records = [e for e in xs if e.get("cat") == "kernel" and "dgauss_kernel" in e.get("name", "")]
    assert len(records) == 1
    at = launched_at[records[0]["args"]["correlation"]]
    holders = sorted((r for r in ranges if r[0] <= at <= r[1]), key=lambda r: r[1] - r[0])
    assert [r[2] for r in holders][:2] == ["sda.dp.noise.draw", "sda.dp.noise"]
