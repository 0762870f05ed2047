"""Both cells and their controls on the card, at the tiny sizes: the port's
kernels K1 and K2 run (not their plain versions), every sound run is
correct, and every control run and every run with a planted fault is not. Run on a machine with a card:

    python3 -m pytest sdabench/tests -q -m card
"""

from __future__ import annotations

import pytest

from test_sdabench_reference import FAULTS, faults_of
from test_sdabench_run import run


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", ["northstar.sumfirst", "cnn.engine"])
def test_cell_on_the_card(tiny_root, workload, trace):
    _card()
    result = run(tiny_root, workload, trace, device="cuda")
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0


@pytest.mark.card
@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("workload", ["northstar.sumfirst", "cnn.engine"])
def test_control_on_the_card(tiny_root, workload, seed):
    _card()
    result = run(tiny_root, workload, False, seed=seed, device="cuda", control=True)
    assert result["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload,fault", FAULTS)
def test_planted_fault_on_the_card(tiny_root, monkeypatch, workload, fault):
    _card()
    module, name, broken = faults_of(workload)[fault]
    monkeypatch.setattr(module, name, broken)
    result = run(tiny_root, workload, False, device="cuda")
    assert result["correct"] is False, result["checks"]
