"""``chip_smoke.py``'s ChaCha20 bounds and its fold recorder, on the CPU.

K2's and K2x's least times are the benchmark's own yardstick
(``sdabench.least_time``: 640 integer-pipe operations a 64-byte block)
beside the bytes each kernel must move; ``_Folds`` swaps
``masking.combine_masks_device`` for a recording call and puts the
original back on any exit."""

import pytest

import chip_smoke
from sdabench import least_time


@pytest.mark.parametrize("seeds, n_blocks, dim", [(25, 207_923, 1_663_370), (1, 2, 10), (2_000, 1_251, 10_000)])
def test_chacha_bounds_are_least_time_plus_bytes(seeds, n_blocks, dim):
    moved, bytes_ms, ops_ms = chip_smoke._chacha_bound(seeds, n_blocks)
    assert moved == seeds * 32 + seeds * n_blocks * 64  # keys, keystream blocks
    assert bytes_ms == pytest.approx(moved / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert ops_ms == pytest.approx(seeds * n_blocks * 640 / least_time.int_pipe_ops_per_s() * 1e3)
    moved, bytes_ms, ops_ms = chip_smoke._expand_bound(seeds, dim)
    assert moved == seeds * 32 + seeds * dim * 8 + seeds * 4  # keys, int64 masks, int32 counts
    assert bytes_ms == pytest.approx(moved / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert ops_ms == pytest.approx(least_time.chacha_s(seeds, dim) * 1e3)
    assert ops_ms == pytest.approx(chip_smoke._chacha_bound(seeds, least_time.chacha_blocks(dim))[2])


def test_fold_recorder_restores_the_combine_when_its_body_raises():
    from sda_tpu_torch.crypto import masking

    real = masking.combine_masks_device
    with pytest.raises(RuntimeError, match="in the body"):
        with chip_smoke._Folds() as folds:
            assert masking.combine_masks_device is not real
            raise RuntimeError("in the body")
    assert masking.combine_masks_device is real and folds == []
    folds.remove()  # a second removal changes nothing
    assert masking.combine_masks_device is real
