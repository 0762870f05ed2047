"""Every least time against a count made by hand at a tiny shape."""

from __future__ import annotations

import pytest

from sdabench import least_time as lt

PEAKS = {"hbm_bytes_per_s": 1000.0, "sms": 2, "int_pipe_lanes_per_sm": 4, "boost_clock_hz": 10.0}


def _quarter_round_ops():
    """Counts the XORs and rotations of ChaCha20's 20 rounds as RFC 8439
    writes them: a += b; d ^= a; d <<<= 16; c += d; b ^= c; b <<<= 12; ...
    with eight quarter rounds a double round."""
    ops = {"xor": 0, "rot": 0}
    for _ in range(10):  # double rounds
        for _ in range(8):  # four column and four diagonal quarter rounds
            for _ in range(4):  # the four add-xor-rotate steps of one quarter round
                ops["xor"] += 1
                ops["rot"] += 1
    return ops


def test_chacha_block_ops_are_its_xors_and_rotations():
    ops = _quarter_round_ops()
    assert ops == {"xor": 320, "rot": 320}
    assert lt.CHACHA_OPS_PER_BLOCK == ops["xor"] + ops["rot"]


@pytest.mark.parametrize("dim, blocks", [(1, 1), (8, 1), (9, 2), (16, 2), (17, 3), (1_663_370, 207_922)])
def test_chacha_blocks(dim, blocks):
    assert lt.chacha_blocks(dim) == blocks  # eight 64-bit draws a 64-byte block


def test_chacha_time():
    # 3 seeds x 2 blocks x 640 ops over 2 SMs x 4 lanes x 10 Hz
    assert lt.chacha_s(3, 9, PEAKS) == pytest.approx(3 * 2 * 640 / 80.0)


def test_bytes_times():
    assert lt.bytes_s(500, PEAKS) == 0.5
    # 4 participants x 3 dims x 8 bytes of (hi, lo) words
    assert lt.sumfirst_aggregate_s(4, 3, 8, PEAKS) == pytest.approx(96 / 1000.0)
    # 4 x 11 int32 read, 8 clerks x ceil(11 / 5) = 3 batches x 8 bytes written
    assert lt.share_s(4, 11, 8, 5, PEAKS) == pytest.approx((4 * 11 * 4 + 8 * 3 * 8) / 1000.0)


def test_masked_round_takes_the_larger_bound():
    # 2 participants x 9 dims: updates 2 x 9 x 4 = 72 bytes (0.072 s); ChaCha
    # for 4 expansions x 2 blocks x 640 ops (64 s): the ChaCha bound
    assert lt.masked_round_s(2, 9, 4, PEAKS) == pytest.approx(4 * 2 * 640 / 80.0)
    wide = {**PEAKS, "boost_clock_hz": 1e9}
    assert lt.masked_round_s(2, 9, 4, wide) == pytest.approx(0.072)


def test_published_peaks():
    assert lt.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert lt.int_pipe_ops_per_s() == pytest.approx(132 * 64 * 1.98e9)
    # the CNN round: 200 expansions of 1,663,370 values
    assert lt.masked_round_s(100, 1_663_370, 4) == pytest.approx(200 * 207_922 * 640 / (132 * 64 * 1.98e9))
