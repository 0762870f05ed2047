"""The plain references against hand sums, and ``correct`` against its
control and against faults planted under the timed path: each has to come
out false. Tiny sizes on the CPU, where the port runs its kernels' plain
versions; ``test_sdabench_card.py`` repeats the control on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sdabench import catalog
from test_sdabench_run import run

P61 = 1152921504606847201


def _ref(name):
    return catalog.reference(name)


def test_secure_sum_reference_is_the_hand_sum():
    ref = _ref("secure_sum")
    g = torch.Generator().manual_seed(1)
    hi = torch.randint(0, 1 << 28, (3, 4, 5), generator=g, dtype=torch.int32)
    lo = torch.randint(-(1 << 31), 1 << 31, (3, 4, 5), generator=g, dtype=torch.int32)
    sums = ref.pool_sums(hi, lo)
    order = [2, 0, 2, 1, 2]
    want = [sum((int(hi[j, r, c]) << 32) + (int(lo[j, r, c]) & 0xFFFFFFFF) for j in order for r in range(4)) % P61
            for c in range(5)]
    assert list(ref.aggregate(sums, order, P61)) == want


def test_fedavg_reference_is_the_hand_sum():
    ref = _ref("fedavg")
    p, clip, frac = 16777441, 8.0, 16
    updates = torch.tensor([[0.5, -9.0, 1.0 / 3.0], [2.5 / 65536, -0.25, 8.0], [-1.5 / 65536, 0.0, -7.75]],
                           dtype=torch.float32)
    want = []
    for c in range(3):
        total = 0
        for r in range(3):
            x = min(max(float(updates[r, c]), -clip), clip) * 2**frac
            total += int(np.rint(x))  # half to even, as the configuration states
        want.append(total % p)
    got = ref.field_sum(updates, clip, frac, p)
    assert got.tolist() == want
    mean = ref.mean_update(got, 3, frac, p)
    centered = [w - p if w > p // 2 else w for w in want]
    assert mean.tolist() == [c / 2**frac / 3 for c in centered]


def test_chacha20_block_is_rfc_8439s():
    """RFC 8439 sec. 2.3.2's block: its 32-bit counter and 96-bit nonce are
    words 12-15, which the 64-bit layout reads as counter and nonce words."""
    ref = _ref("chacha20")
    key = [int.from_bytes(bytes(range(4 * i, 4 * i + 4)), "little") for i in range(8)]
    block = ref.blocks(key, 1 | (0x09000000 << 32), 1, nonce=(0x4A000000, 0))
    want = bytes.fromhex("10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
                         "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
    assert block.astype("<u4").tobytes() == want


@pytest.mark.parametrize("p", [268435873, P61, (1 << 63) - 25])
def test_chacha20_mask_is_the_protocols(p):
    """The reference's mask against the port's host expansion: the protocol
    fixes it, so both have to give the same values."""
    from sda_tpu_torch.ops import chacha

    ref = _ref("chacha20")
    rng = np.random.default_rng(p)
    for words in (rng.integers(0, 1 << 32, 4, dtype=np.uint64).astype(np.uint32), np.zeros(8, np.uint32)):
        assert (ref.mask(words, 3000, p) == chacha.expand_seed(words, 3000, p)).all()


def _scheme(p_bits):
    from sda_tpu_torch.ops import find_packed_parameters

    p, ws, wn = find_packed_parameters(5, 2, 8, min_modulus_bits=p_bits, seed=0)
    return {"secret_count": 5, "privacy_threshold": 2, "share_count": 8, "prime_modulus": p,
            "omega_secrets": ws, "omega_shares": wn}


@pytest.mark.parametrize("p_bits", [28, 60])
def test_sharing_recovers_the_randomness(p_bits):
    """Shares made by the port's share matrix: the reference gets the
    randomness back from clerks 1..7 and clerk 0's share right; a wrong
    share of clerk 0 and zero randomness show."""
    from sda_tpu_torch.ops import shamir as port_shamir
    from sda_tpu_torch.protocol import PackedShamirSharing

    ref = _ref("shamir")
    scheme = _scheme(p_bits)
    p = scheme["prime_modulus"]
    S = [[int(v) for v in row] for row in port_shamir.share_matrix(PackedShamirSharing(**scheme))]
    rng = np.random.default_rng(p_bits)
    values = [[int(v) % p for v in rng.integers(0, 1 << 62, 7)] for _ in range(40)]

    def shares(rows):
        return np.array([[sum(S[i][j] * v[j] for j in range(7)) % p for v in rows] for i in range(8)], dtype=object)

    clerks = list(range(1, 8))
    randomness, bad = ref.sharing(shares(values), scheme, clerks)
    assert bad == 0 and randomness.tolist() == [[v[5] for v in values], [v[6] for v in values]]
    broken = shares(values)
    broken[0, 3] = (broken[0, 3] + 1) % p
    assert ref.sharing(broken, scheme, clerks)[1] == 1
    zero = ref.checks([shares([v[:5] + [0, 0] for v in values])], scheme, clerks)
    assert zero["randomness_zero_share"][0] == 1.0 and zero["randomness_mean_sigmas"][0] > 15
    sound = ref.checks([shares(values)], scheme, clerks)
    assert all(v <= limit for v, limit in sound.values()), sound
    assert all(v is None for v, _ in ref.checks([None], scheme, clerks).values())


# -- correct has to come out false ------------------------------------------


@pytest.mark.parametrize("workload", ["northstar.sumfirst", "cnn.engine"])
def test_control_is_not_correct(tiny_root, workload):
    """The reference in the program's place, one precision down."""
    result = run(tiny_root, workload, trace=False, control=True)
    assert result["correct"] is False and result["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _sumfirst_faults():
    from sda_tpu_torch.parallel import sumfirst

    from sda_tpu_torch.ops import rng

    real_pair, real_reveal = sumfirst.value_limb_sums_chunk_pair, sumfirst.reconstruct_from_clerk_sums
    return {
        # the share randomness drawn as zeros
        "zero_share_draws": (rng, "uniform_bits_device_pair", _zero_pair),
        # the chunk's step leaves the accumulator as it was
        "state_unchanged": (sumfirst, "value_limb_sums_chunk_pair",
                            lambda hi, lo, gen, plan, draw: torch.zeros_like(real_pair(hi, lo, gen, plan, draw))),
        # half of each chunk's participants left out
        "half_the_batch": (sumfirst, "value_limb_sums_chunk_pair",
                           lambda hi, lo, gen, plan, draw: real_pair(hi[: len(hi) // 2], lo[: len(lo) // 2],
                                                                      gen, plan, draw)),
        # one revealed value altered where it is produced
        "answer_altered": (sumfirst, "reconstruct_from_clerk_sums",
                           lambda *a: _bump(np.asarray(real_reveal(*a), dtype=object))),
    }


def _zero_pair(generator, shape, nbits):
    zeros = torch.zeros(tuple(shape), dtype=torch.int32, device=generator.device)
    return zeros, zeros.clone()


def _chacha_rounds(double_rounds: int):
    """ChaCha with ``double_rounds`` double rounds where 10 are due, in the
    port's state layout: a keystream that masks and folds alike."""
    from sda_tpu_torch.ops import chacha

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & chacha.MASK32

    def blocks(key_words, first_counter, n_blocks):
        state = chacha.chacha_state(key_words, first_counter, n_blocks)
        x = [state[..., i] for i in range(16)]
        for _ in range(double_rounds):
            for a, b, c, d in chacha._QUARTER_ROUNDS:
                x[a] = (x[a] + x[b]) & chacha.MASK32
                x[d] = rotl(x[d] ^ x[a], 16)
                x[c] = (x[c] + x[d]) & chacha.MASK32
                x[b] = rotl(x[b] ^ x[c], 12)
                x[a] = (x[a] + x[b]) & chacha.MASK32
                x[d] = rotl(x[d] ^ x[a], 8)
                x[c] = (x[c] + x[d]) & chacha.MASK32
                x[b] = rotl(x[b] ^ x[c], 7)
        out = chacha.i32_bits((torch.stack(x, dim=-1) + state) & chacha.MASK32)
        return out[0] if key_words.ndim == 1 else out
    return blocks


def _zero_keystream(key_words, first_counter, n_blocks):
    lead = (key_words.shape[0],) if key_words.ndim == 2 else ()
    return torch.zeros(lead + (n_blocks, 16), dtype=torch.int32, device=key_words.device)


def _engine_faults():
    import sda_tpu_torch.models as models
    from sda_tpu_torch.ops import chacha_cuda
    from sda_tpu_torch.parallel import engine

    real_share, real_fold = engine.share_combine_limb_streamed, chacha_cuda.combine_masks_device
    return {
        # ChaCha with 8 rounds for the masks and the fold alike: they cancel
        "fewer_chacha_rounds": (chacha_cuda, "chacha_blocks_cuda", _chacha_rounds(4)),
        # every mask zero, on both sides
        "zero_masks": (chacha_cuda, "chacha_blocks_cuda", _zero_keystream),
        # the share randomness drawn as zeros
        "zero_share_draws": (engine, "_device_randomness",
                             lambda generator, shape, modulus: torch.zeros(tuple(shape), dtype=torch.int64,
                                                                           device=generator.device)),
        # the round's model update leaves the global model as it was
        "state_unchanged": (models, "fedavg_apply",
                            lambda g, u, device=None: {k: {n: t.to(torch.float64) for n, t in v.items()}
                                                       for k, v in g.items()}),
        # half of each chunk's participants left out of the share and combine
        "half_the_batch": (engine, "share_combine_limb_streamed",
                           lambda s, gen, plan, draw=None: real_share(s[: len(s) // 2], gen, plan, draw)),
        # one value of the recipient's fold altered where it is produced
        "answer_altered": (chacha_cuda, "combine_masks_device",
                           lambda *a, **k: _bump(real_fold(*a, **k))),
    }


def _bump(x):
    x = x.clone() if isinstance(x, torch.Tensor) else x.copy()
    x[0] = x[0] + 1
    return x


COMMON = ["state_unchanged", "half_the_batch", "answer_altered", "zero_share_draws"]
FAULTS = [("northstar.sumfirst", f) for f in COMMON] + \
    [("cnn.engine", f) for f in COMMON + ["fewer_chacha_rounds", "zero_masks"]]


def faults_of(workload: str) -> dict:
    """``fault -> (module, name, broken)``: what to plant, by fault."""
    return _sumfirst_faults() if workload == "northstar.sumfirst" else _engine_faults()


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    """The harness's run with the timed path broken underneath. The cells
    run on one chip, so no exchange between chips can be left out. A fault
    on both sides of a cancellation (masks, share randomness) fails only
    the numbers that the reference works out apart from the sums."""
    module, name, broken = faults_of(workload)[fault]
    monkeypatch.setattr(module, name, broken)
    result = run(tiny_root, workload, trace=False)
    assert result["correct"] is False, result["checks"]
    if fault in ("fewer_chacha_rounds", "zero_masks"):
        assert result["checks"]["field_sum_mismatches"]["value"] == 0  # the masks still cancel
        assert result["checks"]["mask_mismatches"]["value"] > 0
    if fault == "zero_share_draws":
        assert result["checks"]["randomness_zero_share"]["value"] == 1.0


def test_faults_reach_the_timed_path(tiny_root):
    """Each planted function is one the cells call: a run that counts the
    calls sees them."""
    calls = {}

    def counting(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        return wrapped

    planted = {(module, name) for workload, fault in FAULTS for module, name, _ in [faults_of(workload)[fault]]}
    mp = pytest.MonkeyPatch()
    try:
        for module, name in planted:
            mp.setattr(module, name, counting(module, name))
        assert run(tiny_root, "northstar.sumfirst", trace=False)["correct"]
        assert run(tiny_root, "cnn.engine", trace=False)["correct"]
    finally:
        mp.undo()
    assert set(calls) == {name for _, name in planted}
