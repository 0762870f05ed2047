"""The port's native batch layer (``sda_tpu_torch.native``, C built here with
the host's compiler) against its plain versions and against ``sda_tpu``.

- varints byte-equal to ``sda_tpu.crypto.varint`` and to the port's
  ``crypto/varint.py``, malformed streams refused with the same exception;
- sealed boxes byte-equal to ``crypto/sodium.seal_with_ephemeral`` at fixed
  ephemeral keys on both paths (comb tables and the ladder) and at 1 and 4
  threads, opened by libsodium (``sda_tpu.crypto.sodium``) and opening
  libsodium's boxes, refusals at the lowest failing index;
- ChaCha expansion bit-equal to ``sda_tpu.ops.chacha.expand_seed`` and the
  fold to ``sda_tpu.native.chacha_combine``, across the moduli and dims that
  cross the rejection zone's edge and the keystream refills;
- key generation and signing: the box public key byte-equal to libsodium's
  ``crypto_scalarmult_base`` and to the plain ``x25519``, Ed25519 seed
  keypairs and detached signatures byte-equal to libsodium's and to
  ``crypto/sodium.py`` over seeded seeds and messages of 0 bytes to a
  CNN-width row's 1.33 MB, verified by both packages;
- the counters under the reference's labels, the call sites that reach the
  layer, no silent fallback when it cannot be built, and two processes
  building it at once.

A build failure fails this file: nothing here is skipped. Every comparison
is exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sda_tpu.crypto import sodium as ref_sodium
from sda_tpu.crypto import varint as ref_varint
from sda_tpu_torch import native, telemetry
from sda_tpu_torch.crypto import sodium, varint

ROOT = Path(__file__).resolve().parent.parent
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
ORDER_8 = bytes.fromhex("e0eb7a7c3b41b8ae1656e3faf19fc46ada098deb9c32b1fd866205165f49b800")
SMALL_ORDER = {"zero key": bytes(32), "order 8": ORDER_8}
MODULI = [2, 433, (1 << 31) - 1, (1 << 61) - 1, (1 << 62) + 1, 1 << 63]
DIMS = [0, 1, 8191, 8193]


def _rng(*salt):
    return np.random.default_rng([2015, *salt])


def _messages(n: int, *salt, lengths=(0, 1, 1000)) -> list:
    rng = _rng(n, *salt)
    return [rng.integers(0, 256, size=lengths[i % len(lengths)], dtype=np.uint8).tobytes()
            for i in range(n)]


def _keys(count: int, *salt) -> bytes:
    return _rng(count, 99, *salt).integers(0, 256, size=32 * count, dtype=np.uint8).tobytes()


def _keypairs(n: int) -> list:
    return [ref_sodium.box_keypair() for _ in range(n)]


def _counts() -> dict:
    return {(c["name"], c["labels"].get("path")): c["value"]
            for c in telemetry.snapshot(include_spans=0)["counters"]
            if c["name"].startswith("sda_crypto_")}


def _lifts(pk: bytes) -> bool:
    return native.participation_keys(8, [pk, ref_sodium.box_keypair()[0]]) == 8


def _twist_key() -> bytes:
    """A u-coordinate of large order on the twist: it does not lift to a
    curve point, so sealing to it takes the ladder."""
    for u in range(2, 100):
        pk = u.to_bytes(32, "little")
        if not _lifts(pk):
            return pk
    raise AssertionError("no twist point below u = 100")


def test_library_builds_from_the_sources():
    native.build()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.available()


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

VARINT_CASES = {
    "zero": [0],
    "one": [1],
    "minus one": [-1],
    "int64 min": [I64_MIN],
    "int64 max": [I64_MAX],
    "extremes": [I64_MIN, -1, 0, 1, I64_MAX, I64_MIN + 1, I64_MAX - 1],
    "empty": [],
    "random 1000": list(_rng(1).integers(I64_MIN, I64_MAX, size=1000, dtype=np.int64)),
    "random small": list(_rng(2).integers(-300, 300, size=5000)),
    "random shares": list(_rng(3).integers(-(1 << 31), 1 << 31, size=20_000)),
}


@pytest.mark.parametrize("case", sorted(VARINT_CASES))
def test_varints_byte_equal(case):
    values = np.asarray(VARINT_CASES[case], dtype=np.int64)
    got = native.varint_encode(values)
    assert got == ref_varint.encode_i64(values) == varint.encode_i64(values)
    decoded = native.varint_decode(got)
    assert decoded.dtype == np.int64 and np.array_equal(decoded, values)
    assert np.array_equal(decoded, ref_varint.decode_i64(got))


MALFORMED = {
    "lone continuation": b"\x80",
    "truncated tail": b"\x02\x04\x81",
    "eleven bytes": b"\xff" * 10 + b"\x01",
    "long then truncated": b"\xff" * 12,
    "beyond 64 bits": b"\xff" * 9 + b"\x7f",  # accepted: the top bits drop
    "ten bytes": b"\xfe" + b"\xff" * 8 + b"\x01",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_varints_same_as_plain(case):
    buf = MALFORMED[case]
    outcomes = []
    for decode in (native.varint_decode, varint.decode_i64, ref_varint.decode_i64):
        try:
            outcomes.append(("ok", decode(buf).tolist()))
        except Exception as e:  # noqa: BLE001 - the type and message are compared
            outcomes.append((type(e), str(e)))
    assert outcomes[0] == outcomes[1] == outcomes[2]


# ---------------------------------------------------------------------------
# sealed boxes: C against plain at fixed ephemeral keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("n", [1, 7, 8, 20])
def test_seal_batch_equals_plain(n, threads):
    pk, sk = ref_sodium.box_keypair()
    msgs = _messages(n, threads)
    keys = _keys(n, threads)
    got = native.seal_batch(msgs, pk, n_threads=threads, ephemeral_keys=keys)
    want = [sodium.seal_with_ephemeral(m, pk, keys[32 * i:32 * i + 32])
            for i, m in enumerate(msgs)]
    assert got == want
    assert native.open_batch(got, pk, sk, n_threads=threads) == msgs


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("shape", [(1, 3), (1, 7), (1, 8), (3, 8), (16, 8)],
                         ids=lambda s: f"P{s[0]}xC{s[1]}")
def test_seal_participations_equals_plain(shape, threads):
    P, C = shape
    pairs = _keypairs(C)
    pks = [pk for pk, _ in pairs]
    matrix = [_messages(C, p, threads) for p in range(P)]
    n_keys = native.participation_keys(P, pks)
    comb = P * C >= 8
    assert n_keys == (P if comb else P * C)
    keys = _keys(n_keys, P, C, threads)
    got = native.seal_participations(matrix, pks, n_threads=threads, ephemeral_keys=keys)

    def key(p, c):
        i = p if comb else p * C + c
        return keys[32 * i:32 * i + 32]

    want = [[sodium.seal_with_ephemeral(matrix[p][c], pks[c], key(p, c)) for c in range(C)]
            for p in range(P)]
    assert got == want
    if comb:  # one ephemeral public key per participant
        assert all(len({box[:32] for box in row}) == 1 for row in got)
    for c, (pk, sk) in enumerate(pairs):
        column = [got[p][c] for p in range(P)]
        assert native.open_batch(column, pk, sk) == [matrix[p][c] for p in range(P)]


@pytest.mark.parametrize("n", [1, 9])
def test_seal_to_a_key_that_does_not_lift_takes_the_ladder(n):
    pk = _twist_key()
    msgs = _messages(n, 5)
    keys = _keys(n, 5)
    assert native.participation_keys(n, [pk]) == n
    got = native.seal_batch(msgs, pk, ephemeral_keys=keys)
    assert got == [sodium.seal_with_ephemeral(m, pk, keys[32 * i:32 * i + 32])
                   for i, m in enumerate(msgs)]
    matrix = [[m, m] for m in msgs]
    pks = [pk, ref_sodium.box_keypair()[0]]
    keys2 = _keys(2 * n, 6)
    assert native.participation_keys(n, pks) == 2 * n
    got2 = native.seal_participations(matrix, pks, ephemeral_keys=keys2)
    assert got2 == [[sodium.seal_with_ephemeral(matrix[p][c], pks[c], keys2[32 * (2 * p + c):][:32])
                     for c in range(2)] for p in range(n)]


def test_cnn_width_row_seals_equal_plain():
    """One share row at the FedAvg CNN's width (1,663,370 values), sealed
    to 8 clerks on the comb path, byte-equal to the plain seal."""
    row = _rng(7).integers(-(1 << 30), 1 << 30, size=1_663_370)
    encoded = native.varint_encode(row)
    pairs = _keypairs(8)
    pks = [pk for pk, _ in pairs]
    keys = _keys(1, 7)
    got = native.seal_participations([[encoded] * 8], pks, ephemeral_keys=keys)[0]
    assert got[3] == sodium.seal_with_ephemeral(encoded, pks[3], keys)
    assert ref_sodium.seal_open(got[5], *pairs[5]) == encoded
    assert np.array_equal(native.varint_decode(native.open_batch([got[0]], *pairs[0])[0]), row)


# ---------------------------------------------------------------------------
# interoperation with libsodium
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 12])
def test_libsodium_opens_c_boxes(n):
    pairs = _keypairs(3)
    msgs = _messages(n, 11)
    pk, sk = pairs[0]
    for box, m in zip(native.seal_batch(msgs, pk), msgs):
        assert ref_sodium.seal_open(box, pk, sk) == m
    matrix = [_messages(3, 12, p) for p in range(n)]
    sealed = native.seal_participations(matrix, [pk for pk, _ in pairs])
    for p in range(n):
        for c, (pk_c, sk_c) in enumerate(pairs):
            assert ref_sodium.seal_open(sealed[p][c], pk_c, sk_c) == matrix[p][c]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("n", [1, 5, 16])
def test_c_opens_libsodium_boxes(n, threads):
    pk, sk = ref_sodium.box_keypair()
    msgs = _messages(n, 13)
    boxes = [ref_sodium.seal(m, pk) for m in msgs]
    assert native.open_batch(boxes, pk, sk, n_threads=threads) == msgs


# ---------------------------------------------------------------------------
# refusals at the lowest failing index
# ---------------------------------------------------------------------------


def _expect_refusal(fn, index: int, plain):
    with pytest.raises(sodium.SodiumError) as got:
        fn()
    assert got.value.index == index
    with pytest.raises(sodium.SodiumError) as want:
        plain()
    assert str(want.value) in str(got.value)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("kind", ["tampered", "short", "empty"])
@pytest.mark.parametrize("n", [3, 12])
def test_open_refuses_at_the_index(kind, n, threads):
    pk, sk = ref_sodium.box_keypair()
    boxes = native.seal_batch(_messages(n, 17), pk)
    bad = n - 2
    if kind == "tampered":
        raw = bytearray(boxes[bad])
        raw[len(raw) // 2] ^= 0x01
        boxes[bad] = bytes(raw)
    else:
        boxes[bad] = boxes[bad][:47] if kind == "short" else b""
    # a later bad box must not win over the lowest one
    boxes[-1] = boxes[-1][:10]
    _expect_refusal(lambda: native.open_batch(boxes, pk, sk, n_threads=threads), bad,
                    lambda: sodium.seal_open(boxes[bad], pk, sk))
    with pytest.raises(ref_sodium.SodiumError):
        ref_sodium.seal_open(boxes[bad], pk, sk)


@pytest.mark.parametrize("label", sorted(SMALL_ORDER))
@pytest.mark.parametrize("n", [1, 9])
def test_open_refuses_small_order_ephemeral_keys(label, n):
    pk, sk = ref_sodium.box_keypair()
    boxes = native.seal_batch(_messages(n, 19), pk)
    forged = SMALL_ORDER[label] + bytes(16) + b"secret"
    boxes[n // 2] = forged
    _expect_refusal(lambda: native.open_batch(boxes, pk, sk), n // 2,
                    lambda: sodium.seal_open(forged, pk, sk))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("label", sorted(SMALL_ORDER))
@pytest.mark.parametrize("n", [1, 9])
def test_seal_batch_refuses_small_order_keys(label, n, threads):
    key = SMALL_ORDER[label]
    _expect_refusal(lambda: native.seal_batch(_messages(n, 23), key, n_threads=threads), 0,
                    lambda: sodium.seal(b"m", key))
    with pytest.raises(ref_sodium.SodiumError):
        ref_sodium.seal(b"m", key)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("label", sorted(SMALL_ORDER))
@pytest.mark.parametrize("P", [1, 4])
def test_seal_participations_refuses_small_order_keys(label, P, threads):
    pks = [pk for pk, _ in _keypairs(4)]
    pks[2] = SMALL_ORDER[label]
    matrix = [_messages(4, 29, p) for p in range(P)]
    _expect_refusal(lambda: native.seal_participations(matrix, pks, n_threads=threads), 2,
                    lambda: sodium.seal(b"m", SMALL_ORDER[label]))


def test_wrong_ephemeral_key_count_refused():
    pks = [pk for pk, _ in _keypairs(8)]
    with pytest.raises(ValueError, match="ephemeral keys"):
        native.seal_participations([[b"x"] * 8], pks, ephemeral_keys=bytes(32 * 8))
    with pytest.raises(ValueError, match="ephemeral keys"):
        native.seal_batch([b"x", b"y"], pks[0], ephemeral_keys=bytes(32))


# ---------------------------------------------------------------------------
# ChaCha expansion and fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("modulus", MODULI)
def test_chacha_expand_bit_equal(modulus, dim):
    from sda_tpu.ops.chacha import expand_seed as ref_expand

    seed = _rng(31, dim).integers(0, 1 << 32, size=4).astype(np.uint32)
    got = native.chacha_expand(seed, dim, modulus)
    assert got.dtype == np.int64 and got.shape == (dim,)
    assert np.array_equal(got, ref_expand(seed, dim, modulus))


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("modulus", MODULI)
def test_chacha_combine_bit_equal(modulus, dim):
    from sda_tpu import native as ref_native

    seeds = _rng(37, dim).integers(0, 1 << 32, size=(3, 4)).astype(np.uint32)
    got = native.chacha_combine(seeds, dim, modulus)
    assert np.array_equal(got, ref_native.chacha_combine(seeds, dim, modulus))


@pytest.mark.parametrize("modulus", [0, (1 << 63) + 1, 1 << 64])
def test_chacha_moduli_outside_the_range_raise(modulus):
    seed = np.arange(4, dtype=np.uint32)
    with pytest.raises(ValueError, match="modulus"):
        native.chacha_expand(seed, 8, modulus)
    with pytest.raises(ValueError, match="modulus"):
        native.chacha_combine(seed[None], 8, modulus)


# ---------------------------------------------------------------------------
# counters, call sites, no fallback, concurrent builds
# ---------------------------------------------------------------------------


def test_counters_carry_the_reference_labels():
    from sda_tpu import native as ref_native
    from sda_tpu import telemetry as ref_telemetry

    pk, sk = ref_sodium.box_keypair()
    before = _counts()
    boxes = native.seal_batch([b"a", b"b"], pk)
    native.seal_participations([[b"a"], [b"b"], [b"c"]], [pk])
    native.open_batch(boxes, pk, sk)
    native.chacha_expand(np.arange(4, dtype=np.uint32), 16, 433)
    native.chacha_combine(np.zeros((5, 4), np.uint32), 16, 433)
    after = _counts()
    grew = {key: after[key] - before.get(key, 0) for key in after if after[key] != before.get(key, 0)}
    assert grew == {("sda_crypto_seals_total", "batch"): 2, ("sda_crypto_seals_total", "comb"): 3,
                    ("sda_crypto_opens_total", "batch"): 2,
                    ("sda_crypto_chacha_expands_total", "native"): 6}
    ref_native._count_seals(1, "batch")
    ref_native._count_seals(1, "comb")
    ref_native._count_opens(1, "batch")
    ref_native._count_chacha(1, "native")
    ref_keys = {(c["name"], tuple(sorted(c["labels"].items())))
                for c in ref_telemetry.snapshot(include_spans=0)["counters"]
                if c["name"].startswith("sda_crypto_")}
    port_keys = {(c["name"], tuple(sorted(c["labels"].items())))
                 for c in telemetry.snapshot(include_spans=0)["counters"]
                 if c["name"].startswith("sda_crypto_")}
    assert {k for k in port_keys if k[1][0][1] in ("batch", "comb", "native")} <= ref_keys


# -- key generation and Ed25519 signing ----------------------------------------

# around SHA-512's 128-byte blocks and its 112-byte padding edge, and a
# CNN-width share row's length
SIGN_LENGTHS = [0, 1, 111, 112, 127, 128, 129, 1000, 4096, 1_330_000]


def _libsodium_seed_keypair(seed: bytes) -> tuple:
    import ctypes

    vk, sk = ctypes.create_string_buffer(32), ctypes.create_string_buffer(64)
    assert ref_sodium._sodium().crypto_sign_seed_keypair(vk, sk, seed) == 0
    return vk.raw, sk.raw


def _libsodium_public_key(secret_key: bytes) -> bytes:
    import ctypes

    pk = ctypes.create_string_buffer(32)
    assert ref_sodium._sodium().crypto_scalarmult_base(pk, secret_key) == 0
    return pk.raw


@pytest.mark.parametrize("salt", range(6))
def test_box_public_key_equals_libsodium_and_plain(salt):
    keys = _keys(8, 11, salt)
    for i in range(8):
        sk = keys[32 * i:32 * i + 32]
        pk = native.box_public_key(sk)
        assert pk == _libsodium_public_key(sk) == sodium.x25519(sk, sodium._BASE_U)


def test_box_keypair_opens_libsodium_boxes():
    pk, sk = native.box_keypair()
    assert native.box_public_key(sk) == pk
    m = _messages(1, 15)[0]
    assert ref_sodium.seal_open(ref_sodium.seal(m, pk), pk, sk) == m
    assert sodium.seal_open(ref_sodium.seal(m, pk), pk, sk) == m


@pytest.mark.parametrize("salt", range(4))
def test_sign_seed_keypair_equals_libsodium_and_plain(salt):
    seeds = _keys(8, 12, salt)
    for i in range(8):
        seed = seeds[32 * i:32 * i + 32]
        vk, sk = native.sign_seed_keypair(seed)
        a, _ = sodium._expand_seed(seed)
        assert (vk, sk) == _libsodium_seed_keypair(seed)
        assert vk == sodium._encode(sodium._scalar_mult(a, sodium._B)) and sk == seed + vk


@pytest.mark.parametrize("n", SIGN_LENGTHS)
def test_sign_detached_equals_libsodium_and_plain(n):
    seeds = _keys(3, 13, n)
    for i, m in enumerate(_messages(3, 13, n, lengths=(n,))):
        vk, sk = native.sign_seed_keypair(seeds[32 * i:32 * i + 32])
        sig = native.sign_detached(m, sk)
        assert sig == ref_sodium.sign_detached(m, sk) == sodium.sign_detached(m, sk)
        assert ref_sodium.verify_detached(sig, m, vk) and sodium.verify_detached(sig, m, vk)
        assert not sodium.verify_detached(sig, m + b"x", vk)


def test_sign_keypair_is_fresh_and_verifies():
    (vk1, sk1), (vk2, sk2) = native.sign_keypair(), native.sign_keypair()
    assert vk1 != vk2 and native.sign_seed_keypair(sk1[:32]) == (vk1, sk1)
    sig = native.sign_detached(b"labelled key", sk2)
    assert ref_sodium.verify_detached(sig, b"labelled key", vk2)


def test_sign_detached_refuses_a_short_key():
    with pytest.raises(sodium.SodiumError, match="crypto_sign_detached failed"):
        native.sign_detached(b"m", bytes(32))


def _call_sites():
    from sda_tpu_torch.crypto import encryption, masking, signing
    from sda_tpu_torch.crypto.keystore import EncryptionKeypair
    from sda_tpu_torch.ops.rng import uniform_mod_host
    from sda_tpu_torch.rest import wire

    pair = encryption.generate_encryption_keypair()
    assert isinstance(pair, EncryptionKeypair)
    enc = encryption.SodiumEncryptor(pair.ek)
    dec = encryption.SodiumDecryptor(pair)
    box = enc.encrypt(np.arange(5))
    masker = masking.ChaChaMasker(433, 64, 128, device="cpu")
    scheme = encryption.SodiumEncryptionScheme()
    sign_pair = signing.generate_signature_keypair()
    return {
        "encrypt": lambda: enc.encrypt(np.arange(5)),
        "encrypt_batch": lambda: enc.encrypt_batch([np.arange(5)] * 3),
        "decrypt": lambda: dec.decrypt(box),
        "decrypt_batch": lambda: dec.decrypt_batch([box, box]),
        "encrypt_share_matrix": lambda: encryption.encrypt_share_matrix(
            [pair.ek] * 2, scheme, [np.zeros((2, 4), np.int64)]),
        "mask": lambda: masker.mask(np.zeros(64, np.int64)),
        "combine": lambda: masker.combine([np.arange(4)] * 3),
        "uniform_mod_host": lambda: uniform_mod_host((600,), 433),
        "wire": lambda: wire._put_i64_column([], np.arange(5)),
        "box_keypair": encryption.generate_encryption_keypair,
        "sign_keypair": signing.generate_signature_keypair,
        "sign": lambda: signing.sign(scheme, None, sign_pair),
    }


SITES = ["encrypt", "encrypt_batch", "decrypt", "decrypt_batch", "encrypt_share_matrix", "mask",
         "combine", "uniform_mod_host", "wire", "box_keypair", "sign_keypair", "sign"]


@pytest.mark.parametrize("site", SITES)
def test_call_sites_reach_the_layer_and_never_fall_back(site, monkeypatch):
    call = _call_sites()[site]
    call()  # works while the layer is there

    def missing():
        raise RuntimeError("native layer unavailable")

    monkeypatch.setattr(native, "_load", missing)
    with pytest.raises(RuntimeError, match="native layer unavailable"):
        call()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "cc"
    fake.write_text("#!/bin/sh\necho 'cc: the sources do not compile' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "compiler", lambda: str(fake))
    with pytest.raises(RuntimeError, match="the sources do not compile"):
        native.varint_encode(np.arange(3))
    assert not native.available()
    assert not list((tmp_path / "build").glob("*"))


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.chacha_expand(np.arange(4, dtype=np.uint32), 8, 433)


BUILD_AND_USE = """
import sys
from pathlib import Path
import numpy as np
import sda_tpu_torch.native as native
from sda_tpu_torch.crypto import sodium
native.BUILD_DIR = Path(sys.argv[1])
pk, sk = sodium.box_keypair()
msgs = [b"a" * 100] * 9
assert native.open_batch(native.seal_batch(msgs, pk), pk, sk) == msgs
assert np.array_equal(native.varint_decode(native.varint_encode(np.arange(-5, 5))), np.arange(-5, 5))
print("built", native.library_path().name)
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    build_dir = tmp_path / "build"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_USE, str(build_dir)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [proc.communicate(timeout=120) for proc in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
        assert out.startswith("built libsdanative-")
    assert sorted(p.name for p in build_dir.iterdir()) == [outs[0][0].split()[1]]
