"""The port's own sealed boxes and Ed25519 against libsodium.

``sda_tpu_torch.crypto.sodium`` binds no shared library; ``sda_tpu.crypto.
sodium`` binds the system libsodium by ctypes. Every case here holds the
port's bytes or verdicts against libsodium's: boxes sealed by either open in
the other, forged boxes and small-order keys are refused by both,
signatures are byte-equal, and verification agrees on valid and on each kind
of bad signature libsodium 1.0.18 rejects. Message bytes come from a seeded
numpy generator; there is no tolerance: every comparison is exact.
"""

import numpy as np
import pytest

from sda_tpu.crypto import sodium as ref
from sda_tpu_torch.crypto import sodium as port

LENGTHS = [0, 1, 15, 16, 17, 63, 64, 65, 1000, 1_330_000]
P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
# X25519 small-order u-coordinates: 0, 1 and a point of order 8
SMALL_ORDER_U = {
    "u=0": bytes(32),
    "u=1": (1).to_bytes(32, "little"),
    "order 8": bytes.fromhex(
        "e0eb7a7c3b41b8ae1656e3faf19fc46ada098deb9c32b1fd866205165f49b800"),
}
# an Ed25519 point of order 8 (libsodium's small-order blacklist)
ED_ORDER_8 = bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")


def _message(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed + n).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("direction", ["port seals", "libsodium seals"])
def test_sealed_boxes_open_across(n, direction):
    m = _message(n)
    pk, sk = ref.box_keypair()
    if direction == "port seals":
        c = port.seal(m, pk)
        assert ref.seal_open(c, pk, sk) == m
    else:
        c = ref.seal(m, pk)
        assert port.seal_open(c, pk, sk) == m
    assert len(c) == n + port.SEALBYTES == n + ref.SEALBYTES


def test_port_keypair_opens_libsodium_box():
    pk, sk = port.box_keypair()
    m = _message(333)
    assert port.seal_open(ref.seal(m, pk), pk, sk) == m
    assert ref.seal_open(port.seal(m, pk), pk, sk) == m


@pytest.mark.parametrize("i", range(3))
def test_x25519_public_key_of_libsodium_secret(i):
    pk, sk = ref.box_keypair()
    assert port.x25519(sk, (9).to_bytes(32, "little")) == pk


@pytest.mark.parametrize("where", ["epk", "tag", "body"])
def test_flipped_byte_refused_by_both(where):
    pk, sk = ref.box_keypair()
    c = bytearray(port.seal(_message(100), pk))
    c[{"epk": 5, "tag": 40, "body": 90}[where]] ^= 0x01
    with pytest.raises(port.SodiumError):
        port.seal_open(bytes(c), pk, sk)
    with pytest.raises(ref.SodiumError):
        ref.seal_open(bytes(c), pk, sk)


def test_short_ciphertext_refused_by_both():
    pk, sk = ref.box_keypair()
    for impl in (port, ref):
        with pytest.raises(impl.SodiumError):
            impl.seal_open(bytes(47), pk, sk)


@pytest.mark.parametrize("label", sorted(SMALL_ORDER_U))
def test_small_order_keys_refused_by_both(label):
    u = SMALL_ORDER_U[label]
    # sealing to a small-order recipient key
    for impl in (port, ref):
        with pytest.raises(impl.SodiumError):
            impl.seal(b"secret", u)
    # opening a box whose ephemeral key is of small order
    pk, sk = ref.box_keypair()
    forged = u + bytes(16) + b"secret"
    for impl in (port, ref):
        with pytest.raises(impl.SodiumError):
            impl.seal_open(forged, pk, sk)


@pytest.mark.parametrize("n", [0, 3, 64, 1000])
def test_signatures_byte_equal_to_libsodium(n):
    vk, sk = ref.sign_keypair()
    m = _message(n, seed=7)
    sig = port.sign_detached(m, sk)
    assert sig == ref.sign_detached(m, sk)
    assert port.verify_detached(sig, m, vk) and ref.verify_detached(sig, m, vk)


def test_port_keypair_layout_and_libsodium_verifies():
    vk, sk = port.sign_keypair()
    assert len(vk) == 32 and len(sk) == 64 and sk[32:] == vk
    m = _message(200, seed=3)
    sig = port.sign_detached(m, sk)
    assert sig == ref.sign_detached(m, sk)
    assert ref.verify_detached(sig, m, vk)


def _bad_signatures():
    """(label, signature, message, key) cases libsodium 1.0.18 rejects."""
    vk, sk = ref.sign_keypair()
    m = _message(50, seed=11)
    sig = ref.sign_detached(m, sk)
    s = int.from_bytes(sig[32:], "little")
    # an encoding whose y has no x on the curve (decoding fails)
    y = next(y for y in range(2, 100) if port._recover_x(y, 0) is None)
    return [
        ("valid", sig, m, vk),
        ("S + L", sig[:32] + (s + L).to_bytes(32, "little"), m, vk),
        ("small-order R", ED_ORDER_8 + sig[32:], m, vk),
        ("identity R", (1).to_bytes(32, "little") + sig[32:], m, vk),
        ("small-order A", sig, m, ED_ORDER_8),
        ("non-canonical A", sig, m, (P + 2).to_bytes(32, "little")),
        ("A off the curve", sig, m, y.to_bytes(32, "little")),
        ("changed message", sig, m + b"!", vk),
        ("flipped R bit", bytes([sig[0] ^ 1]) + sig[1:], m, vk),
    ]


@pytest.mark.parametrize("case", range(9))
def test_verification_agrees_with_libsodium(case):
    label, sig, m, vk = _bad_signatures()[case]
    want = ref.verify_detached(sig, m, vk)
    assert port.verify_detached(sig, m, vk) is want
    assert want is (label == "valid")


# -- key generation and signing at the call sites run the native C -------------


def _plain_curve_raises(monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("the variable-time plain curve arithmetic was reached")

    monkeypatch.setattr(port, "_scalar_mult", plain)
    monkeypatch.setattr(port, "x25519", plain)


@pytest.mark.parametrize("site", ["agent", "encryption key", "signed key"])
def test_keygen_and_signing_never_reach_the_plain_curve(site, tmp_path, monkeypatch):
    """With ``crypto.sodium._scalar_mult`` and ``x25519`` made to raise, an
    agent's signature key, a box keypair and a signed key still come out,
    from the native layer's constant-time C, and libsodium verifies them;
    the plain functions the patch covers do raise."""
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import CryptoModule, Keystore
    from sda_tpu_torch.protocol import canonical_bytes

    _plain_curve_raises(monkeypatch)
    with pytest.raises(AssertionError, match="plain curve"):
        port.sign_keypair()
    with pytest.raises(AssertionError, match="plain curve"):
        port.box_keypair()
    keystore = Keystore(tmp_path)
    agent = SdaClient.new_agent(keystore)
    crypto = CryptoModule(keystore, device="cpu")
    vk = agent.verification_key.body.data
    if site == "agent":
        sk = keystore.get_signature_keypair(agent.verification_key.id).sk.data
        assert sk[32:] == vk and ref.verify_detached(ref.sign_detached(b"m", sk), b"m", vk)
        return
    key_id = crypto.new_encryption_key()
    pair = keystore.get_encryption_keypair(key_id)
    if site == "encryption key":
        m = _message(100, seed=5)
        assert ref.seal_open(ref.seal(m, pair.ek.data), pair.ek.data, pair.dk.data) == m
        return
    signed = crypto.sign_encryption_key(agent, key_id)
    assert signed.body.body == pair.ek
    assert ref.verify_detached(signed.signature.data, canonical_bytes(signed.body), vk)
