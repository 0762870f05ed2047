"""The port's Packed Paillier plane against ``sda_tpu``'s.

``keygen`` draws its primes and ``encrypt`` its ``r`` from ``secrets``, so
the key is generated once by the reference and loaded into the port, and
ciphertexts are compared at a fixed ``r`` (or with ``secrets.randbelow``
replayed from one seeded stream for both packages): ``encrypt``, ``add``,
``decrypt`` and ``Packing`` give the reference's integers; the Paillier
``Encryption`` bytes, the key and keypair JSON, the scheme JSON and its
validation errors, ``combine_encryptions`` and
``paillier_ciphertext_well_formed`` give the reference's bytes and
verdicts. Then whole rounds: Full masking with the masks sealed to a
Paillier key reveals exactly in process and over loopback HTTP in all four
pairings of the port's and the reference's client and server, with the
server's homomorphic combine leaving one mask ciphertext, or the
uncombined list over the packing's capacity; the server's checks refuse
what the reference's refuses. Keys are 512 bits, as the reference's tests
use; the arithmetic does not depend on the size.
"""

from __future__ import annotations

import dataclasses
import json
import random
import secrets

import numpy as np
import pytest

import sda_tpu.protocol as jp
import sda_tpu.rest as jrest
import sda_tpu_torch.protocol as tp
import sda_tpu_torch.rest as trest
from sda_tpu.client import SdaClient as JClient
from sda_tpu.crypto import Keystore as JKeystore
from sda_tpu.crypto import encryption as jenc
from sda_tpu.crypto import keystore as jkeystore
from sda_tpu.ops import paillier as jpaillier
from sda_tpu.server import new_mem_server as j_server
from sda_tpu.server import snapshot as jsnapshot
from sda_tpu_torch.client import SdaClient as TClient
from sda_tpu_torch.crypto import Keystore as TKeystore
from sda_tpu_torch.crypto import encryption as tenc
from sda_tpu_torch.crypto import keystore as tkeystore
from sda_tpu_torch.ops import paillier
from sda_tpu_torch.server import new_mem_server as t_server
from sda_tpu_torch.server import snapshot as tsnapshot

BITS = 512


@pytest.fixture(scope="module")
def keys():
    """One reference keypair, as (reference pk, sk, port pk, sk)."""
    jpk, jsk = jpaillier.keygen(BITS)
    return (jpk, jsk, paillier.PaillierPublicKey(jpk.n),
            paillier.PaillierPrivateKey(jsk.n, jsk.lam, jsk.mu))


def _replayed_randomness(monkeypatch, seed: int):
    """Replace ``secrets.randbelow`` (both packages' draw of ``r``) by a
    seeded stream; returns a function that restarts it."""
    state = {}

    def restart():
        state["rng"] = random.Random(seed)

    def randbelow(n):
        return state["rng"].randrange(n)

    restart()
    monkeypatch.setattr(secrets, "randbelow", randbelow)
    return restart


# -- the cryptosystem -------------------------------------------------------------


@pytest.mark.parametrize("m", [0, 1, 12345, 1 << 300, "n-1"])
def test_encrypt_at_a_fixed_r_and_decrypt_match(keys, m):
    jpk, jsk, pk, sk = keys
    m = pk.n - 1 if m == "n-1" else m
    r = random.Random(m if isinstance(m, int) and m < 1 << 64 else 7).randrange(1, pk.n)
    c = paillier.encrypt(pk, m, r)
    assert c == jpaillier.encrypt(jpk, m, r)
    assert paillier.decrypt(sk, c) == jpaillier.decrypt(jsk, c) == m


def test_add_and_range_refusals_match(keys):
    jpk, jsk, pk, sk = keys
    rng = np.random.default_rng(0)
    total = 0
    c = jc = paillier.encrypt(pk, 0, 3)
    for k in range(12):
        m = int(rng.integers(0, 1 << 40))
        e = paillier.encrypt(pk, m, 5 + k)
        c, jc = paillier.add(pk, c, e), jpaillier.add(jpk, jc, e)
        total += m
    assert c == jc
    assert paillier.decrypt(sk, c) == total
    for bad in (lambda mod: mod.encrypt(pk if mod is paillier else jpk, pk.n, 3),
                lambda mod: mod.decrypt(sk if mod is paillier else jsk, pk.n_sq)):
        errors = []
        for mod in (paillier, jpaillier):
            with pytest.raises(ValueError) as e:
                bad(mod)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_port_keygen_round_trips():
    pk, sk = paillier.keygen(BITS)
    assert pk.n.bit_length() == BITS and paillier.PaillierPublicKey(sk.n) == pk
    for m in (0, 99, pk.n - 1):
        assert paillier.decrypt(sk, paillier.encrypt(pk, m)) == m
    assert paillier.encrypt(pk, 7) != paillier.encrypt(pk, 7)


@pytest.mark.parametrize("layout", [(4, 40, 32), (10, 40, 32), (1, 62, 62), (50, 40, 32)])
def test_packing_matches(keys, layout):
    jpk = keys[0]
    ours, theirs = paillier.Packing(*layout), jpaillier.Packing(*layout)
    rng = np.random.default_rng(layout[0])
    values = [int(v) for v in rng.integers(0, 1 << layout[2], size=layout[0], dtype=np.uint64)]
    assert ours.pack(values) == theirs.pack(values)
    assert ours.unpack(ours.pack(values)) == values
    assert ours.unpack(12345678901234567890, 3) == theirs.unpack(12345678901234567890, 3)
    assert (ours.plaintext_bits, ours.additions_capacity) == (theirs.plaintext_bits,
                                                             theirs.additions_capacity)
    assert ours.fits(jpk) == theirs.fits(jpk)


@pytest.mark.parametrize("case", ["slots", "too many", "outside", "negative"])
def test_packing_refusals_match(case):
    errors = []
    for mod in (paillier, jpaillier):
        with pytest.raises(ValueError) as e:
            if case == "slots":
                mod.Packing(1, 8, 9)
            packing = mod.Packing(2, 40, 32)
            packing.pack({"too many": [1, 2, 3], "outside": [1 << 32], "negative": [0, -1]}[case])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_vectors_match_on_replayed_randomness(keys, monkeypatch):
    jpk, jsk, pk, sk = keys
    packing, jpacking = paillier.Packing(5, 40, 32), jpaillier.Packing(5, 40, 32)
    rng = np.random.default_rng(1)
    vectors = rng.integers(0, 1 << 32, size=(12, 13), dtype=np.uint64)
    restart = _replayed_randomness(monkeypatch, 11)
    outs = []
    for mod, key, pack in ((paillier, pk, packing), (jpaillier, jpk, jpacking)):
        restart()
        combined = None
        for vec in vectors:
            blocks = mod.encrypt_vector(key, pack, [int(v) for v in vec])
            combined = blocks if combined is None else mod.add_vectors(key, combined, blocks)
        outs.append(combined)
    assert outs[0] == outs[1] and len(outs[0]) == 3
    got = paillier.decrypt_vector(sk, packing, outs[0], 13)
    assert got == jpaillier.decrypt_vector(jsk, jpacking, outs[0], 13)
    assert got == [int(w) for w in vectors.astype(object).sum(axis=0)]
    with pytest.raises(ValueError, match="fit"):
        paillier.encrypt_vector(pk, paillier.Packing(20, 40, 32), [1])
    with pytest.raises(ValueError, match="mismatched"):
        paillier.add_vectors(pk, outs[0], outs[0][:2])
    with pytest.raises(ValueError, match="shorter"):
        paillier.decrypt_vector(sk, packing, outs[0][:1], 13)


# -- records, wire bytes and the encryptors -----------------------------------------


def _schemes(component_count=10, component_bitsize=40, max_value_bitsize=32,
             min_modulus_bitsize=BITS):
    args = (component_count, component_bitsize, max_value_bitsize, min_modulus_bitsize)
    return tp.PackedPaillierEncryptionScheme(*args), jp.PackedPaillierEncryptionScheme(*args)


def test_key_keypair_and_scheme_json_match(keys, tmp_path):
    jpk, jsk = keys[0], keys[1]
    ours = tp.PaillierEncryptionKey(jpk.n)
    theirs = jp.PaillierEncryptionKey(jpk.n)
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())
    assert tp.EncryptionKey.from_json(theirs.to_json()) == ours
    pair = tkeystore.PaillierKeypair(ek=ours, lam=jsk.lam, mu=jsk.mu)
    jpair = jkeystore.PaillierKeypair(ek=theirs, lam=jsk.lam, mu=jsk.mu)
    assert json.dumps(pair.to_json()) == json.dumps(jpair.to_json())
    assert tkeystore.EncryptionKeypair.from_json(jpair.to_json()) == pair
    scheme, jscheme = _schemes()
    assert json.dumps(scheme.to_json()) == json.dumps(jscheme.to_json())
    assert tp.AdditiveEncryptionScheme.from_json(jscheme.to_json()) == scheme
    assert scheme.batch_size() == jscheme.batch_size() == 10
    # a keystore directory written by either package loads in the other
    key_id = tp.EncryptionKeyId.random()
    TKeystore(tmp_path / "port").put_encryption_keypair(key_id, pair)
    loaded = JKeystore(tmp_path / "port").get_encryption_keypair(jp.EncryptionKeyId(str(key_id)))
    assert json.dumps(loaded.to_json()) == json.dumps(jpair.to_json())
    JKeystore(tmp_path / "ref").put_encryption_keypair(jp.EncryptionKeyId(str(key_id)), jpair)
    assert TKeystore(tmp_path / "ref").get_encryption_keypair(key_id) == pair


@pytest.mark.parametrize("args", [(10, 30, 32, 512), (10, 63, 32, 2048), (13, 40, 32, 520),
                                  (12, 40, 32, 480)])
def test_scheme_validation_matches(args):
    errors = []
    for proto in (tp, jp):
        with pytest.raises(ValueError) as e:
            proto.PackedPaillierEncryptionScheme(*args)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_encryptor_bytes_decryptor_and_combine_match(keys, monkeypatch):
    jpk, jsk = keys[0], keys[1]
    scheme, jscheme = _schemes()
    ek, jek = tp.PaillierEncryptionKey(jpk.n), jp.PaillierEncryptionKey(jpk.n)
    pair = tkeystore.PaillierKeypair(ek=ek, lam=jsk.lam, mu=jsk.mu)
    jpair = jkeystore.PaillierKeypair(ek=jek, lam=jsk.lam, mu=jsk.mu)
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 433, size=(5, 23))
    restart = _replayed_randomness(monkeypatch, 5)
    restart()
    ours = [tenc.new_share_encryptor(ek, scheme).encrypt(row) for row in rows]
    restart()
    theirs = [jenc.new_share_encryptor(jek, jscheme).encrypt(row) for row in rows]
    assert [(e.variant, bytes(e.inner)) for e in ours] == [(e.variant, bytes(e.inner))
                                                          for e in theirs]
    assert json.dumps(ours[0].to_json()) == json.dumps(theirs[0].to_json())
    assert tp.Encryption.from_json(theirs[0].to_json()) == ours[0]
    decryptor = tenc.new_share_decryptor(pair, scheme)
    for e, row in zip(ours, rows):
        np.testing.assert_array_equal(decryptor.decrypt(e), row)
    combined = tenc.combine_encryptions(ek, scheme, ours)
    assert bytes(combined.inner) == bytes(jenc.combine_encryptions(jek, jscheme, theirs).inner)
    np.testing.assert_array_equal(decryptor.decrypt(combined), rows.sum(axis=0))
    np.testing.assert_array_equal(jenc.new_share_decryptor(jpair, jscheme).decrypt(theirs[0]),
                                  decryptor.decrypt(ours[0]))
    with pytest.raises(ValueError, match="nonnegative"):
        tenc.new_share_encryptor(ek, scheme).encrypt(np.array([1, -1]))
    with pytest.raises(TypeError, match="Paillier public key"):
        tenc.new_share_encryptor(tp.EncryptionKey(b"\x01" * 32), scheme)
    with pytest.raises(ValueError, match="mismatched vector lengths"):
        tenc.combine_encryptions(ek, scheme, [ours[0], tenc.new_share_encryptor(
            ek, scheme).encrypt(rows[0][:5])])
    with pytest.raises(ValueError, match="Paillier ciphertext"):
        decryptor.decrypt(tp.Encryption(b"\x00" * 10))
    with pytest.raises(ValueError, match="sodium decryptor"):
        tenc.SodiumDecryptor(type("K", (), {"ek": tp.EncryptionKey(b"\x01" * 32),
                                            "dk": tp.EncryptionKey(b"\x02" * 32)})).decrypt(ours[0])


def _malformed(good: bytes, case: str) -> tuple:
    """(variant, payload bytes, expected values) for one well-formedness case."""
    head, body = good[:4], good[4:]
    block = len(body) // 3
    return {
        "good": ("Paillier", good, 23),
        "sodium tag": ("Sodium", good, 23),
        "count off": ("Paillier", (24).to_bytes(4, "big") + body, 23),
        "count unchecked": ("Paillier", (24).to_bytes(4, "big") + body, None),
        "misaligned": ("Paillier", good[:-1], 23),
        "missing block": ("Paillier", head + body[:2 * block], 23),
        "zero block": ("Paillier", head + bytes(block) + body[block:], 23),
        "block at n^2": ("Paillier", head + b"\xff" * block + body[block:], 23),
        "empty": ("Paillier", (0).to_bytes(4, "big"), 0),
    }[case]


@pytest.mark.parametrize("case", ["good", "sodium tag", "count off", "count unchecked",
                                  "misaligned", "missing block", "zero block", "block at n^2",
                                  "empty"])
def test_well_formedness_verdicts_match(keys, case):
    jpk = keys[0]
    scheme, jscheme = _schemes()
    ek, jek = tp.PaillierEncryptionKey(jpk.n), jp.PaillierEncryptionKey(jpk.n)
    good = bytes(tenc.new_share_encryptor(ek, scheme).encrypt(np.arange(23)).inner)
    variant, payload, expected = _malformed(good, case)
    ours = tenc.paillier_ciphertext_well_formed(tp.Encryption(payload, variant), ek, scheme,
                                                expected)
    theirs = jenc.paillier_ciphertext_well_formed(jp.Encryption(payload, variant), jek, jscheme,
                                                  expected)
    assert ours == theirs
    assert ours == (case in ("good", "count unchecked", "empty"))


def test_participation_frame_with_paillier_masks_round_trips(keys):
    from sda_tpu.rest import wire as jwire
    from sda_tpu_torch.rest import wire

    jpk = keys[0]
    scheme = _schemes()[0]
    mask = tenc.new_share_encryptor(tp.PaillierEncryptionKey(jpk.n), scheme).encrypt(np.arange(9))
    part = jp.Participation(
        id=jp.ParticipationId.random(), participant=jp.AgentId.random(),
        aggregation=jp.AggregationId.random(),
        recipient_encryption=jp.Encryption(bytes(mask.inner), "Paillier"),
        clerk_encryptions=[(jp.AgentId.random(), jp.Encryption(b"sealed" * 9))])
    frame = jwire.encode_participations([part])
    ours = wire.decode_participations(frame)
    assert ours[0].recipient_encryption == mask
    assert wire.encode_participations(ours) == frame


# -- the server's combine and checks, whole rounds -----------------------------------


def test_combine_falls_back_on_a_malformed_upload(keys):
    """The snapshot's combine keeps the uncombined list when one stored
    ciphertext cannot be combined, as the reference's does."""
    jpk = keys[0]
    scheme, jscheme = _schemes()
    ek = tp.PaillierEncryptionKey(jpk.n)
    good = tenc.new_share_encryptor(ek, scheme).encrypt(np.arange(23))
    encryptions = [good, tp.Encryption(bytes(good.inner)[:-1], "Paillier")]

    class Signed:
        body = type("Body", (), {"body": ek})

    class Server:
        agents_store = type("Agents", (), {"get_encryption_key": lambda self, key: Signed()})()

    agg = type("Agg", (), {"recipient_encryption_scheme": scheme, "recipient_key": None})
    assert tsnapshot._maybe_combine_masks(Server(), agg, encryptions) is encryptions
    (combined,) = tsnapshot._maybe_combine_masks(Server(), agg, [good, good])
    jagg = type("Agg", (), {"recipient_encryption_scheme": jscheme, "recipient_key": None})
    jserver = type("S", (), {"agents_store": type("A", (), {
        "get_encryption_key": lambda self, key: type("Sg", (), {
            "body": type("B", (), {"body": jp.PaillierEncryptionKey(jpk.n)})})()})()})()
    jgood = jp.Encryption(bytes(good.inner), "Paillier")
    (jcombined,) = jsnapshot._maybe_combine_masks(jserver, jagg, [jgood, jgood])
    assert bytes(combined.inner) == bytes(jcombined.inner)


P, DIM, CLERKS = 433, 23, 3
PORT = {"proto": tp, "client": TClient, "keystore": TKeystore, "server": t_server,
        "rest": trest}
REFERENCE = {"proto": jp, "client": JClient, "keystore": JKeystore, "server": j_server,
             "rest": jrest}
PACKAGES = {"port": PORT, "reference": REFERENCE}


def _member(pkg, root, service):
    keystore = pkg["keystore"](root)
    agent = pkg["client"].new_agent(keystore)
    if pkg is PORT:
        return TClient(agent, keystore, service, device="cpu")
    return JClient(agent, keystore, service)


def paillier_round(root, pkg, service_for, values, component_bitsize=40):
    """A Full-masked additive round whose masks are sealed to a Paillier
    key; returns (revealed values, stored mask ciphertexts)."""
    proto = pkg["proto"]
    recipient = _member(pkg, root / "recipient", service_for("recipient"))
    recipient.upload_agent()
    rkey = recipient.new_paillier_encryption_key(BITS)
    recipient.upload_encryption_key(rkey)
    clerks = [_member(pkg, root / f"clerk{i}", service_for(f"clerk{i}")) for i in range(CLERKS)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())
    agg = proto.Aggregation(
        id=proto.AggregationId.random(), title="paillier round", vector_dimension=DIM, modulus=P,
        recipient=recipient.agent.id, recipient_key=rkey, masking_scheme=proto.FullMasking(P),
        committee_sharing_scheme=proto.AdditiveSharing(share_count=CLERKS, modulus=P),
        recipient_encryption_scheme=proto.PackedPaillierEncryptionScheme(
            10, component_bitsize, 32, BITS),
        committee_encryption_scheme=proto.SodiumEncryptionScheme())
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)
    for i, row in enumerate(values):
        part = _member(pkg, root / f"part{i}", service_for(f"part{i}"))
        part.upload_agent()
        part.participate([int(v) for v in row], agg.id)
    recipient.end_aggregation(agg.id)
    for clerk in clerks:
        clerk.run_chores(-1)
    status = recipient.service.get_aggregation_status(recipient.agent, agg.id)
    result = recipient.service.get_snapshot_result(recipient.agent, agg.id,
                                                   status.snapshots[0].id)
    masks = (result.mask_encryption_count if result.is_paged()
             else len(result.recipient_encryptions))
    return recipient.reveal_aggregation(agg.id).positive().values, masks


def _values(n):
    return np.random.default_rng(20).integers(0, P, size=(n, DIM))


@pytest.mark.parametrize("component_bitsize,combined", [(40, True), (33, False)])
def test_in_process_round_combines_within_capacity(tmp_path, component_bitsize, combined):
    """Capacity 2^8 holds 3 participants: one combined ciphertext; capacity
    2^1 does not: the three uploads stay uncombined. Both reveal exactly,
    as the reference's round does."""
    values = _values(3)
    outs = []
    for name, pkg in PACKAGES.items():
        server = pkg["server"]()
        outs.append(paillier_round(tmp_path / name, pkg, lambda _: server, values,
                                   component_bitsize))
    assert outs[0][1] == outs[1][1] == (1 if combined else 3)
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][0], values.sum(axis=0) % P)


@pytest.mark.parametrize("paged", [False, True], ids=["bulk", "paged"])
@pytest.mark.parametrize("client,server", [("port", "port"), ("port", "reference"),
                                           ("reference", "port"), ("reference", "reference")])
def test_rest_round_in_every_pairing(tmp_path, monkeypatch, client, server, paged):
    if paged:
        for key in ("SDA_JOB_PAGE_THRESHOLD", "SDA_RESULT_PAGE_THRESHOLD"):
            monkeypatch.setenv(key, "0")
        for key in ("SDA_JOB_CHUNK_SIZE", "SDA_RESULT_CHUNK_SIZE"):
            monkeypatch.setenv(key, "2")
    values = _values(5)
    cpkg, spkg = PACKAGES[client], PACKAGES[server]
    with spkg["rest"].serve_background(spkg["server"]()) as url:
        out, masks = paillier_round(
            tmp_path, cpkg,
            lambda name: cpkg["rest"].SdaHttpClient(url, cpkg["rest"].TokenStore(tmp_path / name)),
            values)
    assert masks == 1
    np.testing.assert_array_equal(out, values.sum(axis=0) % P)


@pytest.mark.parametrize("case", ["chacha masking", "committee encryption", "component bound",
                                  "malformed upload"])
def test_server_refusals_match(tmp_path, keys, case):
    """The port's server refuses what the reference's refuses, with the
    same message: Paillier over ChaCha seeds, Paillier as the committee's
    transport, a modulus beyond the component bound, and a malformed mask
    ciphertext at the door."""
    messages = []
    for name, pkg in PACKAGES.items():
        proto = pkg["proto"]
        server = pkg["server"]()
        recipient = _member(pkg, tmp_path / name / "recipient", server)
        recipient.upload_agent()
        rkey = recipient.new_paillier_encryption_key(BITS)
        recipient.upload_encryption_key(rkey)
        clerks = [_member(pkg, tmp_path / name / f"c{i}", server) for i in range(CLERKS)]
        for clerk in clerks:
            clerk.upload_agent()
            clerk.upload_encryption_key(clerk.new_encryption_key())
        pscheme = proto.PackedPaillierEncryptionScheme(10, 40, 32, BITS)
        fields = dict(
            id=proto.AggregationId.random(), title="refusal", vector_dimension=DIM, modulus=P,
            recipient=recipient.agent.id, recipient_key=rkey, masking_scheme=proto.FullMasking(P),
            committee_sharing_scheme=proto.AdditiveSharing(share_count=CLERKS, modulus=P),
            recipient_encryption_scheme=pscheme,
            committee_encryption_scheme=proto.SodiumEncryptionScheme())
        if case == "chacha masking":
            fields["masking_scheme"] = proto.ChaChaMasking(modulus=P, dimension=DIM,
                                                           seed_bitsize=128)
        elif case == "committee encryption":
            fields["committee_encryption_scheme"] = pscheme
        elif case == "component bound":
            fields["recipient_encryption_scheme"] = proto.PackedPaillierEncryptionScheme(
                10, 40, 8, BITS)
        agg = proto.Aggregation(**fields)
        with pytest.raises(proto.InvalidRequestError) as e:
            recipient.upload_aggregation(agg)
            recipient.begin_aggregation(agg.id)
            part = _member(pkg, tmp_path / name / "part", server)
            part.upload_agent()
            row = part.new_participation(list(range(DIM)), agg.id)
            blob = bytes(row.recipient_encryption.inner)
            part.upload_participation(dataclasses.replace(
                row, recipient_encryption=proto.Encryption(blob[:-1], "Paillier")))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
