"""The port's protocol records, keystore and host helpers against ``sda_tpu``.

Every JSON codec of the port's records and schemes gives the reference's
bytes and the golden fixtures' (``tests/wire_fixtures.py``, transcribed from
the original SDA sources); keystore directories written by either package
load in the other, and what they hold still seals, opens, signs and
verifies across; ``share_batches`` and ``uniform_mod_host`` equal the
reference's on the same inputs. Inputs come from seeded numpy generators;
every comparison is exact.
"""

import json

import numpy as np
import pytest

import sda_tpu.protocol as jp
import sda_tpu_torch.protocol as tp
import wire_fixtures as wf
from sda_tpu.crypto import Keystore as JKeystore
from sda_tpu.crypto import CryptoModule as JCryptoModule
from sda_tpu.crypto import encryption as jenc
from sda_tpu.crypto import signing as jsigning
from sda_tpu.ops import rng as jrng
from sda_tpu.ops import shamir as jshamir
from sda_tpu_torch.crypto import CryptoModule, Keystore
from sda_tpu_torch.crypto import encryption as tenc
from sda_tpu_torch.crypto import signing as tsigning
from sda_tpu_torch.ops import rng as trng
from sda_tpu_torch.ops import shamir as tshamir


def _compact(obj) -> str:
    return json.dumps(obj.to_json(), separators=(",", ":"), ensure_ascii=False)


def _signed_key(proto):
    return proto.signed_encryption_key_from_json


# (fixture name, how each package decodes it)
FIXTURES = [
    ("ENCRYPTION_SODIUM", lambda p: p.Encryption.from_json),
    ("ENCRYPTION_KEY_SODIUM", lambda p: p.EncryptionKey.from_json),
    ("SIGNATURE_SODIUM", lambda p: p.Signature.from_json),
    ("VERIFICATION_KEY_SODIUM", lambda p: p.VerificationKey.from_json),
    ("MASKING_NONE", lambda p: p.LinearMaskingScheme.from_json),
    ("MASKING_FULL", lambda p: p.LinearMaskingScheme.from_json),
    ("MASKING_CHACHA", lambda p: p.LinearMaskingScheme.from_json),
    ("SHARING_ADDITIVE", lambda p: p.LinearSecretSharingScheme.from_json),
    ("SHARING_PACKED_SHAMIR", lambda p: p.LinearSecretSharingScheme.from_json),
    ("ADDITIVE_ENCRYPTION_SODIUM", lambda p: p.AdditiveEncryptionScheme.from_json),
    ("AGENT", lambda p: p.Agent.from_json),
    ("PROFILE_DEFAULT", lambda p: p.Profile.from_json),
    ("PROFILE_FULL", lambda p: p.Profile.from_json),
    ("SIGNED_ENCRYPTION_KEY", _signed_key),
    ("AGGREGATION", lambda p: p.Aggregation.from_json),
    ("CLERK_CANDIDATE", lambda p: p.ClerkCandidate.from_json),
    ("COMMITTEE", lambda p: p.Committee.from_json),
    ("PARTICIPATION_NO_RECIPIENT", lambda p: p.Participation.from_json),
    ("PARTICIPATION_WITH_RECIPIENT", lambda p: p.Participation.from_json),
    ("SNAPSHOT", lambda p: p.Snapshot.from_json),
    ("CLERKING_JOB", lambda p: p.ClerkingJob.from_json),
    ("CLERKING_RESULT", lambda p: p.ClerkingResult.from_json),
    ("AGGREGATION_STATUS", lambda p: p.AggregationStatus.from_json),
    ("SNAPSHOT_RESULT", lambda p: p.SnapshotResult.from_json),
    ("SNAPSHOT_RESULT_NO_MASKS", lambda p: p.SnapshotResult.from_json),
]


@pytest.mark.parametrize("name", [n for n, _ in FIXTURES])
def test_codec_matches_fixture_and_reference(name):
    decoder = dict(FIXTURES)[name]
    text = getattr(wf, name)
    ours = decoder(tp)(json.loads(text))
    theirs = decoder(jp)(json.loads(text))
    assert _compact(ours) == text == _compact(theirs)


@pytest.mark.parametrize("size", [8, 32, 64])
def test_fixed_byte_arrays(size):
    want = {8: wf.B8_ZERO_B64, 32: wf.B32_ZERO_B64, 64: wf.B64_ZERO_B64}[size]
    cls = getattr(tp, f"B{size}")
    assert cls().to_json() == want == getattr(jp, f"B{size}")().to_json()
    assert cls.from_json(want).data == bytes(size)


def test_canonical_signing_bytes():
    body = json.loads(wf.SIGNED_ENCRYPTION_KEY)["body"]
    labelled = tp.Labelled.from_json(body, tp.EncryptionKeyId, tp.EncryptionKey)
    assert tp.canonical_bytes(labelled) == wf.CANONICAL_LABELLED_KEY


def _records(proto):
    """Records the fixtures do not cover: basic Shamir, the optional tier
    and paging fields, ids built from values."""
    ids = {n: getattr(proto, n)(u) for n, u in (
        ("AggregationId", wf.AGG_UUID), ("AgentId", wf.AGENT_UUID),
        ("EncryptionKeyId", wf.EKEY_UUID), ("SnapshotId", wf.SNAP_UUID),
        ("ClerkingJobId", wf.JOB_UUID), ("ParticipationId", wf.PART_UUID))}
    agg = proto.Aggregation(
        id=ids["AggregationId"], title="t", vector_dimension=9, modulus=433,
        recipient=ids["AgentId"], recipient_key=ids["EncryptionKeyId"],
        masking_scheme=proto.FullMasking(433),
        committee_sharing_scheme=proto.BasicShamirSharing(5, 2, 433),
        recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
        committee_encryption_scheme=proto.SodiumEncryptionScheme())
    tiered = proto.Aggregation(**{**agg.__dict__, "sub_cohort_size": 4, "tiers": 2,
                                  "tier_promotion": "reshare"})
    job = proto.ClerkingJob(id=ids["ClerkingJobId"], clerk=ids["AgentId"],
                            aggregation=ids["AggregationId"], snapshot=ids["SnapshotId"],
                            encryptions=[], total_encryptions=10_000, chunk_size=4096)
    result = proto.SnapshotResult(snapshot=ids["SnapshotId"], number_of_participations=3,
                                  clerk_encryptions=[], recipient_encryptions=None,
                                  mask_encryption_count=3, clerk_result_count=8, chunk_size=4096)
    part = proto.Participation(
        id=ids["ParticipationId"], participant=ids["AgentId"], aggregation=ids["AggregationId"],
        recipient_encryption=None,
        clerk_encryptions=[(ids["AgentId"], proto.Encryption(proto.Binary(b"\x01\x02\x03")))],
        tier_reshare=proto.TierReshare(child=ids["AggregationId"], epoch=1, position=2,
                                       survivors=[0, 2, 3]))
    return [agg, tiered, job, result, part, proto.Pong(True)]


@pytest.mark.parametrize("i", range(6))
def test_other_records_match_reference(i):
    ours, theirs = _records(tp)[i], _records(jp)[i]
    assert _compact(ours) == _compact(theirs)
    assert _compact(type(ours).from_json(json.loads(_compact(theirs)))) == _compact(theirs)


PAILLIER = {
    "Encryption": '{"Paillier":"AQI="}',
    "EncryptionKey": '{"Paillier":{"n":"15"}}',
    "AdditiveEncryptionScheme": '{"PackedPaillier":{"component_count":2,"component_bitsize":40,'
                                '"max_value_bitsize":30,"min_modulus_bitsize":512}}',
}


@pytest.mark.parametrize("record", sorted(PAILLIER))
def test_paillier_records_match_reference(record):
    """The Packed Paillier extension's records decode in the port and
    re-encode to the reference's bytes, each package reading the other's."""
    text = PAILLIER[record]
    theirs = getattr(jp, record).from_json(json.loads(text))
    ours = getattr(tp, record).from_json(json.loads(text))
    assert type(ours).__name__ == type(theirs).__name__
    assert _compact(ours) == _compact(theirs) == text
    back = getattr(jp, record).from_json(json.loads(_compact(ours)))
    assert _compact(back) == text


@pytest.mark.parametrize("writer", ["reference writes", "port writes"])
def test_keystore_directories_load_across(tmp_path, writer):
    if writer == "reference writes":
        w_crypto, r_crypto = JCryptoModule(JKeystore(tmp_path)), CryptoModule(Keystore(tmp_path), "cpu")
        w_proto, w_enc, r_enc, r_sign = jp, jenc, tenc, tsigning
    else:
        w_crypto, r_crypto = CryptoModule(Keystore(tmp_path), "cpu"), JCryptoModule(JKeystore(tmp_path))
        w_proto, w_enc, r_enc, r_sign = tp, tenc, jenc, jsigning
    key_id = w_crypto.new_encryption_key()
    vk = w_crypto.new_signature_key()
    agent = w_proto.Agent(id=w_proto.AgentId.random(), verification_key=vk)
    signed = w_crypto.sign_encryption_key(agent, key_id)

    pair = r_crypto.keystore.get_encryption_keypair(str(key_id))
    sig_pair = r_crypto.keystore.get_signature_keypair(str(vk.id))
    written = w_crypto.keystore.get_encryption_keypair(key_id)
    assert pair.ek.data == written.ek.data and pair.dk.data == written.dk.data
    assert sig_pair.vk.data == vk.body.data
    assert json.dumps(pair.to_json()) == json.dumps(written.to_json())
    # a box sealed by the writer's package opens with the loaded key, and
    # the reader's signature over the same body equals the writer's
    m = np.arange(-50, 50, dtype=np.int64)
    box = w_enc.new_share_encryptor(written.ek, w_proto.SodiumEncryptionScheme()).encrypt(m)
    opened = r_enc.SodiumDecryptor(pair).decrypt(_reencode(box, r_enc))
    np.testing.assert_array_equal(opened, m)
    resigned = r_sign.sign(_reencode(signed.body, r_sign), _reencode(agent.id, r_sign), sig_pair)
    assert resigned.signature.data == signed.signature.data
    assert r_sign.signature_is_valid(_reencode(agent, r_sign), _reencode(signed, r_sign))


def _reencode(obj, module):
    """``obj`` decoded by the package ``module`` belongs to, through JSON."""
    proto = tp if module.__name__.startswith("sda_tpu_torch") else jp
    if isinstance(obj, (tp.Signed, jp.Signed)):
        return proto.signed_encryption_key_from_json(obj.to_json())
    if isinstance(obj, (tp.Labelled, jp.Labelled)):
        return proto.Labelled.from_json(obj.to_json(), proto.EncryptionKeyId, proto.EncryptionKey)
    return getattr(proto, type(obj).__name__).from_json(obj.to_json())


SCHEMES = [
    ("packed 433", (3, 8, 4, 433, 354, 150)),
    ("basic 433", (5, 2, 433)),
]


@pytest.mark.parametrize("label", [s for s, _ in SCHEMES])
def test_share_batches_matches_reference(label):
    args = dict(SCHEMES)[label]
    ours = (tp.PackedShamirSharing if len(args) == 6 else tp.BasicShamirSharing)(*args)
    theirs = (jp.PackedShamirSharing if len(args) == 6 else jp.BasicShamirSharing)(*args)
    rng = np.random.default_rng(5)
    p = args[3] if len(args) == 6 else args[2]
    secrets = rng.integers(0, p, size=(40, ours.input_size))
    randomness = rng.integers(0, p, size=(40, ours.privacy_threshold))
    got = tshamir.share_batches(secrets, randomness, tshamir.share_matrix(ours), p)
    want = jshamir.share_batches(secrets, randomness, jshamir.share_matrix(theirs), p)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [433, (1 << 31) - 1, (1 << 62) + 135, 1 << 63])
@pytest.mark.parametrize("shape", [(7,), (3, 5), ()])
def test_uniform_mod_host_matches_reference(m, shape):
    def entropy(seed):
        gen = np.random.default_rng(seed)
        return lambda n: gen.integers(0, 256, size=n, dtype=np.uint8).tobytes()

    got = trng.uniform_mod_host(shape, m, entropy=entropy(1))
    want = jrng.uniform_mod_host(shape, m, entropy=entropy(1))
    np.testing.assert_array_equal(got, want)
    assert got.shape == want.shape == shape and got.dtype == np.int64
    # the default OS-entropy path: the same shape and range
    draw = trng.uniform_mod_host((1000,), m)
    assert draw.shape == (1000,) and draw.min() >= 0 and int(draw.max()) < m


# -- the reference's public names: ids, parameters, the REST handler -----------


@pytest.mark.parametrize("cls", ["AgentId", "AggregationId", "SnapshotId", "EncryptionKeyId"])
def test_typed_id_from_str_matches_reference(cls):
    text = "5f9b3c1e-2d4a-4b6c-8e0f-1a2b3c4d5e6f"
    got, want = getattr(tp, cls).from_str(text), getattr(jp, cls).from_str(text)
    assert type(got) is getattr(tp, cls) and str(got) == str(want) == text
    assert got == getattr(tp, cls)(text)
    for package in (tp, jp):
        with pytest.raises(ValueError, match="unparseable uuid"):
            getattr(package, cls).from_str("not-a-uuid")


REF_VECTOR = (3, 8, 4, 433, 354, 150)  # tests/test_ops_field.py's REF_SCHEME


def _packed_cases():
    """tests/test_ops_field.py:58-76's schemes, and ill-formed variants."""
    from sda_tpu.ops import find_packed_parameters

    k, n, t, p, w2, w3 = REF_VECTOR
    cases = {"reference vector": REF_VECTOR}
    p8, a8, b8 = find_packed_parameters(3, 4, 8, min_modulus_bits=8, seed=0)
    cases["found at 8 bits"] = (3, 8, 4, p8, a8, b8)
    big = find_packed_parameters(64, 63, 242, min_modulus_bits=26, seed=0)
    cases["k=64 t=63 n=242"] = (64, 242, 63, *big)
    cases["omega_secrets of order 4"] = (k, n, t, p, w2 * w2 % p, w3)
    cases["omega_shares of order 3"] = (k, n, t, p, w2, pow(w3, 3, p))
    cases["composite modulus"] = (k, n, t, 435, w2, w3)
    cases["k + t + 1 not a power of 2"] = (k, n, t + 1, p, w2, w3)
    cases["n + 1 not a power of 3"] = (k, n + 1, t, p, w2, w3)
    cases["n below the reconstruction threshold"] = (3, 2, 4, 433, 354, 150)
    return cases


@pytest.mark.parametrize("label", list(_packed_cases()))
def test_validate_packed_parameters_matches_reference(label):
    from sda_tpu.ops import validate_packed_parameters as jvalidate
    from sda_tpu_torch.ops import validate_packed_parameters

    args = _packed_cases()[label]
    outcomes = []
    for validate, package in ((jvalidate, jp), (validate_packed_parameters, tp)):
        try:
            validate(package.PackedShamirSharing(*args))
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (label in ("reference vector", "found at 8 bits",
                                               "k=64 t=63 n=242"))


@pytest.mark.parametrize("x", [1, 2, 150, 354, 432, 433 + 354, 0])
def test_element_order_matches_reference(x):
    from sda_tpu.ops import element_order as jorder
    from sda_tpu_torch.ops import element_order

    if x == 0:
        for order in (jorder, element_order):
            with pytest.raises(ValueError, match="no multiplicative order"):
                order(0, 433)
        return
    assert element_order(x, 433) == jorder(x, 433)
    p = (1 << 61) - 1
    assert element_order(x + 5, p) == jorder(x + 5, p)


def test_element_order_of_the_reference_vector():
    from sda_tpu_torch.ops import element_order

    assert element_order(354, 433) == 8 and element_order(150, 433) == 9


@pytest.mark.parametrize("target", ["/v1/ping", "/v1/healthz", "/v1/nowhere", "/v1/agents/me"])
def test_make_handler_answers_as_the_reference(target):
    """``rest.make_handler`` gives the service's ``Router``, which answers
    unauthenticated requests as the reference's does."""
    from sda_tpu.rest import make_handler as jmake_handler
    from sda_tpu.server import new_mem_server as jnew_mem_server
    from sda_tpu_torch.rest import make_handler
    from sda_tpu_torch.rest.server import Router
    from sda_tpu_torch.server import new_mem_server

    handler = make_handler(new_mem_server())
    assert isinstance(handler, Router)
    got = handler.handle("GET", target, {})
    want = jmake_handler(jnew_mem_server()).handle("GET", target, {})
    assert (got.status, got.body) == (want.status, want.body)
    assert handler.handle("PUT", target, {}).status == 501
