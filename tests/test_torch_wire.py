"""The port's binary wire codec (``sda_tpu_torch/rest/wire.py``) against
``sda_tpu/rest/wire.py``: for the records of ``tests/wire_fixtures.py`` and
seeded random ones, the port's frames are byte-equal to the reference's,
each package decodes the other's frames to the same records, and the JSON
bodies that ``SDA_WIRE=json`` selects are byte-equal too. Then the codec's
safety contract on the port: every strict prefix and every trailing byte
raises ``WireError``, garbage never escapes it, and a frame of Packed
Paillier ciphertexts (variant tag 1) round-trips byte-equal to the
reference's."""

from __future__ import annotations

import json

import numpy as np
import pytest

import sda_tpu.protocol as jp
import sda_tpu_torch.protocol as tp
import wire_fixtures as fx
from sda_tpu.rest import wire as jwire
from sda_tpu_torch.rest import wire
from sda_tpu_torch.rest.wire import WireError


def _random_participations(seed, n, clerks):
    rng = np.random.default_rng(seed)
    blob = lambda k: bytes(rng.integers(0, 256, size=k, dtype=np.uint8))
    return [jp.Participation(
        id=jp.ParticipationId.random(), participant=jp.AgentId.random(),
        aggregation=jp.AggregationId.random(),
        recipient_encryption=jp.Encryption(blob(64)) if i % 2 == 0 else None,
        clerk_encryptions=[(jp.AgentId.random(), jp.Encryption(blob(48 + 8 * c)))
                           for c in range(clerks + i % 3)]) for i in range(n)]


def _records(kind, case):
    """Reference records of one payload kind: a fixture, empty, or random."""
    if kind == "participations":
        return {
            "fixture": [jp.Participation.from_json(json.loads(fx.PARTICIPATION_WITH_RECIPIENT)),
                        jp.Participation.from_json(json.loads(fx.PARTICIPATION_NO_RECIPIENT))],
            "empty": [],
            "random": _random_participations(3, 9, 4),
        }[case]
    if kind == "encryptions":
        rng = np.random.default_rng(5)
        return {
            "fixture": [jp.Encryption.from_json(json.loads(fx.ENCRYPTION_SODIUM))],
            "empty": [],
            "random": [jp.Encryption(bytes(rng.integers(0, 256, size=k, dtype=np.uint8)))
                       for k in (0, 1, 48, 300, 129)],
        }[case]
    rng = np.random.default_rng(11)
    return {
        "fixture": [jp.ClerkingResult.from_json(json.loads(fx.CLERKING_RESULT))],
        "empty": [],
        "random": [jp.ClerkingResult(job=jp.ClerkingJobId.random(), clerk=jp.AgentId.random(),
                                     encryption=jp.Encryption(bytes(rng.integers(
                                         0, 256, size=40 + i, dtype=np.uint8))))
                   for i in range(6)],
    }[case]


CODECS = {  # kind -> (port record type, encode/decode in each package)
    "participations": (tp.Participation, "encode_participations", "decode_participations"),
    "encryptions": (tp.Encryption, "encode_encryptions", "decode_encryptions"),
    "clerking_results": (tp.ClerkingResult, "encode_clerking_results", "decode_clerking_results"),
}


def _json(records):
    return json.dumps([r.to_json() for r in records], separators=(",", ":"))


@pytest.mark.parametrize("case", ["fixture", "empty", "random"])
@pytest.mark.parametrize("kind", sorted(CODECS))
def test_frames_byte_equal_and_cross_decode(kind, case):
    record_cls, enc, dec = CODECS[kind]
    theirs = _records(kind, case)
    ours = [record_cls.from_json(r.to_json()) for r in theirs]
    frame = getattr(wire, enc)(ours)
    assert frame == getattr(jwire, enc)(theirs)
    # each package decodes the other's frame to the same records
    assert _json(getattr(wire, dec)(getattr(jwire, enc)(theirs))) == _json(theirs)
    assert getattr(jwire, dec)(frame) == theirs


@pytest.mark.parametrize("case", ["fixture", "random"])
@pytest.mark.parametrize("kind", sorted(CODECS))
def test_json_bodies_byte_equal(kind, case, monkeypatch):
    """``SDA_WIRE=json`` selects the JSON bodies in both packages, and the
    port's JSON bodies are the reference's bytes."""
    record_cls = CODECS[kind][0]
    theirs = _records(kind, case)
    ours = [record_cls.from_json(r.to_json()) for r in theirs]
    assert _json(ours) == _json(theirs)
    monkeypatch.setenv("SDA_WIRE", "json")
    assert wire.mode() == jwire.mode() == "json"
    monkeypatch.setenv("SDA_WIRE", "binary")
    assert wire.mode() == jwire.mode() == "binary"
    monkeypatch.delenv("SDA_WIRE")
    assert wire.mode() == jwire.mode() == "binary"


def test_negotiation_helpers_equal_reference():
    assert wire.CONTENT_TYPE == jwire.CONTENT_TYPE == "application/x-sda-binary"
    for header in (None, "", "application/json", "application/x-sda-binary",
                   "Application/X-SDA-Binary; charset=x", "text/plain, application/x-sda-binary"):
        assert wire.is_binary(header) == jwire.is_binary(header)
        assert wire.accepts_binary(header) == jwire.accepts_binary(header)


def test_i64_column_boundary_values():
    values = np.array([0, 1, -1, 63, -64, 2**62, -(2**62), 2**63 - 1, -(2**63)], dtype=np.int64)
    parts, jparts = [], []
    wire._put_i64_column(parts, values)
    jwire._put_i64_column(jparts, values)
    assert b"".join(parts) == b"".join(jparts)
    r = wire._Reader(b"".join(parts))
    np.testing.assert_array_equal(wire._get_i64_column(r, len(values)), values)
    r.expect_eof()


@pytest.mark.parametrize("kind", sorted(CODECS))
def test_every_truncation_raises_cleanly(kind):
    record_cls, enc, dec = CODECS[kind]
    ours = [record_cls.from_json(r.to_json()) for r in _records(kind, "random")]
    frame = getattr(wire, enc)(ours)
    for cut in range(len(frame)):
        with pytest.raises(WireError):
            getattr(wire, dec)(frame[:cut])
    with pytest.raises(WireError, match="trailing"):
        getattr(wire, dec)(frame + b"\x00")


def test_header_validation_and_overlong_uvarint():
    good = wire.encode_encryptions([tp.Encryption(b"abc")])
    with pytest.raises(WireError, match="magic"):
        wire.decode_encryptions(b"XXXX" + good[4:])
    with pytest.raises(WireError, match="version"):
        wire.decode_encryptions(good[:4] + b"\x7f" + good[5:])
    with pytest.raises(WireError, match="kind"):
        wire.decode_participations(good)
    with pytest.raises(WireError):
        wire.decode_encryptions(good[:6] + b"\xff" * 10 + b"\x01")


def test_garbage_fuzz_never_escapes_wireerror():
    rng = np.random.default_rng(2024)
    header = wire.MAGIC + bytes((wire.VERSION, wire.KIND_PARTICIPATIONS))
    for _ in range(200):
        noise = bytes(rng.integers(0, 256, size=int(rng.integers(0, 120)), dtype=np.uint8))
        try:
            wire.decode_participations(header + noise)
        except WireError:
            pass


def test_paillier_tag_round_trips():
    theirs = [jp.Encryption(b"x" * 9, "Paillier"), jp.Encryption(b"abc"),
              jp.Encryption(b"\x00\x01" * 40, "Paillier")]
    frame = jwire.encode_encryptions(theirs)
    ours = wire.decode_encryptions(frame)
    assert [e.variant for e in ours] == ["Paillier", "Sodium", "Paillier"]
    assert [bytes(e.inner) for e in ours] == [bytes(e.inner) for e in theirs]
    assert wire.encode_encryptions(ours) == frame
    assert jwire.decode_encryptions(wire.encode_encryptions(ours)) == theirs
    with pytest.raises(WireError, match="variant tag"):
        wire.decode_encryptions(frame[:7] + b"\x05" + frame[8:])
