"""Negotiated binary wire codec for the hot REST routes (copy of
``sda_tpu/rest/wire.py``; the frames are byte-equal to the reference's).

JSON carries every route fine, but the three bulk payloads — the
participation batch POST, the clerking-job chunk GET, and the
snapshot-result mask/clerk chunk GETs — pay base64 (+33% bytes) plus
per-field JSON encode/decode on both ends, and that is the measured
ingest ceiling once the host planes are batched and pooled. This module
defines ``application/x-sda-binary``: varint-framed *columns* of raw
sealed-box bytes, negotiated per request via ``Accept`` (GETs) /
``Content-Type`` (POSTs) so plain-JSON peers keep working unchanged.

Frame layout (pinned in docs/protocol.md):

    magic    4 bytes   b"SDAW"
    version  1 byte    0x01 — bumped on any layout change, never reused
    kind     1 byte    1=encryptions 2=participations 3=clerking results
    payload  columns, kind-specific

Column primitives:

    uvarint       unsigned LEB128 (framing counts and section lengths)
    i64 column    uvarint byte-length + zigzag-LEB128 stream, produced
                  and parsed by the native layer's varint calls
                  (``native/_sdanative.c``) — the same codec share
                  vectors already use
    uuid column   count x 16 raw bytes (count always known from context)
    bytes column  uvarint count + i64 column of per-item lengths +
                  the items' raw bytes, concatenated
    encryption column
                  uvarint count + one variant-tag byte per item
                  (index into ``Encryption.VARIANTS``) + bytes column
                  of the ciphertexts (lengths + concatenated payload)

Every read is bounds-checked against the delivered body: a truncated or
oversized frame raises ``WireError`` (a ``ValueError``) before any
object is half-built, and trailing bytes after a frame are an error too.
Crypto is untouched — the sealed-box ciphertexts cross this layer as
opaque bytes, byte-identical to their base64 JSON form. The variant tag
byte keeps ``sda_tpu``'s numbering: 0 for a sealed box, 1 for a Packed
Paillier ciphertext.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native
from ..protocol import (
    AgentId,
    AggregationId,
    ClerkingJobId,
    ClerkingResult,
    Encryption,
    Participation,
    ParticipationId,
)

#: the negotiated binary media type; requests/responses carrying it hold
#: exactly one frame as described in the module docstring
CONTENT_TYPE = "application/x-sda-binary"

MAGIC = b"SDAW"
VERSION = 1

KIND_ENCRYPTIONS = 1
KIND_PARTICIPATIONS = 2
KIND_CLERKING_RESULTS = 3


class WireError(ValueError):
    """A binary frame that cannot be decoded safely: truncated, trailing
    bytes, bad magic/version/kind, or inconsistent column framing."""


def mode() -> str:
    """The client's transport preference: ``binary`` (default) sends the
    negotiated frames on the hot routes; ``SDA_WIRE=json`` forces the
    legacy JSON bodies everywhere (interop / bisection knob)."""
    return "json" if os.environ.get("SDA_WIRE", "").strip().lower() == "json" else "binary"


def is_binary(content_type) -> bool:
    """Does a Content-Type header name the binary media type?"""
    if not content_type:
        return False
    return content_type.split(";", 1)[0].strip().lower() == CONTENT_TYPE


def accepts_binary(accept) -> bool:
    """Does an Accept header offer the binary media type? (Substring is
    enough: the exact token cannot appear inside another media type.)"""
    return bool(accept) and CONTENT_TYPE in accept


# -- primitives -------------------------------------------------------------


def _uvarint(n: int) -> bytes:
    """Unsigned LEB128 — framing counts and section byte-lengths."""
    if n < 0:
        raise WireError("uvarint cannot encode a negative value")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Reader:
    """Bounds-checked cursor over one delivered frame body."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int):
        if n < 0 or self.pos + n > len(self.buf):
            raise WireError(
                f"truncated binary frame: need {n} bytes at offset {self.pos}, "
                f"have {len(self.buf) - self.pos}"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def uvarint(self) -> int:
        shift = 0
        value = 0
        while True:
            if self.pos >= len(self.buf):
                raise WireError("truncated binary frame: unterminated uvarint")
            if shift > 63:
                raise WireError("uvarint too long for u64")
            b = self.buf[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not (b & 0x80):
                return value
            shift += 7

    def expect_eof(self) -> None:
        if self.pos != len(self.buf):
            raise WireError(
                f"trailing bytes after binary frame: {len(self.buf) - self.pos}"
            )


def _header(kind: int) -> bytes:
    return MAGIC + bytes((VERSION, kind))


def _open(buf: bytes, kind: int) -> _Reader:
    r = _Reader(bytes(buf))
    if bytes(r.take(len(MAGIC))) != MAGIC:
        raise WireError("bad magic: not an SDA binary frame")
    version = r.take(1)[0]
    if version != VERSION:
        raise WireError(f"unsupported binary wire version {version}")
    got = r.take(1)[0]
    if got != kind:
        raise WireError(f"unexpected binary payload kind {got} (wanted {kind})")
    return r


def _put_i64_column(parts: list, values) -> None:
    encoded = native.varint_encode(np.asarray(values, dtype=np.int64))
    parts.append(_uvarint(len(encoded)))
    parts.append(encoded)


def _get_i64_column(r: _Reader, count: int) -> np.ndarray:
    nbytes = r.uvarint()
    raw = bytes(r.take(nbytes))
    try:
        arr = native.varint_decode(raw)
    except ValueError as e:
        raise WireError(f"bad i64 column: {e}")
    if len(arr) != count:
        raise WireError(f"i64 column holds {len(arr)} values, framing says {count}")
    return arr


_VARIANT_TAG = {v: i for i, v in enumerate(Encryption.VARIANTS)}


def _put_encryptions(parts: list, encryptions) -> None:
    n = len(encryptions)
    parts.append(_uvarint(n))
    if not n:
        return
    # single pass; ``e.inner.data`` skips the ``data`` property descriptor,
    # measurable at thousands of ciphertexts per frame
    tags = bytearray(n)
    datas = []
    for i, e in enumerate(encryptions):
        tags[i] = _VARIANT_TAG[e.variant]
        datas.append(e.inner.data)
    parts.append(bytes(tags))
    _put_i64_column(
        parts, np.fromiter(map(len, datas), dtype=np.int64, count=n)
    )
    parts.append(b"".join(datas))


def _get_encryptions(r: _Reader) -> list:
    n = r.uvarint()
    if not n:
        return []
    variant_tags = bytes(r.take(n))
    lengths = _get_i64_column(r, n)
    if n and int(lengths.min()) < 0:
        raise WireError("negative ciphertext length in encryption column")
    blob = bytes(r.take(int(lengths.sum())))
    variants = Encryption.VARIANTS
    if max(variant_tags) >= len(variants):
        tag = next(t for t in variant_tags if t >= len(variants))
        raise WireError(f"unknown encryption variant tag {tag}")
    build = Encryption._from_wire
    ends = np.cumsum(lengths).tolist()
    starts = [0] + ends[:-1]
    if variant_tags.count(0) == n:
        # overwhelmingly common frame: every ciphertext is a sodium sealed
        # box — skip the per-item variant lookup entirely
        return [build(blob[s:e], "Sodium") for s, e in zip(starts, ends)]
    return [
        build(blob[s:e], variants[t])
        for s, e, t in zip(starts, ends, variant_tags)
    ]


def _put_uuid_column(parts: list, ids) -> None:
    parts.append(b"".join(i.uuid.bytes for i in ids))


def _get_uuid_column(r: _Reader, count: int, id_type, cache=None) -> list:
    """Parse ``count`` raw 16-byte uuids into ``id_type`` instances.

    ``cache`` (a per-frame, per-type dict keyed by the raw bytes) dedupes
    columns whose values repeat heavily — the participant / aggregation /
    clerk-agent columns of a participation batch hold a handful of
    distinct ids repeated thousands of times, so sharing the (immutable)
    instances turns most constructions into dict hits."""
    raw = bytes(r.take(16 * count))
    build = id_type._from_uuid_bytes
    if cache is None:
        return [build(raw[o : o + 16]) for o in range(0, 16 * count, 16)]
    out = []
    for o in range(0, 16 * count, 16):
        key = raw[o : o + 16]
        hit = cache.get(key)
        if hit is None:
            hit = cache[key] = build(key)
        out.append(hit)
    return out


# -- payloads ---------------------------------------------------------------


def encode_encryptions(encryptions) -> bytes:
    """One bare ciphertext column — the clerking-job chunk and
    snapshot-result mask chunk response payload."""
    parts = [_header(KIND_ENCRYPTIONS)]
    _put_encryptions(parts, list(encryptions))
    return b"".join(parts)


def decode_encryptions(buf) -> list:
    r = _open(buf, KIND_ENCRYPTIONS)
    out = _get_encryptions(r)
    r.expect_eof()
    return out


def encode_participations(participations) -> bytes:
    """The participation batch POST body: id/participant/aggregation uuid
    columns, a recipient-encryption presence bitmap (LSB-first) with the
    present ciphertexts packed densely, then the flattened clerk matrix
    (per-item clerk counts as an i64 column, clerk agent ids, and the
    ciphertexts in the same flattened order)."""
    ps = list(participations)
    for p in ps:
        if getattr(p, "tier_reshare", None) is not None:
            # the frame has no tag column; silently encoding a tagged row
            # would strip its promotion semantics server-side. Callers
            # route tagged batches through the JSON body (rest/client.py).
            raise WireError("tier_reshare-tagged participations have no binary encoding")
    parts = [_header(KIND_PARTICIPATIONS), _uvarint(len(ps))]
    if ps:
        _put_uuid_column(parts, [p.id for p in ps])
        _put_uuid_column(parts, [p.participant for p in ps])
        _put_uuid_column(parts, [p.aggregation for p in ps])
        bitmap = bytearray((len(ps) + 7) // 8)
        recipient_encs = []
        for i, p in enumerate(ps):
            if p.recipient_encryption is not None:
                bitmap[i >> 3] |= 1 << (i & 7)
                recipient_encs.append(p.recipient_encryption)
        parts.append(bytes(bitmap))
        _put_encryptions(parts, recipient_encs)
        _put_i64_column(
            parts,
            np.fromiter(
                (len(p.clerk_encryptions) for p in ps), dtype=np.int64, count=len(ps)
            ),
        )
        parts.append(
            b"".join(a.uuid.bytes for p in ps for (a, _e) in p.clerk_encryptions)
        )
        _put_encryptions(parts, [e for p in ps for (_a, e) in p.clerk_encryptions])
    return b"".join(parts)


def decode_participations(buf) -> list:
    r = _open(buf, KIND_PARTICIPATIONS)
    n = r.uvarint()
    if not n:
        r.expect_eof()
        return []
    agent_cache: dict = {}
    ids = _get_uuid_column(r, n, ParticipationId)
    participants = _get_uuid_column(r, n, AgentId, cache=agent_cache)
    aggregations = _get_uuid_column(r, n, AggregationId, cache={})
    bitmap = bytes(r.take((n + 7) // 8))
    recipient_encs = _get_encryptions(r)
    present = sum(bool(bitmap[i >> 3] & (1 << (i & 7))) for i in range(n))
    if present != len(recipient_encs):
        raise WireError(
            f"presence bitmap marks {present} recipient encryptions, "
            f"column holds {len(recipient_encs)}"
        )
    clerk_counts = _get_i64_column(r, n)
    if int(clerk_counts.min()) < 0:
        raise WireError("negative clerk count in participation frame")
    total = int(clerk_counts.sum())
    clerk_ids_raw = bytes(r.take(16 * total))
    clerk_encs = _get_encryptions(r)
    if len(clerk_encs) != total:
        raise WireError(
            f"clerk counts sum to {total}, encryption column holds {len(clerk_encs)}"
        )
    r.expect_eof()

    # The flattened clerk column names the same few committee agents over
    # and over; decode it once through the shared agent cache.
    build_agent = AgentId._from_uuid_bytes
    clerk_agents = []
    for o in range(0, 16 * total, 16):
        key = clerk_ids_raw[o : o + 16]
        hit = agent_cache.get(key)
        if hit is None:
            hit = agent_cache[key] = build_agent(key)
        clerk_agents.append(hit)

    out = []
    rec_pos = 0
    flat = 0
    for i, count in enumerate(clerk_counts.tolist()):
        recipient_encryption = None
        if bitmap[i >> 3] & (1 << (i & 7)):
            recipient_encryption = recipient_encs[rec_pos]
            rec_pos += 1
        end = flat + count
        clerk_encryptions = list(zip(clerk_agents[flat:end], clerk_encs[flat:end]))
        flat = end
        out.append(
            Participation(
                id=ids[i],
                participant=participants[i],
                aggregation=aggregations[i],
                recipient_encryption=recipient_encryption,
                clerk_encryptions=clerk_encryptions,
            )
        )
    return out


def encode_clerking_results(results) -> bytes:
    """The snapshot-result clerk chunk response payload: job and clerk
    uuid columns plus the combined-ciphertext column, row-aligned."""
    rs = list(results)
    parts = [_header(KIND_CLERKING_RESULTS), _uvarint(len(rs))]
    if rs:
        _put_uuid_column(parts, [c.job for c in rs])
        _put_uuid_column(parts, [c.clerk for c in rs])
        _put_encryptions(parts, [c.encryption for c in rs])
    return b"".join(parts)


def decode_clerking_results(buf) -> list:
    r = _open(buf, KIND_CLERKING_RESULTS)
    n = r.uvarint()
    if not n:
        r.expect_eof()
        return []
    jobs = _get_uuid_column(r, n, ClerkingJobId)
    clerks = _get_uuid_column(r, n, AgentId, cache={})
    encryptions = _get_encryptions(r)
    if len(encryptions) != n:
        raise WireError(
            f"clerking-result frame of {n} rows holds {len(encryptions)} ciphertexts"
        )
    r.expect_eof()
    return [
        ClerkingResult(job=jobs[i], clerk=clerks[i], encryption=encryptions[i])
        for i in range(n)
    ]
