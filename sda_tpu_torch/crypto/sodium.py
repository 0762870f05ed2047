"""Sealed boxes and Ed25519 detached signatures, wire-compatible with
libsodium (counterpart of ``sda_tpu/crypto/sodium.py``, which binds the
system libsodium by ctypes).

The port binds no shared library: everything is computed here from
``hashlib``, ``os.urandom``, Python integers and numpy, byte for byte as
libsodium 1.0.18 computes it, so boxes and signatures interoperate with any
libsodium consumer (the CPU tests hold them against it):

- ``box_keypair``: 32 random bytes ``sk``, ``pk = X25519(sk, 9)``;
- X25519 (RFC 7748): clamped scalar, bit 255 of u masked, u reduced mod
  2^255 - 19; an all-zero output fails, as libsodium's ``crypto_scalarmult``
  returns -1 there, which makes sealing to or opening from a small-order
  key fail;
- ``seal(m, pk)`` (``crypto_box_seal``): fresh ``(esk, epk)``; nonce
  ``blake2b(epk || pk, 24 bytes)``; ``k = HSalsa20(X25519(esk, pk), 0^16)``;
  XSalsa20 under ``k`` and the nonce, whose first 32 keystream bytes key
  Poly1305 and whose bytes from 32 on encrypt ``m``; out
  ``epk || tag || c``, ``len(m) + SEALBYTES`` bytes;
- Ed25519 (RFC 8032) in libsodium's layout (``sk = seed || vk``) with
  ``crypto_sign_verify_detached``'s checks: S canonical, R not of small
  order, A canonical, not of small order and on the curve, then the
  encoding of ``[S]B - [h]A`` compared with R byte for byte (cofactorless).

The Salsa20 keystream is vectorised over 64-byte blocks in numpy; the field
arithmetic and Poly1305 are Python integers. This is variable-time code:
it is not hardened against timing side channels as libsodium is (the tag
compare alone is constant time, ``hmac.compare_digest``). It is the plain
version the native layer is held against: the port's call sites seal, open,
generate keys and sign in ``sda_tpu_torch.native``'s constant-time C, and
verify (public) here.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

import numpy as np


class SodiumError(Exception):
    pass


BOX_PUBLICKEYBYTES = 32
BOX_SECRETKEYBYTES = 32
SEALBYTES = 48  # crypto_box_SEALBYTES = PUBLICKEYBYTES + MACBYTES
SIGN_PUBLICKEYBYTES = 32
SIGN_SECRETKEYBYTES = 64
SIGN_BYTES = 64

_P = (1 << 255) - 19

# ---------------------------------------------------------------------------
# X25519
# ---------------------------------------------------------------------------

_A24 = 121665


def _clamp(k: bytes) -> int:
    n = int.from_bytes(k, "little")
    return (n & ~7 & ((1 << 254) - 1)) | (1 << 254)


def x25519(scalar: bytes, u: bytes) -> bytes:
    """RFC 7748 X25519; raises ``SodiumError`` on an all-zero output."""
    k = _clamp(scalar)
    x1 = (int.from_bytes(u, "little") & ((1 << 255) - 1)) % _P
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        bit = (k >> t) & 1
        if swap ^ bit:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = bit
        a, b = x2 + z2, x2 - z2
        aa, bb = a * a % _P, b * b % _P
        e = aa - bb
        c, d = x3 + z3, x3 - z3
        da, cb = d * a % _P, c * b % _P
        x3 = (da + cb) ** 2 % _P
        z3 = x1 * (da - cb) ** 2 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, z2 = x3, z3
    out = x2 * pow(z2, _P - 2, _P) % _P
    if out == 0:
        raise SodiumError("X25519 of a small-order point")
    return out.to_bytes(32, "little")


_BASE_U = (9).to_bytes(32, "little")

# ---------------------------------------------------------------------------
# Salsa20 / HSalsa20 / XSalsa20
# ---------------------------------------------------------------------------

_SIGMA = np.frombuffer(b"expand 32-byte k", dtype="<u4")
_COLUMNS = ((0, 4, 8, 12), (5, 9, 13, 1), (10, 14, 2, 6), (15, 3, 7, 11))
_ROWS = ((0, 1, 2, 3), (5, 6, 7, 4), (10, 11, 8, 9), (15, 12, 13, 14))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _salsa_rounds(x: list) -> None:
    """20 Salsa20 rounds in place over 16 word arrays."""
    for _ in range(10):
        for quads in (_COLUMNS, _ROWS):
            for a, b, c, d in quads:
                x[b] ^= _rotl(x[a] + x[d], 7)
                x[c] ^= _rotl(x[b] + x[a], 9)
                x[d] ^= _rotl(x[c] + x[b], 13)
                x[a] ^= _rotl(x[d] + x[c], 18)


def _salsa_rounds_int(x: list) -> None:
    """The same 20 rounds over 16 Python ints: a single block costs far
    less this way than as 16 one-element numpy arrays."""
    m = 0xFFFFFFFF
    for _ in range(10):
        for quads in (_COLUMNS, _ROWS):
            for a, b, c, d in quads:
                t = (x[a] + x[d]) & m
                x[b] ^= ((t << 7) | (t >> 25)) & m
                t = (x[b] + x[a]) & m
                x[c] ^= ((t << 9) | (t >> 23)) & m
                t = (x[c] + x[b]) & m
                x[d] ^= ((t << 13) | (t >> 19)) & m
                t = (x[d] + x[c]) & m
                x[a] ^= ((t << 18) | (t >> 14)) & m


def _state_int(key: bytes, words6_9) -> list:
    k = struct.unpack("<8I", key)
    sigma = [int(w) for w in _SIGMA]
    return [sigma[0], *k[:4], sigma[1], *words6_9, sigma[2], *k[4:], sigma[3]]


#: keystreams up to this many blocks take the Python-int rounds
_SCALAR_BLOCKS = 8


def _state(key: bytes, words6_9: np.ndarray) -> list:
    k = np.frombuffer(key, dtype="<u4").astype(np.uint32)
    n = words6_9.shape[1]
    rows = [np.full(n, _SIGMA[0], np.uint32)]
    rows += [np.full(n, w, np.uint32) for w in k[:4]]
    rows += [np.full(n, _SIGMA[1], np.uint32)]
    rows += [words6_9[i].astype(np.uint32) for i in range(4)]
    rows += [np.full(n, _SIGMA[2], np.uint32)]
    rows += [np.full(n, w, np.uint32) for w in k[4:]]
    rows += [np.full(n, _SIGMA[3], np.uint32)]
    return rows


def hsalsa20(key: bytes, nonce16: bytes) -> bytes:
    """HSalsa20(key, 16-byte input) -> 32-byte subkey."""
    x = _state_int(key, struct.unpack("<4I", nonce16))
    _salsa_rounds_int(x)
    return struct.pack("<8I", *(x[i] for i in (0, 5, 10, 15, 6, 7, 8, 9)))


def salsa20_stream(key: bytes, nonce8: bytes, length: int) -> bytes:
    """``length`` bytes of Salsa20 keystream from block counter 0: a short
    stream block by block in Python ints, a longer one with every block
    computed at once in numpy."""
    n_blocks = -(-length // 64)
    if n_blocks == 0:
        return b""
    if n_blocks <= _SCALAR_BLOCKS:
        nonce = struct.unpack("<2I", nonce8)
        blocks = []
        for counter in range(n_blocks):
            start = _state_int(key, (*nonce, counter & 0xFFFFFFFF, counter >> 32))
            x = list(start)
            _salsa_rounds_int(x)
            blocks.append(struct.pack("<16I", *((a + b) & 0xFFFFFFFF for a, b in zip(x, start))))
        return b"".join(blocks)[:length]
    counters = np.arange(n_blocks, dtype=np.uint64)
    nonce = np.frombuffer(nonce8, dtype="<u4").astype(np.uint32)
    words = np.stack([
        np.full(n_blocks, nonce[0], np.uint32),
        np.full(n_blocks, nonce[1], np.uint32),
        (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (counters >> np.uint64(32)).astype(np.uint32),
    ])
    start = _state(key, words)
    x = [w.copy() for w in start]
    _salsa_rounds(x)
    out = np.stack([x[i] + start[i] for i in range(16)], axis=1)  # (blocks, 16)
    return out.astype("<u4").tobytes()[:length]


# ---------------------------------------------------------------------------
# Poly1305
# ---------------------------------------------------------------------------

_P1305 = (1 << 130) - 5


def poly1305(message: bytes, key: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:32], "little")
    h = 0
    full = len(message) - len(message) % 16
    top = 1 << 128
    frombytes = int.from_bytes
    for i in range(0, full, 16):
        h = (h + frombytes(message[i : i + 16], "little") + top) * r % _P1305
    if full < len(message):
        tail = message[full:]
        h = (h + frombytes(tail, "little") + (1 << (8 * len(tail)))) * r % _P1305
    return ((h + s) & ((1 << 128) - 1)).to_bytes(16, "little")


# ---------------------------------------------------------------------------
# sealed boxes
# ---------------------------------------------------------------------------


def _xor(a: bytes, b: bytes) -> bytes:
    return (np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8)).tobytes()


def _secretbox_stream(shared: bytes, nonce: bytes, length: int) -> bytes:
    k = hsalsa20(shared, bytes(16))  # crypto_box_beforenm
    subkey = hsalsa20(k, nonce[:16])
    return salsa20_stream(subkey, nonce[16:], 32 + length)


def _seal_nonce(epk: bytes, pk: bytes) -> bytes:
    return hashlib.blake2b(epk + pk, digest_size=24).digest()


def box_keypair() -> tuple[bytes, bytes]:
    """Generate a Curve25519 box keypair -> (public, secret)."""
    sk = os.urandom(BOX_SECRETKEYBYTES)
    return x25519(sk, _BASE_U), sk


def seal(message: bytes, public_key: bytes) -> bytes:
    """Anonymous sealed box: ephemeral-key encrypt to ``public_key``."""
    return seal_with_ephemeral(message, public_key, os.urandom(BOX_SECRETKEYBYTES))


def seal_with_ephemeral(message: bytes, public_key: bytes, esk: bytes) -> bytes:
    """``seal`` under the given 32-byte ephemeral secret key ``esk``: the
    plain version of the native layer's batch seals, which take their
    ephemeral keys from the caller."""
    message = bytes(message)
    if len(public_key) != BOX_PUBLICKEYBYTES:
        raise SodiumError("crypto_box_seal failed")
    epk = x25519(esk, _BASE_U)
    try:
        shared = x25519(esk, public_key)
    except SodiumError:
        raise SodiumError("crypto_box_seal failed") from None
    stream = _secretbox_stream(shared, _seal_nonce(epk, public_key), len(message))
    body = _xor(message, stream[32:])
    return epk + poly1305(body, stream[:32]) + body


def seal_open(ciphertext: bytes, public_key: bytes, secret_key: bytes) -> bytes:
    """Open a sealed box; raises SodiumError on forgery/corruption."""
    ciphertext = bytes(ciphertext)
    if len(ciphertext) < SEALBYTES:
        raise SodiumError("ciphertext too short")
    epk, tag, body = ciphertext[:32], ciphertext[32:48], ciphertext[48:]
    try:
        shared = x25519(secret_key, epk)
    except SodiumError:
        raise SodiumError("sealed box open failed") from None
    stream = _secretbox_stream(shared, _seal_nonce(epk, public_key), len(body))
    if not hmac.compare_digest(poly1305(body, stream[:32]), tag):
        raise SodiumError("sealed box open failed")
    return _xor(body, stream[32:])


# ---------------------------------------------------------------------------
# Ed25519
# ---------------------------------------------------------------------------

_L = (1 << 252) + 27742317777372353535851937790883648493
_D = -121665 * pow(121666, _P - 2, _P) % _P
_SQRT_M1 = pow(2, (_P - 1) // 4, _P)
# y coordinates of the curve's 8 torsion points plus the two non-canonical
# encodings p and p + 1 of 0 and 1 (libsodium's ge25519_has_small_order
# blacklist, sign bit ignored)
_SMALL_ORDER_Y = frozenset((
    0, 1, _P - 1, _P, _P + 1,
    2707385501144840649318225287225658788936804267575313519463743609750303402022,
    55188659117513257062467267217118295137698188065244968500265048394206261417927,
))


def _edwards_add(p1, p2):
    """Extended-coordinate addition (RFC 8032 section 5.1.4)."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    d = 2 * z1 * z2 % _P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % _P, g * h % _P, f * g % _P, e * h % _P


def _scalar_mult(s: int, point):
    q = (0, 1, 1, 0)
    while s:
        if s & 1:
            q = _edwards_add(q, point)
        point = _edwards_add(point, point)
        s >>= 1
    return q


def _encode(point) -> bytes:
    x, y, z, _ = point
    zi = pow(z, _P - 2, _P)
    x, y = x * zi % _P, y * zi % _P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _recover_x(y: int, sign: int):
    """x for y on the curve with the given sign bit, or None."""
    x2 = (y * y - 1) * pow(_D * y * y + 1, _P - 2, _P) % _P
    x = pow(x2, (_P + 3) // 8, _P)
    if (x * x - x2) % _P:
        x = x * _SQRT_M1 % _P
    if (x * x - x2) % _P:
        return None
    if (x & 1) != sign:
        x = _P - x
    return x % _P


_BY = 4 * pow(5, _P - 2, _P) % _P
_BX = _recover_x(_BY, 0)
_B = (_BX, _BY, 1, _BX * _BY % _P)


def _expand_seed(seed: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    return _clamp(h[:32]), h[32:]


def _h_int(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little") % _L


def sign_keypair() -> tuple[bytes, bytes]:
    """Generate an Ed25519 keypair -> (verify 32B, signing 64B)."""
    seed = os.urandom(32)
    a, _ = _expand_seed(seed)
    vk = _encode(_scalar_mult(a, _B))
    return vk, seed + vk


def sign_detached(message: bytes, signing_key: bytes) -> bytes:
    """Deterministic Ed25519 signature under ``seed || vk``: the nonce
    hashes the seed's prefix half and the challenge the key's own ``vk``
    half, as libsodium's ``crypto_sign_detached``."""
    if len(signing_key) != SIGN_SECRETKEYBYTES:
        raise SodiumError("crypto_sign_detached failed")
    a, prefix = _expand_seed(signing_key[:32])
    message = bytes(message)
    r = _h_int(prefix, message)
    big_r = _encode(_scalar_mult(r, _B))
    k = _h_int(big_r, signing_key[32:], message)
    return big_r + ((r + k * a) % _L).to_bytes(32, "little")


def verify_detached(signature: bytes, message: bytes, verify_key: bytes) -> bool:
    if len(signature) != SIGN_BYTES or len(verify_key) != SIGN_PUBLICKEYBYTES:
        return False
    r_bytes, s = signature[:32], int.from_bytes(signature[32:], "little")
    if s >= _L:
        return False
    if int.from_bytes(r_bytes, "little") & ((1 << 255) - 1) in _SMALL_ORDER_Y:
        return False
    a_y = int.from_bytes(verify_key, "little") & ((1 << 255) - 1)
    if a_y >= _P or a_y in _SMALL_ORDER_Y:
        return False
    a_x = _recover_x(a_y, verify_key[31] >> 7)
    if a_x is None:
        return False
    k = _h_int(r_bytes, verify_key, bytes(message))
    neg_a = (_P - a_x, a_y, 1, (_P - a_x) * a_y % _P)
    check = _edwards_add(_scalar_mult(s, _B), _scalar_mult(k, neg_a))
    return hmac.compare_digest(_encode(check), r_bytes)
