"""The native layer: bulk varints, batched sealed boxes, ChaCha20 mask
expansion, constant-time key generation and Ed25519 signing, and Montgomery
modexp in C (counterpart of ``sda_tpu/native``).

The reference layer is a CPython extension over the system libsodium, with
``bignum.py`` over the system libcrypto. The port's is plain C with no
library behind it (``sodium_prims.c`` for HSalsa20, XSalsa20-Poly1305,
BLAKE2b and ChaCha20; ``curve25519_comb.c`` for X25519 on comb tables and a
Montgomery ladder; ``ed25519.c`` for SHA-512, box public keys and Ed25519
keypairs and signatures on the base comb table; ``bignum.c`` for Montgomery
modexp over 64-bit limbs; ``_sdanative.c`` for the batch entry points),
compiled on first use with the host's ``cc`` (or ``gcc``) into
``build/sda_tpu_torch/libsdanative-<hash>.so`` at the checkout's root and
bound through ``ctypes``, which releases the GIL for the whole call. The
hash covers the five sources, so an edited source is rebuilt and a built
one reused; concurrent builds each write their own temporary file and
``os.replace`` it into place.

There is no fallback: when the compiler is missing or the build fails, the
first call raises with the compiler's output. The plain versions stay where
they are (``crypto/sodium.py``, ``crypto/varint.py``,
``ops/chacha.expand_seed``) and the tests hold this layer against them.

Box and signing secrets (``box_keypair``, ``sign_keypair``) are drawn here
with ``os.urandom``, and so are the ephemeral secret keys of sealed boxes,
with one call, handed to the C, which clamps them; a caller may pass its
own (``ephemeral_keys``), which is how the tests hold the C byte for byte
against ``sodium.seal_with_ephemeral``. Each bulk entry point
counts its work under the reference's labels:
``sda_crypto_seals_total{path=batch|comb}``,
``sda_crypto_opens_total{path=batch}`` and
``sda_crypto_chacha_expands_total{path=native}``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from .. import telemetry
from ..kernels import BUILD_DIR

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("_sdanative.c", "sodium_prims.c", "curve25519_comb.c", "ed25519.c", "bignum.c")
CFLAGS = ["-O2", "-fPIC", "-shared", "-pthread"]
SEALBYTES = 48

_u8 = ctypes.c_char_p
_vp = ctypes.c_void_p
_i64 = ctypes.c_int64

#: entry point -> (argtypes, restype)
_SIGNATURES = {
    "sda_varint_encode": ([_vp, _i64, _vp], _i64),
    "sda_varint_count": ([_u8, _i64], _i64),
    "sda_varint_decode": ([_u8, _i64, _vp], None),
    "sda_seal_uses_comb": ([_u8, _i64, _i64], ctypes.c_int),
    "sda_seal_batch": ([_u8, _vp, _i64, _u8, _u8, _vp, _vp, ctypes.c_int], _i64),
    "sda_open_batch": ([_u8, _vp, _i64, _u8, _u8, _vp, _vp, ctypes.c_int], _i64),
    "sda_seal_participations": ([_u8, _vp, _i64, _i64, _u8, _u8, _i64, _vp, _vp,
                                 ctypes.c_int], _i64),
    "sda_chacha_expand": ([_u8, _i64, ctypes.c_uint64, _vp], None),
    "sda_chacha_combine": ([_u8, _i64, _i64, ctypes.c_uint64, _vp], None),
    "sda_box_public_key": ([_u8, _vp], None),
    "sda_sign_seed_keypair": ([_u8, _vp, _vp], None),
    "sda_sign_detached": ([_u8, _i64, _u8, _vp], None),
    "sda_mod_exp": ([_vp, _vp, _i64, _vp, _i64, _vp], _i64),
    "sda_mod_exp_batch": ([_vp, _i64, _vp, _i64, _vp, _i64, _vp, ctypes.c_int], _i64),
}

_ERR_KEYS, _ERR_NOMEM = -2, -3
_VARINT_ERRORS = {-1: "truncated varint stream", -2: "varint too long for u64"}

_lib = None
_lib_lock = threading.Lock()


def compiler() -> str:
    """The host C compiler: ``cc``, else ``gcc``."""
    found = shutil.which("cc") or shutil.which("gcc")
    if not found:
        raise RuntimeError("no C compiler (cc or gcc) found: the native layer is built "
                           "from sda_tpu_torch/native/*.c at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libsdanative-{digest.hexdigest()[:16]}.so"


def build() -> str | None:
    """Compile the library unless it is built; returns the compiler's
    output, or None when there was nothing to build."""
    lib = library_path()
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(), *CFLAGS, "-o", str(tmp), str(SRC_DIR / "_sdanative.c")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native layer failed (rc {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return proc.stdout


def _load():
    """The loaded library, built on first use."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                if sys.byteorder != "little":
                    # the C reads keys and writes int64 in native order while
                    # Python reads them as little-endian
                    raise RuntimeError("the native layer needs a little-endian host")
                build()
                lib = ctypes.CDLL(str(library_path()))
                for name, (argtypes, restype) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _default_threads() -> int:
    """Sealed-box worker threads: ``SDA_NATIVE_THREADS`` if set, else one
    per CPU. The C splits a batch into contiguous chunks over a pthread
    pool; the result does not depend on the thread count (each item is
    sealed or opened by exactly one thread)."""
    env = os.environ.get("SDA_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return os.cpu_count() or 1


def _count_seals(n: int, path: str) -> None:
    telemetry.counter(
        "sda_crypto_seals_total", "sealed boxes produced by crypto path", path=path
    ).inc(n)


def _count_opens(n: int, path: str) -> None:
    telemetry.counter(
        "sda_crypto_opens_total", "sealed boxes opened by crypto path", path=path
    ).inc(n)


def _count_chacha(n: int, path: str) -> None:
    telemetry.counter(
        "sda_crypto_chacha_expands_total",
        "ChaCha mask seeds expanded/combined by path",
        path=path,
    ).inc(n)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_vp)


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


def varint_encode(values: np.ndarray) -> bytes:
    """zigzag-LEB128 of an int64 vector, byte-equal to ``varint.encode_i64``."""
    vals = np.ascontiguousarray(values, dtype="<i8").reshape(-1)
    out = np.empty(10 * vals.size, dtype=np.uint8)
    n = _load().sda_varint_encode(_ptr(vals), vals.size, _ptr(out))
    return out[:n].tobytes()


def varint_decode(buf: bytes) -> np.ndarray:
    """The int64 vector of a zigzag-LEB128 stream; malformed streams raise
    ``varint.decode_i64``'s ``ValueError``."""
    buf = bytes(buf)
    lib = _load()
    count = lib.sda_varint_count(buf, len(buf))
    if count < 0:
        raise ValueError(_VARINT_ERRORS[count])
    out = np.empty(count, dtype="<i8")
    if count:
        lib.sda_varint_decode(buf, len(buf), _ptr(out))
    return out


# ---------------------------------------------------------------------------
# sealed boxes
# ---------------------------------------------------------------------------


def _concat(items) -> tuple[bytes, np.ndarray]:
    """Items -> (one buffer, n + 1 int64 offsets into it)."""
    lens = np.fromiter((len(x) for x in items), dtype=np.int64, count=len(items))
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return b"".join(items), offsets


def _split(out: np.ndarray, offsets: np.ndarray) -> list:
    view = memoryview(out)
    return [bytes(view[a:b]) for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


def _error(index: int, reason: str):
    from ..crypto.sodium import SodiumError

    err = SodiumError(f"box {index}: {reason}")
    err.index = index
    return err


def _keys(ephemeral_keys, count: int) -> bytes:
    if ephemeral_keys is None:
        return os.urandom(32 * count)
    keys = bytes(ephemeral_keys)
    if len(keys) != 32 * count:
        raise ValueError(f"need {count} ephemeral keys of 32 bytes, got {len(keys)} bytes")
    return keys


def _check_key(key, what: str) -> bytes:
    key = bytes(key)
    if len(key) != 32:
        raise ValueError(f"{what} must be 32 bytes")
    return key


def _raise_status(status: int, reason: str) -> None:
    if status == _ERR_NOMEM:
        raise MemoryError("the native layer could not allocate its tables")
    if status == _ERR_KEYS:
        raise ValueError("ephemeral key count does not match the sealing path")
    if status >= 0:
        raise _error(status, reason)


def seal_batch(messages: list, public_key: bytes, n_threads: int | None = None,
               ephemeral_keys: bytes | None = None) -> list:
    """Seal every message to ``public_key`` (``crypto_box_seal`` boxes):
    comb tables from 8 messages on, the ladder below that or for a key that
    does not lift to a curve point; message i under ephemeral key i."""
    lib = _load()
    pk = _check_key(public_key, "public key")
    n = len(messages)
    _count_seals(n, "batch")
    if n == 0:
        return []
    buf, offsets = _concat(messages)
    out_off = offsets + SEALBYTES * np.arange(n + 1, dtype=np.int64)
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    status = lib.sda_seal_batch(buf, _ptr(offsets), n, pk, _keys(ephemeral_keys, n), _ptr(out),
                                _ptr(out_off), n_threads or _default_threads())
    _raise_status(status, "crypto_box_seal failed")
    return _split(out, out_off)


def open_batch(ciphertexts: list, public_key: bytes, secret_key: bytes,
               n_threads: int | None = None) -> list:
    """Open sealed boxes addressed to ``(public_key, secret_key)``. Raises
    ``SodiumError`` naming the lowest index that is shorter than a sealed
    box, has a zero shared secret or fails its tag."""
    lib = _load()
    pk = _check_key(public_key, "public key")
    sk = _check_key(secret_key, "secret key")
    n = len(ciphertexts)
    _count_opens(n, "batch")
    if n == 0:
        return []
    buf, offsets = _concat(ciphertexts)
    out_lens = np.maximum(np.diff(offsets) - SEALBYTES, 0)
    out_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_lens, out=out_off[1:])
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    status = lib.sda_open_batch(buf, _ptr(offsets), n, pk, sk, _ptr(out), _ptr(out_off),
                                n_threads or _default_threads())
    if status >= 0:
        short = offsets[status + 1] - offsets[status] < SEALBYTES
        raise _error(status, "ciphertext too short" if short else "sealed box open failed")
    _raise_status(status, "sealed box open failed")
    return _split(out, out_off)


def participation_keys(participants: int, public_keys: list) -> int:
    """How many ephemeral keys ``seal_participations`` takes for this many
    participants and these clerk keys: one per participant on the comb path,
    one per box on the ladder path."""
    pks = b"".join(_check_key(pk, f"public key {c}") for c, pk in enumerate(public_keys))
    total = participants * len(public_keys)
    return participants if _load().sda_seal_uses_comb(pks, len(public_keys), total) else total


def seal_participations(share_matrix: list, public_keys: list, n_threads: int | None = None,
                        ephemeral_keys: bytes | None = None) -> list:
    """Seal a ``P x C`` matrix of share messages to ``C`` clerk public keys:
    ``result[p][c]`` is ``share_matrix[p][c]`` sealed to ``public_keys[c]``.

    On the comb path (at least 8 boxes, every key lifts) participant p's C
    boxes share ephemeral key p, amortizing X25519 to ~(1 + 1/C) comb
    multiplications per box; on the ladder path box ``p * C + c`` has key
    ``p * C + c``. Every output is a standard ``crypto_box_seal`` box."""
    lib = _load()
    P, C = len(share_matrix), len(public_keys)
    pks = b"".join(_check_key(pk, f"public key {c}") for c, pk in enumerate(public_keys))
    flat = []
    for p, row in enumerate(share_matrix):
        if len(row) != C:
            raise ValueError(f"shares[{p}] must be a list of {C} messages")
        flat.extend(row)
    _count_seals(P * C, "comb")
    if P * C == 0:
        return [[] for _ in range(P)]
    n_keys = P if lib.sda_seal_uses_comb(pks, C, P * C) else P * C
    buf, offsets = _concat(flat)
    out_off = offsets + SEALBYTES * np.arange(P * C + 1, dtype=np.int64)
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    status = lib.sda_seal_participations(buf, _ptr(offsets), P, C, pks,
                                         _keys(ephemeral_keys, n_keys), n_keys, _ptr(out),
                                         _ptr(out_off), n_threads or _default_threads())
    _raise_status(status, "crypto_box_seal failed")
    boxes = _split(out, out_off)
    return [boxes[p * C:(p + 1) * C] for p in range(P)]


# ---------------------------------------------------------------------------
# ChaCha20 masks
# ---------------------------------------------------------------------------


def _chacha_keys(seed_rows: np.ndarray) -> bytes:
    """(n, <=8) u32 seed words -> n concatenated 32-byte ChaCha keys
    (little-endian words, zero-padded: the expand_seed key layout)."""
    rows = np.asarray(seed_rows, dtype=np.uint32)
    if rows.ndim == 1:
        rows = rows[None, :]
    keys = np.zeros((rows.shape[0], 8), dtype="<u4")
    keys[:, : rows.shape[1]] = rows
    return keys.tobytes()


def _check_modulus(modulus: int) -> None:
    if not 0 < modulus <= 1 << 63:
        raise ValueError(f"modulus out of range: {modulus} (the masks need 0 < m <= 2^63)")


def chacha_expand(seed_words, dim: int, modulus: int) -> np.ndarray:
    """One seed -> (dim,) int64 mask in [0, modulus), bit-identical to
    ``ops.chacha.expand_seed``."""
    _check_modulus(modulus)
    lib = _load()
    _count_chacha(1, "native")
    out = np.empty(int(dim), dtype="<i8")
    lib.sda_chacha_expand(_chacha_keys(seed_words), int(dim), int(modulus), _ptr(out))
    return out


def chacha_combine(seed_rows, dim: int, modulus: int) -> np.ndarray:
    """The sum of every seed's expanded mask, elementwise mod modulus: the
    reveal's host fold, one C call for the whole cohort."""
    _check_modulus(modulus)
    lib = _load()
    rows = np.asarray(seed_rows, dtype=np.uint32)
    n_seeds = int(np.prod(rows.shape[:-1])) if rows.ndim > 1 else 1
    _count_chacha(n_seeds, "native")
    out = np.empty(int(dim), dtype="<i8")
    lib.sda_chacha_combine(_chacha_keys(rows.reshape(-1, rows.shape[-1])), n_seeds, int(dim),
                           int(modulus), _ptr(out))
    return out


# ---------------------------------------------------------------------------
# key generation and Ed25519 signing
# ---------------------------------------------------------------------------


def box_public_key(secret_key: bytes) -> bytes:
    """X25519(secret_key, 9) on the base comb table, in constant time."""
    sk = _check_key(secret_key, "secret key")
    out = ctypes.create_string_buffer(32)
    _load().sda_box_public_key(sk, out)
    return out.raw


def box_keypair() -> tuple[bytes, bytes]:
    """A Curve25519 box keypair -> (public, secret): ``crypto_box_keypair``."""
    sk = os.urandom(32)
    return box_public_key(sk), sk


def sign_seed_keypair(seed: bytes) -> tuple[bytes, bytes]:
    """The Ed25519 keypair of a 32-byte seed -> (verify 32B, signing 64B =
    seed || vk): ``crypto_sign_seed_keypair``."""
    seed = _check_key(seed, "seed")
    vk, sk = ctypes.create_string_buffer(32), ctypes.create_string_buffer(64)
    _load().sda_sign_seed_keypair(seed, vk, sk)
    return vk.raw, sk.raw


def sign_keypair() -> tuple[bytes, bytes]:
    """A fresh Ed25519 keypair -> (verify 32B, signing 64B)."""
    return sign_seed_keypair(os.urandom(32))


def sign_detached(message: bytes, signing_key: bytes) -> bytes:
    """The deterministic Ed25519 signature of ``message`` under ``seed ||
    vk``, as libsodium's ``crypto_sign_detached`` (the challenge hashes the
    key's own ``vk`` half)."""
    from ..crypto.sodium import SIGN_SECRETKEYBYTES, SodiumError

    sk = bytes(signing_key)
    if len(sk) != SIGN_SECRETKEYBYTES:
        raise SodiumError("crypto_sign_detached failed")
    message = bytes(message)
    sig = ctypes.create_string_buffer(64)
    _load().sda_sign_detached(message, len(message), sk, sig)
    return sig.raw


# ---------------------------------------------------------------------------
# Montgomery modexp
# ---------------------------------------------------------------------------


def _limbs(values, n: int) -> np.ndarray:
    """Python ints (each < 2^(64 n)) -> one little-endian uint64 array of n
    limbs each."""
    return np.frombuffer(b"".join(v.to_bytes(8 * n, "little") for v in values), dtype="<u8")


def _check_modexp(exp: int, mod: int) -> int:
    """The modulus's limb count; refuses what ``BN_mod_exp`` would and an
    even modulus, which Montgomery multiplication cannot take."""
    if exp < 0 or mod <= 0:
        raise ValueError("mod_exp needs nonnegative base/exp and positive mod")
    if not mod & 1:
        raise ValueError("mod_exp needs an odd modulus (Montgomery form)")
    return (mod.bit_length() + 63) // 64


def _raise_modexp(status: int) -> None:
    if status == _ERR_NOMEM:
        raise MemoryError("the native layer could not allocate its modexp scratch")
    if status != 0:  # the C's SDA_ERR_EVEN, which _check_modexp forestalls
        raise ValueError("mod_exp needs an odd modulus (Montgomery form)")


def _mod_exps(bases: list, exp: int, mod: int, n_threads: int) -> list:
    n = _check_modexp(exp, mod)
    if any(b < 0 for b in bases):
        raise ValueError("mod_exp needs nonnegative base/exp and positive mod")
    if not bases:
        return []
    e = _limbs([exp], max(1, (exp.bit_length() + 63) // 64))
    m = _limbs([mod], n)
    x = _limbs([b % mod for b in bases], n)
    out = np.empty(len(bases) * n, dtype="<u8")
    lib = _load()
    if len(bases) == 1 and n_threads == 1:
        status = lib.sda_mod_exp(_ptr(x), _ptr(e), e.size, _ptr(m), n, _ptr(out))
    else:
        status = lib.sda_mod_exp_batch(_ptr(x), len(bases), _ptr(e), e.size, _ptr(m), n,
                                       _ptr(out), n_threads)
    _raise_modexp(status)
    raw = out.tobytes()
    return [int.from_bytes(raw[8 * n * i:8 * n * (i + 1)], "little") for i in range(len(bases))]


def mod_exp(base: int, exp: int, mod: int) -> int:
    """``pow(base, exp, mod)`` for nonnegative operands and an odd modulus."""
    return _mod_exps([base], exp, mod, 1)[0]


def mod_exp_batch(bases, exp: int, mod: int, n_threads: int | None = None) -> list:
    """``[pow(b, exp, mod) for b in bases]`` in one C call: the Montgomery
    constants once for the modulus, the bases split over ``n_threads``
    threads (``SDA_NATIVE_THREADS``, else one per CPU)."""
    return _mod_exps(list(bases), exp, mod, n_threads or _default_threads())
