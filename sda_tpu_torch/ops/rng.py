"""Randomness for masks and shares (counterpart of ``sda_tpu/ops/rng.py``).

Host path: ``uniform_mod_host``, unbiased uniform draws in ``[0, m)`` from OS
entropy, for the protocol plane's real participants.

Device path: draws for simulated participants. Each draw takes an explicit ``torch.Generator`` in place of a JAX key and
returns a tensor on that generator's device. The bits differ from JAX's
threefry and need not match: parity tests hand both packages the same
host-drawn numbers through the engines' ``draw=`` hooks.

Simulation grade only: real participants draw on their own hosts from OS
entropy (``uniform_mod_host``), where full-range uniformity is a privacy
requirement.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def uniform_mod_host(shape, m: int, entropy=os.urandom) -> np.ndarray:
    """Unbiased uniform int64 draws in [0, m) from OS entropy.

    Draws of at least 512 under the default ``os.urandom`` entropy take the
    reference's route: the native layer's C ChaCha20 expansion keyed with a
    fresh full 256-bit OS-entropy key per call, under the same unbiased
    rand-0.3 rejection zone as the protocol's ChaCha masks. Smaller draws,
    and a custom ``entropy`` source (tests pass deterministic ones), take
    the direct path: rejection of the u64 draws at or above the largest
    multiple of m. Both give unbiased uniforms over [0, m)."""
    if not (0 < m <= 1 << 63):
        raise ValueError(f"modulus out of range: {m}")
    n = int(np.prod(shape)) if shape else 1
    if entropy is os.urandom and n >= 512:
        from .. import native

        seed = np.frombuffer(os.urandom(32), dtype=np.uint32)
        return native.chacha_expand(seed, n, m).reshape(shape)
    out = np.empty(n, dtype=np.int64)
    rejection = (1 << 64) % m != 0
    zone = (1 << 64) - ((1 << 64) % m)  # accept draws < zone
    filled = 0
    while filled < n:
        need = n - filled
        draw = np.frombuffer(entropy(8 * need), dtype=np.uint64)
        if rejection:
            draw = draw[draw < np.uint64(zone)]
        vals = (draw % np.uint64(m)).astype(np.int64)
        k = min(len(vals), need)
        out[filled : filled + k] = vals[:k]
        filled += k
    return out.reshape(shape)


def _draw(generator: torch.Generator, shape, high: int, dtype=torch.int64):
    """Uniform integers in ``[0, high)`` on the generator's device. Exact for
    a power-of-two ``high``."""
    return torch.randint(
        0, high, tuple(shape), generator=generator, dtype=dtype,
        device=generator.device,
    )


def uniform_mod_device(generator: torch.Generator, shape, m: int) -> torch.Tensor:
    """Uniform int64 draws in ``[0, m)`` from a 63-bit draw reduced mod m.

    The modulo bias is below ``m / 2**63``: under ``2**-32`` for
    ``m < 2**31``. Fine for load simulation, not a protocol CSPRNG.
    """
    if not (0 < m <= 1 << 62):
        raise ValueError(f"modulus out of range: {m}")
    hi = _draw(generator, shape, 1 << 31)
    lo = _draw(generator, shape, 1 << 32)
    return torch.fmod((hi << 32) | lo, m)


def uniform_bits_device(generator: torch.Generator, shape, nbits: int) -> torch.Tensor:
    """Uniform int64 draws over ``[0, 2**nbits)``: exact (power-of-two range,
    zero modulo bias) and division-free. The streaming benchmark draws
    synthetic data with ``nbits = p.bit_length() - 1``, a sub-range of the
    field."""
    if not (0 < nbits <= 62):
        raise ValueError(f"nbits out of range: {nbits}")
    return _draw(generator, shape, 1 << nbits)


def uniform_bits_device_pair(generator: torch.Generator, shape, nbits: int):
    """``uniform_bits_device`` for ``32 <= nbits <= 62`` as a ``(hi, lo)``
    pair of int32 tensors holding the uint32 bit patterns of the value
    ``hi * 2**32 + lo``; ``hi`` is masked to ``nbits - 32`` bits (all zero
    at ``nbits == 32``). No int64 tensor of the values is built: the wide
    sum-first path (``sumfirst.value_limb_sums_chunk_pair``) consumes the
    halves directly."""
    if not (32 <= nbits <= 62):
        raise ValueError(f"pair draw needs 32 <= nbits <= 62, got {nbits}")
    hi = _draw(generator, shape, 1 << (nbits - 32), dtype=torch.int32)
    lo = torch.randint(
        -(1 << 31), 1 << 31, tuple(shape), generator=generator, dtype=torch.int32,
        device=generator.device,
    )
    return hi, lo


def uniform_bits_device_narrow(
    generator: torch.Generator, shape, nbits: int
) -> torch.Tensor:
    """``uniform_bits_device`` for ``nbits <= 31``, kept int32 for the narrow
    (int32) hot paths."""
    if not (0 < nbits <= 31):
        raise ValueError(f"narrow draw needs nbits <= 31, got {nbits}")
    return _draw(generator, shape, 1 << nbits, dtype=torch.int32)
