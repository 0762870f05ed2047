"""Device draws for simulated participants (counterpart of the device half
of ``sda_tpu/ops/rng.py``).

Each draw takes an explicit ``torch.Generator`` in place of a JAX key and
returns a tensor on that generator's device. The bits differ from JAX's
threefry and need not match: parity tests hand both packages the same
host-drawn numbers through the engines' ``draw=`` hooks.

Simulation grade only: real participants draw on their own hosts from OS
entropy (``sda_tpu/ops/rng.py:uniform_mod_host``), where full-range
uniformity is a privacy requirement.
"""

from __future__ import annotations

import torch


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
