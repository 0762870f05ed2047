"""The discrete Gaussian sampler on Hopper, and its plain twin.

The Canonne–Kamath–Steinke rejection sampler of ``models/dp.py``
(``sample_discrete_gaussian``) draws its proposals here: a discrete Laplace
of scale t = ⌊σ⌋+1, accepted with probability exp(-(|y| - σ²/t)²/2σ²),
tested in float64. ``csrc/dgauss.cu`` does it in one launch: a warp fills a
segment of ``SEGMENT`` values from Philox4x32-10 proposals, one a lane a
step, the accepted ones taking the segment's next slots in lane order until
it is full (its header note has the law and the bound). ``sample`` draws a
fresh 64-bit key from the caller's ``torch.Generator`` with one device op and
then, on a CUDA generator, launches the kernel or raises; on a CPU generator
it runs ``dgauss_plain``, the same stream in torch, vectorised over the
segments, bit for bit the kernel's (the card tests hold them equal).

Counters: ``launches`` (the kernel's launches), and each device's count of
the proposals drawn on it, an int64 there: the kernel adds its own to it
(one atomicAdd a block), and on the CPU ``sample`` adds the twin's.
``proposals(device)`` reads it, which waits on the device.
"""

from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

#: values a warp fills in one go (a multiple of ``LANES``)
SEGMENT = 256
LANES = 32

#: launches of ``dgauss_kernel``; only ``sample`` adds to it
launches = 0

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
#: proposals' segments handled at once by the twin (about 4M values), so its
#: transients stay near half a GB at any n
_TWIN_SEGMENTS = 1 << 14

#: device -> the int64 there that counts its proposals
_accumulators: dict = {}
#: guards ``_accumulators``, the CPU's count and ``launches``
_lock = threading.Lock()


def _mulhilo(x: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit words of ``x * m`` for u32 ``x`` held in int64 and
    a u32 constant ``m``, in 48-bit partial products (no int64 overflow)."""
    p1 = x * (m & 0xFFFF)
    p2 = x * (m >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (s >> 32), s & _U32


def philox(key: torch.Tensor, c0, c1, c2, c3):
    """Philox4x32-10 of the u64 ``key`` (an int64 tensor) at the counter
    words ``c0..c3`` (u32 values in int64 tensors, broadcast together): the
    four output words, as int64 tensors of u32 values."""
    k0, k1 = key & _U32, (key >> 32) & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def constants(sigma: float) -> tuple[float, float, float]:
    """The kernel's float64 arguments: t = ⌊σ⌋+1, the center σ²/t and the
    scale -1/(2σ²) of the acceptance's exponent."""
    t = math.floor(sigma) + 1
    return float(t), sigma * sigma / t, -1.0 / (2.0 * sigma * sigma)


def proposals_at(key: torch.Tensor, segment: torch.Tensor, offset: torch.Tensor, sigma: float):
    """The proposals at ``(segment, offset)`` (int64 tensors, broadcast
    together; offset = 32·step + lane): ``(y, accepted)``, the discrete
    Laplace value as int64 and whether the test keeps it."""
    t, center, scale = constants(sigma)
    w0, w1, w2, w3 = philox(key, offset & _U32, offset >> 32, segment & _U32, segment >> 32)
    a = (w0 << 21) | (w1 >> 11)
    b = (w2 << 21) | (w3 >> 11)
    negative = (w1 & 1).bool()
    # (a + 1)·2^-53 in (0, 1] and b·2^-53 are exact in float64
    g = torch.floor(torch.log((a + 1).to(torch.float64) * 2.0**-53) * -t)
    dev = g - center
    ok = ~(negative & (g == 0)) & (b.to(torch.float64) * 2.0**-53 < torch.exp((dev * dev) * scale))
    return torch.where(negative, -g, g).to(torch.int64), ok


@functools.lru_cache(maxsize=64)
def acceptance_rate(sigma: float) -> float:
    """The share of discrete Laplace proposals (t = ⌊σ⌋+1) that the
    Canonne–Kamath–Steinke test accepts at σ: Σ_y L_t(y)·exp(-(|y| -
    σ²/t)²/2σ²), summed to |y| = 40t (the proposal's mass beyond is below
    e^-40). 0.44-0.73 below σ = 4; above it the rate rises to √(π/2)·e^-½ =
    0.7601734505, so past σ = 10⁴, within 1e-8 of that, it is taken there."""
    sigma = min(sigma, 1e4)
    t = math.floor(sigma) + 1
    q = math.exp(-1.0 / t)
    y = np.arange(0, 40 * t + 1, dtype=np.float64)
    mass = (1.0 - q) / (1.0 + q) * np.exp(-y / t) * np.where(y > 0, 2.0, 1.0)
    return float(np.sum(mass * np.exp(-((y - sigma * sigma / t) ** 2) / (2.0 * sigma * sigma))))


def draw_rate(sigma: float) -> float:
    """The share of Philox proposals kept: the sign test's 1 - (1-q)/2
    (q = e^(-1/t)) times the CKS acceptance rate."""
    t = math.floor(sigma) + 1
    return (1.0 + math.exp(-1.0 / t)) / 2.0 * acceptance_rate(sigma)


def dgauss_plain(sigma: float, n: int, key: torch.Tensor):
    """The kernel's plain twin: ``(n,)`` int64 N_Z(0, σ²) on the key's
    device, and the proposals drawn (an int64 0-d tensor there), from the
    same Philox stream. Each segment's proposals in (step, lane) order keep
    their first ``SEGMENT`` accepted ones (fewer in the last segment), and
    the segment drew 32 proposals a step up to the step that filled it."""
    device = key.device
    out = torch.empty(n, dtype=torch.int64, device=device)
    drawn = torch.zeros((), dtype=torch.int64, device=device)
    rate = draw_rate(sigma)
    segments = -(-n // SEGMENT)
    lanes = torch.arange(LANES, device=device)
    for first in range(0, segments, _TWIN_SEGMENTS):
        live = torch.arange(first, min(first + _TWIN_SEGMENTS, segments), device=device)
        length = torch.clamp(n - live * SEGMENT, max=SEGMENT)
        filled = torch.zeros_like(live)
        step = 0
        while live.numel():
            need = int((length - filled).max())
            k = math.ceil((need + 4.0 * math.sqrt(need) + 4.0) / (LANES * rate))
            offset = ((step + torch.arange(k, device=device))[:, None] * LANES + lanes).reshape(-1)
            y, ok = proposals_at(key, live[:, None], offset[None, :], sigma)
            rank = filled[:, None] + torch.cumsum(ok, dim=1)
            keep = ok & (rank <= length[:, None])
            out[(live[:, None] * SEGMENT + rank - 1)[keep]] = y[keep]
            full = rank[:, -1] >= length
            # a full segment stopped at the step of its last kept proposal
            last = k * LANES - (rank[full] >= length[full, None]).sum(dim=1)
            drawn += torch.sum(step + torch.div(last, LANES, rounding_mode="floor") + 1) * LANES
            live, length, filled = live[~full], length[~full], rank[~full, -1]
            step += k
    return out, drawn


def draw_key(generator: torch.Generator) -> torch.Tensor:
    """A fresh u64 key (an int64 0-d tensor) from ``generator``, on its
    device: one device op, no host round trip."""
    return torch.empty((), dtype=torch.int64, device=generator.device).random_(
        -(1 << 63), None, generator=generator)


def sample(sigma: float, n: int, generator: torch.Generator) -> torch.Tensor:
    """``(n,)`` int64 N_Z(0, σ²) on the generator's device, from a fresh key
    of ``generator``: on a CPU generator the plain twin, on a CUDA one one
    launch of the kernel (it raises where the launch fails)."""
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=generator.device)
    key = draw_key(generator)
    if key.device.type == "cpu":
        out, drawn = dgauss_plain(sigma, n, key)
        acc = _accumulator(key.device)
        with _lock:
            acc += drawn
        return out
    return dgauss_cuda(sigma, n, key)


def _accumulator(device: torch.device) -> torch.Tensor:
    """The int64 on ``device`` that counts the proposals drawn there."""
    with _lock:
        acc = _accumulators.get(device)
        if acc is None:
            acc = _accumulators[device] = torch.zeros((), dtype=torch.int64, device=device)
    return acc


def proposals(device) -> int:
    """The proposals drawn on ``device`` so far, by the kernel on a card and
    by the twin through ``sample`` on the CPU; the read waits on the
    device."""
    return int(_accumulator(torch.device(device)))


def dgauss_cuda(sigma: float, n: int, key: torch.Tensor) -> torch.Tensor:
    """One launch of ``dgauss_kernel`` for ``n`` values from the CUDA 0-d
    int64 ``key``; its proposals go to the device's accumulator."""
    global launches
    from .. import kernels

    if key.device.type != "cuda" or key.dtype != torch.int64 or key.numel() != 1:
        raise ValueError("the key must be one int64 on a CUDA device")
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    out = torch.empty(n, dtype=torch.int64, device=key.device)
    if n == 0:
        return out
    t, center, scale = constants(sigma)
    fn = kernels.load("dgauss").dgauss_launch
    with torch.cuda.device(key.device):
        acc = _accumulator(key.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(key.data_ptr(), n, t, center, scale, out.data_ptr(), acc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dgauss launch failed: cudaError {rc}")
    with _lock:
        launches += 1
    return out
