"""Exact mod-p products via base-128 limb decomposition (counterpart of
``sda_tpu/parallel/limbmatmul.py``).

Canonical residues (0 <= x < p) split into base-128 limbs (0..127); every
limb product is an int8 x int8 -> int32 dot, and the partials recombine
with ``128^w mod p`` weights in int64. Each partial product is <= 127^2,
so an int32 accumulator holds ~133k contraction terms; the guards below
raise before that bound could be crossed.

CUDA has no integer ``torch.matmul`` (and integer ``einsum`` lowers to
``bmm``, which refuses int on CUDA), so the plain limb dots here are
broadcast-multiply + int32 sum, sliced over rows so the intermediate stays
bounded. The fused share-and-reduce hot loop has its own kernel
(``limb_cuda``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..telemetry.device import device_span, sync

#: elements of the (rows, K, N) broadcast intermediate per slice (128 MiB)
_DOT_SLICE_ELEMS = 1 << 25


def _max_contraction(L: int) -> int:
    """int32 bound for one weight group: up to L partial dots summed, each
    elementwise <= K * 127^2."""
    return (1 << 31) // (127 * 127 * L)


def limb_count(p: int) -> int:
    return -(-p.bit_length() // 7)


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) for small integer operands, int32 accumulate. The
    caller guarantees every output fits int32."""
    a = a.to(torch.int32)
    b = b.to(device=a.device, dtype=torch.int32)
    M, K = a.shape
    N = b.shape[1]
    rows = max(1, _DOT_SLICE_ELEMS // max(1, K * N))
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    for r in range(0, M, rows):
        out[r : r + rows] = torch.sum(
            a[r : r + rows, :, None] * b[None], dim=1, dtype=torch.int32
        )
    return out


def _limbs(x: torch.Tensor, count: int, p: int) -> list[torch.Tensor]:
    """Base-128 limbs of canonical values (int32 lanes when p fits them)."""
    x = x.to(torch.int32 if p <= (1 << 31) else torch.int64)
    return [(x >> (7 * i)) & 0x7F for i in range(count)]


def limb_partials(A: torch.Tensor, B: torch.Tensor, p: int) -> torch.Tensor:
    """Weight-grouped limb partials of (M, K) @ (K, N) mod p.

    Returns int32 ``(W, M, N)`` with ``W = 2*L-1`` such that the true product
    is ``sum_w partials[w] * 128^w (mod p)``.
    """
    K = A.shape[-1]
    L = limb_count(p)
    if K > _max_contraction(L):
        raise ValueError(f"contraction {K} overflows int32 accumulator; chunk first")
    a_limbs = _limbs(A, L, p)
    b_limbs = _limbs(B.to(A.device), L, p)
    partials = [None] * (2 * L - 1)
    for i in range(L):
        for j in range(L):
            prod = _int_dot(a_limbs[i], b_limbs[j])
            w = i + j
            partials[w] = prod if partials[w] is None else partials[w] + prod
    return torch.stack(partials)


def limb_recombine(partials: torch.Tensor, p: int) -> torch.Tensor:
    """(W, ...) partials (each < 2^31) -> canonical mod-p int64 values.
    Call on a reduced accumulator, never inside the hot loop."""
    if p >= (1 << 31):
        raise ValueError(
            "device recombine needs p < 2^31 (weight products would overflow "
            "int64); reduce the accumulator and use limb_recombine_host"
        )
    W = partials.shape[0]
    with device_span("limb.recombine"):
        weights = torch.tensor(
            [pow(128, w, p) for w in range(W)], dtype=torch.int64, device=partials.device
        ).reshape((W,) + (1,) * (partials.ndim - 1))
        acc = torch.sum(torch.fmod(partials.to(torch.int64) * weights, p), dim=0)
        return torch.fmod(acc, p)


def limb_modmatmul(A: torch.Tensor, B: torch.Tensor, p: int) -> torch.Tensor:
    """(M, K) @ (K, N) mod p, inputs canonical, output canonical."""
    return limb_recombine(limb_partials(A, B, p), p)


def fold_const_limbs(B_host, p: int) -> np.ndarray:
    """Weight-folded limb decomposition of a constant matrix B (K, N).

    ``A @ B = sum_i a_i @ (128^i B mod p)``; decomposing each
    ``D_i = 128^i B mod p`` into base-128 limbs ``d_{i,m}`` and stacking the
    ``i`` axis onto the contraction gives
    ``A @ B = sum_m 128^m (A_limbs @ stacks[m]) (mod p)`` with
    ``A_limbs = [a_0 | ... | a_{L-1}]`` of shape (M, L*K). Returns int8
    ``(L, L*K, N)`` stacks; exact for any p (python-int arithmetic).
    """
    L = limb_count(p)
    B_obj = np.asarray(B_host, dtype=object)
    K, N = B_obj.shape
    stacks = np.empty((L, L * K, N), dtype=np.int8)
    for i in range(L):
        D_i = (pow(128, i, p) * B_obj) % p
        for m in range(L):
            stacks[m, i * K : (i + 1) * K] = ((D_i >> (7 * m)) & 0x7F).astype(
                np.int8
            )
    return stacks


def limb_partials_const(A: torch.Tensor, stacks, p: int) -> torch.Tensor:
    """Partials of ``A @ B mod p`` from ``fold_const_limbs(B)``.

    ``A`` (M, K) canonical; returns int32 ``(L, M, N)`` with the true product
    ``sum_m partials[m] * 128^m (mod p)``. Each partial <= L*K*127^2.
    """
    stacks = torch.as_tensor(stacks, device=A.device)
    L, LK, N = stacks.shape
    K = LK // L
    if A.shape[-1] != K:
        raise ValueError(f"A contraction {A.shape[-1]} != stacks K {K}")
    if LK * 127 * 127 >= (1 << 31):
        raise ValueError(f"contraction {LK} overflows int32 accumulator")
    a_limbs = torch.cat(_limbs(A, L, p), dim=-1)  # (M, L*K)
    return torch.stack([_int_dot(a_limbs, stacks[m]) for m in range(L)])


def limb_modmatmul_const(A: torch.Tensor, B_host, p: int) -> torch.Tensor:
    """(M, K) @ const (K, N) mod p with one final reduction.

    Exact because every partial is <= L*K*127^2: the weighted int64
    accumulator stays below ``L * L*K*127^2 * (p-1)``, checked against 2^63.
    """
    if p >= (1 << 31):
        raise ValueError(
            "device recombine needs p < 2^31; use limb_partials_const + "
            "reduce + limb_recombine_host"
        )
    stacks = fold_const_limbs(B_host, p)
    L, LK, _ = stacks.shape
    if L * (LK * 127 * 127) * (p - 1) >= (1 << 63):
        raise ValueError(f"contraction {LK} overflows the int64 recombine")
    partials = limb_partials_const(A, stacks, p)
    weights = torch.tensor(
        [pow(128, m, p) for m in range(L)], dtype=torch.int64, device=A.device
    )
    acc = torch.sum(
        partials.to(torch.int64) * weights.reshape((L,) + (1,) * (partials.ndim - 1)),
        dim=0,
    )
    return torch.fmod(acc, p)


def limb_recombine_host(partials, p: int) -> np.ndarray:
    """Exact host recombine for any modulus width: ``sum_w partials[w] *
    128^w mod p`` in python ints on the tiny (W, batches, clerks)
    accumulator. Returns canonical int64 values."""
    if isinstance(partials, torch.Tensor):
        with sync("recombine_host"):
            partials = partials.cpu().numpy()
    arr = np.asarray(partials, dtype=object)
    out = np.zeros(arr.shape[1:], dtype=object)
    for w in range(arr.shape[0]):
        out = (out + arr[w] * pow(128, w, p)) % p
    return out.astype(np.int64)
