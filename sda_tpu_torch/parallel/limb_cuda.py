"""Fused per-participant limb share + participant reduction on Hopper.

Counterpart of ``sda_tpu/parallel/limb_pallas.py``. The per-participant
engine forms every participant's share limb-partials and sums them over the
participant axis; ``csrc/limb_share_sum.cu`` does both in one kernel, so no
per-participant partial reaches device memory. ``participant_limb_sums_torch``
is its plain version: the CPU path and the kernel's yardstick on the card.

Everything is int32: partials are bounded by L*K*127^2 and the participant
sum by C*L*K*127^2, which must stay < 2^31 (checked before every launch).
The mod-p recombine happens outside, on the reduced accumulator. Narrow
fields only (p < 2^31).
"""

from __future__ import annotations

import torch

#: launches of the limb_share_sum kernel; only the launching wrapper adds
#: to it (plain-version calls are not counted)
launches = 0

_TILE = 8  # clerks per column tile in the kernel
_LIMB_SLOTS = 5  # limb slots in the kernel: p < 2^31 has at most 5 limbs
_MAX_SMEM = 48 * 1024  # static shared-memory budget per block


def _check_bound(C: int, L: int, K: int) -> None:
    if C * L * K * 127 * 127 >= (1 << 31):
        raise ValueError(
            f"participant accumulation over C={C} overflows int32; chunk first"
        )


def participant_limb_sums_torch(values: torch.Tensor, stacks: torch.Tensor) -> torch.Tensor:
    """Plain version: (C, nb, K) int32 canonical values -> (L, nb, n) int32.

    Limbs ``(C*nb, L*K)``, the L dots against ``stacks[m]`` as
    broadcast-multiply + int32 sum, then the participant reduction.
    """
    from .limbmatmul import _int_dot

    C, nb, K = values.shape
    L, LK, n = stacks.shape
    if LK != L * K:
        raise ValueError(f"stacks contraction {LK} != L*K = {L * K}")
    _check_bound(C, L, K)
    x = values.reshape(C * nb, K).to(torch.int32)
    a = torch.cat([(x >> (7 * i)) & 0x7F for i in range(L)], dim=-1)  # (M, L*K)
    stacks = stacks.to(values.device)
    out = torch.empty((L, nb, n), dtype=torch.int32, device=values.device)
    for m in range(L):
        prod = _int_dot(a, stacks[m])  # (C*nb, n)
        out[m] = torch.sum(prod.reshape(C, nb, n), dim=0, dtype=torch.int32)
    return out


def pack_stacks(stacks: torch.Tensor) -> torch.Tensor:
    """(L, L*K, n) int8 -> the kernel's (n_tiles, K, 5, 8, 2) int32 layout:
    for each clerk tile, contraction row kk, output limb m and clerk, the
    stack bytes of limbs i = 0..7 (zero for i >= L) as two int32 words."""
    L, LK, n = stacks.shape
    K = LK // L
    n_tiles = -(-n // _TILE)
    full = torch.zeros(
        (_LIMB_SLOTS, 8, K, n_tiles * _TILE), dtype=torch.int8, device=stacks.device
    )
    full[:L, :L, :, :n] = stacks.view(L, L, K, n)  # [m, i, kk, j]
    full = full.view(_LIMB_SLOTS, 8, K, n_tiles, _TILE).permute(3, 2, 0, 4, 1)
    return full.contiguous().view(torch.int32)


def participant_limb_sums_cuda(values: torch.Tensor, stacks: torch.Tensor) -> torch.Tensor:
    """(C, nb, K) int32 canonical values -> (L, nb, n) int32 partial sums.

    ``stacks`` from ``fold_const_limbs`` (L, L*K, n) int8. Drop-in for
    ``limb_partials_const`` + participant reduction with weights 128^m. On a
    CPU tensor this is the plain version; on a CUDA tensor it launches the
    kernel or raises.
    """
    if values.device.type == "cpu":
        return participant_limb_sums_torch(values, stacks)
    global launches
    from .. import kernels

    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if values.dtype != torch.int32 or values.ndim != 3 or not values.is_contiguous():
        raise ValueError("values must be a contiguous (C, nb, K) int32 tensor")
    if stacks.device != values.device or stacks.dtype != torch.int8 or stacks.ndim != 3:
        raise ValueError("stacks must be an (L, L*K, n) int8 tensor on the values' device")
    C, nb, K = values.shape
    L, LK, n = stacks.shape
    if LK != L * K:
        raise ValueError(f"stacks contraction {LK} != L*K = {L * K}")
    if L > _LIMB_SLOTS:
        raise ValueError(f"{L} limbs: the kernel takes narrow fields (p < 2^31) only")
    if K * _LIMB_SLOTS * _TILE * 2 * 4 > _MAX_SMEM:
        raise ValueError(f"contraction K={K} exceeds the kernel's shared-memory tile")
    _check_bound(C, L, K)
    out = torch.zeros((L, nb, n), dtype=torch.int32, device=values.device)
    if C == 0 or nb == 0 or n == 0:
        return out
    packed = pack_stacks(stacks)
    fn = kernels.load("limb_share_sum").limb_share_sum_launch
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            values.data_ptr(), packed.data_ptr(), out.data_ptr(),
            C, nb, K, L, n, stream,
        )
    if rc != 0:
        raise RuntimeError(f"limb_share_sum launch failed: cudaError {rc}")
    launches += 1
    return out


def share_combine_limb_cuda(secrets: torch.Tensor, generator, plan, draw=None) -> torch.Tensor:
    """Fused-kernel twin of ``engine.share_combine_limb`` for p < 2^31: the
    same (W, b, n) int64 contract (weights 128^m), bit-identical results for
    the same draws."""
    from .engine import _share_values

    if plan.modulus >= (1 << 31):
        raise ValueError("the fused limb kernel is narrow-field only (p < 2^31)")
    values = _share_values(secrets, generator, plan, draw, torch.int32)
    acc = participant_limb_sums_cuda(values, plan.limb_stacks)
    return acc.to(torch.int64)  # (W=L, b, n)
