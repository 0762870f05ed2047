"""Fused per-participant limb share + participant reduction on Hopper.

Counterpart of ``sda_tpu/parallel/limb_pallas.py``. The per-participant
engine forms every participant's share limb-partials and sums them over the
participant axis; ``csrc/limb_share_sum.cu`` does both in one kernel on the
int8 tensor cores (``mma.sync`` m16n8k32), so no per-participant partial
reaches device memory. The kernel reads the ``(C, d)`` secrets and the
``(C, nb, t)`` randomness directly: the ``(C, nb, k+t)`` values that the
reference concatenates are never built on the card.

Two entries, each with its plain version (the CPU path and the kernel's
yardstick on the card):

- ``participant_limb_sums_cuda(values, stacks)``: the reference's signature,
  ``(C, nb, K)`` values (the kernel's t = 0 case);
- ``share_limb_sums_cuda(secrets, randomness, stacks, k)``: the two inputs,
  used by ``share_combine_limb_cuda``.

The stacks are packed into the kernel's B-fragment layout once per stacks
tensor (``packed_stacks``), not once per chunk.

Everything is int32: partials are bounded by L*K*127^2 and the participant
sum by C*L*K*127^2, which must stay < 2^31 (checked before every launch).
The mod-p recombine happens outside, on the reduced accumulator. Narrow
fields only (p < 2^31).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..telemetry.device import device_span

#: launches of the limb_share_sum kernel; only the launching wrapper adds
#: to it (plain-version calls are not counted)
launches = 0

_TILE = 8  # clerks per mma N tile
_LIMB_SLOTS = 5  # the kernel's limb counts: p < 2^31 has at most 5 limbs
_MAX_K = 256  # csrc/limb_share_sum.cu kMaxK


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


def share_limb_sums_torch(
    secrets: torch.Tensor, randomness: torch.Tensor, stacks: torch.Tensor, k: int
) -> torch.Tensor:
    """Plain version of the two-input entry: (C, d) secrets and (C, nb, t)
    randomness -> (L, nb, n) int32, over the values ``[batched secrets |
    randomness]`` with the secrets' tail zero-padded to nb*k."""
    C, d = secrets.shape
    nb = randomness.shape[1]
    if randomness.shape[0] != C or nb != -(-d // k):
        raise ValueError(f"randomness {tuple(randomness.shape)} does not fit secrets {(C, d)}, k={k}")
    batches = torch.nn.functional.pad(secrets.to(torch.int32), (0, nb * k - d))
    values = torch.cat(
        [batches.reshape(C, nb, k), randomness.to(device=secrets.device, dtype=torch.int32)],
        dim=-1,
    )
    return participant_limb_sums_torch(values, stacks)


def kernel_geometry(K: int) -> tuple[int, int, int]:
    """(Kp, participants per mma step, kk slices of 32) for contraction K:
    kk is zero-padded to Kp = max(4, 2^ceil(log2 K)); one m16n8k32 step
    covers 32/Kp participants, or for Kp > 32 one participant's slice of 32."""
    Kp = 4
    while Kp < K:
        Kp *= 2
    return Kp, max(1, 32 // Kp), max(1, Kp // 32)


def pack_stacks(stacks: torch.Tensor) -> torch.Tensor:
    """(L, L*K, n) int8 -> the kernel's B fragments, (n_tiles, KPS, L, L, 32, 2)
    int32: for clerk tile, kk slice, output limb m, input limb i and lane
    (g = lane // 4 the clerk in the tile, q = lane % 4), register h holds the
    stack bytes of reduction slots 16h + 4q + e, e = 0..3, slot -> kk =
    slot % Kp (or 32*slice + slot when Kp > 32); zero for kk >= K and for
    clerks >= n."""
    L, LK, n = stacks.shape
    K = LK // L
    Kp, _, kps = kernel_geometry(K)
    n_tiles = -(-n // _TILE)
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    slot = 16 * np.arange(2)[:, None, None] + 4 * q[None, :, None] + np.arange(4)[None, None, :]
    kk = (slot % Kp if Kp <= 32 else slot)[None] + 32 * np.arange(kps)[:, None, None, None]
    clerk = _TILE * np.arange(n_tiles)[:, None] + g[None, :]  # (T, 32)
    # gather index arrays over (T, KPS, h, lane, e)
    kk_b = np.broadcast_to(kk[None], (n_tiles, kps, 2, 32, 4))
    cl_b = np.broadcast_to(clerk[:, None, None, :, None], (n_tiles, kps, 2, 32, 4))
    live = (kk_b < K) & (cl_b < n)
    src = stacks.detach().to("cpu", torch.int8).numpy().reshape(L, L, K, n)  # [m, i, kk, j]
    got = src[:, :, np.where(live, kk_b, 0), np.where(live, cl_b, 0)]  # (L, L, T, KPS, 2, 32, 4)
    got = np.where(live, got, 0).astype(np.int8)
    frags = np.ascontiguousarray(got.transpose(2, 3, 0, 1, 5, 4, 6))  # (T, KPS, L, L, 32, 2, 4)
    return torch.as_tensor(np.ascontiguousarray(frags.view(np.int32)[..., 0]), device=stacks.device)


_packed: dict[int, tuple[weakref.ref, torch.Tensor]] = {}


def packed_stacks(stacks: torch.Tensor) -> torch.Tensor:
    """``pack_stacks(stacks)``, built once per stacks tensor (a plan's
    constant) and kept while that tensor lives."""
    key = id(stacks)
    hit = _packed.get(key)
    if hit is not None and hit[0]() is stacks:
        return hit[1]
    packed = pack_stacks(stacks)
    _packed[key] = (weakref.ref(stacks, lambda _, key=key: _packed.pop(key, None)), packed)
    return packed


def _as_int32(x: torch.Tensor, name: str) -> torch.Tensor:
    """int32 contiguous as the kernel reads it: int64 canonical residues are
    narrowed in one copy (the CPU aggregator's dtype); other dtypes raise."""
    if x.dtype == torch.int64:
        x = x.to(torch.int32)
    if x.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 (or int64) canonical residues, got {x.dtype}")
    return x.contiguous()


def _launch(secrets, randomness, stacks, k: int) -> torch.Tensor:
    """Checks, then one launch over (C, d) secrets and (C, nb, t) randomness
    (``None`` when t = 0) on a CUDA device."""
    global launches
    from .. import kernels

    dev = secrets.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if stacks.device != dev or stacks.dtype != torch.int8 or stacks.ndim != 3:
        raise ValueError("stacks must be an (L, L*K, n) int8 tensor on the secrets' device")
    C, d = secrets.shape
    nb = -(-d // k)
    t = 0 if randomness is None else randomness.shape[2]
    if randomness is not None and (randomness.device != dev or tuple(randomness.shape[:2]) != (C, nb)):
        raise ValueError(f"randomness {tuple(randomness.shape)} does not fit secrets {(C, d)}, k={k}")
    L, LK, n = stacks.shape
    K = k + t
    if LK != L * K:
        raise ValueError(f"stacks contraction {LK} != L*K = {L * K}")
    if L > _LIMB_SLOTS:
        raise ValueError(f"{L} limbs: the kernel takes narrow fields (p < 2^31) only")
    if K > _MAX_K:
        raise ValueError(f"contraction K={K} exceeds the kernel's shared-memory ring (K <= {_MAX_K})")
    _check_bound(C, L, K)
    with device_span("limb.k1"):
        out = torch.zeros((L, nb, n), dtype=torch.int32, device=dev)
        if C == 0 or d == 0 or n == 0:
            return out
        packed = packed_stacks(stacks)
        fn = kernels.load("limb_share_sum").limb_share_sum_launch
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(
                secrets.data_ptr(), 0 if randomness is None else randomness.data_ptr(),
                packed.data_ptr(), out.data_ptr(), C, d, nb, k, t, L, n, stream,
            )
    if rc != 0:
        raise RuntimeError(f"limb_share_sum launch failed: cudaError {rc}")
    launches += 1
    return out


def participant_limb_sums_cuda(values: torch.Tensor, stacks: torch.Tensor) -> torch.Tensor:
    """(C, nb, K) int32 canonical values -> (L, nb, n) int32 partial sums.

    ``stacks`` from ``fold_const_limbs`` (L, L*K, n) int8. Drop-in for
    ``limb_partials_const`` + participant reduction with weights 128^m. On a
    CPU tensor this is the plain version; on a CUDA tensor it launches the
    kernel (as secrets (C, nb*K) with k = K and no randomness) or raises.
    """
    if values.device.type == "cpu":
        with device_span("limb.k1"):
            return participant_limb_sums_torch(values, stacks)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if values.dtype != torch.int32 or values.ndim != 3 or not values.is_contiguous():
        raise ValueError("values must be a contiguous (C, nb, K) int32 tensor")
    C, nb, K = values.shape
    return _launch(values.view(C, nb * K), None, stacks, K)


def share_limb_sums_cuda(
    secrets: torch.Tensor, randomness: torch.Tensor, stacks: torch.Tensor, k: int
) -> torch.Tensor:
    """(C, d) secrets and (C, nb, t) randomness, canonical residues ->
    (L, nb, n) int32 partial sums over the values ``[batched secrets |
    randomness]``, without building them. On CPU tensors this is the plain
    version; on CUDA tensors it launches the kernel or raises."""
    if secrets.device.type == "cpu":
        with device_span("limb.k1"):
            return share_limb_sums_torch(secrets, randomness, stacks, k)
    if secrets.device.type != "cuda":
        raise ValueError(f"unsupported device {secrets.device}")
    if secrets.ndim != 2 or randomness.ndim != 3:
        raise ValueError("secrets must be (C, d) and randomness (C, nb, t)")
    rand = _as_int32(randomness, "randomness") if randomness.shape[2] else None
    return _launch(_as_int32(secrets, "secrets"), rand, stacks, k)


def share_combine_limb_cuda(secrets: torch.Tensor, generator, plan, draw=None) -> torch.Tensor:
    """Fused-kernel twin of ``engine.share_combine_limb`` for p < 2^31: the
    same (W, b, n) int64 contract (weights 128^m), bit-identical results for
    the same draws. The randomness comes from ``draw`` (default: the
    engine's device draw) and goes to the kernel beside the secrets."""
    from .engine import _device_randomness

    if plan.modulus >= (1 << 31):
        raise ValueError("the fused limb kernel is narrow-field only (p < 2^31)")
    if draw is None:
        draw = _device_randomness
    C, d = secrets.shape
    nb = -(-d // plan.input_size)
    with device_span("limb.draw"):
        randomness = draw(generator, (C, nb, plan.rand_size), plan.modulus).to(secrets.device)
    acc = share_limb_sums_cuda(secrets, randomness, plan.limb_stacks, plan.input_size)
    return acc.to(torch.int64)  # (W=L, b, n)
