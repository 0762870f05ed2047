"""Single-device secure-sum engine (counterpart of the single-device part of
``sda_tpu/parallel/engine.py``).

Pipeline, all mod p with truncated-remainder representatives:

1. *share*: reshape ``(P, dim) -> (P, B, k)`` batches (zero-padding the dim
   tail like the reference's batched.rs), append ``(P, B, t)`` randomness,
   multiply by the precomputed share matrix ``(k+t, n)`` -> ``(P, B, n)``;
2. *clerk-combine*: a mod-p sum over the participant axis -> ``(n, B)``;
3. *reconstruct*: a Lagrange matrix over the surviving clerk rows, pad
   truncated.

Integer products are broadcast-multiply + ``fmod`` + sum (CUDA has no
integer GEMM in torch), exactly the reference's form. Values live in int32
while p < 2^31 and widen to int64 where products or sums need it. The
streamed bench path fuses share + combine in limb space
(``share_combine_limb``; its kernel twin is ``limb_cuda``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import shamir
from ..ops.modular import mod_sum_auto
from ..protocol import AdditiveSharing, BasicShamirSharing, PackedShamirSharing
from .limbmatmul import fold_const_limbs


@dataclass(frozen=True)
class AggregationPlan:
    """Constants for a scheme + dimension, resident on ``device``."""

    modulus: int
    dim: int
    input_size: int  # k (1 for additive)
    rand_size: int  # t for Shamir, n-1 for additive
    share_count: int  # n
    n_batches: int  # B = ceil(dim / k)
    share_matrix: torch.Tensor | None  # (n, k+t) int64; None for additive
    limb_stacks: torch.Tensor | None  # (L, L*(k+t), n) int8 from fold_const_limbs
    device: torch.device


def make_plan(scheme, dim: int, device=None) -> AggregationPlan:
    """Plan for ``scheme`` over ``dim`` values; ``device`` defaults to CUDA
    (raises without a GPU)."""
    device = resolve_device(device)
    if isinstance(scheme, (BasicShamirSharing, PackedShamirSharing)):
        k = scheme.input_size
        S = shamir.share_matrix(scheme)
        p = scheme.prime_modulus
        return AggregationPlan(
            modulus=p,
            dim=dim,
            input_size=k,
            rand_size=scheme.privacy_threshold,
            share_count=scheme.share_count,
            n_batches=-(-dim // k),
            share_matrix=torch.as_tensor(S, dtype=torch.int64, device=device),
            limb_stacks=torch.as_tensor(fold_const_limbs(S.T, p), device=device),
            device=device,
        )
    if isinstance(scheme, AdditiveSharing):
        return AggregationPlan(
            modulus=scheme.modulus,
            dim=dim,
            input_size=1,
            rand_size=scheme.share_count - 1,
            share_count=scheme.share_count,
            n_batches=dim,
            share_matrix=None,
            limb_stacks=None,
            device=device,
        )
    raise TypeError(f"unknown sharing scheme {scheme!r}")


def _batch_secrets(secrets: torch.Tensor, plan: AggregationPlan) -> torch.Tensor:
    """(P, d) -> (P, b, k) with a zero-padded tail (batched.rs semantics)."""
    P, d = secrets.shape
    nb = -(-d // plan.input_size)
    pad = nb * plan.input_size - d
    if pad:
        secrets = torch.nn.functional.pad(secrets, (0, pad))
    return secrets.reshape(P, nb, plan.input_size)


def _device_randomness(generator: torch.Generator, shape, modulus: int) -> torch.Tensor:
    """Uniform draws in [0, modulus) on the generator's device
    (simulation grade; see ops/rng.py)."""
    from ..ops.rng import uniform_mod_device

    return uniform_mod_device(generator, shape, modulus)


def _share_values(secrets, generator, plan: AggregationPlan, draw, dtype) -> torch.Tensor:
    """(P, d) secrets -> (P, b, k+t) ``[batched secrets | randomness]``."""
    if draw is None:
        draw = _device_randomness
    batches = _batch_secrets(secrets, plan)  # (P, b, k)
    P, nb = batches.shape[0], batches.shape[1]
    randomness = draw(generator, (P, nb, plan.rand_size), plan.modulus)
    return torch.cat(
        [batches.to(dtype), randomness.to(device=batches.device, dtype=dtype)], dim=-1
    )


def _lane_dtype(p: int) -> torch.dtype:
    """Keep the big tensor in int32 lanes when the field fits them."""
    return torch.int32 if p <= (1 << 31) else torch.int64


def share_participants(
    secrets: torch.Tensor, generator, plan: AggregationPlan, use_limbs: bool = False,
    draw=None,
) -> torch.Tensor:
    """(P, dim) secrets -> (P, n, B) per-clerk share tensor.

    ``draw(generator, shape, p) -> integers in [0, p)`` overrides the
    randomness (benchmarks pass a masked-bits draw, tests a host array).
    """
    p = plan.modulus
    if plan.share_matrix is None:
        # additive: n-1 uniform draws + closing share (additive.rs:42-48);
        # the auto sum avoids int64 overflow of (n-1)*(p-1) at wide p
        if draw is None:
            draw = _device_randomness
        P, d = secrets.shape
        draws = draw(generator, (P, plan.share_count - 1, d), p).to(secrets.device)
        total = mod_sum_auto(draws, p, axis=1)
        last = torch.fmod(secrets.to(torch.int64) - total, p)
        return torch.cat([draws.to(torch.int64), last[:, None, :]], dim=1)

    if use_limbs:
        from .limbmatmul import limb_modmatmul_const

        values = _share_values(secrets, generator, plan, draw, _lane_dtype(p))
        P, nb = values.shape[0], values.shape[1]
        flat = values.reshape(-1, values.shape[-1])
        S_T = plan.share_matrix.T.cpu().numpy()
        shares = limb_modmatmul_const(flat, S_T, p).reshape(P, nb, -1)
    else:
        if p >= (1 << 31):
            raise ValueError(
                "int64 share products overflow for p >= 2^31; use the limb "
                "path (share_combine_limb + limb_recombine_host)"
            )
        values = _share_values(secrets, generator, plan, draw, torch.int64)
        S_T = plan.share_matrix.T.to(values.device)  # (k+t, n)
        prods = torch.fmod(values[..., :, None] * S_T[None, None, :, :], p)
        shares = torch.fmod(torch.sum(prods, dim=-2), p)  # (P, B, n)
    return shares.transpose(1, 2)  # (P, n, B)


def share_combine_limb(
    secrets: torch.Tensor, generator, plan: AggregationPlan, draw=None
) -> torch.Tensor:
    """Fused share + clerk-combine in limb space: (C, d) -> (W, b, n) int64.

    int8-limb dots produce weight-grouped partials, summed over the
    participant axis first (linearity), then carried as a tiny (W, b, n)
    accumulator. Callers reduce accumulators across chunks with ``fmod``
    and recombine once at the end (``limb_recombine_host``).
    """
    from .limbmatmul import limb_partials_const

    p = plan.modulus
    values = _share_values(secrets, generator, plan, draw, _lane_dtype(p))
    C, nb = values.shape[0], values.shape[1]
    stacks = plan.limb_stacks
    partials = limb_partials_const(values.reshape(C * nb, -1), stacks, p)
    W, LK = stacks.shape[0], stacks.shape[1]
    per_part = partials.reshape(W, C, nb, -1)
    if C * LK * 127 * 127 < 2**31:
        return torch.sum(per_part, dim=1, dtype=torch.int32).to(torch.int64)
    return torch.sum(per_part.to(torch.int64), dim=1)


def clerk_combine(shares: torch.Tensor) -> torch.Tensor:
    """(P, n, B) -> (n, B) int64 sums; exact only while P*(p-1) < 2^63 (the
    caller reduces mod p). ``clerk_combine_mod`` has no such bound."""
    return torch.sum(shares.to(torch.int64), dim=0)


def clerk_combine_mod(shares: torch.Tensor, p: int) -> torch.Tensor:
    """Reduced clerk sums over the participant axis, exact for any p < 2^62."""
    return mod_sum_auto(shares, p, axis=0)


def reconstruct(clerk_sums: torch.Tensor, indices, scheme, dim: int) -> torch.Tensor:
    """(n, B) clerk sums + surviving ``indices`` -> (dim,) aggregate."""
    device = clerk_sums.device
    if isinstance(scheme, AdditiveSharing):
        return mod_sum_auto(clerk_sums.to(torch.int64), scheme.modulus, axis=0)[:dim]
    p = scheme.prime_modulus
    indices = list(indices)
    if p >= (1 << 31):
        # wide modulus: tiny matrices, exact host interpolation
        host = shamir.reconstruct_clerk_sums_host(
            clerk_sums.cpu().numpy(), indices, scheme, dim
        )
        return torch.as_tensor(np.asarray(host, dtype=np.int64), device=device)
    L = torch.as_tensor(
        shamir.reconstruction_matrix(scheme, indices), dtype=torch.int64, device=device
    )  # (k, R)
    rows = clerk_sums[torch.as_tensor(indices, device=device)].to(torch.int64)  # (R, B)
    prods = torch.fmod(L[:, :, None] * rows[None, :, :], p)
    secrets = torch.fmod(torch.sum(prods, dim=1), p)  # (k, B)
    return secrets.T.reshape(-1)[:dim]


class TorchAggregator:
    """End-to-end single-device secure-sum engine (counterpart of
    ``TpuAggregator``'s ``mesh=None`` path). ``device`` defaults to CUDA and
    raises without a GPU; pass ``device="cpu"`` to run on the host."""

    def __init__(self, scheme, dim: int, device=None, use_limbs: bool = False):
        self.scheme = scheme
        self.dim = dim
        self.plan = make_plan(scheme, dim, device)
        self.device = self.plan.device
        self.use_limbs = use_limbs

    def secure_sum(self, secrets, generator: torch.Generator, indices=None) -> torch.Tensor:
        """(P, dim) -> (dim,) aggregate, all on the plan's device."""
        secrets = torch.as_tensor(secrets, device=self.device)
        shares = share_participants(secrets, generator, self.plan, self.use_limbs)
        sums = clerk_combine_mod(shares, self.plan.modulus)
        if indices is None:
            indices = range(self.plan.share_count)
        return reconstruct(sums, indices, self.scheme, self.dim)
