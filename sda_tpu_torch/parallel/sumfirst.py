"""Sum-first clerk sums: ``share(sum_c v_c) = sum_c share(v_c)`` (counterpart
of ``sda_tpu/parallel/sumfirst.py``).

Packed-Shamir share generation is a fixed linear map ``v -> v @ S`` over
the prime field, and a clerk's job is the sum of all participants' shares.
Matmul and participant sum commute, so when the goal is the clerk sums
themselves (simulated or co-hosted participants), the hot loop over the big
``(participants, dim)`` tensor is one streaming integer reduction, and the
share matmul runs once, on the host, over the tiny ``(B, K)`` participant
sum. Bit-exact: both orders give the same field elements. Do not use it
where each participant's shares must exist (to be sealed per clerk); that
is ``engine.share_participants``.

Overflow discipline: the reduction is carried as exact integer sums in
base-2^32 limbs, no mod op touches the big tensor. Values ``v < p < 2^62``
split into ``lo = v & (2^32 - 1)`` and ``hi = v >> 32``; limb sums over
``C_total`` participants stay below ``C_total * (2^32 - 1)``, so int64
accumulators are exact up to 2^31 participants (``MAX_PARTICIPANTS``). For
``p < 2^31`` one limb suffices. The epilogue (recombine mod p, share
matmul, reconstruction) runs on the host in exact python ints.

The narrow reduction (``exact_sum_narrow_u32``) carries uint32 words as
int32 bit patterns, since torch's uint32 arithmetic is incomplete: the
16-bit halves ``x & 0xFFFF`` and ``(x >> 16) & 0xFFFF`` are exact for every
bit pattern (the mask removes what the arithmetic shift brings in), each is
summed in int32 (exact while a chunk has at most ``MAX_NARROW_CHUNK`` rows)
and only the reduced ``(nb, K)`` result widens to int64.

Secrets and randomness are limb-summed separately and joined on the tiny
``(L, nb, .)`` results; no ``(C, nb, K)`` concatenation is built. That holds
for the ``(hi, lo)`` pair path too (``value_limb_sums_chunk_pair``), where
the reference concatenates the halves before summing: here each half of the
secrets and of the randomness is summed on its own.

Pure PyTorch: the reference has no Pallas kernel on this path (it is XLA
code there), so the port has no kernel for it either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import shamir
from ..ops.modular import modmatmul_np
from ..telemetry.device import device_span, sync
from .engine import (
    AggregationPlan,
    _batch_secrets,
    _device_randomness,
    fold_mesh_axes,
    instrument_fabric,
    validate_d_sharding,
)
from .mesh import axis_size, reduce_over

#: participant bound for exact int64 limb accumulation (see module doc)
MAX_PARTICIPANTS = 1 << 31

#: chunk bound for the int32 narrow reduction: C * (2^16 - 1) < 2^31
MAX_NARROW_CHUNK = 1 << 15


def limb_count_sum(p: int) -> int:
    """Limbs needed for exact base-2^32 sum accumulation of values < p."""
    return 1 if p <= (1 << 31) else 2


def exact_sum_narrow(x: torch.Tensor) -> torch.Tensor:
    """Exact axis-0 sums of nonnegative values < 2^31 in int32 lanes:
    ``(C, ...) -> (...)`` int64. The int32 bit pattern of such a value is
    its uint32 word, so this is ``exact_sum_narrow_u32``."""
    return exact_sum_narrow_u32(x.to(torch.int32))


def exact_sum_narrow_u32(x: torch.Tensor) -> torch.Tensor:
    """Exact axis-0 sums of uint32 words given as int32 bit patterns (or as
    int64 values in [0, 2^32), which narrow to those patterns): split into
    16-bit halves, sum each in int32, widen only the reduced result.
    ``(C, ...) -> (...)`` int64; raises past ``MAX_NARROW_CHUNK`` rows."""
    if x.shape[0] > MAX_NARROW_CHUNK:
        raise ValueError(f"narrow reduction bound is {MAX_NARROW_CHUNK} rows")
    x = x.to(torch.int32)
    lo = torch.sum(x & 0xFFFF, dim=0, dtype=torch.int32)
    hi = torch.sum((x >> 16) & 0xFFFF, dim=0, dtype=torch.int32)
    return lo.to(torch.int64) + (hi.to(torch.int64) << 16)


def value_limb_sums_chunk_pair(hi, lo, generator, plan: AggregationPlan, draw_pair) -> torch.Tensor:
    """The wide-modulus twin of :func:`value_limb_sums_chunk` over ``(hi,
    lo)`` uint32 words as int32 bit patterns (value = hi * 2^32 + lo < p <
    2^62). The base-2^32 limb sums are exactly ``sum lo`` and ``sum hi``,
    so no int64 tensor of the values is built. ``draw_pair(generator,
    shape) -> (hi, lo)`` supplies the share randomness in the same form
    (``rng.uniform_bits_device_pair``). Returns ``(2, nb, K)`` int64 exact
    limb sums; each half of the secrets and of the randomness is summed on
    its own (no concatenation)."""
    nb = -(-hi.shape[1] // plan.input_size)
    with device_span("sumfirst.draw"):
        rand_hi, rand_lo = draw_pair(generator, (hi.shape[0], nb, plan.rand_size))
    with device_span("sumfirst.reduce"):
        batches_hi = _batch_secrets(hi, plan)  # (C, nb, k)
        batches_lo = _batch_secrets(lo, plan)
        dev = batches_lo.device
        sums_lo = [exact_sum_narrow_u32(batches_lo), exact_sum_narrow_u32(rand_lo.to(dev))]
        sums_hi = [exact_sum_narrow_u32(batches_hi), exact_sum_narrow_u32(rand_hi.to(dev))]
        return torch.stack([torch.cat(sums_lo, dim=-1), torch.cat(sums_hi, dim=-1)])


def value_limb_sums_chunk(secrets: torch.Tensor, generator, plan: AggregationPlan, draw=None) -> torch.Tensor:
    """One streaming chunk of the sum-first hot loop.

    ``(C, dim)`` canonical secrets -> ``(L, nb, K)`` int64 exact integer
    limb sums over the chunk's participants of the value rows ``[batched
    secrets | fresh randomness]`` (the rows ``engine.share_participants``
    shares). ``L`` is ``limb_count_sum(p)``. Accumulate chunks with plain
    ``+`` while the total stays below ``MAX_PARTICIPANTS``. ``draw(generator,
    shape, p)`` overrides the randomness (default: the engine's device
    draw, so this matches ``share_participants`` for the same generator
    state).
    """
    p = plan.modulus
    C, nb = secrets.shape[0], -(-secrets.shape[1] // plan.input_size)
    if draw is None:
        draw = _device_randomness

    # narrow path (p <= 2^31, chunk <= 2^15): the big tensors stay in int32
    # lanes and only the tiny (nb, cols) result widens
    narrow = limb_count_sum(p) == 1 and C <= MAX_NARROW_CHUNK

    def limb_sums(x):  # (C, nb, cols) -> (L, nb, cols) exact integer sums
        if narrow:
            return exact_sum_narrow(x)[None]
        x = x.to(torch.int64)
        if limb_count_sum(p) == 1:
            return torch.sum(x, dim=0)[None]
        return torch.stack([torch.sum(x & 0xFFFFFFFF, dim=0), torch.sum(x >> 32, dim=0)])

    with device_span("sumfirst.draw"):
        randomness = draw(generator, (C, nb, plan.rand_size), p)
    with device_span("sumfirst.reduce"):
        batches = _batch_secrets(secrets, plan)  # (C, nb, k)
        randomness = randomness.to(batches.device)
        return torch.cat([limb_sums(batches), limb_sums(randomness)], dim=-1)


def _host(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    with sync("sumfirst_host"):
        return x.cpu().numpy()


def exact_value_sums(limb_acc) -> np.ndarray:
    """``(L, B, K)`` int64 limb accumulator -> ``(B, K)`` exact integer
    participant sums (object dtype, python ints, no modulus applied)."""
    acc = np.asarray(_host(limb_acc), dtype=object)
    out = np.zeros(acc.shape[1:], dtype=object)
    for w in range(acc.shape[0]):
        out = out + acc[w] * (1 << (32 * w))
    return out


def clerk_sums_from_limb_acc(limb_acc, plan: AggregationPlan, exact=None):
    """Host epilogue: ``(L, B, K)`` int64 limb accumulator -> ``(clerk_sums,
    value_sums)``: the ``(n, B)`` int64 canonical per-clerk share sums
    (what per-participant sharing + clerk-combine gives) and the ``(B, K)``
    canonical participant sums, whose first ``k`` columns are the plain
    batched secret sums (the free verification handle). Pass a precomputed
    ``exact_value_sums(limb_acc)`` as ``exact`` to reuse it."""
    p = plan.modulus
    if plan.share_matrix is None:
        raise ValueError("sum-first epilogue requires a packed share matrix")
    with device_span("sumfirst.clerk_sums"):
        if exact is None:
            exact = exact_value_sums(limb_acc)
        vsum = exact % p  # exact sums >= 0: % is the canonical remainder
        S_T = plan.share_matrix.T.cpu().numpy().astype(np.int64)  # (K, n)
        clerk = modmatmul_np(vsum, S_T, p)  # (B, n) in (-p, p)
        clerk = np.where(clerk < 0, clerk + p, clerk).astype(np.int64)
        return clerk.T.copy(), vsum.astype(np.int64)


def clerk_sums_sum_first(secrets, generator, plan: AggregationPlan, draw=None) -> np.ndarray:
    """Single-shot ``(P, dim)`` -> ``(n, B)`` canonical clerk sums: the
    parity twin of ``share_participants`` + ``clerk_combine_mod``."""
    if secrets.shape[0] > MAX_PARTICIPANTS:
        raise ValueError(f"chunk the input: exact bound is {MAX_PARTICIPANTS}")
    acc = value_limb_sums_chunk(secrets, generator, plan, draw)
    clerk, _ = clerk_sums_from_limb_acc(acc, plan)
    return clerk


def reconstruct_from_clerk_sums(clerk_sums, indices, scheme, dim: int) -> np.ndarray:
    """Host-exact reconstruction for any modulus width (tiny inputs)."""
    with device_span("sumfirst.reconstruct"):
        return shamir.reconstruct_clerk_sums_host(_host(clerk_sums), list(indices), scheme, dim)


def sharded_value_limb_sums(plan: AggregationPlan, mesh):
    """The sum-first hot loop over a mesh: each rank limb-sums its own
    participant shard (``value_limb_sums_chunk``), then one int64
    ``all_reduce`` over ``p`` carries only the tiny ``(L, nb, K)``
    accumulator. The exactness bound is ``MAX_PARTICIPANTS`` in total over
    the shards, checked on every call.

    Returns ``fn(secrets_local, key, draw=None) -> (L, nb_local, K)`` int64
    limb sums, replicated over ``p``, this rank's ``d``-slice of the batch
    axis (``mesh.gather_over`` assembles it); ``key`` is an integer seed or
    a generator, folded with the mesh coordinates (``fold_mesh_axes``).
    """
    validate_d_sharding(mesh, plan.dim, plan.input_size)
    p_size = axis_size(mesh, "p")

    def fn(secrets, key, draw=None):
        if secrets.shape[0] * p_size > MAX_PARTICIPANTS:
            raise ValueError(
                f"global participant count {secrets.shape[0] * p_size} exceeds the "
                f"exact limb-sum bound {MAX_PARTICIPANTS}; chunk the input"
            )
        acc = value_limb_sums_chunk(secrets, fold_mesh_axes(key, mesh), plan, draw)
        return reduce_over(acc, mesh, "p")

    return instrument_fabric(fn, "sharded_value_limb_sums", p_size)
