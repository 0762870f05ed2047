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

The sharded half (``TorchAggregator(..., mesh=...)``) runs one process per
device over ``torch.distributed`` (``mesh.py``): the reference's ``psum``
is ``all_reduce`` on a mesh dim's group, its ``all_to_all`` is
``all_to_all_single`` on the ``p`` group. A fabric returns ``fn(secrets,
key, draw=None)`` over this rank's block of the participants; its result
keeps the reference's ``out_specs`` (replicated over ``p``, this rank's
``d``-slice of the batch axis), and ``mesh.gather_over`` assembles the
whole. ``key`` is an integer seed or a generator; every rank draws from
``fold_mesh_axes(key, mesh)``.

Telemetry (``sda_tpu_torch.telemetry``) records, as the reference does, the
host dispatch time of each ``secure_sum`` stage and of each fabric call in
the ``sda_engine_step_seconds`` histogram, and each fabric's nominal
collective bytes in ``sda_engine_psum_bytes_total``; ``fabric_calls()`` and
``fabric_bytes()`` read them back by fabric.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry
from ..device import resolve_device
from ..ops import shamir
from ..ops.chacha_cuda import expand_seeds_counts
from ..ops.modular import mod_sum_auto
from ..protocol import AdditiveSharing, BasicShamirSharing, PackedShamirSharing
from .limbmatmul import fold_const_limbs
from .mesh import axis_size, gather_over, mesh_device, reduce_over


STEP_SECONDS = "sda_engine_step_seconds"
PSUM_BYTES = "sda_engine_psum_bytes_total"


def _step_hist(step: str):
    return telemetry.histogram(
        STEP_SECONDS,
        "secure_sum stage / sharded-fabric invocation timing (host dispatch)",
        step=step,
    )


def _count_fabric(fabric: str, seconds: float, nbytes: int) -> None:
    """One fabric call: its host time and its nominal collective bytes."""
    _step_hist(fabric).observe(seconds)
    telemetry.counter(
        PSUM_BYTES, "nominal bytes moved per psum/all_to_all by sharded fabrics", fabric=fabric
    ).inc(nbytes)


def fabric_bytes() -> dict[str, int]:
    """Nominal collective bytes of every fabric call so far, by fabric (the
    ``sda_engine_psum_bytes_total`` series)."""
    counters = telemetry.get_registry().snapshot()["counters"]
    return {dict(labels)["fabric"]: v for (name, labels), v in counters.items() if name == PSUM_BYTES}


def fabric_calls() -> dict[str, int]:
    """Fabric calls so far, by fabric (the ``sda_engine_step_seconds``
    observations of each fabric in ``fabric_bytes``)."""
    hists = telemetry.get_registry().snapshot()["histograms"]
    return {f: hists[(STEP_SECONDS, (("step", f),))]["count"] for f in fabric_bytes()}


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
    with telemetry.device_span("engine.reconstruct"):
        device = clerk_sums.device
        if isinstance(scheme, AdditiveSharing):
            return mod_sum_auto(clerk_sums.to(torch.int64), scheme.modulus, axis=0)[:dim]
        p = scheme.prime_modulus
        indices = list(indices)
        if p >= (1 << 31):
            # wide modulus: tiny matrices, exact host interpolation
            with telemetry.sync("reconstruct_host"):
                host_sums = clerk_sums.cpu().numpy()
            host = shamir.reconstruct_clerk_sums_host(host_sums, indices, scheme, dim)
            return torch.as_tensor(np.asarray(host, dtype=np.int64), device=device)
        L = torch.as_tensor(
            shamir.reconstruction_matrix(scheme, indices), dtype=torch.int64, device=device
        )  # (k, R)
        rows = clerk_sums[torch.as_tensor(indices, device=device)].to(torch.int64)  # (R, B)
        prods = torch.fmod(L[:, :, None] * rows[None, :, :], p)
        secrets = torch.fmod(torch.sum(prods, dim=1), p)  # (k, B)
        return secrets.T.reshape(-1)[:dim]


class TorchAggregator:
    """End-to-end secure-sum engine (counterpart of ``TpuAggregator``).

    Without a ``mesh`` it is the single-device engine: ``device`` defaults
    to CUDA and raises without a GPU; pass ``device="cpu"`` to run on the
    host. With a ``mesh`` (``mesh.make_mesh``; dims ``"p"`` over
    participants, ``"d"`` over the batch axis) the sharded fabrics run on
    this rank's device of it.
    """

    def __init__(self, scheme, dim: int, device=None, use_limbs: bool = False, mesh=None):
        self.scheme = scheme
        self.dim = dim
        if mesh is not None and device is None:
            device = mesh_device(mesh)
        self.plan = make_plan(scheme, dim, device)
        self.device = self.plan.device
        self.use_limbs = use_limbs
        self.mesh = mesh

    def secure_sum(self, secrets, generator: torch.Generator, indices=None) -> torch.Tensor:
        """(P, dim) -> (dim,) aggregate, all on the plan's device. Each
        stage's host dispatch time goes to ``sda_engine_step_seconds``."""
        with telemetry.span("engine.secure_sum", dim=self.dim):
            t0 = time.perf_counter()
            secrets = torch.as_tensor(secrets, device=self.device)
            shares = share_participants(secrets, generator, self.plan, self.use_limbs)
            t1 = time.perf_counter()
            _step_hist("share").observe(t1 - t0)
            sums = clerk_combine_mod(shares, self.plan.modulus)
            t2 = time.perf_counter()
            _step_hist("combine").observe(t2 - t1)
            if indices is None:
                indices = range(self.plan.share_count)
            out = reconstruct(sums, indices, self.scheme, self.dim)
            _step_hist("reconstruct").observe(time.perf_counter() - t2)
        return out

    # -- sharded paths -------------------------------------------------------

    def sharded_clerk_sums(self):
        """Sharded share + combine: each rank shares its participant block,
        sums it locally, and the ``(n, nb_local)`` partials are summed over
        ``p``. Returns ``fn(secrets, key, draw=None) -> (n, nb_local)`` clerk
        sums in ``(-p, p)``, replicated over ``p``."""
        plan, mesh, use_limbs = self.plan, self.mesh, self.use_limbs
        modulus = plan.modulus
        _check_psum_bound(axis_size(mesh, "p"), modulus, "sharded_clerk_sums")
        validate_d_sharding(self.mesh, self.dim, self.plan.input_size)

        def fn(secrets, key, draw=None):
            gen = fold_mesh_axes(key, mesh)
            shares = share_participants(secrets, gen, plan, use_limbs, draw=draw)
            partial = clerk_combine_mod(shares, modulus)  # (n, nb_local)
            return torch.fmod(reduce_over(partial, mesh, "p"), modulus)

        return instrument_fabric(fn, "sharded_clerk_sums", axis_size(mesh, "p"))

    def sharded_clerk_sums_all_to_all(self):
        """Clerk-sharded variant: the server-side transpose as an all-to-all.

        Each rank shares its participant block, then the shares reshard from
        participant-major to clerk-major over ``p`` (``all_to_all_single``
        with the clerk axis moved to the front), and each rank sums every
        participant for its own ``n/p`` clerks. Returns ``fn(secrets, key,
        draw=None) -> (n/p, nb)`` clerk sums: this rank's slice of the clerk
        axis (``gather_over(x, mesh, "p", dim=0)`` gives all ``n``). Every
        rank of the ``p`` group must hold the same number of participants.
        """
        plan, mesh, use_limbs = self.plan, self.mesh, self.use_limbs
        modulus = plan.modulus
        p_size = axis_size(mesh, "p")
        if plan.share_count % p_size != 0:
            raise ValueError(
                f"share_count {plan.share_count} must divide over mesh axis p={p_size}"
            )
        per_rank = plan.share_count // p_size

        def fn(secrets, key, draw=None):
            gen = fold_mesh_axes(key, mesh)
            shares = share_participants(secrets, gen, plan, use_limbs, draw=draw)  # (Pl, n, nb)
            Pl, n, nb = shares.shape
            send = shares.transpose(0, 1).contiguous()  # (n, Pl, nb): clerk blocks in rank order
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=mesh.get_group("p"))
            # block s holds rank s's participants for this rank's clerks
            resharded = recv.view(p_size, per_rank, Pl, nb).transpose(1, 2)
            return clerk_combine_mod(resharded.reshape(p_size * Pl, per_rank, nb), modulus)

        return instrument_fabric(fn, "all_to_all", p_size)

    def _limb_accumulator_local_step(self, psum_axes):
        """Shared per-rank body of the limb-accumulator fabrics: fused limb
        share + combine over this rank's participants
        (``share_combine_limb_streamed``), then int64 partial sums over
        ``psum_axes`` in order (``("p",)``; hybrid: ``("p", "h")``, within a
        node before across nodes)."""
        plan, mesh = self.plan, self.mesh

        def local_step(secrets, key, draw=None):
            acc = share_combine_limb_streamed(secrets, fold_mesh_axes(key, mesh), plan, draw)
            for ax in psum_axes:
                acc = reduce_over(acc, mesh, ax)
            return acc

        return local_step

    def sharded_limb_accumulators(self):
        """Limb-accumulator fabric, any modulus width: each rank's fused limb
        share + combine, int64 ``(W, nb_local, n)`` partials summed over
        ``p``; the exact mod-p recombine runs once on the host
        (``limbmatmul.limb_recombine_host(acc, p).T``, then ``reconstruct``).
        Partials stay below ``C_local * L * K * 127^2`` per rank, so int64 is
        exact to ~5e12 participants in total. Returns ``fn(secrets, key,
        draw=None)``, replicated over ``p``."""
        validate_d_sharding(self.mesh, self.dim, self.plan.input_size)
        return instrument_fabric(
            self._limb_accumulator_local_step(("p",)), "sharded_limb_accumulators",
            axis_size(self.mesh, "p"),
        )


def instrument_fabric(fn, fabric: str, p_size: int):
    """Wrap a fabric ``fn(secrets, key, draw=None)``: with telemetry on,
    observe its host time under ``step=fabric`` and add its nominal
    collective bytes (result bytes x ``p_size``) to
    ``sda_engine_psum_bytes_total{fabric=}``."""

    def instrumented(secrets, key, draw=None):
        if not telemetry.enabled():
            return fn(secrets, key, draw)
        t0 = time.perf_counter()
        out = fn(secrets, key, draw)
        _count_fabric(fabric, time.perf_counter() - t0, out.numel() * out.element_size() * p_size)
        return out

    return instrumented


#: participants per K1 launch in ``share_combine_limb_streamed``: the main
#: path's chunk; K1's int32 guard ``C*L*K*127^2 < 2^31`` allows 3,804 at the
#: bench scheme (L = 5, K = 7)
LIMB_CHUNK = 2_000


def share_combine_limb_streamed(secrets: torch.Tensor, generator, plan: AggregationPlan,
                                draw=None) -> torch.Tensor:
    """``share_combine_limb`` over any number of participants: (C, d) ->
    (W, b, n) int64. Narrow fields (p < 2^31) go through K1
    (``limb_cuda.share_combine_limb_cuda``, its plain version on a CPU
    tensor) in chunks of at most ``LIMB_CHUNK`` rows that keep its int32
    guard, accumulated in int64; each chunk draws its own randomness rows.
    Wide fields keep the torch limb dots in one pass (the kernel is
    narrow-only, like the reference's Pallas kernel)."""
    from .limb_cuda import share_combine_limb_cuda

    p = plan.modulus
    if p >= (1 << 31):
        return share_combine_limb(secrets, generator, plan, draw)
    L, LK, n = plan.limb_stacks.shape
    chunk = max(1, min(LIMB_CHUNK, ((1 << 31) - 1) // (LK * 127 * 127)))
    C, d = secrets.shape
    with telemetry.device_span("engine.share_combine"):
        acc = torch.zeros((L, -(-d // plan.input_size), n), dtype=torch.int64, device=secrets.device)
        for start in range(0, C, chunk):
            acc += share_combine_limb_cuda(secrets[start : start + chunk], generator, plan, draw=draw)
        return acc


def masked_sum(secrets: torch.Tensor, seed_words: torch.Tensor, modulus: int, mesh) -> torch.Tensor:
    """The participant side of a ChaCha-masked round over ``mesh``: this
    rank's ``(P_local, dim)`` canonical secrets masked with the expansion of
    their ``(P_local, w)`` seed words (``expand_seeds_counts``: K2 on CUDA,
    one launch for the whole block), summed mod m, and the partial sums
    summed over ``p``. Returns the ``(dim,)`` masked total mod m on every
    rank; raises if any rank's seed window held fewer than ``dim`` accepted
    draws (about once in 1e9 rows). Counted as the fabric ``masked_sum``."""
    t0 = time.perf_counter()
    dim = secrets.shape[1]
    masks, counts = expand_seeds_counts(seed_words, dim, modulus)
    total = torch.remainder(torch.sum(torch.remainder(secrets + masks, modulus), dim=0), modulus)
    total = torch.remainder(reduce_over(total, mesh, "p"), modulus)
    dry = reduce_over((counts.min() < dim).to(torch.int64).reshape(1), mesh, "p")
    if int(dry) != 0:
        raise RuntimeError("a seed window held fewer than dim accepted draws")
    if telemetry.enabled():
        _count_fabric("masked_sum", time.perf_counter() - t0,
                      (total.numel() + 1) * total.element_size() * axis_size(mesh, "p"))
    return total


def _check_psum_bound(size: int, modulus: int, where: str) -> None:
    """A sum of ``size`` reduced partials (each in (-m, m)) in int64 wraps
    past ``size*(m-1) < 2^63``. Wide moduli must use the limb-accumulator
    fabrics, which sum small exact int64 accumulators and recombine mod p
    once on the host."""
    if size * (modulus - 1) >= 2**63:
        raise ValueError(
            f"{where}: psum of {size} partials overflows int64 at "
            f"modulus {modulus}; use sharded_limb_accumulators / "
            "hierarchical_limb_accumulators for wide moduli"
        )


def validate_d_sharding(mesh, dim: int, input_size: int) -> None:
    """With a sharded dim axis every d-shard zero-pads its own tail batch, so
    a dim that does not divide over ``input_size * d`` would misalign batch
    boundaries and reconstruct a wrong aggregate: raise. One rule for every
    fabric (engine, multihost, sumfirst)."""
    d_size = axis_size(mesh, "d")
    if d_size > 1 and dim % (input_size * d_size) != 0:
        raise ValueError(
            f"dim {dim} must divide over input_size {input_size} x d={d_size} "
            "so every d-shard holds whole batches"
        )


def fold_mesh_axes(key, mesh) -> torch.Generator:
    """This rank's generator: ``key`` (an integer seed, or a generator from
    which one seed is drawn) mixed with every mesh coordinate through
    numpy's ``SeedSequence``, on the rank's device.

    Folding only one axis would hand ranks that differ on another axis the
    same stream: with ``d`` sharded, two d-shards of one participant row
    would draw identical share randomness for different dim slices, and a
    clerk's shares subtracted across shards would cancel it, a zero-privacy
    failure. The coordinates are hashed together with the seed, not added
    to it, so no two coordinates share a stream (with a sum, ``(seed, 1,
    0)`` and ``(seed, 0, 1)`` would). Every sharded path derives its
    randomness here.
    """
    if isinstance(key, torch.Generator):
        key = int(torch.randint(0, 1 << 62, (1,), generator=key, device=key.device))
    coords = [int(c) for c in mesh.get_coordinate()]
    words = np.random.SeedSequence([int(key), *coords]).generate_state(2, np.uint32)
    gen = torch.Generator(device=mesh_device(mesh))
    gen.manual_seed(int(words[0]) | (int(words[1]) << 32))
    return gen


def verified_step(agg: TorchAggregator, sums_fn):
    """Round with a verification handle: ``fn(secrets, key, draw=None) ->
    (aggregate, plain)``, both ``(dim,)`` on every rank: the reconstruction
    from ``sums_fn``'s clerk sums (gathered over ``d``) and an independent
    plaintext sum of the same secrets mod p. Shared by the single-mesh and
    the hybrid (``multihost.py``) fabrics."""
    mesh, plan = agg.mesh, agg.plan
    p = plan.modulus
    axes = [ax for ax in ("p", "h") if ax in mesh.mesh_dim_names]  # participant dims
    for ax in axes:
        _check_psum_bound(axis_size(mesh, ax), p, f"verified_step({ax})")

    def step(secrets, key, draw=None):
        sums = gather_over(sums_fn(secrets, key, draw), mesh, "d", dim=1)
        out = reconstruct(sums, range(plan.share_count), agg.scheme, agg.dim)
        plain = mod_sum_auto(secrets, p, axis=0)
        for ax in axes:
            plain = torch.fmod(reduce_over(plain, mesh, ax), p)
        return out, gather_over(plain, mesh, "d", dim=0)

    return step


def full_training_step(scheme, dim: int, mesh):
    """One full secure-aggregation round over the mesh: sharded share +
    clerk-combine, then reconstruct + verify (``verified_step``). Returns
    ``(agg, step)``."""
    agg = TorchAggregator(scheme, dim, mesh=mesh)
    return agg, verified_step(agg, agg.sharded_clerk_sums())
