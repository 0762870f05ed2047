"""Multi-node distribution: hybrid meshes and hierarchical sums over
``torch.distributed`` (counterpart of ``sda_tpu/parallel/multihost.py``).

Topology: axis ``h`` counts nodes (the slow network between hosts), ``p``
the devices of a node (participants), ``d`` the dim/batch axis. Each
device shares and combines its own participants; the sum runs over ``p``
first (within a node), is reduced mod p, and only then crosses nodes over
``h``, so the cross-node traffic is the tiny ``(n, nb)`` partials,
whatever each node's participant count.

One process per device: ``initialize_distributed`` joins the process group
(NCCL for CUDA, gloo for the CPU) and pins the rank's card;
``spawn_ranks`` starts ``world_size`` such processes on one host, which is
how the CPU tests and ``entry.dryrun_multichip`` run the fabrics.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import axis_size, build_mesh, reduce_over, shard_block


def _local_world_size(world_size: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def initialize_distributed(init_method: str, world_size: int, rank: int, device=None) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` and return this
    rank's device. The backend follows the device (CUDA unless the caller
    asks for the CPU): NCCL, with the rank pinned to card ``LOCAL_RANK``
    (default ``rank`` modulo the node's ``LOCAL_WORLD_SIZE``), or gloo. A
    CUDA request with fewer cards than the node's ranks raises, and so does
    a failed init."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local_world = _local_world_size(world_size)
        cards = torch.cuda.device_count()
        if cards < local_world:
            raise RuntimeError(f"{local_world} ranks on this node need {local_world} cards, found {cards}")
        local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method, world_size=world_size, rank=rank,
    )
    return dev


def make_hybrid_mesh(h_size: int | None = None, p_size: int | None = None, d_size: int = 1,
                     device=None):
    """Mesh with dims ``("h", "p", "d")``: nodes x devices per node
    (participants) x dim batches, over every rank of the running group.

    With several nodes (world size over ``LOCAL_WORLD_SIZE`` > 1) ``h`` is
    the node count, ranks being numbered node-major as launchers number
    them; an explicit ``h_size`` is then only a cross-check, and one that
    miscounts the nodes raises. On one node (tests, dry runs) ``h_size`` is
    free, default 2 when the world size is even.
    """
    device = resolve_device(device)
    world = dist.get_world_size()
    nodes = world // _local_world_size(world)
    if nodes > 1:
        if h_size is not None and h_size != nodes:
            raise ValueError(
                f"h_size {h_size} != {nodes} nodes: the outer mesh axis is laid out "
                f"per node here, so h_size must equal the node count ({nodes}); omit "
                "h_size to use it"
            )
        h_size = nodes
    elif h_size is None:
        h_size = 2 if world % 2 == 0 and world > 1 else 1
    p_size = p_size or world // (h_size * d_size)
    return build_mesh((h_size, p_size, d_size), ("h", "p", "d"), device)


def shard_participants_hybrid(array, mesh) -> torch.Tensor:
    """This rank's block of a ``(P, dim)`` array: participants over the
    composed ``(h, p)`` axes, dim over ``d``."""
    return shard_block(array, mesh, ("h", "p"))


def hierarchical_clerk_sums(scheme, dim: int, mesh):
    """Share + combine over a hybrid mesh with a staged reduction. Returns
    ``(agg, fn)``, ``fn(secrets, key, draw=None) -> (n, nb_local)`` clerk
    sums replicated over ``h`` and ``p``: each rank shares and combines its
    participants, the partials are summed over ``p`` and reduced mod p,
    then summed over ``h``."""
    from .engine import (
        TorchAggregator,
        _check_psum_bound,
        clerk_combine_mod,
        fold_mesh_axes,
        instrument_fabric,
        share_participants,
        validate_d_sharding,
    )

    agg = TorchAggregator(scheme, dim, mesh=mesh)
    plan = agg.plan
    modulus = plan.modulus
    validate_d_sharding(mesh, dim, agg.plan.input_size)
    _check_psum_bound(axis_size(mesh, "p"), modulus, "hierarchical_clerk_sums(p)")
    _check_psum_bound(axis_size(mesh, "h"), modulus, "hierarchical_clerk_sums(h)")

    def fn(secrets, key, draw=None):
        shares = share_participants(secrets, fold_mesh_axes(key, mesh), plan, False, draw=draw)
        partial = clerk_combine_mod(shares, modulus)
        partial = torch.fmod(reduce_over(partial, mesh, "p"), modulus)
        # across nodes: (n, nb_local) int64 per node, independent of P
        return torch.fmod(reduce_over(partial, mesh, "h"), modulus)

    return agg, instrument_fabric(fn, "hierarchical_clerk_sums", axis_size(mesh, "p") * axis_size(mesh, "h"))


def hierarchical_limb_accumulators(scheme, dim: int, mesh):
    """Limb-accumulator twin of :func:`hierarchical_clerk_sums` for any
    modulus width: each rank's fused limb share + combine (K1 for p < 2^31),
    int64 partial sums over ``p`` then ``h``; the host epilogue is
    ``limb_recombine_host(acc, p).T`` then ``reconstruct``. Returns ``(agg,
    fn)``, ``fn(secrets, key, draw=None) -> (W, nb_local, n)`` int64."""
    from .engine import TorchAggregator, instrument_fabric, validate_d_sharding

    agg = TorchAggregator(scheme, dim, mesh=mesh)
    validate_d_sharding(mesh, dim, agg.plan.input_size)
    return agg, instrument_fabric(
        agg._limb_accumulator_local_step(("p", "h")), "hierarchical_limb_accumulators",
        axis_size(mesh, "p") * axis_size(mesh, "h"),
    )


def hierarchical_secure_sum(scheme, dim: int, mesh):
    """Full round over the hybrid mesh: hierarchical share/combine,
    reconstruct, and an independent plaintext sum (``verified_step``).
    Returns ``(agg, step)``."""
    from .engine import verified_step

    agg, sums_fn = hierarchical_clerk_sums(scheme, dim, mesh)
    return agg, verified_step(agg, sums_fn)


def _rank_main(rank, fn, world_size, init_method, device, args, out_dir):
    dev = initialize_distributed(init_method, world_size, rank, device)
    if dev.type == "cpu":
        # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        result = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


#: seconds ``spawn_ranks`` waits for its ranks before it kills them all
SPAWN_TIMEOUT_S = 600.0


def spawn_ranks(fn, world_size: int, device=None, args=()) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    that form one process group on ``device``'s backend (CUDA unless the
    caller asks for the CPU), rendezvousing through a ``file://`` in a
    temporary directory (no port). ``fn`` must be importable by name (a
    module-level function). Returns each rank's result in rank order; a
    rank that raises re-raises here, and past ``SPAWN_TIMEOUT_S`` every
    rank is killed and this raises ``TimeoutError``."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} cards, found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, f"file://{tmp}/rendezvous", str(dev.type), tuple(args), tmp),
        )
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish in {SPAWN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
