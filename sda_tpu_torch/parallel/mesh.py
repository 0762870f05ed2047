"""Device meshes over ``torch.distributed`` (counterpart of
``sda_tpu/parallel/mesh.py``).

One process per device: a mesh is a ``DeviceMesh`` over the process group
that is already running (``multihost.initialize_distributed``), with named
dims. ``p`` shards participants (the "many phones" axis), ``d`` shards the
dim/batch axis; the hybrid mesh of ``multihost.py`` adds ``h`` (nodes) in
front. The backend follows the device: NCCL for CUDA, gloo for the CPU.

Where the reference places a global array over the mesh (``device_put``
with a ``NamedSharding``), each rank here takes its own block of it by its
mesh coordinate (``shard_participants``); where a reference fabric's result
is sharded, each rank holds its shard and ``gather_over`` assembles the
whole for the host epilogue. Every mesh covers every rank of the group, laid
out in rank order (``arange(world).reshape(shape)``), so a dim group's rank
order is its coordinate order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def build_mesh(shape, names, device=None):
    """``DeviceMesh`` of ``shape`` with dims ``names`` over every rank of the
    running process group, on ``device``'s type (CUDA unless the caller
    asks for the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize_distributed first")
    world = dist.get_world_size()
    need = int(np.prod(shape))
    if need != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {need} ranks, the group has {world}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_mesh(p_size: int | None = None, d_size: int = 1, device=None):
    """Mesh with dims ``("p", "d")`` over every rank of the running group;
    ``p_size`` defaults to world size // ``d_size``."""
    device = resolve_device(device)
    if p_size is None:
        p_size = dist.get_world_size() // d_size
    return build_mesh((p_size, d_size), ("p", "d"), device)


def axis_size(mesh, name: str) -> int:
    """Size of mesh dim ``name``; 1 for a dim the mesh does not have."""
    if name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def coordinate(mesh, name: str) -> int:
    """This rank's index on mesh dim ``name``; 0 for a dim it does not have."""
    if name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)


def mesh_device(mesh) -> torch.device:
    """The torch device this rank computes on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_block(array, mesh, row_axes, col_axis: str | None = "d") -> torch.Tensor:
    """This rank's block of a global ``(P, dim)`` host or device array: rows
    split over the composed ``row_axes`` (major first), columns over
    ``col_axis``; on the mesh's device. Both splits must be even."""
    P, d = array.shape
    rows = int(np.prod([axis_size(mesh, a) for a in row_axes]))
    row = 0
    for a in row_axes:
        row = row * axis_size(mesh, a) + coordinate(mesh, a)
    cols = axis_size(mesh, col_axis) if col_axis else 1
    col = coordinate(mesh, col_axis) if col_axis else 0
    if P % rows or d % cols:
        raise ValueError(f"({P}, {d}) does not split evenly over {rows} x {cols} ranks")
    r, c = P // rows, d // cols
    block = array[row * r : (row + 1) * r, col * c : (col + 1) * c]
    if not isinstance(block, torch.Tensor):
        block = torch.as_tensor(np.ascontiguousarray(block))
    return block.to(mesh_device(mesh)).contiguous()


def shard_participants(array, mesh) -> torch.Tensor:
    """This rank's ``(P/p, dim/d)`` block of a ``(P, dim)`` array."""
    return shard_block(array, mesh, ("p",))


def reduce_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over mesh dim ``axis`` (``psum``), on every rank of it.
    The collective runs even on a dim of size 1, so a one-rank mesh still
    goes through the backend."""
    x = x.contiguous()
    if axis in mesh.mesh_dim_names:
        dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def gather_over(x: torch.Tensor, mesh, axis: str = "d", dim: int = 1) -> torch.Tensor:
    """Concatenate every rank's ``x`` along tensor dim ``dim`` in mesh dim
    ``axis``'s coordinate order: a fabric's ``axis``-sharded result as the
    whole, for the host epilogue."""
    if axis not in mesh.mesh_dim_names:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)
