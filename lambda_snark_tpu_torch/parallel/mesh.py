"""Device meshes over a ``torch.distributed`` world.

The counterpart of the JAX package's ``parallel/mesh.py`` (``make_mesh``,
``ring_mesh``, ``shard_planes`` at :20-45). JAX runs one controller that
sees every device; here every rank is a process of its own (one per card
under NCCL; CPU ranks, or several ranks sharing one card, under gloo), the
world is initialised first (``parallel.multihost``), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over all of it: proof
batches shard over "dp", polynomial and ring coefficients over "sp".

A mesh spans the whole world: in a multi-controller program a rank outside
the mesh would have no work and would still have to join its groups, so a
mesh smaller than the world raises where JAX takes the first devices.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str] = ("dp", "sp"),
              device="cuda", devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh of the given shape over the initialised world (ranks in
    row-major order, the last axis fastest) on ``device``'s type.
    ``devices``, the JAX package's keyword, lists what the mesh is laid
    over, of which it takes the first ones: here the world's ranks, which
    must come in order, since each group of a torch ``DeviceMesh`` orders
    its members by rank."""
    dev = resolve(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize_multihost "
                           "(or run under parallel.multihost.spawn_local) first")
    total = math.prod(axis_sizes)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if total > len(ranks):
        raise ValueError(f"need {total} ranks, have {len(ranks)}")
    if total < world:
        raise ValueError(f"a mesh of {total} ranks must span the world of {world}")
    if ranks[:total] != list(range(world)):
        raise ValueError(f"devices {ranks[:total]} must be the world's ranks in order, "
                         f"0 to {world - 1}")
    return init_device_mesh(dev.type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def ring_mesh(n: Optional[int] = None, name: str = "sp", device="cuda",
              n_devices: Optional[int] = None) -> DeviceMesh:
    """1-D mesh over the ring/coefficient axis of ``n`` ranks (or
    ``n_devices``, the JAX package's keyword; the whole world by default)."""
    resolve(device)
    if n is not None and n_devices is not None and n != n_devices:
        raise ValueError(f"n={n} and n_devices={n_devices} disagree")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize_multihost "
                           "(or run under parallel.multihost.spawn_local) first")
    return make_mesh([n or n_devices or dist.get_world_size()], [name], device)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, split evenly over mesh
    axis ``axis`` (the place of JAX's ``shard_planes`` sharding spec)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over {n} ranks")
    return x.chunk(n, dim)[mesh.get_local_rank(axis)]
