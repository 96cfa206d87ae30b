"""Mesh construction. Counterpart of ``repro.launch.mesh``.

Targets, as in JAX: 8 chips per node;
  * single-pod — (16, 16)    = 256 chips, axes ("data", "model")
  * multi-pod  — (2, 16, 16) = 512 chips, axes ("pod", "data", "model")

``make_production_mesh`` returns a ``parallel.sharding.MeshShape``, the
axis names and sizes, which the placement rules take as they are; the AFD
dry-run runs one rank of it and starts no process group.

``device_mesh`` builds a ``DeviceMesh`` with the same axis names over the
default process group: gloo or NCCL for a real run, or the ``fake``
backend of ``fake_world`` (one process standing for rank 0 of 256 or 512,
whose collectives move nothing) for the multi-pod dry-run's pricing.
The fake group stands for the accelerators' (NCCL's), so inside
``fake_world`` DTensor moves a split from one tensor dim to another with
one all-to-all, as it does on NCCL, where on a CPU mesh (gloo has no
all-to-all) it would all-gather the whole dim and chunk it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

from repro_torch.parallel.sharding import MeshShape, axis_sizes

CHIPS_PER_NODE = 8


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> MeshShape:
    return MeshShape(tuple(axes), tuple(shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def nodes_in_mesh(mesh) -> int:
    return math.prod(axis_sizes(mesh).values()) // CHIPS_PER_NODE


def device_mesh(mesh: MeshShape, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``mesh``'s axis names and sizes over the default
    process group, whose world size must be their product."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(mesh.shape),
                            mesh_dim_names=tuple(mesh.mesh_dim_names))


def _all_to_all_move(input, gather_dim: int, shard_dim: int, mesh,
                     mesh_dim: int):
    """DTensor's move of a split from ``gather_dim`` to ``shard_dim`` over
    one mesh dim as NCCL makes it: ``shard_dim``'s n chunks, one to each
    rank, in one all-to-all, and the n received blocks joined along
    ``gather_dim``."""
    import torch
    from torch.distributed import _functional_collectives as funcol
    n = mesh.size(mesh_dim)
    x = torch.stack(input.chunk(n, dim=shard_dim)).contiguous()
    out = funcol.all_to_all_single(x, None, None, (mesh, mesh_dim))
    if isinstance(out, funcol.AsyncCollectiveTensor):
        out = out.wait()
    return torch.cat(out.unbind(0), dim=gather_dim).contiguous()


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as rank ``rank`` of a ``fake`` process group of
    ``world_size`` ranks (collectives return at once and move nothing),
    destroyed on exit, with DTensor's split moves made by all-to-all (see
    the module's docstring). Refuses to start inside another default
    group."""
    import torch.distributed as dist
    from torch.distributed.tensor import placement_types
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs no default process group; one "
                           "is already initialized")
    move = placement_types.shard_dim_alltoall

    def moved(input, gather_dim, shard_dim, mesh, mesh_dim):
        if input.shape[shard_dim] % mesh.size(mesh_dim):
            return move(input, gather_dim, shard_dim, mesh, mesh_dim)
        return _all_to_all_move(input, gather_dim, shard_dim, mesh, mesh_dim)

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    placement_types.shard_dim_alltoall = moved
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = move
        dist.destroy_process_group()
