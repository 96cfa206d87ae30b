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


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as rank ``rank`` of a ``fake`` process group of
    ``world_size`` ranks (collectives return at once and move nothing),
    destroyed on exit. Refuses to start inside another default group."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs no default process group; one "
                           "is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
