"""Mesh construction. Counterpart of ``repro.launch.mesh``.

Targets, as in JAX: 8 chips per node;
  * single-pod — (16, 16)    = 256 chips, axes ("data", "model")
  * multi-pod  — (2, 16, 16) = 512 chips, axes ("pod", "data", "model")

A mesh here is a ``parallel.sharding.MeshShape``, the axis names and
sizes, which the placement rules take as they are. The dry-run runs one
rank of it; it starts no process group.
"""

from __future__ import annotations

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
