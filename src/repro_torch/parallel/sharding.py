"""Logical-axis → mesh placement rules. Counterpart of
``repro.parallel.sharding``.

A placement ("spec") is a tuple with one entry per tensor dim: ``None``
(replicated), a mesh-axis name, or a tuple of names (the dim split over
those axes, the first one major). It stands in for JAX's
``PartitionSpec``. The rules need only a mesh's axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` serves, and so does
``MeshShape``, which needs no process group.

Parallelism strategy, as in the JAX package:
  * batch  → ("pod", "data")   — DP over pods and the data axis
  * TP     → "model"           — attention q-heads, FFN hidden, vocab,
                                 MoE expert dim (EP lives on "model")
  * FSDP   → "data"            — parameter second-dim sharding
  * kv_seq → "model"           — split-KV decode (cache seq dim sharded)

Dims that do not divide by their mesh axes stay replicated.

The port's parameter and cache trees hold one entry per layer (no scanned
``stack`` axis, ``bridge.unstack_layers``), so a leaf's spec here is the
JAX leaf's without its leading ``stack`` entry (``None`` in every rule
set). ``local_block`` cuts this rank's block of a full tensor and
``gather_block`` puts the full tensor back together from the blocks.

``install`` / ``activate`` route the model's activation hints
(``models.common.shard``) into a constraint, as JAX's route them into
``jax.lax.with_sharding_constraint``: a DTensor whose rank equals the
number of logical axes is redistributed to the placement the rules give
it (a dim that does not divide stays replicated); any other tensor, and
every plain tensor, passes unchanged. A constraint changes no value,
only where the value lives and so which collectives the program runs.
The caller installs the rules around a program, as JAX's dry-runs do.

On a ``DeviceMesh`` a spec becomes DTensor placements (``placements``,
one per mesh dim: ``Shard(d)`` on each axis that splits tensor dim d,
``Replicate()`` elsewhere), and ``distribute`` / ``distribute_tree`` turn
full tensors into DTensors holding this rank's block: the port's
counterpart of ``NamedSharding`` and of ``jit``'s ``in_shardings``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models import common as mcommon

Spec = Tuple[object, ...]               # one entry per tensor dim


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Maps logical axis names to mesh axis names (or tuples thereof)."""
    batch: object = ("pod", "data")
    seq: object = None
    embed: object = None
    heads: object = "model"
    kv_heads: object = "model"
    kv_seq: object = None           # "model" enables split-KV decode layout
    mlp: object = "model"
    experts: object = "model"
    vocab: object = "model"
    fsdp: object = "data"           # None disables FSDP (small archs)
    moe_fsdp: object = "data"       # expert-weight FSDP (None = weight-
                                    # stationary serving)
    stack: object = None

    def get(self, name: Optional[str]):
        if name is None:
            return None
        return getattr(self, name)


TRAIN_RULES = MeshRules()
SERVE_RULES = MeshRules(kv_seq="model")
SERVE_RULES_NO_SPLITKV = MeshRules(kv_seq=None)
# sequence-parallel activations between blocks
TRAIN_RULES_SP = MeshRules(seq="model")
# weight-stationary serving: expert weights replicated over "data"
SERVE_RULES_WS = MeshRules(kv_seq="model", moe_fsdp=None)
SERVE_RULES_SP = MeshRules(kv_seq="model", seq="model")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process group:
    all the placement rules read."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _present_axes(mesh, spec_entry) -> Optional[object]:
    """Filter a rules entry down to axes that exist on this mesh."""
    if spec_entry is None:
        return None
    entries = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    present = tuple(a for a in entries if a in mesh.mesh_dim_names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(entry))


def logical_to_spec(mesh, rules: MeshRules, logical: Sequence,
                    shape: Sequence[int]) -> Spec:
    """Build a spec, dropping assignments that do not divide or that reuse
    a mesh axis."""
    out = []
    used = set()
    for dim, name in zip(shape, logical):
        entry = _present_axes(mesh, rules.get(name))
        if entry is None:
            out.append(None)
            continue
        flat = _axes(entry)
        if any(a in used for a in flat) or dim % _axis_size(mesh, entry):
            out.append(None)
            continue
        used.update(flat)
        out.append(entry)
    return tuple(out)


def install(mesh, rules: MeshRules) -> None:
    """Route ``models.common.shard`` through a DTensor redistribute on
    ``mesh`` under ``rules`` (see the module's docstring)."""
    from torch.distributed.tensor import DTensor

    def constrain(x, logical):
        if not isinstance(x, DTensor) or x.ndim != len(logical):
            return x
        pl = placements(logical_to_spec(mesh, rules, logical, x.shape), mesh)
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)

    mcommon.set_constraint_fn(constrain)


def uninstall() -> None:
    mcommon.reset_constraint_fn()


class activate:
    """Context manager: ``install(mesh, rules)`` for the duration; the
    hook is uninstalled on the way out, also when the body raises."""

    def __init__(self, mesh, rules: MeshRules):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        install(self.mesh, self.rules)
        return self

    def __exit__(self, *exc):
        uninstall()
        return False


# ---------------------------------------------------------------------------
# Parameter, batch and cache placement (path-based)
# ---------------------------------------------------------------------------

# (regex over the "/"-joined path, logical axes per dim)
_PARAM_RULES = [
    (r"embed/tok$",        ("vocab", "embed")),
    (r"embed/pos$",        (None, "embed")),
    (r"enc\.pos|encoder/pos$", (None, "embed")),
    (r"lm_head/w$",        ("fsdp", "vocab")),
    (r"attn/wq$|cross/wq$", ("fsdp", "heads")),
    (r"attn/wk$|cross/wk$", ("fsdp", "kv_heads")),
    (r"attn/wv$|cross/wv$", ("fsdp", "kv_heads")),
    (r"attn/wo$|cross/wo$", ("heads", "fsdp")),
    (r"attn/b[qkv]$|cross/b[qkv]$", (None,)),
    (r"mlp/wi$|shared/wi$", ("fsdp", "mlp")),
    (r"mlp/wo$|shared/wo$", ("mlp", "fsdp")),
    (r"mlp/b[io]$|shared/b[io]$", (None,)),
    (r"moe/router$",       (None, None)),
    (r"moe/wi$",           ("experts", "moe_fsdp", None)),
    (r"moe/wo$",           ("experts", None, "moe_fsdp")),
    (r"mamba/in_proj$",    ("fsdp", None)),
    (r"mamba/out_proj$",   (None, "fsdp")),
    (r"mamba/conv_w$",     (None, None)),
]


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the dicts, lists and tuples of ``tree``;
    the path joins dict keys and list indices with "/"."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_spec(path: str, leaf: torch.Tensor, mesh,
               rules: MeshRules) -> Spec:
    for pat, logical in _PARAM_RULES:
        if re.search(pat, path):
            if leaf.ndim != len(logical):
                return (None,) * leaf.ndim
            return logical_to_spec(mesh, rules, logical, leaf.shape)
    # norms, scalars, A_log, dt_bias, ... → replicated
    return (None,) * leaf.ndim


def params_shardings(params, mesh, rules: MeshRules):
    """The spec tree matching ``params``."""
    return map_with_path(
        lambda path, leaf: param_spec(path, leaf, mesh, rules), params)


def batch_shardings(batch, mesh, rules: MeshRules):
    """Input batches shard on the leading (batch) dim only."""
    return map_with_path(
        lambda _, leaf: logical_to_spec(
            mesh, rules, ("batch",) + (None,) * (leaf.ndim - 1), leaf.shape),
        batch)


def cache_shardings(cache, mesh, rules: MeshRules, cfg=None):
    """KV/SSM cache placement: batch on dim 0, ``kv_seq`` on the
    attention cache's sequence dim. ``cfg`` is unused, as in JAX."""

    def spec_for(path, leaf):
        if leaf is None:                # a Mamba layer's cross_kv slot
            return None
        ndim = leaf.ndim
        if path.endswith("pos"):
            return (None,) * ndim
        if re.search(r"/k$|/v$", path):
            logical = ("batch", "kv_seq", "kv_heads", None)
        elif path.endswith("conv"):
            logical = ("batch", None, None)
        elif path.endswith("state"):
            logical = ("batch", "heads", None, None)
        else:
            logical = ("batch",) + (None,) * (ndim - 1)
        logical = (logical[:ndim] if ndim < len(logical)
                   else logical + (None,) * (ndim - len(logical)))
        return logical_to_spec(mesh, rules, logical, leaf.shape)

    return map_with_path(spec_for, cache)


# ---------------------------------------------------------------------------
# Blocks of a tensor on this rank
# ---------------------------------------------------------------------------

def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's index along each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_block(t: torch.Tensor, spec: Spec, mesh,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a view).
    ``coords`` (axis → index) default to the calling rank's on a
    ``DeviceMesh``; give them to cut another rank's block."""
    coords = mesh_coords(mesh) if coords is None else coords
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = 0, 1
        for a in _axes(entry):
            idx, n = idx * sizes[a] + coords[a], n * sizes[a]
        step = t.shape[dim] // n
        t = t.narrow(dim, idx * step, step)
    return t


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh axis that splits tensor dim d, ``Replicate()`` on the others. A
    dim split over two axes is split over both in mesh order, the first
    major, as the spec says; a spec that lists them in another order has
    no placement and raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} splits dim {dim} over mesh "
                             f"axes out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def distribute(t: torch.Tensor, spec: Spec, mesh):
    """The DTensor of the full tensor ``t`` under ``spec``: a copy of this
    rank's block (``local_block``) with ``placements(spec, mesh)``. No
    communication: every rank is taken to hold the same ``t``."""
    from torch.distributed.tensor import DTensor
    # a copy of the block: the rank holds its block, not a view of t
    return DTensor.from_local(local_block(t, spec, mesh).clone(
        memory_format=torch.contiguous_format), mesh, placements(spec, mesh),
        run_check=False, shape=t.shape, stride=t.stride())


def distribute_tree(tree, specs, mesh):
    """``distribute`` over a tree of tensors and its matching spec tree."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [distribute_tree(v, s, mesh) for v, s in zip(tree, specs)]
    if tree is None:
        return None
    return distribute(tree, tuple(specs), mesh)


def block_bytes(tree, specs, mesh) -> int:
    """Bytes of this rank's blocks of every tensor of ``tree`` under
    ``specs`` (shapes only: ``tree`` may hold meta tensors)."""
    if isinstance(tree, dict):
        return sum(block_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(block_bytes(v, s, mesh) for v, s in zip(tree, specs))
    if tree is None:
        return 0
    sizes = axis_sizes(mesh)
    n = tree.numel()
    for entry in specs:
        if entry is not None:
            n //= math.prod(sizes[a] for a in _axes(entry))
    return n * tree.element_size()


def gather_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's ``local_block`` (all-gathers over
    each sharded dim's axes, minor axis first)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in reversed(_axes(entry)):
            group = mesh.get_group(a)
            parts = [torch.empty_like(t)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=dim)
    return t
