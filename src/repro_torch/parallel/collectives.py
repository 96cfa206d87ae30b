"""Distributed collectives on ``torch.distributed``. Counterpart of
``repro.parallel.collectives``.

The centerpiece is split-KV decode attention: the KV cache's sequence dim
is sharded over a mesh axis, every rank runs the split-KV kernel over its
slice, and the partials are combined with a log-sum-exp weighted sum
across the axis.

The differentiable collectives below (``all_to_all``, ``all_reduce_sum``,
``all_gather_tiled``) follow ``torch.distributed.nn``'s convention: the
objective is the sum of the ranks' losses, so the backward of an
all-gather is a reduce-scatter (here an all-reduce and this rank's
slice), of a sum an all-reduce, and of an all-to-all the reverse
all-to-all. The port keeps its own: the library's all-gather backward
fails on a subgroup that does not hold global rank 0.

``spmd_map`` runs such a rank-local function on DTensors (``local_map``)
and reconciles the two conventions: an output replicated over n ranks
has its gradient divided by n before the local backward, and an input
replicated over an axis gets its gradient as a partial sum over that
axis, so the local gradients become DTensor's gradients of the one loss.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import axis_sizes


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


class _ScaleGrad(torch.autograd.Function):
    """Identity whose gradient is scaled and made contiguous: a local
    gradient leaves ``local_map`` as a DTensor's local block, whose views
    assume a contiguous layout."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad * ctx.scale).contiguous(), None


def spmd_map(fn, mesh, in_placements, out_placements):
    """``local_map(fn)`` for a rank-local ``fn`` written with the port's
    differentiable collectives (see the module's docstring). Inputs are
    redistributed to ``in_placements``; each output's gradient is divided
    by the number of ranks it is replicated over, and each input's
    gradient is partial over the axes it is replicated over."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    sizes = [int(n) for n in mesh.shape]

    def replicas(pl) -> int:
        return math.prod(n for p, n in zip(pl, sizes)
                         if isinstance(p, Replicate))

    def body(*args):
        args = [_ScaleGrad.apply(a, 1.0) if isinstance(a, torch.Tensor)
                and a.requires_grad else a for a in args]
        outs = fn(*args)
        return tuple(_ScaleGrad.apply(o, 1.0 / replicas(pl))
                     if o.requires_grad else o
                     for o, pl in zip(outs, out_placements))

    grad_pl = tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) else p for p in pl)
        for pl in in_placements)
    return local_map(body, out_placements=tuple(out_placements),
                     in_placements=tuple(in_placements),
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_gather_tiled(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    return _AllGather.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal splits along dim 0: block j of ``x`` goes to rank j, and
    block i of the result came from rank i."""
    return _AllToAll.apply(x, group)


def splitkv_combine(out_i: torch.Tensor, lse_i: torch.Tensor,
                    group) -> torch.Tensor:
    """Combine per-shard attention partials across ``group``.

    out_i: (B, Hq, d) shard-local normalised outputs;
    lse_i: (B, Hq) shard-local log-sum-exp. Dead shards (no valid keys)
    carry lse ≈ -1e30 and vanish under the max-shifted weighting.
    """
    m = lse_i.float().clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse_i.float() - m)[..., None]                # (B, Hq, 1)
    num = all_reduce_sum(out_i.float() * w, group)
    den = all_reduce_sum(w, group)
    return (num / den).to(out_i.dtype)


def splitkv_specs(mesh, axis: str, batch: int) -> Dict[str, tuple]:
    """Placement of ``splitkv_decode_attention``'s operands: the cache's T
    over ``axis``, the batch over the other axes when it divides by
    them (else replicated), as JAX's ``in_specs``."""
    other = tuple(a for a in mesh.mesh_dim_names if a != axis)
    sizes = axis_sizes(mesh)
    dp = 1
    for a in other:
        dp *= sizes[a]
    b = None
    if other and batch % dp == 0:
        b = other if len(other) > 1 else other[0]
    return {"q": (b, None, None), "kv": (b, axis, None, None),
            "pos": (b,), "out": (b, None, None)}


def splitkv_decode_attention(q: torch.Tensor, k_local: torch.Tensor,
                             v_local: torch.Tensor, pos: torch.Tensor, mesh,
                             axis: str = "model",
                             impl: Optional[str] = None) -> torch.Tensor:
    """Decode attention with the cache sequence dim sharded over ``axis``.

    Every operand is this rank's block under ``splitkv_specs``:
    q (B_l, Hq, d); k_local, v_local (B_l, T / n, Hkv, d), this rank's T
    slice; pos (B_l,) current positions (valid keys = [0, pos]).
    Returns (B_l, Hq, d), replicated over ``axis``.
    """
    t_local = k_local.shape[1]
    start = mesh.get_local_rank(axis) * t_local
    lengths = (pos + 1 - start).clamp(0, t_local).to(torch.int32)
    out, lse = kops.splitkv_attention(q, k_local, v_local, lengths,
                                      impl=impl, return_lse=True)
    return splitkv_combine(out, lse, mesh.get_group(axis))


def ring_all_gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather along dim 0 (tiled), as the JAX package's helper of
    this name."""
    return all_gather_tiled(x, group, 0)
