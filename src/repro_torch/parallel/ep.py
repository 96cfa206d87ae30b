"""Expert-parallel MoE on ``torch.distributed`` — the paper's large-scale
EP baseline. Counterpart of ``repro.parallel.ep``.

Every rank runs the same program (SPMD) on its own blocks; the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes. Two
execution paths, installed as the model's MoE strategy hook:

  * ``moe_ep_train`` — all-to-all dispatch/combine across the EP axis
    ("model"). Each rank routes its S / ep block of the sequence,
    scatters the (token, slot) pairs into fixed-capacity per-destination
    send buffers, an all-to-all exchanges them, the receiver runs its
    local experts as a batched capacity GEMM, and the reverse all-to-all
    brings the results home for the gate-weighted combine. This is the
    collective the paper prices as t_dispatch / t_combine. Differentiable.

  * ``moe_ep_decode`` — activations replicated across the EP axis: each
    rank selects the (token, k) pairs whose expert it holds, runs them
    through the grouped GEMM kernel over its local experts, and one
    all-reduce over the EP axis is the combine.

Hook contract: each rank passes its data-parallel block of the
activations, replicated over the EP axis, as the rest of the model sees
it, and gets the same block back. Expert weights may be passed whole
(E, ...) or as this rank's block; whole weights are cut here.

Gradients follow ``parallel.collectives``: the objective is the sum of
the ranks' losses, and a parameter replicated over an axis has its
gradient summed over that axis by the caller (the router over every
axis, the experts over the data-parallel axes).

Shared experts are not handled here — they stay on the dense path.

On DTensors (``make_dtensor_ep_forward``, installed by
``activate_dtensor``) the same rank-local forwards run through
``collectives.spmd_map``, a ``local_map`` that turns the local
collectives' "sum of the ranks' losses" gradients into DTensor's
gradients of the one loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import apply_mlp
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import axis_sizes, local_block


@dataclasses.dataclass(frozen=True)
class EPConfig:
    mesh: object                        # a DeviceMesh
    ep_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("pod", "data")
    capacity_factor: float = 2.0
    gemm_impl: Optional[str] = None     # grouped-GEMM impl for decode
    etp: bool = False                   # weight-stationary ETP decode
    etp_axis: str = "data"              # expert-internal D sharding axis

    @property
    def present_dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.dp_axes
                     if a in self.mesh.mesh_dim_names)

    @property
    def ep_size(self) -> int:
        return axis_sizes(self.mesh)[self.ep_axis]


def _zeros_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _block(w: torch.Tensor, spec, mesh, n_experts: int) -> torch.Tensor:
    """This rank's block of ``w`` under ``spec`` when ``w`` holds all
    ``n_experts`` experts; else ``w`` is taken to be the block already."""
    if w.shape[0] != n_experts:
        return w
    sizes = axis_sizes(mesh)
    spec = tuple(a if a in sizes else None for a in spec)
    return local_block(w, spec, mesh).contiguous()


def _local_experts(params, cfg: ArchConfig, ep: EPConfig):
    spec = (ep.ep_axis, None, None)
    return (_block(params["wi"], spec, ep.mesh, cfg.n_experts),
            _block(params["wo"], spec, ep.mesh, cfg.n_experts))


# ---------------------------------------------------------------------------
# local helpers (run per rank)
# ---------------------------------------------------------------------------

def _scatter_to_buffers(rows: torch.Tensor, dest: torch.Tensor,
                        n_dest: int, cap: int, payload: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter ``rows`` (R, D) into (n_dest, cap, D) by ``dest`` (R,).

    Returns (buffers, payload buffers, slot (R,)). The slot is the arrival
    order within each destination; rows at or past ``cap`` go to a spare
    row that is cut off (capacity drops). Kept slots are unique, so the
    scatter is deterministic.
    """
    onehot = F.one_hot(dest.long(), n_dest)                      # (R, nd)
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)   # (R,)
    flat_idx = torch.where(slot < cap, dest.long() * cap + slot,
                           torch.full_like(slot, n_dest * cap))
    buf = rows.new_zeros((n_dest * cap + 1, rows.shape[-1]))
    buf = buf.index_add(0, flat_idx, rows)
    pay = payload.new_zeros((n_dest * cap + 1, payload.shape[-1]))
    pay = pay.index_copy(0, flat_idx, payload)
    return (buf[:-1].reshape(n_dest, cap, -1),
            pay[:-1].reshape(n_dest, cap, -1), slot)


def _expert_capacity_gemm(cfg: ArchConfig, x_buf: torch.Tensor,
                          wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Batched per-expert GEMM over capacity buffers (E_loc, C, D)."""
    h = torch.einsum("ecd,edf->ecf", x_buf, wi.to(x_buf.dtype))
    gate, up = h.chunk(2, dim=-1)
    h = F.silu(gate) * up
    return torch.einsum("ecf,efd->ecd", h, wo.to(x_buf.dtype))


# ---------------------------------------------------------------------------
# Training path: all-to-all dispatch
# ---------------------------------------------------------------------------

def _moe_ep_train_local(x_loc, router_w, wi_loc, wo_loc, *, cfg: ArchConfig,
                        ep: EPConfig):
    """Per-rank body. x_loc: (n_loc, D). Returns (out, aux, drop_frac)."""
    n_shards = ep.ep_size
    group = ep.mesh.get_group(ep.ep_axis)
    e_loc = cfg.n_experts // n_shards
    n_loc, d = x_loc.shape
    k = cfg.top_k

    probs, topw, topi = moe_mod.route({"router": router_w}, cfg, x_loc)
    aux = moe_mod.aux_load_balance_loss(probs, topi, cfg.n_experts)

    # --- dispatch: (token, slot) pairs → destination expert shard ---------
    flat_e = topi.reshape(-1).long()                             # (n_loc·k,)
    dest = flat_e // e_loc
    rows = x_loc.repeat_interleave(k, dim=0)                     # (n_loc·k, D)
    cap_send = max(4, int(n_loc * k / n_shards * ep.capacity_factor))
    meta = torch.stack([flat_e % e_loc, torch.ones_like(flat_e)],
                       dim=-1).to(torch.int32)                 # local expert, valid
    send_x, send_meta, slot_d = _scatter_to_buffers(rows, dest, n_shards,
                                                    cap_send, meta)
    recv_x = coll.all_to_all(send_x.reshape(-1, d), group)      # (ns·cap, D)
    recv_meta = torch.empty_like(send_meta.reshape(-1, 2))
    torch.distributed.all_to_all_single(
        recv_meta, send_meta.reshape(-1, 2).contiguous(), group=group)

    # --- local expert compute over capacity buffers -----------------------
    rvalid = recv_meta[:, 1] > 0
    cap_e = max(4, int(n_loc * k / e_loc * ep.capacity_factor))
    rdest = torch.where(rvalid, recv_meta[:, 0].long(),
                        torch.full_like(recv_meta[:, 0].long(), e_loc))
    x_buf, _, slot = _scatter_to_buffers(
        recv_x, rdest, e_loc + 1, cap_e,
        torch.ones((recv_x.shape[0], 1), dtype=torch.int32,
                   device=recv_x.device))
    y_buf = _expert_capacity_gemm(cfg, x_buf[:e_loc], wi_loc, wo_loc)
    y_buf = torch.cat([y_buf, y_buf.new_zeros((1, cap_e, d))], dim=0)

    # gather outputs back to recv-row order, all-to-all home
    flat_back = torch.where(slot < cap_e, rdest * cap_e + slot,
                            torch.full_like(slot, e_loc * cap_e))
    y_rows = y_buf.reshape(-1, d)[flat_back]
    y_rows = torch.where(rvalid[:, None], y_rows, torch.zeros_like(y_rows))
    y_recv = coll.all_to_all(y_rows, group)                     # (ns·cap, D)

    # --- combine: un-scatter to (token, slot) order, gate-weight ----------
    kept = slot_d < cap_send
    flat_idx = torch.where(kept, dest * cap_send + slot_d,
                           torch.full_like(slot_d, n_shards * cap_send))
    y_flat = torch.cat([y_recv, y_recv.new_zeros((1, d))], dim=0)
    y_pairs = y_flat[flat_idx].reshape(n_loc, k, d)
    out = torch.einsum("nkd,nk->nd", y_pairs, topw.to(x_loc.dtype))
    drop_frac = 1.0 - kept.float().mean()
    return out, aux, drop_frac


def moe_ep_train(params, cfg: ArchConfig, x: torch.Tensor, ep: EPConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B_l, S, D), this rank's data-parallel block, replicated over the
    EP axis. The rank routes its S / ep slice; the outputs are gathered
    along S over the EP axis. Returns (out (B_l, S, D), aux)."""
    b, s, d = x.shape
    n = ep.ep_size
    if s % n:
        raise ValueError(f"sequence {s} does not split over {n} EP ranks")
    group = ep.mesh.get_group(ep.ep_axis)
    s_loc = s // n
    x_l = x.narrow(1, ep.mesh.get_local_rank(ep.ep_axis) * s_loc, s_loc)
    wi_l, wo_l = _local_experts(params, cfg, ep)
    out, aux, _ = _moe_ep_train_local(x_l.reshape(-1, d), params["router"],
                                      wi_l, wo_l, cfg=cfg, ep=ep)
    aux = coll.all_reduce_sum(aux, group) / n
    sizes = axis_sizes(ep.mesh)
    for a in ep.present_dp_axes:
        aux = coll.all_reduce_sum(aux, ep.mesh.get_group(a)) / sizes[a]
    out = coll.all_gather_tiled(out.reshape(b, s_loc, d), group, dim=1)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], cfg, x)
    return out, aux


# ---------------------------------------------------------------------------
# Decode path: replicated activations, local select + all-reduce combine
# ---------------------------------------------------------------------------

def _moe_ep_decode_local(x_loc, router_w, wi_loc, wo_loc, *,
                         cfg: ArchConfig, ep: EPConfig):
    """Per-rank body: the grouped GEMM over this rank's experts (pairs
    routed elsewhere sort past ``sum(group_sizes)`` and come out 0), then
    the sum over the EP axis."""
    _, topw, topi = moe_mod.route({"router": router_w}, cfg, x_loc)
    first = ep.mesh.get_local_rank(ep.ep_axis) * wi_loc.shape[0]
    out = moe_mod.expert_ffn(cfg, wi_loc, wo_loc, x_loc, topw, topi,
                             ep.gemm_impl, first_expert=first)
    return coll.all_reduce_sum(out, ep.mesh.get_group(ep.ep_axis))


def moe_ep_decode(params, cfg: ArchConfig, x: torch.Tensor, ep: EPConfig
                  ) -> torch.Tensor:
    """x: (B_l, S, D) — this rank's data-parallel block, replicated over
    the EP axis."""
    d = x.shape[-1]
    wi_l, wo_l = _local_experts(params, cfg, ep)
    out = _moe_ep_decode_local(x.reshape(-1, d), params["router"], wi_l,
                               wo_l, cfg=cfg, ep=ep).reshape(x.shape)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], cfg, x)
    return out


# ---------------------------------------------------------------------------
# ETP weight-stationary decode
# ---------------------------------------------------------------------------

def moe_ep_decode_etp(params, cfg: ArchConfig, x: torch.Tensor,
                      ep: EPConfig) -> torch.Tensor:
    """Weight-stationary expert-tensor-parallel decode.

    Experts stay sharded over the EP axis AND each expert's D dimension
    over ``etp_axis`` (the FSDP storage layout), so no weight bytes move;
    the decode activations do:

        up-proj:   rows[:, D_loc] · wi (E_loc, D_loc, 2M) → partial h,
                   summed over etp_axis                   (n·k × 2M)
        down-proj: h · wo (E_loc, M, D_loc) → y slice     (no comm)
        combine:   sum over the EP axis + all-gather D    (n × D)

    x: (B, S, D) replicated on every rank.
    """
    d, k = x.shape[-1], cfg.top_k
    sizes = axis_sizes(ep.mesh)
    n_etp = sizes.get(ep.etp_axis, 1)
    d_loc = d // n_etp
    wi_l = _block(params["wi"], (ep.ep_axis, ep.etp_axis, None), ep.mesh,
                  cfg.n_experts)
    wo_l = _block(params["wo"], (ep.ep_axis, None, ep.etp_axis), ep.mesh,
                  cfg.n_experts)
    e_loc = wi_l.shape[0]

    xf = x.reshape(-1, d)
    n = xf.shape[0]
    _, topw, topi = moe_mod.route(params, cfg, xf)
    first = ep.mesh.get_local_rank(ep.ep_axis) * e_loc
    sort_idx, group_sizes = moe_mod.sort_by_local_expert(topi, first, e_loc)

    # row-parallel up-projection over the local D slice
    me = ep.mesh.get_local_rank(ep.etp_axis) if n_etp > 1 else 0
    rows_l = xf[:, me * d_loc:(me + 1) * d_loc].contiguous()
    h = kops.grouped_gemm(rows_l, wi_l.to(xf.dtype), group_sizes,
                          impl=ep.gemm_impl, row_index=sort_idx // k)
    if n_etp > 1:
        h = coll.all_reduce_sum(h, ep.mesh.get_group(ep.etp_axis))
    gate, up = h.chunk(2, dim=-1)
    h = F.silu(gate) * up                                       # (n·k, M)

    # column-parallel down-projection into the local D slice
    y = kops.grouped_gemm(h, wo_l.to(xf.dtype), group_sizes,
                          impl=ep.gemm_impl, out_index=sort_idx,
                          out_rows=n * k)                       # (n·k, D_loc)
    out = torch.einsum("nkd,nk->nd", y.reshape(n, k, d_loc),
                       topw.to(xf.dtype))
    out = coll.all_reduce_sum(out, ep.mesh.get_group(ep.ep_axis))
    if n_etp > 1:
        out = coll.all_gather_tiled(out, ep.mesh.get_group(ep.etp_axis),
                                    dim=1)
    out = out.reshape(x.shape)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], cfg, x)
    return out


# ---------------------------------------------------------------------------
# Strategy hook installation
# ---------------------------------------------------------------------------

def make_ep_forward(ep: EPConfig):
    """Build the ``moe_forward`` strategy hook for models under this mesh.
    ``impl`` (the model's kernel choice) overrides ``ep.gemm_impl``."""

    def forward(params, cfg: ArchConfig, x: torch.Tensor, mode: str,
                impl: Optional[str] = None):
        epc = ep if impl is None else dataclasses.replace(ep, gemm_impl=impl)
        if cfg.n_experts % ep.ep_size != 0:
            # e.g. jamba's 16 experts on a 32-wide axis — fall back to the
            # single-program path, as JAX does
            if mode == "train":
                return moe_mod.moe_capacity(params, cfg, x)
            return (moe_mod.moe_sorted(params, cfg, x, epc.gemm_impl),
                    _zeros_aux(x))
        if mode == "train":
            return moe_ep_train(params, cfg, x, epc)
        n_etp = axis_sizes(ep.mesh).get(ep.etp_axis, 1)
        if ep.etp and cfg.d_model % max(n_etp, 1) == 0:
            return moe_ep_decode_etp(params, cfg, x, epc), _zeros_aux(x)
        return moe_ep_decode(params, cfg, x, epc), _zeros_aux(x)

    return forward


# ---------------------------------------------------------------------------
# DTensor front
# ---------------------------------------------------------------------------

def make_dtensor_ep_forward(ep: EPConfig):
    """The MoE strategy hook on DTensor activations: ``make_ep_forward``'s
    rank-local forward through ``spmd_map``. The batch is split over the
    data-parallel axes (replicated where it does not divide), the experts
    over the EP axis (replicated where they do not divide: the local
    fallback then averages its aux loss over every axis), the router
    replicated; the ETP decode keeps each expert's D split over its axis
    and the activations whole. The shared experts run outside, on the
    DTensor path.
    Plain-tensor activations take the rank-local hook."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import placements
    local = make_ep_forward(ep)
    mesh = ep.mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)

    def forward(params, cfg: ArchConfig, x: torch.Tensor, mode: str,
                impl: Optional[str] = None):
        if not isinstance(x, DTensor):
            return local(params, cfg, x, mode, impl)
        dp = ep.present_dp_axes
        split = cfg.n_experts % ep.ep_size == 0
        # the weight-stationary decode keeps each expert's D split over the
        # ETP axis and takes the activations whole
        etp = (split and mode != "train" and ep.etp
               and cfg.d_model % sizes.get(ep.etp_axis, 1) == 0)
        if etp or x.shape[0] % math.prod(sizes[a] for a in dp):
            dp = ()
        x_pl = placements(((dp if len(dp) > 1 else dp[0]) if dp else None,)
                          + (None,) * (x.ndim - 1), mesh)
        keys = sorted(k for k in params if k != "shared")
        expert_axis = ep.ep_axis if split else None
        d_axis = ep.etp_axis if etp and ep.etp_axis in sizes else None
        w_specs = {"wi": (expert_axis, d_axis, None),
                   "wo": (expert_axis, None, d_axis)}
        in_pl = [x_pl] + [placements(
            w_specs.get(k, (None,) * params[k].ndim), mesh) for k in keys]
        repl_all = placements((None,), mesh)

        def body(x_l, *ws):
            out, aux = local(dict(zip(keys, ws)), cfg, x_l, mode, impl)
            if not split:
                for a in names:
                    aux = coll.all_reduce_sum(aux, mesh.get_group(a)) / sizes[a]
            return out, aux

        out, aux = coll.spmd_map(body, mesh, in_pl, (x_pl, repl_all))(
            x, *(params[k] for k in keys))
        if "shared" in params:
            out = out + apply_mlp(params["shared"], cfg, x)
        return out, aux

    return forward


class activate_dtensor:
    """``activate`` with the DTensor hook (``make_dtensor_ep_forward``)."""

    def __init__(self, ep: EPConfig):
        self.ep = ep

    def __enter__(self):
        moe_mod.set_ep_forward(make_dtensor_ep_forward(self.ep))
        return self

    def __exit__(self, *exc):
        uninstall()
        return False


def install(ep: EPConfig) -> None:
    moe_mod.set_ep_forward(make_ep_forward(ep))


def uninstall() -> None:
    moe_mod.set_ep_forward(None)


class activate:
    def __init__(self, ep: EPConfig):
        self.ep = ep

    def __enter__(self):
        install(self.ep)
        return self

    def __exit__(self, *exc):
        uninstall()
        return False
