"""AFD-mode dry-run: the paper's Fig. 1a deployment, priced per device and
timed on the card. Counterpart of ``repro.launch.afd_dryrun``.

For a MoE architecture's decode cell this module

  1. splits the pod's 32 nodes into A-role / F-role fleets at node
     granularity (``n_a_nodes`` + ``n_f_nodes``): the A mesh is (A chips /
     16, 16) over ("data", "model"), the F mesh (F chips,) over ("model",),
     as in JAX;
  2. runs rank 0's per-layer program of each role on seeded tensors of rank
     0's blocks (``parallel.sharding``'s serving placement): the A role
     (norm → decode attention → residual → norm → router → shared expert)
     on its local query heads, the F role (the routed experts' grouped
     GEMMs) on its expert block. PyTorch has no partitioner, so the
     programs are rank-local and call their collectives themselves;
  3. prices each program (``lower_afd``) under ``hlo_analysis.count_cost``:
     the rank runs alone, and each collective it calls (``LocalComm``) is
     priced as the one it stands for on the role's mesh;
  4. feeds (t_a, t_f, t_c) into the §2.2 budget and the 3BO pipeline
     simulator (``afd_budget``), t_c from the Eq. 9/17 wire model over the
     M2N bytes the programs exchange.

``measure_afd`` is the card's leg: the same two programs on rank 0's
blocks on the device, each timed by its wall per call and by its device
time, beside the same programs priced on ``H100``.

Rank-local layout. A rank holds the spec's block of every leaf, with two
layouts of its own (same bytes as the spec's block): the shared expert's
fused gate|up columns are cut per half, so that a rank holds the gate and
up columns of the same hidden units; and the KV cache block (batch-split
only, every KV head) is kept KV-head-major, (Hkv, B, T, d), so that the KV
head a rank's query heads read is one contiguous tensor for the kernel.

    PYTHONPATH=src python -m repro_torch.launch.afd_dryrun --arch kimi-k2-1t-a32b
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import time
from typing import Dict, Optional

import torch

from repro_torch import configs
from repro_torch.core import overlap as ov
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quant import quantize_experts
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import CHIPS_PER_NODE
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ArchConfig, resolve_device
from repro_torch.models.layers import activation, apply_norm, apply_rope, \
    rmsnorm_1d
from repro_torch.parallel import sharding as shd

RESULTS = "results/afd_dryrun.json"
TP = "model"                    # the tensor/expert-parallel axis
TP_SIZE = 16                    # the A mesh's "model" axis, as in JAX


@dataclasses.dataclass(frozen=True)
class Cell:
    """One decode cell: the pod split and the micro-batch it feeds."""
    cfg: ArchConfig
    batch: int
    context: int
    n_a_nodes: int
    n_f_nodes: int
    micro_batches: int
    int8: bool

    @property
    def a_chips(self) -> int:
        return self.n_a_nodes * CHIPS_PER_NODE

    @property
    def f_chips(self) -> int:
        return self.n_f_nodes * CHIPS_PER_NODE

    @property
    def a_shape(self):
        return (self.a_chips // TP_SIZE, TP_SIZE)

    @property
    def mb(self) -> int:
        """Per-micro-batch tokens, padded up to the A mesh's data dim (the
        3BO rotation feeds ``micro_batches`` slices of the run batch)."""
        a_data = self.a_shape[0]
        mb = -(-self.batch // self.micro_batches)
        return -(-mb // a_data) * a_data


def make_cell(arch: str, batch: int, context: int, n_a_nodes: int,
              n_f_nodes: int, micro_batches: int, int8: bool) -> Cell:
    cfg = configs.get_config(arch)
    if not cfg.is_moe:
        raise SystemExit(f"{arch} is dense — AFD inapplicable")
    return Cell(cfg, batch, context, n_a_nodes, n_f_nodes, micro_batches,
                int8)


# ---------------------------------------------------------------------------
# Collectives of a rank-local program
# ---------------------------------------------------------------------------

class LocalComm:
    """One rank of a mesh run alone: an all-reduce returns the rank's own
    partial and an all-gather puts its part among zeros for the other
    ranks'. Each call is noted to an open cost counter as the collective it
    stands for, so the program is priced as on the whole mesh."""

    def __init__(self, sizes: Dict[str, int], coords: Dict[str, int]):
        self.sizes, self.coords = dict(sizes), dict(coords)

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        n, size = self.sizes[axis], t.shape[dim]
        with hlo.uncounted():
            shape = list(t.shape)
            shape[dim] = n * size
            out = t.new_zeros(shape)
            out.narrow(dim, self.coords[axis] * size, size).copy_(t)
        hlo.note_collective("all-gather", out, n)
        return out

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        hlo.note_collective("all-reduce", t, self.sizes[axis])
        return t


# ---------------------------------------------------------------------------
# Role blocks
# ---------------------------------------------------------------------------

def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def a_layer_shapes(cfg: ArchConfig) -> Dict:
    """The A role's layer leaves (JAX's ``layer_shape``) on the meta
    device."""
    D, dt = cfg.d_model, cfg.params_dtype
    norm = lambda: ({"scale": _meta(D, dtype=dt)}  # noqa: E731
                    | ({"bias": _meta(D, dtype=dt)}
                       if cfg.norm_type == "layernorm" else {}))
    attn = {"wq": _meta(D, cfg.q_dim, dtype=dt),
            "wk": _meta(D, cfg.kv_dim, dtype=dt),
            "wv": _meta(D, cfg.kv_dim, dtype=dt),
            "wo": _meta(cfg.q_dim, D, dtype=dt)}
    if cfg.qkv_bias:
        attn |= {"bq": _meta(cfg.q_dim, dtype=dt),
                 "bk": _meta(cfg.kv_dim, dtype=dt),
                 "bv": _meta(cfg.kv_dim, dtype=dt)}
    if cfg.qk_norm:
        attn |= {"q_norm": _meta(cfg.d_head, dtype=dt),
                 "k_norm": _meta(cfg.d_head, dtype=dt)}
    moe = {"router": _meta(D, cfg.n_experts, dtype=torch.float32)}
    if cfg.n_shared_experts:
        f = cfg.shared_d_ff or cfg.moe_d_ff
        moe["shared"] = {"wi": _meta(D, 2 * f, dtype=dt),
                         "wo": _meta(f, D, dtype=dt)}
    return {"ln1": norm(), "ln2": norm(), "attn": attn, "moe": moe}


@dataclasses.dataclass
class ABlock:
    """One A rank's blocks of the layer's leaves, their specs on the A
    mesh, and its KV cache block (KV-head-major, (Hkv, B_l, T, d))."""
    params: Dict
    specs: Dict
    cache: Dict[str, torch.Tensor]


@dataclasses.dataclass
class FBlock:
    """One F rank's block of the experts: ``first`` and on. ``split``:
    the experts divide over the F mesh (else every rank holds them all
    and no sum is needed). int8 blocks carry per-expert scales."""
    wi: torch.Tensor
    wo: torch.Tensor
    first: int
    split: bool
    wi_scale: Optional[torch.Tensor] = None
    wo_scale: Optional[torch.Tensor] = None


def _local_shape(shape, spec, sizes) -> tuple:
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] //= math.prod(sizes[a] for a in shd._axes(entry))
    return tuple(out)


def a_specs(cfg: ArchConfig, mesh) -> Dict:
    return shd.params_shardings(a_layer_shapes(cfg), mesh, shd.SERVE_RULES)


def _at(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def cut_a_params(cfg: ArchConfig, full: Dict, mesh,
                 coords: Dict[str, int]) -> Dict:
    """The rank at ``coords``'s blocks of full layer leaves: each leaf's
    ``local_block``, except that a split shared gate|up is cut per half."""
    specs = a_specs(cfg, mesh)

    def cut(path, t):
        spec = _at(specs, path)
        if path == "moe/shared/wi" and spec[1] == TP:
            d, f2 = t.shape
            blk = shd.local_block(t.reshape(d, 2, f2 // 2),
                                  (spec[0], None, TP), mesh, coords)
            return blk.reshape(blk.shape[0], -1)
        return shd.local_block(t, spec, mesh, coords)

    return shd.map_with_path(cut, full)


def _normal(shape, dtype, gen, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype).mul_(scale)


def seeded_a_block(cell: Cell, mesh):
    """Rank 0's A block with seeded values, and its inputs (x (B_l, 1, D),
    pos (B_l,) at ``context - 1``, so every cache slot is live), on the
    CPU. Weights are normal / sqrt(fan-in), norm scales 1."""
    cfg, gen = cell.cfg, torch.Generator().manual_seed(0)
    sizes = shd.axis_sizes(mesh)
    specs = a_specs(cfg, mesh)

    def leaf(path, t):
        shape = _local_shape(t.shape, _at(specs, path), sizes)
        name = path.rsplit("/", 1)[-1]
        if name in ("scale", "q_norm", "k_norm"):
            return torch.ones(shape, dtype=t.dtype)
        if name in ("bias", "bq", "bk", "bv"):
            return torch.zeros(shape, dtype=t.dtype)
        return _normal(shape, t.dtype, gen, 1.0 / math.sqrt(t.shape[0]))

    params = shd.map_with_path(leaf, a_layer_shapes(cfg))
    b_l = cell.mb // sizes["data"]
    dt = cfg.compute_dtype
    cache = {n: _normal((cfg.n_kv_heads, b_l, cell.context, cfg.d_head), dt,
                        gen) for n in ("k", "v")}
    x = _normal((b_l, 1, cfg.d_model), dt, gen)
    pos = torch.full((b_l,), cell.context - 1, dtype=torch.int32)
    return ABlock(params, specs, cache), (x, pos)


def seeded_f_block(cell: Cell) -> FBlock:
    """F rank 0's expert block with seeded values on the CPU: int8 codes
    and per-expert scales of the seeded weights when ``cell.int8``."""
    cfg, gen = cell.cfg, torch.Generator().manual_seed(1)
    E, D, M = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    split = E % cell.f_chips == 0
    e_loc = E // cell.f_chips if split else E
    wi = _normal((e_loc, D, 2 * M), cfg.params_dtype, gen, 1.0 / math.sqrt(D))
    wo = _normal((e_loc, M, D), cfg.params_dtype, gen, 1.0 / math.sqrt(M))
    if not cell.int8:
        return FBlock(wi, wo, 0, split)
    (wi, wi_scale), (wo, wo_scale) = quantize_experts(wi), quantize_experts(wo)
    return FBlock(wi, wo, 0, split, wi_scale, wo_scale)


def seeded_f_inputs(cell: Cell):
    """The F role's inputs on the CPU: the micro-batch's tokens (mb, D) and
    a random top-k gating, topw (mb, k) float32 summing to 1 per token and
    topi (mb, k) int32 of distinct experts."""
    cfg, gen = cell.cfg, torch.Generator().manual_seed(2)
    tokens = _normal((cell.mb, cfg.d_model), cfg.compute_dtype, gen)
    scores = torch.rand((cell.mb, cfg.n_experts), generator=gen)
    topw, topi = torch.topk(scores, cfg.top_k, dim=-1)
    return tokens, topw / topw.sum(-1, keepdim=True), topi.to(torch.int32)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# Role programs (rank-local)
# ---------------------------------------------------------------------------

def _gather(t: torch.Tensor, spec, comm, keep: Optional[int] = None):
    """All-gather every dim of ``t`` sharded under ``spec`` but ``keep``
    when that dim is split over ``TP`` alone. Returns (tensor, kept)."""
    kept = keep is not None and spec[keep] == TP
    for dim, entry in enumerate(spec):
        if entry is not None and not (kept and dim == keep):
            for a in reversed(shd._axes(entry)):
                t = comm.all_gather(t, a, dim)
    return t, kept


def a_role_layer(cfg: ArchConfig, blk: ABlock, x: torch.Tensor,
                 pos: torch.Tensor, comm, impl: Optional[str] = None):
    """One A rank's layer step for its block of a decode micro-batch.

    x (B_l, 1, D), pos (B_l,) → (x after attention, norm'd tokens
    (B_l, D), topw, topi, shared-expert output, cache): JAX's
    ``_a_role_layer`` on this rank's sequences; then the attention
    sublayer's output added to x (the kernel's share, which the residual
    can round away in bf16). Weights split over the
    data axis (FSDP) are all-gathered; the query heads (``wq`` columns,
    ``wo`` rows) and the shared expert's hidden units stay split over
    ``TP`` when whole heads divide, and their partial outputs are summed
    over it; the new token's k and v columns are all-gathered before the
    cache write. The cache block is written in place."""
    p, s, d = blk.params, blk.specs, cfg.d_head
    n_tp, r = comm.sizes.get(TP, 1), comm.coords.get(TP, 0)
    at, ats = p["attn"], s["attn"]
    wq, tp_attn = _gather(at["wq"], ats["wq"], comm, keep=1)
    wo, o_kept = _gather(at["wo"], ats["wo"], comm, keep=0)
    if tp_attn != o_kept or (tp_attn and cfg.n_heads % n_tp):
        raise ValueError(f"{cfg.n_heads} query heads do not split whole "
                         f"over {n_tp} ranks")
    hl = cfg.n_heads // n_tp if tp_attn else cfg.n_heads
    h0 = r * hl if tp_attn else 0
    wk, k_kept = _gather(at["wk"], ats["wk"], comm, keep=1)
    wv, _ = _gather(at["wv"], ats["wv"], comm, keep=1)

    b = x.shape[0]
    h = apply_norm(p["ln1"], cfg, x)
    q = h @ wq.to(h.dtype)
    k, v = h @ wk.to(h.dtype), h @ wv.to(h.dtype)
    if k_kept:
        k, v = comm.all_gather(k, TP, -1), comm.all_gather(v, TP, -1)
    if "bq" in at:
        q = q + at["bq"][h0 * d:(h0 + hl) * d].to(h.dtype)
        k, v = k + at["bk"].to(h.dtype), v + at["bv"].to(h.dtype)
    q = q.reshape(b, 1, hl, d)
    k = k.reshape(b, 1, cfg.n_kv_heads, d)
    v = v.reshape(b, 1, cfg.n_kv_heads, d)
    if "q_norm" in at:
        q = rmsnorm_1d(at["q_norm"], q, cfg.rms_eps)
        k = rmsnorm_1d(at["k_norm"], k, cfg.rms_eps)
    if cfg.use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)

    # cache write at pos (writes past T dropped, as JAX's scatter does)
    cache = blk.cache
    t = cache["k"].shape[2]
    slot = pos.long()
    inside = (slot < t)[None, :, None]
    slot = slot.clamp(max=t - 1)
    idx = torch.arange(b, device=slot.device)
    for name, new in (("k", k), ("v", v)):
        plane = cache[name]
        plane[:, idx, slot] = torch.where(
            inside, new[:, 0].transpose(0, 1).to(plane.dtype),
            plane[:, idx, slot])

    # attend with the KV heads the local query heads map to
    g = cfg.n_heads // cfg.n_kv_heads
    lo, hi = h0 // g, (h0 + hl - 1) // g + 1
    if hl % (hi - lo):
        raise ValueError(f"{hl} local query heads from head {h0} do not "
                         f"form whole GQA groups over KV heads {lo}..{hi}")
    kv = [cache[n][lo:hi].permute(1, 2, 0, 3) for n in ("k", "v")]
    out = kops.splitkv_attention(q[:, 0], kv[0], kv[1], pos + 1, impl=impl)
    mix = out.reshape(b, 1, hl * d) @ wo.to(h.dtype)
    if tp_attn:
        mix = comm.all_reduce(mix, TP)
    x = x + mix

    hn = apply_norm(p["ln2"], cfg, x)
    tokens = hn.reshape(-1, cfg.d_model)
    _, topw, topi = moe_mod.route(p["moe"], cfg, tokens)
    if "shared" in p["moe"]:
        sp, ss = p["moe"]["shared"], s["moe"]["shared"]
        wi, i_kept = _gather(sp["wi"], ss["wi"], comm, keep=1)
        wso, so_kept = _gather(sp["wo"], ss["wo"], comm, keep=0)
        if i_kept != so_kept:
            raise ValueError("the shared expert's wi and wo split apart")
        gate, up = (hn @ wi.to(hn.dtype)).chunk(2, dim=-1)
        shared = (activation(cfg, gate) * up) @ wso.to(hn.dtype)
        if i_kept:
            shared = comm.all_reduce(shared, TP)
    else:
        shared = torch.zeros_like(x)
    return x, tokens, topw, topi, shared, cache, mix


def f_role_layer(cfg: ArchConfig, blk: FBlock, tokens: torch.Tensor,
                 topw: torch.Tensor, topi: torch.Tensor, comm,
                 impl: Optional[str] = None) -> torch.Tensor:
    """One F rank's routed-expert FFN given the gating (JAX's
    ``_f_role_layer``): its expert block's grouped GEMMs, dense or in the
    int8 mode, then the sum over the F mesh when the experts are split."""
    y = moe_mod.expert_ffn(cfg, blk.wi, blk.wo, tokens, topw, topi, impl,
                           first_expert=blk.first, wi_scale=blk.wi_scale,
                           wo_scale=blk.wo_scale)
    return comm.all_reduce(y, TP) if blk.split else y


def _f_args_bytes(blk: FBlock, inputs) -> int:
    """The F program's argument bytes on one device: its expert block (and
    scales) and the replicated tokens and gating."""
    return sum(t.numel() * t.element_size() for t in
               (blk.wi, blk.wo, blk.wi_scale, blk.wo_scale, *inputs)
               if t is not None)


def _expert_bytes(blk: FBlock) -> int:
    return sum(t.numel() * t.element_size() for t in
               (blk.wi, blk.wo, blk.wi_scale, blk.wo_scale) if t is not None)


# ---------------------------------------------------------------------------
# Stage latencies and the paper's budget machinery
# ---------------------------------------------------------------------------

def m2n_bytes(cfg: ArchConfig, mb: int):
    """(dispatch, combine) wire bytes of one micro-batch (Eq. 17-adapted,
    dtype-accurate): tokens + gates A→F, outputs F→A."""
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    return (mb * cfg.d_model * itemsize + mb * cfg.top_k * 8,
            mb * cfg.d_model * itemsize)


def afd_budget(t_a: float, t_f: float, flops_f_dev: float, f_chips: int,
               dispatch_bytes: int, combine_bytes: int, n_a_nodes: int,
               n_f_nodes: int, hardware: str = "TPUv5e") -> Dict:
    """The ``m2n``, ``pipeline`` and ``ffn_stage`` fields of the record from
    the stage latencies, the F role's per-device FLOPs and the M2N sizes,
    priced on ``hardware``: JAX's float operations in JAX's order."""
    hw = hlo.get_pricing(hardware)
    # node-level scale-out links (one egress per node, as the paper prices
    # per-GPU NICs); conservative: the slower role pays the wire.
    link_bw = hw.link_bw
    t_dispatch = dispatch_bytes / (min(n_a_nodes, n_f_nodes) *
                                   CHIPS_PER_NODE * link_bw / 8)
    t_combine = combine_bytes / (min(n_a_nodes, n_f_nodes) *
                                 CHIPS_PER_NODE * link_bw / 8)
    st = ov.StageTimes(t_attn=t_a, t_ffn=t_f, t_dispatch=t_dispatch,
                       t_combine=t_combine)
    period = ov.afd_3bo_steady_period(st)
    a_util, f_util = ov.steady_state_utilization("3BO", st, n_layers=24)
    # FFN-stage HFU within the realized period (Eq. 8 on our artifact)
    flops_f = flops_f_dev * f_chips
    hfu_f = flops_f / (period * f_chips * hw.peak_flops)
    ofu_f = flops_f / (max(t_f, 1e-12) * f_chips * hw.peak_flops)
    return {
        "m2n": {"dispatch_bytes": dispatch_bytes,
                "combine_bytes": combine_bytes,
                "t_dispatch": t_dispatch, "t_combine": t_combine},
        "pipeline": {"period": period, "a_util": a_util, "f_util": f_util,
                     "bubble_free": abs(max(t_a, t_f) - period) < 1e-12},
        "ffn_stage": {"ofu": ofu_f, "s_t": min(t_f / period, 1.0),
                      "hfu": hfu_f},
    }


def _role_record(terms: hlo.RooflineTerms, chips: int, wall: float) -> Dict:
    return {"chips": chips, "compile_s": round(wall, 1),
            "t_compute": terms.t_compute, "t_memory": terms.t_memory,
            "t_collective": terms.t_collective,
            "t_stage": terms.total_lower_bound,
            "flops_dev": terms.flops_dev, "bytes_dev": terms.bytes_dev,
            "coll_link_dev": terms.coll_link_dev}


# ---------------------------------------------------------------------------
# Priced on the host: lower_afd
# ---------------------------------------------------------------------------

def _price(run, chips: int, hardware: str):
    t0 = time.perf_counter()
    with hlo.count_cost() as counter:
        out = run()
    terms = hlo.roofline(counter.cost,
                         hlo.collective_stats(counter.collectives), chips,
                         hardware)
    return terms, time.perf_counter() - t0, out


def lower_afd(arch: str, batch: int = 128, context: int = 32_768,
              n_a_nodes: int = 24, n_f_nodes: int = 8,
              micro_batches: int = 3, int8: bool = False,
              hardware: str = "TPUv5e") -> Dict:
    """JAX's record for the cell, key for key, priced on ``hardware``:
    each role's program run once on rank 0's seeded CPU blocks
    (``role_programs``). Each role also carries the counts it was priced
    from (``flops_dev``, ``bytes_dev``, ``coll_link_dev``); ``compile_s``
    is the pricing wall; ``priced_on`` names ``hardware``."""
    hlo.get_pricing(hardware)
    cell = make_cell(arch, batch, context, n_a_nodes, n_f_nodes,
                     micro_batches, int8)
    runs, f_args, _ = role_programs(cell, torch.device("cpu"))
    a_terms, a_time, _ = _price(runs["a_role"], cell.a_chips, hardware)
    f_terms, f_time, _ = _price(runs["f_role"], cell.f_chips, hardware)

    t_a, t_f = a_terms.total_lower_bound, f_terms.total_lower_bound
    dispatch, combine = m2n_bytes(cell.cfg, cell.mb)
    return {
        "arch": arch, "batch": batch, "context": context,
        "n_a_nodes": n_a_nodes, "n_f_nodes": n_f_nodes,
        "micro_batches": micro_batches, "int8": int8, "mb": cell.mb,
        "f_weight_bytes_dev": f_args,
        "a_role": {**_role_record(a_terms, cell.a_chips, a_time),
                   "per_layer": True},
        "f_role": _role_record(f_terms, cell.f_chips, f_time),
        **afd_budget(t_a, t_f, f_terms.flops_dev, cell.f_chips, dispatch,
                     combine, n_a_nodes, n_f_nodes, hardware),
        "priced_on": hardware,
    }


# ---------------------------------------------------------------------------
# Measured on the card: measure_afd
# ---------------------------------------------------------------------------

def _wall_ms(fn, device: torch.device, iters: int) -> float:
    """Median wall time of ``fn`` in ms on the host's clock, each call
    ended by a sync: what the program takes as it runs, host enqueue and
    host syncs included, by one rule for every role. On a CUDA device each
    call starts on an idle device after a 256 MB buffer is rewritten, so
    its inputs come from device memory, as each layer's own would."""
    cuda = device.type == "cuda"
    flush = (torch.empty(64 << 20, dtype=torch.float32, device=device)
             if cuda else None)
    fn()
    times = []
    for _ in range(iters):
        if cuda:
            flush.zero_()
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_ms(fn, calls: int = 10):
    """Device time of ``fn`` per call in ms, the host out of the way: the
    sum of the device times of its kernels and copies in a
    ``torch.profiler`` trace of ``calls`` calls back to back. Returns it
    and the largest kernels as (ms per call, launches per call, name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total / 1e3 / calls,
                    ev.count // calls, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    return sum(r[0] for r in rows), rows[:6]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    den = float(want.norm())
    return float((got - want).norm()) / (den if den > 0 else 1.0)


def role_programs(cell: Cell, device):
    """Rank 0's A and F blocks of ``cell`` on ``device`` (seeded on the CPU
    and moved, so every device sees the same values), each program run
    alone with its collectives local (``LocalComm``). Returns ``runs``,
    where ``runs[role](impl=None)`` runs that role's program once and
    returns its outputs by name, and the F program's (argument, expert)
    bytes."""
    cfg = cell.cfg
    a_mesh = shd.MeshShape(("data", TP), cell.a_shape)
    a_comm = LocalComm(shd.axis_sizes(a_mesh), {"data": 0, TP: 0})
    f_comm = LocalComm({TP: cell.f_chips}, {TP: 0})
    blk, (x, pos) = seeded_a_block(cell, a_mesh)
    blk = ABlock(_to(blk.params, device), blk.specs, _to(blk.cache, device))
    x, pos = x.to(device), pos.to(device)
    fblk, f_in = seeded_f_block(cell), seeded_f_inputs(cell)
    fblk = FBlock(**{f.name: _to(getattr(fblk, f.name), device)
                     for f in dataclasses.fields(FBlock)})
    f_in = _to(f_in, device)

    def run_a(impl=None):
        # the A role's program under its serving rules, as JAX compiles
        # it; the rank-local program holds plain tensors, which the rules
        # pass unchanged, so no priced or measured number moves
        with shd.activate(a_mesh, shd.SERVE_RULES):
            out = a_role_layer(cfg, blk, x, pos, a_comm, impl)
        return {"x": out[0], "shared": out[4], "attn": out[6],
                "topi": out[3]}

    def run_f(impl=None):
        return {"y": f_role_layer(cfg, fblk, *f_in, f_comm, impl)}

    return ({"a_role": run_a, "f_role": run_f}, _f_args_bytes(fblk, f_in),
            _expert_bytes(fblk))


def measure_afd(arch: str, batch: int = 128, context: int = 32_768,
                n_a_nodes: int = 24, n_f_nodes: int = 8,
                micro_batches: int = 3, int8: bool = False,
                device="cuda", iters: int = 20) -> Dict:
    """Rank 0's A and F blocks of the cell on ``device`` (``role_programs``):

      * one call of each program under ``count_cost``, priced on ``H100``,
        with the kernel launches it made (``launches``);
      * its output against the same program on the plain versions on the
        same device (``rel_err_plain``, ||got − plain|| / ||plain||, the
        worst of x, the attention output and the shared output for the A
        role; the FFN output for F);
      * its median wall per call over ``iters`` calls, each ended by a
        sync (``t_measured``, seconds), and on a CUDA device its device
        time per call (``t_device``, seconds; ``None`` elsewhere) with its
        largest kernels (``top_kernels``).

    ``pipeline`` and ``ffn_stage`` come from the two roles' ``t_measured``,
    t_c from Eq. 9/17 priced on ``H100`` and the F role's priced FLOPs;
    ``device_only`` holds the same fields from the two ``t_device`` (on a
    CUDA device). The measured times hold no collective time: the link is
    priced, not measured. ``outputs`` holds the kernel runs' outputs on the
    CPU."""
    dev = resolve_device(device)
    cell = make_cell(arch, batch, context, n_a_nodes, n_f_nodes,
                     micro_batches, int8)
    runs, f_args, f_experts = role_programs(cell, dev)
    rec = {"arch": arch, "batch": batch, "context": context,
           "n_a_nodes": n_a_nodes, "n_f_nodes": n_f_nodes,
           "micro_batches": micro_batches, "int8": int8, "mb": cell.mb,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "f_weight_bytes_dev": f_args, "f_expert_bytes_dev": f_experts,
           "outputs": {}}
    for name, chips in (("a_role", cell.a_chips), ("f_role", cell.f_chips)):
        run = runs[name]
        before = kops.launch_counts()
        terms, _, out = _price(run, chips, "H100")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = {k: n - before[k] for k, n in kops.launch_counts().items()}
        plain = run("plain")
        rec["outputs"][name] = {k: v.cpu() for k, v in out.items()}
        dev_ms, top = (_device_ms(run) if dev.type == "cuda"
                       else (None, []))
        rec[name] = {
            "chips": chips, "t_measured": _wall_ms(run, dev, iters) / 1e3,
            "t_device": None if dev_ms is None else dev_ms / 1e3,
            "top_kernels": top, "t_priced": terms.total_lower_bound,
            "t_compute": terms.t_compute, "t_memory": terms.t_memory,
            "t_collective": terms.t_collective,
            "flops_dev": terms.flops_dev, "bytes_dev": terms.bytes_dev,
            "coll_link_dev": terms.coll_link_dev, "launches": launches,
            "rel_err_plain": max(_rel(out[k], plain[k]) for k in out
                                 if k != "topi")}

    dispatch, combine = m2n_bytes(cell.cfg, cell.mb)

    def budget(key):
        return afd_budget(rec["a_role"][key], rec["f_role"][key],
                          rec["f_role"]["flops_dev"], cell.f_chips, dispatch,
                          combine, n_a_nodes, n_f_nodes, "H100")

    rec.update(budget("t_measured"))
    rec["device_only"] = ({k: v for k, v in budget("t_device").items()
                           if k != "m2n"} if dev.type == "cuda" else None)
    rec["priced_on"] = "H100"
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="kimi-k2-1t-a32b")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--n-a-nodes", type=int, default=24)
    ap.add_argument("--n-f-nodes", type=int, default=8)
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight-only expert residency on the F role")
    ap.add_argument("--hardware", default="TPUv5e",
                    choices=sorted(hlo.PRICING),
                    help="the hardware each role's program is priced on")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    rec = lower_afd(args.arch, batch=args.batch, n_a_nodes=args.n_a_nodes,
                    n_f_nodes=args.n_f_nodes, int8=args.int8,
                    hardware=args.hardware)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    try:
        with open(args.out) as f:
            all_rec = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        all_rec = {}
    suffix = ":int8" if args.int8 else ""
    all_rec[f"{args.arch}|{args.n_a_nodes}A+{args.n_f_nodes}F{suffix}"] = rec
    with open(args.out, "w") as f:
        json.dump(all_rec, f, indent=1)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
