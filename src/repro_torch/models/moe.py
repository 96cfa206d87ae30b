"""Mixture-of-Experts FFN: init, top-k router and two execution paths.
Counterpart of ``repro.models.moe``.

  * ``moe_capacity`` — GShard-style capacity-bounded one-hot dispatch as
    dense einsums; tokens past an expert's capacity are dropped. The
    single-program model's prefill and forward run it, as JAX's do; the
    einsums stay ``torch.einsum`` (JAX computes them outside any kernel).
  * ``moe_sorted`` — dropless: replicate each token top_k times, sort by
    expert and run the routed-expert FFN (``expert_ffn``) on the grouped
    GEMM kernel, with the dispatch gather fused into the first GEMM
    (``row_index``) and the combine unpermute into the second
    (``out_index``). The model's decode step runs it; the AFD runtime's F
    role runs ``expert_ffn`` on the gating the A role sends it.

``moe_capacity`` carries JAX's two ``shard`` annotations (the expert
buffers). On DTensors the MoE layers run the EP hook's local blocks
instead, as JAX's do, so there they meet no DTensor.

Routing is softmax-then-top-k with optional renormalisation of the gate
weights. The router weight stays float32, as in JAX. Shared experts are a
plain gated MLP added to the routed output. ``set_ep_forward`` installs a
strategy hook that ``moe_forward`` defers to (``parallel.ep``'s
expert-parallel paths); ``expert_ffn`` also runs one block of the experts.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ArchConfig, dense_init, shard
from repro_torch.models.layers import activation, apply_mlp, init_mlp


def init_moe(seed: int, name: str, cfg: ArchConfig,
             device) -> Dict[str, object]:
    D, E, M = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p: Dict[str, object] = {
        "router": dense_init(seed, f"{name}.router", (D, E), torch.float32,
                             device, fan_in=D),
        "wi": dense_init(seed, f"{name}.wi", (E, D, 2 * M), cfg.params_dtype,
                         device, fan_in=D),
        "wo": dense_init(seed, f"{name}.wo", (E, M, D), cfg.params_dtype,
                         device, fan_in=M),
    }
    if cfg.n_shared_experts:
        ms = (cfg.shared_d_ff or cfg.moe_d_ff) * cfg.n_shared_experts
        p["shared"] = init_mlp(seed, f"{name}.shared", cfg, device, d_ff=ms)
    return p


def route(params, cfg: ArchConfig, x_flat: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. x_flat: (N, D) → (probs (N, E), weights (N, k),
    ids (N, k) int32)."""
    probs = torch.softmax(x_flat.float() @ params["router"], dim=-1)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_renorm:
        topw = topw / topw.sum(-1, keepdim=True)
    return probs, topw, topi.to(torch.int32)


def aux_load_balance_loss(probs: torch.Tensor, topi: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss: E · Σ_e f_e · P_e."""
    onehot = F.one_hot(topi.long(), n_experts).float()         # (N, k, E)
    f = onehot.sum(1).mean(0)                                  # per expert
    return n_experts * (f * probs.mean(0)).sum()


def _expert_ffn(cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    gate, up = h.chunk(2, dim=-1)
    return activation(cfg, gate) * up


def _counts(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int32 occurrences of each key in [0, n): a scatter-add into a
    fixed-size vector, whose shape does not depend on the data (unlike
    ``torch.bincount``'s), so it runs on fake tensors and needs no host
    read of the largest key."""
    return torch.zeros(n, dtype=torch.int32, device=keys.device).scatter_add_(
        0, keys, torch.ones_like(keys, dtype=torch.int32))


def sort_by_expert(topi: torch.Tensor, n_experts: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten (N, k) expert ids into a group-sorted order.

    Returns (sort_idx (N·k,), inv_idx (N·k,), group_sizes (E,) int32):
    ``sort_idx`` gathers the replicated tokens into expert-contiguous rows
    (stable, so ties keep token order).
    """
    flat = topi.reshape(-1).long()
    sort_idx = torch.argsort(flat, stable=True)
    inv_idx = torch.argsort(sort_idx, stable=True)
    group_sizes = _counts(flat, n_experts)
    return sort_idx, inv_idx, group_sizes


def sort_by_local_expert(topi: torch.Tensor, first: int, n_local: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert sort of one block of experts, ``[first, first +
    n_local)``: (sort_idx (N·k,), group_sizes (n_local,) int32). Pairs
    routed outside the block take the key ``n_local`` and sort to the
    tail, past ``sum(group_sizes)``, where the grouped GEMM writes zeros:
    the expert-parallel decode's local select (``parallel.ep``)."""
    key = topi.reshape(-1).long() - first
    key = torch.where((key >= 0) & (key < n_local), key,
                      torch.full_like(key, n_local))
    sort_idx = torch.argsort(key, stable=True)
    return sort_idx, _counts(key, n_local + 1)[:n_local]


# ---------------------------------------------------------------------------
# Capacity-bounded dense dispatch
# ---------------------------------------------------------------------------

def capacity(cfg: ArchConfig, n_tokens: int,
             factor: Optional[float] = None) -> int:
    f = factor if factor is not None else cfg.moe_capacity_factor
    return max(int(math.ceil(n_tokens * cfg.top_k * f / cfg.n_experts)), 4)


def moe_capacity(params, cfg: ArchConfig, x: torch.Tensor,
                 cap: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatch MoE over x (..., D). Returns (out, aux_loss).

    A (token, slot) pair takes the next place in its expert's queue in
    token-major order (a cumulative sum of one-hots, as in JAX); pairs at
    or past ``cap`` places are dropped."""
    orig_shape = x.shape
    x_flat = x.reshape(-1, orig_shape[-1])
    n, dt = x_flat.shape[0], x_flat.dtype
    e, k = cfg.n_experts, cfg.top_k
    c = cap if cap is not None else capacity(cfg, n)

    probs, topw, topi = route(params, cfg, x_flat)
    aux = aux_load_balance_loss(probs, topi, e)

    onehot = F.one_hot(topi.long(), e)                          # (N, k, E)
    flat_oh = onehot.reshape(n * k, e)
    pos_in_expert = torch.cumsum(flat_oh, dim=0) * flat_oh - 1  # (N·k, E)
    pos = pos_in_expert.max(dim=-1).values.reshape(n, k)        # (N, k)
    keep = pos < c

    disp = onehot.to(dt) * keep[..., None].to(dt)
    pos_oh = F.one_hot(torch.where(keep, pos, 0), c).to(dt)
    dispatch = torch.einsum("nke,nkc->nkec", disp, pos_oh)      # (N,k,E,C)
    combine = dispatch * topw[..., None, None].to(dt)

    x_e = torch.einsum("nkec,nd->ecd", dispatch, x_flat)        # (E, C, D)
    x_e = shard(x_e, "experts", None, "embed")
    h = _expert_ffn(cfg, torch.einsum("ecd,edf->ecf", x_e,
                                      params["wi"].to(dt)))
    h = shard(h, "experts", None, "mlp")
    y_e = torch.einsum("ecf,efd->ecd", h, params["wo"].to(dt))
    out = torch.einsum("nkec,ecd->nd", combine, y_e)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], cfg, x_flat)
    return out.reshape(orig_shape), aux


# ---------------------------------------------------------------------------
# Sort-based dropless dispatch on the grouped GEMM
# ---------------------------------------------------------------------------

def expert_ffn(cfg: ArchConfig, wi: torch.Tensor, wo: torch.Tensor,
               tokens: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor,
               impl: Optional[str] = None, first_expert: int = 0,
               wi_scale: Optional[torch.Tensor] = None,
               wo_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Routed-expert FFN of tokens (N, D) given their gating: the dispatch
    gather rides into the gate|up grouped GEMM as ``row_index`` and the
    combine unpermute out of the down GEMM as an ``out_index`` scatter.
    ``impl`` picks the kernel or the plain version (``kernels.ops``).

    ``wi``/``wo`` may hold a block of the experts, ``first_expert`` and
    on (``wi.shape[0]`` of them): pairs routed elsewhere then add 0, so
    the blocks' outputs sum to the whole FFN's (expert parallelism).
    With ``wi_scale``/``wo_scale`` (per expert, (E,)) the weights are int8
    codes and both GEMMs run the grouped GEMM's int8 mode."""
    n, d = tokens.shape
    sort_idx, group_sizes = sort_by_local_expert(topi, first_expert,
                                                 wi.shape[0])
    if wi_scale is None:
        wi, wo = wi.to(tokens.dtype), wo.to(tokens.dtype)
    h = kops.grouped_gemm(tokens, wi, group_sizes, impl=impl,
                          row_index=sort_idx // cfg.top_k, scales=wi_scale)
    ys = kops.grouped_gemm(_expert_ffn(cfg, h), wo, group_sizes, impl=impl,
                           out_index=sort_idx, out_rows=n * cfg.top_k,
                           scales=wo_scale)
    y = ys.reshape(n, cfg.top_k, d)
    return torch.einsum("nkd,nk->nd", y, topw.to(tokens.dtype))


def moe_sorted(params, cfg: ArchConfig, x: torch.Tensor,
               impl: Optional[str] = None) -> torch.Tensor:
    """Dropless MoE via sort + grouped GEMM. x: (..., D) → (..., D)."""
    x_flat = x.reshape(-1, x.shape[-1])
    _, topw, topi = route(params, cfg, x_flat)
    out = expert_ffn(cfg, params["wi"], params["wo"], x_flat, topw, topi,
                     impl)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], cfg, x_flat)
    return out.reshape(x.shape)


# Distributed strategy hook: ``parallel.ep`` installs its expert-parallel
# forward here; None means single-program execution.
_EP_FORWARD = None


def set_ep_forward(fn) -> None:
    global _EP_FORWARD
    _EP_FORWARD = fn


def moe_forward(params, cfg: ArchConfig, x: torch.Tensor,
                mode: str = "train", impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by phase: the capacity path for train and prefill, the
    sorted grouped-GEMM path for decode, or the installed EP hook.
    Returns (out, aux_loss)."""
    if _EP_FORWARD is not None:
        return _EP_FORWARD(params, cfg, x, mode, impl)
    if mode == "train":
        return moe_capacity(params, cfg, x)
    return (moe_sorted(params, cfg, x, impl),
            torch.zeros((), dtype=torch.float32, device=x.device))
