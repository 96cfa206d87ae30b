"""MoE routing: init, top-k router and the expert sort that feeds the
grouped GEMM. Counterpart of ``repro.models.moe`` (the routing half; the
expert FFN itself runs on the F role in ``parallel/afd.py``).

Routing is softmax-then-top-k with optional renormalisation of the gate
weights. The router weight stays float32, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import ArchConfig, dense_init
from repro_torch.models.layers import init_mlp


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
    group_sizes = torch.bincount(flat, minlength=n_experts).to(torch.int32)
    return sort_idx, inv_idx, group_sizes
