"""Plain PyTorch versions of the kernels.

Simple, obviously-right formulations with no tiling or online softmax:
the CPU path of every kernel wrapper, the oracle the CUDA kernels are held
against on the card, and the counterparts of ``repro.kernels.ref`` and of
the dense form of ``repro.kernels.ops.flash_prefill_attention``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import quant

MASK_VALUE = -1e30


def grouped_gemm_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """out[r] = lhs[r] @ rhs[group_of(r)] for group-sorted rows.

    lhs: (M, K), group g owns rows [offsets[g], offsets[g+1]); rhs:
    (G, K, N); group_sizes: (G,). Rows past sum(group_sizes) give zeros.
    Every row is multiplied by every expert in float32 and the right
    product is picked per row, so a row's arithmetic does not depend on
    how many rows share the call.
    """
    m, g = lhs.shape[0], rhs.shape[0]
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    rows = torch.arange(m, device=lhs.device)
    gid = torch.searchsorted(ends, rows, right=True)             # G = none
    prods = torch.matmul(lhs.float()[None], rhs.float())         # (G, M, N)
    out = prods[gid.clamp(max=g - 1), rows]
    out = torch.where((gid < g)[:, None], out, torch.zeros_like(out))
    return out.to(lhs.dtype if lhs.dtype == rhs.dtype else torch.float32)


def grouped_gemm_fused_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                           group_sizes: torch.Tensor,
                           row_index: Optional[torch.Tensor] = None,
                           out_index: Optional[torch.Tensor] = None,
                           out_rows: Optional[int] = None) -> torch.Tensor:
    """Explicit gather → ``grouped_gemm_ref`` → explicit scatter.

    GEMM row r consumes ``lhs[row_index[r]]`` and lands in
    ``out[out_index[r]]`` (destinations distinct); rows of ``out`` that
    no GEMM row targets are zero.
    """
    x = lhs if row_index is None else lhs[row_index.long()]
    y = grouped_gemm_ref(x, rhs, group_sizes)
    if out_index is None:
        return y
    n_out = y.shape[0] if out_rows is None else out_rows
    out = torch.zeros((n_out, y.shape[1]), dtype=y.dtype, device=y.device)
    out[out_index.long()] = y[:out_index.shape[0]]
    return out


def grouped_gemm_quant_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                           group_sizes: torch.Tensor, scales: torch.Tensor,
                           row_index: Optional[torch.Tensor] = None,
                           out_index: Optional[torch.Tensor] = None,
                           out_rows: Optional[int] = None) -> torch.Tensor:
    """Weight-only quantized grouped GEMM: dequantize the int8 codes
    (``scales`` (G,)) or packed int4 codes (``scales`` (G, N/block_n)) to
    float32, then ``grouped_gemm_fused_ref``; the output has lhs's dtype."""
    w = (quant.dequantize_experts(rhs, scales) if scales.ndim == 1
         else quant.dequantize_experts_int4(rhs, scales))
    return grouped_gemm_fused_ref(lhs, w, group_sizes, row_index, out_index,
                                  out_rows).to(lhs.dtype)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, group, T) float32 masked scores of one-token queries."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) / math.sqrt(d)
    mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    return torch.where(mask[:, None, None, :], scores,
                       torch.full_like(scores, MASK_VALUE))


def splitkv_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, return_lse: bool = False):
    """One-token GQA attention over the valid prefix ``[0, lengths[b])``.

    q: (B, Hq, d); k, v: (B, T, Hkv, d); lengths: (B,). Returns
    (B, Hq, d) in q's dtype, plus the (B, Hq) float32 log-sum-exp when
    ``return_lse``. float32 softmax, no online trick.
    """
    b, hq, d = q.shape
    scores = _grouped_scores(q, k, lengths)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v.float())
    out = out.reshape(b, hq, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).reshape(b, hq)
    return out


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0,
                      t_valid: Optional[int] = None) -> torch.Tensor:
    """Dense masked GQA attention (B, S, Hq, d) × (B, T, Hkv, d).

    Query row j sits at absolute position ``q_offset + j``; only the first
    ``t_valid`` KV slots hold keys. float32 scores and softmax.
    """
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    rows = q_offset + torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if t_valid is not None:
        mask = mask & (cols < t_valid)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (rows - cols < window)
    scores = torch.where(mask, scores, torch.full_like(scores, MASK_VALUE))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def moe_ffn_ref(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
                w_out: torch.Tensor, top_k: int, renorm: bool = True,
                shared_in: Optional[torch.Tensor] = None,
                shared_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-token MoE oracle: loop over the k slots with a dense gather.

    x: (N, D); router_w: (D, E); w_in: (E, D, 2M) fused gate|up;
    w_out: (E, M, D). Dropless by construction.
    """
    xf = x.float()
    probs = torch.softmax(xf @ router_w.float(), dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)
    if renorm:
        topw = topw / topw.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for slot in range(top_k):
        wi = w_in[topi[:, slot]].float()
        wo = w_out[topi[:, slot]].float()
        gate, up = torch.einsum("nd,ndf->nf", xf, wi).chunk(2, dim=-1)
        h = torch.nn.functional.silu(gate) * up
        out = out + topw[:, slot:slot + 1] * torch.einsum("nf,nfd->nd", h, wo)
    if shared_in is not None:
        gate, up = (xf @ shared_in.float()).chunk(2, dim=-1)
        out = out + (torch.nn.functional.silu(gate) * up) @ shared_out.float()
    return out.to(x.dtype)
