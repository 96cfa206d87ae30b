"""Front door of the kernels: the counterpart of ``repro.kernels.ops``.

Every op has two implementations:

  * ``cuda``  — the hand-written Hopper kernel (CUDA tensors only);
  * ``plain`` — the plain PyTorch version in ``kernels/ref.py``.

``impl=None`` picks by where the tensors lie: CUDA tensors go to the
kernel, CPU tensors to the plain version. ``impl="plain"`` on CUDA tensors
is an explicit request (the end-to-end path check of ``chip_smoke.py``);
``impl="cuda"`` on CPU tensors raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import splitkv_attention as _skv

IMPLS = ("cuda", "plain")


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "plain"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def grouped_gemm(lhs: torch.Tensor, rhs: torch.Tensor,
                 group_sizes: torch.Tensor, impl: Optional[str] = None,
                 row_index: Optional[torch.Tensor] = None,
                 out_index: Optional[torch.Tensor] = None,
                 out_rows: Optional[int] = None,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r] = lhs[r] @ rhs[group_of(r)] for group-sorted rows.

    lhs: (M, K); rhs: (G, K, N); group_sizes: (G,) summing to ≤ M
    (surplus rows give zeros). ``row_index``/``out_index``/``out_rows``
    fuse the router permute: row r consumes ``lhs[row_index[r]]`` and
    lands in ``out[out_index[r]]``. ``scales`` makes ``rhs`` weight-only
    quantized: (G,) for int8 codes (G, K, N), (G, N/block_n) for int4
    codes packed two per byte along K (G, K/2, N); the output then has
    lhs's dtype.
    """
    if resolve_impl(impl, lhs) == "plain":
        return _gg.plain(lhs, rhs, group_sizes, row_index, out_index,
                         out_rows, scales)
    return _gg.grouped_gemm(lhs, rhs, group_sizes, row_index=row_index,
                            out_index=out_index, out_rows=out_rows,
                            scales=scales)


def splitkv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, impl: Optional[str] = None,
                      return_lse: bool = False):
    """One-token GQA attention with per-batch valid lengths.

    q: (B, Hq, d); k, v: (B, T, Hkv, d); lengths: (B,) int32 or int64,
    each clamped to [0, T].
    """
    if resolve_impl(impl, q) == "plain":
        return _ref.splitkv_attention_ref(q, k, v, lengths,
                                          return_lse=return_lse)
    return _skv.splitkv_attention(q, k, v, lengths, return_lse=return_lse)


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None,
                            impl: Optional[str] = None, q_offset: int = 0,
                            t_valid: Optional[int] = None) -> torch.Tensor:
    """Prefill attention (B, S, Hq, d) against a (B, T, Hkv, d) cache:
    query row j at absolute position ``q_offset + j``, the first
    ``t_valid`` KV slots live."""
    if resolve_impl(impl, q) == "plain":
        return _ref.flash_prefill_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, t_valid=t_valid)
    return _fp.flash_prefill(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, t_valid=t_valid)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {"grouped_gemm": _gg.launches,
            "grouped_gemm_int8": _gg.launches_int8,
            "grouped_gemm_int4": _gg.launches_int4,
            "flash_prefill": _fp.launches,
            "splitkv_attention": _skv.launches}


def reset_launch_counts() -> None:
    _gg.launches = 0
    _gg.launches_int8 = 0
    _gg.launches_int4 = 0
    _fp.launches = 0
    _skv.launches = 0
