"""Wrapper of the grouped-GEMM CUDA kernel (``csrc/grouped_gemm.cu``).

    out (M, N) = grouped_gemm(lhs (M, K), rhs (G, K, N), group_sizes (G,))

with the fused router permute: ``row_index`` (M,) makes GEMM row r read
``lhs[row_index[r]]`` and ``out_index`` (M,) sends it to
``out[out_index[r]]`` of an ``out_rows``-row output whose other rows are 0.
On a CPU tensor the wrapper returns the plain version
(``ref.grouped_gemm_fused_ref``); on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# Kernel launches since the last reset (the main-path check reads it).
launches = 0

_FN = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("grouped_gemm").rt_grouped_gemm
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _index(idx: torch.Tensor, m: int, name: str) -> torch.Tensor:
    if idx.shape != (m,):
        raise ValueError(f"{name} must have shape ({m},), got {tuple(idx.shape)}")
    return idx.to(torch.int32).contiguous()


def grouped_gemm(lhs: torch.Tensor, rhs: torch.Tensor,
                 group_sizes: torch.Tensor,
                 row_index: Optional[torch.Tensor] = None,
                 out_index: Optional[torch.Tensor] = None,
                 out_rows: Optional[int] = None) -> torch.Tensor:
    if not lhs.is_cuda:
        return _ref.grouped_gemm_fused_ref(lhs, rhs, group_sizes, row_index,
                                           out_index, out_rows)
    global launches
    if lhs.dtype not in _DTYPES or rhs.dtype != lhs.dtype:
        raise TypeError(f"grouped_gemm takes f32/bf16 lhs and rhs of one "
                        f"dtype, got {lhs.dtype} and {rhs.dtype}")
    if lhs.ndim != 2 or rhs.ndim != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(f"shapes lhs {tuple(lhs.shape)} / rhs "
                         f"{tuple(rhs.shape)} are not (M, K) / (G, K, N)")
    g, k, n = rhs.shape
    if group_sizes.shape != (g,):
        raise ValueError(f"group_sizes must be ({g},)")
    if n % 8:
        raise ValueError(f"N={n} must be a multiple of 8 (16-byte loads)")
    for t in (lhs, rhs, group_sizes):
        if not t.is_cuda or t.device != lhs.device:
            raise ValueError("all grouped_gemm operands must be on one CUDA device")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("grouped_gemm needs contiguous lhs and rhs")
    if rhs.data_ptr() % 16:
        raise ValueError("rhs must be 16-byte aligned")
    m = lhs.shape[0] if row_index is None else row_index.shape[0]
    ri = None if row_index is None else _index(row_index, m, "row_index")
    oi = None if out_index is None else _index(out_index, m, "out_index")
    n_out = m if out_index is None or out_rows is None else int(out_rows)
    offsets = torch.zeros(g + 1, dtype=torch.int32, device=lhs.device)
    offsets[1:] = torch.cumsum(group_sizes, 0)
    out = torch.zeros((n_out, n), dtype=lhs.dtype, device=lhs.device)
    err = _fn()(lhs.data_ptr(), rhs.data_ptr(), offsets.data_ptr(),
                None if ri is None else ri.data_ptr(),
                None if oi is None else oi.data_ptr(), out.data_ptr(),
                m, k, n, g, lhs.shape[0], n_out, _DTYPES[lhs.dtype],
                torch.cuda.current_stream(lhs.device).cuda_stream)
    _build.check(err, "grouped_gemm")
    launches += 1
    return out
