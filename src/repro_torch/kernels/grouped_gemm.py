"""Wrapper of the grouped-GEMM CUDA kernel (``csrc/grouped_gemm.cu``).

    out (M, N) = grouped_gemm(lhs (M, K), rhs (G, K, N), group_sizes (G,))

with the fused router permute: ``row_index`` (M,) makes GEMM row r read
``lhs[row_index[r]]`` and ``out_index`` (M,) of distinct destinations sends
it to ``out[out_index[r]]`` of an ``out_rows``-row output whose other rows
are 0.

Weight-only quantization, chosen by ``scales`` as in
``repro.kernels.grouped_gemm``:

  * ``scales`` (G,)   — int8 codes in ``rhs`` (G, K, N), per-expert scale;
  * ``scales`` (G, B) — int4 codes packed two per int8 along K in ``rhs``
    (G, K/2, N), low nibble = even k, one scale per (expert, N-block of
    N / B columns).

With bf16 activations the kernel runs on the tensor cores: it copies the
codes, turns them into bf16 fragments (every int8 and int4 code is exact in
bf16) and applies the per-column scale in the epilogue, ``scale · Σ x·code``;
with float32 activations it dequantises each weight tile as it stages it,
``x · (float(code) · scale)``. Both accumulate in float32; the output has
lhs's dtype.
The quantization helpers (``kernels.quant``, re-exported here) use the JAX
package's layout and rounding, so weights quantized there load unchanged.

With bf16 activations the tiling (rows per pass, output columns per
block, reduction depth per stage) is a choice among ``TILINGS``, the ones
the kernel is built for (``GG_TILINGS`` in the source; the first is the
default). They cut only rows and columns, never the order in which K is
summed, so every tiling gives the same bits in every weight mode (the
quantized modes scale per column in the epilogue). Float32 activations
keep the CUDA-core kernel's own fixed tiling. Any other tiling is refused
by the kernel (``cudaErrorInvalidValue``) and the wrapper raises.

On a CPU tensor the wrapper returns the plain version
(``ref.grouped_gemm_fused_ref`` / ``ref.grouped_gemm_quant_ref``), which
has no tiling; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.quant import (  # noqa: F401  (re-exported)
    dequantize_experts, dequantize_experts_int4, quantize_experts,
    quantize_experts_int4, unpack_experts_int4)

# Kernel launches since the last reset (the main-path check reads them),
# one count per weight mode.
launches = 0
launches_int8 = 0
launches_int4 = 0

_FN = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# weight modes of csrc/grouped_gemm.cu
DENSE, INT8, INT4 = 0, 1, 2
# (tile_m, tile_n, tile_k) of the bf16 kernel's instantiations, the default
# first: GG_TILINGS in csrc/grouped_gemm.cu (``kernel_tilings`` reads them
# back from the built library)
TILINGS: Tuple[Tuple[int, int, int], ...] = (
    (64, 64, 32),
    (16, 64, 64),
    (32, 64, 32),
    (16, 32, 64),
    (64, 32, 32),
    (128, 128, 32),
)
DEFAULT_TILING = TILINGS[0]


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("grouped_gemm").rt_grouped_gemm
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def kernel_tilings() -> Tuple[Tuple[int, int, int], ...]:
    """The tilings the built library takes, as it lists them."""
    fn = _build.load("grouped_gemm").rt_grouped_gemm_tilings
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_int * (3 * 64))()
    n = fn(ctypes.cast(buf, ctypes.c_void_p), 64)
    return tuple(tuple(buf[3 * i:3 * i + 3]) for i in range(n))


def _index(idx: torch.Tensor, m: int, name: str) -> torch.Tensor:
    """The index as the kernel reads it: int32 or int64 as given (no
    conversion launch on the main path's int64 sort order), else int32."""
    if idx.shape != (m,):
        raise ValueError(f"{name} must have shape ({m},), got {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int32)
    return idx.contiguous()


def weight_mode(lhs: torch.Tensor, rhs: torch.Tensor,
                scales: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(mode, block_n) of a call, with the JAX kernel's shape errors."""
    if lhs.ndim != 2 or rhs.ndim != 3:
        raise ValueError(f"shapes lhs {tuple(lhs.shape)} / rhs "
                         f"{tuple(rhs.shape)} are not (M, K) / (G, K, N)")
    k = lhs.shape[1]
    if scales is None:
        if rhs.shape[1] != k:
            raise ValueError(f"shapes lhs {tuple(lhs.shape)} / rhs "
                             f"{tuple(rhs.shape)} are not (M, K) / (G, K, N)")
        return DENSE, 0
    g, _, n = rhs.shape
    if rhs.dtype != torch.int8:
        raise TypeError(f"quantized rhs must hold int8 codes, got {rhs.dtype}")
    if scales.ndim == 1:
        if scales.shape != (g,) or rhs.shape[1] != k:
            raise ValueError(f"int8 weights take rhs (G, {k}, N) and scales "
                             f"(G,), got {tuple(rhs.shape)} and "
                             f"{tuple(scales.shape)}")
        return INT8, 0
    if rhs.shape[1] * 2 != k:
        raise ValueError(
            f"int4 rhs packs two codes per byte along K: expected "
            f"(G, {k}//2, N), got {tuple(rhs.shape)}")
    n_blocks = scales.shape[1]
    if scales.shape[0] != g or n_blocks < 1 or n % n_blocks:
        raise ValueError(
            f"int4 scales carry {n_blocks} N-blocks but N={n} does not tile "
            f"into them — quantize with block_n = N / scales.shape[1]")
    return INT4, n // n_blocks


def plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
          row_index: Optional[torch.Tensor] = None,
          out_index: Optional[torch.Tensor] = None,
          out_rows: Optional[int] = None,
          scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of a call, after the kernel's checks."""
    if weight_mode(lhs, rhs, scales)[0] == DENSE:
        return _ref.grouped_gemm_fused_ref(lhs, rhs, group_sizes, row_index,
                                           out_index, out_rows)
    return _ref.grouped_gemm_quant_ref(lhs, rhs, group_sizes, scales,
                                       row_index, out_index, out_rows)


def grouped_gemm(lhs: torch.Tensor, rhs: torch.Tensor,
                 group_sizes: torch.Tensor,
                 row_index: Optional[torch.Tensor] = None,
                 out_index: Optional[torch.Tensor] = None,
                 out_rows: Optional[int] = None,
                 scales: Optional[torch.Tensor] = None,
                 tiles: Tuple[int, int, int] = DEFAULT_TILING) -> torch.Tensor:
    """The kernel on CUDA tensors (the plain version on CPU tensors);
    ``tiles`` is the bf16 kernel's (tile_m, tile_n, tile_k)."""
    if not lhs.is_cuda:
        return plain(lhs, rhs, group_sizes, row_index, out_index, out_rows,
                     scales)
    mode, block_n = weight_mode(lhs, rhs, scales)
    global launches, launches_int8, launches_int4
    if lhs.dtype not in _DTYPES or (mode == DENSE and rhs.dtype != lhs.dtype):
        raise TypeError(f"grouped_gemm takes f32/bf16 lhs and rhs of one "
                        f"dtype (or int8 codes with scales), got {lhs.dtype} "
                        f"and {rhs.dtype}")
    g, k, n = rhs.shape[0], lhs.shape[1], rhs.shape[2]
    if group_sizes.shape != (g,):
        raise ValueError(f"group_sizes must be ({g},)")
    if n % (8 if mode == DENSE else 16):
        raise ValueError(f"N={n} must be a multiple of 8 (dense) or 16 "
                         f"(quantized) for 16-byte loads")
    operands = (lhs, rhs, group_sizes) + (() if scales is None else (scales,))
    for t in operands:
        if not t.is_cuda or t.device != lhs.device:
            raise ValueError("all grouped_gemm operands must be on one CUDA device")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("grouped_gemm needs contiguous lhs and rhs")
    if rhs.data_ptr() % 16:
        raise ValueError("rhs must be 16-byte aligned")
    sc = None if scales is None else scales.to(torch.float32).contiguous()
    m = lhs.shape[0] if row_index is None else row_index.shape[0]
    ri = None if row_index is None else _index(row_index, m, "row_index")
    oi = None if out_index is None else _index(out_index, m, "out_index")
    n_out = m if out_index is None or out_rows is None else int(out_rows)
    gs = group_sizes.to(torch.int32).contiguous()
    idx64 = (int(ri is not None and ri.dtype == torch.int64)
             | int(oi is not None and oi.dtype == torch.int64) << 1)
    # The kernel writes every destination, 0 for rows past
    # sum(group_sizes). Distinct destinations cover all of out when there is
    # no out_index or out_rows == M (a permutation, as the F role's combine
    # passes); only otherwise can rows of out be left untargeted, and out
    # starts at 0.
    covered = g > 0 and (oi is None or n_out == m)
    out = (torch.empty if covered else torch.zeros)(
        (n_out, n), dtype=lhs.dtype, device=lhs.device)
    err = _fn()(lhs.data_ptr(), rhs.data_ptr(),
                None if sc is None else sc.data_ptr(), gs.data_ptr(),
                None if ri is None else ri.data_ptr(),
                None if oi is None else oi.data_ptr(), idx64, out.data_ptr(),
                m, k, n, g, lhs.shape[0], n_out, _DTYPES[lhs.dtype], mode,
                block_n, *(int(t) for t in tiles),
                torch.cuda.current_stream(lhs.device).cuda_stream)
    _build.check(err, f"grouped_gemm (tiles {tuple(tiles)})")
    if mode == DENSE:
        launches += 1
    elif mode == INT8:
        launches_int8 += 1
    else:
        launches_int4 += 1
    return out
