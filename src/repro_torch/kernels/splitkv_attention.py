"""Wrapper of the split-KV decode CUDA kernel
(``csrc/splitkv_attention.cu``).

    out (B, Hq, d) = splitkv_attention(q (B, Hq, d), k/v (B, T, Hkv, d),
                                       lengths (B,))

over the valid prefix ``[0, lengths[b])``, plus the (B, Hq) float32
log-sum-exp when ``return_lse``. On a CPU tensor the wrapper returns the
plain version (``ref.splitkv_attention_ref``); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# Kernel launches since the last reset (the main-path check reads it).
launches = 0

_FN = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
PART = 64          # keys per warp part (csrc/splitkv_attention.cu)
MAX_GROUP = 8


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("splitkv_attention").rt_splitkv_attention
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def splitkv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, return_lse: bool = False):
    if not q.is_cuda:
        return _ref.splitkv_attention_ref(q, k, v, lengths,
                                          return_lse=return_lse)
    global launches
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("splitkv_attention takes f32/bf16 q, k, v of one dtype")
    if k.shape != (b, t, hkv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form GQA decode")
    if d not in HEAD_DIMS or hq // hkv > MAX_GROUP:
        raise ValueError(f"head dim {d} must be in {HEAD_DIMS} and the "
                         f"query group ≤ {MAX_GROUP}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},)")
    for x in (k, v, lengths):
        if not x.is_cuda or x.device != q.device:
            raise ValueError("q, k, v, lengths must be on one CUDA device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    n_parts = -(-t // PART)
    group = hq // hkv
    part_acc = torch.empty((b, hkv, n_parts, group, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hkv, n_parts, group, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                b, t, hq, hkv, d, n_parts, 1.0 / math.sqrt(d),
                _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "splitkv_attention")
    launches += 1
    return (out, lse) if return_lse else out
