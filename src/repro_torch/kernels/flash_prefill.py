"""Wrapper of the flash-prefill CUDA kernel (``csrc/flash_prefill.cu``).

    out (B, S, Hq, d) = flash_prefill(q (B, S, Hq, d), k/v (B, T, Hkv, d))

Query row j sits at absolute position ``q_offset + j``; only the first
``t_valid`` KV slots hold keys. bf16 runs on the tensor cores (the q heads
that share a kv head packed into the rows of one block), float32 on the
CUDA cores. On a CPU tensor the wrapper returns the plain version
(``ref.flash_prefill_ref``); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# Kernel launches since the last reset (the main-path check reads it).
launches = 0

_FN = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_prefill").rt_flash_prefill
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0,
                  t_valid: Optional[int] = None) -> torch.Tensor:
    if not q.is_cuda:
        return _ref.flash_prefill_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, t_valid=t_valid)
    global launches
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill takes f32/bf16 q, k, v of one dtype")
    if k.shape != (b, t, hkv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form GQA attention")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for x in (k, v):
        if not x.is_cuda or x.device != q.device:
            raise ValueError("q, k, v must be on one CUDA device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_prefill's bf16 kernel copies 16-byte chunks: "
                         "q, k and v must start on 16-byte boundaries")
    tv = t if t_valid is None else max(0, min(int(t_valid), t))
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, hq, hkv, d, int(causal),
                0 if window is None else int(window), int(q_offset), tv,
                1.0 / math.sqrt(d), _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill")
    launches += 1
    return out
