"""Wrapper of the split-KV decode CUDA kernel
(``csrc/splitkv_attention.cu``).

    out (B, Hq, d) = splitkv_attention(q (B, Hq, d), k/v (B, T, Hkv, d),
                                       lengths (B,))

over the valid prefix ``[0, lengths[b])`` (each length clamped to
``[0, T]``), plus the (B, Hq) float32 log-sum-exp when ``return_lse``. A
sequence with no live key gives the mean of v over all T slots and LSE
-1e30. One launch per call: one block per (split, kv head, sequence), and
the last block of a (sequence, kv head) combines the splits' partials.
``lengths`` is read as given when int32 or int64. On a CPU tensor the
wrapper returns the plain version (``ref.splitkv_attention_ref``); on a
CUDA tensor it launches the kernel or raises.

The kernel's workspace (the splits' partials and the per-(sequence, kv
head) arrival counters, which the kernel leaves at 0) is kept per device
and grown when a call needs more, so calls on one device must be ordered
on one stream, as PyTorch's current stream orders them. A CUDA graph that
captured the kernel keeps the workspace it was captured with
(``workspace_tensors``), which a later growth would otherwise free.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# Kernel launches since the last reset (the main-path check reads it).
launches = 0

_FN = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128)
GROUPS = (1, 2, 4, 8)
# csrc/splitkv_attention.cu: a split's K and V tiles take at most
# KV_TILE_BYTES of shared memory and it holds at most SPLIT_CAP keys, a
# multiple of SPLIT_ALIGN
KV_TILE_BYTES = 64 * 1024
SPLIT_CAP = 256
SPLIT_ALIGN = 16
# blocks over the whole cache, per SM: the live prefix is a fraction of T
WAVES = 4

# device index -> (counters int32, partial accumulators f32, partial (m, l))
_WORK: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("splitkv_attention").rt_splitkv_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def max_split(d: int, elem_bytes: int) -> int:
    """The longest split the kernel takes for head dim ``d``."""
    fit = KV_TILE_BYTES // (2 * d * elem_bytes) // SPLIT_ALIGN * SPLIT_ALIGN
    return min(SPLIT_CAP, fit)


def plan_splits(b: int, hkv: int, t: int, n_sm: int,
                most: int) -> Tuple[int, int]:
    """(split, n_splits): keys per block and blocks per (sequence, kv
    head), so that the whole cache makes ``WAVES`` blocks per SM, with the
    split a multiple of 16 in [16, ``most``]. Split i covers keys
    ``[i * split, min((i + 1) * split, t))``."""
    want = -(-t * b * hkv // (WAVES * n_sm))
    split = -(-want // SPLIT_ALIGN) * SPLIT_ALIGN
    split = max(SPLIT_ALIGN, min(most, split))
    return split, -(-t // split)


def _workspace(dev: torch.device, streams: int, parts: int, d: int):
    """The device's counters (zeroed once, grown with B·Hkv) and room for
    ``parts`` partials of d columns and (m, l): (counters, acc, ml)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    cnt, acc, ml = _WORK.get(idx, (None, None, None))
    if cnt is None or cnt.numel() < streams:
        cnt = torch.zeros(streams, dtype=torch.int32, device=dev)
    if acc is None or acc.numel() < parts * d:
        acc = torch.empty(parts * d, dtype=torch.float32, device=dev)
    if ml is None or ml.numel() < parts * 2:
        ml = torch.empty(parts * 2, dtype=torch.float32, device=dev)
    _WORK[idx] = (cnt, acc, ml)
    return cnt, acc, ml


def workspace_tensors() -> List[torch.Tensor]:
    """Every device's workspace tensors as they are now."""
    return [t for ws in _WORK.values() for t in ws]


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
    group = hq // hkv
    if d not in HEAD_DIMS or group not in GROUPS:
        raise ValueError(f"head dim {d} must be in {HEAD_DIMS} and the "
                         f"query group {group} in {GROUPS}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},)")
    for x in (k, v, lengths):
        if not x.is_cuda or x.device != q.device:
            raise ValueError("q, k, v, lengths must be on one CUDA device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    if lengths.dtype not in (torch.int32, torch.int64):
        lengths = lengths.to(torch.int32)
    lengths = lengths.contiguous()
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    split, n_splits = plan_splits(b, hkv, t, n_sm,
                                  max_split(d, q.element_size()))
    cnt, acc, ml = _workspace(q.device, b * hkv, b * hkv * n_splits * group,
                              d)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                int(lengths.dtype == torch.int64), acc.data_ptr(),
                ml.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                b, t, hq, hkv, d, split, n_splits, 1.0 / math.sqrt(d),
                _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "splitkv_attention")
    launches += 1
    return (out, lse) if return_lse else out
