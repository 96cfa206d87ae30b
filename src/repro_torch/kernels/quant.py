"""Weight-only quantization of expert weights for the grouped GEMM: int8
per expert, and int4 per (expert, N-block) packed two codes per int8 along
K (low nibble = even k). Layout and rounding (half to even) are those of
``repro.kernels.grouped_gemm``, so weights quantized there load unchanged.
Plain PyTorch; the kernel wrapper and the plain reference both use it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_experts(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-expert symmetric int8 quantization: w ≈ codes · scale[g]."""
    wf = w.float()
    amax = wf.abs().amax(dim=(1, 2))
    scale = torch.clamp(amax, min=1e-8) / 127.0
    codes = torch.clamp(torch.round(wf / scale[:, None, None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_experts(codes: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Exact float form of the int8 codes the kernel sees."""
    return codes.float() * scale.float()[:, None, None]


def quantize_experts_int4(w: torch.Tensor, block_n: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 quantization, two codes packed per int8 along K.

    w: (G, K, N) with K even and N a multiple of ``block_n``. Returns
    ``(packed (G, K//2, N) int8, scales (G, N//block_n) f32)`` where
    ``w ≈ codes · scales[g, n // block_n]`` and codes ∈ [-7, 7].
    """
    g, k, n = w.shape
    if k % 2:
        raise ValueError(f"int4 packing needs an even K, got {k}")
    if n % block_n:
        raise ValueError(f"N={n} must be a multiple of block_n={block_n}")
    wf = w.float().reshape(g, k, n // block_n, block_n)
    amax = wf.abs().amax(dim=(1, 3))                          # (G, N/block)
    scale = torch.clamp(amax, min=1e-8) / 7.0
    codes = torch.clamp(torch.round(wf / scale[:, None, :, None]), -7, 7
                        ).to(torch.int32).reshape(g, k, n)
    lo = codes[:, 0::2] & 0xF
    hi = codes[:, 1::2] & 0xF
    packed = lo | (hi << 4)                                   # [0, 255]
    return ((packed ^ 128) - 128).to(torch.int8), scale       # two's complement


def unpack_experts_int4(packed: torch.Tensor) -> torch.Tensor:
    """(G, K//2, N) packed nibbles → (G, K, N) int32 codes."""
    g, kh, n = packed.shape
    w32 = packed.to(torch.int32) & 0xFF
    lo = ((w32 & 0xF) ^ 8) - 8
    hi = (((w32 >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], dim=2).reshape(g, 2 * kh, n)


def dequantize_experts_int4(packed: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """Exact float form of the packed int4 codes the kernel sees."""
    codes = unpack_experts_int4(packed)
    g, k, n = codes.shape
    blocks = scale.shape[1]
    cf = codes.float().reshape(g, k, blocks, n // blocks)
    return (cf * scale.float()[:, None, :, None]).reshape(g, k, n)
