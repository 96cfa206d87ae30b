"""Decoder stack assembly. Counterpart of ``repro.models.transformer``.

Layer structure (pre-norm residual):
    x += mixer(norm1(x))         mixer ∈ {attention, mamba2}
    x += cross_attn(norm_x(x))   (enc-dec only)
    x += ffn(norm2(x))           ffn ∈ {dense MLP, MoE, none (pure SSM)}

The stack is a Python loop over the flat per-layer list (``params
["layers"]``). JAX factors depth into an unrolled prefix plus a scanned
period to keep its compiled program small; eager PyTorch runs each layer
as it comes, so there is no scan and ``force_unroll`` has nothing to act
on here. ``cfg.remat`` keeps JAX's meaning, a rematerialised forward
(``jax.checkpoint`` of each scanned period): in train mode with autograd
on, each layer runs under ``torch.utils.checkpoint`` and keeps only its
inputs, recomputing its activations in the backward pass. The gradients
are the same; only the memory changes.

``impl`` (as in ``kernels.ops``: None picks by device, ``"plain"`` forces
the plain versions) reaches the two kernels of the decode step: split-KV
attention on full KV caches and the grouped GEMM of the sorted MoE.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.common import ArchConfig, LayerSpec
from repro_torch.models.layers import apply_mlp, apply_norm


def has_ffn(cfg: ArchConfig, spec: LayerSpec) -> bool:
    return spec.moe or cfg.d_ff > 0


def _residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's placement on DTensors: the batch split as it
    came (the data-parallel axes), every other dim whole on every rank. A
    sum left partial over "model" by a row-split projection is all-reduced
    here, as XLA's partitioner does after JAX's output projections, and a
    sequence split that the sequence-parallel rules' annotations made is
    gathered: the norms run on the whole sequence. The gradient gets the
    same placement. Plain tensors pass unchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x

    def canonical(t):
        pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in t.placements]
        return t if pl == list(t.placements) else t.redistribute(
            t.device_mesh, pl)

    x = canonical(x)
    if x.requires_grad:         # and so is its gradient
        x.register_hook(canonical)
    return x


def layer_forward(params, cfg: ArchConfig, spec: LayerSpec, x: torch.Tensor,
                  *, mode: str, positions: Optional[torch.Tensor] = None,
                  cache=None, pos: Optional[torch.Tensor] = None,
                  cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  impl: Optional[str] = None):
    """Apply one layer in ``mode`` "train", "prefill" or "decode". Returns
    (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(params["ln1"], cfg, x)
    if spec.kind == "attn":
        if mode == "decode":
            mix, new_cache = attn.attention_decode(params["attn"], cfg, h,
                                                   cache, pos, impl=impl)
        else:
            mix, new_cache = attn.attention_prefill(params["attn"], cfg, h,
                                                    positions, cache)
    elif mode == "decode":
        mix, new_cache = mamba2.mamba_decode(params["mamba"], cfg, h, cache)
    else:
        mix, new_cache = mamba2.mamba_prefill(params["mamba"], cfg, h, cache)
    x = _residual(x + mix)

    if spec.kind == "attn" and cfg.is_encdec and cross_kv is not None:
        h = apply_norm(params["ln_cross"], cfg, x)
        x = _residual(x + attn.cross_attention(params["cross"], cfg, h,
                                               *cross_kv))

    if has_ffn(cfg, spec):
        h = apply_norm(params["ln2"], cfg, x)
        if spec.moe:
            out, aux = moe.moe_forward(
                params["moe"], cfg, h,
                mode="train" if mode in ("train", "prefill") else "decode",
                impl=impl)
        else:
            out = apply_mlp(params["mlp"], cfg, h)
        x = _residual(x + out)
    return x, new_cache, aux


def stack_forward(params, cfg: ArchConfig, x: torch.Tensor, *, mode: str,
                  positions: Optional[torch.Tensor] = None,
                  cache: Optional[Dict[str, object]] = None,
                  pos: Optional[torch.Tensor] = None,
                  cross_kv: Optional[List] = None,
                  impl: Optional[str] = None):
    """Run every layer of ``params["layers"]``, then the final norm.
    ``cache["layers"]`` and ``cross_kv`` hold one entry per layer. Returns
    (x, new_cache or None, aux_total); the new cache is a new dict whose
    attention entries were updated in place and whose Mamba entries are
    new."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_layers: List = []
    run = layer_forward
    if cfg.remat and mode == "train" and torch.is_grad_enabled():
        run = functools.partial(torch.utils.checkpoint.checkpoint,
                                layer_forward, use_reentrant=False)
    x = _residual(x)
    for i, spec in enumerate(cfg.layer_plan().flat()):
        x, nc, aux = run(
            params["layers"][i], cfg, spec, x, mode=mode,
            positions=positions,
            cache=cache["layers"][i] if cache is not None else None,
            pos=pos, cross_kv=cross_kv[i] if cross_kv is not None else None,
            impl=impl)
        new_layers.append(nc)
        aux_total = aux_total + aux
    x = apply_norm(params["final_norm"], cfg, x)
    new_cache = None
    if cache is not None:
        new_cache = {**cache, "layers": new_layers}
    return x, new_cache, aux_total


# ---------------------------------------------------------------------------
# Whisper-style encoder (the frontend is a stub: inputs are frame embeddings)
# ---------------------------------------------------------------------------

def encoder_config(cfg: ArchConfig) -> ArchConfig:
    """The encoder twin: bidirectional attention, no cache, no MoE."""
    return dataclasses.replace(
        cfg, n_layers=cfg.n_encoder_layers, n_experts=0, top_k=0,
        n_encoder_layers=0, sliding_window=None, causal=False)


def encode(params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, encoder_seq, D) precomputed stub embeddings; params: the
    model's ``"encoder"`` entry."""
    ecfg = encoder_config(cfg)
    dt = cfg.compute_dtype
    x = frames.to(dt) + params["pos"][None].to(dt)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, _, _ = stack_forward(params, ecfg, x, mode="train",
                            positions=positions)
    return x
