"""Basic layers: norms, rotary embeddings, activations, dense MLP,
embeddings. Counterpart of ``repro.models.layers``: functions
``f(params, cfg, x, ...)`` on nested dicts of tensors, weights laid out
``(in, out)`` and applied as ``x @ w``; reductions in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ArchConfig, dense_init, embed_init,
                                       gathered, rows_whole, shard)


def init_norm(cfg: ArchConfig, device) -> Dict[str, torch.Tensor]:
    """Norm scale of ones (and a zero bias for LayerNorm archs)."""
    d, dt = cfg.d_model, cfg.params_dtype
    p = {"scale": torch.ones(d, dtype=dt, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dt, device=device)
    return p


def apply_norm(params, cfg: ArchConfig, x: torch.Tensor,
               eps: Optional[float] = None) -> torch.Tensor:
    eps = eps if eps is not None else cfg.rms_eps
    xf = x.float()
    if cfg.norm_type == "layernorm" and "bias" in params:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def rmsnorm_1d(scale: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim with a raw scale vector (qk-norm)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2 gated RMSNorm: norm(x * silu(z)) * scale, in float32."""
    xf = x.float() * F.silu(z.float())
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rope_frequencies(d_head: int, theta: float, device) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, d_head); positions broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs             # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def init_mlp(seed: int, name: str, cfg: ArchConfig, device,
             d_ff: int) -> Dict[str, torch.Tensor]:
    """Gated MLP params: fused [gate; up] ``wi`` (D, 2F) and ``wo`` (F, D).
    For gelu archs (whisper) the layer is a plain two-matrix MLP with
    biases: ``wi`` (D, F), ``bi``, ``wo``, ``bo``."""
    D = cfg.d_model
    gated = cfg.act != "gelu"
    p = {"wi": dense_init(seed, f"{name}.wi",
                          (D, 2 * d_ff if gated else d_ff),
                          cfg.params_dtype, device, fan_in=D),
         "wo": dense_init(seed, f"{name}.wo", (d_ff, D), cfg.params_dtype,
                          device, fan_in=d_ff)}
    if not gated:
        p["bi"] = torch.zeros(d_ff, dtype=cfg.params_dtype, device=device)
        p["bo"] = torch.zeros(D, dtype=cfg.params_dtype, device=device)
    return p


def apply_mlp(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP: fused [gate; up] projection, activation, down."""
    h = rows_whole(x) @ gathered(params["wi"]).to(x.dtype)
    if "bi" in params:
        h = activation(cfg, h + params["bi"].to(x.dtype))
    else:
        gate, up = h.chunk(2, dim=-1)
        h = activation(cfg, gate) * up
    h = shard(h, "batch", "seq", "mlp")
    wo = gathered(params["wo"])
    out = rows_whole(h, wo) @ wo.to(x.dtype)
    if "bo" in params:
        out = out + params["bo"].to(x.dtype)
    return out


def init_embedding(seed: int, cfg: ArchConfig,
                   device) -> Dict[str, torch.Tensor]:
    """Token table, plus a learned position table of
    ``max_decode_positions()`` rows for archs without RoPE (whisper)."""
    p = {"tok": embed_init(seed, "embed.tok", (cfg.vocab_size, cfg.d_model),
                           cfg.params_dtype, device)}
    if not cfg.use_rope:
        p["pos"] = embed_init(seed, "embed.pos",
                              (cfg.max_decode_positions(), cfg.d_model),
                              cfg.params_dtype, device)
    return p


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``. On a DTensor table (the sharded step) each rank
    looks its indices up in its block (``collectives.spmd_map``): rows
    split over "model" (the vocabulary) are taken where they are held and
    summed over "model" (the vocab-parallel embedding), other rows are
    read whole; the result is split over the batch as ``idx`` is.
    DTensor's own indexing rules are not used: their backward fails on
    some torch versions."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[idx]
    from repro_torch.parallel import collectives as coll
    mesh = table.device_mesh
    names = list(mesh.mesh_dim_names)
    split = "model" in names and isinstance(
        table.placements[names.index("model")], Shard)
    tab_pl = tuple(Shard(0) if split and n == "model" else Replicate()
                   for n in names)
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * len(names),
                                 run_check=False)
    idx_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in idx.placements)

    def local(tab, ix):
        if not split:
            return (tab[ix],)
        v_l = tab.shape[0]
        j = ix - mesh.get_local_rank("model") * v_l
        rows = tab[j.clamp(0, v_l - 1)]
        rows = torch.where(((j >= 0) & (j < v_l))[..., None], rows,
                           torch.zeros_like(rows))
        return (coll.all_reduce_sum(rows, mesh.get_group("model")),)

    return coll.spmd_map(local, mesh, (tab_pl, idx_pl), (idx_pl,))(
        table, idx)[0]


def embed_tokens(params, cfg: ArchConfig, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = lookup(params["tok"], tokens.long()).to(cfg.compute_dtype)
    if "pos" in params and positions is not None:
        cap = params["pos"].shape[0]
        x = x + lookup(params["pos"], positions.long().clamp(0, cap - 1)).to(
            cfg.compute_dtype)
    return shard(x, "batch", "seq", "embed")


def init_lm_head(seed: int, cfg: ArchConfig,
                 device) -> Dict[str, torch.Tensor]:
    """Untied head (D, V); a tied head has no parameters of its own."""
    if cfg.tie_embeddings:
        return {}
    return {"w": dense_init(seed, "lm_head.w", (cfg.d_model, cfg.vocab_size),
                            cfg.params_dtype, device, fan_in=cfg.d_model)}


def apply_lm_head(head_params, embed_params, cfg: ArchConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """Logits in float32. A tied head reads ``embed.tok`` transposed unless
    the caller put a contiguous (D, V) copy in ``head_params["w"]``."""
    w = head_params.get("w")
    if w is None:
        w = embed_params["tok"].T
    return shard((rows_whole(x) @ gathered(w).to(x.dtype)).float(), "batch",
                 "seq", "vocab")
