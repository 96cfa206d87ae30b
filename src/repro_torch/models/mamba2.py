"""Mamba-2 (SSD, state-space duality) mixer: the O(1)-per-token decode
step the AFD serving path runs. Counterpart of ``repro.models.mamba2``'s
``init_mamba`` and ``mamba_decode``; the chunked SSD prefill
(``ssd_chunked``, ``ssd_sequential``, ``mamba_prefill``) belongs to the
single-program model, which the port does not carry yet. The AFD
runtime's chunked prefill steps ``mamba_decode`` over the chunk, as the
JAX runtime does.

Layout (the reference Mamba-2's):
  in_proj:  D → [z (d_inner) | xBC (d_inner + 2·g·n) | dt (heads)]
  conv:     depthwise causal conv over xBC, width ssm_conv
  heads:    d_inner = heads · head_dim; B/C shared across head groups (g)

Types follow the JAX step: the projections, the conv window and the
``D·x`` skip run in the activation dtype; ``dt``, its softplus,
``A = -exp(A_log)`` and the recurrent state are float32, and ``y`` is cast
to the activation dtype before the skip is added. ``A_log``, ``D`` and
``dt_bias`` are float32 whatever the parameter dtype. No kernel: the JAX
package has none for this layer, and its products are small einsums.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, dense_init
from repro_torch.models.layers import gated_rmsnorm


def init_mamba(seed: int, name: str, cfg: ArchConfig,
               device) -> Dict[str, torch.Tensor]:
    D, di, h, dt = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.params_dtype
    proj_out = 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + h
    f32 = torch.float32
    return {
        "in_proj": dense_init(seed, f"{name}.in_proj", (D, proj_out), dt,
                              device, fan_in=D),
        "conv_w": dense_init(seed, f"{name}.conv_w",
                             (cfg.ssm_conv, cfg.conv_dim), dt, device,
                             fan_in=cfg.ssm_conv),
        "conv_b": torch.zeros(cfg.conv_dim, dtype=dt, device=device),
        # A init in [1, 16) → A = -exp(log A) ∈ (-16, -1]
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "D": torch.ones(h, dtype=f32, device=device),
        "dt_bias": torch.zeros(h, dtype=f32, device=device),
        "norm": torch.ones(di, dtype=dt, device=device),
        "out_proj": dense_init(seed, f"{name}.out_proj", (di, D), dt, device,
                               fan_in=di),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn],
            zxbcdt[..., 2 * di + 2 * gn:])


def _split_xbc(cfg: ArchConfig, x_bc: torch.Tensor):
    di = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return x_bc[..., :di], x_bc[..., di:di + gn], x_bc[..., di + gn:]


def _broadcast_groups(cfg: ArchConfig, t: torch.Tensor) -> torch.Tensor:
    """(B, S, g·n) → (B, S, H, n) repeating each group over its heads."""
    bs, s, _ = t.shape
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return t.reshape(bs, s, g, n).repeat_interleave(h // g, dim=2)


def mamba_decode(params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1) stateful step. x: (B, 1, D); cache {"conv" (B, ssm_conv-1,
    conv_dim), "state" (B, H, P, N) float32}. Returns (out (B, 1, D), a
    new cache dict; the input cache is not modified)."""
    bs = x.shape[0]
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, x_bc_raw, dt_raw = _split_proj(cfg, zxbcdt)

    # conv ring step
    window = torch.cat([cache["conv"].to(x.dtype), x_bc_raw], dim=1)
    x_bc = torch.einsum("bkc,kc->bc", window, params["conv_w"].to(x.dtype))
    x_bc = F.silu(x_bc + params["conv_b"].to(x.dtype))[:, None]
    new_conv = window[:, 1:]

    xh, b, c = _split_xbc(cfg, x_bc)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])[:, 0]
    a = -torch.exp(params["A_log"])

    xheads = xh.reshape(bs, cfg.ssm_heads, cfg.ssm_head_dim)       # (B,H,P)
    bh = _broadcast_groups(cfg, b)[:, 0]                           # (B,H,N)
    ch = _broadcast_groups(cfg, c)[:, 0]

    da = torch.exp(dt * a[None, :])[..., None, None]               # (B,H,1,1)
    upd = ((dt[..., None] * xheads.float())[..., None]
           * bh.float()[:, :, None, :])
    state = cache["state"] * da + upd
    y = torch.einsum("bhpn,bhn->bhp", state, ch.float())
    y = y.to(x.dtype) + params["D"].to(x.dtype)[None, :, None] * xheads

    y = gated_rmsnorm(params["norm"], y.reshape(bs, 1, cfg.d_inner), z,
                      cfg.rms_eps)
    out = y @ params["out_proj"].to(y.dtype)
    return out, {"conv": new_conv.to(cache["conv"].dtype), "state": state}
