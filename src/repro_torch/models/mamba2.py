"""Mamba-2 (SSD, state-space duality) mixer. Counterpart of
``repro.models.mamba2``, with its two execution paths:

  * ``mamba_prefill`` — the chunked SSD algorithm (``ssd_chunked``: the
    block-diagonal "attention-like" term inside each chunk plus the
    low-rank state carried between chunks), which also returns the final
    recurrent state for the cache. The single-program model's prefill and
    forward run it;
  * ``mamba_decode`` — the O(1)-per-token recurrence: conv tail plus SSM
    state update. The AFD runtime's chunked prefill steps it over the
    chunk, as the JAX runtime does.

``ssd_sequential`` is the per-step recurrence that ``ssd_chunked`` is held
to.

Layout (the reference Mamba-2's):
  in_proj:  D → [z (d_inner) | xBC (d_inner + 2·g·n) | dt (heads)]
  conv:     depthwise causal conv over xBC, width ssm_conv
  heads:    d_inner = heads · head_dim; B/C shared across head groups (g)

Types follow JAX: the projections, the conv and the ``D·x`` skip run in
the activation dtype; ``dt``, its softplus, ``A = -exp(A_log)``, the SSD
products and the recurrent state are float32, and ``y`` is cast to the
activation dtype before the skip is added. ``A_log``, ``D`` and
``dt_bias`` are float32 whatever the parameter dtype. No kernel: the JAX
package has none for this layer.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, dense_init, gathered
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


def causal_conv(cfg: ArchConfig, x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C), width ``cfg.ssm_conv``."""
    pad = cfg.ssm_conv - 1
    s = x.shape[1]
    xp = F.pad(x, (0, 0, pad, 0))
    acc = torch.zeros_like(x)
    for i in range(cfg.ssm_conv):
        acc = acc + xp[:, i:i + s] * w[i].to(x.dtype)
    return acc + b.to(x.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = x[..., j+1] + ... + x[..., i]
    on and below the diagonal, -inf above it."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, one chunk at a time (a Python loop in place of JAX's
    ``lax.scan``).

    x: (B, S, H, P) head inputs; dt: (B, S, H), already softplus'd;
    a: (H,) negative decay rates; b, c: (B, S, H, N), group-broadcast.
    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, P, N) float32).
    S must be a multiple of ``chunk``.

    JAX writes each chunk as 3- and 4-operand einsums. Here every product
    is one batched matmul over (B, H) with a named intermediate, so no
    contraction order can materialise a (B, L, L, H, N) tensor: the largest
    is the (B, H, L, L) score block, O(B·H·chunk²) per chunk.
    """
    bs, s, h, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    xd = (x * dt[..., None]).to(f32)                       # dt-weighted input
    da = (dt * a[None, None, :]).to(f32)                   # (B, S, H) ≤ 0
    state = (torch.zeros((bs, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for k0 in range(0, s, chunk):
        sl = slice(k0, k0 + chunk)
        xk = xd[:, sl].permute(0, 2, 1, 3)                 # (B, H, L, P)
        bk = b[:, sl].to(f32).permute(0, 2, 1, 3)          # (B, H, L, N)
        ck = c[:, sl].to(f32).permute(0, 2, 1, 3)          # (B, H, L, N)
        dak = da[:, sl].permute(0, 2, 1)                   # (B, H, L)
        a_cs = torch.cumsum(dak, dim=-1)                   # (B, H, L)
        # intra-chunk: y_diag[l] = Σ_s (C_l · B_s) exp(segsum)[l, s] x_s
        scores = ck @ bk.transpose(-1, -2)                 # (B, H, L, L)
        y = (scores * torch.exp(_segsum(dak))) @ xk        # (B, H, L, P)
        # the carried state's contribution: exp(a_cs[l]) · C_l · state
        y = y + (ck @ state.transpose(-1, -2)) * torch.exp(a_cs)[..., None]
        # carry: decay over the chunk plus this chunk's inputs
        decay = torch.exp(a_cs[..., -1:] - a_cs)           # (B, H, L)
        chunk_state = (xk * decay[..., None]).transpose(-1, -2) @ bk
        state = state * torch.exp(a_cs[..., -1])[..., None, None] \
            + chunk_state                                  # (B, H, P, N)
        ys.append(y.permute(0, 2, 1, 3))                   # (B, L, H, P)
    return torch.cat(ys, dim=1).to(x.dtype), state


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step recurrence, in float32: the oracle ``ssd_chunked`` is
    held to. Same arguments and returns, without ``chunk``."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    state = (torch.zeros((bs, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for t in range(s):
        xt, dtt = x[:, t].to(f32), dt[:, t].to(f32)          # (B,H,P), (B,H)
        bt, ct = b[:, t].to(f32), c[:, t].to(f32)            # (B,H,N)
        da = torch.exp(dtt * a[None, :])[..., None, None]
        upd = (dtt[..., None] * xt)[..., None] * bt[:, :, None, :]
        state = state * da + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ct))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _on_blocks(fn):
    """``fn(params, cfg, x, cache)`` on each rank's block when ``x`` is a
    DTensor (``collectives.spmd_map``): the batch split as ``x`` is, the
    weights and every head whole on each rank, and the new SSM state cut
    back to the heads the cache's placement gives the rank. DTensor's
    rules do not split the scan (its flattened batch and head dims give
    placements its batched products fail on), so the heads are computed
    whole: the ``replicated`` pieces of ``launch.dryrun``'s record."""
    @functools.wraps(fn)
    def wrapped(params, cfg: ArchConfig, x: torch.Tensor, cache=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(x, DTensor):
            return fn(params, cfg, x, cache)
        from repro_torch.parallel.collectives import spmd_map
        mesh = x.device_mesh
        names = list(mesh.mesh_dim_names)
        batch = tuple(p if isinstance(p, Shard) and p.dim == 0
                      else Replicate() for p in x.placements)
        whole = (Replicate(),) * len(names)
        keys = sorted(params)
        heads = [] if cache is None else [
            i for i, p in enumerate(cache["state"].placements)
            if isinstance(p, Shard) and p.dim == 1]

        def local(x_l, *rest):
            c = (None if cache is None else
                 {"conv": rest[len(keys)], "state": rest[len(keys) + 1]})
            out, new = fn(dict(zip(keys, rest[:len(keys)])), cfg, x_l, c)
            if new is None:
                return (out,)
            st = new["state"]
            for i in heads:         # this rank's heads, as the cache holds
                h = st.shape[1] // int(mesh.shape[i])
                st = st.narrow(1, mesh.get_local_rank(names[i]) * h, h)
            return out, new["conv"], st

        args = [x] + [params[k] for k in keys]
        in_pl = [batch] + [whole] * len(keys)
        out_pl = [batch]
        if cache is not None:
            args += [cache["conv"], cache["state"]]
            in_pl += [batch, batch]
            out_pl += [batch, tuple(Shard(1) if i in heads else p
                                    for i, p in enumerate(batch))]
        res = spmd_map(local, mesh, tuple(in_pl), tuple(out_pl))(*args)
        if cache is None:
            return res[0], None
        return res[0], {"conv": res[1], "state": res[2]}
    return wrapped


@_on_blocks
def mamba_prefill(params, cfg: ArchConfig, x: torch.Tensor,
                  cache: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor,
                             Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence SSD from a zero state. x: (B, S, D). Returns (out
    (B, S, D), with a cache: a new cache dict holding the conv tail and the
    final state; the input cache is not modified)."""
    bs, s, _ = x.shape
    zxbcdt = x @ gathered(params["in_proj"]).to(x.dtype)
    z, x_bc_raw, dt_raw = _split_proj(cfg, zxbcdt)

    x_bc = F.silu(causal_conv(cfg, x_bc_raw, params["conv_w"],
                              params["conv_b"]))
    xh, b, c = _split_xbc(cfg, x_bc)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])

    # pad S to a chunk multiple; padded steps get dt = 0 (no decay, no
    # input), so states and outputs are unaffected
    chunk = min(cfg.ssm_chunk, s) or 1
    pad = (-s) % chunk
    if pad:
        xh, b, c, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xh, b, c, dt))

    a = -torch.exp(params["A_log"])
    xheads = xh.reshape(bs, s + pad, cfg.ssm_heads, cfg.ssm_head_dim)
    y, final_state = ssd_chunked(xheads, dt, a, _broadcast_groups(cfg, b),
                                 _broadcast_groups(cfg, c), chunk)
    y = y[:, :s] + (params["D"].to(y.dtype)[None, None, :, None]
                    * xheads[:, :s].to(y.dtype))
    y = gated_rmsnorm(params["norm"], y.reshape(bs, s, cfg.d_inner), z,
                      cfg.rms_eps)
    out = y @ gathered(params["out_proj"]).to(y.dtype)

    if cache is None:
        return out, None
    tail = cfg.ssm_conv - 1
    conv_tail = (x_bc_raw[:, s - tail:] if s >= tail else
                 torch.cat([cache["conv"][:, s:].to(x_bc_raw.dtype),
                            x_bc_raw], dim=1))
    return out, {"conv": conv_tail.to(cache["conv"].dtype),
                 "state": final_state}


@_on_blocks
def mamba_decode(params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1) stateful step. x: (B, 1, D); cache {"conv" (B, ssm_conv-1,
    conv_dim), "state" (B, H, P, N) float32}. Returns (out (B, 1, D), a
    new cache dict; the input cache is not modified)."""
    bs = x.shape[0]
    zxbcdt = x @ gathered(params["in_proj"]).to(x.dtype)
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
    out = y @ gathered(params["out_proj"]).to(y.dtype)
    return out, {"conv": new_conv.to(cache["conv"].dtype), "state": state}
