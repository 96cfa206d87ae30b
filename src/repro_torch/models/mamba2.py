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

from repro_torch.models.common import ArchConfig, dense_init, is_dtensor, shard
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


def _moved(placements, dims) -> tuple:
    """DTensor placements that keep ``Shard(d)`` as ``Shard(dims[d])`` for
    each tensor dim d in ``dims`` and replicate every other."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in placements)


def _on_blocks(fn, mesh, in_pl, out_pl, *args) -> tuple:
    """``fn(*args)`` (a tuple); with a ``mesh`` (DTensor arguments) on each
    rank's blocks under ``in_pl`` / ``out_pl`` (``collectives.spmd_map``)."""
    if mesh is None:
        return fn(*args)
    from repro_torch.parallel.collectives import spmd_map
    return spmd_map(fn, mesh, tuple(in_pl), tuple(out_pl))(*args)


def _layouts(x: torch.Tensor):
    """(mesh, the batch placement of ``x``, the whole placement) on a
    DTensor; (None, None, None) on a plain tensor."""
    if not is_dtensor(x):
        return None, None, None
    from torch.distributed.tensor import Replicate
    return (x.device_mesh, _moved(x.placements, {0: 0}),
            (Replicate(),) * x.device_mesh.ndim)


_IN_KEYS = ("in_proj", "conv_w", "conv_b", "dt_bias")


def _prefill_in(cfg: ArchConfig, chunk: int, x, in_proj, conv_w, conv_b,
                dt_bias) -> tuple:
    """The projections and the conv of ``mamba_prefill``, every head:
    (z, the last ssm_conv - 1 raw xBC rows, head inputs (B, S', H, P), dt
    (B, S', H) and B, C on the heads (B, S', H, N)); S' is S padded to a
    chunk multiple, where padded steps get dt = 0 (no decay, no input), so
    states and outputs are unaffected."""
    bs, s, _ = x.shape
    z, x_bc_raw, dt_raw = _split_proj(cfg, x @ in_proj.to(x.dtype))
    x_bc = F.silu(causal_conv(cfg, x_bc_raw, conv_w, conv_b))
    xh, b, c = _split_xbc(cfg, x_bc)
    dt = F.softplus(dt_raw.float() + dt_bias[None, None, :])
    pad = (-s) % chunk
    if pad:
        xh, b, c, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xh, b, c, dt))
    xheads = xh.reshape(bs, s + pad, cfg.ssm_heads, cfg.ssm_head_dim)
    return (z, x_bc_raw[:, max(s - (cfg.ssm_conv - 1), 0):], xheads, dt,
            _broadcast_groups(cfg, b), _broadcast_groups(cfg, c))


def _prefill_scan(chunk: int, s: int, xheads, dt, bh, ch, a_log,
                  d) -> tuple:
    """The SSD over the heads it is given, and the ``D·x`` skip: (y
    (B, S, H, P), final state (B, H, P, N) float32)."""
    y, state = ssd_chunked(xheads, dt, -torch.exp(a_log), bh, ch, chunk)
    y = y[:, :s] + (d.to(y.dtype)[None, None, :, None]
                    * xheads[:, :s].to(y.dtype))
    return y, state


def _decode_in(cfg: ArchConfig, x, conv, in_proj, conv_w, conv_b,
               dt_bias) -> tuple:
    """The projections and the conv ring step of ``mamba_decode``, every
    head: (z, the new conv tail, head inputs (B, H, P), dt (B, H), B, C on
    the heads (B, H, N))."""
    bs = x.shape[0]
    z, x_bc_raw, dt_raw = _split_proj(cfg, x @ in_proj.to(x.dtype))
    window = torch.cat([conv.to(x.dtype), x_bc_raw], dim=1)
    x_bc = torch.einsum("bkc,kc->bc", window, conv_w.to(x.dtype))
    x_bc = F.silu(x_bc + conv_b.to(x.dtype))[:, None]
    xh, b, c = _split_xbc(cfg, x_bc)
    dt = F.softplus(dt_raw.float() + dt_bias[None, None, :])[:, 0]
    return (z, window[:, 1:].to(conv.dtype),
            xh.reshape(bs, cfg.ssm_heads, cfg.ssm_head_dim), dt,
            _broadcast_groups(cfg, b)[:, 0], _broadcast_groups(cfg, c)[:, 0])


def _decode_scan(xheads, dt, bh, ch, state, a_log, d) -> tuple:
    """One recurrence step over the heads it is given, and the ``D·x``
    skip: (y (B, H, P), new state (B, H, P, N) float32)."""
    da = torch.exp(dt * -torch.exp(a_log)[None, :])[..., None, None]
    upd = ((dt[..., None] * xheads.float())[..., None]
           * bh.float()[:, :, None, :])
    state = state * da + upd
    y = torch.einsum("bhpn,bhn->bhp", state, ch.float())
    y = y.to(xheads.dtype) + d.to(xheads.dtype)[None, :, None] * xheads
    return y, state


def _mixer_out(cfg: ArchConfig, y, z, norm, out_proj) -> tuple:
    """The gated norm over all of d_inner and the output projection."""
    y = gated_rmsnorm(norm, y.reshape(*z.shape[:2], cfg.d_inner), z,
                      cfg.rms_eps)
    return (y @ out_proj.to(y.dtype),)


def mamba_prefill(params, cfg: ArchConfig, x: torch.Tensor,
                  cache: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor,
                             Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence SSD from a zero state. x: (B, S, D). Returns (out
    (B, S, D), with a cache: a new cache dict holding the conv tail and the
    final state; the input cache is not modified).

    On DTensors each stage runs on local blocks: the projections, the conv
    and the gated norm on the batch as ``x`` splits it, with the weights
    whole (JAX's parameter rules leave them whole over "model"); the SSD
    on the placement JAX's annotation of the head inputs gives it, so its
    heads split over "model" where the installed rules put them there and
    they divide, else whole on every rank. The heads are gathered for the
    norm; the final state takes the cache's placement."""
    s = x.shape[1]
    chunk = min(cfg.ssm_chunk, s) or 1
    mesh, batch, whole = _layouts(x)
    z, tail, xheads, dt, bh, ch = _on_blocks(
        functools.partial(_prefill_in, cfg, chunk), mesh,
        [batch] + [whole] * 4, [batch] * 6, x,
        *(params[k] for k in _IN_KEYS))
    xheads = shard(xheads, "batch", "seq", "heads", None)
    hp = vec = st = None
    if mesh is not None:
        hp = _moved(xheads.placements, {0: 0, 2: 2})
        vec, st = _moved(hp, {2: 0}), _moved(hp, {0: 0, 2: 1})
    y, state = _on_blocks(functools.partial(_prefill_scan, chunk, s), mesh,
                          [hp] * 4 + [vec] * 2, (hp, st), xheads, dt, bh,
                          ch, params["A_log"], params["D"])
    out, = _on_blocks(functools.partial(_mixer_out, cfg), mesh,
                      (batch, batch, whole, whole), (batch,), y, z,
                      params["norm"], params["out_proj"])
    out = shard(out, "batch", "seq", "embed")
    if cache is None:
        return out, None
    if mesh is not None:
        state = state.redistribute(mesh, cache["state"].placements)
    if s < cfg.ssm_conv - 1:
        tail = torch.cat([cache["conv"][:, s:].to(tail.dtype), tail], dim=1)
    return out, {"conv": tail.to(cache["conv"].dtype), "state": state}


def mamba_decode(params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1) stateful step. x: (B, 1, D); cache {"conv" (B, ssm_conv-1,
    conv_dim), "state" (B, H, P, N) float32}. Returns (out (B, 1, D), a
    new cache dict; the input cache is not modified).

    On DTensors the stages run on local blocks as in ``mamba_prefill``;
    the recurrence runs on the heads the cache's state holds on the rank
    (split over "model" where they divide, as XLA propagates the state's
    placement through JAX's step)."""
    mesh, batch, whole = _layouts(x)
    z, conv, xheads, dt, bh, ch = _on_blocks(
        functools.partial(_decode_in, cfg), mesh,
        [batch, batch] + [whole] * 4, [batch] * 6, x, cache["conv"],
        *(params[k] for k in _IN_KEYS))
    hp = vec = st = None
    if mesh is not None:
        st = _moved(cache["state"].placements, {0: 0, 1: 1})
        hp, vec = _moved(st, {0: 0, 1: 1}), _moved(st, {1: 0})
    y, state = _on_blocks(_decode_scan, mesh, [hp] * 4 + [st] + [vec] * 2,
                          (hp, st), xheads, dt, bh, ch, cache["state"],
                          params["A_log"], params["D"])
    out, = _on_blocks(functools.partial(_mixer_out, cfg), mesh,
                      (batch, batch, whole, whole), (batch,), y, z,
                      params["norm"], params["out_proj"])
    return out, {"conv": conv, "state": state}
