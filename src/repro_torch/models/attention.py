"""Attention mixer: GQA with optional QKV bias and qk-norm, full or
sliding-window KV caches, and cross-attention over static encoder K/V
(whisper). Counterpart of ``repro.models.attention``.

GQA is computed in grouped form: q is reshaped to (B, S, n_kv, group, d)
and contracted against (B, T, n_kv, d) keys directly.

Kernel routing (``impl`` as in ``kernels.ops``: None picks by device):

  * ``attention_decode`` sends full (non-ring) caches to the split-KV
    kernel with ``lengths = pos + 1`` — the one-shard form of the JAX
    package's split-KV decode override. Ring caches keep the dense masked
    path, which the override leaves to them too.
  * ``attention_prefill_cached`` sends a chunk to the flash-prefill kernel
    when there is no sliding window and every sequence starts the chunk at
    the same position (the kernel's ``q_offset`` is one scalar), as the JAX
    package guards it; otherwise the dense masked path.

The plain path (CPU tensors or ``impl="plain"``) is the dense masked form
of the JAX package's default, so chunked prefill stays bit-exact against
token-by-token decode on it.

Two hooks the multi-pod dry-run sets, both off by default, as in JAX:
``QK_F32_BARRIER`` casts Q and K to float32 before the score contraction,
and ``set_decode_attention_override`` installs a decode-attention
strategy (the split-KV decode over a sharded cache) that
``attention_decode`` tries before its own.

Activations carry JAX's six ``shard`` annotations (``models.common``):
q, k and v after the projections, the core's output, the output
projection's and the flash branch's. On DTensors the core runs on local
blocks (``_local_core``), so its annotation sits at that boundary, on
the DTensor the blocks make up.

``attention_prefill`` (the single-program model's full-sequence prefill)
and ``cross_attention`` run no kernel: the JAX package computes both dense
and masked, outside any Pallas call, and so does the port.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import ops as kops
from repro_torch.models import kvcache
from repro_torch.models.common import (ArchConfig, gathered, is_dtensor,
                                       rows_whole, shard)
from repro_torch.models.layers import apply_rope, rmsnorm_1d

NEG_INF = -1e30

# The dry-run's ``qkf32`` lever: cast Q/K to float32 *before* the score
# contraction. In JAX the cast is a dtype barrier in the VJP that halves
# the tensor-parallel activation-gradient bytes; in the port it changes
# the scores' arithmetic (float32 products) and nothing else.
QK_F32_BARRIER = False


def _split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n·d) → (..., n, d). A DTensor whose last dim is split over a
    mesh axis that does not divide the n heads is first gathered along
    that axis: DTensor cannot cut a head across ranks (XLA pads)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        mesh = t.device_mesh
        pl = [Replicate() if isinstance(p, Shard) and p.dim == t.ndim - 1
              and n % int(mesh.shape[i]) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            if t.requires_grad:     # its gradient back in its own placement
                own = t.placements
                t.register_hook(lambda g: g.redistribute(mesh, own))
            t = t.redistribute(mesh, pl)
    return t.reshape(*t.shape[:-1], n, d)


def _project_q(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rows_whole(x)
    q = x @ gathered(params["wq"]).to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    q = _split_heads(q, cfg.n_heads, cfg.d_head)
    if "q_norm" in params:
        q = rmsnorm_1d(params["q_norm"], q, cfg.rms_eps)
    return shard(q, "batch", "seq", "heads", None)


def _project_kv(params, cfg: ArchConfig,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = rows_whole(x)
    k = x @ gathered(params["wk"]).to(x.dtype)
    v = x @ gathered(params["wv"]).to(x.dtype)
    if "bk" in params:
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    k = _split_heads(k, cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(v, cfg.n_kv_heads, cfg.d_head)
    if "k_norm" in params:
        k = rmsnorm_1d(params["k_norm"], k, cfg.rms_eps)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    return k, v


def gqa_scores_softmax_out(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped attention core. q: (B, S, Hq, d); k, v: (B, T, Hkv, d);
    mask broadcastable to (B, 1, 1, S, T) or None. Returns (B, S, Hq·d).

    Scores are formed in the input dtype and softmaxed in float32; the
    probabilities are cast back before the value contraction, as in JAX.
    """
    if is_dtensor(q):
        return shard(_local_core(cfg, q, k, v, mask), "batch", "seq", "heads")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    if QK_F32_BARRIER:
        qg = qg.float()
        k = k.float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) * (1.0 / math.sqrt(d))
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return shard(out.reshape(b, s, hq * d), "batch", "seq", "heads")


def _local_core(cfg: ArchConfig, q, k, v, mask):
    """``gqa_scores_softmax_out`` on DTensors, run on each rank's block
    (``collectives.spmd_map``): the batch split over the data-parallel
    axes ("pod", "data") where it divides, the query heads over "model"
    where they divide, the KV heads too where they divide, else whole on
    every rank, which then takes the KV heads its query heads read (GQA);
    the cache's T and the sequence whole. It is what XLA's partitioner
    makes of JAX's ``shard(out, "batch", "seq", "heads")``. Heads that do
    not divide stay whole (replicated) on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.parallel.collectives import spmd_map
    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(n) for n in mesh.shape)))
    b, hq, hkv = q.shape[0], q.shape[2], k.shape[2]
    g = hq // hkv
    dp = [a for a in ("pod", "data") if a in sizes]
    if b % math.prod(sizes[a] for a in dp):
        dp = []
    m = sizes.get("model", 1)
    q_split = m > 1 and hq % m == 0 and (hq // m % g == 0 or g % (hq // m) == 0)
    kv_split = q_split and hkv % m == 0

    def pl(batch: bool, heads: bool):
        out = [Replicate()] * len(names)
        for a in dp if batch else ():
            out[names.index(a)] = Shard(0)
        if heads:
            out[names.index("model")] = Shard(2)
        return tuple(out)

    def core(q_, k_, v_, m_=None):
        if q_split and not kv_split:    # this rank's query heads' KV heads
            hq_l = q_.shape[2]
            lo = mesh.get_local_rank("model") * hq_l // g
            n = max(hq_l // g, 1)
            k_, v_ = k_[:, :, lo:lo + n], v_[:, :, lo:lo + n]
        return (gqa_scores_softmax_out(cfg, q_, k_, v_, m_),)

    args = [q, k, v]
    in_pl = [pl(True, q_split), pl(True, kv_split), pl(True, kv_split)]
    if mask is not None:
        if not isinstance(mask, DTensor):
            mask = DTensor.from_local(mask, mesh, pl(False, False),
                                      run_check=False)
        args.append(mask)
        in_pl.append(pl(mask.shape[0] == b and b > 1, False))
    return spmd_map(core, mesh, tuple(in_pl), (pl(True, q_split),))(*args)[0]


def _output_proj(params, x_attn: torch.Tensor) -> torch.Tensor:
    wo = gathered(params["wo"])
    out = rows_whole(x_attn, wo) @ wo.to(x_attn.dtype)
    return shard(out, "batch", "seq", "embed")


def causal_mask(cfg: ArchConfig, s: int, t: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(1, 1, 1, S, T) causal (+ sliding window) mask for prefill.
    Bidirectional stacks (``cfg.causal=False``, the whisper encoder) see
    every key."""
    t = t if t is not None else s
    if not cfg.causal:
        return torch.ones((1, 1, 1, s, t), dtype=torch.bool, device=device)
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    m = cols <= rows
    if cfg.sliding_window is not None:
        m = m & (rows - cols < cfg.sliding_window)
    return m[None, None, None]


# Above this many query positions (and at a multiple of it), prefill scores
# one query chunk at a time: peak score memory O(chunk × S), not O(S²).
PREFILL_CHUNK = 1024


def _chunked_causal_attention(cfg: ArchConfig, q: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor,
                              chunk: int) -> torch.Tensor:
    """Causal attention one (B, chunk, Hq, d) query block at a time against
    the full key set, under a global-position causal (+ window) mask. A
    Python loop over the chunks stands in for JAX's ``lax.scan``."""
    b, s, hq, d = q.shape
    cols = torch.arange(s, device=q.device)[None, :]
    outs = []
    for ci in range(s // chunk):
        rows = ci * chunk + torch.arange(chunk, device=q.device)[:, None]
        m = cols <= rows
        if cfg.sliding_window is not None:
            m = m & (rows - cols < cfg.sliding_window)
        if not cfg.causal:
            m = torch.ones_like(m)
        outs.append(gqa_scores_softmax_out(
            cfg, q[:, ci * chunk:(ci + 1) * chunk], k, v, m[None, None, None]))
    return torch.cat(outs, dim=1)


def attention_prefill(params, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor,
                      cache: Optional[kvcache.Cache] = None
                      ) -> Tuple[torch.Tensor, Optional[kvcache.Cache]]:
    """Full-sequence attention over x (B, S, D) at positions (B, S); with a
    cache, its K/V are written from position 0 (``write_kv_prefill``)."""
    q = _project_q(params, cfg, x)
    k, v = _project_kv(params, cfg, x)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    if s > PREFILL_CHUNK and s % PREFILL_CHUNK == 0:
        out = _chunked_causal_attention(cfg, q, k, v, PREFILL_CHUNK)
    else:
        out = gqa_scores_softmax_out(cfg, q, k, v,
                                     causal_mask(cfg, s, device=x.device))
    if cache is not None:
        cache = kvcache.write_kv_prefill(cfg, cache, k, v)
    return _output_proj(params, out), cache


def cross_attention(params, cfg: ArchConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decoder cross-attention over static encoder K/V (whisper)."""
    q = _project_q(params, cfg, x)
    mask = None if enc_mask is None else enc_mask[:, None, None, None, :]
    return _output_proj(params, gqa_scores_softmax_out(cfg, q, enc_k, enc_v,
                                                       mask))


def project_cross_kv(params, cfg: ArchConfig, enc_out: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder K/V of one decoder layer, computed once per request."""
    return _project_kv(params, cfg, enc_out)


def attention_prefill_cached(params, cfg: ArchConfig, x: torch.Tensor,
                             cache: kvcache.Cache, pos: torch.Tensor,
                             impl: Optional[str] = None
                             ) -> Tuple[torch.Tensor, kvcache.Cache]:
    """Multi-token chunk against a live cache. x: (B, C, D); pos: (B,)
    absolute position of x[:, 0]. All C keys/values are written first;
    on the dense path every row then attends over the full cache under its
    own validity mask (``valid_mask_chunk``), so row j's arithmetic is the
    same as a decode step at pos + j."""
    b, c, _ = x.shape
    q = _project_q(params, cfg, x)
    k_new, v_new = _project_kv(params, cfg, x)
    positions = pos[:, None] + torch.arange(c, dtype=pos.dtype,
                                            device=pos.device)[None, :]
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    cache = kvcache.write_kv_chunk(cfg, cache, k_new, v_new, pos)
    t = cache["k"].shape[1]
    starts = []
    if kops.resolve_impl(impl, x) == "cuda":
        starts = pos.tolist()
        trace.count("sync.attn_prefill_starts")
    if (starts and cfg.sliding_window is None
            and all(p == starts[0] for p in starts)):
        off = starts[0]
        out = kops.flash_prefill_attention(
            q, cache["k"], cache["v"], causal=cfg.causal, impl="cuda",
            q_offset=off, t_valid=min(off + c, t)).reshape(b, c, -1)
        out = shard(out, "batch", "seq", "heads")
    else:
        valid = kvcache.valid_mask_chunk(cfg, t, pos, c)       # (B, C, T)
        out = gqa_scores_softmax_out(cfg, q, cache["k"], cache["v"],
                                     valid[:, None, None, :, :])
    return _output_proj(params, out), cache


# Optional decode-attention strategy (the dry-run's split-KV decode over a
# cache whose T is sharded, ``launch.dryrun._install_splitkv``):
# fn(cfg, q (B, 1, Hq, d), k, v, pos) -> (B, 1, Hq·d), or None where it
# does not apply.
_DECODE_OVERRIDE = None


def set_decode_attention_override(fn) -> None:
    global _DECODE_OVERRIDE
    _DECODE_OVERRIDE = fn


def attention_decode(params, cfg: ArchConfig, x: torch.Tensor,
                     cache: kvcache.Cache, pos: torch.Tensor,
                     impl: Optional[str] = None
                     ) -> Tuple[torch.Tensor, kvcache.Cache]:
    """One-token step. x: (B, 1, D); pos: (B,) current absolute positions.
    Keys carry RoPE at their absolute positions (applied at write time), so
    ring-buffer eviction needs no re-rotation."""
    q = _project_q(params, cfg, x)
    k_new, v_new = _project_kv(params, cfg, x)
    if cfg.use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    cache = kvcache.write_kv(cfg, cache, k_new, v_new, pos)
    if _DECODE_OVERRIDE is not None:
        out = _DECODE_OVERRIDE(cfg, q, cache["k"], cache["v"], pos)
        if out is not None:
            return _output_proj(params, out), cache
    t = cache["k"].shape[1]
    if kops.resolve_impl(impl, x) == "cuda" and cfg.sliding_window is None:
        # the kernel clamps each length to [0, T] and reads pos's dtype
        out = kops.splitkv_attention(q[:, 0], cache["k"], cache["v"],
                                     pos + 1, impl="cuda")
        out = out.reshape(x.shape[0], 1, -1)
    else:
        valid = kvcache.valid_mask(cfg, t, pos)                # (B, T)
        out = gqa_scores_softmax_out(cfg, q, cache["k"], cache["v"],
                                     valid[:, None, None, None, :])
    return _output_proj(params, out), cache
