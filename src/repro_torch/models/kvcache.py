"""Caches for autoregressive decoding, one kind per mixer family.
Counterpart of ``repro.models.kvcache``.

  * attention: ``{"k", "v"}`` planes of shape (B, T, n_kv, d_head),
    T = max context, or T = window for sliding-window archs (a ring:
    slot = pos mod window);
  * Mamba-2: ``{"conv"}`` tail (B, ssm_conv - 1, conv_dim) in the compute
    dtype and the recurrent ``{"state"}`` (B, heads, head_dim, d_state) in
    float32; O(1) in the sequence length.

The writers update the cache tensors in place and return the same dict
(the JAX versions return new arrays): a decode step then moves one row per
sequence instead of copying the cache.

On DTensor planes (the multi-pod dry-run's caches, split over batch and
T) the writers write each rank's block in place: the new rows come whole
along T, and each rank keeps the slots of its own T range.

The initializers carry JAX's four ``shard`` annotations. They make plain
tensors, which every annotation passes unchanged: a DTensor cache is
placed by its caller (``parallel.sharding.cache_shardings`` and
``distribute_tree``), and the writers work on local blocks
(``_local_plane``) between DTensor boundaries that keep the cache's
placement.

The whole-model cache of ``models.model`` is flat, one entry per layer:
``{"layers": [per-layer cache], "pos": (B,) int32}``, plus ``"cross_kv"``
(one (k, v) per decoder layer, None for Mamba layers) for enc-dec archs.
It is the counterpart of JAX's ``{"prefix": [...], "stack": [...]}``
with the stacked periods laid out layer by layer.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch import trace
from repro_torch.models.common import (ArchConfig, LayerSpec, is_dtensor,
                                       shard, tree_bytes)

Cache = Dict[str, torch.Tensor]


def attn_cache_len(cfg: ArchConfig, max_len: int) -> int:
    """Ring length for sliding-window archs, else the full context."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int,
                    device) -> Cache:
    shape = (batch, attn_cache_len(cfg, max_len), cfg.n_kv_heads, cfg.d_head)
    return {"k": shard(torch.zeros(shape, dtype=cfg.compute_dtype,
                                   device=device),
                       "batch", "kv_seq", "kv_heads", None),
            "v": shard(torch.zeros(shape, dtype=cfg.compute_dtype,
                                   device=device),
                       "batch", "kv_seq", "kv_heads", None)}


def init_ssm_cache(cfg: ArchConfig, batch: int, device) -> Cache:
    conv = torch.zeros((batch, cfg.ssm_conv - 1, cfg.conv_dim),
                       dtype=cfg.compute_dtype, device=device)
    state = torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device)
    return {"conv": shard(conv, "batch", None, None),
            "state": shard(state, "batch", "heads", None, None)}


def init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     max_len: int, device) -> Cache:
    if spec.kind == "mamba":
        return init_ssm_cache(cfg, batch, device)
    return init_attn_cache(cfg, batch, max_len, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device) -> Dict[str, object]:
    """Whole-model cache, every layer's at position 0. The cross-attention
    K/V of enc-dec archs is attached by ``Model.prefill``."""
    return {"layers": [init_layer_cache(cfg, spec, batch, max_len, device)
                       for spec in cfg.layer_plan().flat()],
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def cache_bytes(cache) -> int:
    """Bytes of every tensor in a cache tree."""
    return tree_bytes(cache)


def write_kv(cfg: ArchConfig, cache: Cache, k_new: torch.Tensor,
             v_new: torch.Tensor, pos: torch.Tensor) -> Cache:
    """Write one step's k/v (B, 1, n_kv, d_head) at per-sequence ``pos``.

    Ring caches wrap (slot = pos mod window). A full cache drops writes at
    ``pos >= T``, as the JAX scatter does; they are masked on the device
    (no host sync), and each sequence writes one slot, so no index repeats.
    """
    t = cache["k"].shape[1]
    if is_dtensor(cache["k"]):
        for name, new in (("k", k_new), ("v", v_new)):
            _write_step_local(cfg, cache[name], new, pos)
        return cache
    slot = pos.long() % t if cfg.sliding_window is not None else pos.long()
    inside = (slot < t)[:, None, None]
    slot = slot.clamp(max=t - 1)
    idx = torch.arange(k_new.shape[0], device=slot.device)
    for name, new in (("k", k_new), ("v", v_new)):
        plane = cache[name]
        plane[idx, slot] = torch.where(inside, new[:, 0].to(plane.dtype),
                                       plane[idx, slot])
    return cache


def write_kv_chunk(cfg: ArchConfig, cache: Cache, k_new: torch.Tensor,
                   v_new: torch.Tensor, pos: torch.Tensor) -> Cache:
    """Write a chunk's k/v (B, C, n_kv, d_head); row j lands at absolute
    position ``pos + j``.

    Identical to C sequential ``write_kv`` calls: under ring wrap only the
    last ``t`` positions survive such a loop, so the overwritten head is
    dropped first and every slot is written once (``index_put_`` with
    repeated indices is undefined, as XLA's scatter is). Positions past the
    end of a full cache are dropped.
    """
    t = cache["k"].shape[1]
    b, c = k_new.shape[0], k_new.shape[1]
    if cfg.sliding_window is not None and c > t:
        k_new, v_new = k_new[:, c - t:], v_new[:, c - t:]
        pos = pos + (c - t)
        c = t
    positions = pos.long()[:, None] + torch.arange(c, device=pos.device)
    slot = positions % t if cfg.sliding_window is not None else positions
    bidx = torch.arange(b, device=pos.device)[:, None].expand(b, c)
    keep = slot < t
    for name, new in (("k", k_new), ("v", v_new)):
        plane = cache[name]
        plane[bidx[keep], slot[keep]] = new.to(plane.dtype)[keep]
        trace.count("sync.kv_chunk_mask", 3)  # each mask index is a nonzero
    return cache


def write_kv_prefill(cfg: ArchConfig, cache: Cache, k: torch.Tensor,
                     v: torch.Tensor) -> Cache:
    """Bulk-write a prefill segment (B, S, n_kv, d_head) starting at
    position 0.

    A ring cache shorter than the segment keeps its last ``t`` positions,
    position p in slot p mod t, so that decode writes continue the ring.
    A full cache keeps positions below T and drops the rest, as ``write_kv``
    drops writes at ``pos >= T``.
    """
    t = cache["k"].shape[1]
    s = k.shape[1]
    for name, new in (("k", k), ("v", v)):
        plane = cache[name]
        if is_dtensor(plane):
            _write_prefill_local(cfg, plane, new)
        elif cfg.sliding_window is not None and s > t:
            slots = torch.arange(s - t, s, device=plane.device) % t
            plane[:, slots] = new[:, s - t:].to(plane.dtype)
        else:
            n = min(s, t)
            plane[:, :n] = new[:, :n].to(plane.dtype)
    return cache


def _local_plane(plane, new, *rest):
    """This rank's block of a DTensor cache plane (in place), its first
    slot along T, and ``new`` and ``rest`` (per-sequence tensors such as
    ``pos``) split over the batch as the plane is, whole along T."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = plane.device_mesh
    local = plane.to_local()
    t_loc, off = local.shape[1], 0
    coords = mesh.get_coordinate()
    for i, p in enumerate(plane.placements):
        if isinstance(p, Shard) and p.dim == 1:
            off = off * int(mesh.shape[i]) + coords[i]
    off *= t_loc
    rows = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in plane.placements]
    batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
             for p in plane.placements]

    def place(x, pl):
        if not is_dtensor(x):
            from torch.distributed.tensor import DTensor
            x = DTensor.from_local(x, mesh, [Replicate()] * len(pl),
                                   run_check=False)
        return x.redistribute(mesh, pl).to_local()

    return (local, off, place(new, rows),
            *(place(r, batch) for r in rest))


def _write_step_local(cfg: ArchConfig, plane, new, pos) -> None:
    """``write_kv`` of one plane on this rank's block."""
    local, off, new_l, pos_l = _local_plane(plane, new, pos)
    t, t_loc = plane.shape[1], local.shape[1]
    slot = pos_l.long() % t if cfg.sliding_window is not None else pos_l.long()
    slot = slot - off
    inside = ((slot >= 0) & (slot < t_loc))[:, None, None]
    slot = slot.clamp(0, t_loc - 1)
    idx = torch.arange(local.shape[0], device=local.device)
    local[idx, slot] = torch.where(inside, new_l[:, 0].to(local.dtype),
                                   local[idx, slot])


def _write_prefill_local(cfg: ArchConfig, plane, new) -> None:
    """``write_kv_prefill`` of one plane on this rank's block: slot j holds
    the segment's position j (full caches, j < S) or, for a ring shorter
    than the segment, its last position p with p mod T = j."""
    local, off, new_l = _local_plane(plane, new)
    t, t_loc, s = plane.shape[1], local.shape[1], new_l.shape[1]
    slots = torch.arange(off, off + t_loc, device=local.device)
    if cfg.sliding_window is not None and s > t:
        src = s - t + (slots - (s - t)) % t
        local[:] = new_l[:, src].to(local.dtype)
    else:
        n = max(0, min(min(s, t) - off, t_loc))
        if n:
            local[:, :n] = new_l[:, off:off + n].to(local.dtype)


def valid_mask(cfg: ArchConfig, cache_len: int,
               pos: torch.Tensor) -> torch.Tensor:
    """(B, T) bool — cache slots holding live keys when querying at pos."""
    slots = torch.arange(cache_len, device=pos.device)[None, :]
    p = pos.long()[:, None]
    if cfg.sliding_window is None:
        return slots <= p
    age = (p % cache_len - slots) % cache_len
    return (age <= p) & (age < cache_len)


def valid_mask_chunk(cfg: ArchConfig, cache_len: int, pos: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """(B, C, T) bool — ``valid_mask`` at ``pos + j`` for each chunk row."""
    slots = torch.arange(cache_len, device=pos.device)[None, None, :]
    p = (pos.long()[:, None]
         + torch.arange(chunk, device=pos.device)[None, :])[..., None]
    if cfg.sliding_window is None:
        return slots <= p
    age = (p % cache_len - slots) % cache_len
    return (age <= p) & (age < cache_len)
