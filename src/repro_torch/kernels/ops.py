"""Front door of the kernels: the counterpart of ``repro.kernels.ops``.

Every op has two implementations:

  * ``cuda``  — the hand-written Hopper kernel (CUDA tensors only);
  * ``plain`` — the plain PyTorch version in ``kernels/ref.py``.

``impl=None`` picks by where the tensors lie: CUDA tensors go to the
kernel, CPU tensors to the plain version. ``impl="plain"`` on CUDA tensors
is an explicit request (the end-to-end path check of ``chip_smoke.py``);
``impl="cuda"`` on CPU tensors raises.

While a work observer is set (``set_work_observer``), each op runs inside
``observer.kernel(work, *inputs)``, which gets the kernel's own work on
these inputs (``*_work`` below) in place of the arithmetic of whichever
version runs: the plain grouped GEMM multiplies every row by every expert,
the kernel only the routed rows. With none set, an op pays one check.
A rotation replayed from a CUDA graph (``parallel.rotation_graph``) runs
no op here: it reports the calls it captured to the observer itself. The
launch counters count the launches a wrapper issues, into a graph being
captured too, and nothing a graph's replay launches.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import splitkv_attention as _skv

IMPLS = ("cuda", "plain")

# The work observer (``set_work_observer``), if any.
_OBSERVER = None
_UNOBSERVED = contextlib.nullcontext()


def set_work_observer(observer):
    """Set the object whose ``kernel(work, *inputs)`` context each op runs
    in (``None``: no observer); returns the one it replaces."""
    global _OBSERVER
    previous, _OBSERVER = _OBSERVER, observer
    return previous


def work_observer():
    """The work observer set now, or None."""
    return _OBSERVER


def _bytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def grouped_gemm_work(lhs: torch.Tensor, rhs: torch.Tensor,
                      group_sizes: torch.Tensor,
                      row_index: Optional[torch.Tensor] = None,
                      out_index: Optional[torch.Tensor] = None,
                      out_rows: Optional[int] = None,
                      scales: Optional[torch.Tensor] = None
                      ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one grouped-GEMM call on these inputs: 2·K·N per
    routed row (rows past ``sum(group_sizes)`` are written as zeros, not
    computed); lhs, the index vectors and the group sizes read once, each
    visited expert's weights (codes and scales) once, the output written
    once. Reads the group sizes on the host."""
    m = lhs.shape[0] if row_index is None else row_index.shape[0]
    k, n = lhs.shape[1], rhs.shape[2]
    sizes = group_sizes.long()
    routed = min(int(sizes.sum()), m)
    visited = int((sizes > 0).sum())
    expert = _bytes(rhs[0]) + (0 if scales is None else _bytes(scales[0]))
    n_out = m if out_index is None or out_rows is None else int(out_rows)
    nbytes = (_bytes(lhs, row_index, out_index, group_sizes)
              + visited * expert + n_out * n * lhs.element_size())
    return 2 * routed * k * n, nbytes


def splitkv_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, return_lse: bool = False
                 ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one split-KV call: 4·d per live key and query
    head (scores and the value sum); q, the live keys' K and V rows and the
    lengths read once, the output (and LSE) written once."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    live = int(lengths.long().clamp(0, t).sum())
    nbytes = (2 * _bytes(q) + 2 * live * hkv * d * k.element_size()
              + _bytes(lengths) + (b * hq * 4 if return_lse else 0))
    return 4 * live * hq * d, nbytes


def flash_prefill_work(q: torch.Tensor, k: torch.Tensor,
                       causal: bool = True, window: Optional[int] = None,
                       q_offset: int = 0, t_valid: Optional[int] = None
                       ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one flash-prefill call: 4·d per live (query row,
    key) pair and query head; q, the live KV prefix and the output once."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    tv = t if t_valid is None else min(t_valid, t)
    keys = 0
    for j in range(s):
        row = q_offset + j
        hi = min(tv, row + 1) if causal else tv
        lo = max(0, row - window + 1) if window is not None else 0
        keys += max(hi - lo, 0)
    nbytes = 2 * _bytes(q) + 2 * b * tv * hkv * d * k.element_size()
    return 4 * b * keys * hq * d, nbytes


def grouped_gemm_bound(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor,
                       row_index: Optional[torch.Tensor] = None,
                       out_index: Optional[torch.Tensor] = None,
                       out_rows: Optional[int] = None,
                       scales: Optional[torch.Tensor] = None
                       ) -> Tuple[int, int]:
    """``grouped_gemm_work``'s bound on these shapes, read from the shapes
    alone: every row routed, min(G, rows) experts visited."""
    m = lhs.shape[0] if row_index is None else row_index.shape[0]
    k, n = lhs.shape[1], rhs.shape[2]
    expert = _bytes(rhs[0]) + (0 if scales is None else _bytes(scales[0]))
    n_out = m if out_index is None or out_rows is None else int(out_rows)
    nbytes = (_bytes(lhs, row_index, out_index, group_sizes)
              + min(rhs.shape[0], m) * expert + n_out * n * lhs.element_size())
    return 2 * m * k * n, nbytes


def splitkv_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, return_lse: bool = False
                  ) -> Tuple[int, int]:
    """``splitkv_work``'s bound on these shapes: every key live."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    nbytes = (2 * _bytes(q) + 2 * b * t * hkv * d * k.element_size()
              + _bytes(lengths) + (b * hq * 4 if return_lse else 0))
    return 4 * b * t * hq * d, nbytes


def bound_work(work):
    """The shape-only bound of a ``*_work`` function that reads its
    inputs' values (the grouped GEMM's group sizes, split-KV's lengths);
    ``work`` itself where it reads shapes alone."""
    return {grouped_gemm_work: grouped_gemm_bound,
            splitkv_work: splitkv_bound}.get(work, work)


# The inputs, by their place in ``observer.kernel(work, *inputs)``, whose
# values a ``*_work`` function reads: the group sizes, the lengths.
VALUE_INPUTS = {grouped_gemm_work: (2,), splitkv_work: (3,)}


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "plain"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def gemm_tiles(lhs: torch.Tensor, rhs: torch.Tensor,
               row_index: Optional[torch.Tensor] = None,
               scales: Optional[torch.Tensor] = None,
               tile_m: Optional[int] = None, tile_n: Optional[int] = None,
               tile_k: Optional[int] = None) -> Tuple[int, int, int]:
    """The grouped GEMM's bf16 tiling for a call: pinned tiles win, the
    others come from the autotune table keyed as JAX keys it (E, rows /
    E, N; rows = ``row_index``'s length when given). With int4 weights
    the column tile must divide the quantization block: as JAX forces its
    n-tile to the block, the port takes the widest built column tile of
    the same (tile_m, tile_k) that divides it. A tiling the kernel is not
    built for raises."""
    m = lhs.shape[0] if row_index is None else row_index.shape[0]
    at_m, at_n, at_k = _autotune.lookup(rhs.shape[0], m, rhs.shape[2])
    tiles = (at_m if tile_m is None else int(tile_m),
             at_n if tile_n is None else int(tile_n),
             at_k if tile_k is None else int(tile_k))
    if scales is not None and scales.ndim == 2:
        block_n = rhs.shape[2] // scales.shape[1]
        if block_n % tiles[1]:
            fits = [t for t in _gg.TILINGS if t[0] == tiles[0]
                    and t[2] == tiles[2] and block_n % t[1] == 0]
            if not fits:
                raise ValueError(
                    f"no built tiling ({tiles[0]}, n, {tiles[2]}) has a "
                    f"column tile dividing the int4 block of {block_n}; "
                    f"built: {_gg.TILINGS}")
            tiles = max(fits, key=lambda t: t[1])
    if tiles not in _gg.TILINGS:
        raise ValueError(f"the grouped GEMM is not built for tiles {tiles}; "
                         f"built: {_gg.TILINGS}")
    return tiles


def grouped_gemm(lhs: torch.Tensor, rhs: torch.Tensor,
                 group_sizes: torch.Tensor, impl: Optional[str] = None,
                 tile_m: Optional[int] = None, tile_n: Optional[int] = None,
                 tile_k: Optional[int] = None,
                 scales: Optional[torch.Tensor] = None,
                 row_index: Optional[torch.Tensor] = None,
                 out_index: Optional[torch.Tensor] = None,
                 out_rows: Optional[int] = None) -> torch.Tensor:
    """out[r] = lhs[r] @ rhs[group_of(r)] for group-sorted rows.

    lhs: (M, K); rhs: (G, K, N); group_sizes: (G,) summing to ≤ M
    (surplus rows give zeros). ``row_index``/``out_index``/``out_rows``
    fuse the router permute: row r consumes ``lhs[row_index[r]]`` and
    lands in ``out[out_index[r]]``. ``scales`` makes ``rhs`` weight-only
    quantized: (G,) for int8 codes (G, K, N), (G, N/block_n) for int4
    codes packed two per byte along K (G, K/2, N); the output then has
    lhs's dtype.

    Unpinned tile sizes come from the autotune table keyed on (E,
    tokens/expert, d_ff) (``gemm_tiles``; ``python -m repro_torch tune``
    fills it). The table applies to the bf16 kernel; the float32 kernel
    and the plain version have no tiling, and ignore it.
    """
    kernel = resolve_impl(impl, lhs) == "cuda"
    # the plain version has no tiling: only a pinned one is checked
    tiles = gemm_tiles(lhs, rhs, row_index, scales if kernel else None,
                       tile_m, tile_n, tile_k)
    with _UNOBSERVED if _OBSERVER is None else _OBSERVER.kernel(
            grouped_gemm_work, lhs, rhs, group_sizes, row_index, out_index,
            out_rows, scales):
        if not kernel:
            return _gg.plain(lhs, rhs, group_sizes, row_index, out_index,
                             out_rows, scales)
        return _gg.grouped_gemm(lhs, rhs, group_sizes, row_index=row_index,
                                out_index=out_index, out_rows=out_rows,
                                scales=scales, tiles=tiles)


def splitkv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, impl: Optional[str] = None,
                      return_lse: bool = False):
    """One-token GQA attention with per-batch valid lengths.

    q: (B, Hq, d); k, v: (B, T, Hkv, d); lengths: (B,) int32 or int64,
    each clamped to [0, T].
    """
    with _UNOBSERVED if _OBSERVER is None else _OBSERVER.kernel(
            splitkv_work, q, k, v, lengths, return_lse):
        if resolve_impl(impl, q) == "plain":
            return _ref.splitkv_attention_ref(q, k, v, lengths,
                                              return_lse=return_lse)
        return _skv.splitkv_attention(q, k, v, lengths,
                                      return_lse=return_lse)


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None,
                            impl: Optional[str] = None, q_offset: int = 0,
                            t_valid: Optional[int] = None) -> torch.Tensor:
    """Prefill attention (B, S, Hq, d) against a (B, T, Hkv, d) cache:
    query row j at absolute position ``q_offset + j``, the first
    ``t_valid`` KV slots live."""
    with _UNOBSERVED if _OBSERVER is None else _OBSERVER.kernel(
            flash_prefill_work, q, k, causal, window, q_offset, t_valid):
        if resolve_impl(impl, q) == "plain":
            return _ref.flash_prefill_ref(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset,
                                          t_valid=t_valid)
        return _fp.flash_prefill(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, t_valid=t_valid)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {"grouped_gemm": _gg.launches,
            "grouped_gemm_int8": _gg.launches_int8,
            "grouped_gemm_int4": _gg.launches_int4,
            "flash_prefill": _fp.launches,
            "splitkv_attention": _skv.launches}


def reset_launch_counts() -> None:
    _gg.launches = 0
    _gg.launches_int8 = 0
    _gg.launches_int4 = 0
    _fp.launches = 0
    _skv.launches = 0
