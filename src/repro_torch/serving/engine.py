"""Serving helpers shared by the engines: the pad token, the failure-drain
count and the batch-slot cache splice. Counterparts of the helpers in
``repro.serving.engine``; the single-program ``DecodeEngine`` is not
ported yet.
"""

from __future__ import annotations

import math

import torch

PAD = 0


def failure_drain_count(frac_nodes_lost: float, n_slots: int) -> int:
    """Slots to drain when ``frac_nodes_lost`` of capacity fails: exactly
    ``ceil(frac · n_slots)``, clamped to ``n_slots``."""
    if not 0.0 <= frac_nodes_lost <= 1.0:
        raise ValueError(
            f"frac_nodes_lost must be in [0, 1], got {frac_nodes_lost}")
    return min(n_slots, math.ceil(frac_nodes_lost * n_slots - 1e-12))


def _splice(dst: torch.Tensor, src: torch.Tensor, slot: int, n_slots: int,
            t_offset: int) -> None:
    if dst.ndim == 0:
        return
    for ax in range(dst.ndim):
        if not (dst.shape[ax] == n_slots and src.shape[ax] == 1):
            continue
        rest_dst = dst.shape[:ax] + dst.shape[ax + 1:]
        rest_src = src.shape[:ax] + src.shape[ax + 1:]
        one = src.select(ax, 0).to(dst.dtype)
        if rest_dst == rest_src:
            dst.select(ax, slot).copy_(one)
            return
        diff = [i for i, (a, b) in enumerate(zip(rest_dst, rest_src))
                if a != b]
        if len(diff) == 1:
            tax = diff[0]                       # axis id with ``ax`` removed
            n = one.shape[tax]
            if n < rest_dst[tax] and t_offset + n <= rest_dst[tax]:
                dst.select(ax, slot).narrow(tax, t_offset, n).copy_(one)
                return


def splice_batch_slot(dst_tree, src_tree, slot: int, n_slots: int,
                      t_offset: int = 0):
    """Write a 1-sequence cache tree into batch position ``slot``.

    The batch axis is identified explicitly: the axis where ``dst`` has size
    ``n_slots``, ``src`` has size 1, and every other dimension agrees.
    Matching on whole-shape inequality is wrong at ``n_slots == 1`` (the two
    shapes coincide and the splice would silently do nothing).

    Token slabs: a ``src`` leaf may be shorter than ``dst`` along exactly
    one further axis; it is written as one contiguous slab starting at
    ``t_offset`` on that axis.

    The write is in place on ``dst``'s tensors (the JAX version returns new
    arrays); the updated tree is returned for symmetry.
    """
    if isinstance(dst_tree, dict):
        for k in dst_tree:
            splice_batch_slot(dst_tree[k], src_tree[k], slot, n_slots,
                              t_offset)
    elif isinstance(dst_tree, (list, tuple)):
        for d, s in zip(dst_tree, src_tree):
            splice_batch_slot(d, s, slot, n_slots, t_offset)
    else:
        _splice(dst_tree, src_tree, slot, n_slots, t_offset)
    return dst_tree
