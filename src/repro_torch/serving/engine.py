"""Continuous-batching decode engine of the single-program model, and
the serving helpers the engines share (the pad token, the failure-drain
count, the batch-slot cache splice). Counterpart of
``repro.serving.engine``.

A fixed number of batch *slots* decode in lock-step (one ``decode_step``
per tick over every slot; dead slots carry their last token and their
outputs are ignored). Requests arrive in a queue; a free slot triggers a
one-sequence ``Model.prefill`` whose cache is spliced into the batch cache
at the slot index. A dead slot's position keeps growing past the cache;
the cache writers drop those writes and split-KV clamps their lengths.

Fault tolerance: ``simulate_failure(frac)`` drains the ``ceil(frac ·
n_slots)`` lowest slots, which stand in for the failed fraction of the
fleet: their in-flight requests re-queue (keeping their arrival and start
timestamps, so TTFT spans the outage) and only their positions are zeroed.

As in JAX, the engine admits requests by their tokens only (no
``frames``), so it cannot serve an enc-dec arch such as whisper: drive
``Model.prefill`` / ``decode_step`` directly for those.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, List, Optional

import numpy as np
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


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (S,) int32
    max_new_tokens: int
    arrived: float = 0.0
    started: float = 0.0
    finished: float = 0.0
    output: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens


@dataclasses.dataclass
class EngineStats:
    ticks: int = 0
    tokens_out: int = 0
    prefills: int = 0
    requeued: int = 0
    replans: int = 0

    def throughput(self, wall: float) -> float:
        return self.tokens_out / wall if wall > 0 else 0.0


class DecodeEngine:
    """Lock-step continuous batching over ``n_slots`` sequences of one
    ``models.model.Model``, on the model's device. Sampling
    (``greedy=False``) draws from ``np.random.RandomState(seed)`` in the
    JAX engine's order, so a sampled run on the same logits picks the same
    tokens."""

    def __init__(self, model, params, n_slots: int, max_len: int,
                 greedy: bool = True, seed: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.greedy = greedy
        self.rng = np.random.RandomState(seed)

        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.cache = model.init_cache(n_slots, max_len)
        self.cur_tokens = np.zeros((n_slots,), np.int32)
        self.stats = EngineStats()

    # ---- request management -------------------------------------------------

    def submit(self, req: Request) -> None:
        req.arrived = time.time()
        self.queue.append(req)

    def _sample(self, row: np.ndarray) -> int:
        """A seeded draw from softmax(row), row float32 on the host."""
        p = np.exp(row - row.max())
        p = p / p.sum()
        return int(self.rng.choice(p.shape[0], p=p / p.sum()))

    def _select(self, logits_row: torch.Tensor) -> int:
        """Greedy (the first maximal index) or a seeded draw; shared by the
        prefill and the decode tick, so ``greedy=False`` applies to every
        token."""
        if self.greedy:
            return int(torch.argmax(logits_row))
        return self._sample(logits_row.float().cpu().numpy())

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            if req.started == 0.0:       # re-admissions keep the original
                req.started = time.time()    # timestamp: TTFT spans outages
            tokens = torch.as_tensor(req.prompt[None, :],
                                     device=self.model.device)
            logits, cache1 = self.model.prefill(self.params,
                                                {"tokens": tokens},
                                                max_len=self.max_len)
            splice_batch_slot(self.cache, cache1, slot, self.n_slots)
            first = self._select(logits[0])
            req.output.append(first)
            self.slots[slot] = req
            self.cur_tokens[slot] = first
            self.stats.prefills += 1
            self.stats.tokens_out += 1   # the prefill-produced first token

    # ---- the decode tick ----------------------------------------------------

    def tick(self) -> int:
        """One lock-step decode over all slots. Returns the live count."""
        self._admit()
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return 0
        tokens = torch.as_tensor(self.cur_tokens, device=self.model.device)
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    tokens)
        # one host read per tick for the picks and one for the positions
        if self.greedy:
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        else:
            rows = logits.float().cpu().numpy()
            nxt = np.zeros(self.n_slots, np.int64)
            for i in live:
                nxt[i] = self._sample(rows[i])
        pos = self.cache["pos"].tolist()
        for i in live:
            req = self.slots[i]
            req.output.append(int(nxt[i]))
            self.cur_tokens[i] = nxt[i]
            self.stats.tokens_out += 1
            if req.done or pos[i] >= self.max_len - 1:
                req.finished = time.time()
                self.slots[i] = None
        self.stats.ticks += 1
        return len(live)

    def run(self, max_ticks: int = 10_000) -> None:
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.stats.ticks < max_ticks:
            self.tick()

    # ---- fault tolerance ----------------------------------------------------

    def simulate_failure(self, frac_nodes_lost: float) -> int:
        """Fail ``frac_nodes_lost`` of capacity: ``ceil(frac · n_slots)``
        slots (the lowest indices) drain their in-flight requests back to
        the queue for a fresh generation; survivors keep decoding. Returns
        the number of requeued requests; ``stats.replans`` counts the
        failures, as in JAX (whose optional re-plan callback has no caller
        and is not carried)."""
        n_drain = failure_drain_count(frac_nodes_lost, self.n_slots)
        requeued = 0
        for i in range(n_drain):
            req = self.slots[i]
            if req is not None:
                req.output.clear()       # restart generation after recovery
                self.queue.appendleft(req)
                self.slots[i] = None
                requeued += 1
        if n_drain:
            # only the drained slots' caches are stale; zero their positions
            # so the next admit overwrites them
            self.cache["pos"][:n_drain] = 0
        self.stats.requeued += requeued
        self.stats.replans += 1
        return requeued
