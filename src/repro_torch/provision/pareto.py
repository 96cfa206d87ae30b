"""Exact streaming Pareto frontier for the provisioning search.

A copy of ``repro.provision.pareto`` (the port imports nothing of ``repro``).

The search streams ~10^6 candidate deployments through this structure and
never holds the grid: the frontier keeps only the non-dominated set over a
fixed vector of *maximize* objectives (the search canonicalizes $/token as
its negative). Insertion is two-stage:

  1. a vectorized batch prefilter drops every candidate weakly dominated
     by the current frontier (one broadcast compare per tile — this kills
     almost everything once the frontier has formed);
  2. survivors go through the exact per-point insert, which also evicts
     incumbents the new point strictly dominates.

Weak-dominance rejection makes ties first-wins: a candidate exactly equal
to an incumbent on every objective is dropped. Stream order is the
deterministic row-major tile order, so repeated runs with the same grid
parameters produce the identical frontier (the CI determinism gate relies
on this).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


class ParetoFrontier:
    """Non-dominated set under elementwise maximization."""

    def __init__(self, n_objectives: int = 3):
        if n_objectives < 1:
            raise ValueError("need at least one objective")
        self.n_objectives = n_objectives
        self._vals = np.empty((0, n_objectives), dtype=np.float64)
        self._payloads: List[object] = []
        self.offered = 0
        self.accepted = 0
        self.evicted = 0

    def __len__(self) -> int:
        return len(self._payloads)

    @property
    def values(self) -> np.ndarray:
        """(k, n_objectives) frontier metric matrix (copy-free view)."""
        return self._vals

    def dominated_mask(self, metrics: np.ndarray,
                       block: int = 4096, f_chunk: int = 1024) -> np.ndarray:
        """Per-row True where the current frontier weakly dominates the row.

        Vectorized 2-D compares (no (k, m, d) broadcast): incumbents are
        visited strongest-first-objective-first in chunks, and candidates
        already proven dominated drop out of later chunks — on provisioning
        workloads almost every candidate dies against the first incumbent
        chunk, so the cost is ≈ one (f_chunk × block) compare per block
        rather than the full k × m product.
        """
        metrics = np.asarray(metrics, dtype=np.float64)
        if metrics.ndim != 2 or metrics.shape[1] != self.n_objectives:
            raise ValueError(
                f"expected (m, {self.n_objectives}) metrics,"
                f" got {metrics.shape}")
        out = np.zeros(len(metrics), dtype=bool)
        if not len(self._payloads):
            return out
        strongest = np.argsort(-self._vals[:, 0], kind="stable")
        fvals = self._vals[strongest]
        for lo in range(0, len(metrics), block):
            cand = metrics[lo:lo + block]
            alive = np.arange(len(cand))
            dom = np.zeros(len(cand), dtype=bool)
            for flo in range(0, len(fvals), f_chunk):
                fc = fvals[flo:flo + f_chunk]
                ge = fc[:, 0][:, None] >= cand[alive, 0][None, :]
                for d in range(1, self.n_objectives):
                    ge &= fc[:, d][:, None] >= cand[alive, d][None, :]
                hit = ge.any(axis=0)
                dom[alive[hit]] = True
                alive = alive[~hit]
                if not alive.size:
                    break
            out[lo:lo + block] = dom
        return out

    def offer(self, metrics: Sequence[float], payload: object) -> bool:
        """Exact insert of one point; returns True if it joined the frontier."""
        v = np.asarray(metrics, dtype=np.float64)
        if v.shape != (self.n_objectives,):
            raise ValueError(
                f"expected {self.n_objectives} objectives, got {v.shape}")
        self.offered += 1
        if self._vals.size:
            # Reject if any incumbent is ≥ everywhere (weak dominance —
            # exact ties lose to the earlier arrival).
            if (self._vals >= v).all(axis=1).any():
                return False
            # Evict incumbents the newcomer strictly dominates.
            le = self._vals <= v
            dominated = le.all(axis=1) & (self._vals < v).any(axis=1)
            if dominated.any():
                self.evicted += int(dominated.sum())
                keep = ~dominated
                self._vals = self._vals[keep]
                self._payloads = [p for p, k in zip(self._payloads, keep)
                                  if k]
        self._vals = np.concatenate([self._vals, v[None, :]], axis=0)
        self._payloads.append(payload)
        self.accepted += 1
        return True

    def offer_batch(self, metrics: np.ndarray,
                    make_payload: Callable[[int], object],
                    block: int = 4096) -> int:
        """Offer a batch; payloads are built lazily for accepted points only.

        Fully vectorized — no per-point Python loop. The batch is processed
        in lexicographically descending objective order in blocks; each
        block is (1) prefiltered against the current frontier, (2) reduced
        to its internal non-dominated set with one triangular pairwise
        compare (the sort order guarantees earlier rows can't be dominated
        by later ones except at exact ties, where the earlier row wins),
        (3) bulk-appended after evicting incumbents the block strictly
        dominates. ``make_payload(i)`` runs only for the accepted rows.

        The result is the exact weak-dominance frontier with first-wins
        ties, identical to offering every row through :meth:`offer` in the
        same sorted order.
        """
        metrics = np.asarray(metrics, dtype=np.float64)
        if metrics.size == 0:
            return 0
        if metrics.ndim != 2 or metrics.shape[1] != self.n_objectives:
            raise ValueError(
                f"expected (m, {self.n_objectives}) metrics,"
                f" got {metrics.shape}")
        n_in = len(metrics)
        self.offered += n_in
        # Descending lexicographic order over all objectives: row j < i can
        # only dominate row i, never the reverse (ties resolve first-wins).
        order = np.lexsort(tuple(metrics[:, d]
                                 for d in range(self.n_objectives - 1, -1,
                                                -1)))[::-1]
        added = 0
        for lo in range(0, n_in, block):
            rows = order[lo:lo + block]
            rows = rows[~self.dominated_mask(metrics[rows])]
            if not rows.size:
                continue
            m = metrics[rows]
            # Triangular pairwise weak dominance within the sorted block:
            # ge[j, i] ⇔ row j ≥ row i on every objective beyond the first
            # (the sort covers the first); only j < i can dominate.
            ge = np.ones((len(rows), len(rows)), dtype=bool)
            for d in range(1, self.n_objectives):
                ge &= m[:, None, d] >= m[None, :, d]
            keep_local = ~np.triu(ge, k=1).any(axis=0)
            rows = rows[keep_local]
            m = m[keep_local]
            # Evict incumbents strictly dominated by any accepted row
            # (chunked over incumbents to bound the broadcast temporaries).
            if self._vals.size:
                dominated_old = np.zeros(len(self._vals), dtype=bool)
                for olo in range(0, len(self._vals), 2048):
                    old = self._vals[olo:olo + 2048]
                    ge_old = (m[:, None, :] >= old[None, :, :]).all(2)
                    gt_old = (m[:, None, :] > old[None, :, :]).any(2)
                    dominated_old[olo:olo + 2048] = (ge_old & gt_old).any(0)
                if dominated_old.any():
                    self.evicted += int(dominated_old.sum())
                    keep = ~dominated_old
                    self._vals = self._vals[keep]
                    self._payloads = [p for p, k in
                                      zip(self._payloads, keep) if k]
            self._vals = np.concatenate([self._vals, m], axis=0)
            self._payloads.extend(make_payload(int(i)) for i in rows)
            self.accepted += len(rows)
            added += len(rows)
        return added

    def sorted_entries(self) -> List[tuple]:
        """(metrics_tuple, payload) pairs in canonical order.

        Sorted by descending objectives (first objective primary). The
        frontier *set* is insertion-order-dependent only at exact metric
        ties, so this canonical ordering makes serialized output stable
        across runs with identical grid parameters.
        """
        idx = np.lexsort(tuple(self._vals[:, d]
                               for d in range(self.n_objectives - 1, -1, -1)))
        out = []
        for i in idx[::-1]:
            out.append((tuple(float(x) for x in self._vals[i]),
                        self._payloads[i]))
        return out
