"""The million-point provisioning search (streamed, memory-bounded). A
copy of ``repro.provision.search``; host numpy, no torch.

Grid = the 6-axis sweep grid (model × hardware × scenario × bw_scale ×
b_cap × N_F) × an ``n_a_slack`` axis (extra attention nodes beyond the
planner's minimum). Every point is priced with:

  * Eqs. 6–9 via the tiled sweep core (``repro_torch.api.sweep_tiles``);
  * the attention fleet it needs: N_A = ⌈ffn_tokens / a_tok⌉ + slack,
    where a_tok is the planner's decode-attention roofline
    (``planner.attention_tokens_per_node``);
  * the §3.3 discrete imbalance penalty α_AFD(σ, N_A, N_F) (Eq. 16,
    vectorized) — giving HFU_eff = HFU × α;
  * $/Mtok from the per-hardware ``cost_per_device_hour`` metadata
    (CLI-overridable).

Eligibility: expert weights fit in HBM (Eq. 6 feasibility), the grouped
GEMM finishes strictly inside the stage budget (temporal sparsity < 1 ⇒
positive latency slack), and the model actually routes experts. Eligible
points stream into an exact Pareto frontier over

    (HFU_eff ↑, latency budget slack ↑, $/Mtok ↓)

and per-(model, hardware, scenario) champions (best HFU_eff) are tracked
for the AFD-vs-EP recommendation — all without ever materializing the
full grid: peak residency is one sweep tile plus the frontier.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api import registry
from repro_torch.api.sweep import (DEFAULT_TILE_POINTS, GridSpec, SweepTile,
                             resolve_grid, tiles_from_grid)
from repro_torch.core import planner as pln
from repro_torch.provision import pricing
from repro_torch.provision.pareto import ParetoFrontier

DEFAULT_SIGMA = 0.8

# Default grid axes: every paper model on every registry platform under the
# four named scenarios, swept over link derating, offered-batch caps, a wide
# N_F range, and 0/+1 attention-node slack. 6·10·4·4·6·96·2 = 1,105,920
# points — past the 10^6-point bar while each axis still means something
# (no padding axes).
DEFAULT_BW_SCALE = (0.5, 0.75, 1.0, 1.25)
DEFAULT_B_CAP = (float("inf"), 4096.0, 2048.0, 1024.0, 512.0, 256.0)
DEFAULT_N_F_MAX = 96
DEFAULT_N_A_SLACK = (0, 1)


@dataclasses.dataclass(frozen=True)
class ProvisionGrid:
    """A fully resolved provisioning search space."""
    spec: GridSpec
    n_a_slack: Tuple[int, ...] = DEFAULT_N_A_SLACK
    sigma: float = DEFAULT_SIGMA
    ep_lambda: float = pricing.DEFAULT_EP_LAMBDA
    cost_overrides: Tuple[Tuple[str, float], ...] = ()

    @property
    def points(self) -> int:
        return self.spec.size * len(self.n_a_slack)

    def cost_for(self, hw) -> float:
        for name, usd in self.cost_overrides:
            if name == hw.name:
                return usd
        return hw.cost_per_device_hour


def default_grid(models=None, hardware=None, scenarios=None,
                 n_f_max: int = DEFAULT_N_F_MAX,
                 bw_scale: Sequence[float] = DEFAULT_BW_SCALE,
                 b_cap: Sequence[float] = DEFAULT_B_CAP,
                 n_a_slack: Sequence[int] = DEFAULT_N_A_SLACK,
                 sigma: float = DEFAULT_SIGMA,
                 ep_lambda: float = pricing.DEFAULT_EP_LAMBDA,
                 cost_overrides: Dict[str, float] | None = None,
                 weight_bytes: float = 1.0
                 ) -> ProvisionGrid:
    """The stock search space (≈2.2M points); every axis overridable."""
    from repro_torch.core.modelspec import PAPER_MODELS
    if models is None:
        models = list(PAPER_MODELS)
    if hardware is None:
        hardware = registry.list_hardware()
    if scenarios is None:
        scenarios = sorted(registry.SCENARIOS)
    if n_f_max < 1:
        raise ValueError(f"n_f_max must be ≥ 1, got {n_f_max}")
    slack = tuple(int(s) for s in n_a_slack)
    if not slack or any(s < 0 for s in slack):
        raise ValueError("n_a_slack must be non-empty, all entries ≥ 0")
    spec = resolve_grid(models, hardware, n_f=range(1, n_f_max + 1),
                        scenarios=list(scenarios), bw_scale=list(bw_scale),
                        b_cap=list(b_cap), weight_bytes=weight_bytes)
    overrides = tuple(sorted((cost_overrides or {}).items()))
    return ProvisionGrid(spec=spec, n_a_slack=slack, sigma=sigma,
                         ep_lambda=ep_lambda, cost_overrides=overrides)


@dataclasses.dataclass
class ProvisionResult:
    """Everything the search keeps from the streamed grid."""
    points: int                   # grid cells × slack values priced
    eligible: int                 # points that passed HBM + SLO + MoE
    counters: Dict[str, int]      # ineligibility breakdown
    frontier: List[dict]          # canonical-order Pareto entries
    champions: Dict[str, dict]    # "model|hw|scenario" → best-HFU_eff point
    ep: Dict[str, dict]           # "model|hw" → EP baseline
    sigma: float
    ep_lambda: float
    shape: Tuple[int, ...]        # sweep-grid shape (slack axis excluded)
    tiles: int
    frontier_offered: int
    frontier_evicted: int

    def to_obj(self) -> dict:
        return {
            "points": self.points,
            "eligible": self.eligible,
            "counters": dict(self.counters),
            "sigma": self.sigma,
            "ep_lambda": self.ep_lambda,
            "shape": list(self.shape),
            "tiles": self.tiles,
            "frontier_size": len(self.frontier),
            "frontier_offered": self.frontier_offered,
            "frontier_evicted": self.frontier_evicted,
            "frontier": self.frontier,
            "champions": self.champions,
            "ep_baselines": self.ep,
        }


def _point_payload(labels: dict, hfu: float, alpha: float, hfu_eff: float,
                   slack_frac: float, cost: float, n_a: int, n_a_slack: int,
                   extra: dict) -> dict:
    body = dict(labels)
    body.update(n_a=n_a, n_a_slack=n_a_slack,
                total_nodes=n_a + int(labels["n_f"]),
                hfu=round(float(hfu), 12), alpha=round(float(alpha), 12),
                hfu_eff=round(float(hfu_eff), 12),
                slack_frac=round(float(slack_frac), 12),
                cost_per_mtok=round(float(cost), 9))
    body.update(extra)
    return body


def search(grid: ProvisionGrid,
           tile_points: int = DEFAULT_TILE_POINTS,
           processes: Optional[int] = None) -> ProvisionResult:
    """Stream the grid through the tiled sweep and price every point."""
    spec = grid.spec
    sigma, slacks = grid.sigma, grid.n_a_slack
    frontier = ParetoFrontier(n_objectives=3)
    champions: Dict[str, dict] = {}
    counters = {"hbm_infeasible": 0, "slo_exceeded": 0, "dense_model": 0}
    eligible_total = 0
    tiles = 0

    f_tok_by_model = {m.name: pricing.ffn_flops_per_token(m)
                      for m in spec.models}
    usd_by_hw = {h.name: grid.cost_for(h) for h in spec.hardware}

    for tile in tiles_from_grid(spec, tile_points=tile_points,
                                processes=processes):
        tiles += 1
        eligible_total += _price_tile(grid, tile, frontier, champions,
                                      counters, f_tok_by_model, usd_by_hw)

    ep: Dict[str, dict] = {}
    for m in spec.models:
        if not m.is_moe:
            continue
        for h in spec.hardware:
            base = pricing.ep_baseline(m, h, sigma, grid.ep_lambda,
                                       cost_per_device_hour=usd_by_hw[h.name])
            ep[f"{m.name}|{h.name}"] = dataclasses.asdict(base)

    frontier_rows = [dict(payload, objectives=list(metrics))
                     for metrics, payload in frontier.sorted_entries()]
    return ProvisionResult(
        points=grid.points, eligible=eligible_total, counters=counters,
        frontier=frontier_rows, champions=champions, ep=ep,
        sigma=sigma, ep_lambda=grid.ep_lambda, shape=spec.shape,
        tiles=tiles, frontier_offered=frontier.offered,
        frontier_evicted=frontier.evicted)


def _price_tile(grid: ProvisionGrid, tile: SweepTile,
                frontier: ParetoFrontier, champions: Dict[str, dict],
                counters: Dict[str, int], f_tok_by_model: Dict[str, float],
                usd_by_hw: Dict[str, float]) -> int:
    """Price one sweep tile into the frontier; returns its eligible count."""
    spec = grid.spec
    i0, j0, k0, l0, c0, n0 = tile.offsets
    P, Q, S, L, C, N = tile.shape
    models = spec.models[i0:i0 + P]
    hardware = spec.hardware[j0:j0 + Q]
    scen_names = spec.scenario_names[k0:k0 + S]
    bw = spec.bw_scale[l0:l0 + L]
    cap = spec.b_cap[c0:c0 + C]
    nf = spec.n_f[n0:n0 + N]

    hfu = tile.fields["hfu"]
    s_t = tile.fields["temporal_sparsity"]
    feasible = tile.fields["feasible"]
    b_rank = tile.fields["b_rank"]
    t_b = tile.fields["t_budget"]

    g = np.array([h.gpus_per_node for h in hardware],
                 dtype=np.float64).reshape(1, Q, 1, 1, 1, 1)
    peak = np.array([h.peak_flops for h in hardware],
                    dtype=np.float64).reshape(1, Q, 1, 1, 1, 1)
    usd = np.array([usd_by_hw[h.name] for h in hardware],
                   dtype=np.float64).reshape(1, Q, 1, 1, 1, 1)
    f_tok = np.array([f_tok_by_model[m.name] for m in models],
                     dtype=np.float64).reshape(P, 1, 1, 1, 1, 1)
    is_moe = np.array([m.is_moe for m in models],
                      dtype=bool).reshape(P, 1, 1, 1, 1, 1)
    nf_b = nf.astype(np.float64).reshape(1, 1, 1, 1, 1, N)

    # Decode-attention roofline tokens/node per t_B — (model, hw, scenario)
    # only (bw_scale touches the interconnect, not the HBM/compute terms).
    a_tok = np.empty((P, Q, S, 1, 1, 1))
    for i, m in enumerate(models):
        for j, h in enumerate(hardware):
            for k in range(S):
                a_tok[i, j, k, 0, 0, 0] = pln.attention_tokens_per_node(
                    m, h, float(t_b[i, j, k, 0, 0, 0]))

    ffn_tokens = b_rank * nf_b * g
    n_a_min = np.maximum(1.0, np.ceil(ffn_tokens / a_tok))
    slack_frac = 1.0 - s_t
    base_ok = feasible & (s_t < 1.0) & is_moe

    # Ineligibility breakdown (per slack value the masks are identical, so
    # count once per tile and scale by the slack-axis length).
    n_slack = len(grid.n_a_slack)
    dense = ~np.broadcast_to(is_moe, hfu.shape)
    hbm = ~feasible & ~dense
    slo = np.broadcast_to(s_t >= 1.0, hfu.shape) & ~dense & feasible
    counters["dense_model"] += int(dense.sum()) * n_slack
    counters["hbm_infeasible"] += int(hbm.sum()) * n_slack
    counters["slo_exceeded"] += int(slo.sum()) * n_slack

    eligible_count = 0
    for s_extra in grid.n_a_slack:
        n_a = n_a_min + float(s_extra)
        if grid.sigma < 1.0:
            alpha = pricing.alpha_afd_array(grid.sigma, n_a, nf_b)
        else:
            alpha = np.ones_like(hfu)
        hfu_eff = hfu * alpha
        cost = pricing.cost_per_mtoken(
            n_a + nf_b, g, usd, hfu_eff, peak, nf_b, f_tok)
        ok = base_ok & (hfu_eff > 0.0) & np.isfinite(cost)
        idx = np.nonzero(ok)
        m_count = len(idx[0])
        if not m_count:
            continue
        eligible_count += m_count
        metrics = np.stack([
            np.broadcast_to(hfu_eff, hfu.shape)[idx],
            np.broadcast_to(slack_frac, hfu.shape)[idx],
            -np.broadcast_to(cost, hfu.shape)[idx],
        ], axis=1)
        n_a_full = np.broadcast_to(n_a, hfu.shape)
        alpha_full = np.broadcast_to(alpha, hfu.shape)
        cost_full = np.broadcast_to(cost, hfu.shape)

        def make_payload(row: int, _idx=idx, _n_a=n_a_full,
                         _alpha=alpha_full, _cost=cost_full,
                         _s=s_extra) -> dict:
            cell = tuple(int(ax[row]) for ax in _idx)
            i, j, k, l, c, n = cell
            labels = dict(
                model=models[i].name, hardware=hardware[j].name,
                scenario=scen_names[k], bw_scale=float(bw[l]),
                b_cap=(None if math.isinf(cap[c]) else float(cap[c])),
                n_f=int(nf[n]))
            extra = dict(
                b_rank=round(float(b_rank[cell]), 6),
                regime=str(tile.fields["regime"][cell]),
                bottleneck=str(tile.fields["bottleneck"][cell]),
                t_budget=round(float(t_b[cell]), 9))
            return _point_payload(
                labels, hfu[cell], _alpha[cell],
                hfu[cell] * _alpha[cell], 1.0 - s_t[cell], _cost[cell],
                int(_n_a[cell]), _s, extra)

        frontier.offer_batch(metrics, make_payload)

        # Per-(model, hardware, scenario) champions by HFU_eff. ``ok`` is
        # already materialized; one argmax per axis triple in the tile.
        heff_masked = np.where(ok, np.broadcast_to(hfu_eff, hfu.shape),
                               -np.inf)
        best_per = heff_masked.reshape(P, Q, S, -1).max(axis=3)
        for i in range(P):
            for j in range(Q):
                for k in range(S):
                    best = best_per[i, j, k]
                    if not np.isfinite(best):
                        continue
                    key = (f"{models[i].name}|{hardware[j].name}"
                           f"|{scen_names[k]}")
                    prev = champions.get(key)
                    if prev is not None and prev["hfu_eff"] >= best:
                        continue
                    flat = int(np.argmax(heff_masked[i, j, k]))
                    l, c, n = np.unravel_index(flat, (L, C, N))
                    cell = (i, j, k, int(l), int(c), int(n))
                    row = _cell_row(idx, cell)
                    champions[key] = make_payload(row)

    return eligible_count


def _cell_row(idx: Tuple[np.ndarray, ...], cell: Tuple[int, ...]) -> int:
    """Row position of ``cell`` inside the np.nonzero index tuple."""
    mask = np.ones(len(idx[0]), dtype=bool)
    for ax, v in zip(idx, cell):
        mask &= (ax == v)
    rows = np.nonzero(mask)[0]
    if not len(rows):
        raise RuntimeError(f"cell {cell} not among eligible indices")
    return int(rows[0])
