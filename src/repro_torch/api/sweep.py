"""Vectorized grid evaluation of the §3 analysis hot path: a copy of
``repro.api.sweep`` (numpy only; the port imports nothing of ``repro``).

``sweep()`` evaluates the communication-extended roofline (Eq. 9) and the
HFU bound (Eqs. 6–8) over the full cartesian grid

    model × hardware × scenario × bw_scale × b_cap × N_F

as numpy array arithmetic — thousands of points in one shot instead of a
Python loop over ``repro_torch.core.hfu_bound.hfu_point``. The implementation
mirrors the scalar code *operation by operation* (same association order,
same guards, same tolerances) so results are **bit-exact** equal to the
scalar reference; ``tests/test_torch_api.py`` holds every field
bit for bit to the JAX package's sweep.

The evaluation is *streamed*: :func:`sweep_tiles` yields memory-bounded
rectangular tiles of the grid (at most ``tile_points`` cells of field
arrays resident per tile), optionally sharded across worker processes
along the model × hardware axes. :func:`sweep` is a thin concatenating
wrapper over the tile stream — million-point grids (the
``repro_torch.provision`` search space) never materialize more than one tile of
intermediate arrays per worker, while small grids (Fig. 4) still evaluate
as a single tile with zero overhead. Because every grid cell is an
independent elementwise computation, the tiling is value-neutral: any
tile shape produces bit-identical fields.

Axes beyond the paper's Fig. 4 grid:
  * ``bw_scale`` — multiplies both interconnect tiers (link derating /
    upgrade studies, paper footnote 3);
  * ``b_cap``   — caps Eq. 9 token inflow per rank (offered decode batch
    smaller than what the wire could deliver).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import comm_roofline as cr
from repro_torch.core import hfu_bound as hb
from repro_torch.core.budget import WIRE_BYTES_PER_ELEM, Scenario
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec

from repro_torch.api import registry
from repro_torch.api.records import Record

_REGIMES = np.array([cr.REGIME_MAX_INTENSITY, cr.REGIME_SCALE_UP_BOUND,
                     cr.REGIME_SCALE_OUT_BOUND, cr.REGIME_STABLE])
_BOTTLENECKS = np.array(["compute", "hbm", "interconnect"])

# Field arrays a sweep produces, in record order.
FIELDS = ("feasible", "b_rank", "local_experts", "tokens_per_expert",
          "intensity", "ofu", "temporal_sparsity", "hfu", "regime",
          "bottleneck", "t_budget")

# Per-cell field bytes: bool + 7×f64 + regime (<U16) + bottleneck (<U12)
# + t_budget f64. Used by the tile-footprint accounting (and its test).
FIELD_ITEMSIZES = {
    "feasible": 1, "b_rank": 8, "local_experts": 8, "tokens_per_expert": 8,
    "intensity": 8, "ofu": 8, "temporal_sparsity": 8, "hfu": 8,
    "regime": 4 * 16, "bottleneck": 4 * 12, "t_budget": 8,
}
BYTES_PER_CELL = sum(FIELD_ITEMSIZES.values())

# Default tile budget: ≤ 2^16 grid cells of field arrays resident at once
# (≈ 11 MiB of output fields per tile plus same-order temporaries).
DEFAULT_TILE_POINTS = 1 << 16


def _as_models(models) -> List[MoEModelSpec]:
    if isinstance(models, (str, MoEModelSpec)):
        models = [models]
    return [registry.resolve_model(m) for m in models]


def _as_hardware(hardware) -> List[HardwareSpec]:
    if isinstance(hardware, (str, HardwareSpec)):
        hardware = [hardware]
    return [registry.resolve_hardware(h) for h in hardware]


def _as_scenarios(scenarios) -> List[Scenario]:
    if isinstance(scenarios, (str, Scenario)):
        scenarios = [scenarios]
    return [registry.resolve_scenario(s) for s in scenarios]


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Dense result grid with shape (P models, Q hardware, S scenarios,
    L bw_scales, C b_caps, N n_f values); fields are numpy arrays of that
    shape (regime/bottleneck are string arrays)."""

    models: tuple                 # MoEModelSpec per P
    hardware: tuple               # HardwareSpec per Q
    scenarios: tuple              # Scenario per S
    scenario_names: tuple         # str per S
    bw_scale: np.ndarray          # (L,)
    b_cap: np.ndarray             # (C,)  np.inf = uncapped
    n_f: np.ndarray               # (N,)
    fields: Dict[str, np.ndarray]
    weight_bytes: float = 1.0     # expert-weight bytes/param (Eq. 6 Mem)

    @property
    def shape(self):
        return self.fields["hfu"].shape

    @property
    def size(self) -> int:
        return int(self.fields["hfu"].size)

    def __len__(self) -> int:
        return self.size

    def axis_labels(self, idx) -> Dict[str, object]:
        i, j, k, l, c, n = idx
        lab = dict(model=self.models[i].name,
                   hardware=self.hardware[j].name,
                   scenario=self.scenario_names[k],
                   n_f=int(self.n_f[n]))
        if len(self.bw_scale) > 1 or self.bw_scale[0] != 1.0:
            lab["bw_scale"] = float(self.bw_scale[l])
        if len(self.b_cap) > 1 or np.isfinite(self.b_cap[c]):
            lab["b_cap"] = float(self.b_cap[c])
        if self.weight_bytes != 1.0:
            lab["weight_bytes"] = float(self.weight_bytes)
        return lab

    def record(self, idx) -> Record:
        body = self.axis_labels(idx)
        for name in FIELDS:
            v = self.fields[name][idx]
            body[name] = v.item() if isinstance(v, np.generic) else str(v)
        return Record.from_obj(body)

    def records(self) -> List[Record]:
        return [self.record(idx) for idx in np.ndindex(*self.shape)]

    def ceilings(self, feasible_only: bool = True,
                 per_model_bounds: bool = True) -> List[Record]:
        """Best-HFU point over N_F for every (model, hardware, scenario,
        bw_scale, b_cap) cell — the Fig. 4 envelope, vectorized.

        Matches ``hfu_bound.hfu_ceiling`` exactly: restrict to
        memory-feasible N_F (falling back to all when nothing fits), take
        the first maximum. ``per_model_bounds`` additionally restricts each
        model to its own default sweep bound (as the scalar sweep does when
        given no explicit ``n_f``).
        """
        hfu = self.fields["hfu"]
        feas = self.fields["feasible"]
        allowed = np.ones(self.shape, dtype=bool)
        if per_model_bounds:
            for i, m in enumerate(self.models):
                for j, h in enumerate(self.hardware):
                    bound = hb.default_n_f_max(m, h)
                    allowed[i, j] &= (self.n_f <= bound)
        out: List[Record] = []
        for idx in np.ndindex(*self.shape[:-1]):
            ok = allowed[idx]
            pool = ok & feas[idx] if feasible_only else ok
            if not pool.any():
                pool = ok
            if not pool.any():
                continue
            masked = np.where(pool, hfu[idx], -np.inf)
            n = int(np.argmax(masked))
            out.append(self.record(idx + (n,)))
        return out

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        from repro_torch.api.records import dump_records
        return dump_records(self.records(), path, indent)


def _default_n_f(models, hardware) -> np.ndarray:
    bound = max(hb.default_n_f_max(m, h) for m in models for h in hardware)
    return np.arange(1, bound + 1)


def _scenario_names(scenarios) -> tuple:
    if isinstance(scenarios, (str, Scenario)):
        scenarios = [scenarios]
    return tuple(registry.scenario_name(s) for s in scenarios)


# ---------------------------------------------------------------------------
# Grid resolution + tiling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A fully resolved sweep grid: concrete axis values, no evaluation."""
    models: tuple                 # MoEModelSpec per P
    hardware: tuple               # HardwareSpec per Q
    scenarios: tuple              # Scenario per S
    scenario_names: tuple
    bw_scale: np.ndarray          # (L,)
    b_cap: np.ndarray             # (C,)
    n_f: np.ndarray               # (N,)
    weight_bytes: float = 1.0     # expert-weight bytes/param (Eq. 6 Mem)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.models), len(self.hardware), len(self.scenarios),
                len(self.bw_scale), len(self.b_cap), len(self.n_f))

    @property
    def size(self) -> int:
        s = 1
        for d in self.shape:
            s *= d
        return s


def resolve_grid(models, hardware, n_f=None, scenarios="default",
                 bw_scale: Union[float, Sequence[float]] = 1.0,
                 b_cap: Union[None, float, Sequence[float]] = None,
                 weight_bytes: float = 1.0
                 ) -> GridSpec:
    """Resolve names → specs and validate the axis arrays (no evaluation).

    ``weight_bytes`` (bytes/param, scalar) scales the grouped GEMM's Mem
    term and the HBM feasibility test across the whole grid — see
    ``budget.WEIGHT_BYTES_PER_PARAM`` for the named widths. At the default
    1.0 (the paper's fp8 assumption) every cell is bit-identical to the
    pre-quantization sweep.
    """
    if not (weight_bytes > 0):
        raise ValueError(f"weight_bytes must be positive, got {weight_bytes}")
    models = _as_models(models)
    hardware = _as_hardware(hardware)
    scens = _as_scenarios(scenarios)
    scen_names = _scenario_names(scenarios)
    if n_f is None:
        n_f = _default_n_f(models, hardware)
    nf = np.asarray(list(n_f) if not isinstance(n_f, np.ndarray) else n_f,
                    dtype=np.int64)
    if nf.ndim != 1 or nf.size == 0 or (nf < 1).any():
        raise ValueError("n_f must be a non-empty 1-D sequence of ints ≥ 1")
    bw = np.atleast_1d(np.asarray(bw_scale, dtype=np.float64))
    cap = (np.array([np.inf])
           if b_cap is None
           else np.atleast_1d(np.asarray(b_cap, dtype=np.float64)))
    return GridSpec(models=tuple(models), hardware=tuple(hardware),
                    scenarios=tuple(scens), scenario_names=scen_names,
                    bw_scale=bw, b_cap=cap, n_f=nf,
                    weight_bytes=float(weight_bytes))


def tile_spans(shape: Sequence[int],
               tile_points: int = DEFAULT_TILE_POINTS
               ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Partition a 6-D grid into rectangular (offsets, tile_shape) spans.

    Chunk sizes grow innermost-axis-first (N_F, then b_cap, bw_scale,
    scenario, hardware, model) so small grids stay a single tile while the
    per-tile cell count never exceeds ``tile_points``. Pure shape
    accounting — the memory-regression test calls this on 10^6-point grids
    without evaluating anything.
    """
    if len(shape) != 6:
        raise ValueError(f"expected a 6-axis grid shape, got {shape}")
    # Greedy innermost-first chunking: the running ``rem`` budget guarantees
    # prod(chunks) ≤ tile_points (each step divides the remainder).
    rem = max(1, int(tile_points))
    chunks = [1] * 6
    for ax in range(5, -1, -1):
        chunks[ax] = max(1, min(int(shape[ax]), rem))
        rem = max(1, rem // chunks[ax])
    spans = []
    starts = [range(0, shape[ax], chunks[ax]) for ax in range(6)]
    for offsets in itertools.product(*starts):
        tshape = tuple(min(chunks[ax], shape[ax] - offsets[ax])
                       for ax in range(6))
        spans.append((offsets, tshape))
    return spans


def tile_footprint_bytes(tile_shape: Sequence[int]) -> int:
    """Resident field-array bytes of one evaluated tile (output fields)."""
    cells = 1
    for d in tile_shape:
        cells *= d
    return cells * BYTES_PER_CELL


@dataclasses.dataclass(frozen=True)
class SweepTile:
    """One evaluated rectangular block of the sweep grid."""
    offsets: Tuple[int, ...]      # start index per axis in the full grid
    shape: Tuple[int, ...]        # tile extent per axis
    fields: Dict[str, np.ndarray]

    @property
    def size(self) -> int:
        return int(self.fields["hfu"].size)

    @property
    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(o, o + s) for o, s in zip(self.offsets,
                                                     self.shape))


def _evaluate_span(spec: GridSpec, offsets: Sequence[int],
                   tshape: Sequence[int]) -> Dict[str, np.ndarray]:
    """Evaluate one rectangular span of the grid (the §3 kernel).

    This is byte-for-byte the operation order of the scalar core
    (``hfu_bound.hfu_point``), applied to broadcast parameter arrays; the
    equivalence tests in tests/test_api.py hold for any span shape.
    """
    i0, j0, k0, l0, c0, n0 = offsets
    P, Q, S, L, C, N = tshape
    models = spec.models[i0:i0 + P]
    hardware = spec.hardware[j0:j0 + Q]
    scens = spec.scenarios[k0:k0 + S]
    bw = spec.bw_scale[l0:l0 + L]
    cap = spec.b_cap[c0:c0 + C]
    nf = spec.n_f[n0:n0 + N]

    # Axis parameter arrays, broadcast to (P, Q, S, L, C, N).
    def ax(vals, axis, dtype):
        shape = [1] * 6
        shape[axis] = len(vals)
        return np.asarray(vals, dtype=dtype).reshape(shape)

    H = ax([m.hidden_size for m in models], 0, np.int64)
    M = ax([m.moe_intermediate for m in models], 0, np.int64)
    E = ax([m.n_routed_experts for m in models], 0, np.int64)
    topk = ax([m.top_k for m in models], 0, np.int64)
    layers = ax([m.n_moe_layers if m.is_moe else m.n_layers
                 for m in models], 0, np.int64)
    moe_layers = ax([m.n_moe_layers for m in models], 0, np.int64)

    peak = ax([h.peak_flops for h in hardware], 1, np.float64)
    hbm_bw = ax([h.hbm_bw for h in hardware], 1, np.float64)
    hbm_cap = ax([h.hbm_cap for h in hardware], 1, np.float64)
    su = ax([h.scale_up_bw for h in hardware], 1, np.float64)
    so = ax([np.nan if h.scale_out_bw is None else h.scale_out_bw
             for h in hardware], 1, np.float64)
    g = ax([h.gpus_per_node for h in hardware], 1, np.int64)
    # Two distinct flags, as in the scalar core: b_rank collapses to the
    # scale-up term when superpod OR scale_out is absent (cr.b_rank), while
    # regime classification keys on the superpod flag alone (cr.regime).
    no_scale_out = ax([h.superpod or h.scale_out_bw is None
                       for h in hardware], 1, bool)
    superpod = ax([h.superpod for h in hardware], 1, bool)

    slo = ax([s.slo_tpot for s in scens], 2, np.float64)
    l_acc = ax([s.l_accept for s in scens], 2, np.float64)
    t_gap = ax([s.t_gap for s in scens], 2, np.float64)
    n_bo = ax([s.n_bo for s in scens], 2, np.int64)

    bw_b = bw.reshape(1, 1, 1, -1, 1, 1)
    cap_b = cap.reshape(1, 1, 1, 1, -1, 1)
    nf_b = nf.reshape(1, 1, 1, 1, 1, -1)

    # --- Eq. 1: stage budget (budget.stage_budget, op for op) --------------
    t_avail = slo * l_acc - t_gap
    if (t_avail <= 0).any():
        raise ValueError("a scenario's gap t_g exceeds its run-batch latency")
    t_b = t_avail / (layers * n_bo)

    with np.errstate(invalid="ignore", divide="ignore"):
        # --- Eq. 9: token inflow (comm_roofline.b_rank) --------------------
        su_s = su * bw_b
        so_s = so * bw_b
        b_up = su_s * t_b / (WIRE_BYTES_PER_ELEM * H)
        b_out = so_s * t_b / (WIRE_BYTES_PER_ELEM * H)
        fan = np.maximum(1.0, topk / nf_b)
        b_rank = np.where(no_scale_out, b_up, np.minimum(b_out * fan, b_up))
        b_rank = np.minimum(b_rank, cap_b)

        # --- local experts / Eq. 10 intensity ------------------------------
        g_local = np.ceil(E / (nf_b * g)).astype(np.int64)
        tok_pe = b_rank / g_local

        # --- grouped-GEMM roofline (budget.*, hfu_bound.hfu_point) ---------
        # weight_bytes multiplies LAST, mirroring the scalar core's operation
        # order exactly (×1.0 is a bitwise identity, keeping the default
        # grid byte-equal to the pre-quantization sweep).
        wb = spec.weight_bytes
        flops = 6.0 * g_local * tok_pe * H * M
        mem = 3.0 * g_local * H * M * wb
        t_comp = flops / (peak * 1.0)
        t_mem = mem / hbm_bw
        t_gemm = np.maximum(t_comp, t_mem)

        ofu = np.where(t_gemm > 0, flops / t_gemm / peak, 0.0)
        s_t = np.minimum(t_gemm / t_b, 1.0)
        s_t = np.where(t_gemm > 0, s_t, 0.0)
        hfu = ofu * s_t
        intensity = np.where(mem > 0, flops / mem, 0.0)

        # --- memory feasibility (hfu_bound.memory_feasible) ----------------
        expert_bytes = 3.0 * H * M * E * moe_layers * wb
        capacity = 0.8 * hbm_cap * nf_b * g
        feasible = expert_bytes <= capacity

        # --- regime classification (comm_roofline.regime) ------------------
        ratio = topk / nf_b
        su_over_out = su_s / so_s
        regime = np.select(
            [g_local <= 1,
             np.broadcast_to(superpod, hfu.shape),
             nf_b >= topk,
             ratio > su_over_out],
            [_REGIMES[0], _REGIMES[1], _REGIMES[2], _REGIMES[1]],
            default=_REGIMES[3])

        # --- bottleneck attribution (hfu_bound.hfu_point) ------------------
        comp_ge_mem = t_comp >= t_mem
        primary = ((t_gemm >= t_b * (1 - 1e-9)) |
                   (t_comp >= np.maximum(t_mem, 1e-30)))
        bottleneck = np.where(
            primary,
            np.where(comp_ge_mem, _BOTTLENECKS[0], _BOTTLENECKS[1]),
            np.where(t_mem > t_comp, _BOTTLENECKS[1], _BOTTLENECKS[2]))
        starved = (s_t < 1.0 - 1e-9) & (t_gemm < t_b)
        bottleneck = np.where(
            starved,
            np.where(comp_ge_mem, _BOTTLENECKS[2], _BOTTLENECKS[1]),
            bottleneck)

    shape = np.broadcast_shapes(hfu.shape)
    full = lambda a: np.broadcast_to(a, shape).copy() if a.shape != shape else a
    return {
        "feasible": full(np.asarray(feasible)),
        "b_rank": full(b_rank),
        "local_experts": full(g_local),
        "tokens_per_expert": full(tok_pe),
        "intensity": full(intensity),
        "ofu": full(ofu),
        "temporal_sparsity": full(s_t),
        "hfu": full(hfu),
        "regime": full(regime),
        "bottleneck": full(bottleneck),
        "t_budget": full(np.broadcast_to(t_b, shape).copy()),
    }


# --- multiprocess sharding -------------------------------------------------
# Workers inherit the resolved GridSpec via the pool initializer (fork),
# so per-task payloads are just (offsets, shape) tuples and the results
# stream back in deterministic task order through imap.

_WORKER_SPEC: Optional[GridSpec] = None


def _init_worker(spec: GridSpec) -> None:
    global _WORKER_SPEC
    _WORKER_SPEC = spec


def _worker_eval(span):
    offsets, tshape = span
    return offsets, tshape, _evaluate_span(_WORKER_SPEC, offsets, tshape)


def sweep_tiles(models, hardware, n_f=None, scenarios="default",
                bw_scale: Union[float, Sequence[float]] = 1.0,
                b_cap: Union[None, float, Sequence[float]] = None,
                tile_points: int = DEFAULT_TILE_POINTS,
                processes: Optional[int] = None,
                weight_bytes: float = 1.0) -> Iterator[SweepTile]:
    """Stream the §3 sweep as memory-bounded tiles (see module doc).

    Yields :class:`SweepTile` blocks covering the full grid exactly once,
    in deterministic row-major span order; at most ``tile_points`` cells of
    field arrays are resident per tile. ``processes > 1`` shards the spans
    across a process pool (fork), preserving yield order — the outermost
    span axes are model × hardware, so large multi-model searches spread
    across cores.
    """
    spec = resolve_grid(models, hardware, n_f, scenarios, bw_scale, b_cap,
                        weight_bytes=weight_bytes)
    yield from tiles_from_grid(spec, tile_points=tile_points,
                               processes=processes)


def tiles_from_grid(spec: GridSpec,
                    tile_points: int = DEFAULT_TILE_POINTS,
                    processes: Optional[int] = None) -> Iterator[SweepTile]:
    """Tile stream over an already-resolved :class:`GridSpec`."""
    spans = tile_spans(spec.shape, tile_points)
    if processes is None or processes <= 1 or len(spans) <= 1:
        for offsets, tshape in spans:
            yield SweepTile(offsets=offsets, shape=tshape,
                            fields=_evaluate_span(spec, offsets, tshape))
        return
    import multiprocessing as mp
    try:
        ctx = mp.get_context("fork")
    except ValueError:                      # platform without fork
        ctx = mp.get_context()
    with ctx.Pool(processes, initializer=_init_worker,
                  initargs=(spec,)) as pool:
        for offsets, tshape, fields in pool.imap(_worker_eval, spans):
            yield SweepTile(offsets=tuple(offsets), shape=tuple(tshape),
                            fields=fields)


def sweep(models, hardware, n_f=None, scenarios="default",
          bw_scale: Union[float, Sequence[float]] = 1.0,
          b_cap: Union[None, float, Sequence[float]] = None,
          tile_points: int = DEFAULT_TILE_POINTS,
          processes: Optional[int] = None,
          weight_bytes: float = 1.0) -> SweepResult:
    """Vectorized §3 sweep over the full parameter grid. See module doc.

    A thin concatenating wrapper over :func:`sweep_tiles`: the dense
    result arrays are allocated once and filled tile by tile, so the
    evaluation working set stays bounded regardless of grid size.
    """
    spec = resolve_grid(models, hardware, n_f, scenarios, bw_scale, b_cap,
                        weight_bytes=weight_bytes)
    fields: Dict[str, np.ndarray] = {}
    for tile in tiles_from_grid(spec, tile_points=tile_points,
                                processes=processes):
        if not fields:
            fields = {name: np.empty(spec.shape, dtype=arr.dtype)
                      for name, arr in tile.fields.items()}
        for name, arr in tile.fields.items():
            fields[name][tile.slices] = arr
    return SweepResult(models=spec.models, hardware=spec.hardware,
                       scenarios=spec.scenarios,
                       scenario_names=spec.scenario_names,
                       bw_scale=spec.bw_scale, b_cap=spec.b_cap,
                       n_f=spec.n_f, fields=fields,
                       weight_bytes=spec.weight_bytes)


def run_named_sweep(name: str, **overrides) -> SweepResult:
    """Run one of the registry's named sweeps (fig4, dead-zone, superpod…)."""
    params = registry.named_sweep(name)
    params.update(overrides)
    return sweep(**params)


def scalar_reference(models, hardware, n_f=None, scenarios="default",
                     bw_scale=1.0, b_cap=None,
                     weight_bytes: float = 1.0) -> SweepResult:
    """The equivalent per-point Python loop over ``hfu_bound.hfu_point``.

    Ground truth for the equivalence tests and the baseline for the
    ``python -m repro_torch bench`` speedup measurement. Returns the same
    ``SweepResult`` layout as :func:`sweep`.
    """
    models = _as_models(models)
    hardware = _as_hardware(hardware)
    scens = _as_scenarios(scenarios)
    scen_names = _scenario_names(scenarios)
    if n_f is None:
        n_f = _default_n_f(models, hardware)
    nf = np.asarray(list(n_f), dtype=np.int64)
    bw = np.atleast_1d(np.asarray(bw_scale, dtype=np.float64))
    cap = (np.array([np.inf]) if b_cap is None
           else np.atleast_1d(np.asarray(b_cap, dtype=np.float64)))

    shape = (len(models), len(hardware), len(scens), len(bw), len(cap),
             len(nf))
    fields = {
        name: np.empty(shape, dtype=(
            bool if name == "feasible"
            else np.int64 if name == "local_experts"
            else "<U16" if name in ("regime", "bottleneck")
            else np.float64))
        for name in FIELDS
    }
    for (i, m), (j, h), (k, s), (l, b), (c, bc) in itertools.product(
            enumerate(models), enumerate(hardware), enumerate(scens),
            enumerate(bw), enumerate(cap)):
        hw = registry.resolve_hardware(h, bw_scale=float(b))
        for n, nf_val in enumerate(nf):
            pt = hb.hfu_point(m, hw, int(nf_val), s,
                              b_cap=None if np.isinf(bc) else float(bc),
                              weight_bytes=weight_bytes)
            idx = (i, j, k, l, c, n)
            fields["feasible"][idx] = pt.feasible
            fields["b_rank"][idx] = pt.b_rank
            fields["local_experts"][idx] = pt.local_experts
            fields["tokens_per_expert"][idx] = pt.tokens_per_expert
            fields["intensity"][idx] = pt.intensity
            fields["ofu"][idx] = pt.ofu
            fields["temporal_sparsity"][idx] = pt.temporal_sparsity
            fields["hfu"][idx] = pt.hfu
            fields["regime"][idx] = pt.regime
            fields["bottleneck"][idx] = pt.bottleneck
    # t_budget depends only on (model, scenario); fill as the scalar core does.
    from repro_torch.core.budget import stage_budget
    for (i, m), (k, s) in itertools.product(enumerate(models),
                                            enumerate(scens)):
        fields["t_budget"][i, :, k] = stage_budget(m, s)
    return SweepResult(models=tuple(models), hardware=tuple(hardware),
                       scenarios=tuple(scens), scenario_names=scen_names,
                       bw_scale=bw, b_cap=cap, n_f=nf, fields=fields,
                       weight_bytes=float(weight_bytes))
