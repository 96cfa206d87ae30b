"""Theoretical HFU upper bounds under AFD (paper §3.2, Fig. 4, Appendix A).

A copy of ``repro.core.hfu_bound`` (the port imports nothing of ``repro``).

For each (model, hardware, N_F) we combine:
  * Eq. 9 token inflow  B_rank(N_F)              (comm_roofline)
  * grouped-GEMM FLOPs  6·G·B·H·M and Mem 3·G·H·M (budget)
  * the classic roofline for the operator time    t_G
  * the stage budget    t_B                       (budget)
into  HFU = FLOPs / (peak · t_B) = OFU × S_t  (Eq. 8).

The *dead zone* (paper's core finding): past the scale-out knee, raising N_F
raises OFU (fewer local experts ⇒ higher intensity) but FLOPs is capped by the
interconnect, so S_t collapses and HFU plateaus — on H800-class clusters below
the ≈60 % HFU the paper credits to large-scale EP.

Appendix-A closed form (Superpod, interconnect-bound):
    HFU = 2 · B_ScaleUp · M / FLOPS
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.core import budget as bdg
from repro_torch.core import comm_roofline as cr
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec

# Reference point quoted in §3.2: DeepSeek production profile, ~740 tokens per
# expert, "an HFU of approximately 60% considering EP imbalance".
LARGE_EP_REFERENCE_HFU = 0.60
LARGE_EP_REFERENCE_TOKENS_PER_EXPERT = 740


@dataclasses.dataclass(frozen=True)
class HFUPoint:
    n_f: int
    feasible: bool              # model weights fit in N_F·g ranks' HBM
    b_rank: float               # token inflow per rank within t_B (Eq. 9)
    local_experts: int
    tokens_per_expert: float
    intensity: float            # FLOP/byte
    ofu: float
    temporal_sparsity: float
    hfu: float
    regime: str
    bottleneck: str             # "compute" | "hbm" | "interconnect"


def memory_feasible(model: MoEModelSpec, hw: HardwareSpec, n_f: int,
                    bytes_per_param: float = 1.0) -> bool:
    """Do the routed experts fit in the HBM of N_F·g ranks? (fp8 residency).

    Expert params per layer: 3·H·M·N_experts; plus shared/dense kept on the
    attention side (AFD). A 20 % headroom is reserved for activations/buffers.
    """
    expert_bytes = (3.0 * model.hidden_size * model.moe_intermediate *
                    model.n_routed_experts * model.n_moe_layers *
                    bytes_per_param)
    capacity = 0.8 * hw.hbm_cap * n_f * hw.gpus_per_node
    return expert_bytes <= capacity


def default_n_f_max(model: MoEModelSpec, hw: HardwareSpec) -> int:
    """Default sweep bound: well past the max-intensity knee (≥ 16)."""
    return max(2 * math.ceil(model.n_routed_experts / hw.gpus_per_node), 16)


def hfu_point(model: MoEModelSpec, hw: HardwareSpec, n_f: int,
              scen: Optional[bdg.Scenario] = None,
              b_cap: Optional[float] = None,
              weight_bytes: float = 1.0) -> HFUPoint:
    """One (model, hardware, N_F) cell of the Fig. 4 sweep.

    ``b_cap`` optionally caps the Eq. 9 token inflow per rank — modelling a
    deployment whose offered decode batch is smaller than what the
    interconnect could deliver within t_B.

    ``weight_bytes`` is the expert-weight storage width in bytes/param
    (1.0 = the paper's fp8 baseline; see budget.WEIGHT_BYTES_PER_PARAM).
    Narrower weights raise the Eq. 6 arithmetic intensity AND shrink the
    HBM-residency footprint, so both the roofline memory term and the
    feasibility test move together.
    """
    scen = scen or bdg.Scenario()
    t_b = bdg.stage_budget(model, scen)
    inflow = cr.b_rank(model, hw, t_b, n_f)
    if b_cap is not None:
        inflow = min(inflow, b_cap)
    g_local = cr.local_experts(model, hw, n_f)
    tokens_per_expert = inflow / g_local
    flops = bdg.grouped_gemm_flops(g_local, tokens_per_expert,
                                   model.hidden_size, model.moe_intermediate)
    mem = bdg.grouped_gemm_bytes(g_local, model.hidden_size,
                                 model.moe_intermediate,
                                 bytes_per_param=weight_bytes)
    t_gemm = bdg.gemm_time_roofline(flops, mem, hw)
    # The budget window truncates nothing here — if t_gemm > t_B the point is
    # simply infeasible under the SLO; we clamp S_t at 1 and flag it.
    metrics = bdg.StageMetrics(flops=flops, t_gemm=t_gemm, t_budget=t_b,
                               peak_flops=hw.peak_flops)
    s_t = min(metrics.temporal_sparsity, 1.0)
    hfu = metrics.ofu * s_t
    intensity = flops / mem if mem else 0.0
    # Bottleneck attribution: which resource pins HFU at this point?
    t_compute = flops / hw.peak_flops
    t_hbm = mem / hw.hbm_bw
    if t_gemm >= t_b * (1 - 1e-9) or t_compute >= max(t_hbm, 1e-30):
        bottleneck = "compute" if t_compute >= t_hbm else "hbm"
    elif t_hbm > t_compute:
        bottleneck = "hbm"
    else:
        bottleneck = "interconnect"
    # If the op finishes well inside the budget, the window is starved by the
    # interconnect (more tokens would both lift OFU and fill the window).
    if s_t < 1.0 - 1e-9 and t_gemm < t_b:
        bottleneck = "interconnect" if t_compute >= t_hbm else "hbm"
    return HFUPoint(
        n_f=n_f,
        feasible=memory_feasible(model, hw, n_f,
                                 bytes_per_param=weight_bytes),
        b_rank=inflow,
        local_experts=g_local,
        tokens_per_expert=tokens_per_expert,
        intensity=intensity,
        ofu=metrics.ofu,
        temporal_sparsity=s_t,
        hfu=hfu,
        regime=cr.regime(model, hw, n_f),
        bottleneck=bottleneck,
    )


def hfu_sweep(model: MoEModelSpec, hw: HardwareSpec,
              scen: Optional[bdg.Scenario] = None,
              n_f_max: Optional[int] = None,
              weight_bytes: float = 1.0) -> List[HFUPoint]:
    """Fig. 4: HFU upper bound vs N_F for one (model, platform)."""
    if n_f_max is None:
        n_f_max = default_n_f_max(model, hw)
    return [hfu_point(model, hw, n_f, scen, weight_bytes=weight_bytes)
            for n_f in range(1, n_f_max + 1)]


def hfu_ceiling(model: MoEModelSpec, hw: HardwareSpec,
                scen: Optional[bdg.Scenario] = None,
                feasible_only: bool = True,
                weight_bytes: float = 1.0) -> HFUPoint:
    """The best achievable HFU point over all N_F (the Fig. 4 envelope).

    ``feasible_only`` restricts to N_F where expert weights fit in HBM
    (paper's "HBM - DeepSeek-V3" annotations mark the infeasible ones).
    """
    pts = hfu_sweep(model, hw, scen, weight_bytes=weight_bytes)
    pool = [p for p in pts if p.feasible] if feasible_only else pts
    if not pool:
        pool = pts  # nothing fits: report the (infeasible) envelope anyway
    return max(pool, key=lambda p: p.hfu)


def dead_zone(model: MoEModelSpec, hw: HardwareSpec,
              scen: Optional[bdg.Scenario] = None,
              tol: float = 0.02,
              weight_bytes: float = 1.0) -> List[int]:
    """N_F values in the dead zone: adding FFN nodes no longer moves HFU.

    Defined as the suffix of the sweep (past the scale-out knee) where HFU is
    within ``tol`` (relative) of its running plateau while S_t strictly falls.

    ``weight_bytes`` moves the boundary: narrower expert weights raise the
    grouped GEMM's arithmetic intensity, so the HBM term leaves the roofline
    earlier and the plateau starts at a different N_F — the kernel-level
    quantization paths are a *planning* lever, not just a speedup.
    """
    pts = hfu_sweep(model, hw, scen, weight_bytes=weight_bytes)
    if not pts:
        return []
    zone: List[int] = []
    for prev, cur in zip(pts, pts[1:]):
        flat = cur.hfu <= prev.hfu * (1 + tol)
        st_falls = cur.temporal_sparsity <= prev.temporal_sparsity + 1e-12
        if flat and st_falls and cur.regime in (
                cr.REGIME_SCALE_OUT_BOUND, cr.REGIME_MAX_INTENSITY):
            zone.append(cur.n_f)
    return zone


def dead_zone_boundary(model: MoEModelSpec, hw: HardwareSpec,
                       scen: Optional[bdg.Scenario] = None,
                       tol: float = 0.02,
                       weight_bytes: float = 1.0) -> Optional[int]:
    """First N_F inside the dead zone (None if the sweep never plateaus)."""
    zone = dead_zone(model, hw, scen, tol=tol, weight_bytes=weight_bytes)
    return min(zone) if zone else None


def superpod_hfu_closed_form(model: MoEModelSpec, hw: HardwareSpec) -> float:
    """Appendix A: HFU = 2·B_ScaleUp·M / FLOPS (interconnect-bound Superpod)."""
    return min(1.0, 2.0 * hw.scale_up_bw * model.moe_intermediate /
               hw.peak_flops)
