"""Communication-extended roofline for AFD (paper §3.1, Eqs. 9–10, Fig. 2).

A copy of ``repro.core.comm_roofline`` (the port imports nothing of ``repro``).

Token inflow achievable for a single FFN rank within a stage budget t_B:

    B_rank = min(B_ScaleOut · max(1, TopK / N_F), B_ScaleUp)        (Eq. 9)

where B_ScaleOut / B_ScaleUp are the token counts transmissible over the
respective networks within t_B (payload 3·H bytes/token: fp8 dispatch +
bf16 combine, Eq. 17), and max(1, TopK/N_F) is the two-stage-forwarding
fan-out factor (scale-out carries unique tokens, scale-up replicates them to
the TopK/N_F co-resident target experts).

Arithmetic intensity (tokens/expert doubled, §2.3):

    I = 2 · B_rank / ceil(N_experts / (N_F · g))                    (Eq. 10)

Four operational regimes as N_F grows (Fig. 2):
  scale-up-bound      TopK/N_F > B_su/B_so          (inflow capped by scale-up)
  stable-intensity    1 ≤ TopK/N_F ≤ B_su/B_so      (I flat: inflow and local
                                                     experts shrink together)
  scale-out-bound     N_F > TopK                    (I grows: fewer local experts)
  max-intensity       local experts == 1            (nothing left to consolidate)
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

from repro_torch.core.budget import WIRE_BYTES_PER_ELEM, Scenario, stage_budget
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec

REGIME_SCALE_UP_BOUND = "scale-up-bound"
REGIME_STABLE = "stable-intensity"
REGIME_SCALE_OUT_BOUND = "scale-out-bound"
REGIME_MAX_INTENSITY = "max-intensity"


def tokens_over_link(bandwidth_bytes: float, t_budget: float,
                     hidden: int) -> float:
    """Tokens transmissible over a link of given bandwidth within t_B."""
    return bandwidth_bytes * t_budget / (WIRE_BYTES_PER_ELEM * hidden)


def fanout_factor(top_k: int, n_f: int) -> float:
    """Two-stage-forwarding overlap factor max(1, TopK/N_F) from Eq. 9."""
    return max(1.0, top_k / n_f)


def b_rank(model: MoEModelSpec, hw: HardwareSpec, t_budget: float,
           n_f: int) -> float:
    """Eq. 9 — max token inflow per FFN rank within t_B."""
    b_up = tokens_over_link(hw.scale_up_bw, t_budget, model.hidden_size)
    if hw.superpod or hw.scale_out_bw is None:
        # Superpod: the scale-up fabric is the interconnect (Appendix A).
        return b_up
    b_out = tokens_over_link(hw.scale_out_bw, t_budget, model.hidden_size)
    return min(b_out * fanout_factor(model.top_k, n_f), b_up)


def local_experts(model: MoEModelSpec, hw: HardwareSpec, n_f: int) -> int:
    """Experts resident per rank: ceil(N_experts / (N_F · g))."""
    return math.ceil(model.n_routed_experts / (n_f * hw.gpus_per_node))


def arithmetic_intensity(model: MoEModelSpec, hw: HardwareSpec,
                         t_budget: float, n_f: int,
                         discretize: bool = True) -> float:
    """Eq. 10 — grouped-GEMM arithmetic intensity on an FFN rank.

    ``discretize=False`` gives the blue upper-bound curve of Fig. 2 (treats
    local expert count as the continuous ratio N_experts/(N_F·g)).
    """
    inflow = b_rank(model, hw, t_budget, n_f)
    if discretize:
        g_local = local_experts(model, hw, n_f)
    else:
        g_local = model.n_routed_experts / (n_f * hw.gpus_per_node)
        g_local = max(g_local, 1.0)
    return 2.0 * inflow / g_local


def regime(model: MoEModelSpec, hw: HardwareSpec, n_f: int) -> str:
    """Classify N_F into one of the four Fig. 2 regimes."""
    if local_experts(model, hw, n_f) <= 1:
        return REGIME_MAX_INTENSITY
    if hw.superpod:
        # No scale-out constraint: either fan-out still helps (scale-up term
        # binds) or every expert already has its own rank.
        return REGIME_SCALE_UP_BOUND
    if n_f >= model.top_k:
        # "cannot benefit from the scale-up network" (paper §3.1).
        return REGIME_SCALE_OUT_BOUND
    ratio = model.top_k / n_f
    if ratio > hw.scale_up_over_out:
        return REGIME_SCALE_UP_BOUND
    return REGIME_STABLE


@dataclasses.dataclass(frozen=True)
class IntensityPoint:
    n_f: int
    b_rank: float
    local_experts: int
    intensity: float            # discretized (red curve)
    intensity_bound: float      # continuous (blue curve)
    regime: str


def intensity_sweep(model: MoEModelSpec, hw: HardwareSpec,
                    scen: Scenario | None = None,
                    n_f_max: int | None = None) -> List[IntensityPoint]:
    """Reproduce Fig. 2: normalized arithmetic intensity vs N_F."""
    scen = scen or Scenario()
    t_b = stage_budget(model, scen)
    if n_f_max is None:
        # Sweep until well past the max-intensity knee.
        n_f_max = max(2 * math.ceil(model.n_routed_experts / hw.gpus_per_node), 8)
    pts = []
    for n_f in range(1, n_f_max + 1):
        pts.append(IntensityPoint(
            n_f=n_f,
            b_rank=b_rank(model, hw, t_b, n_f),
            local_experts=local_experts(model, hw, n_f),
            intensity=arithmetic_intensity(model, hw, t_b, n_f, True),
            intensity_bound=arithmetic_intensity(model, hw, t_b, n_f, False),
            regime=regime(model, hw, n_f),
        ))
    return pts


def regime_boundaries(model: MoEModelSpec, hw: HardwareSpec) -> dict:
    """Closed-form regime boundaries in N_F (validation target #2)."""
    out = {}
    if not hw.superpod:
        # largest N_F with TopK/N_F > B_su/B_so  <=>  N_F < TopK·B_so/B_su
        out["scale_up_bound_max_nf"] = math.ceil(
            model.top_k / hw.scale_up_over_out) - 1
        out["scale_out_bound_min_nf"] = model.top_k
    out["max_intensity_min_nf"] = math.ceil(
        model.n_routed_experts / hw.gpus_per_node)
    return out
