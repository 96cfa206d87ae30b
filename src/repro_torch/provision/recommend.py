"""Deploy recommendation: best AFD point vs the large-EP reference. A copy
of ``repro.provision.recommend``.

Consumes a :class:`~repro_torch.provision.search.ProvisionResult` and, for a
stated (model, hardware, scenario) traffic profile, compares the search's
champion AFD point (best §3.3-penalized HFU_eff) against the §3.2 large-EP
baseline under the same imbalance σ. The verdict reproduces the paper's
taxonomy:

  * champion HFU_eff > EP HFU_eff  →  ``deploy-afd`` ("deploy AFD with
    N_F=k on <hw>"), with the Appendix-A superpod escape noted when the
    win comes from the scale-up fabric;
  * champion below the EP line     →  ``stay-ep``, with the §3.2 dead-zone
    / scale-out-bandwidth reason attached;
  * no eligible point at all       →  ``stay-ep`` (HBM- or SLO-infeasible).

An optional calibration scale (measured/predicted HFU from
``repro_torch.provision.calibrate``, on the card) derates the analytic
champion before comparison, attaching the analytic-vs-measured error
bar to the verdict.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.api import registry
from repro_torch.provision.search import ProvisionResult


@dataclasses.dataclass(frozen=True)
class ProvisionVerdict:
    model: str
    hardware: str
    scenario: str
    decision: str               # "deploy-afd" | "stay-ep"
    reason: str
    afd: Optional[dict]         # champion payload (None if nothing eligible)
    ep: dict                    # EP baseline fields
    hfu_margin: float           # champion HFU_eff − EP HFU_eff (derated)
    cost_margin: float          # EP $/Mtok − champion $/Mtok (>0: AFD cheaper)
    calibration_scale: float    # measured/predicted derate applied (1 = none)
    summary: str                # the one-line human statement

    def to_obj(self) -> dict:
        return dataclasses.asdict(self)


def recommend(result: ProvisionResult, model: str, hardware: str,
              scenario: str = "default",
              calibration_scale: float = 1.0) -> ProvisionVerdict:
    """The AFD-vs-EP verdict for one (model, hardware, scenario) triple."""
    if not 0.0 < calibration_scale <= 1.5:
        raise ValueError(
            f"calibration scale out of range: {calibration_scale}")
    ep = result.ep.get(f"{model}|{hardware}")
    if ep is None:
        raise KeyError(
            f"no EP baseline for {model!r} on {hardware!r}; the search grid "
            f"must include both (have: {sorted(result.ep)})")
    champ = result.champions.get(f"{model}|{hardware}|{scenario}")

    if champ is None:
        reason = ("no eligible AFD point: expert weights exceed HBM or the "
                  "grouped GEMM misses the stage budget at every searched "
                  "N_F (paper's 'HBM -' / SLO-infeasible cases)")
        summary = (f"stay with large-scale EP for {model} on {hardware}: "
                   f"{reason}")
        return ProvisionVerdict(
            model=model, hardware=hardware, scenario=scenario,
            decision="stay-ep", reason=reason, afd=None, ep=ep,
            hfu_margin=-ep["hfu_eff"], cost_margin=0.0,
            calibration_scale=calibration_scale, summary=summary)

    afd_hfu = champ["hfu_eff"] * calibration_scale
    hfu_margin = afd_hfu - ep["hfu_eff"]
    cost_margin = (ep["cost_per_mtok"] - champ["cost_per_mtok"]
                   / calibration_scale)
    wins = hfu_margin > 0.0
    try:
        superpod = registry.resolve_hardware(hardware).superpod
    except KeyError:
        superpod = False

    if wins:
        clauses = [f"AFD HFU_eff {afd_hfu:.1%} clears the large-EP "
                   f"reference {ep['hfu_eff']:.1%} under σ={result.sigma:g}"]
        if superpod:
            clauses.append("superpod scale-up fabric removes the "
                           "scale-out cap (Appendix A)")
        if cost_margin > 0:
            clauses.append(f"and prices {cost_margin:.2f} $/Mtok below EP")
        reason = "; ".join(clauses)
        summary = (f"deploy AFD with N_F={champ['n_f']} "
                   f"(N_A={champ['n_a']}) on {hardware} for {model}: "
                   f"{reason}")
        decision = "deploy-afd"
    else:
        clauses = [f"best AFD HFU_eff {afd_hfu:.1%} stays below the "
                   f"large-EP reference {ep['hfu_eff']:.1%}"]
        if not superpod:
            clauses.append("the Eq. 9 interconnect inflow cap plateaus the "
                           "HFU curve before the EP line (§3.2 dead zone)")
        elif champ["regime"] == "max-intensity":
            clauses.append("experts are already maximally aggregated "
                           "(one per rank) and still miss the line")
        if champ.get("bw_scale", 1.0) > 1.0:
            clauses.append(f"even at bw_scale={champ['bw_scale']:g}")
        reason = "; ".join(clauses)
        summary = (f"stay with large-scale EP for {model} on {hardware}: "
                   f"{reason}")
        decision = "stay-ep"

    return ProvisionVerdict(
        model=model, hardware=hardware, scenario=scenario,
        decision=decision, reason=reason, afd=champ, ep=ep,
        hfu_margin=hfu_margin, cost_margin=cost_margin,
        calibration_scale=calibration_scale, summary=summary)
