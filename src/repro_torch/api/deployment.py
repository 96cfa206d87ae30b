"""The ``Deployment`` façade — one object binding (model, hardware,
scenario) to every analysis entry point in ``repro_torch.core``. A copy of
``repro.api.deployment``.

    >>> from repro_torch.api import Deployment
    >>> d = Deployment("DeepSeek-V3", "H800")
    >>> d.hfu_ceiling().hfu            # Fig. 4 cell
    >>> d.plan().n_a                   # §4 planner
    >>> d.verdict().afd_recommended    # Table 3 recommendation
    >>> d.sweep(n_f=range(1, 65))      # vectorized grid over this pair

Accepts names (resolved through ``repro_torch.api.registry``, including
the port's ``repro_torch.configs`` architectures) or spec objects. All
results come back as JSON-serializable ``Record`` objects; the raw core
dataclasses remain reachable through ``repro_torch.core`` for callers that want
them.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.core import budget as bdg
from repro_torch.core import comm_roofline as cr
from repro_torch.core import hfu_bound as hb
from repro_torch.core import imbalance as imb
from repro_torch.core import planner as pl
from repro_torch.core.budget import Scenario
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec

from repro_torch.api import registry
from repro_torch.api import sweep as sweep_mod
from repro_torch.api.records import Record


class Deployment:
    """Façade over the §2–§4 analysis stack for one deployment triple."""

    def __init__(self, model: registry.ModelLike,
                 hardware: registry.HardwareLike,
                 scenario: registry.ScenarioLike = "default",
                 bw_scale: float = 1.0):
        self.model: MoEModelSpec = registry.resolve_model(model)
        self.hardware: HardwareSpec = registry.resolve_hardware(
            hardware, bw_scale=bw_scale)
        self.scenario: Scenario = registry.resolve_scenario(scenario)
        self.scenario_name: str = registry.scenario_name(scenario)

    def __repr__(self) -> str:
        return (f"Deployment({self.model.name!r}, {self.hardware.name!r}, "
                f"{self.scenario_name!r})")

    # --- budget / roofline (§2–§3.1) --------------------------------------

    def stage_budget(self) -> float:
        """t_B from Eq. 1 (seconds)."""
        return bdg.stage_budget(self.model, self.scenario)

    def intensity_sweep(self, n_f_max: Optional[int] = None) -> List[Record]:
        """Fig. 2: arithmetic-intensity regimes vs N_F."""
        return [Record.from_obj(p) for p in cr.intensity_sweep(
            self.model, self.hardware, self.scenario, n_f_max=n_f_max)]

    def regime_boundaries(self) -> Record:
        return Record.from_obj(
            cr.regime_boundaries(self.model, self.hardware))

    # --- HFU bounds (§3.2, Fig. 4, Appendix A) ----------------------------

    def hfu_point(self, n_f: int, b_cap: Optional[float] = None) -> Record:
        return Record.from_obj(hb.hfu_point(
            self.model, self.hardware, n_f, self.scenario, b_cap=b_cap))

    def hfu_sweep(self, n_f_max: Optional[int] = None) -> List[Record]:
        return [Record.from_obj(p) for p in hb.hfu_sweep(
            self.model, self.hardware, self.scenario, n_f_max=n_f_max)]

    def hfu_ceiling(self, feasible_only: bool = True) -> Record:
        return Record.from_obj(hb.hfu_ceiling(
            self.model, self.hardware, self.scenario,
            feasible_only=feasible_only))

    def dead_zone(self, tol: float = 0.02) -> List[int]:
        return hb.dead_zone(self.model, self.hardware, self.scenario,
                            tol=tol)

    def superpod_closed_form(self) -> float:
        return hb.superpod_hfu_closed_form(self.model, self.hardware)

    def memory_feasible(self, n_f: int) -> bool:
        return hb.memory_feasible(self.model, self.hardware, n_f)

    # --- planner / verdict (§4) -------------------------------------------

    def plan(self, n_f: Optional[int] = None,
             max_total_nodes: int = 512) -> Record:
        return Record.from_obj(pl.plan_afd(
            self.model, self.hardware, self.scenario, n_f=n_f,
            max_total_nodes=max_total_nodes))

    def rescale(self, sigma: float, n_f: Optional[int] = None) -> Record:
        """Plan, then apply the §3.3 elastic rescale policy under σ."""
        plan = pl.plan_afd(self.model, self.hardware, self.scenario, n_f=n_f)
        dec = pl.elastic_rescale(plan, sigma)
        return Record.from_obj(dec, plan=Record.from_obj(plan))

    def verdict(self) -> Record:
        return Record.from_obj(pl.afd_verdict(
            self.model, self.hardware, self.scenario))

    def imbalance_penalty(self, sigma: float, n_a: int, n_f: int) -> Record:
        return Record.from_obj(dict(
            sigma=sigma, n_a=n_a, n_f=n_f,
            alpha_afd=imb.alpha_afd(sigma, n_a, n_f),
            alpha_ep=imb.alpha_ep(sigma, n_a / n_f)))

    # --- vectorized grid over this (model, hardware) ----------------------

    def sweep(self, n_f=None, bw_scale=1.0,
              b_cap=None) -> sweep_mod.SweepResult:
        return sweep_mod.sweep(self.model, self.hardware, n_f=n_f,
                               scenarios=self.scenario, bw_scale=bw_scale,
                               b_cap=b_cap)

    # --- summary ----------------------------------------------------------

    def describe(self) -> Record:
        ceiling = hb.hfu_ceiling(self.model, self.hardware, self.scenario,
                                 feasible_only=False)
        dz = self.dead_zone()
        return Record.from_obj(dict(
            model=self.model.name,
            hardware=self.hardware.name,
            scenario=self.scenario_name,
            is_moe=self.model.is_moe,
            granularity=self.model.granularity,
            sparsity=self.model.sparsity,
            superpod=self.hardware.superpod,
            t_budget=self.stage_budget(),
            hfu_ceiling=ceiling.hfu,
            hfu_ceiling_n_f=ceiling.n_f,
            regime_at_ceiling=ceiling.regime,
            dead_zone_from=dz[0] if dz else None,
            ep_reference_hfu=hb.LARGE_EP_REFERENCE_HFU,
        ))
