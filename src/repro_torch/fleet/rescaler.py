"""Elastic N_F rescaling: §3.3's discrete-scaling penalty as a live,
closed-loop fleet policy. Counterpart of ``repro.fleet.rescaler``.

Per fleet window the controller hands the rescaler the measured load
fraction σ (demand tokens / provisioned slot capacity; above 1 under a
backlog). The rescaler prices staying at the current N_F against the
continuous ideal through ``core.planner.rescale_n_f`` and, when the
imbalance penalty exceeds the predicted dead-zone threshold, re-plans the
deployment at the chosen N_F through ``core.planner.plan_afd``. The new
plan is what the next window is judged against.

Every decision is kept in ``decisions``; every executed re-plan is a
``RescaleEvent`` carrying (σ, old N_F, threshold), from which the
planner's decision can be recomputed.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.core import planner as pln
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec
from repro_torch.fleet.events import RescaleEvent


class ElasticRescaler:
    """Re-plans on the default ``Scenario`` and the planner's default node
    budget, as every caller of the JAX rescaler does."""

    def __init__(self, model: MoEModelSpec, hardware: HardwareSpec,
                 plan: Optional[pln.AFDPlan] = None, *,
                 threshold: Optional[float] = None,
                 cooldown_windows: int = 0):
        self.model = model
        self.hardware = hardware
        self.plan = plan if plan is not None else pln.plan_afd(model,
                                                               hardware)
        # The controller measures σ against the deployed fleet's slot
        # capacity, which the baseline plan provisioned and a re-plan does
        # not change. Each window's σ is re-expressed in the current plan's
        # units (σ_plan = σ · N_F0 / N_F), so the ideal continuous fleet
        # σ_plan · N_F tracks demand instead of compounding re-plans.
        self.baseline_n_f = self.plan.n_f
        self.threshold = threshold
        self.cooldown_windows = cooldown_windows
        self.decisions: List[pln.NFRescaleDecision] = []
        self.events: List[RescaleEvent] = []
        self._last_rescale_window = -10**9

    @property
    def n_f(self) -> int:
        return self.plan.n_f

    def observe(self, window: int, t: float,
                sigma: float) -> Optional[RescaleEvent]:
        """Judge one fleet window; execute and return a re-plan if the
        §3.3 penalty of staying exceeds the dead-zone threshold."""
        if sigma <= 0:
            return None                     # idle window: nothing to price
        sigma_plan = sigma * self.baseline_n_f / self.plan.n_f
        dec = pln.rescale_n_f(self.plan, sigma_plan, self.threshold)
        self.decisions.append(dec)
        if not dec.triggered:
            return None
        if window - self._last_rescale_window <= self.cooldown_windows:
            return None
        try:
            new_plan = pln.plan_afd(self.model, self.hardware,
                                    n_f=dec.new_n_f)
        except pln.PlanningError:
            return None                     # target infeasible: stay
        event = RescaleEvent(
            window=window, t=t, sigma=dec.sigma,
            old_n_f=dec.old_n_f, new_n_f=dec.new_n_f,
            rounding=dec.rounding, alpha_stay=dec.alpha_stay,
            alpha_new=dec.alpha_new, penalty=dec.penalty,
            residual_penalty=dec.residual_penalty,
            threshold=dec.threshold,
            hfu_old=self.plan.hfu, hfu_new=new_plan.hfu,
            n_a_old=self.plan.n_a, n_a_new=new_plan.n_a)
        self.plan = new_plan
        self.events.append(event)
        self._last_rescale_window = window
        return event
