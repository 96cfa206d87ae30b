"""``repro_torch.provision`` — the million-point AFD-vs-EP provisioning
search and its calibration; the counterpart of ``repro.provision``.

  * :mod:`repro_torch.provision.search` — streams ≥10^6-point grids
    through the memory-bounded ``repro_torch.api.sweep_tiles`` core,
    prices every point with Eqs. 6–9 + the §3.3 imbalance penalty + a
    $/token estimate, and keeps a running Pareto frontier over (HFU,
    latency slack, $/token) without materializing the grid.
  * :mod:`repro_torch.provision.pareto` — the exact streaming frontier.
  * :mod:`repro_torch.provision.pricing` — the $/token cost model, the
    vectorized §3.3 α penalties, and the large-EP reference baseline.
  * :mod:`repro_torch.provision.recommend` — the deploy verdict: "deploy
    AFD with N_F=k on <hw>" or "stay with EP", with the dead-zone /
    bandwidth reason attached.
  * :mod:`repro_torch.provision.calibrate` — re-prices the analytic t_B
    against measured ``AFDServeEngine`` windows on the card, so the
    verdict carries an analytic-vs-measured derate.

The search, pricing, frontier and verdict are host numpy and import no
torch; ``calibrate`` imports torch inside the call.

CLI: ``python -m repro_torch provision [--calibrate [--device cpu]]``.
"""

from repro_torch.provision.calibrate import CalibrationReport, calibrate
from repro_torch.provision.pareto import ParetoFrontier
from repro_torch.provision.pricing import (EPBaseline, alpha_afd_array,
                                           ep_baseline, ffn_flops_per_token)
from repro_torch.provision.recommend import ProvisionVerdict, recommend
from repro_torch.provision.search import (ProvisionGrid, ProvisionResult,
                                          default_grid, search)

__all__ = [
    "CalibrationReport", "calibrate", "ParetoFrontier", "EPBaseline",
    "alpha_afd_array", "ep_baseline", "ffn_flops_per_token",
    "ProvisionVerdict", "recommend", "ProvisionGrid", "ProvisionResult",
    "default_grid", "search",
]
