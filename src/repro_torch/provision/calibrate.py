"""Analytic-vs-measured calibration of the AFD plan. Counterpart of
``repro.provision.calibrate``.

The provisioning search prices points with the Eq. 6–9 *analytic* bound.
Calibration drives ``AFDServeEngine`` over a seeded traffic trace (the
serve-traffic path) and reports

    scale = mean(HFU_measured) / HFU_predicted   ∈ (0, 1]

over the windows that routed tokens. The engine's measured HFU never
exceeds the plan's Eq. 9 cap, so the scale is a derate.

The engine runs on a virtual clock and every request stops at its
``max_new_tokens`` (no EOS), so the report depends on the trace and the
plan, not on the weights or the width: the smoke config on the CPU and
the full-width model on the card give the same windows.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    arch: str
    profile: str
    seed: int
    windows: int                  # measurement windows with routed tokens
    hfu_predicted: float          # plan's analytic Eq. 6–9 operating point
    hfu_measured_mean: float      # mean over busy windows
    b_rank_utilization: float     # measured inflow / Eq. 9 cap, mean
    scale: float                  # hfu_measured_mean / hfu_predicted
    t_budget_analytic: float      # the plan's t_B (s)
    t_budget_effective: float     # t_B the measured inflow actually fills

    def to_obj(self) -> dict:
        return dataclasses.asdict(self)


def calibrate(arch: str = "granite-moe-1b-a400m",
              profile: str = "poisson-burst", seed: int = 0,
              max_requests: int = 10, hardware: str = "H800",
              max_ticks: int = 2000, device=None) -> CalibrationReport:
    """Run the serve-traffic path on ``arch``'s smoke config (random
    weights from seed 0) and derive the analytic derate. ``device=None``
    means the CUDA device, as the port's other entry points."""
    from repro_torch import configs
    from repro_torch.models.common import resolve_device
    from repro_torch.models.params import init_params
    from repro_torch.parallel.afd import AFDRuntime

    cfg = configs.get_smoke_config(arch)
    device = resolve_device(device)
    rt = AFDRuntime(cfg, init_params(cfg, seed=0, device=device),
                    device=device)
    return _calibrate(rt, arch, profile, seed, max_requests, hardware,
                      max_ticks)


def _calibrate(rt, arch: str, profile: str, seed: int, max_requests: int,
               hardware: str, max_ticks: int) -> CalibrationReport:
    """The calibration run on a built runtime: the JAX package's engine
    shape (``max_len`` 32, 2 micro-batches of 2 slots, legacy prefill),
    an EP-mode ``SLOScheduler`` at a 50 ms TPOT SLO, 10 ms virtual ticks
    and 8-tick windows, with an ``HFUProbe`` on the AFD plan of the
    runtime's config for ``hardware``."""
    from repro_torch.api import registry
    from repro_torch.core import planner as pln
    from repro_torch.serving.afd_engine import AFDServeEngine, HFUProbe
    from repro_torch.serving.scheduler import SLOConfig, SLOScheduler
    from repro_torch.serving.workload import generate_trace, get_profile

    spec = registry.spec_from_arch_config(rt.cfg)
    hw = registry.resolve_hardware(hardware)
    plan = pln.plan_afd(spec, hw)
    probe = HFUProbe(model=spec, hardware=hw, plan=plan)
    sch = SLOScheduler(SLOConfig(tpot=0.05), mode="ep")
    eng = AFDServeEngine(rt, max_len=32, n_bo=2, mb_slots=2,
                         scheduler=sch, probe=probe,
                         tick_seconds=0.01, window_ticks=8)
    trace = generate_trace(get_profile(profile), seed=seed,
                           max_requests=max_requests)
    windows = eng.run(trace, max_ticks=max_ticks)
    s = eng.summary()

    busy = [w for w in windows if w.tokens_routed]
    if not busy:
        raise RuntimeError(
            f"calibration trace produced no routed tokens "
            f"(arch={arch}, profile={profile}, seed={seed})")
    predicted = float(s["hfu_predicted"])
    measured = float(s["hfu_measured_mean"])
    util = float(s["b_rank_utilization_mean"])
    scale = measured / predicted if predicted > 0 else 1.0
    return CalibrationReport(
        arch=arch, profile=profile, seed=seed, windows=len(busy),
        hfu_predicted=predicted, hfu_measured_mean=measured,
        b_rank_utilization=util, scale=min(max(scale, 1e-9), 1.0),
        t_budget_analytic=plan.t_budget,
        t_budget_effective=plan.t_budget * util)
