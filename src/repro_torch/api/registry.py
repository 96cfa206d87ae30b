"""Name → spec resolution for the port's entry point: the part of
``repro.api.registry`` that ``serve-traffic`` and ``serve-fleet`` need
(hardware, scenario and router lookup, and the analysis view of an
executable config), kept as a copy so the port imports nothing of
``repro``. Models by name and named sweeps wait for the sweep slice.
"""

from __future__ import annotations

import difflib
from typing import Dict, Iterable, List, Union

from repro_torch.core.budget import Scenario
from repro_torch.core.hardware import HARDWARE, HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec

HardwareLike = Union[str, HardwareSpec]
ScenarioLike = Union[str, Scenario]


def unknown_name_error(kind: str, name: object,
                       known: Iterable[str]) -> KeyError:
    """A helpful lookup error: the full list of known names plus a
    closest-match suggestion (shared by every registry namespace)."""
    known = sorted(known)
    msg = f"unknown {kind} {name!r}; known: {known}"
    close = difflib.get_close_matches(str(name), known, n=3, cutoff=0.5)
    if close:
        hint = " or ".join(repr(c) for c in close)
        msg += f" — did you mean {hint}?"
    return KeyError(msg)


# --- scenarios -------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {
    # Paper Fig. 4 assumptions: 50 ms TPOT SLO, MTP acceptance 1.7, 15 ms gap.
    "default": Scenario(),
    # Latency-critical serving: the stage budget shrinks with the SLO.
    "tight-slo": Scenario(slo_tpot=0.03),
    # Throughput-oriented batch serving.
    "relaxed-slo": Scenario(slo_tpot=0.10),
    # No multi-token prediction: L_accept = 1.
    "no-mtp": Scenario(l_accept=1.0),
}


def resolve_scenario(scen: ScenarioLike) -> Scenario:
    if isinstance(scen, Scenario):
        return scen
    try:
        return SCENARIOS[scen]
    except KeyError:
        raise unknown_name_error("scenario", scen, SCENARIOS) from None


# --- models ----------------------------------------------------------------

def spec_from_arch_config(cfg) -> MoEModelSpec:
    """Lower the port's executable ``ArchConfig`` to the analysis view.

    Dense architectures follow the modelspec convention E = k = 1 with
    M = d_ff (the whole FFN is one always-active "expert").
    """
    n_moe = sum(bool(cfg.is_moe_layer(i)) for i in range(cfg.n_layers))
    is_moe = n_moe > 0 and cfg.n_experts > 1
    return MoEModelSpec(
        name=cfg.name,
        hidden_size=cfg.d_model,
        n_layers=cfg.n_layers,
        n_dense_layers=cfg.n_layers - n_moe,
        n_moe_layers=n_moe if is_moe else 0,
        n_routed_experts=cfg.n_experts if is_moe else 1,
        top_k=cfg.top_k if is_moe else 1,
        moe_intermediate=cfg.moe_d_ff if is_moe else cfg.d_ff,
        n_shared_experts=cfg.n_shared_experts,
    )


# --- hardware --------------------------------------------------------------

def resolve_hardware(hw: HardwareLike) -> HardwareSpec:
    if isinstance(hw, str):
        try:
            return HARDWARE[hw]
        except KeyError:
            raise unknown_name_error("hardware", hw, HARDWARE) from None
    return hw


def list_hardware() -> List[str]:
    return sorted(HARDWARE)


# --- fleet routers -----------------------------------------------------------

def resolve_router(name: str):
    """A fresh fleet routing policy by name (``repro_torch.fleet.router``)."""
    from repro_torch.fleet.router import ROUTER_POLICIES, get_policy
    try:
        return get_policy(name)
    except KeyError:
        raise unknown_name_error("router policy", name,
                                 ROUTER_POLICIES) from None


def list_routers() -> List[str]:
    from repro_torch.fleet.router import list_policies
    return list_policies()
