"""Name → spec resolution for the port's front door: a copy of
``repro.api.registry`` (the port imports nothing of ``repro``).

One registry over these namespaces, all addressable by plain strings:

  * **models** — the paper's Table 4 models and the repo's assigned
    architectures (``repro_torch.core.modelspec.ALL_MODELS``), plus any
    ``repro_torch.configs`` architecture, lowered to its analysis view
    (``MoEModelSpec``) on the fly; ``repro_torch.configs`` (and with it
    torch) is imported only when a name is not a Table 4 model;
  * **hardware** — Table 5 platforms + TPU targets
    (``repro_torch.core.hardware.HARDWARE``), with an interconnect scale;
  * **scenarios** — named deployment scenarios (SLO/MTP/gap presets);
  * **fleet routers** — ``repro_torch.fleet.router``'s policies.

Plus **named sweeps**: the paper's recurring grids (Fig. 4, the dead zone,
the Appendix-A superpod study, link bandwidth) as parameter sets for
``repro_torch.api.sweep``.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Dict, Iterable, List, Union

from repro_torch.core.budget import Scenario
from repro_torch.core.hardware import HARDWARE, HardwareSpec
from repro_torch.core.modelspec import ALL_MODELS, PAPER_MODELS, MoEModelSpec

ModelLike = Union[str, MoEModelSpec]
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


def scenario_name(scen: ScenarioLike) -> str:
    if isinstance(scen, str):
        return scen
    for name, s in SCENARIOS.items():
        if s == scen:
            return name
    # Unregistered Scenario: derive a deterministic parameter label so
    # records from multi-custom-scenario sweeps stay distinguishable.
    return (f"slo{scen.slo_tpot * 1e3:g}ms-la{scen.l_accept:g}"
            f"-gap{scen.t_gap * 1e3:g}ms-bo{scen.n_bo}")


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


def resolve_model(model: ModelLike) -> MoEModelSpec:
    if isinstance(model, MoEModelSpec):
        return model
    if model in ALL_MODELS:
        return ALL_MODELS[model]
    # Any repro_torch.configs architecture id or module name.
    try:
        from repro_torch import configs
        cfg = configs.get_config(model)
    except Exception:
        names = set(ALL_MODELS)
        try:
            from repro_torch import configs
            names |= set(configs.ARCH_IDS)
        except Exception:
            pass
        err = unknown_name_error("model", model, names)
        # the JAX package's message, word for word (the CLIs print it)
        raise KeyError(err.args[0] +
                       " (any repro.configs arch id also resolves)") from None
    return spec_from_arch_config(cfg)


def list_models() -> List[str]:
    return sorted(ALL_MODELS)


# --- hardware --------------------------------------------------------------

def resolve_hardware(hw: HardwareLike,
                     bw_scale: float = 1.0) -> HardwareSpec:
    """Resolve a platform; ``bw_scale`` scales both interconnect tiers."""
    if isinstance(hw, str):
        try:
            hw = HARDWARE[hw]
        except KeyError:
            raise unknown_name_error("hardware", hw, HARDWARE) from None
    if bw_scale != 1.0:
        hw = dataclasses.replace(
            hw,
            name=f"{hw.name}@bw{bw_scale:g}",
            scale_up_bw=hw.scale_up_bw * bw_scale,
            scale_out_bw=(None if hw.scale_out_bw is None
                          else hw.scale_out_bw * bw_scale))
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


# --- named sweeps ----------------------------------------------------------

# Platform order of the paper's Fig. 4 table.
FIG4_PLATFORMS = ["H20", "H100", "H200", "H800", "B200", "B300",
                  "GB200", "GB300"]

NAMED_SWEEPS: Dict[str, dict] = {
    # Fig. 4: every paper model on every Table-5 platform.
    "fig4": dict(models=list(PAPER_MODELS), hardware=FIG4_PLATFORMS),
    # The core finding: DeepSeek-V3-class models plateau below the large-EP
    # reference on scale-out clusters; superpods escape the dead zone.
    "dead-zone": dict(models=["DeepSeek-V3"],
                      hardware=["H20", "H800", "GB200"],
                      n_f=range(1, 41)),
    # Appendix A: superpod closed form — HFU depends only on M there.
    "superpod": dict(models=list(PAPER_MODELS),
                     hardware=["GB200", "GB300"]),
    # Interconnect sensitivity: the fig4 grid under derated/upgraded links.
    "bandwidth": dict(models=["DeepSeek-V3", "Kimi-K2"],
                      hardware=["H800", "B200"],
                      bw_scale=(0.5, 0.75, 1.0, 1.5, 2.0)),
}


def named_sweep(name: str) -> dict:
    try:
        return dict(NAMED_SWEEPS[name])
    except KeyError:
        raise unknown_name_error("sweep", name, NAMED_SWEEPS) from None


def list_sweeps() -> List[str]:
    return sorted(NAMED_SWEEPS)
