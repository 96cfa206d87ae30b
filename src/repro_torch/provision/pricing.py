"""Pricing a provisioning point: $/token, §3.3 penalties, EP baseline.

A copy of ``repro.provision.pricing`` (the port imports nothing of ``repro``).

The search compares deployments on three objectives:

  * **effective HFU** — the Eq. 6–8 bound multiplied by the §3.3
    imbalance penalty α (AFD pays the *discrete* N_A quantization
    penalty, Eqs. 13–16; large-scale EP pays the continuous Eq. 12 one);
  * **latency budget slack** — the fraction of the stage budget t_B left
    unused by the grouped GEMM (headroom against jitter / SLO);
  * **$/token** — fleet cost rate over token throughput.

Cost model (documented so the numbers are auditable):

    FFN FLOPs per decoded token  F_tok = 6·H·M·TopK·L_moe     (routed only)
    useful FLOP rate             = HFU_eff · peak · N_F · g
    token throughput     R      = useful FLOP rate / F_tok
    fleet cost rate             = (N_A + N_F) · g · $/chip-hour / 3600
    $/token                     = cost rate / R

The same F_tok normalization prices the large-EP reference, where the
per-chip rate makes the fleet size cancel:

    $/token_EP = ($/chip-hour / 3600) · F_tok / (HFU_EP · α_EP · peak)

so AFD-vs-EP $/token comparisons are apples-to-apples per useful FLOP.
Attention-side FLOPs are excluded from *both* sides (EP chips timeshare
attention and FFN; AFD carries its attention fleet in the (N_A + N_F)
node count instead), which is exactly the paper's framing of HFU as an
FFN-stage metric.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import hfu_bound as hb
from repro_torch.core import imbalance as imb
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec

SECONDS_PER_HOUR = 3600.0

# λ = t_a/t_f assumed for the EP reference (paper §3.3: H800 practice 2–4).
DEFAULT_EP_LAMBDA = 3.0


def ffn_flops_per_token(model: MoEModelSpec) -> float:
    """Routed-expert FLOPs per decoded token across all MoE layers."""
    return (6.0 * model.hidden_size * model.moe_intermediate *
            model.top_k * max(model.n_moe_layers, 1))


def alpha_afd_array(sigma: float, n_a: np.ndarray,
                    n_f: np.ndarray) -> np.ndarray:
    """Vectorized Eq. 16 — elementwise-identical to ``imbalance.alpha_afd``.

    Mirrors the scalar branch structure: exact when σ·N_A ∈ ℤ, otherwise
    the better of the floor (Eq. 14) and ceil (Eq. 15) roundings, with the
    same 1e-12 epsilon guards.
    """
    if not 0.0 < sigma <= 1.0:
        raise ValueError(f"balancedness σ must be in (0, 1], got {sigma}")
    n_a = np.asarray(n_a, dtype=np.float64)
    n_f = np.asarray(n_f, dtype=np.float64)
    x = sigma * n_a
    total = n_a + n_f
    with np.errstate(invalid="ignore", divide="ignore"):
        a_exact = sigma * total / (x + n_f)
        na_fl = np.floor(x + 1e-12)
        a_floor = np.where(na_fl <= 0, 0.0,
                           (na_fl / (na_fl + n_f)) * (total / n_a))
        na_ce = np.minimum(np.ceil(x - 1e-12), n_a)
        a_ceil = np.where(na_ce <= 0, 0.0,
                          (na_ce / (na_ce + n_f)) * (total / n_a)
                          * (x / np.maximum(na_ce, 1e-300)))
        exact = np.abs(x - np.round(x)) < 1e-9
        return np.where(exact, a_exact, np.maximum(a_floor, a_ceil))


def nf_quantization_threshold_array(n_f: np.ndarray) -> np.ndarray:
    """Vectorized ``planner.nf_quantization_threshold``: 0.25/(N_F+1)."""
    return 0.25 / (np.asarray(n_f, dtype=np.float64) + 1.0)


def cost_per_mtoken(total_nodes: np.ndarray, gpus_per_node: int,
                    usd_per_device_hour: float, hfu_eff: np.ndarray,
                    peak_flops: float, n_f: np.ndarray,
                    flops_per_token: float) -> np.ndarray:
    """$ per million decoded tokens for an AFD fleet (see module doc)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        rate = np.asarray(
            hfu_eff * peak_flops * n_f * gpus_per_node / flops_per_token,
            dtype=np.float64)
        cost_s = (total_nodes * gpus_per_node * usd_per_device_hour /
                  SECONDS_PER_HOUR)
        out = np.where(rate > 0, cost_s / np.where(rate > 0, rate, 1.0) * 1e6,
                       np.inf)
    return float(out) if out.ndim == 0 else out


@dataclasses.dataclass(frozen=True)
class EPBaseline:
    """The large-scale EP reference a candidate AFD point must beat."""
    model: str
    hardware: str
    hfu: float                  # §3.2 reference (0.60, DeepSeek profile)
    alpha: float                # Eq. 12 continuous-refill penalty
    hfu_eff: float              # hfu × alpha
    sigma: float
    ep_lambda: float            # assumed t_a/t_f
    cost_per_mtok: float        # $/Mtok (fleet-size free, see module doc)


def ep_baseline(model: MoEModelSpec, hw: HardwareSpec, sigma: float,
                ep_lambda: float = DEFAULT_EP_LAMBDA,
                cost_per_device_hour: float | None = None) -> EPBaseline:
    """Price the paper's §3.2 large-EP reference on this hardware.

    EP chips timeshare attention and FFN, so only the 1/(λ+1) FFN share
    of each chip-hour buys FFN FLOPs — the $/token normalization charges
    the whole chip, keeping the comparison to AFD (whose attention fleet
    is charged via N_A) honest.

    ``model`` / ``hw`` accept names as well as resolved specs.
    """
    from repro_torch.api import registry
    model = registry.resolve_model(model)
    hw = registry.resolve_hardware(hw)
    alpha = imb.alpha_ep(sigma, ep_lambda) if sigma < 1.0 else 1.0
    hfu_eff = hb.LARGE_EP_REFERENCE_HFU * alpha
    usd = (hw.cost_per_device_hour if cost_per_device_hour is None
           else cost_per_device_hour)
    f_tok = ffn_flops_per_token(model)
    # FFN share of a chip-second is 1/(λ+1); the rest buys attention.
    ffn_rate = hfu_eff * hw.peak_flops / (ep_lambda + 1.0)
    cost = (usd / SECONDS_PER_HOUR) * f_tok / ffn_rate * 1e6 \
        if ffn_rate > 0 else float("inf")
    return EPBaseline(model=model.name, hardware=hw.name,
                      hfu=hb.LARGE_EP_REFERENCE_HFU, alpha=alpha,
                      hfu_eff=hfu_eff, sigma=sigma, ep_lambda=ep_lambda,
                      cost_per_mtok=cost)
