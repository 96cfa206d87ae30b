"""Imbalance penalty analysis (paper §3.3, Eqs. 11–16, Figs. 5–6).

A copy of ``repro.core.imbalance`` (the port imports nothing of ``repro``).

Two sources of latency jitter in disaggregated MoE serving:

* **DP imbalance** — uneven context lengths / request progress across DP
  ranks stretch attention latency. Mitigation: shrink the batch to σ× so the
  slowest rank meets the SLO.
* **EP imbalance** — the router concentrates tokens on some experts,
  stretching FFN latency. Same mitigation.

The metric is the *throughput conversion factor* α ≤ 1 — average goodput per
node after mitigation relative to the balanced optimum. The paper's key
result: large-scale EP can *continuously* refill the freed latency budget
(α > σ), while AFD can only rescale N_A in *discrete node units* (α ≤ the
continuous optimum, with floor/ceil quantization loss).

Normalization note (also in DESIGN.md §1): Eqs. 14–15 as printed carry a
``(λ_AFD + 1)`` prefactor which is dimensionally inconsistent with Eq. 13 in
the integer case. We implement the self-consistent reading in which the
prefactor is the ``(N_A + N_F)/N_A`` normalisation of the balanced baseline;
the resulting α reduces *exactly* to Eq. 13 whenever σ·N_A ∈ ℤ, and
reproduces Fig. 6 qualitatively (AFD worse than EP except near σ≈0.8, λ=5).
"""

from __future__ import annotations

import dataclasses
import math

_EPS = 1e-12


def _check_sigma(sigma: float) -> None:
    if not 0.0 < sigma <= 1.0:
        raise ValueError(f"balancedness σ must be in (0, 1], got {sigma}")


# ---------------------------------------------------------------------------
# DP imbalance (paper §3.3.1, Fig. 5a/5b)
# ---------------------------------------------------------------------------

def alpha_dp_ep(sigma: float, lam: float | None = None,
                refill: bool = True) -> float:
    """DP-imbalance penalty under large-scale EP deployment.

    Without refill the batch is simply cut to σ× (α = σ, smaller TPOT as a
    consolation). With refill, the latency the faster FFN stage released is
    reclaimed by growing the batch. The paper states α_EP > σ qualitatively;
    under the linearity assumption it uses for Eq. 11 the closed form is

        t_a scales as (b/B)·(t_a/σ)   (attention slowed 1/σ by jitter)
        t_f scales as (b/B)·t_f
        fill the budget:  (b/B)(t_a/σ + t_f) = t_a + t_f
        α = b/B = (λ + 1) / (λ/σ + 1),   λ = t_a/t_f .
    """
    _check_sigma(sigma)
    if not refill:
        return sigma
    if lam is None:
        raise ValueError("refill mode needs λ = t_a/t_f")
    if lam <= 0:
        raise ValueError(f"λ must be > 0, got {lam}")
    return (lam + 1.0) / (lam / sigma + 1.0)


def alpha_dp_afd(sigma: float) -> float:
    """DP-imbalance penalty under AFD (Fig. 5b).

    The fixed t_B stage budget and the memory-bound FFN side prevent
    reclaiming the freed latency: α_AFD = σ exactly.
    """
    _check_sigma(sigma)
    return sigma


# ---------------------------------------------------------------------------
# EP imbalance (paper §3.3.2, Eqs. 11–16, Fig. 5c/5d, Fig. 6)
# ---------------------------------------------------------------------------

def alpha_ep(sigma: float, lam: float) -> float:
    """Eq. 12 — EP-imbalance penalty for large-scale EP with batch refill.

        α_EP = (λ + 1) / (λ + 1/σ),   λ = t_a / t_f  (H800 practice: λ∈[2,4])

    Monotonically increasing in λ; always > σ for σ < 1. The derivation
    *overestimates* t_f (convexity of grouped-GEMM latency in batch), so the
    true α_EP is even larger — this is a lower bound for EP.
    """
    _check_sigma(sigma)
    if lam <= 0:
        raise ValueError(f"λ must be > 0, got {lam}")
    return (lam + 1.0) / (lam + 1.0 / sigma)


def alpha_afd_exact(sigma: float, n_a: int, n_f: int) -> float:
    """Eq. 13 — AFD penalty when σ·N_A lands on an integer node count.

        α_exact = σ (N_A + N_F) / (σ N_A + N_F) = (λ + 1)/(λ + 1/σ),
        λ_AFD = N_A / N_F .
    """
    _check_sigma(sigma)
    if n_a <= 0 or n_f <= 0:
        raise ValueError("N_A and N_F must be positive")
    return sigma * (n_a + n_f) / (sigma * n_a + n_f)


def alpha_afd_floor(sigma: float, n_a: int, n_f: int) -> float:
    """Eq. 14 (normalised) — round the attention fleet down to ⌊σ·N_A⌋.

    Attention nodes stay fully loaded; throughput ∝ surviving attention
    share. Relative to the balanced baseline N_A/(N_A+N_F):

        α_floor = [⌊σN_A⌋ / (⌊σN_A⌋ + N_F)] · [(N_A + N_F) / N_A]
    """
    _check_sigma(sigma)
    na_eff = math.floor(sigma * n_a + _EPS)
    if na_eff <= 0:
        return 0.0
    return (na_eff / (na_eff + n_f)) * ((n_a + n_f) / n_a)


def alpha_afd_ceil(sigma: float, n_a: int, n_f: int) -> float:
    """Eq. 15 (normalised) — round the attention fleet up to ⌈σ·N_A⌉.

    The extra nodes run under-loaded (FFN capacity caps total tokens), hence
    the correction factor σ·N_A / ⌈σ·N_A⌉:

        α_ceil = [⌈σN_A⌉/(⌈σN_A⌉+N_F)] · [(N_A+N_F)/N_A] · [σN_A/⌈σN_A⌉]
    """
    _check_sigma(sigma)
    na_eff = math.ceil(sigma * n_a - _EPS)
    na_eff = min(na_eff, n_a)
    if na_eff <= 0:
        return 0.0
    util = (sigma * n_a) / na_eff
    return (na_eff / (na_eff + n_f)) * ((n_a + n_f) / n_a) * util


def alpha_afd(sigma: float, n_a: int, n_f: int) -> float:
    """Eq. 16 — AFD penalty with discrete N_A scaling.

    Exact when σ·N_A ∈ ℤ, otherwise the better of floor/ceil rounding.
    """
    _check_sigma(sigma)
    x = sigma * n_a
    if abs(x - round(x)) < 1e-9:
        return alpha_afd_exact(sigma, n_a, n_f)
    return max(alpha_afd_floor(sigma, n_a, n_f),
               alpha_afd_ceil(sigma, n_a, n_f))


# ---------------------------------------------------------------------------
# Fig. 6 sweep
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImbalancePoint:
    lam: float                  # λ: t_a/t_f (EP) or N_A/N_F (AFD)
    sigma: float
    n_f: int
    n_a: int
    alpha_ep: float
    alpha_afd: float

    @property
    def afd_deficit(self) -> float:
        """How much worse AFD is than large-scale EP at this point."""
        return self.alpha_ep - self.alpha_afd


def fig6_sweep(n_fs=(2, 4, 6), sigmas=(0.7, 0.75, 0.8, 0.85),
               lam_lo: float = 1.0, lam_hi: float = 5.0,
               lam_steps: int = 33) -> list[ImbalancePoint]:
    """Reproduce Fig. 6: α vs λ for AFD (discrete) and EP (continuous).

    AFD's λ is realised as N_A = λ·N_F (only integer N_A are physical; we
    sweep λ on a grid and round N_A to the nearest integer ≥ 1, as the
    figure's discrete red curves do).
    """
    pts: list[ImbalancePoint] = []
    for n_f in n_fs:
        for sigma in sigmas:
            for i in range(lam_steps):
                lam = lam_lo + (lam_hi - lam_lo) * i / (lam_steps - 1)
                n_a = max(1, round(lam * n_f))
                pts.append(ImbalancePoint(
                    lam=lam, sigma=sigma, n_f=n_f, n_a=n_a,
                    alpha_ep=alpha_ep(sigma, lam),
                    alpha_afd=alpha_afd(sigma, n_a, n_f)))
    return pts


def afd_worse_fraction(pts: list[ImbalancePoint] | None = None,
                       tol: float = 1e-9) -> float:
    """Fraction of sweep points where AFD's penalty is strictly worse.

    Paper: "due to the problem of discrete scaling under AFD, it performs
    worse than large-scale EP in most cases."
    """
    pts = pts if pts is not None else fig6_sweep()
    worse = sum(1 for p in pts if p.alpha_afd < p.alpha_ep - tol)
    return worse / len(pts)
