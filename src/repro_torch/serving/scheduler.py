"""Serving policies of the port — a copy of ``repro.serving.scheduler``.

The §3.3 SLO scheduler observes per-tick stage latencies (measured on the
card, or injected), estimates the balancedness σ (planned latency / p95
observed) and applies the deployment-mode policy:

  * **EP mode**   — continuous batch adjustment: shrink to σ·B, then refill
    the freed FFN budget (α_EP of Eq. 12 > σ).
  * **AFD mode**  — discrete N_A rescale through the planner's floor/ceil
    selection (α_AFD of Eq. 16). The decision log records both αs so the
    deficit is observable.

Ticks that exceed ``deadline × t_B`` count as stragglers; past a 5 %
straggler rate σ is lowered further. ``ChunkedPrefillPolicy`` schedules
chunked prefill; ``inject_jitter`` makes a synthetic latency stream.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core import imbalance as imb
from repro_torch.core import planner as pln


@dataclasses.dataclass
class SLOConfig:
    tpot: float = 0.05                # s per output token
    l_accept: float = 1.7
    deadline_factor: float = 1.2      # straggler threshold ×t_B
    sigma_floor: float = 0.5
    window: int = 64                  # latency samples per estimate


@dataclasses.dataclass
class Decision:
    sigma: float
    mode: str                         # "ep" | "afd"
    batch_scale: float                # EP: new batch fraction
    n_a: Optional[int]                # AFD: new attention fleet
    alpha: float                      # realised throughput factor
    alpha_other: float                # the other mode's α at the same σ
    straggler_rate: float


class SLOScheduler:
    def __init__(self, slo: SLOConfig, mode: str = "ep",
                 lam: float = 4.0, plan: Optional[pln.AFDPlan] = None):
        assert mode in ("ep", "afd")
        if mode == "afd" and plan is None:
            raise ValueError("AFD mode needs an AFDPlan for discrete rescale")
        self.slo = slo
        self.mode = mode
        self.lam = lam
        self.plan = plan
        self.samples: List[float] = []
        self.decisions: List[Decision] = []

    # ---- observation -----------------------------------------------------------

    def observe(self, stage_latency: float) -> None:
        self.samples.append(stage_latency)
        if len(self.samples) > 4 * self.slo.window:
            self.samples = self.samples[-2 * self.slo.window:]

    def estimate_sigma(self, t_budget: float) -> float:
        """σ = planned stage budget / p95 observed latency, clipped."""
        if not self.samples:
            return 1.0
        window = self.samples[-self.slo.window:]
        p95 = float(np.percentile(window, 95))
        if p95 <= t_budget:
            return 1.0
        return max(self.slo.sigma_floor, t_budget / p95)

    def straggler_rate(self, t_budget: float) -> float:
        if not self.samples:
            return 0.0
        window = self.samples[-self.slo.window:]
        deadline = self.slo.deadline_factor * t_budget
        return float(np.mean([s > deadline for s in window]))

    # ---- policy ---------------------------------------------------------------

    def decide(self, t_budget: float) -> Decision:
        sigma = self.estimate_sigma(t_budget)
        srate = self.straggler_rate(t_budget)
        if srate > 0.05:
            # straggler pressure: pre-emptively derate before the 3BO
            # pipeline amplifies it (jitter propagation, §2.2)
            sigma = max(self.slo.sigma_floor, sigma * (1.0 - srate))

        if self.mode == "ep":
            alpha = imb.alpha_ep(sigma, self.lam) if sigma < 1.0 else 1.0
            other = (imb.alpha_afd(sigma,
                                   max(1, round(self.lam * 4)), 4)
                     if sigma < 1.0 else 1.0)
            d = Decision(sigma=sigma, mode="ep", batch_scale=alpha,
                         n_a=None, alpha=alpha, alpha_other=other,
                         straggler_rate=srate)
        else:
            if sigma < 1.0:
                r = pln.elastic_rescale(self.plan, sigma)
                alpha, n_a = r.alpha, r.new_n_a
                other = r.alpha_ep_reference
            else:
                alpha, n_a, other = 1.0, self.plan.n_a, 1.0
            d = Decision(sigma=sigma, mode="afd", batch_scale=sigma,
                         n_a=n_a, alpha=alpha, alpha_other=other,
                         straggler_rate=srate)
        self.decisions.append(d)
        return d


@dataclasses.dataclass(frozen=True)
class ChunkedPrefillPolicy:
    """Chunked-prefill interleaving schedule: admitted prompts prefill
    ``chunk`` tokens at a time, and each engine tick runs at most
    ``max_chunks_per_tick`` chunks alongside the 3BO decode rotation.
    Decode TPOT stays bounded by the tick budget while TTFT drops from
    O(prompt) ticks (token-by-token teacher forcing) to O(prompt/chunk).
    FIFO across prefilling requests keeps the schedule deterministic.
    """
    chunk: int
    max_chunks_per_tick: int = 1

    def __post_init__(self) -> None:
        if self.chunk < 1:
            raise ValueError(f"chunk must be ≥ 1, got {self.chunk}")
        if self.max_chunks_per_tick < 1:
            raise ValueError("max_chunks_per_tick must be ≥ 1")

    def next_chunk(self, remaining: int) -> int:
        """Tokens to prefill next for a prompt with ``remaining`` left."""
        return min(self.chunk, remaining)


def inject_jitter(base_latency: float, n: int, sigma_true: float,
                  seed: int = 0) -> List[float]:
    """Synthetic stage-latency stream whose p95 encodes a true σ.

    Latency ~ base · (1 + |N(0, s)|) calibrated so that
    p95(latency) ≈ base / σ_true — the scheduler should recover σ_true.
    """
    rng = np.random.RandomState(seed)
    target_p95 = base_latency / sigma_true
    # |N(0,1)| p95 ≈ 1.96
    s = (target_p95 - base_latency) / (1.96 * base_latency) \
        if sigma_true < 1.0 else 0.0
    return list(base_latency * (1.0 + np.abs(rng.randn(n)) * s))
