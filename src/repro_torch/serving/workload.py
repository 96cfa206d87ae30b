"""Open-loop stochastic workload generation (a copy of
``repro.serving.workload``, which is numpy only) — the "millions of users"
traffic model for the serving engines.

Requests arrive on an *open loop* (arrival times are independent of how
fast the engine drains them, the queueing framing of the stochastic-
workload provisioning literature): a non-homogeneous Poisson process
shaped by named phases (steady rate, bursts, linear ramps), with mixed
prompt/output-length distributions (a short "chat" body plus an optional
long "document" tail).

Everything here is numpy-only and seeded — a (profile, seed) pair is a
deterministic trace, so engine runs, the golden-diff gate, and the
measured-vs-predicted byte tests are all reproducible.

Named profiles:
  poisson-steady  constant-rate Poisson arrivals
  poisson-burst   steady → 4× burst → steady (jitter the SLO loop sees)
  ramp            diurnal up/down linear ramp
  heavy-tail      bimodal long-prompt / long-output mixture

Rates are requests per second of *virtual* time; the serving engines run
a virtual clock (deterministic tick duration by default) so traces are
hardware-independent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Uniform body plus an optional long tail: mixed length distribution.

    With probability ``p_long`` sample uniform [long_lo, long_hi], else
    uniform [lo, hi] (all bounds inclusive).
    """
    lo: int
    hi: int
    long_lo: int = 0
    long_hi: int = 0
    p_long: float = 0.0

    def __post_init__(self):
        if not 1 <= self.lo <= self.hi:
            raise ValueError(f"bad length bounds [{self.lo}, {self.hi}]")
        if not 0.0 <= self.p_long <= 1.0:
            raise ValueError(f"p_long must be in [0, 1], got {self.p_long}")
        if self.p_long > 0 and not 1 <= self.long_lo <= self.long_hi:
            raise ValueError(
                f"bad tail bounds [{self.long_lo}, {self.long_hi}]")

    @property
    def max_len(self) -> int:
        return max(self.hi, self.long_hi if self.p_long > 0 else 0)

    def sample(self, rng: np.random.RandomState) -> int:
        if self.p_long > 0 and rng.rand() < self.p_long:
            return int(rng.randint(self.long_lo, self.long_hi + 1))
        return int(rng.randint(self.lo, self.hi + 1))


@dataclasses.dataclass(frozen=True)
class Phase:
    """One traffic phase: constant rate, or a linear ramp to ``rate_end``."""
    duration: float               # seconds of virtual time
    rate: float                   # arrivals/s at phase start (Poisson mean)
    rate_end: Optional[float] = None   # linear ramp target; None = constant

    def __post_init__(self):
        if self.duration <= 0:
            raise ValueError(f"phase duration must be > 0, got {self.duration}")
        if self.rate < 0 or (self.rate_end is not None and self.rate_end < 0):
            raise ValueError("phase rates must be ≥ 0")

    @property
    def peak_rate(self) -> float:
        return max(self.rate, self.rate_end if self.rate_end is not None
                   else self.rate)

    def rate_at(self, t: float) -> float:
        """Instantaneous rate at phase-local time ``t``."""
        if self.rate_end is None:
            return self.rate
        frac = min(max(t / self.duration, 0.0), 1.0)
        return self.rate + (self.rate_end - self.rate) * frac


@dataclasses.dataclass(frozen=True)
class TrafficProfile:
    name: str
    phases: Tuple[Phase, ...]
    prompt_len: LengthDist
    output_len: LengthDist
    description: str = ""

    @property
    def total_duration(self) -> float:
        return sum(p.duration for p in self.phases)

    @property
    def expected_requests(self) -> float:
        """Mean arrival count over the whole trace (trapezoid over ramps)."""
        return sum(p.duration * (p.rate + (p.rate_end if p.rate_end is not None
                                           else p.rate)) / 2.0
                   for p in self.phases)


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    rid: int
    t: float                      # virtual arrival time (s)
    prompt_len: int
    max_new_tokens: int


def generate_trace(profile: TrafficProfile, seed: int = 0,
                   max_requests: Optional[int] = None) -> List[ArrivalEvent]:
    """Sample a deterministic arrival trace from a profile.

    Non-homogeneous phases (ramps) use Poisson thinning against the phase's
    peak rate, so the trace is an exact draw from the time-varying process.
    """
    rng = np.random.RandomState(seed)
    events: List[ArrivalEvent] = []
    t0 = 0.0
    for phase in profile.phases:
        peak = phase.peak_rate
        if peak <= 0.0:               # silent phase: pure idle gap
            t0 += phase.duration
            continue
        t = 0.0
        while True:
            t += rng.exponential(1.0 / peak)
            if t >= phase.duration:
                break
            if phase.rate_end is not None \
                    and rng.rand() * peak > phase.rate_at(t):
                continue              # thinned: below the instantaneous rate
            events.append(ArrivalEvent(
                rid=len(events), t=t0 + t,
                prompt_len=profile.prompt_len.sample(rng),
                max_new_tokens=profile.output_len.sample(rng)))
            if max_requests is not None and len(events) >= max_requests:
                return events
        t0 += phase.duration
    return events


# ---------------------------------------------------------------------------
# Named profiles
# ---------------------------------------------------------------------------

_SHORT_PROMPT = LengthDist(2, 5)
_MIXED_PROMPT = LengthDist(2, 5, long_lo=8, long_hi=12, p_long=0.25)
_TAIL_PROMPT = LengthDist(2, 4, long_lo=10, long_hi=16, p_long=0.3)
_SHORT_OUTPUT = LengthDist(3, 6)
_MIXED_OUTPUT = LengthDist(3, 6, long_lo=10, long_hi=14, p_long=0.2)

PROFILES: Dict[str, TrafficProfile] = {
    "poisson-steady": TrafficProfile(
        name="poisson-steady",
        phases=(Phase(4.0, 16.0),),
        prompt_len=_SHORT_PROMPT, output_len=_SHORT_OUTPUT,
        description="constant-rate Poisson arrivals"),
    "poisson-burst": TrafficProfile(
        name="poisson-burst",
        phases=(Phase(1.5, 12.0), Phase(0.75, 48.0), Phase(1.5, 12.0)),
        prompt_len=_MIXED_PROMPT, output_len=_SHORT_OUTPUT,
        description="steady → 4x burst → steady"),
    "ramp": TrafficProfile(
        name="ramp",
        phases=(Phase(2.0, 4.0, rate_end=40.0),
                Phase(2.0, 40.0, rate_end=4.0)),
        prompt_len=_SHORT_PROMPT, output_len=_SHORT_OUTPUT,
        description="diurnal linear up/down ramp"),
    "heavy-tail": TrafficProfile(
        name="heavy-tail",
        phases=(Phase(4.0, 14.0),),
        prompt_len=_TAIL_PROMPT, output_len=_MIXED_OUTPUT,
        description="bimodal long-prompt / long-output mixture"),
}


def get_profile(name: str) -> TrafficProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(
            f"unknown traffic profile {name!r}; known: {sorted(PROFILES)}"
        ) from None


def list_profiles() -> List[str]:
    return sorted(PROFILES)
