"""The benchmark's traffic generator, frozen here so that later changes to
the program cannot move the yardstick.

``LengthDist`` and ``Phase`` follow ``repro_torch.serving.workload``
(numpy only): prompt and output lengths from a uniform body with an
optional long tail, and constant-rate phases. The generator is
``stratified_trace``, the benchmark's own, and the only one. A cell's
window holds some tens of requests, and plain Poisson draws would give
every seed another amount of work in it. Here arrivals come in blocks of
``block`` requests that each last exactly ``block / rate`` seconds. Every
block holds the quantiles u = (j + 0.5) / block, j < block, of the
exponential gap (scaled so that the block's gaps sum to its length) and
of the two length distributions; the seed draws one permutation of each
of the three, and every block repeats it. A window that starts and ends
on block boundaries therefore receives the same requests under every
seed, in another order, and the requests in flight when it closes mirror
those in flight when it opened.

A traffic file (``afdbench/traffic/<name>.json``) holds the generator's
parameters; ``load_mix`` reads it and ``make_trace`` draws from it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Uniform body plus an optional long tail: with probability
    ``p_long`` uniform [long_lo, long_hi], else uniform [lo, hi] (bounds
    inclusive)."""
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

    def quantile(self, u: float) -> int:
        """The length at cumulative probability ``u`` in [0, 1): the tail
        takes the lowest ``p_long`` of it."""
        if self.p_long > 0 and u < self.p_long:
            span = self.long_hi - self.long_lo + 1
            return self.long_lo + min(int(u / self.p_long * span), span - 1)
        u = (u - self.p_long) / (1.0 - self.p_long) if self.p_long else u
        span = self.hi - self.lo + 1
        return self.lo + min(int(u * span), span - 1)


@dataclasses.dataclass(frozen=True)
class Phase:
    """One traffic phase at a constant rate."""
    duration: float               # seconds
    rate: float                   # arrivals/s

    def __post_init__(self):
        if self.duration <= 0:
            raise ValueError(f"phase duration must be > 0, got {self.duration}")
        if self.rate < 0:
            raise ValueError("phase rates must be ≥ 0")


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """What the engine's ``submit`` reads: id, due time (s from the start
    of the loop), prompt length and output length."""
    rid: int
    t: float
    prompt_len: int
    max_new_tokens: int


def stratified_trace(phases: Tuple[Phase, ...], prompt_len: LengthDist,
                     output_len: LengthDist, seed: int, block: int
                     ) -> List[ArrivalEvent]:
    """Each phase in blocks of ``block`` arrivals and ``block / rate``
    seconds; block k of a phase starts at k · block / rate with an
    arrival, the rest follow at the seed's permutation of the block's
    gaps."""
    if block < 1:
        raise ValueError("block must be ≥ 1")
    rng = np.random.RandomState(seed)
    u = (np.arange(block) + 0.5) / block
    gaps = -np.log1p(-u)
    g, p, o = (rng.permutation(a) for a in (
        gaps / gaps.sum(), [prompt_len.quantile(x) for x in u],
        [output_len.quantile(x) for x in u]))
    offsets = np.concatenate([[0.0], np.cumsum(g[:-1])])
    events: List[ArrivalEvent] = []
    t0 = 0.0
    for phase in phases:
        if phase.rate <= 0.0:
            t0 += phase.duration
            continue
        length = round(block / phase.rate, 9)
        for k in range(int(math.ceil(phase.duration / length))):
            for j in range(block):
                t = t0 + k * length + float(offsets[j]) * length
                if t >= t0 + phase.duration:
                    break
                events.append(ArrivalEvent(
                    rid=len(events), t=t, prompt_len=int(p[j]),
                    max_new_tokens=int(o[j])))
        t0 += phase.duration
    return events


@dataclasses.dataclass(frozen=True)
class Mix:
    """A traffic file: the generator's parameters and the run's shape."""
    name: str
    phases: Tuple[Phase, ...]
    prompt_len: LengthDist
    output_len: LengthDist
    warmup_s: float
    max_len: int
    block: int = 32
    sample_tokens: int = 256      # served tokens the check compares
    drain_s: float = 60.0         # wait past the window for first tokens

    def __post_init__(self):
        if self.max_len < self.prompt_len.max_len + self.output_len.max_len:
            raise ValueError(f"{self.name}: max_len {self.max_len} is shorter "
                             "than the longest prompt plus the longest output")

    @property
    def rate(self) -> float:
        return self.phases[0].rate

    def with_rate(self, rate: float) -> "Mix":
        """The same mix with every phase's rate scaled to ``rate`` for the
        first (the knee sweep)."""
        f = rate / self.rate
        return dataclasses.replace(self, phases=tuple(
            dataclasses.replace(p, rate=p.rate * f) for p in self.phases))


def load_mix(path: Path) -> Mix:
    d = json.loads(Path(path).read_text())
    return Mix(name=d["name"],
               phases=tuple(Phase(**p) for p in d["phases"]),
               prompt_len=LengthDist(**d["prompt_len"]),
               output_len=LengthDist(**d["output_len"]),
               warmup_s=float(d["warmup_s"]), max_len=int(d["max_len"]),
               block=int(d.get("block", 32)),
               sample_tokens=int(d.get("sample_tokens", 256)),
               drain_s=float(d.get("drain_s", 60.0)))


def sub_seed(seed: int, stream: int) -> int:
    """A 32-bit seed for numpy from any whole ``seed`` (the driver's exceed
    32 bits) and a stream number."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), stream])
               .generate_state(1)[0])


def make_trace(mix: Mix, seed: int, horizon_s: float) -> List[ArrivalEvent]:
    """The arrivals of the first ``horizon_s`` seconds of ``mix``: its
    phases are repeated from the start until they cover it."""
    reps = max(1, math.ceil(horizon_s / sum(p.duration for p in mix.phases)))
    phases = mix.phases * reps
    events = stratified_trace(phases, mix.prompt_len, mix.output_len,
                              sub_seed(seed, 1), mix.block)
    return [e for e in events if e.t < horizon_s]
