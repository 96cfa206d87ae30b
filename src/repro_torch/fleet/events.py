"""Fleet event types: failures injected into a run, and the drain and
rescale records the controller emits. Counterpart of
``repro.fleet.events``: flat frozen dataclasses, so they serialise through
``dataclasses.asdict`` into the fleet's window stream as plain JSON.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """A scheduled replica failure on the fleet's virtual clock.

    ``frac < 1`` is a partial failure: the replica loses ``ceil(frac ·
    total_slots)`` slots (``AFDServeEngine.simulate_failure``) and keeps
    serving. ``frac == 1`` kills the replica: it is drained through
    ``drain_all`` and its requests are re-routed to healthy replicas.
    """
    t: float
    replica: int
    frac: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {self.frac}")
        if self.t < 0:
            raise ValueError(f"failure time must be ≥ 0, got {self.t}")


@dataclasses.dataclass(frozen=True)
class DrainRecord:
    """What a fired FailureEvent did."""
    t: float
    replica: int
    frac: float
    requeued: int               # in-flight + queued requests re-routed
    fatal: bool                 # the replica left the fleet


@dataclasses.dataclass(frozen=True)
class RescaleEvent:
    """One discrete N_F re-plan of the elastic rescaler: the planner's
    ``NFRescaleDecision`` plus the window and the re-planned HFU, so the
    decision can be recomputed from the record alone."""
    window: int
    t: float
    sigma: float
    old_n_f: int
    new_n_f: int
    rounding: str
    alpha_stay: float
    alpha_new: float
    penalty: float
    residual_penalty: float
    threshold: float
    hfu_old: float
    hfu_new: float
    n_a_old: int
    n_a_new: int
