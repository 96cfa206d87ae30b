"""Batch-overlap pipeline simulator (paper §2.2, Table 2, Fig. 1b).

A copy of ``repro.core.overlap`` (the port imports nothing of ``repro``):
the same float operations in the same order, so every result is JAX's.

A discrete-event model of one decode run-batch forwarded through
``n_layers`` of (attention → dispatch → grouped-FFN → combine), under the
four overlap disciplines the paper compares:

  * **NBO** — one micro-batch, fully serial on one device pool.
  * **SBO** — one micro-batch; the shared-expert GEMM hides dispatch.
  * **2BO** — two micro-batches ping-pong compute and comm streams
    (large-scale EP practice on H800).
  * **3BO (AFD)** — three micro-batches rotate over three resource
    classes: the attention role (A), the interconnect, and the FFN
    role (F). The paper's Fig. 1b: 2BO in AFD necessarily leaves
    attention-side bubbles because t_dispatch + t_f + t_combine > t_a;
    3BO can be bubble-free iff max(t_a, t_f, t_c) ≤ t_B.

The simulator is a true event-driven list scheduler: jobs become ready when
their predecessor finishes, and the earliest-startable ready job is granted
its resource first (FIFO within equal start times). This avoids the
program-order artifacts of closed-form "schedule in loop order" models.

Resource semantics: attention compute serialises on A, FFN compute on F
(A == F when ``colocated``, i.e. large-scale EP on one device pool);
dispatch and combine ride opposite directions of the interconnect and get
independent link resources when ``duplex=True`` (the default — dispatch is
A→F traffic, combine F→A), or one serial link when ``duplex=False`` (the
paper's conservative t_c = t_dispatch + t_combine reading).

Per-(micro-batch, layer, stage) jitter injection makes §3.3's "bubbles
propagate bidirectionally" claim checkable: in a tight 3BO schedule a
single stretched stage delays *both* roles' subsequent stages and the
surplus never heals within the run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Literal, Optional, Tuple

Mode = Literal["NBO", "SBO", "2BO", "3BO"]

# jitter(micro_batch, layer, stage) -> multiplicative latency factor (>= 1).
JitterFn = Callable[[int, int, str], float]


def no_jitter(_m: int, _l: int, _s: str) -> float:
    return 1.0


@dataclasses.dataclass(frozen=True)
class StageTimes:
    """Per-layer stage latencies of one micro-batch (seconds)."""
    t_attn: float               # t_a
    t_ffn: float                # t_f  (grouped GEMM on the F role)
    t_dispatch: float           # scale-out/up dispatch of one micro-batch
    t_combine: float            # the reverse transfer
    t_shared: float = 0.0       # shared-expert GEMM (SBO overlap source)

    @property
    def t_comm(self) -> float:
        """t_c = t_dispatch + t_combine (paper §2.2)."""
        return self.t_dispatch + self.t_combine


@dataclasses.dataclass(frozen=True)
class PipelineResult:
    mode: Mode
    makespan: float
    a_busy: float               # attention-resource busy time
    f_busy: float               # FFN-resource busy time
    c_busy: float               # total link busy time (both directions)
    n_micro: int
    n_layers: int
    events: Tuple[Tuple[int, int, str, float, float], ...]  # (mb, layer, stage, start, end)

    @property
    def a_util(self) -> float:
        return self.a_busy / self.makespan if self.makespan else 0.0

    @property
    def f_util(self) -> float:
        return self.f_busy / self.makespan if self.makespan else 0.0

    @property
    def a_bubble(self) -> float:
        """Idle fraction of the attention resource (the paper's 'GPU bubbles')."""
        return 1.0 - self.a_util

    @property
    def f_bubble(self) -> float:
        return 1.0 - self.f_util


def _micro_batches(mode: Mode) -> int:
    return {"NBO": 1, "SBO": 1, "2BO": 2, "3BO": 3}[mode]


# Stage chain of one (micro-batch, layer). "shared" only exists under SBO;
# it runs concurrently with "dispatch" and joins before "ffn".
_STAGES = ("attn", "dispatch", "ffn", "combine")


def simulate(mode: Mode, st: StageTimes, n_layers: int,
             colocated: Optional[bool] = None,
             duplex: bool = True,
             jitter: JitterFn = no_jitter,
             n_micro: Optional[int] = None) -> PipelineResult:
    """Run the event simulation.

    ``colocated=True`` models large-scale EP (attention and FFN share the
    device pool); ``False`` models AFD (separate A/F roles). Default: EP
    for NBO/SBO/2BO, AFD for 3BO — the pairings the paper discusses.
    """
    if colocated is None:
        colocated = mode != "3BO"
    m = n_micro if n_micro is not None else _micro_batches(mode)
    sbo = mode == "SBO" and st.t_shared > 0

    dur = {
        "attn": st.t_attn, "dispatch": st.t_dispatch, "ffn": st.t_ffn,
        "combine": st.t_combine, "shared": st.t_shared,
    }

    def resource_of(stage: str) -> str:
        if stage in ("attn",):
            return "compute" if colocated else "A"
        if stage in ("ffn", "shared"):
            return "compute" if colocated else "F"
        if stage == "dispatch":
            return "link_d" if duplex else "link"
        return "link_c" if duplex else "link"

    free: Dict[str, float] = {}
    busy: Dict[str, float] = {}

    # Job graph. A job is (mb, layer, stage); ready time = max over preds.
    # done[(mb, layer, stage)] = finish time.
    done: Dict[Tuple[int, int, str], float] = {}
    events: List[Tuple[int, int, str, float, float]] = []

    def preds(mb: int, layer: int, stage: str) -> List[Tuple[int, int, str]]:
        if stage == "attn":
            return [(mb, layer - 1, "combine")] if layer > 0 else []
        if stage in ("dispatch", "shared"):
            return [(mb, layer, "attn")]
        if stage == "ffn":
            p = [(mb, layer, "dispatch")]
            if sbo:
                p.append((mb, layer, "shared"))
            return p
        if stage == "combine":
            return [(mb, layer, "ffn")]
        raise ValueError(stage)

    # Pending jobs: one pointer per micro-batch is not enough once SBO forks,
    # so keep an explicit remaining set ordered by (layer, stage index, mb).
    stage_order = {"attn": 0, "dispatch": 1, "shared": 1, "ffn": 2, "combine": 3}
    pending: List[Tuple[int, int, str]] = []
    for layer in range(n_layers):
        for mb in range(m):
            for stage in _STAGES:
                pending.append((mb, layer, stage))
            if sbo:
                pending.append((mb, layer, "shared"))

    while pending:
        # Ready jobs = all predecessors finished.
        best = None
        best_key = None
        for job in pending:
            mb, layer, stage = job
            ps = preds(mb, layer, stage)
            if any(p not in done for p in ps):
                continue
            ready = max((done[p] for p in ps), default=0.0)
            res = resource_of(stage)
            start = max(ready, free.get(res, 0.0))
            key = (start, layer, stage_order[stage], mb)
            if best_key is None or key < best_key:
                best, best_key = job, key
        assert best is not None, "dependency cycle in overlap simulator"
        mb, layer, stage = best
        ps = preds(mb, layer, stage)
        ready = max((done[p] for p in ps), default=0.0)
        res = resource_of(stage)
        start = max(ready, free.get(res, 0.0))
        end = start + dur[stage] * jitter(mb, layer, stage)
        free[res] = end
        busy[res] = busy.get(res, 0.0) + (end - start)
        done[best] = end
        events.append((mb, layer, stage, start, end))
        pending.remove(best)

    makespan = max(done.values()) if done else 0.0
    if colocated:
        a_busy = sum(e - s for _, _, stg, s, e in events if stg == "attn")
        f_busy = sum(e - s for _, _, stg, s, e in events
                     if stg in ("ffn", "shared"))
    else:
        a_busy = busy.get("A", 0.0)
        f_busy = busy.get("F", 0.0)
    c_busy = (busy.get("link_d", 0.0) + busy.get("link_c", 0.0)
              + busy.get("link", 0.0))
    return PipelineResult(mode=mode, makespan=makespan, a_busy=a_busy,
                          f_busy=f_busy, c_busy=c_busy, n_micro=m,
                          n_layers=n_layers, events=tuple(sorted(
                              events, key=lambda e: (e[3], e[0]))))


# ---------------------------------------------------------------------------
# Paper claims as closed-form predicates
# ---------------------------------------------------------------------------

def afd_2bo_has_bubbles(st: StageTimes) -> bool:
    """§2.2: in AFD, 2BO leaves attention bubbles iff

        t_dispatch + t_f + t_combine > t_a .
    """
    return st.t_dispatch + st.t_ffn + st.t_combine > st.t_attn


def afd_3bo_steady_period(st: StageTimes, duplex: bool = True) -> float:
    """Steady-state per-(layer, micro-batch) period of a 3BO AFD pipeline.

    Cyclic-pipeline bound: with k=3 batches circulating through a loop of
    total service time t_a + t_c + t_f, the period is

        period = max(t_a, t_f, link, (t_a + t_f + t_c) / 3)

    where link = max(t_dispatch, t_combine) for duplex links and
    t_dispatch + t_combine for a serial link. Bubble-free on A iff
    t_a == period — hence the paper's optimum t_B = t_a = t_f ≥ t_c (Eq. 5).
    """
    link = (max(st.t_dispatch, st.t_combine) if duplex
            else st.t_dispatch + st.t_combine)
    cycle = st.t_attn + st.t_ffn + st.t_comm
    return max(st.t_attn, st.t_ffn, link, cycle / 3.0)


def steady_state_utilization(mode: Mode, st: StageTimes,
                             n_layers: int = 64,
                             colocated: Optional[bool] = None,
                             duplex: bool = True) -> Tuple[float, float]:
    """(A-util, F-util) over the pipeline's steady window.

    Strips the fill/drain transient: measures busy time accrued in the
    middle half of the makespan.
    """
    res = simulate(mode, st, n_layers, colocated=colocated, duplex=duplex)
    lo, hi = 0.25 * res.makespan, 0.75 * res.makespan
    a_busy = sum(min(e, hi) - max(s, lo)
                 for _, _, stage, s, e in res.events
                 if stage == "attn" and e > lo and s < hi)
    f_busy = sum(min(e, hi) - max(s, lo)
                 for _, _, stage, s, e in res.events
                 if stage in ("ffn", "shared") and e > lo and s < hi)
    span = hi - lo
    return a_busy / span, f_busy / span


def jitter_spike(mb: int, layer: int, stage: str, factor: float,
                 at_mb: int = 0, at_layer: int = 0,
                 at_stage: str = "ffn") -> float:
    """A single multiplicative latency spike, for propagation experiments."""
    if mb == at_mb and layer == at_layer and stage == at_stage:
        return factor
    return 1.0


def jitter_propagation_delay(st: StageTimes, n_layers: int,
                             factor: float, at_layer: int = 4) -> float:
    """How much one FFN-stage spike at ``at_layer`` delays the whole 3BO run.

    Returns makespan(with spike) − makespan(clean). In a tight schedule
    (t_a = t_f = period) the entire spike surplus survives to the end — the
    paper's "bubbles rapidly propagate bidirectionally" (§2.2).
    """
    clean = simulate("3BO", st, n_layers).makespan
    spiked = simulate(
        "3BO", st, n_layers,
        jitter=lambda m, l, s: jitter_spike(m, l, s, factor,
                                            at_mb=0, at_layer=at_layer,
                                            at_stage="ffn")).makespan
    return spiked - clean
