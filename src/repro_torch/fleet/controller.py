"""Multi-replica fleet controller over ``AFDServeEngine`` replicas.
Counterpart of ``repro.fleet.controller``.

The §3.3 imbalance argument is a fleet phenomenon: it bites only when real
traffic is routed across replicas and N_F is re-chosen live.

  * **Routing**: every ``serving.workload`` arrival goes to a healthy
    replica chosen by a deterministic policy (``fleet.router``) from each
    replica's KV occupancy and queue.
  * **Heterogeneity**: replicas may differ in micro-batch shape
    (``n_bo × mb_slots``), e.g. prefill-heavy beside decode-heavy
    instances serving one queue.
  * **Failure**: a ``FailureEvent`` drains part of a replica
    (``simulate_failure``) or, when fatal, all of it (``drain_all``) and
    re-routes the requests onto healthy replicas with their original
    ``t_arrive``/``t_first``, so TTFT spans the outage. No request is lost.
  * **Elastic N_F**: per window the measured load fraction σ (tokens out
    plus queued pending tokens, over the healthy replicas' slot capacity)
    goes to ``fleet.rescaler``, which re-plans N_F through the planner when
    the penalty of staying exceeds the dead-zone threshold.

Clocks: the controller runs one virtual fleet clock at the engines' tick.
Each replica catches up to fleet time on its own clock; a replica that
prefilled a prompt token by token runs ahead and skips fleet ticks until
the clock reaches it, so every timestamp is deterministic.

Per fleet window the controller diffs each replica's measured dispatch and
combine bytes against the engine's cumulative Eq. 9/17 prediction
(``AFDServeEngine.predicted_wire_bytes``): byte-exactness holds per replica
inside the fleet too.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.fleet.events import DrainRecord, FailureEvent, RescaleEvent
from repro_torch.fleet.rescaler import ElasticRescaler
from repro_torch.fleet.router import (ReplicaView, RouteRequest,
                                      RouterPolicy, get_policy)
from repro_torch.serving.afd_engine import AFDServeEngine, ServeRequest
from repro_torch.serving.workload import ArrivalEvent


@dataclasses.dataclass
class FleetReplica:
    """One engine plus its fleet-side bookkeeping."""
    name: str
    engine: AFDServeEngine
    role: str = "mixed"                 # prefill | decode | mixed
    healthy: bool = True
    dispatched: int = 0                 # arrivals routed here
    requeued_in: int = 0                # failover re-admissions

    def view(self, index: int) -> ReplicaView:
        eng = self.engine
        return ReplicaView(
            index=index, name=self.name,
            queue_len=len(eng.queue), live=eng.live_count(),
            total_slots=eng.total_slots,
            kv_occupancy_bytes=eng.kv_occupancy_bytes(),
            kv_budget_bytes=eng.kv_budget_bytes,
            queued_kv_bytes=eng.queued_kv_bytes(),
            queued_prompt_tokens=eng.queued_prompt_tokens(),
            queued_pending_tokens=eng.queued_pending_tokens(),
            tick_seconds=eng.tick_seconds,
            prefill_chunk=eng.prefill_chunk,
            prefill_backlog_tokens=eng.prefill_backlog_tokens())


@dataclasses.dataclass
class FleetWindowRecord:
    """Per-window fleet observables (JSON-ready through asdict)."""
    window: int
    t_start: float
    t_end: float
    ticks: int
    arrivals: int                       # routed this window
    completed: int
    tokens_out: int
    queue_len: int                      # over the healthy replicas
    live: int
    kv_occupancy_bytes: int
    goodput_rps: float
    goodput_tps: float
    ttft_p50: Optional[float]
    ttft_p95: Optional[float]
    tpot_mean: Optional[float]
    slo_ok_frac: Optional[float]
    bytes_match: bool                   # every replica's window delta
    sigma_load: float                   # demand / provisioned capacity
    n_f: int                            # the rescaler's plan after it
    per_replica: List[Dict] = dataclasses.field(default_factory=list)
    rescale: Optional[Dict] = None
    failures: List[Dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _ReplicaSnapshot:
    dispatch_bytes: int
    combine_bytes: int
    pred_dispatch: int
    pred_combine: int
    completed: int
    tokens_out: int
    ticks: int
    dispatched: int


class FleetController:
    def __init__(self, replicas: Sequence[Union[AFDServeEngine,
                                                FleetReplica]], *,
                 router: Union[str, RouterPolicy] = "round-robin",
                 rescaler: Optional[ElasticRescaler] = None,
                 window_ticks: int = 8):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas: List[FleetReplica] = [
            r if isinstance(r, FleetReplica)
            else FleetReplica(name=f"replica{i}", engine=r)
            for i, r in enumerate(replicas)]
        ticks = {r.engine.tick_seconds for r in self.replicas}
        if None in ticks or len(ticks) != 1:
            raise ValueError(
                "fleet replicas must share one virtual tick_seconds "
                f"(got {sorted(ticks, key=str)})")
        self.tick_s = float(ticks.pop())
        self.router = (get_policy(router) if isinstance(router, str)
                       else router)
        self.rescaler = rescaler
        self.window_ticks = window_ticks

        self.now = 0.0
        self.ticks = 0
        self.arrivals = 0
        self.dispatched = 0
        self.requeued = 0
        self.windows: List[FleetWindowRecord] = []
        self.drains: List[DrainRecord] = []
        self.rescales: List[RescaleEvent] = []
        self.trace: Deque[ArrivalEvent] = collections.deque()
        self._failures: Deque[FailureEvent] = collections.deque()
        # the fleet's TTFT/TPOT SLOs are the first replica's
        eng0 = self.replicas[0].engine
        self.slo_tpot = eng0.slo_tpot
        self.slo_ttft = eng0.slo_ttft
        self._open_window()

    # ---- replica views -----------------------------------------------------

    def healthy(self) -> List[Tuple[int, FleetReplica]]:
        return [(i, r) for i, r in enumerate(self.replicas) if r.healthy]

    def _views(self) -> List[ReplicaView]:
        return [r.view(i) for i, r in self.healthy()]

    def total_live(self) -> int:
        return sum(r.engine.live_count() for _, r in self.healthy())

    def total_queued(self) -> int:
        return sum(len(r.engine.queue) for _, r in self.healthy())

    # ---- routing -----------------------------------------------------------

    def _route(self, rr: RouteRequest) -> FleetReplica:
        views = self._views()
        if not views:
            raise RuntimeError("no healthy replicas left to route to")
        idx = self.router.choose(rr, views)
        rep = self.replicas[idx]
        if not rep.healthy:
            raise RuntimeError(
                f"router chose unhealthy replica {idx} ({rep.name})")
        return rep

    def _dispatch_arrivals(self) -> None:
        while self.trace and self.trace[0].t <= self.now + 1e-12:
            ev = self.trace.popleft()
            rep = self._route(RouteRequest(
                rid=ev.rid, t=ev.t, prompt_len=ev.prompt_len,
                max_new_tokens=ev.max_new_tokens))
            rep.engine.submit(ev)
            rep.dispatched += 1
            self.dispatched += 1
            self._w_arrivals += 1

    # ---- failures ----------------------------------------------------------

    def inject_failure(self, event: FailureEvent) -> DrainRecord:
        """Fire one failure now (the scheduled path uses this too)."""
        rep = self.replicas[event.replica]
        if not rep.healthy:
            rec = DrainRecord(t=self.now, replica=event.replica,
                              frac=event.frac, requeued=0, fatal=True)
            self.drains.append(rec)
            return rec
        fatal = event.frac >= 1.0 - 1e-12
        if fatal:
            survivors = rep.engine.drain_all()
            rep.healthy = False
            for req in survivors:
                dst = self._route(RouteRequest(
                    rid=req.rid, t=self.now, prompt_len=len(req.prompt),
                    max_new_tokens=req.max_new_tokens))
                dst.engine.resubmit(req)
                dst.requeued_in += 1
            requeued = len(survivors)
        else:
            requeued = rep.engine.simulate_failure(event.frac)
        self.requeued += requeued
        rec = DrainRecord(t=self.now, replica=event.replica,
                          frac=event.frac, requeued=requeued, fatal=fatal)
        self.drains.append(rec)
        self._w_failures.append(rec)
        return rec

    def _fire_failures(self) -> None:
        while self._failures and self._failures[0].t <= self.now + 1e-12:
            self.inject_failure(self._failures.popleft())

    # ---- windows -----------------------------------------------------------

    def _snapshot(self, rep: FleetReplica) -> _ReplicaSnapshot:
        eng = rep.engine
        pred_d, pred_c = eng.predicted_wire_bytes()
        return _ReplicaSnapshot(
            dispatch_bytes=eng.rt.stats.dispatch_bytes,
            combine_bytes=eng.rt.stats.combine_bytes,
            pred_dispatch=pred_d, pred_combine=pred_c,
            completed=len(eng.completed),
            tokens_out=eng.stats.tokens_out,
            ticks=eng.stats.decode_ticks,
            dispatched=rep.dispatched + rep.requeued_in)

    def _open_window(self) -> None:
        self._w_t0 = self.now
        self._w_ticks = 0
        self._w_arrivals = 0
        self._w_failures: List[DrainRecord] = []
        self._w_snap = [self._snapshot(r) for r in self.replicas]

    def _slo_ok(self, done: Sequence[ServeRequest]) -> List[ServeRequest]:
        return [r for r in done
                if r.tpot <= self.slo_tpot * (1 + 1e-9)
                and r.ttft <= self.slo_ttft * (1 + 1e-9)]

    def _close_window(self) -> None:
        dur = max(self.now - self._w_t0, 1e-12)
        per_replica: List[Dict] = []
        done: List[ServeRequest] = []
        tokens_out = 0
        capacity = 0
        all_match = True
        for i, rep in enumerate(self.replicas):
            eng, snap = rep.engine, self._w_snap[i]
            pred_d, pred_c = eng.predicted_wire_bytes()
            d_bytes = eng.rt.stats.dispatch_bytes - snap.dispatch_bytes
            c_bytes = eng.rt.stats.combine_bytes - snap.combine_bytes
            d_pred = pred_d - snap.pred_dispatch
            c_pred = pred_c - snap.pred_combine
            match = d_bytes == d_pred and c_bytes == c_pred
            all_match &= match
            window_done = eng.completed[snap.completed:]
            done.extend(window_done)
            tokens_out += eng.stats.tokens_out - snap.tokens_out
            if rep.healthy:
                capacity += self._w_ticks * eng.total_slots
            per_replica.append({
                "name": rep.name, "role": rep.role,
                "healthy": rep.healthy,
                "dispatched": (rep.dispatched + rep.requeued_in
                               - snap.dispatched),
                "completed": len(window_done),
                "tokens_out": eng.stats.tokens_out - snap.tokens_out,
                "ticks": eng.stats.decode_ticks - snap.ticks,
                "live": eng.live_count() if rep.healthy else 0,
                "queue_len": len(eng.queue),
                "kv_occupancy_bytes": eng.kv_occupancy_bytes(),
                "dispatch_bytes": d_bytes, "combine_bytes": c_bytes,
                "predicted_dispatch_bytes": d_pred,
                "predicted_combine_bytes": c_pred,
                "bytes_match": match,
            })

        # measured load fraction: tokens decoded plus the backlog still
        # queued, over the slot capacity the healthy replicas provisioned
        # for this window; above 1 the fleet is behind demand
        backlog = sum(r.engine.queued_pending_tokens()
                      for _, r in self.healthy())
        sigma_load = (tokens_out + backlog) / capacity if capacity else 0.0

        ttfts = sorted(r.ttft for r in done)
        ok = self._slo_ok(done)
        rec = FleetWindowRecord(
            window=len(self.windows), t_start=self._w_t0, t_end=self.now,
            ticks=self._w_ticks, arrivals=self._w_arrivals,
            completed=len(done), tokens_out=tokens_out,
            queue_len=self.total_queued(), live=self.total_live(),
            kv_occupancy_bytes=sum(r.engine.kv_occupancy_bytes()
                                   for _, r in self.healthy()),
            goodput_rps=len(ok) / dur,
            goodput_tps=sum(len(r.output) for r in ok) / dur,
            ttft_p50=(float(np.percentile(ttfts, 50)) if ttfts else None),
            ttft_p95=(float(np.percentile(ttfts, 95)) if ttfts else None),
            tpot_mean=(float(np.mean([r.tpot for r in done]))
                       if done else None),
            slo_ok_frac=(len(ok) / len(done) if done else None),
            bytes_match=all_match, sigma_load=sigma_load,
            n_f=self.rescaler.n_f if self.rescaler else 0,
            per_replica=per_replica,
            failures=[dataclasses.asdict(f) for f in self._w_failures])
        if self.rescaler is not None and sigma_load > 0:
            event = self.rescaler.observe(rec.window, self.now, sigma_load)
            if event is not None:
                self.rescales.append(event)
                rec.rescale = dataclasses.asdict(event)
                rec.n_f = event.new_n_f
        self.windows.append(rec)
        self._open_window()

    # ---- the fleet tick ----------------------------------------------------

    def step(self) -> None:
        """One fleet tick: advance the clock, fire due failures, route due
        arrivals, let every healthy replica catch up to fleet time."""
        self.now += self.tick_s
        self._fire_failures()
        self._dispatch_arrivals()
        for _, rep in self.healthy():
            eng = rep.engine
            while eng.now < self.now - 1e-12:
                if not (eng.queue or eng.live_count()):
                    eng.now = self.now
                    break
                before = eng.now
                eng.tick()
                if eng.now <= before + 1e-15:    # admission stalled
                    eng.now = self.now
                    break
        self.ticks += 1
        self._w_ticks += 1
        if self._w_ticks >= self.window_ticks:
            self._close_window()

    # ---- the serve loop ----------------------------------------------------

    def run(self, trace: Sequence[ArrivalEvent],
            failures: Sequence[FailureEvent] = (),
            max_ticks: int = 100_000) -> List[FleetWindowRecord]:
        self.trace = collections.deque(sorted(trace, key=lambda e: e.t))
        self.arrivals += len(self.trace)
        self._failures = collections.deque(
            sorted(failures, key=lambda f: f.t))
        while self.ticks < max_ticks:
            busy = self.total_live() or self.total_queued()
            if not busy and not self.trace:
                break
            if not busy and self.trace:
                # idle gap: fast-forward to the next arrival or failure
                nxt = self.trace[0].t
                if self._failures:
                    nxt = min(nxt, self._failures[0].t)
                self.now = max(self.now, nxt - self.tick_s)
                for _, rep in self.healthy():
                    rep.engine.now = max(rep.engine.now, self.now)
            self.step()
        if self._w_ticks:
            self._close_window()
        return self.windows

    # ---- summaries ---------------------------------------------------------

    def completed_requests(self) -> List[ServeRequest]:
        return [r for rep in self.replicas for r in rep.engine.completed]

    def summary(self) -> Dict[str, object]:
        done = self.completed_requests()
        ttfts = sorted(r.ttft for r in done)
        ok = self._slo_ok(done)
        dur = max(self.now, 1e-12)
        return {
            "replicas": len(self.replicas),
            "healthy": len(self.healthy()),
            "router": self.router.name,
            "arrivals": self.arrivals,
            "dispatched": self.dispatched,
            "completed": len(done),
            "lost": self.arrivals - len(done) - self.total_live()
                    - self.total_queued(),
            "requeued": self.requeued,
            "fleet_ticks": self.ticks,
            "duration_s": self.now,
            "tokens_out": sum(r.engine.stats.tokens_out
                              for r in self.replicas),
            "goodput_rps": len(ok) / dur,
            "goodput_tps": sum(len(r.output) for r in ok) / dur,
            "slo_ok_frac": (len(ok) / len(done)) if done else None,
            "ttft_p50": float(np.percentile(ttfts, 50)) if ttfts else None,
            "ttft_p95": float(np.percentile(ttfts, 95)) if ttfts else None,
            "windows": len(self.windows),
            "bytes_match_all": all(w.bytes_match for w in self.windows),
            "rescale_events": len(self.rescales),
            "n_f_final": self.rescaler.n_f if self.rescaler else None,
            "drains": len(self.drains),
            "per_replica": {
                r.name: {
                    "role": r.role, "healthy": r.healthy,
                    "dispatched": r.dispatched,
                    "requeued_in": r.requeued_in,
                    "completed": len(r.engine.completed),
                    "tokens_out": r.engine.stats.tokens_out,
                    "decode_ticks": r.engine.stats.decode_ticks,
                    "dispatch_bytes": r.engine.rt.stats.dispatch_bytes,
                    "combine_bytes": r.engine.rt.stats.combine_bytes,
                } for r in self.replicas},
        }
