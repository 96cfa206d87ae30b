"""Two-role AFD continuous-batching engine under open-loop traffic.
Counterpart of ``repro.serving.afd_engine``.

The decode tick drives ``AFDRuntime.decode_step_3bo``: ``n_bo``
micro-batches of ``mb_slots`` sequences each rotate through the A-role
attention / dispatch / F-role expert FFN / combine cycle, fed by a
``serving.workload`` open-loop trace. The micro-batches keep their caches
from tick to tick, so on one CUDA device the runtime replays the rotation
from a CUDA graph from the second decode tick on (``parallel.afd``); the
engine reads its tokens and positions back before the next. Prompts are
prefilled either token by token through the decode path (legacy) or in
chunks through ``AFDRuntime.prefill``, one chunk per tick interleaved with
decode.

Per window the engine records the SLO metrics (goodput, TTFT p50/p95,
mean TPOT) and the runtime's measured dispatch/combine bytes beside the
Eq. 9/17 prediction (``core.planner``); they must match exactly. With an
``HFUProbe`` it also prices the window's routed tokens through the §3.2
HFU chain (``core.planner.live_hfu``): measured HFU never exceeds the
plan's Eq. 9 cap.

The §3.3 policy loop: an ``SLOScheduler`` observes each tick's latency,
estimates σ, and its per-window decision (EP batch shrink or AFD discrete
N_A rescale) sets the live-slot cap that throttles admission; decisions
are recorded in the window stream.

The clock is virtual and deterministic by default (a fixed tick duration,
or an injected latency stream ``tick_latencies``); ``tick_seconds=None``
uses the wall clock: a tick counts from its start (admission included)
through the read-back of its tokens and the splice of finished prefills,
synchronising the device before the reading. A tick's requests are
stamped (``t_first``, ``t_done``) with the clock after it.

Under a ``repro_torch.trace`` tracer each tick is an ``engine.tick`` span
with its phases (``engine.admit``, ``engine.prefill``, ``engine.rotation``,
``engine.readback``, ``engine.clock``, ``engine.finish_prefill``) inside,
and every host wait on the device here is counted (``sync.*``).

The fleet layer (``repro_torch.fleet``) reads the queue and KV
introspection (``queued_kv_bytes`` and friends) and drains replicas
through ``simulate_failure``, ``drain_all`` and ``resubmit``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import planner as pln
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec
from repro_torch.models.kvcache import attn_cache_len
from repro_torch.parallel.afd import AFDRuntime
from repro_torch.serving.engine import (PAD, failure_drain_count,
                                       splice_batch_slot)
from repro_torch.serving.scheduler import ChunkedPrefillPolicy, SLOScheduler
from repro_torch.serving.workload import ArrivalEvent


@dataclasses.dataclass
class ServeRequest:
    """One in-flight request."""
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int
    t_arrive: float
    t_first: float = -1.0               # first token emitted (TTFT end)
    t_done: float = -1.0
    output: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_arrive

    @property
    def tpot(self) -> float:
        n_decode = len(self.output) - 1
        if n_decode <= 0:
            return 0.0
        return (self.t_done - self.t_first) / n_decode


@dataclasses.dataclass
class _PrefillProgress:
    """A slot mid-chunked-prefill: its private 1-sequence cache fills
    ``chunk`` tokens per tick until the prompt is exhausted."""
    req: ServeRequest
    caches: list
    pos: torch.Tensor                   # (1,) int32
    offset: int = 0                     # prompt tokens prefilled so far


@dataclasses.dataclass
class _MicroBatch:
    caches: list                        # per-layer AFD caches
    pos: torch.Tensor                   # (mb_slots,) int32
    tokens: np.ndarray                  # (mb_slots,) int32 next feed
    slots: List[Optional[ServeRequest]]
    prefill: Dict[int, _PrefillProgress] = dataclasses.field(
        default_factory=dict)

    def live(self) -> List[int]:
        return [i for i, r in enumerate(self.slots)
                if r is not None and i not in self.prefill]

    def occupied(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]


@dataclasses.dataclass(frozen=True)
class HFUProbe:
    """Binds the live engine to one planner prediction (Eq. 9 / §3.2)."""
    model: MoEModelSpec
    hardware: HardwareSpec
    plan: pln.AFDPlan

    def window(self, tokens_routed: float, window_s: float) -> pln.LiveHFU:
        return pln.live_hfu(self.model, self.hardware, self.plan,
                            tokens_routed, window_s)


@dataclasses.dataclass
class WindowRecord:
    """Per-window serving observables (flat, JSON-ready)."""
    window: int
    t_start: float
    t_end: float
    ticks: int
    arrivals: int
    admitted: int
    completed: int
    tokens_out: int
    queue_len: int
    live: int
    ttft_p50: Optional[float]
    ttft_p95: Optional[float]
    tpot_mean: Optional[float]
    goodput_rps: float
    goodput_tps: float
    slo_ok_frac: Optional[float]
    dispatch_bytes: int
    combine_bytes: int
    predicted_dispatch_bytes: int
    predicted_combine_bytes: int
    bytes_match: bool
    tokens_routed: int                  # per-MoE-stage tokens this window
    kv_occupancy_bytes: int = 0
    kv_budget_bytes: int = 0
    prefill_tokens: int = 0
    prefill_chunks: int = 0             # M2N prefill cycles per MoE layer
    # §3.3 policy loop
    sigma: Optional[float] = None
    straggler_rate: Optional[float] = None
    alpha: Optional[float] = None
    alpha_other: Optional[float] = None
    policy_mode: Optional[str] = None
    n_a: Optional[int] = None
    live_cap: Optional[int] = None
    # live Eq. 9 / HFU comparison
    hfu_measured: Optional[float] = None
    hfu_predicted: Optional[float] = None
    b_rank_utilization: Optional[float] = None


@dataclasses.dataclass
class ServeStats:
    decode_ticks: int = 0
    engine_ticks: int = 0               # decode ticks + prefill-only ticks
    prefills: int = 0
    prefill_tokens: int = 0
    prefill_chunks: int = 0
    tokens_out: int = 0
    arrivals: int = 0
    completed: int = 0
    requeued: int = 0
    replans: int = 0


class AFDServeEngine:
    """Two-role continuous batching over ``n_bo × mb_slots`` sequences."""

    def __init__(self, runtime: AFDRuntime, *, max_len: int = 32,
                 n_bo: int = 2, mb_slots: int = 2,
                 scheduler: Optional[SLOScheduler] = None,
                 probe: Optional[HFUProbe] = None,
                 greedy: bool = True, seed: int = 0,
                 slo_tpot: float = 0.05, slo_ttft: float = 1.0,
                 tick_seconds: Optional[float] = 0.05,
                 tick_latencies: Optional[Sequence[float]] = None,
                 window_ticks: int = 8,
                 kv_budget_bytes: Optional[int] = None,
                 prefill_chunk: Optional[int] = None):
        if n_bo < 1 or mb_slots < 1:
            raise ValueError("need n_bo ≥ 1 and mb_slots ≥ 1")
        # None → legacy token-by-token teacher forcing at admission.
        self.prefill_policy = (None if prefill_chunk is None
                               else ChunkedPrefillPolicy(prefill_chunk))
        self.rt = runtime
        self.cfg = runtime.cfg
        self.device = runtime.a_device
        self.max_len = max_len
        self.n_bo = n_bo
        self.mb_slots = mb_slots
        self.total_slots = n_bo * mb_slots
        self.scheduler = scheduler
        self.probe = probe
        self.greedy = greedy
        self.rng = np.random.RandomState(seed)
        self.slo_tpot = slo_tpot
        self.slo_ttft = slo_ttft
        self.tick_seconds = tick_seconds
        self._latencies = list(tick_latencies) if tick_latencies else None
        self._lat_i = 0
        self._wall0 = time.perf_counter()   # the running tick's start
        self.window_ticks = window_ticks

        self.mbs = [self._fresh_mb() for _ in range(n_bo)]
        self._prefill_fifo: Deque[tuple] = collections.deque()
        self.queue: Deque[ServeRequest] = collections.deque()
        self.trace: Deque[ArrivalEvent] = collections.deque()
        self.now = 0.0
        self.stats = ServeStats()
        self.windows: List[WindowRecord] = []
        self.completed: List[ServeRequest] = []
        self.decisions: List = []
        self._live_cap = self.total_slots

        self._moe_layers = sum(1 for s in runtime.specs if s.moe)
        self._dtype_bytes = self.cfg.compute_dtype.itemsize

        # Cache footprint: attention layers cost 2·n_kv·d_head bytes per
        # cached token (ring-capped for sliding-window archs); Mamba layers
        # cost their conv tail and float32 state, O(1) per slot.
        cfg = self.cfg
        self._kv_ring_len = attn_cache_len(cfg, max_len)
        self._kv_token_bytes = sum(
            2 * cfg.n_kv_heads * cfg.d_head * self._dtype_bytes
            for s in runtime.specs if s.kind == "attn")
        self._kv_static_bytes = sum(
            (cfg.ssm_conv - 1) * cfg.conv_dim * self._dtype_bytes
            + cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            for s in runtime.specs if s.kind == "mamba")
        self.kv_slot_bytes = (self._kv_static_bytes
                              + self._kv_token_bytes * self._kv_ring_len)
        # Default budget = the preallocated cache (one full slot each).
        self.kv_budget_bytes = (kv_budget_bytes if kv_budget_bytes is not None
                                else self.total_slots * self.kv_slot_bytes)
        self._open_window()

    # ---- plumbing ----------------------------------------------------------

    def _fresh_mb(self) -> _MicroBatch:
        caches, pos = self.rt.init_cache(self.mb_slots, self.max_len)
        return _MicroBatch(caches=caches, pos=pos,
                           tokens=np.full((self.mb_slots,), PAD, np.int32),
                           slots=[None] * self.mb_slots)

    def _tokens(self, toks) -> torch.Tensor:
        trace.count("sync.h2d_tokens")        # a pageable upload
        return torch.as_tensor(np.asarray(toks, np.int32), device=self.device)

    @staticmethod
    def _set_pos(mb: _MicroBatch, slot: int, value: int) -> None:
        trace.count("sync.pos_write")         # a host scalar, uploaded
        mb.pos[slot] = value

    def _select(self, logits_row: torch.Tensor) -> int:
        trace.count("sync.select")
        if self.greedy:
            return int(torch.argmax(logits_row))
        p = logits_row.float().cpu().numpy().astype(np.float64)
        p = np.exp(p - p.max())
        p /= p.sum()
        return int(self.rng.choice(p.shape[0], p=p))

    def live_count(self) -> int:
        """Occupied slots: decoding *and* still-prefilling requests."""
        return sum(len(mb.occupied()) for mb in self.mbs)

    def decode_live_count(self) -> int:
        return sum(len(mb.live()) for mb in self.mbs)

    def live_requests(self) -> List[ServeRequest]:
        return [r for mb in self.mbs for r in mb.slots if r is not None]

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens admitted but not yet prefilled (chunk backlog),
        which the fleet's predicted-TTFT router prices ahead of new work."""
        return sum(len(pf.req.prompt) - pf.offset
                   for mb in self.mbs for pf in mb.prefill.values())

    @property
    def prefill_chunk(self) -> Optional[int]:
        return (self.prefill_policy.chunk if self.prefill_policy is not None
                else None)

    # ---- KV-cache occupancy accounting -------------------------------------

    def kv_request_bytes(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case KV footprint reserved for one request at admission."""
        toks = min(prompt_len + max_new_tokens, self.max_len,
                   self._kv_ring_len)
        return self._kv_static_bytes + self._kv_token_bytes * toks

    def kv_occupancy_bytes(self) -> int:
        return sum(self.kv_request_bytes(len(r.prompt), r.max_new_tokens)
                   for r in self.live_requests())

    def queued_kv_bytes(self) -> int:
        return sum(self.kv_request_bytes(len(r.prompt), r.max_new_tokens)
                   for r in self.queue)

    def queued_prompt_tokens(self) -> int:
        return sum(len(r.prompt) for r in self.queue)

    def queued_pending_tokens(self) -> int:
        return sum(r.max_new_tokens for r in self.queue)

    # ---- cumulative wire prediction ----------------------------------------

    def _predicted(self, decode_ticks: int, prefill_tokens: int) -> tuple:
        cyc_d, cyc_c = pln.predict_m2n_cycle_bytes(
            self.mb_slots, self.cfg.d_model, self.cfg.top_k,
            dtype_bytes=self._dtype_bytes)
        pf_d, pf_c = pln.predict_prefill_window_bytes(
            prefill_tokens, self.cfg.d_model, self.cfg.top_k,
            dtype_bytes=self._dtype_bytes)
        cycles = decode_ticks * self.n_bo * self._moe_layers
        return (cycles * cyc_d + self._moe_layers * pf_d,
                cycles * cyc_c + self._moe_layers * pf_c)

    def predicted_wire_bytes(self) -> tuple:
        """Cumulative (dispatch, combine) bytes the Eq. 9/17 wire model
        predicts for everything this engine has executed since start."""
        return self._predicted(self.stats.decode_ticks,
                               self.stats.prefill_tokens)

    def _tick_duration(self) -> float:
        if self._latencies is not None:
            dt = self._latencies[self._lat_i % len(self._latencies)]
            self._lat_i += 1
            return float(dt)
        if self.tick_seconds is not None:
            return self.tick_seconds
        with trace.span("engine.clock"):
            self.rt.synchronize()
            trace.count("sync.clock")
            return max(time.perf_counter() - self._wall0, 1e-9)

    # ---- windows -----------------------------------------------------------

    def _open_window(self) -> None:
        self._w_t0 = self.now
        self._w_ticks = 0
        self._w_decode_ticks = 0
        self._w_arrivals = 0
        self._w_admitted = 0
        self._w_completed: List[ServeRequest] = []
        self._w_tokens_out = 0
        self._w_prefill_tokens = 0
        self._w_prefill_chunks = 0
        self._w_bytes0 = self.rt.stats.snapshot()

    def _close_window(self) -> None:
        delta = self.rt.stats.since(self._w_bytes0)
        pred_d, pred_c = self._predicted(self._w_decode_ticks,
                                         self._w_prefill_tokens)
        dur = max(self.now - self._w_t0, 1e-12)
        done = self._w_completed
        ttfts = sorted(r.ttft for r in done)
        ok = self._slo_ok(done)
        rec = WindowRecord(
            window=len(self.windows), t_start=self._w_t0, t_end=self.now,
            ticks=self._w_ticks, arrivals=self._w_arrivals,
            admitted=self._w_admitted, completed=len(done),
            tokens_out=self._w_tokens_out, queue_len=len(self.queue),
            live=self.live_count(),
            ttft_p50=(float(np.percentile(ttfts, 50)) if ttfts else None),
            ttft_p95=(float(np.percentile(ttfts, 95)) if ttfts else None),
            tpot_mean=(float(np.mean([r.tpot for r in done]))
                       if done else None),
            goodput_rps=len(ok) / dur,
            goodput_tps=sum(len(r.output) for r in ok) / dur,
            slo_ok_frac=(len(ok) / len(done) if done else None),
            dispatch_bytes=delta.dispatch_bytes,
            combine_bytes=delta.combine_bytes,
            predicted_dispatch_bytes=pred_d,
            predicted_combine_bytes=pred_c,
            bytes_match=(delta.dispatch_bytes == pred_d
                         and delta.combine_bytes == pred_c),
            tokens_routed=(delta.tokens_routed // self._moe_layers
                           if self._moe_layers else 0),
            kv_occupancy_bytes=self.kv_occupancy_bytes(),
            kv_budget_bytes=self.kv_budget_bytes,
            prefill_tokens=self._w_prefill_tokens,
            prefill_chunks=self._w_prefill_chunks,
        )
        if self.scheduler is not None:
            d = self.scheduler.decide(self._policy_budget())
            self.decisions.append(d)
            self._live_cap = max(1, int(math.floor(
                self.total_slots * d.batch_scale + 1e-9)))
            rec.sigma = d.sigma
            rec.straggler_rate = d.straggler_rate
            rec.alpha = d.alpha
            rec.alpha_other = d.alpha_other
            rec.policy_mode = d.mode
            rec.n_a = d.n_a
            rec.live_cap = self._live_cap
        if self.probe is not None and self._moe_layers:
            lh = self.probe.window(rec.tokens_routed, dur)
            rec.hfu_measured = lh.hfu_measured
            rec.hfu_predicted = lh.hfu_predicted
            rec.b_rank_utilization = lh.utilization
        self.windows.append(rec)
        self._open_window()

    def _policy_budget(self) -> float:
        """Per-tick latency budget the §3.3 loop compares p95 against."""
        if self.tick_seconds is not None:
            return self.tick_seconds
        return self.slo_tpot

    def _slo_ok(self, done: Sequence[ServeRequest]) -> List[ServeRequest]:
        return [r for r in done
                if r.tpot <= self.slo_tpot * (1 + 1e-9)
                and r.ttft <= self.slo_ttft * (1 + 1e-9)]

    # ---- admission ---------------------------------------------------------

    def submit(self, event: ArrivalEvent) -> None:
        self.queue.append(ServeRequest(
            rid=event.rid, prompt=self._make_prompt(event),
            max_new_tokens=event.max_new_tokens, t_arrive=event.t))
        self.stats.arrivals += 1
        self._w_arrivals += 1

    def _make_prompt(self, event: ArrivalEvent) -> np.ndarray:
        """Deterministic per-request prompt tokens derived from rid, as
        in the JAX engine, so traces replay exactly."""
        base = np.arange(event.prompt_len, dtype=np.int64)
        toks = (base * 131 + event.rid * 31 + 7) \
            % max(self.cfg.vocab_size - 1, 1) + 1
        return toks.astype(np.int32)

    def _drain_arrivals(self) -> None:
        while self.trace and self.trace[0].t <= self.now + 1e-12:
            self.submit(self.trace.popleft())

    def _prefill_single(self, req: ServeRequest):
        """Legacy admission: teacher-force the prompt token by token
        through the two-role decode path (each token its own 1-token M2N
        cycle, one tick of virtual time each). Returns the 1-sequence
        caches, final pos and the first output token."""
        wall0 = time.perf_counter()
        caches, pos = self.rt.init_cache(1, self.max_len)
        logits = None
        for tok in req.prompt:
            logits, caches, pos = self.rt.decode_step(
                self._tokens([tok]), caches, pos)
        n = len(req.prompt)
        self._w_prefill_tokens += n
        self.stats.prefill_tokens += n
        self._w_prefill_chunks += n
        self.stats.prefill_chunks += n
        first = self._select(logits[0])
        if self._latencies is not None or self.tick_seconds is not None:
            base = (self.tick_seconds if self.tick_seconds is not None
                    else self._latencies[0])
            self.now += n * base
        else:
            dt = max(time.perf_counter() - wall0, 1e-9)
            self.now += dt
            self._wall0 += dt             # so the tick's clock skips it
        return caches, pos, first

    def _admit(self) -> None:
        for mb_i, mb in enumerate(self.mbs):
            for slot in range(self.mb_slots):
                if not self.queue or self.live_count() >= self._live_cap:
                    return
                if mb.slots[slot] is not None:
                    continue
                head = self.queue[0]
                occupancy = self.kv_occupancy_bytes()
                need = self.kv_request_bytes(len(head.prompt),
                                             head.max_new_tokens)
                # Bytes-based cap; an empty batch always admits.
                if occupancy and occupancy + need > self.kv_budget_bytes:
                    return
                req = self.queue.popleft()
                if self.prefill_policy is not None:
                    caches1, pos1 = self.rt.init_cache(1, self.max_len)
                    mb.slots[slot] = req
                    mb.tokens[slot] = PAD
                    mb.prefill[slot] = _PrefillProgress(
                        req=req, caches=caches1, pos=pos1)
                    self._prefill_fifo.append((mb_i, slot))
                    self._w_admitted += 1
                    continue
                caches1, _, first = self._prefill_single(req)
                for li in range(len(mb.caches)):
                    splice_batch_slot(mb.caches[li], caches1[li], slot,
                                      self.mb_slots)
                self._set_pos(mb, slot, len(req.prompt))
                req.output.append(first)
                mb.slots[slot] = req
                mb.tokens[slot] = first
                self.stats.prefills += 1
                self.stats.tokens_out += 1
                self._w_tokens_out += 1
                self._w_admitted += 1
                if req.t_first < 0:
                    req.t_first = self.now
                if req.done:
                    self._complete(mb, slot)
                    req.t_done = self.now

    def _complete(self, mb: _MicroBatch, slot: int) -> None:
        """Free the slot of a finished request; the caller stamps its
        ``t_done``."""
        req = mb.slots[slot]
        self.completed.append(req)
        self._w_completed.append(req)
        self.stats.completed += 1
        mb.slots[slot] = None
        mb.tokens[slot] = PAD
        self._set_pos(mb, slot, 0)

    # ---- chunked prefill (one chunk per tick, FIFO over prefilling slots) ---

    def _prefill_tick(self) -> tuple:
        """Run up to ``max_chunks_per_tick`` prompt chunks. Returns
        (chunks_run, finished (mb_i, slot, logits) list)."""
        finished = []
        ran = 0
        while (self._prefill_fifo
               and ran < self.prefill_policy.max_chunks_per_tick):
            mb_i, slot = self._prefill_fifo[0]
            pf = self.mbs[mb_i].prefill[slot]
            c = self.prefill_policy.next_chunk(len(pf.req.prompt) - pf.offset)
            blk = self._tokens(pf.req.prompt[None, pf.offset:pf.offset + c])
            logits, pf.caches, pf.pos = self.rt.prefill(blk, pf.caches,
                                                        pf.pos)
            pf.offset += c
            ran += 1
            self.stats.prefill_tokens += c
            self._w_prefill_tokens += c
            self.stats.prefill_chunks += 1
            self._w_prefill_chunks += 1
            if pf.offset >= len(pf.req.prompt):
                self._prefill_fifo.popleft()
                finished.append((mb_i, slot, logits))
        return ran, finished

    def _finish_prefill(self, mb_i: int, slot: int, logits) -> ServeRequest:
        """Splice the prefilled cache into the batch slot (one slab write
        per attention plane; a Mamba layer's whole conv tail and state) and
        emit the first token this same tick, which stamps its ``t_first``."""
        mb = self.mbs[mb_i]
        pf = mb.prefill.pop(slot)
        req = pf.req
        n_tok = min(len(req.prompt), self._kv_ring_len)
        for li in range(len(mb.caches)):
            src = pf.caches[li]
            if self.rt.specs[li].kind == "attn" and n_tok < self._kv_ring_len:
                src = {kk: vv[:, :n_tok] for kk, vv in src.items()}
            splice_batch_slot(mb.caches[li], src, slot, self.mb_slots)
        self._set_pos(mb, slot, len(req.prompt))
        first = self._select(logits[0, -1])
        req.output.append(first)
        mb.tokens[slot] = first
        self.stats.prefills += 1
        self.stats.tokens_out += 1
        self._w_tokens_out += 1
        if req.done:
            self._complete(mb, slot)
        return req

    # ---- fleet drain hooks -------------------------------------------------

    def _drain_slot(self, mb: _MicroBatch, slot: int) -> Optional[ServeRequest]:
        """Evict one slot: the request (if any) restarts generation on
        re-admission but keeps its ``t_arrive``/``t_first`` timestamps."""
        req = mb.slots[slot]
        if req is not None:
            req.output.clear()
        if mb.prefill.pop(slot, None) is not None:
            # a mid-prefill eviction abandons the partial cache; the prompt
            # restarts from scratch on re-admission
            mb_i = next(i for i, m in enumerate(self.mbs) if m is mb)
            self._prefill_fifo = collections.deque(
                e for e in self._prefill_fifo if e != (mb_i, slot))
        mb.slots[slot] = None
        mb.tokens[slot] = PAD
        self._set_pos(mb, slot, 0)    # in place: this micro-batch's own tensor
        return req

    def simulate_failure(self, frac_nodes_lost: float, replan=None) -> int:
        """Fail ``frac_nodes_lost`` of this replica's capacity: exactly
        ``ceil(frac · total_slots)`` slots, the lowest (micro-batch, slot)
        indices, drain their requests back to the front of the local
        queue; the other slots keep their caches. ``replan``, if given, is
        called with the surviving fraction. Returns the requeue count."""
        n_drain = failure_drain_count(frac_nodes_lost, self.total_slots)
        requeued = 0
        for k in range(n_drain):
            req = self._drain_slot(self.mbs[k // self.mb_slots],
                                   k % self.mb_slots)
            if req is not None:
                self.queue.appendleft(req)
                requeued += 1
        self.stats.requeued += requeued
        self.stats.replans += 1
        if replan is not None:
            replan(1.0 - frac_nodes_lost)
        return requeued

    def drain_all(self) -> List[ServeRequest]:
        """Evacuate the replica (the fleet's failure path): every in-flight
        request in slot order, then the queue in arrival order, leaves with
        its timestamps so the fleet can requeue it elsewhere."""
        out: List[ServeRequest] = []
        for mb in self.mbs:
            for slot in range(self.mb_slots):
                req = self._drain_slot(mb, slot)
                if req is not None:
                    out.append(req)
        out.extend(self.queue)
        self.queue.clear()
        self.stats.requeued += len(out)
        return out

    def resubmit(self, req: ServeRequest) -> None:
        """Re-admit a drained request: generation restarts, ``t_arrive``
        and ``t_first`` stay (``_admit`` and ``tick`` stamp ``t_first`` only
        while it is unset), so TTFT spans the outage."""
        req.output.clear()
        self.queue.append(req)

    # ---- the decode tick ---------------------------------------------------

    def tick(self) -> int:
        """One engine tick: at most ``max_chunks_per_tick`` prompt chunks
        interleaved with the 3BO decode rotation. Returns the number of
        work units served (decode-live slots + prefill chunks run)."""
        self._wall0 = time.perf_counter()
        with trace.span("engine.tick"):
            return self._tick()

    def _tick(self) -> int:
        with trace.span("engine.admit"):
            self._drain_arrivals()
            self._admit()
        n_done = len(self.completed)

        ran_prefill, finished = 0, []
        if self.prefill_policy is not None and self._prefill_fifo:
            with trace.span("engine.prefill"):
                ran_prefill, finished = self._prefill_tick()

        decode_live = self.decode_live_count()
        if decode_live == 0 and ran_prefill == 0:
            return 0

        if decode_live:
            with trace.span("engine.rotation"):
                outs = self.rt.decode_step_3bo(
                    [(self._tokens(mb.tokens), mb.caches, mb.pos)
                     for mb in self.mbs], n_bo=self.n_bo)
            self._read_back(outs)

        started = []
        if finished:
            with trace.span("engine.finish_prefill"):
                started = [self._finish_prefill(mb_i, slot, logits)
                           for mb_i, slot, logits in finished]

        dt = self._tick_duration()
        self.now += dt
        if self.scheduler is not None:
            self.scheduler.observe(dt)
        for req in started:
            if req.t_first < 0:
                req.t_first = self.now
        for req in self.completed[n_done:]:
            req.t_done = self.now

        self.stats.engine_ticks += 1
        self._w_ticks += 1
        if self._w_ticks >= self.window_ticks:
            self._close_window()
        return decode_live + ran_prefill

    def _read_back(self, outs) -> None:
        """The rotation's results into the micro-batches, its next tokens
        to their requests, and the slots of requests that ended freed."""
        with trace.span("engine.readback"):
            for mb, (logits, caches, pos) in zip(self.mbs, outs):
                mb.caches, mb.pos = caches, pos
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
                pos_now = pos.cpu().numpy()
                trace.count("sync.readback", 2)
                for i in mb.live():
                    req = mb.slots[i]
                    tok = (int(nxt[i]) if self.greedy
                           else self._select(logits[i]))
                    req.output.append(tok)
                    mb.tokens[i] = tok
                    self.stats.tokens_out += 1
                    self._w_tokens_out += 1
                    if req.done or int(pos_now[i]) >= self.max_len - 1:
                        self._complete(mb, i)
            self.stats.decode_ticks += 1
            self._w_decode_ticks += 1

    # ---- the serve loop ----------------------------------------------------

    def run(self, trace: Sequence[ArrivalEvent],
            max_ticks: int = 100_000) -> List[WindowRecord]:
        """Serve an open-loop trace to completion (or ``max_ticks``)."""
        self.trace = collections.deque(sorted(trace, key=lambda e: e.t))
        while self.stats.engine_ticks < max_ticks:
            if (not self.trace and not self.queue
                    and self.live_count() == 0):
                break
            if self.live_count() == 0 and not self.queue and self.trace:
                # idle: fast-forward the clock to the next arrival
                self.now = max(self.now, self.trace[0].t)
                self._drain_arrivals()
                continue
            self.tick()
        if self._w_ticks:
            self._close_window()
        return self.windows

    # ---- summaries ---------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        done = self.completed
        ttfts = sorted(r.ttft for r in done)
        ok = self._slo_ok(done)
        dur = max(self.now, 1e-12)
        out: Dict[str, object] = {
            "arrivals": self.stats.arrivals,
            "completed": self.stats.completed,
            "decode_ticks": self.stats.decode_ticks,
            "engine_ticks": self.stats.engine_ticks,
            "prefills": self.stats.prefills,
            "prefill_tokens": self.stats.prefill_tokens,
            "prefill_chunks": self.stats.prefill_chunks,
            "prefill_chunk": self.prefill_chunk,
            "ttft_mean": float(np.mean(ttfts)) if ttfts else None,
            "tokens_out": self.stats.tokens_out,
            "duration_s": self.now,
            "throughput_tps": self.stats.tokens_out / dur,
            "goodput_rps": len(ok) / dur,
            "goodput_tps": sum(len(r.output) for r in ok) / dur,
            "slo_ok_frac": (len(ok) / len(done)) if done else None,
            "ttft_p50": float(np.percentile(ttfts, 50)) if ttfts else None,
            "ttft_p95": float(np.percentile(ttfts, 95)) if ttfts else None,
            "tpot_mean": (float(np.mean([r.tpot for r in done]))
                          if done else None),
            "windows": len(self.windows),
            "requeued": self.stats.requeued,
            "kv_occupancy_bytes": self.kv_occupancy_bytes(),
            "kv_budget_bytes": self.kv_budget_bytes,
            "bytes_match_all": all(w.bytes_match for w in self.windows),
            "dispatch_bytes": self.rt.stats.dispatch_bytes,
            "combine_bytes": self.rt.stats.combine_bytes,
        }
        if self.probe is not None and self.windows:
            busy = [w for w in self.windows if w.tokens_routed]
            if busy:
                out["hfu_measured_mean"] = float(np.mean(
                    [w.hfu_measured for w in busy]))
                out["hfu_predicted"] = busy[0].hfu_predicted
                out["b_rank_utilization_mean"] = float(np.mean(
                    [w.b_rank_utilization for w in busy]))
        return out
