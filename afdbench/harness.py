"""One run of one cell: set-up, the open loop on the host clock, the
measured window, the check, and the result line.

Everything a cell needs is found by name under the checkout's root:
``BENCHMARK.json`` (the cells, metrics and bounds),
``afdbench/configs/<config>.json`` (the model's sizes and the engine's
shape), ``afdbench/traffic/<mix>.json`` (the arrivals),
``afdbench/checks/<cell>.json`` (the limit of the comparison that decides
``correct``) and ``afdbench/metrics/<metric>.py`` (one reader per
per-layer metric).

The loop is the harness's own: each arrival is submitted to the engine
when it falls due, and ``engine.tick()`` runs while there is work. Every
request is timed on ``time.perf_counter`` from when it was due; a token
is stamped when the tick that emitted it returns (the engine reads its
tokens back to the host, so the device has finished by then).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from afdbench import traffic as tr

from afdbench.work import PEAK_BYTES_PER_S, PEAK_FLOPS_BF16

JAX_NAMES = ("jax", "jaxlib", "flax", "repro")
PEAKS = f"{PEAK_FLOPS_BF16:.4g} FLOP/s bf16, {PEAK_BYTES_PER_S:.4g} B/s"
TRACE_SECONDS = 8.0        # the profiled end of a traced run's window
TRACE_LEAD = 1.5           # what the profiler takes to start, before it


class UnknownWorkload(KeyError):
    pass


# ---------------------------------------------------------------------------
# Discovery
# ---------------------------------------------------------------------------

def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise UnknownWorkload(
        f"unknown workload {name!r}; known: "
        f"{sorted(w['name'] for w in bench['workloads'])}")


def config_path(root: Path, bench: dict, name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return Path(root) / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_reader(root: Path, metric: str):
    """``afdbench/metrics/<metric>.py`` as a module (names hold dots)."""
    path = Path(root) / "afdbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "afdbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(JAX_NAMES))


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


# ---------------------------------------------------------------------------
# The cell
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    root: Path
    workload: dict
    config: dict
    mix: tr.Mix
    check: dict
    per_layer: List[dict]
    end_to_end: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def arch(self) -> dict:
        return self.config["port"]


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    w = find_workload(bench, name)
    cfg = load_json(config_path(root, bench, w["config"]))
    mix = tr.load_mix(root / "afdbench" / "traffic" / f"{w['traffic']}.json")
    check = load_json(root / "afdbench" / "checks" / f"{name}.json")
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    return Cell(root, w, cfg, mix, check, per_layer, e2e)


# ---------------------------------------------------------------------------
# The open loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Req:
    rid: int
    due: float                            # on the host clock
    t_rel: float                          # s after the loop's start
    prompt_len: int
    max_new: int
    submitted: float = math.nan
    admitted: float = math.nan
    stamps: List[float] = dataclasses.field(default_factory=list)
    served: Optional[object] = None       # the engine's request object


@dataclasses.dataclass
class LoopResult:
    reqs: Dict[int, Req]
    w0: float
    w1: float
    rel0: float                           # the window in s after the start
    rel1: float
    end: float
    ticks: int
    completed: list                       # the engine's finished requests
    queue_open: int = 0                   # waiting when the window opened
    queue_close: int = 0                  # and when it closed
    chunk_ticks: frozenset = frozenset()  # returns of ticks that ran a chunk


def run_loop(eng, events: List[tr.ArrivalEvent], warmup_s: float,
             seconds: float, drain_s: float,
             on_tick: Optional[Callable[[float, float], None]] = None,
             tick: Optional[Callable[[], int]] = None,
             on_open: Optional[Callable[[], None]] = None,
             on_close: Optional[Callable[[], None]] = None,
             open_after: float = 0.0) -> LoopResult:
    """Drive ``eng`` with ``events`` on the host clock. The window opens
    ``warmup_s`` after the loop starts and lasts ``seconds``; a request is
    due in it when its arrival time (s after the start, as generated) lies
    in [warmup_s, warmup_s + seconds). ``on_open`` runs ``open_after``
    seconds into the window, ``on_close`` when it closes. After it closes,
    arrivals go on until every request due in it has its first token, or
    ``drain_s`` has passed."""
    tick = tick or eng.tick
    pending = list(events)
    nxt = 0
    reqs: Dict[int, Req] = {}
    t0 = time.perf_counter()
    w0, w1 = t0 + warmup_s, t0 + warmup_s + seconds
    opened = closed = False
    n_done = 0
    ticks = 0
    q_open = q_close = 0
    chunk_ticks = set()
    while True:
        now = time.perf_counter()
        if not opened and now >= w0:
            opened = True
            q_open = len(eng.queue)
        if on_open and opened and now >= w0 + open_after:
            on_open()
            on_open = None
            now = time.perf_counter()
        if opened and not closed and now >= w1:
            closed = True
            q_close = len(eng.queue)
            if on_close:
                on_close()
        if closed:
            waiting = [r for r in reqs.values() if not r.stamps
                       and warmup_s <= r.t_rel < warmup_s + seconds]
            if not waiting or now >= w1 + drain_s:
                break
        while nxt < len(pending) and t0 + pending[nxt].t <= now:
            ev = pending[nxt]
            nxt += 1
            eng.submit(ev)
            reqs[ev.rid] = Req(ev.rid, t0 + ev.t, ev.t, ev.prompt_len,
                               ev.max_new_tokens, submitted=now)
        if not eng.queue and eng.live_count() == 0:
            wake = t0 + pending[nxt].t if nxt < len(pending) else now + 0.05
            wake = min(wake, w0 if not opened else w1 if not closed
                       else now + 0.05)
            time.sleep(max(0.0, min(wake - time.perf_counter(), 0.05)))
            continue
        chunks = eng.stats.prefill_chunks
        t_tick = time.perf_counter()
        tick()
        t_ret = time.perf_counter()
        ticks += 1
        if eng.stats.prefill_chunks != chunks:
            chunk_ticks.add(t_ret)
        if on_tick:
            on_tick(t_tick, t_ret)
        now_live = {r.rid: r for r in eng.live_requests()}
        done = eng.completed[n_done:]
        n_done = len(eng.completed)
        for sr in list(now_live.values()) + list(done):
            r = reqs[sr.rid]
            r.served = sr
            if math.isnan(r.admitted):
                r.admitted = t_tick
            while len(r.stamps) < len(sr.output):
                r.stamps.append(t_ret)
    return LoopResult(reqs, w0, w1, warmup_s, warmup_s + seconds,
                      time.perf_counter(), ticks,
                      list(eng.completed), q_open, q_close,
                      frozenset(chunk_ticks))


def window_served(res: LoopResult) -> list:
    """The engine's finished requests that emitted a token in the window:
    what the check draws its sample from."""
    return [r for r in res.completed
            if any(res.w0 <= t < res.w1 for t in res.reqs[r.rid].stamps)]


def pctl(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile (numpy's linear interpolation)."""
    return float(np.percentile(values, q)) if values else None


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def window_metrics(res: LoopResult, seconds: float) -> dict:
    """The end-to-end numbers of the window [w0, w1)."""
    due = [r for r in res.reqs.values() if res.rel0 <= r.t_rel < res.rel1]
    ttft = [(r.stamps[0] if r.stamps else res.end) - r.due for r in due]
    gaps, tokens = [], 0
    by_kind = {True: [], False: []}       # does the gap end at a chunk tick
    for r in res.reqs.values():
        for i, t in enumerate(r.stamps):
            if res.w0 <= t < res.w1:
                tokens += 1
                if i:
                    gaps.append(t - r.stamps[i - 1])
                    by_kind[t in res.chunk_ticks].append(gaps[-1])
    waits = [r.admitted - r.due for r in due if not math.isnan(r.admitted)]
    half = (res.rel0 + res.rel1) / 2
    first = [t for r, t in zip(due, ttft) if r.t_rel < half]
    second = [t for r, t in zip(due, ttft) if r.t_rel >= half]
    late = [r.submitted - r.due for r in res.reqs.values()]
    return {"attempted": len(due),
            "failed": sum(1 for r in due if not r.stamps),
            "ttft_p95_s": pctl(ttft, 95), "ttft_p50_s": pctl(ttft, 50),
            "ttft_mean_s": mean(ttft),
            "itl_p95_s": pctl(gaps, 95), "itl_p50_s": pctl(gaps, 50),
            "itl_mean_s": mean(gaps), "itl_n": len(gaps),
            "itl_chunk_share": (len(by_kind[True]) / len(gaps)
                                if gaps else None),
            "itl_p50_chunk_s": pctl(by_kind[True], 50),
            "itl_p50_rotation_s": pctl(by_kind[False], 50),
            "tokens_per_s": tokens / seconds, "tokens": tokens,
            "queue_wait_p95_s": pctl(waits, 95),
            "late_p50_s": pctl(late, 50), "late_max_s": max(late or [0.0]),
            "queue_open": res.queue_open, "queue_close": res.queue_close,
            "ttft_p50_first_half_s": pctl(first, 50),
            "ttft_p50_second_half_s": pctl(second, 50)}


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------

def import_program(root: Path):
    """The program under test from the checkout's ``src``, and nowhere
    else."""
    src = str(Path(root) / "src")
    if not (Path(src) / "repro_torch" / "__init__.py").exists():
        raise FileNotFoundError(f"no repro_torch under {src}")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (raises where the program is absent)


def build_runtime(cell: Cell, params, device):
    from repro_torch.models.common import ArchConfig
    from repro_torch.parallel.afd import AFDRuntime
    cfg = ArchConfig(**cell.arch)
    return AFDRuntime(cfg, params, device=device)


def build_engine(cell: Cell, rt):
    from repro_torch.serving.afd_engine import AFDServeEngine
    e = cell.config["engine"]
    return AFDServeEngine(rt, max_len=cell.mix.max_len, n_bo=e["n_bo"],
                          mb_slots=e["mb_slots"],
                          prefill_chunk=e["prefill_chunk"], tick_seconds=None)


def warm_up(cell: Cell, rt) -> None:
    """The cell's own shapes through the serving path, on an engine that
    is then dropped: a full prefill chunk, a partial one at an offset, the
    splice and decode rotations of every micro-batch."""
    eng = build_engine(cell, rt)
    chunk = cell.config["engine"]["prefill_chunk"]
    plen = min(chunk + 1, cell.mix.max_len - 4)
    for i in range(2):
        eng.submit(tr.ArrivalEvent(rid=10**9 + i, t=0.0, prompt_len=plen,
                                   max_new_tokens=3))
    while eng.queue or eng.live_count():
        eng.tick()
    rt.synchronize()
    del eng
    gc.collect()


def free_device(device) -> None:
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The traced window
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceData:
    """What the per-layer readers read (``afdbench/metrics/*.py``). The
    spans' part of the window comes first and runs without the profiler:
    ``span_s``, ``walls``, ``prefill_chunks``, ``decode_contexts`` and
    ``queue_wait_p95_s`` are of it. The profiled part follows: ``window_s``,
    ``ticks``, ``calls`` and ``profile``."""
    arch: dict
    span_s: float
    walls: Dict[str, List[float]]
    prefill_chunks: List[tuple]           # (tokens, start position)
    decode_contexts: List[int]            # keys seen by each decode token
    queue_wait_p95_s: Optional[float]
    window_s: float
    ticks: int
    calls: list                           # afdbench.work.Call
    profile: Optional[dict]               # tracing.reduce_profile


class Tracer:
    """A traced run's instruments. The spans open with the window and
    time the engine's tick and the runtime's calls with nothing else
    watching; for the window's last ``prof_s`` seconds the profiler and
    the work observer watch too, and the span walls taken then are left
    out of the walls read (the profiler's per-launch cost is in them)."""

    def __init__(self, rt, device, seconds: float):
        from afdbench import tracing
        self.rt, self.device = rt, device
        self.spans = tracing.Spans(device)
        self.observer = tracing.Observer()
        self.prof_s = min(TRACE_SECONDS, seconds / 2)
        self.spans_s = max(0.0, seconds - self.prof_s
                           - min(TRACE_LEAD, seconds / 4))
        self.prof = None
        self.t_spans = self.t_split = math.nan
        self.t_open = self.t_close = math.nan
        self._orig = {}
        self.spanning = self.profiling = False

    def open_spans(self) -> None:
        rt = self.rt
        for name in ("decode_step_3bo", "prefill"):
            self._orig[name] = getattr(rt, name)
        rt.decode_step_3bo = self.spans.wrap(
            "runtime.decode_step_3bo", self._orig["decode_step_3bo"])
        rt.prefill = self.spans.wrap(
            "runtime.prefill", self._orig["prefill"],
            note=lambda tokens, caches, pos, *a, **k: (
                int(tokens.shape[1]), int(pos.reshape(-1)[0])))
        self.spanning = True
        self.t_spans = time.perf_counter()

    def open_profile(self) -> None:
        import torch
        from repro_torch.kernels import ops
        self.t_split = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        ops.set_work_observer(self.observer)
        self.profiling = True
        self.t_open = time.perf_counter()

    def on_tick(self, t_tick: float, t_ret: float) -> None:
        if self.spanning and math.isnan(self.t_split) \
                and t_ret >= self.t_spans + self.spans_s:
            self.open_profile()
        elif self.profiling and t_ret >= self.t_open + self.prof_s:
            self.close()

    def close(self) -> None:
        from repro_torch.kernels import ops
        if self.profiling:
            self.t_close = time.perf_counter()
            ops.set_work_observer(None)
            self.spans._sync()
            self.prof.stop()
            self.profiling = False
        if self.spanning:
            if math.isnan(self.t_split):
                self.t_split = time.perf_counter()
            for name in self._orig:
                delattr(self.rt, name)
            self.spanning = False

    def tick(self, eng):
        def run():
            if self.spanning:
                with self.spans.span("engine.tick"):
                    return eng.tick()
            return eng.tick()
        return run

    def data(self, arch: dict, res: "LoopResult", on_card: bool
             ) -> TraceData:
        """The readers' view, once the loop has ended."""
        from afdbench import tracing

        def before(records):
            return [v for t, v in records if self.t_spans <= t < self.t_split]
        walls = {n: before(r) for n, r in self.spans.walls.items()}
        ticks = sum(1 for t, _ in self.spans.walls.get("engine.tick", [])
                    if self.t_open <= t < self.t_close)
        opened = not math.isnan(self.t_open)
        return TraceData(
            arch=arch, span_s=self.t_split - self.t_spans, walls=walls,
            prefill_chunks=before(self.spans.args.get("runtime.prefill", [])),
            decode_contexts=decode_contexts(res, self.t_spans, self.t_split),
            queue_wait_p95_s=pctl(
                [r.admitted - r.due for r in res.reqs.values()
                 if res.rel0 <= r.t_rel < res.rel1
                 and r.admitted < self.t_split], 95),
            window_s=self.t_close - self.t_open if opened else 0.0,
            ticks=ticks, calls=self.observer.finish(),
            profile=(tracing.reduce_profile(self.prof)
                     if opened and on_card else None))


def decode_contexts(res: LoopResult, t_open: float, t_close: float
                    ) -> List[int]:
    """Keys seen by each decode token emitted in [t_open, t_close): token
    i ≥ 1 of a request was fed at position prompt + i − 1."""
    out = []
    for r in res.reqs.values():
        for i, t in enumerate(r.stamps):
            if i and t_open <= t < t_close:
                out.append(r.prompt_len + i)
    return out


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunOutcome:
    record: dict                          # the result line
    notes: List[str]                      # earlier lines for stderr
    checks: List[tuple]                   # (name, value, limit)
    served: list                          # finished, with a token in the window
    prompt_lens: Dict[int, int]
    window: dict                          # window_metrics
    trace: Optional[TraceData] = None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda:0",
             rate: Optional[float] = None, params=None,
             t_start_age: Optional[float] = None,
             check: bool = True) -> RunOutcome:
    """One run. ``device="cpu"`` runs the plain versions (the CPU tests);
    ``rate`` overrides the mix's (the knee sweep); ``params`` reuses
    weights already made from ``seed`` (the readings script)."""
    import torch
    from afdbench import check as chk
    from afdbench import weights
    root = Path(root)
    cell = load_cell(root, workload)
    import_program(root)
    from repro_torch.kernels import ops
    dev = torch.device(device)
    notes: List[str] = []
    mix = cell.mix if rate is None else cell.mix.with_rate(rate)
    dtype = getattr(torch, cell.arch.get("param_dtype", "float32"))
    t_build = 0.0
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        t_build, _ = _build.build_all()
    t0 = time.perf_counter()
    if params is None:
        params = weights.make_params(cell.arch, seed, dtype, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t_weights = time.perf_counter() - t0
    rt = build_runtime(cell, params, dev)
    t0 = time.perf_counter()
    warm_up(cell, rt)
    t_warm = time.perf_counter() - t0
    from repro_torch.parallel.afd import AFDStats
    rt.stats = AFDStats()
    eng = build_engine(cell, rt)
    horizon = mix.warmup_s + seconds + mix.drain_s + 5.0
    events = tr.make_trace(mix, seed, horizon)
    tracer = Tracer(rt, dev, seconds) if trace else None
    setup_s = process_age_s() if t_start_age is None else t_start_age
    notes.append(f"setup: {setup_s:.3f} s (kernel build {t_build:.3f} s, "
                 f"weights {t_weights:.3f} s, "
                 f"{weights.param_bytes(params) / 1e9:.3f} GB, warm-up "
                 f"{t_warm:.3f} s); {len(events)} arrivals over {horizon:.0f}"
                 f" s at {mix.rate:.4g}/s")
    ops.reset_launch_counts()

    if tracer is not None:
        res = run_loop(eng, events, mix.warmup_s, seconds, mix.drain_s,
                       on_tick=tracer.on_tick, tick=tracer.tick(eng),
                       on_open=tracer.open_spans, on_close=tracer.close)
        tracer.close()
    else:
        res = run_loop(eng, events, mix.warmup_s, seconds, mix.drain_s)
    rt.synchronize()
    m = window_metrics(res, seconds)
    launches = ops.launch_counts()
    wins = eng.windows
    notes.append(
        f"window: {m['attempted']} requests due, {m['failed']} without a "
        f"first token; {m['tokens']} tokens; TTFT p50 {m['ttft_p50_s']} s, "
        f"p95 {m['ttft_p95_s']} s, mean {m['ttft_mean_s']} s; ITL p95 "
        f"{m['itl_p95_s']} s; ITL p50 {m['itl_p50_s']} s, mean "
        f"{m['itl_mean_s']} s over {m['itl_n']} gaps, a share "
        f"{m['itl_chunk_share']} of them ending at a tick that ran a "
        f"prefill chunk (p50 {m['itl_p50_chunk_s']} s; the others' p50 "
        f"{m['itl_p50_rotation_s']} s); queue wait "
        f"p95 {m['queue_wait_p95_s']} s; generator late p50 "
        f"{m['late_p50_s']:.6f} s, max {m['late_max_s']:.6f} s; "
        f"{res.ticks} ticks in the run; queue {m['queue_open']} -> "
        f"{m['queue_close']} over the window; TTFT p50 by halves "
        f"{m['ttft_p50_first_half_s']} / {m['ttft_p50_second_half_s']} s")
    notes.append(f"engine: {eng.stats}; M2N bytes as Eq. 9/17 in "
                 f"{sum(w.bytes_match for w in wins)}/{len(wins)} windows; "
                 f"kernel launches {launches}")
    device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": 1,
                  "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(
                      dev)) if dev.type == "cuda" else 0)}
    served = window_served(res)
    lens = {r.rid: res.reqs[r.rid].prompt_len for r in served}

    trace_data = None
    if tracer is not None:
        trace_data = tracer.data(cell.arch, res, dev.type == "cuda")
        notes.append(f"trace: spans {trace_data.span_s:.3f} s unprofiled, "
                     f"{len(trace_data.walls.get('engine.tick', []))} ticks")
        prof = trace_data.profile
        if prof is not None:
            device_rec["busy_s"] = prof["busy_s"]
            device_rec["window_s"] = trace_data.window_s
            notes.append(f"trace: {trace_data.window_s:.3f} s profiled, "
                         f"{trace_data.ticks} ticks, {prof['device_ops']} "
                         f"device ops, busy {prof['busy_s']:.6f} s; kernels "
                         f"linked to their ranges {prof['op_linked']}")

    # the program's state goes before the reference runs
    del eng, rt, tracer
    free_device(dev)

    checks: List[tuple] = []
    correct = True
    if check:
        sample = chk.sample(served, lens, seed, mix.sample_tokens)
        vocab = cell.arch["vocab_size"]
        reading = chk.program_gap(cell.arch, params, sample, vocab, dev)
        correct, checks = chk.judge(reading, cell.check)
        notes.append(f"check: {len(sample)} requests, {reading['tokens']} "
                     f"served tokens; gap mean {reading['mean_gap']:.6g}, "
                     f"widest {reading['max_gap']:.6g}, p99 "
                     f"{reading['p99_gap']:.6g}, share not the reference's "
                     f"best {reading['mismatch']:.6g}; reference "
                     f"{reading['seconds']:.3f} s")

    metrics: Dict[str, dict] = {}
    if trace_data is None:
        values = {"setup_s": setup_s, "itl_p95_s": m["itl_p95_s"],
                  "tokens_per_s": m["tokens_per_s"]}
        for spec in cell.end_to_end:
            v = values.get(spec["name"])
            if v is not None:
                metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    else:
        for spec in cell.per_layer:
            v = load_reader(root, spec["name"]).read(trace_data)
            if v is not None:
                metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    record = {"correct": bool(correct), "attempted": m["attempted"],
              "failed": m["failed"], "metrics": metrics,
              "device": device_rec}
    if trace_data is not None and trace_data.profile is not None:
        p = trace_data.profile
        record["breakdown"] = {
            "device_ops": [[n, s] for n, s in p["ops_by_name"][:10]],
            "idle_gaps": [[n, s] for n, s in p["idle_gaps"][:10]]}
    record["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return RunOutcome(record, notes, checks, served, lens, m, trace_data)
