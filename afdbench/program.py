"""The program's own spans and host-sync counters (``repro_torch.trace``)
in a traced run, and what the program's per-layer readers make of them.

The harness's traced part times the program from outside
(``tracing.Spans``). ``ProgramTracer`` sets the program's tracer over the
same part as well, so the program's spans (``engine.*``, ``afd.*``), its
``sync.*`` counters and Python's collections (``gc.collect``) run beside
them, and adds to what the readers read:

* ``TraceData.program``: a ``Program`` of the spans that opened in the
  part before the profiler, where the harness reads its walls;
* ``TraceData.program_ranges``: the benchmark's and the program's ranges
  on the profiler's clock, (name, start, end) in µs, of the profiled part;
* ``TraceData.program_gaps``: on the card, the profiled part's longest
  idle gaps labelled by those ranges (``label_gaps``).

The harness itself does not set the program's tracer: ``wired()`` puts
``ProgramTracer`` in its place for the runs inside it, and

    python3 afdbench/program_trace.py --workload <cell> --seed <n> --seconds <s>

runs one traced run so and prints the readings. Each reader of
``afdbench/metrics/`` that reads the program reads ``None`` without them.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

from afdbench import harness, tracing

PREFIX = "repro_torch."
# the engine's phases that are not its own work: the prompt chunks and
# the 3BO rotation
DELEGATED = ("engine.prefill", "engine.rotation")


class Program:
    """The program's spans that opened in [t0, t1) on ``time.perf_counter``,
    with every span they opened inside them."""

    def __init__(self, spans: list, t0: float, t1: float):
        self.spans = spans
        self.t0, self.t1 = t0, t1
        self.kids: List[List[int]] = [[] for _ in spans]
        for i, s in enumerate(spans):
            if s.parent >= 0:
                self.kids[s.parent].append(i)

    def named(self, name: str) -> List[int]:
        """Indices of the spans called ``name`` that opened in the part."""
        return [i for i, s in enumerate(self.spans) if s.name == name
                and self.t0 <= s.start < self.t1]

    def subtree(self, i: int) -> List[int]:
        out, todo = [], [i]
        while todo:
            out.append(todo.pop())
            todo.extend(self.kids[out[-1]])
        return out

    def seconds(self, i: int) -> float:
        s = self.spans[i]
        return s.end - s.start

    def counts(self, indices) -> Dict[str, int]:
        out: Dict[str, int] = collections.Counter()
        for i in indices:
            for k, v in (self.spans[i].counters or {}).items():
                out[k] += v
        return out


def _mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def _syncs(counts: Dict[str, int]) -> int:
    return sum(v for k, v in counts.items() if k.startswith("sync."))


# ---------------------------------------------------------------------------
# The readings
# ---------------------------------------------------------------------------

def tick_self_ms(p: Optional[Program]) -> Optional[float]:
    """Mean host ms of an ``engine.tick`` outside its ``engine.prefill``
    and ``engine.rotation``: admission, read-back, the splice, the clock."""
    if p is None:
        return None
    return _mean([1e3 * (p.seconds(i) - sum(
        p.seconds(k) for k in p.kids[i] if p.spans[k].name in DELEGATED))
        for i in p.named("engine.tick")])


def syncs_per_tick(p: Optional[Program]) -> Optional[float]:
    """Mean over ticks of the ``sync.*`` counts in the tick's subtree."""
    if p is None:
        return None
    return _mean([float(_syncs(p.counts(p.subtree(i))))
                  for i in p.named("engine.tick")])


def role_ms(p: Optional[Program], role: str) -> Optional[float]:
    """Mean over ``engine.rotation`` spans of the host ms of the role's
    spans under it: ``a`` the ``afd.a.*`` ones (mixers, router, dense
    FFNs, head), ``f`` the ``afd.f.*`` ones (the experts)."""
    if p is None:
        return None
    prefix = f"afd.{role}."
    return _mean([1e3 * sum(p.seconds(k) for k in p.subtree(i)
                            if p.spans[k].name.startswith(prefix))
                  for i in p.named("engine.rotation")])


def mamba_chunk_ms(p: Optional[Program]) -> Optional[float]:
    """Mean over the ``engine.prefill`` spans that stepped a Mamba chunk of
    the host ms in ``afd.a.mamba_chunk`` under each."""
    if p is None:
        return None
    per = []
    for i in p.named("engine.prefill"):
        chunks = [k for k in p.subtree(i)
                  if p.spans[k].name == "afd.a.mamba_chunk"]
        if chunks:
            per.append(1e3 * sum(p.seconds(k) for k in chunks))
    return _mean(per)


def gc_ms_per_tick(p: Optional[Program]) -> Optional[float]:
    """Host ms of Python's collections in the part over its ticks."""
    if p is None:
        return None
    ticks = p.named("engine.tick")
    if not ticks:
        return None
    return 1e3 * sum(p.seconds(i) for i in p.named("gc.collect")) / len(ticks)


def rotation_syncs(p: Program) -> int:
    """``sync.*`` counts inside the rotation call: under ``engine.rotation``
    but for the uploads of its micro-batches' tokens, made before it."""
    total = 0
    for i in p.named("engine.rotation"):
        own = (p.spans[i].counters or {}).get("sync.h2d_tokens", 0)
        total += _syncs(p.counts(p.subtree(i))) - own
    return total


def mamba_step_ms(p: Program) -> Optional[float]:
    """Host ms of one stepped token of one Mamba layer in a prefill chunk
    (``afd.a.mamba_chunk`` over its ``mamba.steps``)."""
    chunks = p.named("afd.a.mamba_chunk")
    steps = p.counts(chunks).get("mamba.steps", 0)
    return 1e3 * sum(p.seconds(i) for i in chunks) / steps if steps else None


def collections_by_generation(p: Program) -> Dict[int, Tuple[int, float]]:
    """{generation: (collections, longest ms)} of the part."""
    out: Dict[int, Tuple[int, float]] = {}
    for i in p.named("gc.collect"):
        g = (p.spans[i].counters or {}).get("gc.generation", -1)
        n, ms = out.get(g, (0, 0.0))
        out[g] = (n + 1, max(ms, 1e3 * p.seconds(i)))
    return dict(sorted(out.items()))


def report(data) -> dict:
    """Every reading of the program's spans in a traced run's ``data``."""
    p = getattr(data, "program", None)
    if p is None:
        return {}
    ticks = p.named("engine.tick")
    phases: Dict[str, float] = collections.defaultdict(float)
    for i in ticks:
        for k in p.kids[i]:
            phases[p.spans[k].name] += 1e3 * p.seconds(k)
    counts = p.counts([k for i in ticks for k in p.subtree(i)])
    return {
        "engine.tick_self_ms": tick_self_ms(p),
        "engine.syncs_per_tick": syncs_per_tick(p),
        "runtime.a_role_ms": role_ms(p, "a"),
        "runtime.f_role_ms": role_ms(p, "f"),
        "runtime.mamba_chunk_ms": mamba_chunk_ms(p),
        "host.gc_ms_per_tick": gc_ms_per_tick(p),
        "ticks": len(ticks),
        "rotations": len(p.named("engine.rotation")),
        "engine.tick_ms": _mean([1e3 * p.seconds(i) for i in ticks]),
        "phase_ms_per_tick": {k: v / len(ticks) for k, v in phases.items()},
        "counts_per_tick": {k: v / len(ticks) for k, v in
                            sorted(counts.items())} if ticks else {},
        "rotation_call_syncs": rotation_syncs(p),
        "mamba_step_ms": mamba_step_ms(p),
        "gc_by_generation": collections_by_generation(p),
        "idle_gaps": getattr(data, "program_gaps", None),
    }


# ---------------------------------------------------------------------------
# The profiled part
# ---------------------------------------------------------------------------

def _is_range(name: str) -> bool:
    return name.startswith(PREFIX) or (
        name.startswith(tracing.SPAN_PREFIX)
        and not name.startswith(tracing.SPAN_PREFIX + "op."))


def ranges(events) -> List[Tuple[str, float, float]]:
    """The host's benchmark and program ranges, (name, start, end) in µs,
    in order of their start."""
    from torch.autograd import DeviceType
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in events if e.device_type != DeviceType.CUDA
                   and _is_range(e.name)), key=lambda r: r[1])


def label_gaps(events, top: int = 10) -> List[Tuple[str, float]]:
    """The ``top`` longest gaps between device ops, longest first, each
    (label, seconds): ``tracing.reduce_profile``'s gaps, labelled by the
    innermost benchmark or program range open where the gap ended, or
    ``repro_torch.gc.collect`` where Python's collections fill over half
    of it (a collection ends before the host enqueues again, so the range
    open at the end is not where the time went)."""
    from torch.autograd import DeviceType
    busy = tracing._merge([
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == DeviceType.CUDA
        and not e.name.startswith((PREFIX, tracing.SPAN_PREFIX))])
    gaps = sorted(((b2 - a1, a1, b2) for (_, a1), (b2, _) in
                   zip(busy, busy[1:])), reverse=True)[:top]
    rs = ranges(events)
    starts = [r[1] for r in rs]
    gc_name = PREFIX + "gc.collect"
    out = []
    for length, begin, end in gaps:
        label, best, in_gc = "harness", -math.inf, 0.0
        for name, a, b in rs[:bisect.bisect_right(starts, end)]:
            if b >= end and a >= best:
                label, best = name, a
            if name == gc_name:
                in_gc += max(0.0, min(b, end) - max(a, begin))
        if 2 * in_gc > length:
            label = gc_name
        out.append((label, length * 1e-6))
    return out


class _DeviceOpsOnly:
    """A profile without the device-side copies of the program's ranges,
    which ``tracing.reduce_profile`` would take for device ops."""

    def __init__(self, prof):
        self._prof = prof

    def events(self):
        from torch.autograd import DeviceType
        return [e for e in self._prof.events()
                if not (e.device_type == DeviceType.CUDA
                        and e.name.startswith(PREFIX))]


class ProgramTracer(harness.Tracer):
    """The harness's tracer, with the program's tracer set while its spans
    are open."""

    def __init__(self, rt, device, seconds: float):
        super().__init__(rt, device, seconds)
        from repro_torch import trace
        self.program = trace.Tracer()
        self._on = None

    def open_spans(self) -> None:
        from repro_torch import trace
        super().open_spans()
        self._on = trace.enabled(self.program)
        self._on.__enter__()

    def close(self) -> None:
        super().close()
        self.stop()

    def stop(self) -> None:
        """Unset the program's tracer, if this one set it."""
        if self._on is not None:
            self._on.__exit__(None, None, None)
            self._on = None

    def data(self, arch: dict, res, on_card: bool):
        prof = self.prof
        if prof is not None:
            self.prof = _DeviceOpsOnly(prof)
        try:
            data = super().data(arch, res, on_card)
        finally:
            self.prof = prof
        events = prof.events() if prof is not None else []
        data.program = Program(self.program.spans, self.t_spans, self.t_split)
        data.program_ranges = ranges(events)
        data.program_gaps = (label_gaps(events)
                             if on_card and prof is not None else None)
        return data


@contextlib.contextmanager
def wired() -> Iterator[None]:
    """``ProgramTracer`` as the harness's tracer while the block runs; the
    program's tracer is unset on the way out, whatever the block raised."""
    made: List[ProgramTracer] = []

    class Made(ProgramTracer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    previous, harness.Tracer = harness.Tracer, Made
    try:
        yield
    finally:
        harness.Tracer = previous
        for t in reversed(made):
            t.stop()
