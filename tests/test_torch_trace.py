"""The port's tracer (``repro_torch.trace``) on the CPU: the unset path
costs nothing, spans nest and close, counters land where they are made,
and on tiny MoE and hybrid models the serve engine traced gives what it
gives untraced, with one ``engine.tick`` span per tick, the runtime's
per-role spans per rotation, and one ``sync.*`` count per host wait the
run reaches. The wall clock counts a tick from its start through the
read-back."""

import gc
import time
import tracemalloc

import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.models.common import ArchConfig  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.parallel.afd import AFDRuntime  # noqa: E402
from repro_torch.serving.afd_engine import AFDServeEngine  # noqa: E402
from repro_torch.serving.workload import ArrivalEvent  # noqa: E402

# a MoE transformer and a Mamba hybrid (1 attention, 7 Mamba mixers; 4 MoE,
# 4 dense FFNs), float32
CONFIGS = {
    "moe": dict(name="tiny-moe", family="moe", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_head=16, d_ff=0, vocab_size=256,
                n_experts=8, top_k=4, moe_d_ff=32, tie_embeddings=True,
                dtype="float32", param_dtype="float32"),
    "hybrid": dict(name="tiny-hybrid", family="hybrid", n_layers=8,
                   d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                   vocab_size=256, n_experts=4, top_k=2, moe_d_ff=128,
                   moe_layer_offset=1, moe_layer_period=2,
                   attn_layer_offset=4, attn_layer_period=8, ssm_state=8,
                   ssm_head_dim=16, use_rope=False, dtype="float32",
                   param_dtype="float32"),
}
N_BO, SLOTS, CHUNK, MAX_LEN = 2, 2, 8, 26
PROMPTS = [(5, 3), (12, 4), (9, 2), (19, 5), (4, 4), (17, 3)]


@pytest.fixture(autouse=True)
def _no_tracer_left():
    yield
    assert trace._TRACER is None
    assert trace._on_gc not in gc.callbacks


@pytest.fixture(scope="module")
def runtimes():
    out = {}
    for name, kw in CONFIGS.items():
        cfg = ArchConfig(**kw)
        out[name] = (cfg, init_params(cfg, seed=0, device="cpu"))
    return out


def _engine(runtimes, arch, **kw):
    cfg, params = runtimes[arch]
    kw = {"tick_seconds": 0.01, "prefill_chunk": CHUNK, **kw}
    return AFDServeEngine(AFDRuntime(cfg, params, device="cpu"),
                          max_len=MAX_LEN, n_bo=N_BO, mb_slots=SLOTS, **kw)


def _submit(eng):
    for rid, (plen, new) in enumerate(PROMPTS):
        eng.submit(ArrivalEvent(rid=rid, t=0.0, prompt_len=plen,
                                max_new_tokens=new))


def _serve(eng, on_tick=None):
    """Every request to its end, one tick at a time."""
    _submit(eng)
    while eng.queue or eng.live_count():
        before = (eng.stats.prefill_chunks, eng.stats.decode_ticks,
                  eng.stats.prefills, eng.now, eng.stats.completed)
        t0 = time.perf_counter()
        eng.tick()
        if on_tick is not None:
            on_tick(before, time.perf_counter() - t0)
    return eng


def _children(tracer):
    kids = [[] for _ in tracer.spans]
    for i, s in enumerate(tracer.spans):
        if s.parent >= 0:
            kids[s.parent].append(i)
    return kids


def _subtree(tracer, index, kids=None):
    """``index`` and every span opened inside it."""
    kids = _children(tracer) if kids is None else kids
    out, todo = [], [index]
    while todo:
        out.append(todo.pop())
        todo.extend(kids[out[-1]])
    return out


def _named(tracer, indices, name):
    return [i for i in indices if tracer.spans[i].name == name]


def _counts(tracer, indices):
    out = {}
    for i in indices:
        for k, v in (tracer.spans[i].counters or {}).items():
            out[k] = out.get(k, 0) + v
    return out


# ---- the tracer alone ---------------------------------------------------------

def test_off_is_one_shared_context_and_records_nothing():
    assert trace.span("a") is trace.span("b") is trace._OFF
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("a"):
            trace.count("sync.x")
    assert not [e for e in prof.events()
                if e.name.startswith(trace.PREFIX)]


def _bytes_made_by_trace(n):
    """Bytes that ``repro_torch.trace`` holds, made while ``n`` spans are
    open with a count in each (the spans stay open while it is read)."""
    opened = []
    tracemalloc.start()
    try:
        for _ in range(n):
            opened.append(trace.span("afd.a.mixer"))
            opened[-1].__enter__()
            trace.count("sync.readback", 2)
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, trace.__file__)])
    finally:
        tracemalloc.stop()
        for s in reversed(opened):
            s.__exit__(None, None, None)
    return sum(stat.size for stat in snap.statistics("filename"))


def test_off_allocates_nothing():
    assert _bytes_made_by_trace(1000) == 0
    with trace.enabled(trace.Tracer()):     # what the measure would see
        assert _bytes_made_by_trace(1000) > 1000 * 50


def test_spans_nest_with_their_parents_and_are_profiler_ranges():
    tr = trace.Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.enabled(tr):
            with trace.span("outer"):
                with trace.span("inner"):
                    pass
                with trace.span("second"):
                    with trace.span("deep"):
                        pass
            with trace.span("top"):
                pass
    assert [(s.name, s.parent) for s in tr.spans] == [
        ("outer", -1), ("inner", 0), ("second", 0), ("deep", 2), ("top", -1)]
    assert all(s.end >= s.start for s in tr.spans)
    assert tr.spans[0].start <= tr.spans[1].start <= tr.spans[1].end \
        <= tr.spans[2].start <= tr.spans[3].end <= tr.spans[0].end
    assert _children(tr) == [[1, 2], [], [3], [], []]
    assert sorted(_subtree(tr, 0)) == [0, 1, 2, 3]
    names = {e.name for e in prof.events()}
    assert {trace.PREFIX + n for n in ("outer", "inner", "second", "deep",
                                       "top")} <= names


def test_counts_land_on_the_innermost_open_span():
    tr = trace.Tracer()
    with trace.enabled(tr):
        trace.count("sync.a")
        with trace.span("outer"):
            trace.count("sync.a", 2)
            with trace.span("inner"):
                trace.count("sync.a")
                trace.count("sync.b", 3)
            trace.count("sync.b")
    assert tr.counters == {"sync.a": 1}
    assert tr.spans[0].counters == {"sync.a": 2, "sync.b": 1}
    assert tr.spans[1].counters == {"sync.a": 1, "sync.b": 3}
    assert _counts(tr, _subtree(tr, 0)) == {"sync.a": 3, "sync.b": 4}


def test_a_raising_body_still_closes_its_span():
    tr = trace.Tracer()
    with trace.enabled(tr):
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError("x")
        with trace.span("after"):
            pass
    assert [(s.name, s.parent) for s in tr.spans] == [
        ("outer", -1), ("inner", 0), ("after", -1)]
    assert all(s.end >= s.start for s in tr.spans)
    assert tr._open == []


def test_enabled_restores_the_previous_tracer_and_removes_the_gc_hook():
    first, second = trace.Tracer(), trace.Tracer()
    with trace.enabled(first):
        assert trace._TRACER is first and trace._on_gc in gc.callbacks
        with pytest.raises(RuntimeError):
            with trace.enabled(second):
                assert trace._TRACER is second
                raise RuntimeError
        assert trace._TRACER is first and trace._on_gc in gc.callbacks
        with trace.enabled(None):
            assert trace.span("x") is trace._OFF
        assert trace._TRACER is first
    assert trace._TRACER is None and trace._on_gc not in gc.callbacks
    assert gc.isenabled()


def test_a_collection_is_a_gc_span_with_its_generation():
    tr = trace.Tracer()
    with trace.enabled(tr):
        with trace.span("outer"):
            gc.collect(1)
        gc.collect()
    spans = [(s.name, s.parent, s.counters) for s in tr.spans]
    assert ("gc.collect", 0, {"gc.generation": 1}) in spans
    assert ("gc.collect", -1, {"gc.generation": 2}) in spans
    assert all(s.end >= s.start for s in tr.spans)
    n = len(tr.spans)
    gc.collect()                            # unset: nothing recorded
    assert len(tr.spans) == n


# ---- the serve path traced ----------------------------------------------------

@pytest.mark.parametrize("arch", ["moe", "hybrid"])
def test_tracing_changes_no_output(runtimes, arch):
    plain = _serve(_engine(runtimes, arch))
    tr = trace.Tracer()
    with trace.enabled(tr):
        traced = _serve(_engine(runtimes, arch))
    assert {r.rid: r.output for r in traced.completed} == {
        r.rid: r.output for r in plain.completed}
    assert len(traced.completed) == len(PROMPTS)
    assert traced.stats == plain.stats
    assert traced.rt.stats == plain.rt.stats
    assert traced.now == plain.now
    assert tr.spans and tr.counters == {}


@pytest.mark.parametrize("arch", ["moe", "hybrid"])
def test_each_tick_is_one_span_with_its_phases_and_each_rotation_its_roles(
        runtimes, arch):
    tr = trace.Tracer()
    with trace.enabled(tr):
        eng = _serve(_engine(runtimes, arch))
    kids = _children(tr)
    ticks = [i for i, s in enumerate(tr.spans) if s.name == "engine.tick"]
    assert len(ticks) == eng.stats.engine_ticks
    assert all(tr.spans[i].parent == -1 for i in ticks)
    phases = {"engine.admit", "engine.prefill", "engine.rotation",
              "engine.readback", "engine.finish_prefill", "gc.collect"}
    for i in ticks:
        names = [tr.spans[k].name for k in kids[i]
                 if tr.spans[k].name != "gc.collect"]
        assert set(names) <= phases and names[0] == "engine.admit"
    specs = eng.rt.specs
    n_moe = sum(1 for s in specs if s.moe)
    n_dense = sum(1 for s in specs if not s.moe)
    rotations = [i for i, s in enumerate(tr.spans)
                 if s.name == "engine.rotation"]
    assert len(rotations) == eng.stats.decode_ticks > 0
    for r in rotations:
        sub = _subtree(tr, r, kids)
        assert len(_named(tr, sub, "afd.a.mixer")) == N_BO * len(specs)
        assert len(_named(tr, sub, "afd.f.experts")) == N_BO * n_moe
        for name in ("afd.a.route", "afd.dispatch", "afd.combine"):
            assert len(_named(tr, sub, name)) == N_BO * n_moe
        assert len(_named(tr, sub, "afd.a.dense")) == N_BO * n_dense
        assert len(_named(tr, sub, "afd.a.head")) == N_BO
        assert not _named(tr, sub, "afd.a.mamba_chunk")
    n_mamba = sum(1 for s in specs if s.kind == "mamba")
    prefills = [i for i, s in enumerate(tr.spans)
                if s.name == "engine.prefill"]
    chunks = sum((-(-p // CHUNK)) for p, _ in PROMPTS)
    assert sum(len(_named(tr, _subtree(tr, i, kids), "afd.a.mamba_chunk"))
               for i in prefills) == chunks * n_mamba
    steps = _counts(tr, [i for i, s in enumerate(tr.spans)
                         if s.name == "afd.a.mamba_chunk"])
    assert steps.get("mamba.steps", 0) == n_mamba * sum(p for p, _ in PROMPTS)


@pytest.mark.parametrize("wall", [False, True], ids=["virtual", "wall"])
@pytest.mark.parametrize("arch", ["moe", "hybrid"])
def test_sync_counts_equal_the_sites_reached(runtimes, arch, wall):
    """Per tick: one upload per chunk and per micro-batch fed, two
    read-backs per micro-batch, one ``_select`` per finished prefill, one
    position written from the host per finished prefill and per request
    ended, three mask indexes per K/V plane of each attention layer and
    chunk, the wall clock's sync; ``pos.tolist()`` only on the card."""
    tr = trace.Tracer()
    seen = []
    kw = {"tick_seconds": None} if wall else {}
    with trace.enabled(tr):
        eng = _serve(_engine(runtimes, arch, **kw),
                     on_tick=lambda before, _: seen.append(before))
    n_attn = sum(1 for s in eng.rt.specs if s.kind == "attn")
    kids = _children(tr)
    ticks = [i for i, s in enumerate(tr.spans) if s.name == "engine.tick"]
    after = seen[1:] + [(eng.stats.prefill_chunks, eng.stats.decode_ticks,
                         eng.stats.prefills, eng.now, eng.stats.completed)]
    assert len(ticks) == len(seen)
    for i, b, a in zip(ticks, seen, after):
        chunks, rot, done, ended = (a[0] - b[0], a[1] - b[1], a[2] - b[2],
                                    a[4] - b[4])
        want = {"sync.h2d_tokens": chunks + N_BO * rot,
                "sync.readback": 2 * N_BO * rot, "sync.select": done,
                "sync.pos_write": done + ended,
                "sync.kv_chunk_mask": 6 * n_attn * chunks,
                "sync.clock": int(wall and (chunks or rot))}
        got = {k: v for k, v in _counts(tr, _subtree(tr, i, kids)).items()
               if k.startswith("sync.")}
        assert got == {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["legacy", "chunked"])
def test_wall_clock_counts_the_tick_from_its_start_through_the_read_back(
        runtimes, chunk):
    tr = trace.Tracer()
    steps = []
    with trace.enabled(tr):
        eng = _serve(_engine(runtimes, "moe", tick_seconds=None,
                             prefill_chunk=chunk),
                     on_tick=lambda before, wall: steps.append(
                         (before[3], wall)))
    kids = _children(tr)
    ticks = [i for i, s in enumerate(tr.spans) if s.name == "engine.tick"]
    nows = [now for now, _ in steps[1:]] + [eng.now]
    for i, (now0, wall), now1 in zip(ticks, steps, nows):
        clock = _named(tr, kids[i], "engine.clock")
        if not clock:
            continue                    # a tick with nothing to run
        tick, c = tr.spans[i], tr.spans[clock[0]]
        # from before the span opened to after the clock's sync, and never
        # more than the call took
        assert now1 - now0 >= c.start - tick.start
        assert now1 - now0 <= wall
        for k in kids[i]:
            if tr.spans[k].name in ("engine.admit", "engine.prefill",
                                    "engine.rotation", "engine.readback",
                                    "engine.finish_prefill"):
                assert tr.spans[k].end <= c.start


def test_f_role_ranges_nest_in_a_range_around_the_rotation(runtimes):
    """On the profiler's clock the runtime's spans lie inside a caller's
    own range around ``decode_step_3bo``."""
    eng = _engine(runtimes, "moe")
    rt = eng.rt
    inner = rt.decode_step_3bo

    def wrapped(*a, **k):
        with torch.profiler.record_function("caller.decode_step_3bo"):
            return inner(*a, **k)
    rt.decode_step_3bo = wrapped
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.enabled(trace.Tracer()):
            _serve(eng)
    events = prof.events()
    outer = [e.time_range for e in events
             if e.name == "caller.decode_step_3bo"]
    experts = [e.time_range for e in events
               if e.name == trace.PREFIX + "afd.f.experts"]
    inside = [r for r in experts
              if any(o.start <= r.start and r.end <= o.end for o in outer)]
    n_moe = sum(1 for s in rt.specs if s.moe)
    assert len(outer) == eng.stats.decode_ticks > 0
    assert len(inside) == len(outer) * N_BO * n_moe
    ticks = [e for e in events if e.name == trace.PREFIX + "engine.tick"]
    assert len(ticks) == eng.stats.engine_ticks
