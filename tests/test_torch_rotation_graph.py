"""The AFD rotation replayed from a CUDA graph (``parallel.rotation_graph``).

On the CPU: which runtimes may capture (one CUDA device for both roles, the
CUDA kernels), what a captured rotation is keyed on, the Mamba caches kept
in place, and the replay's bookkeeping: one eager rotation's side effects
(M2N records, the work observer's calls with their shapes and values),
recorded and done again without a graph, equal those of a second eager
rotation, and add no kernel launch; the runtime counts its replays. CPU,
``impl="plain"`` and role splits stay eager and count ``graph.eager``.

On the card (``gpu``): the serving engine replaying its rotation against
the same engine run eager, on a tiny MoE transformer and a tiny attention /
Mamba hybrid in bf16, tick by tick over admissions, prefill chunks and
their splice, completions and positions written from the host: logits,
tokens, positions and every cache bit for bit, the same M2N bytes (equal
to Eq. 9/17) and observed work, one capture and replays after it; the
launch counters see the eager and the captured rotation's launches and no
replay's, and the card runs each replay's kernels, counted by the
profiler.
"""

import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.common import ArchConfig  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.parallel import rotation_graph  # noqa: E402
from repro_torch.parallel.afd import AFDRuntime, AFDStats  # noqa: E402
from repro_torch.serving.afd_engine import AFDServeEngine  # noqa: E402
from repro_torch.serving.workload import ArrivalEvent  # noqa: E402

# a MoE transformer shaped as granite (GQA, top-k of fine experts, tied
# head) and a Mamba hybrid (1 attention, 7 Mamba mixers; 4 MoE, 4 dense
# FFNs); widths the CUDA kernels take
CONFIGS = {
    "moe": dict(name="tiny-moe", family="moe", n_layers=3, d_model=64,
                n_heads=4, n_kv_heads=2, d_head=16, d_ff=0, vocab_size=256,
                n_experts=8, top_k=4, moe_d_ff=32, tie_embeddings=True),
    "hybrid": dict(name="tiny-hybrid", family="hybrid", n_layers=8,
                   d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                   vocab_size=256, n_experts=4, top_k=2, moe_d_ff=128,
                   moe_layer_offset=1, moe_layer_period=2,
                   attn_layer_offset=4, attn_layer_period=8, ssm_state=8,
                   ssm_head_dim=16, use_rope=False),
}
F32 = dict(dtype="float32", param_dtype="float32")
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")


def _runtime(arch, device="cpu", impl=None, **kw):
    cfg = ArchConfig(**CONFIGS[arch], **(F32 if device == "cpu" else BF16))
    params = init_params(cfg, seed=0, device=device)
    return AFDRuntime(cfg, params, device=device, impl=impl, **kw)


def _micro_batches(rt, n_bo=2, slots=3, length=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    mbs = []
    for _ in range(n_bo):
        caches, pos = rt.init_cache(slots, length)
        pos.copy_(torch.randint(0, length - 1, (slots,), generator=gen))
        toks = torch.randint(1, rt.cfg.vocab_size, (slots,), generator=gen,
                             dtype=torch.int32)
        mbs.append((toks.to(rt.a_device), caches, pos))
    return mbs


class WorkLog:
    """A work observer that keeps each call: the work function, each
    tensor input's shape and dtype (with its values where the work reads
    them), the other inputs as given; and the ranges entered and left."""

    def __init__(self):
        self.calls, self.ranges = [], []

    def kernel(self, work, *inputs):
        keep = ops.VALUE_INPUTS.get(work, ())
        self.calls.append((work.__name__, tuple(
            (tuple(x.shape), x.dtype,
             x.cpu().tolist() if i in keep else None)
            if isinstance(x, torch.Tensor) else x
            for i, x in enumerate(inputs))))
        log = self.ranges

        class Range:
            def __enter__(self):
                log.append("enter")

            def __exit__(self, *exc):
                log.append("exit")
        return Range()


# ---- which runtimes capture, and on what ------------------------------------

D = torch.device


@pytest.mark.parametrize("a, f, impl, want", [
    (D("cuda:0"), [D("cuda:0")], None, True),
    (D("cuda:0"), [D("cuda:0")] * 4, "cuda", True),
    (D("cuda:0"), [D("cuda:0")], "plain", False),
    (D("cuda:0"), [D("cuda:1")], None, False),
    (D("cuda:0"), [D("cuda:0"), D("cuda:1")], None, False),
    (D("cuda:0"), [D("cpu")], None, False),
    (D("cpu"), [D("cpu")], None, False),
    (D("cpu"), [D("cpu")], "plain", False),
], ids=["one-card", "one-card-4-blocks", "plain", "split", "split-f",
        "f-on-cpu", "cpu", "cpu-plain"])
def test_capture_applies_on_one_cuda_device_with_the_kernels(a, f, impl,
                                                             want):
    assert rotation_graph.applies(a, f, impl) is want


def test_key_binds_cache_addresses_and_layouts_not_token_addresses():
    rt = _runtime("moe")
    mbs = _micro_batches(rt)
    key = rotation_graph.rotation_key(mbs, 2)
    fresh = [(t.clone(), c, p.clone()) for t, c, p in mbs]
    assert rotation_graph.rotation_key(fresh, 2) == key
    assert rotation_graph.rotation_key(mbs, 3) != key
    moved = [(t, [{k: v.clone() for k, v in c.items()} for c in caches], p)
             for t, caches, p in mbs]
    assert rotation_graph.rotation_key(moved, 2) != key
    wider = [(t.long(), c, p) for t, c, p in mbs]
    assert rotation_graph.rotation_key(wider, 2) != key
    assert rotation_graph.rotation_key(mbs[:1], 2) != key


@pytest.mark.parametrize("arch", ["moe", "hybrid"])
@pytest.mark.parametrize("impl", [None, "plain"])
def test_cpu_rotations_stay_eager(arch, impl):
    rt = _runtime(arch, impl=impl, f_devices=["cpu", "cpu"])
    mbs = _micro_batches(rt)
    tr = trace.Tracer()
    with trace.enabled(tr):
        for _ in range(3):
            outs = rt.decode_step_3bo(mbs, n_bo=2)
            mbs = [(t, c, p) for (t, _, _), (_, c, p) in zip(mbs, outs)]
    assert tr.counters == {"graph.eager": 3}
    assert rt._graph is None
    assert not [s for s in tr.spans if s.name.startswith("afd.rotation.")]


def test_mamba_caches_kept_in_place_hold_the_same_values():
    """Where a rotation can be captured, a Mamba layer's new conv tail and
    state are copied into the caches given, which are returned; the values
    are those the eager rotation returns as new tensors."""
    rt = _runtime("hybrid")
    mbs = _micro_batches(rt)
    given = [[{k: v.clone() for k, v in c.items()} for c in caches]
             for _, caches, _ in mbs]
    want = rt._rotation(mbs)
    rt._graphable = True
    kept = [(t, g, p) for (t, _, p), g in zip(mbs, given)]
    got = rt._rotation(kept)
    for (lg, caches, pos), (lg_w, caches_w, pos_w), g in zip(got, want,
                                                             given):
        assert torch.equal(lg, lg_w) and torch.equal(pos, pos_w)
        assert all(c is gc for c, gc in zip(caches, g))
        for c, cw in zip(caches, caches_w):
            assert c.keys() == cw.keys()
            assert all(torch.equal(c[k], cw[k]) for k in c)
    mamba = [i for i, s in enumerate(rt.specs) if s.kind == "mamba"]
    assert mamba and all(want[0][1][i] is not mbs[0][1][i] for i in mamba)


# ---- the replay's bookkeeping, without a graph ------------------------------

def _decode_attention(rt, outs):
    """Split-KV over each micro-batch's first attention cache at the
    lengths the rotation left (the CPU's decode masks instead of calling
    it)."""
    for _, caches, pos in outs:
        kv = next(c for c in caches if "k" in c)
        q = torch.ones(kv["k"].shape[0], rt.cfg.n_heads, kv["k"].shape[3],
                       dtype=kv["k"].dtype)
        ops.splitkv_attention(q, kv["k"], kv["v"], pos + 1)


@pytest.mark.parametrize("arch", ["moe", "hybrid"])
def test_recorded_side_effects_replay_as_an_eager_rotation(arch):
    rt = _runtime(arch)
    mbs = _micro_batches(rt, seed=1)

    def body():
        out = rt._rotation(mbs)
        _decode_attention(rt, out)
        return out

    stats0 = rt.stats.snapshot()
    outer = WorkLog()
    previous = ops.set_work_observer(outer)
    try:
        recorded, effects = rotation_graph.SideEffects.during(rt, body)
    finally:
        ops.set_work_observer(previous)
    # recording leaves nothing done
    assert rt.stats == stats0
    assert outer.calls == [] and effects.records and effects.calls

    replayed = WorkLog()
    effects.replay(rt.stats, replayed)
    after_replay = rt.stats.since(stats0)
    assert replayed.ranges == ["enter", "exit"] * len(replayed.calls)

    stats1 = rt.stats.snapshot()
    eager = WorkLog()
    previous = ops.set_work_observer(eager)
    try:
        again = body()
    finally:
        ops.set_work_observer(previous)
    assert after_replay == rt.stats.since(stats1)
    assert after_replay.dispatches == sum(
        s.moe for s in rt.specs) * len(mbs)
    assert replayed.calls == eager.calls
    assert {name for name, _ in eager.calls} == {"grouped_gemm_work",
                                                "splitkv_work"}
    for (lg, _, pos), (lg2, _, pos2) in zip(recorded, again):
        assert torch.equal(lg, lg2) and torch.equal(pos, pos2)


def test_replay_without_an_observer_records_and_launches_nothing():
    rt = _runtime("moe")
    mbs = _micro_batches(rt)
    _, effects = rotation_graph.SideEffects.during(
        rt, lambda: rt._rotation(mbs))
    stats = AFDStats()
    launches = ops.launch_counts()
    for _ in range(3):
        effects.replay(stats, None)
    n_moe = sum(s.moe for s in rt.specs)
    assert stats.dispatches == 3 * n_moe * len(mbs)
    assert ops.launch_counts() == launches


class Kept:
    """A work observer that keeps the tensors it is given."""

    def __init__(self):
        self.inputs = []

    def kernel(self, work, *inputs):
        self.inputs.append(inputs)
        return rotation_graph._UNOBSERVED


def test_each_value_tensor_is_cloned_once_per_replay():
    """The grouped GEMM's two calls of one expert FFN read one group-sizes
    tensor: a replay under an observer hands both one clone of it, taken
    when it replays; the other tensors are meta tensors."""
    rt = _runtime("moe")
    mbs = _micro_batches(rt)
    _, effects = rotation_graph.SideEffects.during(
        rt, lambda: _decode_attention(rt, rt._rotation(mbs)))
    held = {id(x): x for _, inputs in effects.calls for x in inputs
            if isinstance(x, torch.Tensor) and not x.is_meta}
    n_moe = sum(s.moe for s in rt.specs)
    assert len(held) == n_moe * len(mbs) + len(mbs)

    seen = []
    for _ in range(2):
        kept = Kept()
        effects.replay(AFDStats(), kept)
        values = [x for inputs in kept.inputs for x in inputs
                  if isinstance(x, torch.Tensor) and not x.is_meta]
        clones = {id(x): x for x in values}
        assert len(clones) == len(held) and not clones.keys() & held.keys()
        seen.append(clones.keys())
        for (_, recorded), inputs in zip(effects.calls, kept.inputs):
            for r, x in zip(recorded, inputs):
                if isinstance(r, torch.Tensor) and not r.is_meta:
                    assert torch.equal(r, x) and x.dtype == r.dtype
    assert not seen[0] & seen[1]


class _EagerGraph:
    """Stands in for a CUDA graph on the CPU: its replay runs the rotation
    on the captured rotation's own buffers into its outputs."""

    def __init__(self, rt, tokens, caches, pos, outs):
        self.rt, self.outs = rt, outs
        self.mbs = list(zip(tokens, caches, pos))

    def replay(self):
        with trace.enabled(None):
            got, _ = rotation_graph.SideEffects.during(
                self.rt, lambda: self.rt._rotation(self.mbs))
        for (lg, _, p), (lg_out, p_out) in zip(got, self.outs):
            lg_out.copy_(lg)
            p_out.copy_(p)


def test_runtime_counts_its_replays_and_replays_the_records():
    """The replay branch of ``decode_step_3bo``: the caller's tokens and
    positions go into the captured buffers, the outputs come back as
    copies, the M2N records are made once a rotation, and the runtime
    counts the replay (``replays``, ``graph.replay``)."""
    rt = _runtime("moe")
    mbs = _micro_batches(rt)
    want = [(lg, p) for lg, _, p in rt._rotation(
        [(t, [{k: v.clone() for k, v in c.items()} for c in caches],
          p.clone()) for t, caches, p in mbs])]
    tokens = [torch.zeros_like(t) for t, _, _ in mbs]
    pos = [torch.zeros_like(p) for _, _, p in mbs]
    outs = [(torch.empty_like(lg), torch.empty_like(p)) for lg, p in want]
    _, effects = rotation_graph.SideEffects.during(
        rt, lambda: rt._rotation(mbs))
    key = rotation_graph.rotation_key(mbs, 2)
    rt._graph = rotation_graph.CapturedRotation(
        key, _EagerGraph(rt, tokens, [c for _, c, _ in mbs], pos, outs),
        tokens, pos, outs, effects, [])
    rt._graphable = True
    stats0 = rt.stats.snapshot()
    tr = trace.Tracer()
    with trace.enabled(tr):
        got = rt.decode_step_3bo(mbs, n_bo=2)
    assert rt.replays == 1 and tr.counters == {"graph.replay": 1}
    assert [s.name for s in tr.spans
            if s.name != "gc.collect"] == ["afd.rotation.replay"]
    assert rt.stats.since(stats0).dispatches == len(effects.records)
    for (lg, caches, p), (lg_w, p_w), (_, given, _), out in zip(
            got, want, mbs, outs):
        assert torch.equal(lg, lg_w) and torch.equal(p, p_w)
        assert lg is not out[0] and p is not out[1]
        assert all(c is g for c, g in zip(caches, given))
    assert all(torch.equal(t, t_in) for (t, _, _), t_in in zip(mbs, tokens))


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (rid, arrival tick, prompt length, new tokens): admissions over the run,
# prompts of one to three chunks, answers that end at different ticks
REQUESTS = [(0, 0, 5, 6), (1, 0, 11, 9), (2, 1, 3, 4), (3, 2, 17, 7),
            (4, 3, 8, 12), (5, 5, 20, 5), (6, 6, 4, 10), (7, 8, 13, 6),
            (8, 9, 6, 8), (9, 11, 9, 3)]
TICK = 0.01


def _step(eng):
    """One turn of ``AFDServeEngine.run``'s loop: a tick, or the clock
    moved on to the next arrival when nothing is in flight."""
    if eng.live_count() == 0 and not eng.queue and eng.trace:
        eng.now = max(eng.now, eng.trace[0].t)
        eng._drain_arrivals()
        return
    eng.tick()


def _lockstep(cuda, arch):
    """Two engines on two runtimes of the same weights, one replaying its
    rotation, the other running it eager, ticked together."""
    cfg = ArchConfig(**CONFIGS[arch], **BF16)
    params = init_params(cfg, seed=0, device=cuda)
    engines = {}
    for name in ("graph", "eager"):
        rt = AFDRuntime(cfg, params, device=cuda)
        assert rt._graphable
        engines[name] = AFDServeEngine(rt, max_len=48, n_bo=2, mb_slots=3,
                                       prefill_chunk=8, tick_seconds=TICK,
                                       window_ticks=4)
    rt = engines["eager"].rt
    engines["eager"].rt.decode_step_3bo = (
        lambda mbs, n_bo=3: rt._rotation(mbs))
    return engines


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moe", "hybrid"])
def test_engine_replay_is_bit_identical_to_eager(cuda, arch):
    engines = _lockstep(cuda, arch)
    logits = {name: [] for name in engines}
    rotation_launches = {name: [] for name in engines}
    for name, eng in engines.items():
        inner = eng.rt.decode_step_3bo

        def recorded(mbs, n_bo=3, inner=inner, out=logits[name],
                     launched=rotation_launches[name]):
            before = ops.launch_counts()
            outs = inner(mbs, n_bo=n_bo)
            launched.append({k: n - before[k]
                             for k, n in ops.launch_counts().items()})
            out.append([lg.clone() for lg, _, _ in outs])
            return outs
        eng.rt.decode_step_3bo = recorded
        for rid, at, plen, new in REQUESTS:
            eng.trace.append(ArrivalEvent(rid=rid, t=at * TICK,
                                          prompt_len=plen,
                                          max_new_tokens=new))
    tracer = trace.Tracer()
    launches = {name: dict.fromkeys(ops.launch_counts(), 0)
                for name in engines}
    observed = {name: WorkLog() for name in engines}
    ticks = 0
    while any(e.trace or e.queue or e.live_count()
              for e in engines.values()):
        for name, eng in engines.items():
            before = ops.launch_counts()
            previous = ops.set_work_observer(
                observed[name] if ticks % 3 == 2 else None)
            try:
                with trace.enabled(tracer if name == "graph" else None):
                    _step(eng)
            finally:
                ops.set_work_observer(previous)
            for k, n in ops.launch_counts().items():
                launches[name][k] += n - before[k]
        ticks += 1
        g, e = engines["graph"], engines["eager"]
        assert g.now == e.now and g.stats == e.stats
        for mb_g, mb_e in zip(g.mbs, e.mbs):
            assert [r and r.rid for r in mb_g.slots] == \
                [r and r.rid for r in mb_e.slots]
            assert (mb_g.tokens == mb_e.tokens).all()
            assert torch.equal(mb_g.pos, mb_e.pos)
            for c_g, c_e in zip(mb_g.caches, mb_e.caches):
                assert all(torch.equal(c_g[k], c_e[k]) for k in c_e)
        assert len(logits["graph"]) == len(logits["eager"])
        for a, b in zip(logits["graph"][-1:], logits["eager"][-1:]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    g, e = engines["graph"], engines["eager"]
    assert ticks >= 12 and g.stats.decode_ticks >= 12
    assert g.stats.completed == len(REQUESTS)
    assert {r.rid: r.output for r in g.completed} == {
        r.rid: r.output for r in e.completed}
    assert g.rt.stats == e.rt.stats
    for eng in (g, e):
        eng.run([])                           # closes the last window
        assert eng.windows and all(w.bytes_match for w in eng.windows)
    # the counters see the eager and the captured rotation's launches, the
    # eager engine's every rotation's, and no replay's
    per_rotation = rotation_launches["eager"][0]
    assert per_rotation["grouped_gemm"] > 0
    assert rotation_launches["eager"] == [per_rotation] * len(
        rotation_launches["eager"])
    zero = dict.fromkeys(per_rotation, 0)
    assert rotation_launches["graph"] == [per_rotation] * 2 + [zero] * (
        g.stats.decode_ticks - 2)
    assert g.rt.replays == g.stats.decode_ticks - 2 and e.rt.replays == 0
    assert launches["graph"] == {
        k: n - g.rt.replays * per_rotation[k]
        for k, n in launches["eager"].items()}
    assert observed["graph"].calls == observed["eager"].calls
    assert observed["graph"].calls
    assert observed["graph"].ranges == ["enter", "exit"] * len(
        observed["graph"].calls)
    assert tracer.counters == {}
    counts = {}
    for s in tracer.spans:
        for k, v in (s.counters or {}).items():
            if k.startswith("graph."):
                counts[k] = counts.get(k, 0) + v
    assert counts == {"graph.eager": 1, "graph.capture": 1,
                      "graph.replay": g.stats.decode_ticks - 2}


@pytest.mark.gpu
def test_a_new_key_runs_eager_then_captures_and_the_old_caches_are_freed(
        cuda):
    """One captured rotation per runtime. It holds no caller's caches:
    dropped, they are freed. Other caches run eager once, are captured the
    next time and replace the first capture."""
    rt = _runtime("moe", device=cuda)
    tracer = trace.Tracer()

    def rotations(seed, slots, length):
        mbs = _micro_batches(rt, slots=slots, length=length, seed=seed)
        for _ in range(3):
            outs = rt.decode_step_3bo(mbs, n_bo=2)
            mbs = [(t, c, p) for (t, _, _), (_, c, p) in zip(mbs, outs)]
        return mbs
    with trace.enabled(tracer):
        mbs = rotations(0, 3, 16)
        first = rt._graph
        refs = [weakref.ref(t) for _, caches, _ in mbs for c in caches
                for t in c.values()]
        del mbs
        gc.collect()
        assert rt._graph is first and all(r() is None for r in refs)
        # other shapes, so that no cache of the second key may reuse an
        # address of the first and match its key
        mbs = rotations(1, 4, 24)
    assert rt._graph is not first
    assert rt._graph.key == rotation_graph.rotation_key(mbs, 2)
    assert tracer.counters == {"graph.eager": 2, "graph.capture": 2,
                               "graph.replay": 2}
    captures = [s for s in tracer.spans if s.name == "afd.rotation.capture"]
    assert [s.counters for s in captures] == [{"sync.graph_capture": 1}] * 2
    assert len([s for s in tracer.spans
                if s.name == "afd.rotation.replay"]) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moe", "hybrid"])
def test_a_replay_runs_the_rotation_kernels_on_the_card(cuda, arch):
    """The card's own count of the hand-written kernels over replayed
    rotations, by kernel name in a ``torch.profiler`` trace: one split-KV
    per attention layer and a grouped-GEMM pair per MoE layer of each
    micro-batch, as many as an eager rotation launches; the launch
    counters stay where they were and the runtime counts the replays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rt = _runtime(arch, device=cuda)
    mbs = _micro_batches(rt, n_bo=2)
    attn = sum(s.kind == "attn" for s in rt.specs)
    moe = sum(s.moe for s in rt.specs)

    def rotate():
        nonlocal mbs
        outs = rt.decode_step_3bo(mbs, n_bo=2)
        mbs = [(t, c, p) for (t, _, _), (_, c, p) in zip(mbs, outs)]
    for _ in range(3):                  # eager, capture, replay
        rotate()
    torch.cuda.synchronize()
    launches, replays = ops.launch_counts(), rt.replays
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            rotate()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert rt.replays == replays + 3
    assert ops.launch_counts() == launches
    assert sum("splitkv_" in n for n in names) == 3 * 2 * attn
    assert sum("grouped_gemm_" in n for n in names) == 3 * 2 * 2 * moe
