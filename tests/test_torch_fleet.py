"""The port's fleet slice on the CPU against the JAX package: the routers,
the elastic N_F rescaler, the engine's drain hooks, the runtime's rescale,
whole fleets (``benchmarks/fleet_smoke.py``'s setup and a heterogeneous
chunked-prefill fleet with a partial failure) and the ``serve-fleet``
command line. Inputs come from seeds; weights cross from JAX through the
numpy bridge, so greedy outputs compare too. The fleet's clock is virtual:
its floats are the same sums in the same order in both packages and
compare exactly."""

import collections
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.api import cli as jcli  # noqa: E402
from repro.api import registry as jreg  # noqa: E402
from repro.core import planner as jpln  # noqa: E402
from repro.fleet import events as jevents  # noqa: E402
from repro.fleet import router as jrouter  # noqa: E402
from repro.fleet.controller import FleetController as JFleet  # noqa: E402
from repro.fleet.controller import FleetReplica as JReplica  # noqa: E402
from repro.fleet.rescaler import ElasticRescaler as JRescaler  # noqa: E402
from repro.models.model import make_model  # noqa: E402
from repro.parallel.afd import AFDRuntime as JAFDRuntime  # noqa: E402
from repro.parallel.afd import rescale as jrescale  # noqa: E402
from repro.serving.afd_engine import AFDServeEngine as JEngine  # noqa: E402
from repro.serving.afd_engine import HFUProbe as JProbe  # noqa: E402
from repro.serving.workload import generate_trace as jtrace  # noqa: E402
from repro.serving.workload import get_profile as jprofile  # noqa: E402
from repro_torch import __main__ as tcli  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.api import registry as treg  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core import planner as tpln  # noqa: E402
from repro_torch.fleet import events as tevents  # noqa: E402
from repro_torch.fleet import router as trouter  # noqa: E402
from repro_torch.fleet.controller import FleetController  # noqa: E402
from repro_torch.fleet.controller import FleetReplica  # noqa: E402
from repro_torch.fleet.rescaler import ElasticRescaler  # noqa: E402
from repro_torch.parallel.afd import AFDRuntime, rescale  # noqa: E402
from repro_torch.serving.afd_engine import AFDServeEngine, HFUProbe  # noqa: E402
from repro_torch.serving.workload import generate_trace, get_profile  # noqa: E402

ARCH = "granite-moe-1b-a400m"


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x), tree)


@pytest.fixture(scope="module")
def bridged():
    """Smoke weights from JAX's init, and the same weights in the port."""
    out = {}
    for arch in (ARCH, "kimi-k2-1t-a32b"):
        jcfg = jconfigs.get_smoke_config(arch)
        jparams = make_model(jcfg).init(jax.random.PRNGKey(0))
        tcfg = tconfigs.get_smoke_config(arch)
        out[arch] = (jcfg, jparams, tcfg,
                     params_from_jax(tcfg, _numpy_tree(jparams), "cpu"))
    return out


def _jruntime(jcfg, jparams):
    dev = jax.devices()[0]
    return JAFDRuntime(jcfg, jparams, [dev], [dev])


# ---- routers ----------------------------------------------------------------

def _views(rng, module):
    n = int(rng.integers(1, 5))
    views = []
    for idx in sorted(rng.choice(6, n, replace=False)):
        chunk = [None, 4, 16][int(rng.integers(3))]
        views.append(module.ReplicaView(
            index=int(idx), name=f"replica{idx}",
            queue_len=int(rng.integers(0, 6)), live=int(rng.integers(0, 5)),
            total_slots=4,
            kv_occupancy_bytes=int(rng.integers(0, 4)) * 1024,
            kv_budget_bytes=4096,
            queued_kv_bytes=int(rng.integers(0, 4)) * 1024,
            queued_prompt_tokens=int(rng.integers(0, 40)),
            queued_pending_tokens=int(rng.integers(0, 40)),
            tick_seconds=0.01, prefill_chunk=chunk,
            prefill_backlog_tokens=int(rng.integers(0, 20))))
    return views


@pytest.mark.parametrize("policy", ["round-robin", "least-kv",
                                    "predicted-ttft"])
def test_routers_choose_as_jax(policy):
    """300 seeded arrivals over random healthy subsets (ties included, on
    coarse KV sizes): every choice equal, round-robin's cursor too."""
    rng = np.random.default_rng(11)
    jp, tp = jrouter.get_policy(policy), trouter.get_policy(policy)
    for rid in range(300):
        state = rng.bit_generator.state
        jv = _views(rng, jrouter)
        rng.bit_generator.state = state
        tv = _views(rng, trouter)
        kw = dict(rid=rid, t=0.01 * rid, prompt_len=int(rng.integers(1, 30)),
                  max_new_tokens=int(rng.integers(1, 10)))
        assert (tp.choose(trouter.RouteRequest(**kw), tv)
                == jp.choose(jrouter.RouteRequest(**kw), jv))
    assert trouter.list_policies() == jrouter.list_policies()


# ---- rescaler ---------------------------------------------------------------

@pytest.mark.parametrize("hardware,cooldown,threshold",
                         [("H100", 0, None), ("H800", 0, None),
                          ("H800", 2, 0.05)],
                         ids=["H100", "H800", "H800-cooldown-threshold"])
def test_rescaler_matches_jax(hardware, cooldown, threshold):
    """Full-width granite-moe's spec, one seeded σ sequence with idle
    windows: equal decisions and RescaleEvents."""
    jspec = jreg.spec_from_arch_config(jconfigs.get_config(ARCH))
    tspec = treg.spec_from_arch_config(tconfigs.get_config(ARCH))
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    jr = JRescaler(jspec, jreg.resolve_hardware(hardware),
                   cooldown_windows=cooldown, threshold=threshold)
    tr = ElasticRescaler(tspec, treg.resolve_hardware(hardware),
                         cooldown_windows=cooldown, threshold=threshold)
    sigmas = np.random.default_rng(3).uniform(0.0, 3.0, 60)
    sigmas[::7] = 0.0                                   # idle windows
    for w, sigma in enumerate(sigmas):
        je = jr.observe(w, 0.08 * w, float(sigma))
        te = tr.observe(w, 0.08 * w, float(sigma))
        assert (te is None) == (je is None)
        assert tr.n_f == jr.n_f
    assert len(tr.events) >= 3
    assert ([dataclasses.asdict(e) for e in tr.events]
            == [dataclasses.asdict(e) for e in jr.events])
    assert ([dataclasses.asdict(d) for d in tr.decisions]
            == [dataclasses.asdict(d) for d in jr.decisions])


@pytest.mark.parametrize("kw", [dict(t=1.0, replica=0, frac=0.0),
                                dict(t=1.0, replica=0, frac=1.5),
                                dict(t=-0.1, replica=0)],
                         ids=["frac-0", "frac-above-1", "negative-t"])
def test_failure_event_validation(kw):
    for module in (jevents, tevents):
        with pytest.raises(ValueError):
            module.FailureEvent(**kw)


def test_registry_routers_match_jax():
    assert treg.list_routers() == jreg.list_routers()
    assert treg.resolve_router("least-kv").name == "least-kv"
    msgs = []
    for reg in (jreg, treg):
        with pytest.raises(KeyError) as e:
            reg.resolve_router("least_kv")
        msgs.append(e.value.args[0])
    assert msgs[0] == msgs[1] and "did you mean 'least-kv'" in msgs[1]


# ---- engine drain hooks -----------------------------------------------------

def _advance(eng, n):
    """``n`` iterations of the engine's own serve loop."""
    for _ in range(n):
        if not eng.trace and not eng.queue and eng.live_count() == 0:
            return
        if eng.live_count() == 0 and not eng.queue and eng.trace:
            eng.now = max(eng.now, eng.trace[0].t)
            eng._drain_arrivals()
            continue
        eng.tick()


def _state(eng):
    return dict(queue=[r.rid for r in eng.queue],
                live=[r.rid for r in eng.live_requests()],
                backlog=eng.prefill_backlog_tokens(),
                queued_kv=eng.queued_kv_bytes(),
                queued_prompt=eng.queued_prompt_tokens(),
                queued_pending=eng.queued_pending_tokens(),
                kv=eng.kv_occupancy_bytes(), now=eng.now)


# (prefill chunk, loop iterations before the partial failure, then before
# the full drain): both failures hit occupied slots, and in chunked mode
# the partial one evicts a slot mid-prefill
DRAIN_CASES = [(None, 4, 16), (3, 28, 6)]


@pytest.mark.parametrize("chunk,first,second", DRAIN_CASES,
                         ids=["legacy", "chunked"])
def test_engine_drain_hooks_match_jax(bridged, chunk, first, second):
    """Mid-run on the seeded poisson-burst trace: ``simulate_failure(0.5)``,
    more ticks, ``drain_all``, every drained request ``resubmit``-ted,
    then the rest of the trace: equal requeue counts, queue order by rid,
    introspection, summaries and greedy outputs; timestamps of drained
    requests survive."""
    jcfg, jparams, tcfg, tparams = bridged[ARCH]
    kw = dict(max_len=32, n_bo=2, mb_slots=2, tick_seconds=0.01,
              prefill_chunk=chunk)
    trace = generate_trace(get_profile("poisson-burst"), seed=0,
                           max_requests=12)
    engines = (JEngine(_jruntime(jcfg, jparams), **kw),
               AFDServeEngine(AFDRuntime(tcfg, tparams, device="cpu"), **kw))
    seen = []
    for eng, tr in zip(engines, (jtrace(jprofile("poisson-burst"), seed=0,
                                        max_requests=12), trace)):
        eng.trace = collections.deque(sorted(tr, key=lambda e: e.t))
        _advance(eng, first)
        before = _state(eng)
        n_failed = eng.simulate_failure(0.5)
        after_fail = _state(eng)
        _advance(eng, second)
        mid = _state(eng)
        stamped = {r.rid: r.t_first for r in eng.live_requests()}
        drained = eng.drain_all()
        assert not eng.queue and eng.live_count() == 0
        for r in drained:
            if r.rid in stamped:
                assert r.t_first == stamped[r.rid]
            eng.resubmit(r)
        eng.run(list(eng.trace), max_ticks=2000)
        seen.append(dict(
            before=before, n_failed=n_failed, after_fail=after_fail, mid=mid,
            drained=[r.rid for r in drained], summary=eng.summary(),
            stats=(eng.stats.requeued, eng.stats.replans),
            outputs={r.rid: list(r.output) for r in eng.completed},
            first={r.rid: r.t_first for r in eng.completed}))
    want, got = seen
    assert got == want
    assert got["n_failed"] > 0 and got["drained"]
    if chunk:
        assert got["before"]["backlog"] > got["after_fail"]["backlog"]
    assert got["summary"]["completed"] == 12
    assert got["summary"]["bytes_match_all"]


# ---- runtime rescale --------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "kimi-k2-1t-a32b"])
def test_runtime_rescale(bridged, arch):
    """``rescale`` onto the same device: parameters shared, the tied head
    rebuilt, decode logits bit-identical to the original runtime's, and
    within 1e-4 of JAX's rescaled runtime."""
    jcfg, jparams, tcfg, tparams = bridged[arch]
    rt = AFDRuntime(tcfg, tparams, device="cpu")
    rt2 = rescale(rt, "cpu", ["cpu"])
    assert rt2.impl == rt.impl and rt2.cfg is rt.cfg
    moe = next(i for i, f in enumerate(rt.f_shards) if f is not None)
    assert rt2.f_shards[moe][0]["wi"] is rt.f_shards[moe][0]["wi"]
    assert rt2.a_params["embed"]["tok"] is rt.a_params["embed"]["tok"]
    if tcfg.tie_embeddings:
        assert rt2.a_params["lm_head"]["w"] is not rt.a_params["lm_head"]["w"]
    dev = jax.devices()[0]
    jrt = jrescale(_jruntime(jcfg, jparams), [dev], [dev])
    toks = np.random.default_rng(4).integers(1, tcfg.vocab_size, (2, 5))
    logits = []
    for r in (rt, rt2):
        caches, pos = r.init_cache(2, 8)
        for j in range(toks.shape[1]):
            lg, caches, pos = r.decode_step(torch.from_numpy(toks[:, j]),
                                            caches, pos)
        logits.append(lg)
    assert torch.equal(logits[0], logits[1])
    jc, jpos = jrt.init_cache(2, 8)
    for j in range(toks.shape[1]):
        want, jc, jpos = jrt.decode_step(jnp.asarray(toks[:, j], jnp.int32),
                                         jc, jpos)
    np.testing.assert_allclose(logits[1].numpy(), np.asarray(want),
                               atol=1e-4)


# ---- whole fleets -----------------------------------------------------------

# benchmarks/fleet_smoke.py's setup, and a heterogeneous chunked-prefill
# fleet under round-robin with partial failures of replica 0 (the one at
# t = 0.3 s finds a request in a drained slot, the one at 0.5 s none)
FLEETS = {
    "fleet-smoke": dict(shapes=[(1, 2)] * 3, chunk=None, requests=48,
                        router="least-kv", failures=[(1.8, 1, 1.0)]),
    "hetero-chunked": dict(shapes=[(2, 2), (1, 4)], chunk=4, requests=16,
                           router="round-robin",
                           failures=[(0.3, 0, 0.5), (0.5, 0, 0.5)]),
}


def _fleet(pkg, setup, bridged):
    jcfg, jparams, tcfg, tparams = bridged[ARCH]
    if pkg == "jax":
        reg, pln, probe_cls, rescaler_cls = jreg, jpln, JProbe, JRescaler
        spec = reg.spec_from_arch_config(jcfg)
    else:
        reg, pln, probe_cls, rescaler_cls = (treg, tpln, HFUProbe,
                                             ElasticRescaler)
        spec = reg.spec_from_arch_config(tcfg)
    hw = reg.resolve_hardware("H800")
    plan = pln.plan_afd(spec, hw)
    probe = probe_cls(model=spec, hardware=hw, plan=plan)
    replicas = []
    for i, (bo, slots) in enumerate(setup["shapes"]):
        kw = dict(max_len=32, n_bo=bo, mb_slots=slots, probe=probe, seed=0,
                  tick_seconds=0.01, window_ticks=8,
                  prefill_chunk=setup["chunk"])
        if pkg == "jax":
            replicas.append(JReplica(name=f"replica{i}", engine=JEngine(
                _jruntime(jcfg, jparams), **kw)))
        else:
            replicas.append(FleetReplica(name=f"replica{i}",
                                         engine=AFDServeEngine(AFDRuntime(
                                             tcfg, tparams, device="cpu"),
                                             **kw)))
    ctl_cls = JFleet if pkg == "jax" else FleetController
    ctl = ctl_cls(replicas, router=setup["router"],
                  rescaler=rescaler_cls(spec, hw, plan), window_ticks=8)
    events = jevents if pkg == "jax" else tevents
    failures = [events.FailureEvent(t=t, replica=rep, frac=frac)
                for t, rep, frac in setup["failures"]]
    gen, prof = ((jtrace, jprofile) if pkg == "jax"
                 else (generate_trace, get_profile))
    ctl.run(gen(prof("poisson-burst"), seed=0,
                max_requests=setup["requests"]),
            failures=failures, max_ticks=5000)
    return ctl


@pytest.fixture(scope="module", params=list(FLEETS))
def fleets(request, bridged):
    setup = FLEETS[request.param]
    return (request.param, _fleet("jax", setup, bridged),
            _fleet("port", setup, bridged))


def test_fleet_windows_match_jax(fleets):
    _, jf, tf = fleets
    assert ([dataclasses.asdict(w) for w in tf.windows]
            == [dataclasses.asdict(w) for w in jf.windows])
    assert all(w.bytes_match for w in tf.windows)


def test_fleet_summary_rescales_drains_match_jax(fleets):
    _, jf, tf = fleets
    assert tf.summary() == jf.summary()
    assert ([dataclasses.asdict(e) for e in tf.rescales]
            == [dataclasses.asdict(e) for e in jf.rescales])
    assert ([dataclasses.asdict(d) for d in tf.drains]
            == [dataclasses.asdict(d) for d in jf.drains])
    assert tf.summary()["lost"] == 0 and tf.requeued > 0


def test_fleet_outputs_match_jax(fleets):
    """Per-rid greedy outputs and TTFT/TPOT timestamps."""
    _, jf, tf = fleets

    def per_rid(ctl):
        return {r.rid: (list(r.output), r.t_arrive, r.t_first, r.t_done)
                for r in ctl.completed_requests()}
    assert per_rid(tf) == per_rid(jf)
    assert len(per_rid(tf)) == tf.arrivals


def test_fleet_smoke_reproduces_golden(fleets):
    """benchmarks/golden.json's fleet rows, recomputed on the port."""
    name, _, tf = fleets
    if name != "fleet-smoke":
        assert tf.summary()["completed"] == FLEETS[name]["requests"]
        return
    s = tf.summary()
    assert (s["arrivals"], s["completed"], s["lost"], s["requeued"],
            s["fleet_ticks"], s["windows"]) == (48, 48, 0, 5, 203, 26)
    assert s["bytes_match_all"]
    assert [r["dispatched"] for r in s["per_replica"].values()] == [20, 13,
                                                                   15]
    assert [r["decode_ticks"] for r in s["per_replica"].values()] == [61, 28,
                                                                     34]
    assert [rep.engine.stats.prefill_tokens for rep in tf.replicas] == [
        113, 44, 84]
    assert [tf.rescaler.baseline_n_f] + [e.new_n_f for e in tf.rescales] \
        == [1, 2, 1]
    spec = tf.rescaler.model
    for e in tf.rescales:
        assert tpln.rescale_n_f(tpln.plan_afd(spec, tf.rescaler.hardware,
                                              n_f=e.old_n_f),
                                e.sigma, e.threshold).new_n_f == e.new_n_f


# ---- command line -----------------------------------------------------------

def _run(main, argv, tmp_path, name):
    path = tmp_path / f"{name}.json"
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv + ["--json", str(path)])
    doc = json.loads(path.read_text()) if rc == 0 else None
    return rc, doc, out.getvalue(), err.getvalue()


CLI_CASES = {
    "least-kv-fatal": ["--max-requests", "10", "--router", "least-kv",
                       "--fail", "0.6:1"],
    "hetero-chunked-partial": ["--replica-shapes", "2x2,1x4",
                               "--prefill-chunk", "4", "--max-requests",
                               "16", "--fail", "0.3:0:0.5", "--fail",
                               "0.5:0:0.5"],
    "predicted-ttft-kv-budget": ["--router", "predicted-ttft",
                                 "--kv-budget-slots", "0.5",
                                 "--max-requests", "8", "--no-rescale"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_serve_fleet_matches_jax(tmp_path, case):
    """The same arguments through both command lines (each with its own
    random weights; no fleet record depends on them): equal windows,
    rescales, failures and summary, and the same rows printed."""
    argv = ["serve-fleet", "--profile", "poisson-burst"] + CLI_CASES[case]
    jrc, jdoc, jout, _ = _run(jcli.main, argv, tmp_path, "jax")
    trc, tdoc, tout, _ = _run(tcli.main, argv + ["--device", "cpu"],
                              tmp_path, "port")
    assert jrc == trc == 0
    for key in ("windows", "rescales", "failures", "shapes", "router"):
        assert tdoc[key] == jdoc[key], key
    skip = {"wall_s", "device"}
    assert ({k: v for k, v in tdoc["summary"].items() if k not in skip}
            == {k: v for k, v in jdoc["summary"].items() if k not in skip})
    rows = [[ln for ln in out.splitlines() if not ln.startswith("#")]
            for out in (jout, tout)]
    assert rows[0] == rows[1]
    assert tdoc["summary"]["lost"] == 0


@pytest.mark.parametrize("extra,message", [
    (["--fail", "1.0:3"], "--fail targets replica 3 but the fleet has 3"),
    (["--router", "least_kv"], "unknown router policy 'least_kv'"),
    (["--arch", "qwen3-8b"], None),
], ids=["fail-target", "unknown-router", "dense-arch"])
def test_cli_serve_fleet_exit_2(tmp_path, extra, message):
    """A --fail target outside the fleet, an unknown router and a dense
    architecture exit 2 in both (the port's --arch takes only the MoE
    configs it carries, so argparse refuses a dense one)."""
    argv = ["serve-fleet", "--profile", "poisson-burst", "--max-requests",
            "2"] + extra
    jrc, _, _, jerr = _run(jcli.main, argv, tmp_path, "jax")
    assert jrc == 2
    port = argv + ["--device", "cpu"]
    if message is None:
        with pytest.raises(SystemExit) as e, \
                contextlib.redirect_stderr(io.StringIO()):
            tcli.main(port)
        assert e.value.code == 2
        return
    trc, _, _, terr = _run(tcli.main, port, tmp_path, "port")
    assert trc == 2 and message in terr and message in jerr


def test_cli_serve_fleet_flags_match_jax():
    """Every flag of ``python -m repro serve-fleet`` exists in the port
    with the same default; the port adds ``--device`` (default cuda)."""
    def flags(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        sp = sub.choices["serve-fleet"]
        return {a.dest: (a.default, a.required) for a in sp._actions}
    jd, td = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert set(td) - set(jd) == {"device"} and td["device"][0] == "cuda"
    for dest in set(jd) - {"help"}:
        assert td[dest] == jd[dest], dest
