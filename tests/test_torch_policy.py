"""The port's §3.3 policy loop and HFU probe against the JAX package: the
analysis copies (``repro_torch.core``) equal to ``repro.core`` over every
model and hardware entry, the SLO scheduler's decisions on one jitter
stream, the serving engine with scheduler and probe on JAX's own weights
(through the numpy bridge), and ``serve-traffic``'s flags, columns and
window records against ``python -m repro serve-traffic``."""

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
from repro.core import budget as jbdg  # noqa: E402
from repro.core import comm_roofline as jcr  # noqa: E402
from repro.core import hfu_bound as jhb  # noqa: E402
from repro.core import imbalance as jimb  # noqa: E402
from repro.core import planner as jpln  # noqa: E402
from repro.core.hardware import HARDWARE as JHARDWARE  # noqa: E402
from repro.core.modelspec import ALL_MODELS as JMODELS  # noqa: E402
from repro.models.model import make_model  # noqa: E402
from repro.parallel.afd import AFDRuntime as JAFDRuntime  # noqa: E402
from repro.serving import afd_engine as jeng  # noqa: E402
from repro.serving import scheduler as jsch  # noqa: E402
from repro.serving.workload import generate_trace as jtrace  # noqa: E402
from repro.serving.workload import get_profile as jprofile  # noqa: E402
from repro_torch import __main__ as tcli  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.api import registry as treg  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core import budget as tbdg  # noqa: E402
from repro_torch.core import comm_roofline as tcr  # noqa: E402
from repro_torch.core import hfu_bound as thb  # noqa: E402
from repro_torch.core import imbalance as timb  # noqa: E402
from repro_torch.core import planner as tpln  # noqa: E402
from repro_torch.core.hardware import HARDWARE as THARDWARE  # noqa: E402
from repro_torch.core.modelspec import ALL_MODELS as TMODELS  # noqa: E402
from repro_torch.parallel.afd import AFDRuntime  # noqa: E402
from repro_torch.serving import afd_engine as teng  # noqa: E402
from repro_torch.serving import scheduler as tsch  # noqa: E402
from repro_torch.serving.workload import generate_trace, get_profile  # noqa: E402


def _d(x):
    """A dataclass (or list of them) as plain data, so a JAX-side and a
    port-side instance of twin classes compare with ``==``."""
    if isinstance(x, list):
        return [_d(v) for v in x]
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _both(fn_j, fn_t):
    """(result or exception type and message) of the JAX and port calls."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(_d(fn()))
        except Exception as e:                   # PlanningError included
            out.append(("raises", type(e).__name__, str(e)))
    return out


# ---- analysis copies ---------------------------------------------------------

def test_tables_equal_jax():
    assert sorted(THARDWARE) == sorted(JHARDWARE)
    assert all(_d(THARDWARE[h]) == _d(JHARDWARE[h]) for h in JHARDWARE)
    assert sorted(TMODELS) == sorted(JMODELS)
    assert all(_d(TMODELS[m]) == _d(JMODELS[m]) for m in JMODELS)
    assert tbdg.WEIGHT_BYTES_PER_PARAM == jbdg.WEIGHT_BYTES_PER_PARAM
    for name in jbdg.WEIGHT_BYTES_PER_PARAM:
        assert (tbdg.weight_bytes_per_param(name)
                == jbdg.weight_bytes_per_param(name))
    assert treg.list_hardware() == jreg.list_hardware()
    for scen in ("default", "tight-slo", "relaxed-slo", "no-mtp"):
        assert _d(treg.resolve_scenario(scen)) == _d(
            jreg.resolve_scenario(scen))
    for bad in (lambda r: r.resolve_hardware("H8OO"),
                lambda r: r.resolve_scenario("tight")):
        with pytest.raises(KeyError) as te:
            bad(treg)
        with pytest.raises(KeyError) as je:
            bad(jreg)
        assert te.value.args == je.value.args
    assert treg.resolve_hardware("H800") is THARDWARE["H800"]
    for arch in tconfigs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            assert _d(treg.spec_from_arch_config(
                getattr(tconfigs, get)(arch))) == _d(
                jreg.spec_from_arch_config(getattr(jconfigs, get)(arch)))


@pytest.mark.parametrize("hw", sorted(JHARDWARE))
def test_planner_chain_equal_jax(hw):
    """plan_afd (or the same PlanningError), hfu_point, the dead-zone
    boundary, the Fig. 2 sweep, live_hfu and the verdict, for every model
    on this hardware, at fp8 and int4 expert-weight widths."""
    jh, th = JHARDWARE[hw], THARDWARE[hw]
    for name in sorted(JMODELS):
        jm, tm = JMODELS[name], TMODELS[name]
        for wb in (1.0, 0.5):
            a, b = _both(lambda: jpln.plan_afd(jm, jh, weight_bytes=wb),
                         lambda: tpln.plan_afd(tm, th, weight_bytes=wb))
            assert a == b, (name, wb)
            a, b = _both(lambda: jhb.dead_zone_boundary(jm, jh,
                                                        weight_bytes=wb),
                         lambda: thb.dead_zone_boundary(tm, th,
                                                        weight_bytes=wb))
            assert a == b, (name, wb)
            for n_f in (1, 3, jhb.default_n_f_max(jm, jh)):
                a, b = _both(lambda: jhb.hfu_point(jm, jh, n_f,
                                                   weight_bytes=wb),
                             lambda: thb.hfu_point(tm, th, n_f,
                                                   weight_bytes=wb))
                assert a == b, (name, n_f, wb)
        assert _d(jcr.intensity_sweep(jm, jh)) == _d(
            tcr.intensity_sweep(tm, th))
        assert jcr.regime_boundaries(jm, jh) == tcr.regime_boundaries(tm, th)
        a, b = _both(lambda: jpln.afd_verdict(jm, jh),
                     lambda: tpln.afd_verdict(tm, th))
        assert a == b, name
        if jm.is_moe:
            jp, tp = jpln.plan_afd(jm, jh), tpln.plan_afd(tm, th)
            for routed, secs in ((0.0, 0.08), (1234.0, 0.08), (5e6, 0.5)):
                assert _d(jpln.live_hfu(jm, jh, jp, routed, secs)) == _d(
                    tpln.live_hfu(tm, th, tp, routed, secs))
            for sigma in (0.55, 0.8, 1.0):
                assert _d(jpln.elastic_rescale(jp, sigma)) == _d(
                    tpln.elastic_rescale(tp, sigma))
                assert _d(jpln.rescale_n_f(jp, sigma)) == _d(
                    tpln.rescale_n_f(tp, sigma))


def test_imbalance_equal_jax():
    for sigma in (0.5, 0.63, 0.75, 0.8, 1.0):
        for lam in (1.0, 2.5, 4.0):
            assert timb.alpha_ep(sigma, lam) == jimb.alpha_ep(sigma, lam)
            assert timb.alpha_dp_ep(sigma, lam) == jimb.alpha_dp_ep(sigma,
                                                                    lam)
        for n_a, n_f in ((4, 1), (7, 2), (147, 1), (13, 6)):
            for fn in ("alpha_afd", "alpha_afd_exact", "alpha_afd_floor",
                       "alpha_afd_ceil"):
                assert (getattr(timb, fn)(sigma, n_a, n_f)
                        == getattr(jimb, fn)(sigma, n_a, n_f)), fn
        assert timb.alpha_dp_afd(sigma) == jimb.alpha_dp_afd(sigma)
    assert _d(timb.fig6_sweep()) == _d(jimb.fig6_sweep())
    assert timb.afd_worse_fraction() == jimb.afd_worse_fraction()
    assert tpln.nf_quantization_threshold(3) == \
        jpln.nf_quantization_threshold(3)
    assert _d(tpln.plan_table([TMODELS["DeepSeek-V3"]],
                              [THARDWARE["GB200"]])) == _d(
        jpln.plan_table([JMODELS["DeepSeek-V3"]], [JHARDWARE["GB200"]]))


@pytest.mark.parametrize("mode", ["ep", "afd"])
def test_scheduler_decisions_equal_jax(mode):
    lats = tsch.inject_jitter(0.01, 200, sigma_true=0.6, seed=4)
    assert lats == jsch.inject_jitter(0.01, 200, sigma_true=0.6, seed=4)
    plans = (jpln.plan_afd(JMODELS["DeepSeek-V3"], JHARDWARE["H800"]),
             tpln.plan_afd(TMODELS["DeepSeek-V3"], THARDWARE["H800"]))
    scheds = [mod.SLOScheduler(mod.SLOConfig(deadline_factor=1.5), mode=mode,
                               lam=3.0, plan=plan)
              for mod, plan in zip((jsch, tsch), plans)]
    for i, dt in enumerate(lats):
        for s in scheds:
            s.observe(dt)
        if i % 16 == 15:
            a, b = (_d(s.decide(0.01)) for s in scheds)
            assert a == b
    assert _d(scheds[0].decisions) == _d(scheds[1].decisions)
    assert any(d.sigma < 1.0 for d in scheds[1].decisions)
    with pytest.raises(ValueError):
        tsch.SLOScheduler(tsch.SLOConfig(), mode="afd")


# ---- engine with scheduler and probe, on JAX's weights ------------------------

def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x), tree)


def test_engine_policy_and_probe_match_jax():
    """Injected jitter (σ_true 0.5), the EP-mode scheduler (λ 4) and the
    HFU probe on an H800 plan, legacy admission, the seeded poisson-burst
    trace: every WindowRecord field, every decision, the summary and the
    greedy outputs equal the JAX engine's, and admission really shrank."""
    arch = "granite-moe-1b-a400m"
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(
        arch)
    jparams = make_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, _numpy_tree(jparams), "cpu")
    lats = jsch.inject_jitter(0.01, 400, sigma_true=0.5, seed=3)
    engines = []
    for reg, pln, sch, eng, rt in (
            (jreg, jpln, jsch, jeng,
             lambda: JAFDRuntime(jcfg, jparams, [jax.devices()[0]],
                                 [jax.devices()[0]])),
            (treg, tpln, tsch, teng,
             lambda: AFDRuntime(tcfg, tparams, device="cpu"))):
        cfg = jcfg if reg is jreg else tcfg
        spec, hw = reg.spec_from_arch_config(cfg), reg.resolve_hardware(
            "H800")
        probe = eng.HFUProbe(model=spec, hardware=hw,
                             plan=pln.plan_afd(spec, hw))
        e = eng.AFDServeEngine(
            rt(), max_len=32, n_bo=2, mb_slots=2, tick_seconds=0.01,
            tick_latencies=lats,
            scheduler=sch.SLOScheduler(sch.SLOConfig(tpot=0.05), mode="ep",
                                       lam=4.0),
            probe=probe)
        gen = jtrace if reg is jreg else generate_trace
        prof = jprofile if reg is jreg else get_profile
        e.run(gen(prof("poisson-burst"), seed=0, max_requests=10),
              max_ticks=2000)
        engines.append(e)
    je, te = engines
    assert _d(te.windows) == _d(je.windows)
    assert _d(te.decisions) == _d(je.decisions)
    jsum = je.summary()
    tsum = te.summary()
    assert jsum == tsum
    assert ({r.rid: r.output for r in te.completed}
            == {r.rid: r.output for r in je.completed})
    assert tsum["completed"] == 10 and tsum["bytes_match_all"]
    assert min(w.live_cap for w in te.windows) < te.total_slots
    busy = [w for w in te.windows if w.tokens_routed]
    assert busy and all(w.hfu_measured <= w.hfu_predicted for w in busy)


# ---- serve-traffic against python -m repro serve-traffic ---------------------

def _serve_traffic_parser(build):
    sub = next(a for a in build()._actions
               if a.dest == "cmd" or getattr(a, "choices", None))
    return sub.choices["serve-traffic"]


def test_serve_traffic_flags_and_defaults_match_jax():
    jp = _serve_traffic_parser(jcli.build_parser)
    tp = _serve_traffic_parser(tcli.build_parser)
    jd = {a.dest: (a.default, a.required) for a in jp._actions}
    td = {a.dest: (a.default, a.required) for a in tp._actions}
    shared = set(jd) & set(td)
    assert {"hardware", "policy", "slo_tpot", "slo_ttft"} <= shared
    assert set(jd) - set(td) == set()             # every JAX flag exists
    for dest in shared - {"help"}:
        if jd[dest][1]:                           # required there (profile)
            continue
        assert td[dest] == jd[dest], dest
    jpol = next(a for a in jp._actions if a.dest == "policy")
    tpol = next(a for a in tp._actions if a.dest == "policy")
    assert tpol.choices == jpol.choices == ["ep", "afd", "off"]


def _run(main, argv, tmp_path, name):
    path = tmp_path / f"{name}.json"
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv + ["--json", str(path)])
    doc = json.loads(path.read_text()) if rc == 0 else None
    return rc, doc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("policy", [None, "afd", "off"],
                         ids=["default-flags", "afd", "off"])
def test_cli_serve_traffic_matches_jax(tmp_path, policy):
    """Same profile and seed through both command lines (each with its own
    random weights): equal window records (policy and HFU fields
    included) and summary counters, and the same columns printed."""
    argv = ["serve-traffic", "--profile", "poisson-burst", "--max-requests",
            "6"] + ([] if policy is None else ["--policy", policy])
    jrc, jdoc, jout, _ = _run(jcli.main, argv, tmp_path, "jax")
    trc, tdoc, tout, _ = _run(tcli.main, argv + ["--device", "cpu"],
                              tmp_path, "port")
    assert jrc == trc == 0
    assert tdoc["windows"] == jdoc["windows"]
    skip = {"wall_s", "device"}
    assert ({k: v for k, v in tdoc["summary"].items() if k not in skip}
            == {k: v for k, v in jdoc["summary"].items() if k not in skip})
    want_cols = {None: ("sigma alpha", "hfu_meas/pred"),
                 "afd": ("sigma alpha", "hfu_meas/pred"),
                 "off": ("hfu_meas/pred",)}[policy]
    for out in (jout, tout):
        header = next(ln for ln in out.splitlines() if ln.startswith("win"))
        for col in want_cols:
            assert col in header
        assert ("sigma" in header) == (policy != "off")
        assert "hfu: measured_mean=" in out
    modes = {w["policy_mode"] for w in tdoc["windows"]}
    assert modes == ({None} if policy == "off" else {policy or "ep"})
    if policy == "afd":
        assert all(w["n_a"] is not None for w in tdoc["windows"])


def test_cli_without_plan_warns_and_refuses_afd(tmp_path, monkeypatch):
    """When the planner finds no AFD plan both command lines warn and run
    without the probe, and ``--policy afd`` exits 2; an unknown hardware
    name exits 2 with the registry's message."""
    def no_plan(*args, **kwargs):
        raise jpln.PlanningError("no plan (test)")

    def no_plan_port(*args, **kwargs):
        raise tpln.PlanningError("no plan (test)")

    monkeypatch.setattr(jpln, "plan_afd", no_plan)
    monkeypatch.setattr(tpln, "plan_afd", no_plan_port)
    argv = ["serve-traffic", "--profile", "poisson-burst", "--max-requests",
            "2"]
    rcs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        rc, doc, out, err = _run(main, argv + extra, tmp_path, "w")
        assert rc == 0 and "warning: no AFD plan" in err
        assert "hfu_meas" not in out
        assert all(w["hfu_measured"] is None for w in doc["windows"])
        rc, _, _, err = _run(main, argv + extra + ["--policy", "afd"],
                             tmp_path, "afd")
        assert "--policy afd needs a feasible AFD plan" in err
        rcs.append(rc)
    assert rcs == [2, 2]
    rc, _, _, err = _run(tcli.main, argv + ["--device", "cpu", "--hardware",
                                            "H8OO"], tmp_path, "bad")
    assert rc == 2 and "unknown hardware 'H8OO'" in err
