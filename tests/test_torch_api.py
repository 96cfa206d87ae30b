"""The port's analysis front door against the JAX package's, on the CPU:
the registry (models, hardware with its interconnect scale, scenarios,
named sweeps, routers, their error messages), the vectorized sweep (every
field bit for bit, NaN-aware and dtype-equal, for every named sweep and an
explicit int4 / ``b_cap`` / ``bw_scale`` grid, at any tiling and over
worker processes), its scalar reference, ``Deployment``'s records, and
``python -m repro_torch {plan,sweep,bench,list}`` against ``python -m
repro``. Both packages' analysis layers are numpy only, so the comparisons
are exact."""

import contextlib
import dataclasses
import importlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.api import Deployment as JDeployment  # noqa: E402
from repro.api import cli as jcli  # noqa: E402
from repro.api import records as jrecords  # noqa: E402
from repro.api import registry as jreg  # noqa: E402
from repro.core.budget import Scenario as JScenario  # noqa: E402
from repro.core.modelspec import PAPER_MODELS  # noqa: E402
from repro.core.planner import PlanningError as JPlanningError  # noqa: E402
from repro_torch import __main__ as tcli  # noqa: E402
from repro_torch.api import Deployment  # noqa: E402
from repro_torch.api import records as trecords  # noqa: E402
from repro_torch.api import registry as treg  # noqa: E402
from repro_torch.core.budget import Scenario  # noqa: E402
from repro_torch.core.planner import PlanningError  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the sweep modules (each package's ``api.sweep`` attribute is the function)
jsweep = importlib.import_module("repro.api.sweep")
tsweep = importlib.import_module("repro_torch.api.sweep")

# the explicit grid: two models, a superpod and a scale-out platform, two
# scenarios, derated and upgraded links, offered-batch caps, int4 experts
EXPLICIT = dict(models=["DeepSeek-V3", "Kimi-K2"], hardware=["H800", "GB200"],
                n_f=range(1, 25), scenarios=["default", "tight-slo"],
                bw_scale=[0.5, 1.0, 1.5], b_cap=[256.0, 1024.0, float("inf")],
                weight_bytes=0.5)
SWEEPS = ["fig4", "dead-zone", "superpod", "bandwidth", "explicit"]


def _run_sweep(mod, reg, name, **kw):
    if name == "explicit":
        return mod.sweep(**EXPLICIT, **kw)
    return mod.sweep(**reg.named_sweep(name), **kw)


def _assert_fields_equal(got, want, dtypes=True):
    """Every field array equal bit for bit (NaN where NaN), same dtype."""
    assert list(got.fields) == list(want.fields) == list(tsweep.FIELDS)
    for name, a in got.fields.items():
        b = want.fields[name]
        assert a.shape == b.shape, name
        assert a.dtype == b.dtype or not dtypes, name
        nan = (a != a) & (b != b) if a.dtype.kind == "f" else False
        assert bool(np.all((a == b) | nan)), name


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    assert treg.list_models() == jreg.list_models()
    assert treg.list_hardware() == jreg.list_hardware()
    assert treg.list_sweeps() == jreg.list_sweeps()
    assert treg.list_routers() == jreg.list_routers()
    assert treg.FIG4_PLATFORMS == jreg.FIG4_PLATFORMS
    for name in jreg.list_sweeps():
        assert treg.named_sweep(name) == jreg.named_sweep(name)
    for name, scen in jreg.SCENARIOS.items():
        assert dataclasses.asdict(treg.resolve_scenario(name)) == \
            dataclasses.asdict(scen)
        assert treg.scenario_name(name) == name
        assert treg.scenario_name(Scenario(**dataclasses.asdict(scen))) == \
            jreg.scenario_name(scen)
    custom = dict(slo_tpot=0.04, l_accept=1.3, t_gap=0.01, n_bo=2)
    assert treg.scenario_name(Scenario(**custom)) == \
        jreg.scenario_name(JScenario(**custom))
    # paper models, CLI arch ids and module names of the executable configs
    from repro import configs as jconfigs
    for name in jreg.list_models() + jconfigs.ARCH_IDS + ["qwen3_8b"]:
        assert dataclasses.asdict(treg.resolve_model(name)) == \
            dataclasses.asdict(jreg.resolve_model(name)), name
    for hw in jreg.list_hardware():
        for bw in (1.0, 0.5, 1.25):
            assert dataclasses.asdict(treg.resolve_hardware(hw, bw)) == \
                dataclasses.asdict(jreg.resolve_hardware(hw, bw)), (hw, bw)


@pytest.mark.parametrize("kind,name", [
    ("model", "DeepSeekV3"), ("model", "zzz"), ("hardware", "GB2OO"),
    ("scenario", "tight_slo"), ("sweep", "dead_zone"),
    ("router", "least_kv")])
def test_registry_errors_match_jax(kind, name):
    """A bad name raises the JAX package's KeyError, known names and
    closest-match suggestion included."""
    fn = {"model": "resolve_model", "hardware": "resolve_hardware",
          "scenario": "resolve_scenario", "sweep": "named_sweep",
          "router": "resolve_router"}[kind]
    with pytest.raises(KeyError) as te:
        getattr(treg, fn)(name)
    with pytest.raises(KeyError) as je:
        getattr(jreg, fn)(name)
    assert te.value.args == je.value.args


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------

def test_sweep_constants_and_tiling_match_jax():
    assert tsweep.FIELDS == jsweep.FIELDS
    assert tsweep.FIELD_ITEMSIZES == jsweep.FIELD_ITEMSIZES
    assert tsweep.BYTES_PER_CELL == jsweep.BYTES_PER_CELL
    assert tsweep.DEFAULT_TILE_POINTS == jsweep.DEFAULT_TILE_POINTS
    for shape, tps in (((6, 10, 4, 4, 6, 96), (1 << 14, 1 << 16)),
                       ((1, 3, 1, 1, 1, 40), (1, 7, 1000)),
                       ((2, 2, 1, 5, 1, 7), (1, 7, 1000))):
        for tp in tps:
            assert tsweep.tile_spans(shape, tp) == jsweep.tile_spans(shape, tp)
    assert tsweep.tile_footprint_bytes((2, 3, 4, 4, 6, 96)) == \
        jsweep.tile_footprint_bytes((2, 3, 4, 4, 6, 96))


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_fields_match_jax(name):
    """Every field of the port's sweep equals JAX's bit for bit, in one
    tile and in tiles of 7 cells; the records and the Fig. 4 ceilings
    (feasible and not) are equal too."""
    want = _run_sweep(jsweep, jreg, name)
    got = _run_sweep(tsweep, treg, name)
    assert got.shape == want.shape
    _assert_fields_equal(got, want)
    _assert_fields_equal(_run_sweep(tsweep, treg, name, tile_points=7), want)
    assert got.records() == want.records()
    for feasible_only in (True, False):
        assert got.ceilings(feasible_only) == want.ceilings(feasible_only)


# A fresh interpreter (no JAX, no torch) evaluates the port's sweeps over a
# forked pool of 2 workers in 7-cell tiles and writes the fields.
WORKER_CODE = """
import sys
import numpy as np
from repro_torch.api import registry, sweep
inf = float("inf")
explicit = {explicit!r}
explicit["n_f"] = range(1, 25)
for name in ("bandwidth", "explicit"):
    params = explicit if name == "explicit" else registry.named_sweep(name)
    res = sweep(**params, tile_points=7, processes=2)
    np.savez(sys.argv[1] + "/" + name + ".npz", **res.fields)
assert "torch" not in sys.modules and "jax" not in sys.modules
"""


def test_sweep_over_worker_processes_matches_jax(tmp_path):
    explicit = dict(EXPLICIT, n_f=None)
    code = WORKER_CODE.format(explicit=explicit)
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    for name in ("bandwidth", "explicit"):
        want = _run_sweep(jsweep, jreg, name)
        with np.load(tmp_path / f"{name}.npz") as z:
            got = dataclasses.replace(want, fields={k: z[k] for k in z.files})
        _assert_fields_equal(got, want)


@pytest.mark.parametrize("grid", [
    dict(models=["DeepSeek-V3", "Step3"], hardware=["H800", "GB200"],
         n_f=range(1, 9)),
    dict(models=["Kimi-K2"], hardware=["H20", "GB300"], n_f=range(1, 7),
         scenarios=["default", "no-mtp"], bw_scale=[0.75, 2.0],
         b_cap=[512.0, float("inf")], weight_bytes=0.5),
], ids=["fp8", "int4-bcap-bw"])
def test_scalar_reference_equals_sweep_and_jax(grid):
    """The per-point loop over ``hfu_point`` equals the vectorized sweep
    bit for bit (its string fields are ``<U16`` in both packages, the
    sweep's bottleneck ``<U12``), and equals JAX's loop."""
    ref = tsweep.scalar_reference(**grid)
    _assert_fields_equal(ref, tsweep.sweep(**grid), dtypes=False)
    _assert_fields_equal(ref, jsweep.scalar_reference(**grid))


def test_records_match_jax(tmp_path):
    res = tsweep.run_named_sweep("dead-zone")
    want = jsweep.run_named_sweep("dead-zone")
    assert res.to_json() == want.to_json()
    path = str(tmp_path / "r.json")
    res.to_json(path)
    assert trecords.load_records(path) == jrecords.load_records(path)
    obj = dict(a=float("nan"), b=np.int64(3), c=(np.bool_(True), 2.5),
               d=np.arange(3), e=np.float32(0.5))
    assert trecords.Record.from_obj(obj) == jrecords.Record.from_obj(obj)
    assert trecords.Record.from_obj(obj).to_json() == \
        jrecords.Record.from_obj(obj).to_json()


# ---------------------------------------------------------------------------
# Deployment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", list(PAPER_MODELS))
def test_deployment_matches_jax(model):
    """Every record of the façade equals JAX's for one paper model on each
    Fig. 4 platform; a planner failure raises the same message."""
    for hw in jreg.FIG4_PLATFORMS:
        t, j = Deployment(model, hw), JDeployment(model, hw)
        assert repr(t) == repr(j)
        for call in (lambda d: d.verdict(), lambda d: d.describe(),
                     lambda d: d.hfu_ceiling(), lambda d: d.hfu_sweep(16),
                     lambda d: d.intensity_sweep(16),
                     lambda d: d.regime_boundaries(),
                     lambda d: d.superpod_closed_form(),
                     lambda d: d.dead_zone(), lambda d: d.stage_budget(),
                     lambda d: d.hfu_point(4, b_cap=512.0),
                     lambda d: d.imbalance_penalty(0.8, 12, 4),
                     lambda d: d.plan(), lambda d: d.rescale(0.8),
                     lambda d: d.plan(n_f=3)):
            try:
                want = call(j)
            except JPlanningError as e:
                with pytest.raises(PlanningError) as te:
                    call(t)
                assert te.value.args == e.args
                continue
            assert call(t) == want
        assert Deployment(model, hw, "tight-slo", bw_scale=0.5).plan() == \
            JDeployment(model, hw, "tight-slo", bw_scale=0.5).plan()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _steady(text: str):
    """The output without the lines that hold wall times."""
    return [ln for ln in text.splitlines()
            if " grid points in " not in ln
            and not ln.startswith(("api_sweep_vectorized",
                                   "api_sweep_scalar_loop",
                                   "api_sweep_speedup"))]


@pytest.mark.parametrize("argv,rc", [
    (["plan", "--model", "DeepSeek-V3", "--hardware", "H800"], 0),
    (["plan", "--model", "DeepSeek-V3", "--hardware", "H100", "--json"], 0),
    (["plan", "--model", "Kimi-K2", "--hardware", "GB200", "--sigma", "0.8"],
     0),
    (["plan", "--model", "qwen3-8b", "--hardware", "H800"], 2),
    (["plan", "--model", "DeepSeek-V3", "--hardware", "H900"], 2),
    (["sweep", "--name", "dead-zone"], 0),
    (["sweep", "--name", "superpod", "--weight-dtype", "int4",
      "--infeasible"], 0),
    (["sweep", "--models", "DeepSeek-V3,Kimi-K2", "--hardware", "H800,GB200",
      "--b-cap", "512,1024", "--bw-scale", "0.5,1", "--n-f-max", "20"], 0),
    (["sweep", "--name", "deadzone"], 2),
    (["sweep", "--models", "DeepSeek-V3"], 2),
    (["bench", "--n-f-max", "4"], 0),
    (["list"], 0),
    (["list", "routers"], 0),
], ids=lambda v: "-".join(v) if isinstance(v, list) else str(v))
def test_cli_matches_jax(argv, rc):
    """The port's command prints what ``python -m repro`` prints (the
    lines with wall times aside) and exits with its code."""
    want = _cli(jcli.main, argv)
    got = _cli(tcli.main, argv)
    assert got[0] == want[0] == rc
    assert _steady(got[1]) == _steady(want[1])
    assert got[2] == want[2]
    if argv[0] == "bench":
        assert "api_sweep_equivalence,0,bit_exact=True;points=192" in got[1]


def test_cli_bench_exits_1_when_the_sweep_diverges(monkeypatch):
    """``bench`` fails when a field of the vectorized sweep differs from
    the scalar loop's (one hfu cell nudged here)."""
    from repro_torch import api
    real = api.sweep

    def nudged(*a, **k):
        res = real(*a, **k)
        res.fields["hfu"].flat[0] += 1e-12
        return res
    monkeypatch.setattr(api, "sweep", nudged)
    rc, out, err = _cli(tcli.main, ["bench", "--n-f-max", "2", "--repeat",
                                    "1"])
    assert rc == 1 and "bit_exact=False" in out
    assert "FAIL: vectorized sweep diverged" in err


ANALYSIS_COMMANDS = """
import sys
from repro_torch.__main__ import main
for argv in (["plan", "--model", "DeepSeek-V3", "--hardware", "H800"],
             ["sweep", "--name", "dead-zone"],
             ["bench", "--n-f-max", "2", "--repeat", "1"],
             ["provision", "--models", "DeepSeek-V3", "--hardware", "H800",
              "--n-f-max", "4", "--scenarios", "default"],
             ["list"]):
    assert main(argv) == 0, argv
bad = sorted(m for m in sys.modules if m == "torch" or m.startswith("torch.")
             or m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
"""


def test_analysis_commands_import_no_torch():
    """``python -m repro_torch plan`` starts without torch (and without JAX
    and the JAX package), and so do ``sweep``, ``bench``, ``provision`` and
    ``list`` run in the same interpreter."""
    env = dict(os.environ, PYTHONPATH=SRC)
    code = ("import runpy, sys\n"
            "sys.argv = ['repro_torch', 'plan', '--model', 'DeepSeek-V3', "
            "'--hardware', 'H800']\n"
            "try:\n"
            "    runpy.run_module('repro_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'torch' not in sys.modules\n"
            "print('torch-free')\n")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "AFD recommended" in res.stdout and "torch-free" in res.stdout
    res = subprocess.run([sys.executable, "-c", ANALYSIS_COMMANDS], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
