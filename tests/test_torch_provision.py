"""The port's provisioning search against the JAX package's, on the CPU:
pricing (vectorized Eq. 16, $/Mtok, the EP baseline), the exact Pareto
frontier, the streamed search on a smoke grid (its ``to_obj()`` and every
verdict JSON-byte-equal to JAX's, at any tiling and over worker
processes), ``recommend``'s verdicts and errors, and ``python -m
repro_torch provision`` against ``python -m repro provision``: output,
exit codes, and with ``--calibrate --device cpu`` the calibration block
and the derated verdicts field for field."""

import contextlib
import dataclasses
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.api import cli as jcli  # noqa: E402
from repro.core import imbalance as jimb  # noqa: E402
from repro.core.modelspec import PAPER_MODELS  # noqa: E402
from repro.provision import pareto as jpareto  # noqa: E402
from repro.provision import pricing as jpricing  # noqa: E402
from repro_torch import __main__ as tcli  # noqa: E402
from repro_torch.api import registry as treg  # noqa: E402
from repro_torch.core import imbalance as timb  # noqa: E402
from repro_torch.provision import (ParetoFrontier, ProvisionGrid,  # noqa: E402
                                   default_grid, ep_baseline, recommend,
                                   search)
from repro_torch.provision import pricing as tpricing  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the JAX package's modules (``repro.provision``'s attributes of these names
# are the functions)
jsearch = importlib.import_module("repro.provision.search")
jrecommend = importlib.import_module("repro.provision.recommend")
# two paper models on a scale-out, a scale-up-only and a superpod platform,
# every named scenario, the stock link and batch-cap axes, 2 slack values
SMOKE = dict(models=["DeepSeek-V3", "Kimi-K2"],
             hardware=["H800", "H100", "GB200"], n_f_max=16)
# the JAX package's provisioning test grid (headline verdicts)
HEADLINE = dict(models=["DeepSeek-V3"], hardware=["H800", "GB200"],
                scenarios=["default"], n_f_max=40, bw_scale=[1.0],
                b_cap=[float("inf")])


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=float)


@pytest.fixture(scope="module")
def smoke():
    return (search(default_grid(**SMOKE)),
            jsearch.search(jsearch.default_grid(**SMOKE)))


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

def test_alpha_afd_array_matches_jax_and_scalar():
    rng = np.random.default_rng(0)
    n_a = rng.integers(1, 600, size=200).astype(float)
    n_f = rng.integers(1, 100, size=200).astype(float)
    for sigma in (0.5, 0.8, 0.95, 0.999, 1.0):
        got = tpricing.alpha_afd_array(sigma, n_a, n_f)
        assert np.array_equal(got, jpricing.alpha_afd_array(sigma, n_a, n_f))
        ref = np.array([timb.alpha_afd(sigma, int(a), int(f))
                        for a, f in zip(n_a, n_f)])
        assert np.array_equal(got, ref)
        assert timb.alpha_ep(sigma, 3.0) == jimb.alpha_ep(sigma, 3.0)
    with pytest.raises(ValueError) as te:
        tpricing.alpha_afd_array(0.0, n_a, n_f)
    with pytest.raises(ValueError) as je:
        jpricing.alpha_afd_array(0.0, n_a, n_f)
    assert te.value.args == je.value.args
    assert np.array_equal(tpricing.nf_quantization_threshold_array(n_f),
                          jpricing.nf_quantization_threshold_array(n_f))


def test_pricing_matches_jax():
    """FFN FLOPs per token, $/Mtok (zero rate → inf) and the large-EP
    baseline (with and without a price override) for every paper model on
    every platform."""
    for name in treg.list_models():
        m = treg.resolve_model(name)
        assert tpricing.ffn_flops_per_token(m) == \
            jpricing.ffn_flops_per_token(m)
    for args in ((10, 8, 3.0, 0.0, 1e15, 4, 1e9), (10, 8, 3.0, 0.5, 1e15, 4,
                                                   1e9)):
        assert tpricing.cost_per_mtoken(*args) == \
            jpricing.cost_per_mtoken(*args)
    assert tpricing.cost_per_mtoken(10, 8, 3.0, 0.0, 1e15, 4, 1e9) == np.inf
    hfu = np.array([0.0, 0.1, 0.5])
    assert np.array_equal(
        tpricing.cost_per_mtoken(np.array([5.0, 9.0, 12.0]), 8, 2.5, hfu,
                                 1e15, np.array([1.0, 2.0, 4.0]), 1e9),
        jpricing.cost_per_mtoken(np.array([5.0, 9.0, 12.0]), 8, 2.5, hfu,
                                 1e15, np.array([1.0, 2.0, 4.0]), 1e9))
    for model in PAPER_MODELS:
        for hw in treg.list_hardware():
            for sigma, usd in ((0.8, None), (1.0, None), (0.8, 6.0)):
                got = ep_baseline(model, hw, sigma, cost_per_device_hour=usd)
                want = jpricing.ep_baseline(model, hw, sigma,
                                            cost_per_device_hour=usd)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# Pareto frontier
# ---------------------------------------------------------------------------

def _frontier_state(f):
    return (f.sorted_entries(), f.offered, f.accepted, f.evicted,
            f.values.tolist())


def test_pareto_frontier_matches_jax():
    """The JAX package's frontier cases on both packages: a batch with
    exact ties against per-point offers, weak dominance and eviction, and
    the chunked dominance mask against brute force."""
    rng = np.random.default_rng(1)
    pts = rng.random((5000, 3))
    pts[rng.integers(0, 5000, 500)] = pts[rng.integers(0, 5000, 500)]
    states = []
    for cls in (ParetoFrontier, jpareto.ParetoFrontier):
        a = cls(3)
        a.offer_batch(pts, lambda i: int(i))
        b = cls(3)
        for i in np.lexsort((pts[:, 2], pts[:, 1], pts[:, 0]))[::-1]:
            b.offer(pts[i], int(i))
        assert {m for m, _ in a.sorted_entries()} == \
            {m for m, _ in b.sorted_entries()}
        states.append((_frontier_state(a), _frontier_state(b)))
    assert states[0] == states[1]

    for cls in (ParetoFrontier, jpareto.ParetoFrontier):
        f = cls(2)
        assert f.offer([1.0, 1.0], "a")
        assert not f.offer([1.0, 1.0], "dup")          # exact tie: first wins
        assert not f.offer([0.5, 1.0], "dominated")
        assert f.offer([2.0, 2.0], "b")                # evicts "a"
        assert f.evicted == 1 and f.sorted_entries() == [((2.0, 2.0), "b")]

    rng = np.random.default_rng(2)
    base, cand = rng.random((300, 3)), rng.random((400, 3))
    masks = []
    for cls in (ParetoFrontier, jpareto.ParetoFrontier):
        f = cls(3)
        f.offer_batch(base, lambda i: i)
        masks.append(f.dominated_mask(cand, block=64, f_chunk=16))
    brute = np.array([(f.values >= c).all(axis=1).any() for c in cand])
    assert np.array_equal(masks[0], brute) and np.array_equal(masks[1], brute)
    for cls in (ParetoFrontier, jpareto.ParetoFrontier):
        with pytest.raises(ValueError):
            cls(0)


# ---------------------------------------------------------------------------
# search and verdicts
# ---------------------------------------------------------------------------

def test_default_grid_matches_jax():
    got, want = default_grid(**SMOKE), jsearch.default_grid(**SMOKE)
    assert isinstance(got, ProvisionGrid)
    assert got.points == want.points == 2 * 3 * 4 * 4 * 6 * 16 * 2
    assert got.spec.shape == want.spec.shape
    assert (got.n_a_slack, got.sigma, got.ep_lambda, got.cost_overrides) == \
        (want.n_a_slack, want.sigma, want.ep_lambda, want.cost_overrides)
    stock, jstock = default_grid(), jsearch.default_grid()
    assert stock.points == jstock.points == 1_105_920
    assert stock.spec.scenario_names == jstock.spec.scenario_names
    assert [h.name for h in stock.spec.hardware] == \
        [h.name for h in jstock.spec.hardware]
    for kw in (dict(models=["no-such-model"]), dict(n_f_max=0),
               dict(n_a_slack=[-1])):
        with pytest.raises((KeyError, ValueError)) as te:
            default_grid(**kw)
        with pytest.raises((KeyError, ValueError)) as je:
            jsearch.default_grid(**kw)
        assert te.value.args == je.value.args


@pytest.mark.parametrize("tile_points", [None, 97])
def test_search_is_json_byte_equal_to_jax(smoke, tile_points):
    """``search(…).to_obj()`` equals JAX's byte for byte in JSON, in one
    tile and in 97-cell tiles, and every verdict (each model × platform ×
    scenario, plain and derated) does too."""
    got, want = smoke
    if tile_points is not None:
        grid = default_grid(**SMOKE)
        got = search(grid, tile_points=tile_points)
        want = jsearch.search(jsearch.default_grid(**SMOKE),
                              tile_points=tile_points)
        assert got.tiles == want.tiles > 1
    assert _dump(got.to_obj()) == _dump(want.to_obj())
    assert got.eligible + sum(got.counters.values()) == got.points
    for model in SMOKE["models"]:
        for hw in SMOKE["hardware"]:
            for scen in ("default", "tight-slo", "relaxed-slo", "no-mtp"):
                for scale in (1.0, 0.5, 3.289262350794032e-08):
                    assert _dump(recommend(got, model, hw, scen,
                                           scale).to_obj()) == \
                        _dump(jrecommend.recommend(want, model, hw, scen,
                                                   scale).to_obj())


def test_headline_verdicts_match_jax():
    """The paper's two headline classifications on the JAX package's test
    grid: DeepSeek-V3 stays with EP on H800 (the §3.2 dead zone) and
    deploys AFD on the GB200 superpod, with JAX's margins."""
    got = search(default_grid(**HEADLINE))
    want = jsearch.search(jsearch.default_grid(**HEADLINE))
    h800 = recommend(got, "DeepSeek-V3", "H800")
    gb200 = recommend(got, "DeepSeek-V3", "GB200")
    assert h800.decision == "stay-ep" and "dead zone" in h800.reason
    assert gb200.decision == "deploy-afd" and "superpod" in gb200.reason
    for v in (h800, gb200):
        assert v.to_obj() == jrecommend.recommend(want, v.model,
                                                  v.hardware).to_obj()


@pytest.mark.parametrize("args", [("DeepSeek-V3", "H200"),
                                  ("DeepSeek-V3", "H800", "default", 0.0),
                                  ("DeepSeek-V3", "H800", "default", 1.6)],
                         ids=["not-in-grid", "scale-0", "scale-1.6"])
def test_recommend_errors_match_jax(smoke, args):
    got, want = smoke
    with pytest.raises((KeyError, ValueError)) as te:
        recommend(got, *args)
    with pytest.raises((KeyError, ValueError)) as je:
        jrecommend.recommend(want, *args)
    assert type(te.value) is type(je.value)
    assert te.value.args == je.value.args


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _no_wall(text: str):
    return [ln for ln in text.splitlines() if not ln.startswith(
        "# provision: ")]


PROVISION_ARGS = ["provision", "--models", "DeepSeek-V3",
                  "--hardware", "H800,GB200", "--n-f-max", "40"]
SMOKE_ARGS = ["--models", "DeepSeek-V3,Kimi-K2", "--hardware",
              "H800,H100,GB200", "--n-f-max", "16"]


@pytest.mark.parametrize("argv,rc", [
    (PROVISION_ARGS + ["--json", "-"], 0),
    (PROVISION_ARGS + ["--top", "3", "--cost", "GB200=6.5", "--sigma", "0.9",
                       "--target", "DeepSeek-V3:H800:no-mtp",
                       "--target", "DeepSeek-V3:GB200"], 0),
    (["provision", "--models", "Kimi-K2", "--hardware", "H100,B200",
      "--n-f-max", "12", "--weight-dtype", "int4", "--bw-scale", "1,2",
      "--b-cap", "inf,512", "--n-a-slack", "0,2", "--scenario", "no-mtp",
      "--lambda-ep", "2"], 0),
    (["provision", "--models", "DeepSeek-V3", "--hardware", "H800",
      "--scenarios", "tight-slo", "--n-f-max", "1"], 3),
    (PROVISION_ARGS + ["--cost", "H800"], 2),
    (PROVISION_ARGS + ["--target", "DeepSeek-V3"], 2),
    (["provision", "--models", "DeepSeek-V9"], 2),
    (["provision", "--hardware", "H900"], 2),
], ids=["json", "targets-costs", "int4-axes", "empty-frontier", "bad-cost",
        "bad-target", "bad-model", "bad-hardware"])
def test_cli_provision_matches_jax(argv, rc):
    """The port's ``provision`` prints what ``python -m repro provision``
    prints (its JSON document without ``wall_s``; the text without the
    header line that holds the wall time) and exits with its code: 3 when
    no point is eligible, 2 on a bad argument."""
    want = _cli(jcli.main, argv)
    got = _cli(tcli.main, argv)
    assert got[0] == want[0] == rc
    assert got[2] == want[2]
    if "-" in argv:
        tdoc, jdoc = json.loads(got[1]), json.loads(want[1])
        assert tdoc.pop("wall_s") >= 0 and jdoc.pop("wall_s") >= 0
        assert _dump(tdoc) == _dump(jdoc)
        assert tdoc["calibration"] is None
    else:
        assert _no_wall(got[1]) == _no_wall(want[1])


def test_cli_provision_over_worker_processes_matches_jax(tmp_path):
    """``--processes 2`` in a fresh interpreter (the pool forks) writes
    the document of JAX's single process at the same 500-cell tiles,
    ``wall_s`` aside."""
    argv = ["provision", *SMOKE_ARGS, "--tile-points", "500"]
    path = tmp_path / "port.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch", *argv, "--processes", "2",
         "--json", str(path)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    rc, out, _ = _cli(jcli.main, argv + ["--json", "-"])
    assert rc == 0
    tdoc, jdoc = json.loads(path.read_text()), json.loads(out)
    tdoc.pop("wall_s"), jdoc.pop("wall_s")
    assert tdoc["result"]["tiles"] > 1
    assert _dump(tdoc) == _dump(jdoc)


def test_cli_provision_calibrate_matches_jax():
    """``provision --calibrate --device cpu``: the port's calibration block
    equals JAX's ``provision --calibrate`` field for field, and every
    verdict carries its scale as the derate, as JAX's do."""
    argv = ["provision", *SMOKE_ARGS, "--calibrate", "--json", "-"]
    jrc, jout, _ = _cli(jcli.main, argv)
    trc, tout, _ = _cli(tcli.main, argv + ["--device", "cpu"])
    assert jrc == trc == 0
    tdoc, jdoc = json.loads(tout), json.loads(jout)
    tdoc.pop("wall_s"), jdoc.pop("wall_s")
    assert tdoc["calibration"] == jdoc["calibration"]
    assert tdoc["calibration"]["windows"] == 4
    scale = tdoc["calibration"]["scale"]
    assert 0 < scale <= 1
    assert [v["calibration_scale"] for v in tdoc["verdicts"]] == \
        [scale] * len(tdoc["verdicts"]) == [scale] * 6
    assert _dump(tdoc) == _dump(jdoc)
