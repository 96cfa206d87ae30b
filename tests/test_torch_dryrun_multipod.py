"""The multi-pod dry-run (``repro_torch.launch.dryrun`` and ``.report``)
against the JAX package's.

Device 0's program runs on fake tensors over a ``fake`` process group,
created and destroyed around each case (``launch.mesh.fake_world``), so
no default group outlives a test. JAX's tiny cells (``tests/
test_multidevice.py``: a (2, 4) mesh, granite-moe's smoke config, train /
prefill / decode) compile in a subprocess on 8 forced host devices, and
their argument bytes are held to the port's exactly."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.launch import report as jreport  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import hlo_analysis as hlo  # noqa: E402
from repro_torch.launch import mesh as msh  # noqa: E402
from repro_torch.launch import report as treport  # noqa: E402
from repro_torch.launch import shapes as shp  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCH = "granite-moe-1b-a400m"
# JAX's tiny cells: (kind, rules, split-KV override, sequence), batch 8
TINY = (("train", "TRAIN_RULES", False, 32),
        ("decode", "SERVE_RULES", True, 64),
        ("prefill", "SERVE_RULES", False, 64))

JAX_TINY = """
import dataclasses, json
import jax
from repro import configs
from repro.launch import dryrun as dr, shapes as shp
from repro.parallel import sharding as shd
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = dataclasses.replace(configs.get_smoke_config({arch!r}), remat=True)
out = {{}}
for kind, rules, splitkv, seq in {tiny!r}:
    spec = shp.ShapeSpec("tiny_" + kind, kind, seq, 8)
    epc = dr._ep_config(cfg, spec, mesh)
    c, _, _ = dr._compile_variant(cfg, spec, mesh, getattr(shd, rules), epc,
                                  splitkv, {arch!r})
    out[kind] = c.memory_analysis().argument_size_in_bytes
print("ARGS", json.dumps(out))
""".format(arch=ARCH, tiny=TINY)


@pytest.fixture
def mesh8():
    with msh.fake_world(8):
        yield msh.device_mesh(msh.make_mesh((2, 4), ("data", "model")))


def _tiny(kind, seq, n_layers=None):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), remat=True)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, shp.ShapeSpec("tiny_" + kind, kind, seq, 8)


def test_tiny_cells_argument_bytes_equal_jax(mesh8):
    """Train, decode and prefill on the (2, 4) mesh: the local blocks of
    the program's inputs equal XLA's ``argument_size_in_bytes`` exactly;
    the memory and cost fields are filled."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_TINY)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    got = {}
    for kind, rules, splitkv, seq in TINY:
        cfg, spec = _tiny(kind, seq)
        epc = dr._ep_config(cfg, spec, mesh8)
        mem = dr._run_variant(cfg, spec, mesh8, getattr(shd, rules), epc,
                              splitkv, ARCH, memory=True)
        cost = dr._run_variant(cfg, spec, mesh8, getattr(shd, rules), epc,
                               splitkv, ARCH)
        assert mem["temp_bytes_dev"] > 0 and mem["output_bytes_dev"] > 0
        assert cost["cost"]["flops"] > 0 and cost["cost"]["bytes accessed"] > 0
        assert cost["collectives"].total_link > 0
        got[kind] = mem["argument_bytes_dev"]
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log
    want = json.loads(next(line for line in log.splitlines()
                           if line.startswith("ARGS "))[5:])
    assert got == want


def test_two_probe_extrapolation_equals_full_depth(mesh8):
    """Four identical MoE layers: the cost of the 1- and 2-period probes,
    extrapolated as JAX does, equals the full program's count."""
    cfg, spec = _tiny("train", 32, n_layers=4)
    assert cfg.layer_plan().n_periods == 4
    epc = dr._ep_config(cfg, spec, mesh8)
    runs = {n: dr._run_variant(dr._probe_cfg(cfg, n), spec, mesh8,
                               shd.TRAIN_RULES, epc, False, ARCH)
            for n in (1, 2, 4)}
    cost, coll = dr._extrapolate(*((runs[n]["cost"], runs[n]["collectives"])
                                   for n in (1, 2)), 4)
    full = runs[4]
    assert cost["flops"] == pytest.approx(full["cost"]["flops"], rel=1e-12)
    assert cost["bytes accessed"] == pytest.approx(
        full["cost"]["bytes accessed"], rel=1e-12)
    assert coll.counts == full["collectives"].counts
    assert coll.link_bytes == full["collectives"].link_bytes


@pytest.mark.parametrize("variant", ["donate", "etp", "qkf32", "ga4", "sp"])
def test_levers_on_tiny_cells(mesh8, variant):
    """Each lever runs on a tiny cell it applies to: ``donate`` writes the
    cache in place (its alias bytes are the cache's block), ``etp`` is the
    weight-stationary decode, ``qkf32`` float32 scores, ``ga4`` four
    microbatches, ``sp`` the sequence split over "model" at the
    activation annotations (``TRAIN_RULES_SP`` installed around the step:
    other collectives, the same argument bytes)."""
    kind = "train" if variant in ("ga4", "sp") else "decode"
    cfg, spec = _tiny(kind, 32 if kind == "train" else 64)
    base_rules = shd.TRAIN_RULES if kind == "train" else shd.SERVE_RULES
    rules = shd.TRAIN_RULES_SP if variant == "sp" else base_rules
    epc = dr._ep_config(cfg, spec, mesh8)
    if variant == "etp":
        epc = dataclasses.replace(epc, etp=True)
    kw = dict(donate_cache=variant == "donate", qk_f32=variant == "qkf32",
              grad_accum=4 if variant == "ga4" else 1)
    base = dr._run_variant(cfg, spec, mesh8, base_rules, dr._ep_config(
        cfg, spec, mesh8), True, ARCH, memory=True)
    mem = dr._run_variant(cfg, spec, mesh8, rules, epc, True, ARCH,
                          memory=True, **kw)
    cost = dr._run_variant(cfg, spec, mesh8, rules, epc, True, ARCH, **kw)
    assert cost["cost"]["flops"] > 0
    if variant == "sp":
        base_cost = dr._run_variant(cfg, spec, mesh8, base_rules, epc, True,
                                    ARCH)
        assert cost["collectives"].counts != base_cost["collectives"].counts
        assert cost["collectives"].counts["reduce-scatter"] > \
            base_cost["collectives"].counts["reduce-scatter"]
    if variant == "donate":
        model = dr.Model(cfg, device="cpu")
        cache = shp.cache_specs(model, spec)
        block = shd.block_bytes(cache, shd.cache_shardings(
            cache, mesh8, rules, cfg), mesh8)
        assert mem["alias_bytes_dev"] == block > 0
        assert base["alias_bytes_dev"] == 0
    assert mem["argument_bytes_dev"] == base["argument_bytes_dev"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_mamba_mixer_splits_its_heads(mesh8, kind):
    """A tiny mamba2 cell (8 SSD heads over model = 4): its record no
    longer lists the mixer as replicated, and the SSD's priced FLOPs per
    device are the whole-head run's (the same cell with "heads" mapped to
    no axis) over 4, within 1%; the argument bytes do not move."""
    from unittest import mock
    from repro_torch.models import mamba2
    arch = "mamba2-2.7b"
    cfg = tconfigs.get_smoke_config(arch)
    spec = shp.ShapeSpec("tiny_" + kind, kind, 64, 8)
    whole = dataclasses.replace(shd.SERVE_RULES, heads=None)
    assert dr._replicated_pieces(cfg, spec, mesh8, shd.SERVE_RULES,
                                 None) == []
    assert dr._replicated_pieces(cfg, spec, mesh8, whole, None) == [
        "Mamba mixer (8 SSD heads whole on each of model=4)"]
    name = "_prefill_scan" if kind == "prefill" else "_decode_scan"
    scan = getattr(mamba2, name)
    flops = {}

    def counted(*args):             # the SSD's share of the open counter
        if hlo._OPEN is None:       # the memory run
            return scan(*args)
        before = hlo._OPEN.flops
        out = scan(*args)
        flops[rules_name] = flops.get(rules_name, 0) + hlo._OPEN.flops - before
        return out
    args = {}
    with mock.patch.object(mamba2, name, counted):
        for rules_name, rules in (("split", shd.SERVE_RULES),
                                  ("whole", whole)):
            dr._run_variant(cfg, spec, mesh8, rules, None, False, arch)
            args[rules_name] = dr._run_variant(
                cfg, spec, mesh8, rules, None, False, arch,
                memory=True)["argument_bytes_dev"]
    assert flops["whole"] > 0
    assert flops["split"] == pytest.approx(flops["whole"] / 4, rel=1e-2)
    if kind == "prefill":       # the cache's heads follow the rules
        assert args["split"] == args["whole"]


def test_kernels_are_priced_by_their_bound_on_fake_tensors(mesh8):
    """The decode cell's grouped GEMM reads group sizes that fake tensors
    do not hold: it is priced by its bound and named in ``bounded``."""
    cfg, spec = _tiny("decode", 64)
    epc = dr._ep_config(cfg, spec, mesh8)
    run = dr._run_variant(cfg, spec, mesh8, shd.SERVE_RULES, epc, True, ARCH)
    assert run["bounded"] == ["grouped_gemm"]


def test_lower_cell_record_and_cli(tmp_path):
    """One production cell end to end: JAX's record keys (``price_s`` in
    place of ``lower_s`` / ``compile_s``), both pricings; the CLI writes
    the results file and skips finished cells."""
    jax_keys = {"arch", "shape", "mesh", "kind", "variant", "status", "rules",
                "chips", "memory", "cost", "collectives", "roofline"}
    recs = {hw: dr.lower_cell("qwen1.5-0.5b", "decode_32k", False,
                              hardware=hw) for hw in ("TPUv5e", "H100")}
    for hw, rec in recs.items():
        assert jax_keys <= set(rec) and rec["status"] == "ok"
        assert rec["hardware"] == hw and rec["chips"] == 256
        assert {"argument_bytes_dev", "output_bytes_dev", "temp_bytes_dev",
                "alias_bytes_dev", "peak_bytes_dev", "fits_v5e_16g",
                "fits"} <= set(rec["memory"])
        assert rec["memory"]["fits"]["hardware"] == hw
    assert recs["TPUv5e"]["cost"] == recs["H100"]["cost"]
    sp = dr.lower_cell("qwen1.5-0.5b", "decode_32k", False, variant="sp")
    assert sp["status"] == "ok" and sp["variant"] == "sp" and "sp" not in sp
    assert sp["memory"]["argument_bytes_dev"] == \
        recs["TPUv5e"]["memory"]["argument_bytes_dev"]
    assert recs["H100"]["roofline"]["t_memory"] < \
        recs["TPUv5e"]["roofline"]["t_memory"]
    out = tmp_path / "dryrun.json"
    args = ["--arch", "qwen1.5-0.5b", "--shape", "long_500k", "--mesh",
            "both", "--out", str(out)]
    assert dr.main(args) == 0
    cells = dr.load_results(str(out))["cells"]
    assert {c["status"] for c in cells.values()} == {"skipped"}
    assert set(cells) == {"qwen1.5-0.5b|long_500k|single",
                          "qwen1.5-0.5b|long_500k|multi"}
    assert dr.cell_key("a", "s", "multi", "serve", False, "etp") == \
        "a|s|multi:serve:nosplitkv:etp"


def _records():
    """Records of the results file's layout, for the report."""
    cells = {}
    for i, (arch, shape) in enumerate([(a, s) for a in ("kimi-k2-1t-a32b",
                                                        "granite-moe-1b-a400m",
                                                        "qwen3-8b")
                                       for s in shp.SHAPES]):
        for mesh in ("single", "multi"):
            key = f"{arch}|{shape}|{mesh}"
            if shape == "long_500k" and arch == "qwen3-8b":
                cells[key] = {"arch": arch, "shape": shape, "mesh": mesh,
                              "status": "skipped", "reason": "quadratic"}
                continue
            if shape == "prefill_32k" and arch == "granite-moe-1b-a400m":
                cells[key] = {"arch": arch, "shape": shape, "mesh": mesh,
                              "status": "error", "error": "Boom: " + "x" * 80}
                continue
            f = (i + 1) * (2 if mesh == "multi" else 1)
            cells[key] = {
                "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "memory": {"peak_bytes_dev": 3e9 * f, "fits_v5e_16g": f < 5},
                "collectives": {"counts": {"all-gather": i, "all-reduce": 2,
                                           "reduce-scatter": 0,
                                           "all-to-all": f,
                                           "collective-permute": 0}},
                "roofline": {"t_compute": 1e-4 * f, "t_memory": 3e-3 / f,
                             "t_collective": 2e-5 * i * f,
                             "dominant": "memory",
                             "compute_fraction": 0.01 * f,
                             "useful_flops_ratio": 0.5 * f,
                             "hint": f"hint {i}"}}
            if i % 3 == 0:
                cells[key]["compile_s"] = 1.5 * i
    cells["kimi-k2-1t-a32b|decode_32k|single:etp"] = dict(
        cells["kimi-k2-1t-a32b|decode_32k|single"], variant="etp")
    return cells


def test_report_prints_jax_s_lines(tmp_path, capsys):
    cells = _records()
    for mesh in ("single", "multi"):
        assert treport.roofline_table(cells, mesh) == \
            jreport.roofline_table(cells, mesh)
    assert treport.dryrun_table(cells) == jreport.dryrun_table(cells)
    assert treport.pick_hillclimb(cells) == jreport.pick_hillclimb(cells)
    for x in (0, 3e-7, 2e-3, 4.5):
        assert treport.fmt_s(x) == jreport.fmt_s(x)
    for x in (1e3, 2e6, 3e9):
        assert treport.fmt_b(x) == jreport.fmt_b(x)
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps({"cells": cells}))
    outs = []
    for mod in (jreport, treport):
        argv = sys.argv
        sys.argv = ["report", str(path)]
        try:
            mod.main()
        finally:
            sys.argv = argv
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Hillclimb candidates" in outs[1]
    assert treport.load(str(path)) == cells


def test_no_default_group_after_pricing():
    import torch.distributed as dist
    with msh.fake_world(256):
        assert dist.get_world_size() == 256
        with pytest.raises(RuntimeError, match="already initialized"):
            with msh.fake_world(8):
                pass
    assert not dist.is_initialized()


def test_pricing_names_the_hardware():
    assert hlo.get_pricing("H100").peak_flops == 989e12
    assert "TPUv5e" in hlo.PRICING
