"""The harness on the CPU: what it may import, what it finds by name, the
contract's shape of BENCHMARK.json, and runs of tiny cells with the timed
path broken underneath, each of which has to come out not correct."""

from __future__ import annotations

import ast
import json
import re
import types
from pathlib import Path

import pytest
import torch

from afdbench import check as chk
from afdbench import harness, run, weights
from afdbench.tests import tiny

ROOT = tiny.ROOT
BENCH = ROOT / "afdbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (absolute)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): sorted(
        set(_imports(p)) & {"jax", "jaxlib", "flax", "repro"})
        for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}
    # compared whole: the program's own name begins with the JAX package's
    assert "repro_torch" in set(_imports(BENCH / "harness.py"))


def test_reference_imports_nothing_of_the_program():
    """Every reference file and the weights it reads, nor anything of
    ``afdbench`` they import."""
    todo = list((BENCH / "reference").rglob("*.py")) + [BENCH / "weights.py"]
    seen = set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        assert "repro_torch" not in set(_imports(p)), p
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module.split(".")[0] == "afdbench":
                base = ROOT.joinpath(*node.module.split("."))
                todo += [f for f in [base.with_suffix(".py")]
                         + [base / f"{a.name}.py" for a in node.names]
                         if f.is_file()]
    assert BENCH / "work.py" in seen


def test_nothing_reads_the_jax_benchmarks_folder():
    jax_folder = "benchmarks" + "/"
    for p in BENCH.rglob("*.py"):
        assert "benchmarks" not in set(_imports(p)), p
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert jax_folder not in node.value, p


def test_benchmark_json_keeps_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["afdbench"] and 1 <= b["run_seconds"] <= 51
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "afdbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "checks" / f"{w['name']}.json").is_file()
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        reader = harness.load_reader(ROOT, m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], m["moves"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", sorted(
    p.name[:-3] for p in (BENCH / "metrics").glob("*.over.py")))
def test_an_over_reader_reads_what_its_base_reads(name):
    """A metric of the cell held past capacity reads as the reader it is
    named after, and only the end-to-end metric it moves differs."""
    over = harness.load_reader(ROOT, name)
    base = harness.load_reader(ROOT, name[:-len(".over")])
    t = harness.TraceData(
        arch=tiny.CONFIGS["tiny-moe"]["port"], span_s=2.0,
        walls={"engine.tick": [0.09, 0.1], "runtime.prefill": [0.07]},
        prefill_chunks=[(512, 0)], decode_contexts=[300] * 96,
        queue_wait_p95_s=1.0, window_s=6.0, ticks=2, calls=[],
        profile={"busy_s": 1.0})
    assert over.read(t) is not None and over.read(t) == base.read(t)
    assert (over.LAYER, over.UNIT) == (base.LAYER, base.UNIT)
    assert over.MOVES == "tokens_per_s" != base.MOVES


@pytest.mark.parametrize("limits, ok, names", [
    ({"mean_gap": {"limit": 0.002}}, True, ["mean_logit_gap"]),
    ({"p99_gap": {"limit": 0.04}}, False, ["p99_logit_gap"]),
    ({"mean_gap": {"limit": 0.002}, "p99_gap": {"limit": 0.09}}, True,
     ["mean_logit_gap", "p99_logit_gap"]),
    ({"mean_gap": {"limit": 0.0005}, "p99_gap": {"limit": 0.09}}, False,
     ["mean_logit_gap", "p99_logit_gap"])])
def test_judge_holds_each_gap_the_check_file_names(limits, ok, names):
    reading = {"mean_gap": 0.001, "p99_gap": 0.05, "tokens": 200}
    got, checks = chk.judge(reading, dict(limits, min_tokens=150))
    assert got is ok
    assert [c[0] for c in checks] == names + ["served_tokens_compared"]
    with pytest.raises(ValueError):
        chk.judge(reading, {"min_tokens": 150})


def test_mixes_hold_their_longest_requests():
    for p in (BENCH / "traffic").glob("*.json"):
        mix = harness.tr.load_mix(p)
        assert mix.max_len == (mix.prompt_len.max_len
                               + mix.output_len.max_len), p


def test_files_added_in_a_copy_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    cell = harness.load_cell(root, "tiny-moe-cell")
    assert cell.config["name"] == "tiny-moe" and cell.mix.name == "tiny"
    assert "test.ticks" in [m["name"] for m in cell.per_layer]
    assert harness.load_reader(root, "test.ticks").UNIT == "ticks"
    with pytest.raises(harness.UnknownWorkload, match="tiny-moe-cell"):
        harness.load_cell(root, "no-such-cell")


def test_unknown_workload_exits_2_listing_the_cells(capsys):
    assert run.main(["--workload", "no-such-cell", "--seed", "1",
                     "--seconds", "1"]) == 2
    err = capsys.readouterr().err
    assert "granite-afd-chat" in err and "jamba-afd-chat" in err


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_tiny_run_is_correct_and_traced(tmp_path, cell):
    root = tiny.make_root(tmp_path)
    out = harness.run_cell(root, cell, seed=2**31 + 11, seconds=1.0,
                           trace=False, device="cpu")
    rec = out.record
    assert rec["correct"] and rec["attempted"] > 0 and rec["failed"] == 0
    # the end-to-end metrics that list no cells are every cell's
    assert set(rec["metrics"]) == {"setup_s", "tokens_per_s"}
    assert list(rec)[-1] == "checks"
    traced = harness.run_cell(root, cell, seed=2**31 + 12, seconds=2.0,
                              trace=True, device="cpu")
    # device readers read nothing off the card
    assert "test.ticks" in traced.record["metrics"]
    assert "device.idle_frac" not in traced.record["metrics"]
    # span walls come from the part before the profiler, ticks after it
    t = traced.trace
    assert t.span_s > 0 and t.walls["engine.tick"] and t.ticks > 0
    assert t.window_s > 0 and sum(t.walls["engine.tick"]) <= t.span_s


def test_the_check_samples_the_windows_requests():
    def req(rid, stamps):
        return harness.Req(rid, 0.0, 0.0, 4, len(stamps), stamps=stamps)
    reqs = {0: req(0, [1.0, 2.0]), 1: req(1, [2.0, 5.0]),
            2: req(2, [10.0, 11.0]), 3: req(3, [4.0])}
    done = [types.SimpleNamespace(rid=i) for i in (0, 1, 2)]
    res = harness.LoopResult(reqs, 3.0, 9.0, 3.0, 9.0, 12.0, 9, done)
    assert [r.rid for r in harness.window_served(res)] == [1]


def test_a_short_sample_is_not_correct(tmp_path):
    root = tiny.make_root(tmp_path)
    cell = tiny.CELLS[0]
    path = root / "afdbench" / "checks" / f"{cell}.json"
    limits = json.loads(path.read_text())
    limits["min_tokens"] = 10**6
    path.write_text(json.dumps(limits))
    out = harness.run_cell(root, cell, seed=2**31 + 13, seconds=1.0,
                           trace=False, device="cpu")
    assert out.record["correct"] is False
    assert out.record["checks"]["served_tokens_compared"]["limit"] == 10**6


def test_every_seed_offers_the_window_the_same_requests():
    mix = harness.tr.load_mix(BENCH / "traffic" / "granite-chat.json")
    block_s = mix.block / mix.rate

    def window(seed):
        ev = [e for e in harness.tr.make_trace(mix, seed, 4 * block_s)
              if block_s <= e.t < 3 * block_s]
        return (len(ev), sorted(e.prompt_len for e in ev),
                sorted(e.max_new_tokens for e in ev))
    first = window(2**31 + 41)
    assert first[0] == 2 * mix.block
    assert window(7) == first and window(2**40 + 3) == first


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_fails_the_limit(tmp_path, cell):
    """The reference in float8 in the program's place, judged as a run
    judges the program, is not correct; the program is."""
    root = tiny.make_root(tmp_path)
    c = harness.load_cell(root, cell)
    out = harness.run_cell(root, cell, seed=21, seconds=1.0, trace=False,
                           device="cpu", check=False)
    params = weights.make_params(c.arch, 21, torch.float32,
                                 torch.device("cpu"))
    smp = chk.sample(out.served, out.prompt_lens, 21, 40)
    got = chk.control_gap(c.arch, params, smp, c.arch["vocab_size"],
                          torch.device("cpu"))
    assert chk.judge(got["program"], c.check)[0] is True
    ok, checks = chk.judge(got, c.check)
    assert ok is False and checks[0][1] > tiny.LIMIT


def _token_altered(orig):
    def step(self, micro_batches, n_bo=3):
        return [(lg.roll(1, dims=-1), c, p)
                for lg, c, p in orig(self, micro_batches, n_bo)]
    return step


def _state_unchanged(orig):
    def step(self, micro_batches, n_bo=3):
        outs = orig(self, micro_batches, n_bo)
        return [(lg, caches, pos) for (lg, _, _), (_, caches, pos)
                in zip(outs, micro_batches)]
    return step


def _half_batch(orig):
    def step(self, micro_batches, n_bo=3):
        outs = []
        for lg, c, p in orig(self, micro_batches, n_bo):
            lg = lg.clone()
            lg[lg.shape[0] // 2:] = 0.0
            outs.append((lg, c, p))
        return outs
    return step


def _no_exchange(orig):
    def cycle(self, lp, f_shards, x):
        return x
    return cycle


FAULTS = {"token_altered": ("decode_step_3bo", _token_altered),
          "state_unchanged": ("decode_step_3bo", _state_unchanged),
          "half_batch": ("decode_step_3bo", _half_batch),
          "no_exchange": ("_moe_cycle", _no_exchange)}


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    from repro_torch.parallel.afd import AFDRuntime
    root = tiny.make_root(tmp_path)
    name, make = FAULTS[fault]
    monkeypatch.setattr(AFDRuntime, name, make(getattr(AFDRuntime, name)))
    out = harness.run_cell(root, cell, seed=2**31 + 31, seconds=1.0,
                           trace=False, device="cpu")
    assert out.record["correct"] is False, out.notes
