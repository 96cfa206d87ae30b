"""The readers of the program's own spans (``afdbench.program`` and its six
readers in ``afdbench/metrics/``) on tiny traced runs on the CPU, with the
program's tracer set over the traced part by ``program.wired``."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from afdbench import harness, program
from afdbench.tests import tiny

READERS = ("engine.tick_self_ms", "engine.syncs_per_tick",
           "runtime.a_role_ms", "runtime.f_role_ms",
           "runtime.mamba_chunk_ms", "host.gc_ms_per_tick")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch import trace
    root = tiny.make_root(tmp_path_factory.mktemp("root"))
    out = {}
    with program.wired():
        for seed, cell in enumerate(tiny.CELLS):
            out[cell] = harness.run_cell(root, cell, seed=2**31 + 41 + seed,
                                         seconds=2.0, trace=True,
                                         device="cpu").trace
    assert trace._TRACER is None
    return root, out


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_a_finite_value(runs, cell, name):
    root, data = runs
    reader = harness.load_reader(root, name)
    value = reader.read(data[cell])
    if name == "runtime.mamba_chunk_ms" and cell == "tiny-moe-cell":
        assert value is None            # no Mamba mixer to step
        return
    assert value is not None and math.isfinite(value) and value >= 0
    # without the program's tracer there is nothing to read
    bare = harness.TraceData(**{f: getattr(data[cell], f) for f in
                                harness.TraceData.__dataclass_fields__})
    assert reader.read(bare) is None


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_readings_come_from_the_part_before_the_profiler(runs, cell):
    _, data = runs
    t = data[cell]
    p = t.program
    ticks = p.named("engine.tick")
    assert len(ticks) == len(t.walls["engine.tick"]) > 0
    assert all(p.t0 <= p.spans[i].start < p.t1 for i in ticks)
    assert program.syncs_per_tick(p) > 0
    assert 0 < program.tick_self_ms(p) < 1e3 * max(
        p.seconds(i) for i in ticks)
    r = program.report(t)
    assert r["rotation_call_syncs"] == 0
    assert r["idle_gaps"] is None                # no card
    if cell == "tiny-hybrid-cell":
        assert r["mamba_step_ms"] > 0


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_f_role_nests_in_the_harness_rotation_range(runs, cell):
    """In the profiled part the program's ranges lie on the profiler's
    clock inside the harness's own: each rotation call holds one
    ``afd.f.experts`` per micro-batch and MoE layer, and the others run in
    the prompt chunks."""
    _, data = runs
    rs = data[cell].program_ranges
    calls = {n: [(a, b) for m, a, b in rs if m == "afdbench.runtime." + n]
             for n in ("decode_step_3bo", "prefill")}
    experts = [(a, b) for n, a, b in rs
               if n == program.PREFIX + "afd.f.experts"]

    def inside(name):
        return [r for r in experts if any(a0 <= r[0] and r[1] <= b0
                                          for a0, b0 in calls[name])]
    from repro_torch.models.common import ArchConfig
    cfg = tiny.CONFIGS[cell.replace("-cell", "")]
    n_moe = sum(1 for s in ArchConfig(**cfg["port"]).layer_plan().flat()
                if s.moe)
    assert calls["decode_step_3bo"]
    assert len(inside("decode_step_3bo")) == (
        len(calls["decode_step_3bo"]) * cfg["engine"]["n_bo"] * n_moe)
    assert len(inside("decode_step_3bo")) + len(inside("prefill")) \
        == len(experts)


def test_a_gap_filled_by_a_collection_is_labelled_by_it():
    from torch.autograd import DeviceType

    def ev(name, start, end, device=False):
        return SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=start, end=end),
            device_type=DeviceType.CUDA if device else DeviceType.CPU)
    events = [ev("kernel", 0, 10, True), ev("kernel", 100, 110, True),
              ev("kernel", 130, 140, True),
              ev("afdbench.runtime.decode_step_3bo", 0, 200),
              ev(program.PREFIX + "afd.f.experts", 5, 150),
              ev(program.PREFIX + "gc.collect", 20, 90),
              ev(program.PREFIX + "afd.f.experts", 100, 150, True)]
    gaps = program.label_gaps(events)
    assert [label for label, _ in gaps] == [program.PREFIX + "gc.collect",
                                            program.PREFIX + "afd.f.experts"]
    assert [s for _, s in gaps] == pytest.approx([90e-6, 20e-6])
