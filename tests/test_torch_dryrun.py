"""The port's AFD dry-run (``repro_torch.launch.{hlo_analysis,afd_dryrun}``)
against JAX's (``repro.launch.{hlo_analysis,afd_dryrun}``) on the CPU.

  * Pricing: ``roofline``, ``model_flops`` and ``improvement_hint`` equal
    JAX's on the same inputs; the ring rules give JAX's HLO-parsed bytes.
  * ``lower_afd`` (JAX's in a fresh interpreter with 512 host devices,
    the port's in this process) at granite 4A + 4F (dense and int8) and
    Kimi K2's defaults: the exact fields, and the budget of JAX's own
    t_a / t_f / F FLOPs.
  * The reference's two pricing gaps, pinned: its F-role FLOPs are the
    dense stand-in over the local experts, its A-role bytes far exceed one
    device's block.
  * The per-rank role programs, every rank run in a thread with in-process
    collectives and recombined, equal JAX's unsharded role layers.
  * ``measure_afd`` on the CPU (and, ``gpu``-marked, on the card).
"""

import itertools
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.grouped_gemm import quantize_experts as jquantize  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import quantized_experts_from_jax  # noqa: E402
from repro_torch.launch import afd_dryrun as ad  # noqa: E402
from repro_torch.launch import hlo_analysis as thlo  # noqa: E402
from repro_torch.parallel.sharding import MeshShape  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

GRANITE = dict(arch="granite-moe-1b-a400m", batch=32, context=1024,
               n_a_nodes=4, n_f_nodes=4)
CELLS = {"granite": GRANITE, "granite_int8": {**GRANITE, "int8": True},
         "kimi": dict(arch="kimi-k2-1t-a32b")}

# JAX's lower_afd, with the per-role roofline terms it does not return
_JAX_CODE = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import repro.launch.afd_dryrun as jad
terms = []
role_terms = jad._role_terms
def keep(compiled, chips):
    t = role_terms(compiled, chips)
    terms.append(dataclasses.asdict(t))
    return t
jad._role_terms = keep
out = {}
for key, kw in json.loads(sys.argv[1]).items():
    out[key] = {**jad.lower_afd(**kw), "terms": terms[-2:]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    """(JAX's records, the port's) of ``CELLS`` (+ granite priced on the
    H100 for the port): JAX's in a fresh interpreter while the port's run
    here."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_CODE,
                             json.dumps(CELLS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    port_cells = {**CELLS, "granite_h100": {**GRANITE, "hardware": "H100"}}
    port = {k: ad.lower_afd(**kw) for k, kw in port_cells.items()}
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out), port


# ---------------------------------------------------------------------------
# Pricing
# ---------------------------------------------------------------------------

_SAMPLE = """
  %all-reduce = f32[32,64]{1,0} all-reduce(%dot.1), channel_id=1, replica_groups=[4,2]<=[2,4]T(1,0), use_global_device_ids=true, to_apply=%add
  %ag = bf16[16,128]{1,0} all-gather(%p0), channel_id=2, replica_groups=[2,4]<=[8], dimensions={0}
  %rs = f32[8,8]{1,0} reduce-scatter(%x), channel_id=3, replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %a2a = bf16[64]{0} all-to-all(%y), channel_id=4, replica_groups=[1,8]<=[8]
  %cp = u32[128]{0} collective-permute(%z), channel_id=5, source_target_pairs={{0,1}}
  %ard = f32[4]{0} all-reduce-done(%start)
"""
# the same collectives as (kind, result bytes, group size), as the port's
# counter records them
_RECORDED = [("all-reduce", thlo.shape_bytes(torch.float32, (32, 64)), 2),
           ("all-gather", thlo.shape_bytes(torch.bfloat16, (16, 128)), 4),
           ("reduce-scatter", thlo.shape_bytes(torch.float32, (8, 8)), 4),
           ("all-to-all", thlo.shape_bytes(torch.bfloat16, (64,)), 8),
           ("collective-permute", thlo.shape_bytes(torch.int32, (128,)), 1)]


def test_ring_rules_equal_jax_hlo_parser():
    j, t = jhlo.collective_bytes(_SAMPLE), thlo.collective_stats(_RECORDED)
    assert (t.operand_bytes, t.link_bytes, t.counts) == (
        j.operand_bytes, j.link_bytes, j.counts)
    assert (t.total_operand, t.total_link) == (j.total_operand, j.total_link)


@pytest.mark.parametrize("cost", [
    {"flops": 1e12, "bytes accessed": 1e9},            # compute-bound
    {"flops": 3.3e9, "bytes accessed": 5.6e9},         # memory-bound
    {"flops": 1e3, "bytes accessed": 1e3},             # collective-bound
    {}], ids=["compute", "memory", "collective", "empty"])
def test_roofline_on_tpu_pricing_equals_jax(cost):
    j = jhlo.roofline(cost, jhlo.collective_bytes(_SAMPLE), 256)
    t = thlo.roofline(cost, thlo.collective_stats(_RECORDED), 256)
    for f in ("flops_dev", "bytes_dev", "coll_operand_dev", "coll_link_dev",
              "coll_breakdown", "coll_counts", "chips", "t_compute",
              "t_memory", "t_collective", "dominant", "total_lower_bound",
              "compute_fraction"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.priced_on == "TPUv5e"
    assert thlo.improvement_hint(t) == jhlo.improvement_hint(j)


def test_h100_pricing():
    h = thlo.get_pricing("H100")
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (989e12, 3.35e12, 50e9)
    t = thlo.roofline({"flops": 989e9, "bytes accessed": 3.35e9},
                      thlo.collective_stats([("all-reduce", 50_000, 2)]), 8,
                      "H100")
    assert (t.t_compute, t.t_memory, t.t_collective, t.priced_on) == (
        1e-3, 1e-3, 1e-6, "H100")
    with pytest.raises(KeyError, match="unknown pricing"):
        thlo.get_pricing("TPUv9")


@pytest.mark.parametrize("train", [True, False])
def test_model_flops_equals_jax(train):
    assert thlo.model_flops(1e9, 100, train) == jhlo.model_flops(1e9, 100,
                                                                 train)


def test_shape_bytes():
    assert thlo.shape_bytes(torch.float32, (4, 4)) == 64
    assert thlo.shape_bytes(torch.bfloat16, (8,)) == 16
    assert thlo.shape_bytes(torch.bool, ()) == 1
    assert thlo.shape_bytes(torch.int8, (3, 5)) == 15


def test_counter_counts_kernels_by_their_own_work():
    """Inside the counter the grouped GEMM adds 2·K·N per routed row (not
    the plain version's every-row-by-every-expert), views add nothing, and
    a gather adds the rows it reads."""
    from repro_torch.kernels import ops
    x = torch.randn(6, 16)
    w = torch.randn(3, 16, 8)
    sizes = torch.tensor([2, 0, 1], dtype=torch.int32)   # 3 of 6 rows routed
    with thlo.count_cost() as c:
        ops.grouped_gemm(x, w, sizes)
    assert c.flops == 2 * 3 * 16 * 8
    assert c.bytes == (6 * 16 + 2 * 16 * 8 + 6 * 8) * 4 + 3 * 4
    big = torch.randn(1000, 64)
    with thlo.count_cost() as c:
        big.T.reshape(-1)[:10]
        big[torch.tensor([1, 2])]
    assert c.flops == 0
    assert c.bytes == 2 * 2 * 64 * 4 + 2 * 8 + 64_000 * 4 * 2   # gather + copy


# ---------------------------------------------------------------------------
# lower_afd against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", sorted(CELLS))
def test_exact_fields_equal_jax(records, cell):
    jrec, trec = records[0][cell], records[1][cell]
    for key in ("arch", "batch", "context", "n_a_nodes", "n_f_nodes",
                "micro_batches", "int8", "f_weight_bytes_dev", "m2n"):
        assert trec[key] == jrec[key], key
    for role in ("a_role", "f_role"):
        assert trec[role]["chips"] == jrec[role]["chips"]
    cfg = tconfigs.get_config(trec["arch"])
    assert trec["mb"] * cfg.d_model * 2 == jrec["m2n"]["combine_bytes"]
    assert trec["priced_on"] == "TPUv5e"
    if cell == "kimi":
        assert trec["mb"] == 48
        assert trec["f_weight_bytes_dev"] == 529_173_504
        assert (trec["m2n"]["dispatch_bytes"],
                trec["m2n"]["combine_bytes"]) == (691_200, 688_128)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_budget_of_jax_stage_times_equals_jax(records, cell):
    jrec = records[0][cell]
    got = ad.afd_budget(
        jrec["a_role"]["t_stage"], jrec["f_role"]["t_stage"],
        jrec["terms"][1]["flops_dev"], jrec["f_role"]["chips"],
        jrec["m2n"]["dispatch_bytes"], jrec["m2n"]["combine_bytes"],
        jrec["n_a_nodes"], jrec["n_f_nodes"])
    assert got == {k: jrec[k] for k in ("m2n", "pipeline", "ffn_stage")}


def test_int8_weight_bytes_below_dense(records):
    jrec, trec = records
    assert (trec["granite_int8"]["f_weight_bytes_dev"]
            < trec["granite"]["f_weight_bytes_dev"])
    assert trec["granite_int8"]["f_weight_bytes_dev"] == 1_598_216


def test_reference_f_role_flops_are_the_dense_stand_in(records):
    """JAX's F role runs ``lax.ragged_dot``, and XLA counts every row of
    the micro-batch against every local expert: at Kimi's defaults 384
    rows × 6 experts × 2·(K·N_gate|up + K·N_down), 384× the routed work."""
    jrec = records[0]["kimi"]
    cfg = tconfigs.get_config("kimi-k2-1t-a32b")
    e_loc = cfg.n_experts // jrec["f_role"]["chips"]
    rows = 48 * cfg.top_k
    dense = rows * e_loc * 2 * (cfg.d_model * 2 * cfg.moe_d_ff
                                + cfg.moe_d_ff * cfg.d_model)
    assert abs(jrec["terms"][1]["flops_dev"] / dense - 1) < 0.01


def test_reference_a_role_bytes_exceed_one_devices_block(records):
    """JAX's A-role bytes at Kimi's defaults are > 10× device 0's whole
    cache block (4 sequences × 32768 × 8 × 112 × 2 B, k and v); the
    port's, which read the one KV head its query heads use, are below it."""
    cfg = tconfigs.get_config("kimi-k2-1t-a32b")
    block = 4 * 32768 * cfg.n_kv_heads * cfg.d_head * 2 * 2
    assert records[0]["kimi"]["terms"][0]["bytes_dev"] > 10 * block
    assert records[1]["kimi"]["a_role"]["bytes_dev"] < block


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_port_f_role_flops_are_the_routed_rows(records, cell):
    """The grouped GEMM's FLOPs of the rows routed to rank 0's experts,
    plus the gate-weighted combine (an einsum of 2·k·D per token)."""
    trec = records[1][cell]
    c = ad.make_cell(trec["arch"], trec["batch"], trec["context"],
                     trec["n_a_nodes"], trec["n_f_nodes"], 3, trec["int8"])
    cfg = c.cfg
    _, _, topi = ad.seeded_f_inputs(c)
    routed = int((topi < cfg.n_experts // c.f_chips).sum())
    D, M = cfg.d_model, cfg.moe_d_ff
    want = (2 * routed * D * 2 * M + 2 * routed * M * D
            + 2 * c.mb * cfg.top_k * D)
    assert trec["f_role"]["flops_dev"] == want


def test_priced_on_h100(records):
    dense, h100 = records[1]["granite"], records[1]["granite_h100"]
    assert h100["priced_on"] == "H100"
    for role in ("a_role", "f_role"):
        for k in ("flops_dev", "bytes_dev", "coll_link_dev"):
            assert h100[role][k] == dense[role][k]
        assert h100[role]["t_memory"] == h100[role]["bytes_dev"] / 3.35e12


def test_meshes_without_a_process_group():
    from repro_torch.launch import mesh
    from repro.launch import mesh as jmesh
    assert mesh.CHIPS_PER_NODE == jmesh.CHIPS_PER_NODE == 8
    single, multi = (mesh.make_production_mesh(),
                     mesh.make_production_mesh(multi_pod=True))
    assert single == MeshShape(("data", "model"), (16, 16))
    assert multi == MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert (mesh.nodes_in_mesh(single), mesh.nodes_in_mesh(multi)) == (32, 64)
    assert mesh.make_mesh((24,), ("model",)) == MeshShape(("model",), (24,))


def test_lower_afd_beside_a_process_group(records):
    """``lower_afd`` uses no process group: beside one it prices the same
    record, and leaves the group as it was."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        rec = ad.lower_afd(**GRANITE)
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    def priced(r):
        return {k: ({f: x for f, x in v.items() if f != "compile_s"}
                    if k in ("a_role", "f_role") else v)
                for k, v in r.items()}

    assert priced(rec) == priced(records[1]["granite"])


def test_cli_merges_into_out(tmp_path):
    out = tmp_path / "afd.json"
    out.write_text(json.dumps({"earlier": 1}))
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.afd_dryrun", "--arch",
         "granite-moe-1b-a400m", "--batch", "32", "--n-a-nodes", "4",
         "--n-f-nodes", "4", "--int8", "--hardware", "H100", "--out",
         str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    doc = json.loads(out.read_text())
    rec = doc["granite-moe-1b-a400m|4A+4F:int8"]
    assert doc["earlier"] == 1 and rec["priced_on"] == "H100"
    assert json.loads(res.stdout) == rec


# ---------------------------------------------------------------------------
# Rank programs, recombined, against JAX's unsharded role layers
# ---------------------------------------------------------------------------

class _Hub:
    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=120)
        self.lock = threading.Lock()
        self.box = {}


class ThreadComm:
    """One rank's collectives among threads (every rank calls the same
    collectives in the same order): parts are exchanged through a shared
    box between two barriers; a sum adds the parts in rank order."""

    def __init__(self, hub: _Hub, sizes, coords):
        self.hub, self.sizes, self.coords, self.step = hub, sizes, coords, 0

    def _exchange(self, t, axis):
        key = (self.step, axis, tuple((a, c) for a, c in self.coords.items()
                                      if a != axis))
        self.step += 1
        with self.hub.lock:
            self.hub.box.setdefault(key, {})[self.coords[axis]] = t
        self.hub.barrier.wait()
        parts = [self.hub.box[key][i] for i in range(self.sizes[axis])]
        self.hub.barrier.wait()
        return parts

    def all_gather(self, t, axis, dim):
        return torch.cat(self._exchange(t, axis), dim=dim)

    def all_reduce(self, t, axis):
        parts = self._exchange(t, axis)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


def _run_ranks(sizes, fn):
    """``fn(comm, coords)`` on every rank of a mesh of ``sizes``, each in a
    thread; returns {coords tuple: result}."""
    names = list(sizes)
    ranks = list(itertools.product(*(range(sizes[a]) for a in names)))
    hub, results, errors = _Hub(len(ranks)), {}, []

    def body(idx):
        coords = dict(zip(names, idx))
        try:
            results[idx] = fn(ThreadComm(hub, sizes, coords), coords)
        except BaseException as e:          # reported below
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=body, args=(idx,)) for idx in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


def _jax_roles():
    """JAX's role layers. Its module sets XLA_FLAGS (512 host devices) when
    imported: the backend is started first, with this process's devices,
    and the variable put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import afd_dryrun as jad
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jad


def _a_layer(cfg, rng):
    D, E = cfg.d_model, cfg.n_experts

    def w(rows, cols):
        return (rng.standard_normal((rows, cols)) / np.sqrt(rows)).astype(
            np.float32)

    norm = lambda: {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(  # noqa: E731
        np.float32)}
    lp = {"ln1": norm(), "ln2": norm(),
          "attn": {"wq": w(D, cfg.q_dim), "wk": w(D, cfg.kv_dim),
                   "wv": w(D, cfg.kv_dim), "wo": w(cfg.q_dim, D)},
          "moe": {"router": w(D, E)}}
    if cfg.n_shared_experts:
        f = cfg.shared_d_ff or cfg.moe_d_ff
        lp["moe"]["shared"] = {"wi": w(D, 2 * f), "wo": w(f, D)}
    return lp


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_a_role_ranks_recombined_equal_jax(arch):
    """Every rank of a (2, 4) ("data", "model") A mesh (FSDP weights over
    "data", one query head per rank, half a KV head of k/v columns, the
    shared expert's hidden units split) on its block, recombined: JAX's
    unsharded ``_a_role_layer`` to 2e-5 in float32."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    rng = np.random.default_rng(3)
    lp = _a_layer(tcfg, rng)
    mb, T, sizes = 4, 16, {"data": 2, "model": 4}
    x = rng.standard_normal((mb, 1, tcfg.d_model)).astype(np.float32)
    cache = {n: rng.standard_normal((mb, T, tcfg.n_kv_heads, tcfg.d_head)
                                    ).astype(np.float32) for n in ("k", "v")}
    pos = np.array([3, 15, 0, 9], np.int32)
    want = _jax_roles()._a_role_layer(jcfg)(
        _tree(jnp.asarray, lp), jnp.asarray(x), _tree(jnp.asarray, cache),
        jnp.asarray(pos))

    mesh = MeshShape(tuple(sizes), tuple(sizes.values()))
    full = _tree(torch.from_numpy, lp)
    specs = ad.a_specs(tcfg, mesh)
    assert specs["attn"]["wq"] == ("data", "model")   # FSDP and heads
    b_l = mb // sizes["data"]

    def rank(comm, coords):
        rows = slice(coords["data"] * b_l, (coords["data"] + 1) * b_l)
        blk = ad.ABlock(ad.cut_a_params(tcfg, full, mesh, coords), specs,
                        {n: torch.from_numpy(c[rows]).permute(2, 0, 1, 3)
                         .contiguous() for n, c in cache.items()})
        return ad.a_role_layer(tcfg, blk, torch.from_numpy(x[rows]),
                               torch.from_numpy(pos[rows]), comm)

    got = _run_ranks(sizes, rank)
    for j in range(sizes["model"]):                   # replicated over TP
        for i in range(sizes["data"]):
            assert torch.equal(got[(i, j)][0], got[(i, 0)][0])
    cat = lambda k: torch.cat([got[(i, 0)][k]  # noqa: E731
                               for i in range(sizes["data"])])
    for k, name in ((0, "x"), (1, "tokens"), (2, "topw"), (4, "shared")):
        np.testing.assert_allclose(cat(k).numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=2e-5, err_msg=name)
    np.testing.assert_array_equal(cat(3).numpy(), np.asarray(want[3]))
    for n in ("k", "v"):
        new = torch.cat([got[(i, 0)][5][n].permute(1, 2, 0, 3)
                         for i in range(sizes["data"])])
        np.testing.assert_allclose(new.numpy(), np.asarray(want[5][n]),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("f_ranks", [4, 16], ids=["split", "replicated"])
def test_f_role_ranks_recombined_equal_jax(int8, f_ranks):
    """Every rank of an F mesh on its block of granite's 8 smoke experts (4
    ranks: 2 each, summed over the mesh; 16 ranks: 8 do not divide, every
    rank holds them all), dense or int8 codes: JAX's unsharded
    ``_f_role_layer`` to 2e-5 in float32."""
    arch = "granite-moe-1b-a400m"
    jcfg, cfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    rng = np.random.default_rng(5)
    E, D, M, k, n = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k, 12
    wi = (rng.standard_normal((E, D, 2 * M)) / np.sqrt(D)).astype(np.float32)
    wo = (rng.standard_normal((E, M, D)) / np.sqrt(M)).astype(np.float32)
    tokens = rng.standard_normal((n, D)).astype(np.float32)
    topi = np.argsort(rng.random((n, E)), axis=1)[:, :k].astype(np.int32)
    topw = rng.random((n, k)).astype(np.float32)
    jad = _jax_roles()
    if int8:
        (ci, si), (co, so) = jquantize(jnp.asarray(wi)), jquantize(jnp.asarray(wo))
        want = jad._f_role_layer(jcfg, int8=True)(
            ci, co, jnp.asarray(tokens), jnp.asarray(topw),
            jnp.asarray(topi), si, so)
        (wi_t, si_t), (wo_t, so_t) = (quantized_experts_from_jax(ci, si, "cpu"),
                                      quantized_experts_from_jax(co, so, "cpu"))
    else:
        want = jad._f_role_layer(jcfg)(*(jnp.asarray(a) for a in (
            wi, wo, tokens, topw, topi)))
        wi_t, wo_t, si_t, so_t = (torch.from_numpy(wi), torch.from_numpy(wo),
                                  None, None)
    split = E % f_ranks == 0
    e_loc = E // f_ranks if split else E

    def rank(comm, coords):
        r = coords["model"]
        cut = slice(r * e_loc, (r + 1) * e_loc) if split else slice(None)
        blk = ad.FBlock(wi_t[cut], wo_t[cut], r * e_loc if split else 0,
                        split, None if si_t is None else si_t[cut],
                        None if so_t is None else so_t[cut])
        return ad.f_role_layer(cfg, blk, torch.from_numpy(tokens),
                               torch.from_numpy(topw),
                               torch.from_numpy(topi), comm)

    got = _run_ranks({"model": f_ranks}, rank)
    for r in range(f_ranks):
        np.testing.assert_allclose(got[(r,)].numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# measure_afd
# ---------------------------------------------------------------------------

def _check_measured(rec, priced):
    cfg = tconfigs.get_config(rec["arch"])
    assert rec["mb"] == priced["mb"] == 12
    assert rec["f_weight_bytes_dev"] == priced["f_weight_bytes_dev"]
    assert rec["f_expert_bytes_dev"] == 2 * cfg.d_model * 3 * cfg.moe_d_ff
    assert rec["m2n"] == priced["m2n"] and rec["priced_on"] == "H100"
    for role in ("a_role", "f_role"):
        r = rec[role]
        for k in ("chips", "flops_dev", "bytes_dev", "coll_link_dev",
                  "t_compute", "t_memory", "t_collective"):
            assert r[k] == priced[role][k], (role, k)
        assert r["t_priced"] == priced[role]["t_stage"]
        assert r["t_measured"] > 0 and r["rel_err_plain"] <= 5e-2
        if rec["device"] == "cpu":
            assert r["t_device"] is None and r["top_kernels"] == []
        else:
            assert r["t_device"] > 0 and r["top_kernels"]
    for budget in (rec, rec["device_only"] or rec):
        assert set(budget["pipeline"]) == {"period", "a_util", "f_util",
                                           "bubble_free"}
        assert set(budget["ffn_stage"]) == {"ofu", "s_t", "hfu"}
    assert (rec["device_only"] is None) == (rec["device"] == "cpu")
    assert rec["outputs"]["a_role"]["x"].shape == (6, 1, cfg.d_model)
    assert rec["outputs"]["f_role"]["y"].shape == (12, cfg.d_model)


def test_a_role_rules_move_no_number():
    """The A role's program runs under its serving rules
    (``activate(a_mesh, SERVE_RULES)``, as JAX compiles it); its rank-local
    program holds plain tensors, so its outputs and its priced counts are
    those of the same program with no rules installed."""
    import contextlib
    from unittest import mock
    from repro_torch.models import common as tcommon
    cell = ad.make_cell(GRANITE["arch"], GRANITE["batch"], GRANITE["context"],
                        GRANITE["n_a_nodes"], GRANITE["n_f_nodes"], 3, False)
    installed = []
    layer = ad.a_role_layer

    def spy(*args, **kw):
        installed.append(tcommon._constraint_fn.__qualname__)
        return layer(*args, **kw)

    def priced():
        runs, _, _ = ad.role_programs(cell, torch.device("cpu"))
        with thlo.count_cost() as counter:
            out = runs["a_role"]()
        return out, counter.cost, counter.collectives

    with mock.patch.object(ad, "a_role_layer", spy):
        with_rules = priced()
        with mock.patch.object(ad.shd, "activate",
                               lambda *a: contextlib.nullcontext()):
            without = priced()
    assert installed == ["install.<locals>.constrain",
                         "reset_constraint_fn.<locals>.<lambda>"]
    assert with_rules[1:] == without[1:]
    assert with_rules[0].keys() == without[0].keys()
    for k, v in with_rules[0].items():
        assert torch.equal(v, without[0][k]), k


def test_measure_afd_on_the_cpu(records):
    """The granite 4A + 4F cell on the CPU (plain versions, host clock):
    every field, the priced counts equal ``lower_afd(hardware="H100")``'s
    (both run the same programs), no kernel launched."""
    rec = ad.measure_afd(**GRANITE, device="cpu", iters=2)
    _check_measured(rec, records[1]["granite_h100"])
    assert rec["device"] == "cpu"
    for role in ("a_role", "f_role"):
        assert not any(rec[role]["launches"].values())
        assert rec[role]["rel_err_plain"] == 0.0


def test_measure_afd_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ad.measure_afd(**GRANITE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_measure_afd_on_the_card(cuda, records):
    """The same cell on the card: split-KV once per A call, the grouped
    GEMM twice per F call, and the outputs within 5e-2 of the CPU run's."""
    rec = ad.measure_afd(**GRANITE)
    _check_measured(rec, records[1]["granite_h100"])
    assert rec["a_role"]["launches"]["splitkv_attention"] == 1
    assert rec["f_role"]["launches"]["grouped_gemm"] == 2
    cpu = ad.measure_afd(**GRANITE, device="cpu", iters=1)
    for role, outs in rec["outputs"].items():
        for k, v in outs.items():
            if k != "topi":
                got, want = v.float(), cpu["outputs"][role][k].float()
                assert bool(torch.isfinite(got).all()), ("card", role, k)
                assert bool(torch.isfinite(want).all()), ("cpu", role, k)
                err = float((got - want).norm())
                assert err / (float(want.norm()) or 1.0) < 5e-2, (role, k)
