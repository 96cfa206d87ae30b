"""The port's distribution layer across real ranks: 8 gloo processes on
the CPU against the JAX package on 8 forced host devices (the mirror of
``tests/test_multidevice.py``), and the AFD runtime's F role over 3 and 4
F devices against one and against JAX.

One input file (numpy weights and tokens from a seed) feeds two
subprocesses that run side by side: the JAX reference (``JAX_CODE``,
forced host devices, as ``tests/test_multidevice.py`` starts its own)
and one gloo group of 8 ranks (this file run as a script, ``__main__``),
which runs every multi-rank case and writes one ``.npz`` per rank.

The (2, 4) ("data", "model") mesh orders ranks row-major, as
``jax.make_mesh`` orders devices: rank 4·i + j holds JAX's block (data i,
model j). Beyond the JAX tests, EP training also runs at capacity factor
1.0, where rows drop: outputs, per-rank drop fraction, aux loss and the
gradients of ``sum(out²) + 0.01·aux`` are compared on every rank.

The same pair of runs takes one sharded train step of granite-moe's smoke
config from JAX's ``Model.init`` weights: ``distributed_train_step`` on
DTensors over the 8 ranks against JAX's ``jit_distributed_train_step``
on 8 devices (EP hook active on both) and the port's single-process
step, and the same step again under the sequence-parallel rules
(``activate(mesh, TRAIN_RULES_SP)`` on both sides). It also runs the
Mamba-2 mixer of mamba2's smoke config (prefill with a cache, then one
decode step) under the serving rules, its 8 SSD heads split over
"model", against JAX's mixer under the same rules and the port's
single-process mixer.
"""

import contextlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
WORLD = 8
TIMEOUT_S = 240
CFG = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
           n_kv_heads=2, d_head=16, d_ff=0, vocab_size=64, n_experts=8,
           top_k=2, moe_d_ff=16)
CAPACITY_FACTORS = (8.0, 1.0)
# the sharded train step: arch, batch, and a capacity factor at which no
# (token, slot) pair drops, so the EP and single-program MoE agree
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CF = ("granite-moe-1b-a400m", 8,
                                                16, 8.0)
STEP_RTOL = 1e-4
# the Mamba-2 mixer: layer 0 of mamba2's smoke config, prefill of
# (batch, seq) tokens' activations and one decode step
MAMBA_ARCH, MAMBA_BATCH, MAMBA_SEQ = "mamba2-2.7b", 4, 16
MAMBA_ATOL = 1e-5


def make_train_inputs(path) -> None:
    """JAX's ``Model.init`` weights (CRC-32 keys, so every process draws
    the same ones) and a token batch, pickled as numpy trees."""
    import pickle
    import zlib
    from unittest import mock
    import jax
    from repro import configs as jconfigs
    from repro.models import common as jcommon
    from repro.models.model import make_model as jmake_model

    def key_for(root, name):
        return jax.random.fold_in(root, zlib.crc32(name.encode()) % (1 << 31))
    with mock.patch.object(jcommon, "_key_for", key_for):
        params = jmake_model(jconfigs.get_smoke_config(TRAIN_ARCH)).init(
            jax.random.PRNGKey(0))
        mamba = jmake_model(jconfigs.get_smoke_config(MAMBA_ARCH)).init(
            jax.random.PRNGKey(0))
    vocab = jconfigs.get_smoke_config(TRAIN_ARCH).vocab_size
    tokens = np.random.default_rng(3).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    d = jconfigs.get_smoke_config(MAMBA_ARCH).d_model
    rng = np.random.default_rng(4)
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), t)
    with open(path, "wb") as f:
        pickle.dump({"params": to_np(params), "tokens": tokens,
                     "mamba_params": to_np(mamba),
                     "mamba_x": rng.standard_normal(
                         (MAMBA_BATCH, MAMBA_SEQ, d)).astype(np.float32),
                     "mamba_x1": rng.standard_normal(
                         (MAMBA_BATCH, 1, d)).astype(np.float32)}, f)


def make_inputs(path) -> None:
    """Weights and tokens from a seed, shared by both sides."""
    rng = np.random.default_rng(0)
    d, e, m = CFG["d_model"], CFG["n_experts"], CFG["moe_d_ff"]

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    np.savez(path,
             router=normal(d, e, scale=d ** -0.5),
             wi=normal(e, d, 2 * m, scale=d ** -0.5),
             wo=normal(e, m, d, scale=m ** -0.5),
             x=normal(4, 16, d, scale=0.5),            # train and decode
             x1=normal(4, 1, d, scale=0.5),            # ETP decode
             q=normal(2, 8, 32), k=normal(2, 128, 2, 32),
             v=normal(2, 128, 2, 32), pos=np.asarray([100, 13], np.int32))


JAX_CODE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_default_matmul_precision", "highest")
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.models.common import ArchConfig
from repro.parallel import collectives as coll
from repro.parallel import ep as ep_mod
from repro.kernels.ref import moe_ffn_ref
assert len(jax.devices()) == 8
inp = dict(np.load(sys.argv[1]))
cfg = ArchConfig(**{CFG})
p = {{k: jnp.asarray(inp[k]) for k in ("router", "wi", "wo")}}
x, x1 = jnp.asarray(inp["x"]), jnp.asarray(inp["x1"])
d = cfg.d_model
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
res = {{"ref": moe_ffn_ref(x.reshape(-1, d), p["router"], p["wi"], p["wo"],
                           cfg.top_k).reshape(x.shape),
       "ref1": moe_ffn_ref(x1.reshape(-1, d), p["router"], p["wi"], p["wo"],
                           cfg.top_k).reshape(x1.shape)}}
with mesh:
    for cf in {CAPACITY_FACTORS}:
        ep = ep_mod.EPConfig(mesh=mesh, ep_axis="model", dp_axes=("data",),
                             capacity_factor=cf)

        def loss(pp, ep=ep):
            out, aux = ep_mod.moe_ep_train(pp, cfg, x, ep)
            return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

        (_, (out, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)

        def drop(x_l, r, wi, wo, ep=ep):
            return ep_mod._moe_ep_train_local(
                x_l.reshape(-1, d), r, wi, wo, cfg=cfg, ep=ep)[2].reshape(1, 1)

        res[f"train{{cf}}_drop"] = jax.jit(shard_map(
            drop, mesh=mesh,
            in_specs=(P("data", "model", None), P(None, None),
                      P("model", None, None), P("model", None, None)),
            out_specs=P("data", "model"), check_vma=False))(
            x, p["router"], p["wi"], p["wo"])
        res[f"train{{cf}}_out"], res[f"train{{cf}}_aux"] = out, aux
        for name in ("wi", "wo", "router"):
            res[f"train{{cf}}_g_{{name}}"] = g[name]
    ep = ep_mod.EPConfig(mesh=mesh, ep_axis="model", dp_axes=("data",),
                         capacity_factor=8.0)
    res["decode"] = jax.jit(lambda pp, xx: ep_mod.moe_ep_decode(
        pp, cfg, xx, ep))(p, x)
    etp = ep_mod.EPConfig(mesh=mesh, ep_axis="model", dp_axes=("data",),
                          etp=True, etp_axis="data")
    res["etp"] = jax.jit(lambda pp, xx: ep_mod.moe_ep_decode_etp(
        pp, cfg, xx, etp))(p, x1)
mesh18 = jax.make_mesh((1, 8), ("data", "model"),
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
with mesh18:
    res["splitkv"] = jax.jit(lambda *a: coll.splitkv_decode_attention(
        *a, mesh=mesh18, axis="model"))(
        *(jnp.asarray(inp[n]) for n in ("q", "k", "v", "pos")))
np.savez(sys.argv[2], **{{k: np.asarray(v) for k, v in res.items()}})

# one sharded train step (the dry-run's jit_distributed_train_step)
import dataclasses, pickle
from repro import configs as jconfigs
from repro.models.model import make_model
from repro.parallel import sharding as jshd
from repro.training import optimizer as jopt
from repro.training.train import TrainConfig, jit_distributed_train_step
with open(sys.argv[3], "rb") as f:
    tr = pickle.load(f)
jcfg = dataclasses.replace(jconfigs.get_smoke_config({TRAIN_ARCH!r}),
                           moe_capacity_factor={TRAIN_CF})
jm = make_model(jcfg)
params = jax.tree_util.tree_map(jnp.asarray, tr["params"])
batch = {{"tokens": jnp.asarray(tr["tokens"])}}
opt = jopt.adamw()
state = opt.init(params)
epc = ep_mod.EPConfig(mesh=mesh, ep_axis="model", dp_axes=("data",),
                      capacity_factor={TRAIN_CF})
with mesh, jshd.activate(mesh, jshd.TRAIN_RULES), ep_mod.activate(epc):
    fn, _ = jit_distributed_train_step(jm, opt, params, state, batch, mesh,
                                       TrainConfig(), jshd.TRAIN_RULES,
                                       donate=False)
    new_p, _, metrics = fn(params, state, batch)
with open(sys.argv[4], "wb") as f:
    pickle.dump({{"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), new_p),
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"])}}, f)

# the same step under the sequence-parallel rules
with mesh, jshd.activate(mesh, jshd.TRAIN_RULES_SP), ep_mod.activate(epc):
    fn, _ = jit_distributed_train_step(jm, opt, params, state, batch, mesh,
                                       TrainConfig(), jshd.TRAIN_RULES_SP,
                                       donate=False)
    sp_p, _, sp_m = fn(params, state, batch)

# the Mamba-2 mixer under the serving rules: prefill with a cache, a step
from repro.models import kvcache as jkv
from repro.models import mamba2 as jm2
mcfg = jconfigs.get_smoke_config({MAMBA_ARCH!r})
mp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                            tr["mamba_params"]["decoder"]["stack"][0]["mamba"])
with mesh, jshd.activate(mesh, jshd.SERVE_RULES):
    def pre(p, x):
        return jm2.mamba_prefill(p, mcfg, x,
                                 jkv.init_ssm_cache(mcfg, x.shape[0]))
    m_out, m_cache = jax.jit(pre)(mp, jnp.asarray(tr["mamba_x"]))
    m_out1, m_cache1 = jax.jit(lambda p, x, c: jm2.mamba_decode(
        p, mcfg, x, c))(mp, jnp.asarray(tr["mamba_x1"]), m_cache)
with open(sys.argv[5], "wb") as f:
    pickle.dump({{"sp": {{"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), sp_p),
        "loss": float(sp_m["loss"]), "grad_norm": float(sp_m["grad_norm"])}},
        "mamba": {{k: np.asarray(v, np.float32) for k, v in (
            ("out", m_out), ("conv", m_cache["conv"]),
            ("state", m_cache["state"]), ("out1", m_out1),
            ("conv1", m_cache1["conv"]), ("state1", m_cache1["state"]))}}}},
        f)
""".format(CFG=repr(CFG), CAPACITY_FACTORS=repr(CAPACITY_FACTORS),
           TRAIN_ARCH=TRAIN_ARCH, TRAIN_CF=TRAIN_CF, MAMBA_ARCH=MAMBA_ARCH)


# ---------------------------------------------------------------------------
# the gloo ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, rendezvous: str, in_path: str, out_dir: str):
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.common import ArchConfig
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import ep as ep_mod
    from repro_torch.parallel import sharding as shd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    inp = {k: torch.from_numpy(v) for k, v in np.load(in_path).items()}
    cfg = ArchConfig(**CFG, dtype="float32", param_dtype="float32")
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    data = mesh.get_local_rank("data")
    dp = ("data", None, None)
    res = {}
    x_dp = shd.local_block(inp["x"], dp, mesh)           # this rank's DP block
    for cf in CAPACITY_FACTORS:
        epc = ep_mod.EPConfig(mesh=mesh, dp_axes=("data",),
                              capacity_factor=cf)
        p = {k: inp[k].clone().requires_grad_()
             for k in ("router", "wi", "wo")}
        out, aux = ep_mod.moe_ep_train(p, cfg, x_dp, epc)
        # the objective is the sum of the ranks' losses: the EP ranks of a
        # DP block hold its output replicated, the aux is on every rank
        (out.square().sum() / epc.ep_size + 0.01 * aux / WORLD).backward()
        for name in ("wi", "wo", "router"):
            g = p[name].grad.clone()
            res[f"train{cf}_g_{name}_local"] = g.clone()
            dist.all_reduce(g)
            res[f"train{cf}_g_{name}"] = g
        res[f"train{cf}_out"], res[f"train{cf}_aux"] = out.detach(), aux
        s_loc = x_dp.shape[1] // epc.ep_size
        x_l = x_dp.narrow(1, mesh.get_local_rank("model") * s_loc, s_loc)
        wi_l, wo_l = ep_mod._local_experts(inp, cfg, epc)
        with torch.no_grad():
            res[f"train{cf}_drop"] = ep_mod._moe_ep_train_local(
                x_l.reshape(-1, cfg.d_model), inp["router"], wi_l, wo_l,
                cfg=cfg, ep=epc)[2]
    epc = ep_mod.EPConfig(mesh=mesh, dp_axes=("data",), capacity_factor=8.0)
    res["decode"] = ep_mod.moe_ep_decode(inp, cfg, x_dp, epc)
    etp = ep_mod.EPConfig(mesh=mesh, dp_axes=("data",), etp=True,
                          etp_axis="data")
    wi_spec, wo_spec = ("model", "data", None), ("model", None, "data")
    stored = {"router": inp["router"],           # the FSDP storage layout
              "wi": shd.local_block(inp["wi"], wi_spec, mesh).contiguous(),
              "wo": shd.local_block(inp["wo"], wo_spec, mesh).contiguous()}
    res["etp"] = ep_mod.moe_ep_decode_etp(stored, cfg, inp["x1"], etp)
    res["gathered_wi"] = shd.gather_block(stored["wi"], wi_spec, mesh)
    res["gathered_wo"] = shd.gather_block(stored["wo"], wo_spec, mesh)
    res["data"] = torch.tensor(data)

    mesh18 = init_device_mesh("cpu", (1, 8), mesh_dim_names=("data", "model"))
    specs = coll.splitkv_specs(mesh18, "model", inp["q"].shape[0])
    q, k, v, pos = (shd.local_block(inp[n], specs[s], mesh18).contiguous()
                    for n, s in (("q", "q"), ("k", "kv"), ("v", "kv"),
                                 ("pos", "pos")))
    res["splitkv"] = coll.splitkv_decode_attention(q, k, v, pos, mesh18)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: t.detach().numpy() for k, t in res.items()})
    train_path = os.path.join(os.path.dirname(in_path), "train.pkl")
    _sharded_train_step(rank, mesh, train_path, out_dir)
    _mamba_mixer(rank, mesh, train_path, out_dir)
    dist.barrier()
    dist.destroy_process_group()


def _port_step_inputs(train_path):
    """The port's model, optimizer, bridged weights, state and batch of the
    sharded-step case (CPU)."""
    import dataclasses
    import pickle
    from repro_torch import configs as tconfigs
    from repro_torch.bridge import params_from_jax
    from repro_torch.models.model import Model
    from repro_torch.training import optimizer as topt
    with open(train_path, "rb") as f:
        tr = pickle.load(f)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(TRAIN_ARCH),
                               moe_capacity_factor=TRAIN_CF)
    model = Model(tcfg, device="cpu")
    params = params_from_jax(tcfg, tr["params"], "cpu")
    opt = topt.adamw()
    return (model, opt, params, opt.init(params),
            {"tokens": torch.from_numpy(tr["tokens"])})


def _sharded_train_step(rank, mesh, train_path, out_dir):
    """``distributed_train_step`` over the (2, 4) mesh, with the aux loss
    (against JAX) and without it (against the single-process step, whose
    aux is one batch-wide statistic where EP averages per-shard ones);
    rank 0 writes the gathered parameters and the metrics of both."""
    import pickle
    from unittest import mock
    from repro_torch.models import model as model_mod
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.parallel import ep as ep_mod
    from repro_torch.parallel import sharding as shd
    from repro_torch.training.train import (distributed_train_step,
                                            train_state_shardings)
    model, opt, params, state, batch = _port_step_inputs(train_path)
    specs = train_state_shardings(params, state, batch, mesh)
    placed = [shd.distribute_tree(t, s, mesh)
              for t, s in zip((params, state, batch), specs)]
    epc = ep_mod.EPConfig(mesh=mesh, dp_axes=("data",),
                          capacity_factor=TRAIN_CF)
    step = distributed_train_step(model, opt, mesh, ep=epc)
    sp_specs = train_state_shardings(params, state, batch, mesh,
                                     shd.TRAIN_RULES_SP)
    sp_placed = [shd.distribute_tree(t, s, mesh)
                 for t, s in zip((params, state, batch), sp_specs)]
    out = {}
    for label, coef, rules in (
            ("aux", model_mod.AUX_LOSS_COEF, None),
            ("no_aux", 0.0, None),
            ("sp", model_mod.AUX_LOSS_COEF, shd.TRAIN_RULES_SP)):
        run = placed if rules is None else sp_placed
        ctx = (contextlib.nullcontext() if rules is None
               else shd.activate(mesh, rules))
        with mock.patch.object(model_mod, "AUX_LOSS_COEF", coef), ctx:
            new_p, new_s, metrics = step(*run)
        kept = all(a.placements == b.placements for a, b in zip(
            tree_leaves(new_p) + tree_leaves(new_s),
            tree_leaves(run[0]) + tree_leaves(run[1])))
        out[label] = {
            "params": tree_map(lambda t: t.full_tensor().detach().numpy(),
                               new_p),
            "placements_kept": kept,
            **{k: float(metrics[k].full_tensor())
               for k in ("loss", "grad_norm")}}
    if rank == 0:
        with open(os.path.join(out_dir, "port_step.pkl"), "wb") as f:
            pickle.dump(out, f)


def _mamba_inputs(train_path):
    """Layer 0's Mamba-2 weights of mamba2's smoke config (JAX's, through
    the bridge), its config and the two activations, on the CPU."""
    import pickle
    from repro_torch import configs as tconfigs
    from repro_torch.bridge import params_from_jax
    with open(train_path, "rb") as f:
        tr = pickle.load(f)
    cfg = tconfigs.get_smoke_config(MAMBA_ARCH)
    params = params_from_jax(cfg, tr["mamba_params"], "cpu")
    return (cfg, params["layers"][0]["mamba"],
            torch.from_numpy(tr["mamba_x"]), torch.from_numpy(tr["mamba_x1"]))


def _mamba_mixer(rank, mesh, train_path, out_dir):
    """``mamba_prefill`` with a cache, then ``mamba_decode``, on DTensors
    placed by the serving rules and under them, with the heads each
    rank's SSD ran on recorded; rank r writes its full outputs and those
    head counts."""
    import pickle
    from unittest import mock
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import kvcache as tkv
    from repro_torch.models import mamba2
    from repro_torch.parallel import sharding as shd
    cfg, p, x, x1 = _mamba_inputs(train_path)
    rules = shd.SERVE_RULES
    p_spec = shd.params_shardings({"mamba": p}, mesh, rules)["mamba"]
    cache = tkv.init_ssm_cache(cfg, x.shape[0], "cpu")
    act = lambda t: shd.distribute(t, shd.logical_to_spec(  # noqa: E731
        mesh, rules, ("batch", "seq", "embed"), t.shape), mesh)
    placed = (shd.distribute_tree(p, p_spec, mesh), act(x), act(x1),
              shd.distribute_tree(cache, shd.cache_shardings(
                  cache, mesh, rules), mesh))
    heads = []

    def seen(fn):
        def wrapped(*args):
            heads.append(args[-2].shape[0])         # this rank's A_log
            return fn(*args)
        return wrapped
    with mock.patch.object(mamba2, "_prefill_scan",
                           seen(mamba2._prefill_scan)), \
            mock.patch.object(mamba2, "_decode_scan",
                              seen(mamba2._decode_scan)), \
            shd.activate(mesh, rules), implicit_replication():
        out, c = mamba2.mamba_prefill(placed[0], cfg, placed[1], placed[3])
        out1, c1 = mamba2.mamba_decode(placed[0], cfg, placed[2], c)
    res = {"heads": heads, **{k: v.full_tensor().numpy() for k, v in (
        ("out", out), ("conv", c["conv"]), ("state", c["state"]),
        ("out1", out1), ("conv1", c1["conv"]), ("state1", c1["state"]))}}
    with open(os.path.join(out_dir, f"mamba{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# fixtures: both runs side by side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multidevice")
    make_inputs(d / "inputs.npz")
    make_train_inputs(d / "train.pkl")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_CODE),
             str(d / "inputs.npz"), str(d / "jax.npz"), str(d / "train.pkl"),
             str(d / "jax_step.pkl"), str(d / "jax_more.pkl")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "torch": subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(d / "rdv"),
             str(d / "inputs.npz"), str(d)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for name, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            pytest.fail(f"{name} run exceeded {TIMEOUT_S} s")
        assert proc.returncode == 0, f"{name} run failed:\n{log}"
    want = dict(np.load(d / "jax.npz"))
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return want, ranks, dict(np.load(d / "inputs.npz")), d


def _dp_block(a, data: int):
    return a[2 * data:2 * data + 2]


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_ep_train_matches_jax_8ranks(runs, cf):
    """Outputs, per-rank drop fraction, aux and the gradients of
    sum(out²) + 0.01·aux (wi, wo, router) on every rank."""
    want, ranks, _, _ = runs
    if cf == 1.0:
        assert want[f"train{cf}_drop"].max() > 0      # rows do drop here
    for r, got in enumerate(ranks):
        data, model = divmod(r, 4)
        np.testing.assert_allclose(
            got[f"train{cf}_out"], _dp_block(want[f"train{cf}_out"], data),
            atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"train{cf}_drop"],
                                   want[f"train{cf}_drop"][data, model],
                                   atol=1e-7, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"train{cf}_aux"],
                                   want[f"train{cf}_aux"], rtol=1e-5)
        for name in ("wi", "wo", "router"):
            np.testing.assert_allclose(
                got[f"train{cf}_g_{name}"], want[f"train{cf}_g_{name}"],
                atol=1e-4, err_msg=f"rank {r} {name}")
        # an expert's gradient lands only on the EP rank that holds it
        g = got[f"train{cf}_g_wi_local"]
        held = np.zeros(g.shape[0], bool)
        held[2 * model:2 * model + 2] = True
        assert not g[~held].any() and g[held].any()
    if cf == 8.0:
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(
                got["train8.0_out"], _dp_block(want["ref"], r // 4),
                atol=1e-5)


def test_ep_decode_matches_jax_8ranks(runs):
    want, ranks, _, _ = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["decode"],
                                   _dp_block(want["decode"], r // 4),
                                   atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["decode"],
                                   _dp_block(want["ref"], r // 4), atol=1e-5)


def test_etp_decode_matches_jax_8ranks(runs):
    """Weights held in the FSDP storage layout (experts over "model", D
    over "data"); gather_block puts them back together on every rank."""
    want, ranks, inp, _ = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["etp"], want["etp"], atol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["etp"], want["ref1"], atol=1e-5)
        assert np.array_equal(got["gathered_wi"], inp["wi"])
        assert np.array_equal(got["gathered_wo"], inp["wo"])


def test_splitkv_matches_jax_8ranks(runs):
    want, ranks, _, _ = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["splitkv"], want["splitkv"],
                                   atol=1e-5, err_msg=f"rank {r}")


def _check_step(port, want_params, want, label):
    assert port["placements_kept"], label
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(port[key], want[key], rtol=STEP_RTOL,
                                   err_msg=f"{label} {key}")
    got = _np_leaves(port["params"])
    assert len(got) == len(want_params)
    for i, (g, w) in enumerate(zip(got, want_params)):
        np.testing.assert_allclose(g, w, rtol=STEP_RTOL, atol=STEP_RTOL,
                                   err_msg=f"{label} leaf {i}")


def test_distributed_train_step_matches_jax_8ranks(runs):
    """One ``distributed_train_step`` on 8 gloo ranks against JAX's
    ``jit_distributed_train_step`` on 8 devices (aux loss on, as the
    model has it) and, with the aux loss off, against the port's
    single-process step (the EP hook's aux averages per-shard routing
    statistics, the single program's is batch-wide): loss, gradient norm
    and every updated leaf within 1e-4 (float32), placements kept."""
    import pickle
    from unittest import mock
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import model as model_mod
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.train import build_step_fn
    *_, d = runs
    with open(d / "jax_step.pkl", "rb") as f:
        jax_step = pickle.load(f)
    with open(d / "port_step.pkl", "rb") as f:
        port = pickle.load(f)
    model, opt, params, state, batch = _port_step_inputs(d / "train.pkl")
    want = [t.numpy() for t in tree_leaves(
        params_from_jax(model.cfg, jax_step["params"], "cpu"))]
    _check_step(port["aux"], want, jax_step, "against JAX")
    with mock.patch.object(model_mod, "AUX_LOSS_COEF", 0.0):
        new_p, _, metrics = build_step_fn(model, opt)(params, state, batch)
    single = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
    _check_step(port["no_aux"], [t.numpy() for t in tree_leaves(new_p)],
                single, "against the single-process step")


def test_sp_train_step_matches_jax_8ranks(runs):
    """``distributed_train_step`` under ``activate(mesh, TRAIN_RULES_SP)``
    (the sequence split over "model" at every activation annotation) on 8
    gloo ranks against JAX's ``jit_distributed_train_step`` under
    ``shd.activate(mesh, TRAIN_RULES_SP)`` on 8 devices: loss, gradient
    norm and every updated leaf within 1e-4 (float32), placements kept."""
    import pickle
    from repro_torch.bridge import params_from_jax
    from repro_torch.models.common import tree_leaves
    *_, d = runs
    with open(d / "jax_more.pkl", "rb") as f:
        jax_sp = pickle.load(f)["sp"]
    with open(d / "port_step.pkl", "rb") as f:
        port = pickle.load(f)
    model, *_ = _port_step_inputs(d / "train.pkl")
    want = [t.numpy() for t in tree_leaves(
        params_from_jax(model.cfg, jax_sp["params"], "cpu"))]
    _check_step(port["sp"], want, jax_sp, "sequence-parallel, against JAX")


def test_mamba_mixer_heads_split_matches_jax_8ranks(runs):
    """mamba2's mixer (8 SSD heads) on DTensors over the (2, 4) mesh under
    the serving rules: every rank's SSD ran on its 2 heads, in prefill and
    in decode; the outputs, conv tails and states equal JAX's mixer under
    the same rules on 8 devices within 1e-5 (float32) and, bit for bit,
    the port's single-process mixer on each data-parallel rank's
    sequences (a GEMM over fewer rows may round otherwise on the CPU)."""
    import pickle
    from repro_torch.models import kvcache as tkv
    from repro_torch.models import mamba2
    *_, d = runs
    with open(d / "jax_more.pkl", "rb") as f:
        want = pickle.load(f)["mamba"]
    cfg, p, x, x1 = _mamba_inputs(d / "train.pkl")
    blocks = []
    for xb, x1b in zip(x.chunk(2), x1.chunk(2)):      # the 2 "data" blocks
        out, c = mamba2.mamba_prefill(
            p, cfg, xb, tkv.init_ssm_cache(cfg, xb.shape[0], "cpu"))
        out1, c1 = mamba2.mamba_decode(p, cfg, x1b, c)
        blocks.append((out, c["conv"], c["state"], out1, c1["conv"],
                       c1["state"]))
    single = {k: torch.cat(parts).numpy() for k, parts in zip(
        ("out", "conv", "state", "out1", "conv1", "state1"), zip(*blocks))}
    for r in range(WORLD):
        with open(d / f"mamba{r}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got["heads"] == [cfg.ssm_heads // 4] * 2, (r, got["heads"])
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=MAMBA_ATOL,
                                       rtol=MAMBA_ATOL,
                                       err_msg=f"rank {r} {k}")
            assert np.array_equal(got[k], single[k]), f"rank {r} {k}"


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _np_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _np_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the AFD runtime's F role over N_F devices (in process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def afd_setups():
    import jax
    from repro import configs as jconfigs
    from repro.models.model import make_model
    from repro_torch import configs as tconfigs
    from repro_torch.bridge import params_from_jax
    out = {}
    for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b"):
        jcfg = jconfigs.get_smoke_config(arch)
        params = make_model(jcfg).init(jax.random.PRNGKey(0))
        tcfg = tconfigs.get_smoke_config(arch)
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      params)
        out[arch] = (jcfg, params, tcfg, params_from_jax(tcfg, tree, "cpu"))
    return out


@pytest.mark.parametrize("n_f", [3, 4])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_afd_f_role_over_n_f_devices(afd_setups, arch, n_f):
    """E = 8 experts over 4 F devices: 4 blocks of 2, one grouped-GEMM
    program per block, partials summed on the A device; over 3 they are
    replicated and the first F device runs them. Logits against N_F = 1
    and JAX's runtime, M2N bytes against Eq. 9/17 once per cycle."""
    import jax
    import jax.numpy as jnp
    from repro.parallel.afd import AFDRuntime as JAFDRuntime
    from repro_torch.core import planner as pln
    from repro_torch.parallel.afd import AFDRuntime, rescale
    jcfg, jparams, tcfg, tparams = afd_setups[arch]
    B, S = 2, 5
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S))
    devs = jax.devices()
    jrt = JAFDRuntime(jcfg, jparams, [devs[0]], [devs[-1]])
    rts = [AFDRuntime(tcfg, tparams, device="cpu"),
           AFDRuntime(tcfg, tparams, device="cpu", f_devices=["cpu"] * n_f)]
    assert rts[1].experts_sharded == (tcfg.n_experts % n_f == 0)
    moe_layer = next(i for i, s in enumerate(rts[1].f_shards) if s)
    assert len(rts[1].f_shards[moe_layer]) == n_f
    jc, jpos = jrt.init_cache(B, S + 2)
    states = [rt.init_cache(B, S + 2) for rt in rts]
    for t in range(S):
        want, jc, jpos = jrt.decode_step(jnp.asarray(toks[:, t], jnp.int32),
                                         jc, jpos)
        outs = []
        for i, rt in enumerate(rts):
            lg, c, pos = rt.decode_step(torch.from_numpy(toks[:, t]),
                                        *states[i])
            states[i] = (c, pos)
            outs.append(lg.numpy())
        np.testing.assert_allclose(outs[1], outs[0], atol=1e-4)
        np.testing.assert_allclose(outs[1], np.asarray(want), atol=1e-4)
    moe_layers = sum(s.moe for s in tcfg.layer_plan().flat())
    cyc_d, cyc_c = pln.predict_m2n_cycle_bytes(B, tcfg.d_model, tcfg.top_k)
    for rt in rts:
        assert rt.stats.dispatches == S * moe_layers
        assert (rt.stats.dispatch_bytes, rt.stats.combine_bytes) == (
            S * moe_layers * cyc_d, S * moe_layers * cyc_c)
    # the experts reassemble whole for a rescale back to one F device
    back = rescale(rts[1], "cpu", ["cpu"])
    for i, sh in enumerate(rts[0].f_shards):
        if sh is not None:
            for n in ("wi", "wo"):
                assert torch.equal(back.f_shards[i][0][n], sh[0][n])


if __name__ == "__main__":
    import torch.multiprocessing as mp
    rendezvous, in_path, out_dir = sys.argv[1:4]
    mp.spawn(_rank_main, args=(rendezvous, in_path, out_dir), nprocs=WORLD,
             join=True)
