"""The port's distribution layer in one process: the sharding rules
against JAX's ``PartitionSpec``s leaf for leaf (all 10 smoke configs on
(1, 1), (2, 4) and (2, 2, 2) meshes, with no devices on either side), the
activation annotations (``models.common.shard``) at JAX's 17 sites and
their placement under ``parallel.sharding.activate``, and the
expert-parallel and split-KV paths at world size 1 on a gloo group
against JAX's on a one-device mesh (``tests/test_parallel.py``'s cases).
Multi-rank runs are in ``tests/test_torch_multidevice.py``; the NCCL
world-size-1 runs on the card are the ``gpu`` tests at the end."""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import compat  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels.ref import moe_ffn_ref as jmoe_ffn_ref  # noqa: E402
from repro.kernels.ref import splitkv_attention_ref as jsplitkv_ref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import ArchConfig as JArchConfig  # noqa: E402
from repro.models.model import make_model as jmake_model  # noqa: E402
from repro.parallel import ep as jep  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.ref import moe_ffn_ref  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import ArchConfig  # noqa: E402
from repro_torch.models.model import make_model  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel import ep  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
RULES = ("TRAIN_RULES", "SERVE_RULES", "SERVE_RULES_NO_SPLITKV",
         "TRAIN_RULES_SP", "SERVE_RULES_WS", "SERVE_RULES_SP")


# ---------------------------------------------------------------------------
# sharding rules against JAX
# ---------------------------------------------------------------------------

def _norm(spec) -> tuple:
    """A spec as a tuple without trailing Nones (JAX writes a replicated
    leaf as P())."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _flat_jax(tree, fn) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jshd._path_str(p): fn(p, leaf) for p, leaf in leaves}


def _flat_port(tensors, specs) -> dict:
    """{path: spec} over the tensor leaves of a port tree, read from the
    spec tree of the same nesting."""
    out = {}

    def at(path, _):
        node = specs
        for key in path.split("/"):
            node = node[int(key) if isinstance(node, list) else key]
        out[path] = _norm(node)
    shd.map_with_path(at, tensors)
    return out


def _port_layers(prefix: str, rest: str, spec, plan, j=None, i=None):
    """JAX's per-layer (prefix i) or scanned (period slot j) entry as the
    port's per-layer paths: a scanned leaf's spec loses its stack entry."""
    if i is not None:
        return {f"{prefix}/{i}/{rest}": _norm(spec)}
    spec = _norm(spec)
    assert not spec or spec[0] is None, spec          # stack: replicated
    n0, per = len(plan.prefix), len(plan.period)
    return {f"{prefix}/{n0 + p * per + j}/{rest}": _norm(spec[1:])
            for p in range(plan.n_periods)}


def _jax_param_specs_as_port(tcfg, shapes, mesh, rules) -> dict:
    from repro_torch.models.transformer import encoder_config
    out = {}
    specs = _flat_jax(shapes, lambda p, leaf: jshd.param_spec(p, leaf, mesh,
                                                              rules))
    for path, spec in specs.items():
        parts = path.split("/")
        if parts[0] == "decoder" and parts[1] in ("prefix", "stack"):
            idx = int(parts[2])
            out.update(_port_layers(
                "layers", "/".join(parts[3:]), spec, tcfg.layer_plan(),
                **({"i": idx} if parts[1] == "prefix" else {"j": idx})))
        elif parts[0] == "decoder":
            out["/".join(parts[1:])] = _norm(spec)
        elif parts[:2] == ["encoder", "stack"] and parts[2] in ("prefix",
                                                                "stack"):
            idx = int(parts[3])
            out.update(_port_layers(
                "encoder/layers", "/".join(parts[4:]), spec,
                encoder_config(tcfg).layer_plan(),
                **({"i": idx} if parts[2] == "prefix" else {"j": idx})))
        elif parts[:2] == ["encoder", "stack"]:
            out["encoder/" + "/".join(parts[2:])] = _norm(spec)
        else:
            out[path] = _norm(spec)
    return out


def _jax_cache_specs_as_port(tcfg, shapes, mesh, rules) -> dict:
    out = {}
    shard_tree = jshd.cache_shardings(shapes, mesh, rules, None)
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        shard_tree, is_leaf=lambda x: hasattr(x, "spec"))
    for p, sh in leaves:
        parts = jshd._path_str(p).split("/")
        if parts[0] in ("prefix", "stack"):
            idx = int(parts[1])
            out.update(_port_layers(
                "layers", "/".join(parts[2:]), sh.spec,
                tcfg.layer_plan(),
                **({"i": idx} if parts[0] == "prefix" else {"j": idx})))
        else:
            out["/".join(parts)] = _norm(sh.spec)
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_and_cache_specs_match_jax(arch):
    """Every leaf of the port's parameter and cache trees gets JAX's spec
    (without the scan's stack entry) under every named rule set."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jmodel = jmake_model(jcfg)
    pshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tparams = init_params(tcfg, seed=0, device="cpu")
    for batch, t in ((8, 64), (3, 64)):
        cshapes = jax.eval_shape(lambda: jmodel.init_cache(batch, t))
        cshapes = {k: v for k, v in cshapes.items() if k != "cross"}
        tcache = kvcache.init_cache(tcfg, batch, t, "cpu")
        for sizes, names in MESHES:
            jmesh = AbstractMesh(sizes, names)
            tmesh = shd.MeshShape(names, sizes)
            for rname in RULES:
                jr, tr = getattr(jshd, rname), getattr(shd, rname)
                if batch == 8:
                    want = _jax_param_specs_as_port(tcfg, pshapes,
                                                    jmesh, jr)
                    got = _flat_port(tparams, shd.params_shardings(
                        tparams, tmesh, tr))
                    assert got == want, (arch, sizes, rname)
                want = _jax_cache_specs_as_port(tcfg, cshapes, jmesh, jr)
                got = _flat_port(tcache, shd.cache_shardings(
                    tcache, tmesh, tr, tcfg))
                assert got == want, (arch, sizes, rname, batch)


def test_logical_to_spec_and_blocks():
    """Non-dividing dims and reused axes stay replicated, as in JAX, for
    logical axes and batches; a rank's block under a spec over two axes
    is the JAX layout's (first axis major), and the blocks tile the
    tensor."""
    names, sizes = ("pod", "data", "model"), (2, 2, 2)
    tmesh, jmesh = shd.MeshShape(names, sizes), AbstractMesh(sizes, names)
    for logical, shape in ((("batch", "heads"), (3, 7)),
                           (("batch", "kv_seq", "kv_heads", None),
                            (8, 64, 4, 16)),
                           (("experts", "moe_fsdp", None), (8, 32, 16)),
                           (("heads", "kv_heads"), (4, 4))):
        for rname in RULES:
            got = shd.logical_to_spec(tmesh, getattr(shd, rname), logical,
                                      shape)
            want = jshd.logical_to_spec(jmesh, getattr(jshd, rname),
                                        logical, shape)
            assert _norm(got) == _norm(want), (logical, rname)
    for batch in (8, 6):
        shapes = {"tokens": (batch, 16), "frames": (batch, 30, 8)}
        want = jshd.batch_shardings(
            {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in
             shapes.items()}, jmesh, jshd.TRAIN_RULES)
        got = shd.batch_shardings({k: torch.zeros(v) for k, v in
                                   shapes.items()}, tmesh, shd.TRAIN_RULES)
        assert {k: _norm(v) for k, v in got.items()} == {
            k: _norm(v.spec) for k, v in want.items()}, batch
    t = torch.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), "model")
    blocks = {}
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                b = shd.local_block(t, spec, tmesh, {"pod": pod,
                                                     "data": data,
                                                     "model": model})
                assert b.shape == (2, 3)
                blocks[(pod * 2 + data, model)] = b
    rows = [torch.cat([blocks[(r, c)] for c in range(2)], 1)
            for r in range(4)]
    assert torch.equal(torch.cat(rows, 0), t)


# ---------------------------------------------------------------------------
# activation placement: JAX's shard() sites against the port's
# ---------------------------------------------------------------------------

# JAX's 17 annotation sites as (function, logical axes); k and v share one
# entry in ``_project_kv`` and in ``init_attn_cache``
SITES = {
    ("_project_q", ("batch", "seq", "heads", None)),
    ("_project_kv", ("batch", "seq", "kv_heads", None)),
    ("gqa_scores_softmax_out", ("batch", "seq", "heads")),
    ("_output_proj", ("batch", "seq", "embed")),
    ("attention_prefill_cached", ("batch", "seq", "heads")),
    ("init_attn_cache", ("batch", "kv_seq", "kv_heads", None)),
    ("init_ssm_cache", ("batch", None, None)),
    ("init_ssm_cache", ("batch", "heads", None, None)),
    ("apply_mlp", ("batch", "seq", "mlp")),
    ("embed_tokens", ("batch", "seq", "embed")),
    ("apply_lm_head", ("batch", "seq", "vocab")),
    ("mamba_prefill", ("batch", "seq", "heads", None)),
    ("mamba_prefill", ("batch", "seq", "embed")),
    ("moe_capacity", ("experts", None, "embed")),
    ("moe_capacity", ("experts", None, "mlp")),
}
SITE_RULES = ("TRAIN_RULES", "TRAIN_RULES_SP", "SERVE_RULES",
              "SERVE_RULES_SP", "SERVE_RULES_WS")
# batch, sequence, cache length and flash chunk of the recorded runs
SITE_B, SITE_S, SITE_T, SITE_C = 4, 16, 16, 8


@contextlib.contextmanager
def _recording(common_mod, seen: set):
    """Install a constraint that records (calling function, logical axes,
    shape) of every ``shard`` call and changes nothing."""
    import sys

    def record(x, axes):
        seen.add((sys._getframe(2).f_code.co_name, tuple(axes),
                  tuple(int(n) for n in x.shape)))
        return x
    common_mod.set_constraint_fn(record)
    try:
        yield
    finally:
        common_mod.reset_constraint_fn()


def _flash_applies(cfg) -> bool:
    return cfg.n_heads > 0 and cfg.sliding_window is None


def _jax_sites(arch) -> set:
    """JAX's train forward, prefill and decode step traced on stand-ins,
    and its flash-prefill chunk (Pallas, interpreted) run on zeros."""
    from repro.launch import shapes as jshp
    from repro.models import attention as jattn
    from repro.models import common as jcommon
    from repro.models import kvcache as jkv
    cfg = jconfigs.get_smoke_config(arch)
    model = jmake_model(cfg)
    seen = set()
    with _recording(jcommon, seen):
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        train = jshp.batch_specs(cfg, jshp.ShapeSpec(
            "t", "train", SITE_S, SITE_B), jnp.float32)
        jax.eval_shape(model.forward, params, train)
        jax.eval_shape(lambda p, b: model.prefill(p, b, SITE_T), params,
                       train)
        cache = jshp.cache_specs(model, jshp.ShapeSpec(
            "d", "decode", SITE_T, SITE_B))
        jax.eval_shape(model.decode_step, params, cache,
                       jax.ShapeDtypeStruct((SITE_B,), jnp.int32))
        if _flash_applies(cfg):
            jattn.attention_prefill_cached(
                jattn.init_attention(jax.random.PRNGKey(0), "a", cfg), cfg,
                jnp.zeros((SITE_B, SITE_C, cfg.d_model)),
                jkv.init_attn_cache(cfg, SITE_B, SITE_T),
                jnp.zeros((SITE_B,), jnp.int32), impl="pallas")
    return seen


def _port_sites(arch) -> set:
    """The port's same runs on zeros on the CPU; its flash branch runs on
    the plain version of the kernel."""
    from unittest import mock
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import shapes as tshp
    from repro_torch.models import attention as tattn
    from repro_torch.models import common as tcommon
    cfg = tconfigs.get_smoke_config(arch)
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    train = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in tshp.batch_specs(cfg, tshp.ShapeSpec(
                 "t", "train", SITE_S, SITE_B), torch.float32).items()}
    flash = kops.flash_prefill_attention
    seen = set()
    with _recording(tcommon, seen), torch.no_grad():
        model.forward(params, train)
        _, cache = model.prefill(params, train, SITE_T)
        model.decode_step(params, cache, torch.zeros(SITE_B,
                                                     dtype=torch.long))
        if _flash_applies(cfg):
            attn_p = next(lp["attn"] for lp in params["layers"]
                          if "attn" in lp)
            with mock.patch.object(kops, "resolve_impl",
                                   lambda impl, x: "cuda"), \
                    mock.patch.object(
                        kops, "flash_prefill_attention",
                        lambda *a, impl=None, **kw: flash(*a, impl="plain",
                                                          **kw)):
                tattn.attention_prefill_cached(
                    attn_p, cfg, torch.zeros(SITE_B, SITE_C, cfg.d_model),
                    kvcache.init_attn_cache(cfg, SITE_B, SITE_T, "cpu"),
                    torch.zeros(SITE_B, dtype=torch.int32))
    return seen


@pytest.fixture(scope="module")
def site_records():
    return {arch: (_jax_sites(arch), _port_sites(arch))
            for arch in tconfigs.ARCH_IDS}


def test_every_jax_site_has_its_counterpart(site_records):
    """Across the 10 smoke configs, JAX's 17 ``shard`` sites are reached,
    and the port annotates at the same functions with the same logical
    axes."""
    jax_sites = {(f, a) for j, _ in site_records.values() for f, a, _ in j}
    port_sites = {(f, a) for _, t in site_records.values() for f, a, _ in t}
    assert jax_sites == SITES
    assert port_sites == SITES


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_activation_sites_place_as_jax(site_records, arch):
    """Every ``shard`` call of the arch's train forward, prefill, decode
    step and flash chunk has JAX's counterpart (function, logical axes
    and shape). Under each rule set on the (2, 4) and (2, 2, 2) meshes
    the port's constraint places it as JAX's ``logical_to_spec`` does:
    the spec, and the placements of the DTensor that the installed
    constraint returns (on a ``fake`` group of 8 ranks)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as msh
    from repro_torch.models import common as tcommon
    jax_seen, port_seen = site_records[arch]
    assert port_seen == jax_seen
    for sizes, names in MESHES[1:]:
        jmesh = AbstractMesh(sizes, names)
        with msh.fake_world(8):
            mesh = msh.device_mesh(msh.make_mesh(sizes, names))
            for rname in SITE_RULES:
                jr, tr = getattr(jshd, rname), getattr(shd, rname)
                with shd.activate(mesh, tr):
                    for fn, axes, shape in sorted(port_seen, key=str):
                        want = _norm(jshd.logical_to_spec(jmesh, jr, axes,
                                                          shape))
                        got = shd.logical_to_spec(mesh, tr, axes, shape)
                        assert _norm(got) == want, (fn, axes, shape, rname)
                        x = DTensor.from_local(
                            torch.zeros(shape), mesh,
                            [Replicate()] * len(names), run_check=False)
                        out = tcommon.shard(x, *axes)
                        if len(shape) != len(axes):     # passes, as in JAX
                            assert out is x, (fn, axes, shape)
                            continue
                        placed = shd.placements(
                            want + (None,) * (len(shape) - len(want)), mesh)
                        assert tuple(out.placements) == placed, (
                            fn, axes, shape, rname, names)
                        assert out.shape == x.shape


def test_constraint_semantics_and_activate_undone(mesh1):
    """Installed rules redistribute a DTensor of the annotation's rank and
    pass a plain tensor, and a DTensor of another rank, unchanged;
    ``activate`` uninstalls also when its body raises."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.models import common as tcommon
    plain = torch.arange(6.0).reshape(2, 3)
    dt = DTensor.from_local(plain, mesh1, [Replicate(), Replicate()],
                            run_check=False)
    with shd.activate(mesh1, shd.SERVE_RULES):
        assert tcommon.shard(plain, "batch", "embed") is plain
        assert tcommon.shard(dt, "batch", "seq", "embed") is dt  # rank 3
        out = tcommon.shard(dt, "batch", "vocab")
        assert out is not dt and torch.equal(out.full_tensor(), plain)
        assert out.placements[0].is_shard(0)        # "batch" on "data"
    assert tcommon.shard(dt, "batch", "vocab") is dt
    with pytest.raises(ZeroDivisionError):
        with shd.activate(mesh1, shd.TRAIN_RULES_SP):
            assert tcommon.shard(dt, "batch", "vocab") is not dt
            1 / 0
    assert tcommon.shard(dt, "batch", "vocab") is dt


def test_plain_tensors_untouched_under_rules():
    """With rules installed (the sequence-parallel serving rules on a
    (2, 4) mesh), the serve, train and AFD paths on CPU tensors give the
    bits of the run without them: granite's ``Model.prefill`` and
    ``decode_step``, one ``build_step_fn`` step, and the AFD engine over
    a seeded trace (its summary and every output token)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.afd import AFDRuntime
    from repro_torch.serving.afd_engine import AFDServeEngine
    from repro_torch.serving.workload import generate_trace, get_profile
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train import build_step_fn
    cfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (2, 6)).astype(np.int64))

    def run():
        model = make_model(cfg, device="cpu")
        params = model.init(0)
        lg, cache = model.prefill(params, {"tokens": toks}, 16)
        lg1, cache = model.decode_step(params, cache, toks[:, 0])
        opt = topt.adamw()
        new_p, _, m = build_step_fn(model, opt)(params, opt.init(params),
                                                {"tokens": toks})
        eng = AFDServeEngine(AFDRuntime(cfg, params, device="cpu"),
                             max_len=32, n_bo=2, mb_slots=2,
                             tick_seconds=0.01)
        eng.run(generate_trace(get_profile("poisson-burst"), seed=0,
                               max_requests=4))
        return ([lg, lg1, m["loss"], m["grad_norm"]] + tree_leaves(cache)
                + tree_leaves(new_p), eng.summary(),
                {r.rid: r.output for r in eng.completed})

    want = run()
    with shd.activate(shd.MeshShape(("data", "model"), (2, 4)),
                      shd.SERVE_RULES_SP):
        got = run()
    assert len(got[0]) == len(want[0])
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
    assert got[1:] == want[1:] and len(got[2]) == 4


# ---------------------------------------------------------------------------
# world size 1 on a gloo group (test_parallel.py's one-device cases)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _group(path, backend="gloo", device_type="cpu"):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group(backend, init_method=f"file://{path}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh(device_type, (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.fixture
def mesh1(tmp_path):
    with _group(tmp_path / "rendezvous") as mesh:
        yield mesh


def _moe_cfgs(**kw):
    base = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
                n_kv_heads=2, d_head=16, d_ff=0, vocab_size=64, n_experts=8,
                top_k=2, moe_d_ff=16)
    base.update(kw)
    return (JArchConfig(**base),
            ArchConfig(**base, dtype="float32", param_dtype="float32"))


def _jax_moe(jcfg):
    p = jmoe.init_moe(jax.random.PRNGKey(0), "m", jcfg)
    return p, {k: torch.from_numpy(np.array(v, np.float32))
               for k, v in p.items()}


def _jmesh1():
    return compat.make_mesh((1, 1), ("data", "model"))


def test_ep_train_and_decode_match_oracle_and_jax_1rank(mesh1):
    jcfg, tcfg = _moe_cfgs(moe_capacity_factor=8.0)
    jp, tp = _jax_moe(jcfg)
    x = np.random.default_rng(1).standard_normal((4, 8, 32)).astype(
        np.float32) * 0.5
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    ref = jmoe_ffn_ref(jx.reshape(-1, 32), jp["router"], jp["wi"], jp["wo"],
                       jcfg.top_k).reshape(x.shape)
    jmesh = _jmesh1()
    jepc = jep.EPConfig(mesh=jmesh, ep_axis="model", dp_axes=("data",),
                        capacity_factor=8.0)
    with jmesh:
        jt, jaux = jax.jit(lambda pp, xx: jep.moe_ep_train(
            pp, jcfg, xx, jepc))(jp, jx)
    epc = ep.EPConfig(mesh=mesh1, dp_axes=("data",), capacity_factor=8.0)
    out_t, aux = ep.moe_ep_train(tp, tcfg, tx, epc)
    out_d = ep.moe_ep_decode(tp, tcfg, tx, epc)
    out_e = ep.moe_ep_decode_etp(tp, tcfg, tx, dataclasses.replace(
        epc, etp=True))
    for got in (out_t, out_d, out_e):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(
        out_d.numpy(), moe_ffn_ref(tx.reshape(-1, 32), tp["router"],
                                   tp["wi"], tp["wo"], 2).reshape(
            x.shape).numpy(), atol=1e-5)
    assert float(aux) > 0
    # one rank holds every expert: the decode is moe_sorted's, bit for bit
    assert torch.equal(out_d, moe.moe_sorted(tp, tcfg, tx))


def test_ep_train_differentiable_matches_jax_grad_1rank(mesh1):
    jcfg, tcfg = _moe_cfgs(moe_capacity_factor=4.0)
    jp, tp = _jax_moe(jcfg)
    x = np.random.default_rng(2).standard_normal((2, 4, 32)).astype(
        np.float32)
    jmesh = _jmesh1()
    jepc = jep.EPConfig(mesh=jmesh, ep_axis="model", dp_axes=("data",),
                        capacity_factor=4.0)

    def jloss(pp):
        out, aux = jep.moe_ep_train(pp, jcfg, jnp.asarray(x), jepc)
        return jnp.sum(out ** 2) + 0.01 * aux

    with jmesh:
        jg = jax.jit(jax.grad(jloss))(jp)
    epc = ep.EPConfig(mesh=mesh1, dp_axes=("data",), capacity_factor=4.0)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    out, aux = ep.moe_ep_train(tp, tcfg, torch.from_numpy(x), epc)
    (out.square().sum() + 0.01 * aux).backward()
    for name in ("wi", "wo", "router"):
        g = tp[name].grad
        assert float(g.norm()) > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   atol=1e-4, err_msg=name)


def test_ep_hook_installs_into_model(mesh1):
    """The hook installs and uninstalls. At world size 1 a model's decode
    step under it is bit-identical to the single-program one (the EP
    decode holds every expert and its all-reduce is over one rank), and
    its prefill (the EP train path) agrees with the capacity path's when
    neither drops (capacity factor 8 on both)."""
    epc = ep.EPConfig(mesh=mesh1, dp_axes=("data",), capacity_factor=8.0)
    assert moe._EP_FORWARD is None
    with ep.activate(epc):
        assert moe._EP_FORWARD is not None
    assert moe._EP_FORWARD is None
    cfg = dataclasses.replace(
        tconfigs.get_smoke_config("granite-moe-1b-a400m"),
        moe_capacity_factor=8.0)
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.randint(1, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(3))
    lg, cache = model.prefill(params, {"tokens": toks[:, :4]}, 8)
    with ep.activate(epc):
        lg_ep, _ = model.prefill(params, {"tokens": toks[:, :4]}, 8)
    np.testing.assert_allclose(lg_ep.numpy(), lg.numpy(), atol=1e-5)
    steps = []
    for active in (False, True):
        c = {k: ([{n: t.clone() for n, t in lc.items()} for lc in v]
                 if k == "layers" else v.clone()) for k, v in cache.items()}
        with (ep.activate(epc) if active else contextlib.nullcontext()):
            steps.append(model.decode_step(params, c, toks[:, 4])[0])
    assert torch.equal(steps[0], steps[1])


def test_ep_fallback_when_experts_not_divisible():
    """6 experts on a 4-wide EP axis: the hook falls back to the
    single-program paths (no process group is touched)."""
    _, tcfg = _moe_cfgs(n_experts=6)
    tp = moe.init_moe(0, "m", tcfg, "cpu")
    mesh = shd.MeshShape(("data", "model"), (1, 4))
    fwd = ep.make_ep_forward(ep.EPConfig(mesh=mesh, dp_axes=("data",)))
    x = torch.randn(2, 4, 32, generator=torch.Generator().manual_seed(1))
    out, aux = fwd(tp, tcfg, x, "train")
    want, want_aux = moe.moe_capacity(tp, tcfg, x)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
    out, aux = fwd(tp, tcfg, x, "decode")
    assert torch.equal(out, moe.moe_sorted(tp, tcfg, x)) and float(aux) == 0


@pytest.mark.parametrize("n_blocks", [1, 2, 4])
def test_expert_ffn_blocks_sum_to_jax_oracle(n_blocks):
    """``expert_ffn`` over blocks of the experts (``first_expert``): the
    blocks' outputs sum to JAX's ``moe_ffn_ref``, a token with no pair in
    a block gets exactly 0 from it, and the first block of all E experts
    sorts as ``sort_by_expert`` does."""
    jcfg, tcfg = _moe_cfgs(top_k=2)
    jp, tp = _jax_moe(jcfg)
    x = np.random.default_rng(5).standard_normal((16, 32)).astype(
        np.float32) * 0.5
    tx = torch.from_numpy(x)
    _, topw, topi = moe.route(tp, tcfg, tx)
    e_loc = tcfg.n_experts // n_blocks
    total = torch.zeros_like(tx)
    for j in range(n_blocks):
        blk = slice(j * e_loc, (j + 1) * e_loc)
        part = moe.expert_ffn(tcfg, tp["wi"][blk], tp["wo"][blk], tx, topw,
                              topi, first_expert=j * e_loc)
        away = ((topi < blk.start) | (topi >= blk.stop)).all(-1)
        assert not part[away].any()
        total += part
    want = jmoe_ffn_ref(jnp.asarray(x), jp["router"], jp["wi"], jp["wo"],
                        jcfg.top_k)
    np.testing.assert_allclose(total.numpy(), np.asarray(want), atol=1e-5)
    sort_idx, sizes = moe.sort_by_local_expert(topi, 0, tcfg.n_experts)
    whole_idx, _, whole_sizes = moe.sort_by_expert(topi, tcfg.n_experts)
    assert torch.equal(sort_idx, whole_idx)
    assert torch.equal(sizes, whole_sizes)


def test_splitkv_decode_matches_ref_1rank(mesh1):
    b, hq, hkv, d, t = 2, 4, 2, 16, 64
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    pos = np.asarray([40, 13], np.int32)
    want = jsplitkv_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(pos) + 1)
    specs = coll.splitkv_specs(mesh1, "model", b)
    assert specs["kv"] == ("data", "model", None, None)
    got = coll.splitkv_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, pos)), mesh=mesh1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# NCCL at world size 1 on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nccl_ep_decode_equals_moe_sorted_on_kernels(cuda, tmp_path, dtype):
    """One NCCL rank holds every expert: the EP decode runs the grouped
    GEMM kernel exactly as ``moe_sorted`` does, and its all-reduce over
    one rank changes no bit."""
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(
        tconfigs.get_smoke_config("granite-moe-1b-a400m"), dtype=dtype,
        param_dtype=dtype)
    p = moe.init_moe(0, "m", cfg, cuda)
    x = torch.randn(4, 1, cfg.d_model, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda).to(cfg.compute_dtype)
    with _group(tmp_path / "rendezvous", "nccl", "cuda") as mesh:
        ops.reset_launch_counts()
        got = ep.moe_ep_decode(p, cfg, x, ep.EPConfig(mesh=mesh))
        assert ops.launch_counts()["grouped_gemm"] == 2
        assert torch.equal(got, moe.moe_sorted(p, cfg, x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nccl_splitkv_one_shard_equals_kernel(cuda, tmp_path, dtype):
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn(4, 8, 64, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(4, 256, 4, 64, generator=g, device=cuda).to(dt)
            for _ in range(2))
    pos = torch.tensor([0, 17, 200, 255], dtype=torch.int32, device=cuda)
    with _group(tmp_path / "rendezvous", "nccl", "cuda") as mesh:
        got = coll.splitkv_decode_attention(q, k, v, pos, mesh)
    assert torch.equal(got, ops.splitkv_attention(q, k, v, pos + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_blocks_on_kernels_match_plain(cuda, dtype):
    """The grouped GEMM's block mode on the card (the path EP decode over
    several ranks and the F role over N_F blocks run): each of 4 blocks
    on the kernels against its plain path, tokens with no pair in their
    block exactly 0, and the blocks' sum against the whole-expert call."""
    cfg = dataclasses.replace(
        tconfigs.get_smoke_config("granite-moe-1b-a400m"), dtype=dtype,
        param_dtype=dtype)
    p = moe.init_moe(0, "m", cfg, cuda)
    x = torch.randn(64, cfg.d_model, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda).to(cfg.compute_dtype)
    _, topw, topi = moe.route(p, cfg, x)
    whole = moe.expert_ffn(cfg, p["wi"], p["wo"], x, topw, topi)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    e_loc = cfg.n_experts // 4
    total = torch.zeros_like(whole)
    for j in range(4):
        blk = slice(j * e_loc, (j + 1) * e_loc)
        got, plain = (moe.expert_ffn(cfg, p["wi"][blk], p["wo"][blk], x,
                                     topw, topi, impl, first_expert=j * e_loc)
                      for impl in (None, "plain"))
        assert float((got.float() - plain.float()).norm()
                     / plain.float().norm()) <= tol
        assert not got[((topi < blk.start) | (topi >= blk.stop)).all(-1)].any()
        total += got
    assert float((total.float() - whole.float()).norm()
                 / whole.float().norm()) <= tol


@pytest.mark.gpu
def test_afd_f_role_over_four_blocks_on_card(cuda):
    """The AFD runtime with ``f_devices = [cuda] * 4`` on the kernels:
    decode logits within 1e-4 of N_F = 1's (float32), four times the
    grouped-GEMM launches per M2N cycle."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.afd import AFDRuntime
    cfg = dataclasses.replace(
        tconfigs.get_smoke_config("granite-moe-1b-a400m"), dtype="float32",
        param_dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    tokens = torch.tensor([7, 123], dtype=torch.int32, device=cuda)
    logits, per_cycle = [], []
    for n_f in (1, 4):
        rt = AFDRuntime(cfg, params, f_devices=[cuda] * n_f)
        caches, pos = rt.init_cache(2, 8)
        ops.reset_launch_counts()
        logits.append(rt.decode_step(tokens, caches, pos)[0])
        per_cycle.append(ops.launch_counts()["grouped_gemm"]
                         / rt.stats.dispatches)
    assert per_cycle == [2, 8]
    np.testing.assert_allclose(logits[1].cpu().numpy(),
                               logits[0].cpu().numpy(), atol=1e-4)
