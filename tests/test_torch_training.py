"""The port's training substrate against the JAX package's and on its own:
optimizers (AdamW with clipping and weight decay, Adafactor with factored
and full leaves) and their utilities against JAX on the same numpy trees,
the data stream bit for bit, and ports of ``tests/test_training.py``
(loss decreases, grad-accumulation equivalence, factored state,
checkpoint round trip / GC / uncommitted dirs, bitwise restart), a bf16
checkpoint round trip, remat's gradients, and on the card a float32 step
against the CPU and the restart. Optimizer parity: ≤ 1e-6 relative per
leaf (float32, three updates)."""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.common import (tree_bytes, tree_leaves,  # noqa: E402
                                       tree_map)
from repro_torch.models.model import make_model  # noqa: E402
from repro_torch.training import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.training import data as data_mod  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.train import (TrainConfig,  # noqa: E402
                                        loss_and_grads, make_train_step)

OPT_RTOL = 1e-6


def _walk(t, j, name=""):
    """(path, torch leaf, JAX leaf) over a torch tree and the JAX tree of
    the same nesting."""
    if isinstance(t, dict):
        assert sorted(t) == sorted(j), name
        for k in t:
            yield from _walk(t[k], j[k], f"{name}/{k}")
    elif isinstance(t, (list, tuple)):
        assert len(t) == len(j), name
        for i, (a, b) in enumerate(zip(t, j)):
            yield from _walk(a, b, f"{name}/{i}")
    else:
        yield name, t, j


def _rel(t, j) -> float:
    t = t.detach().double().numpy()
    j = np.asarray(j, np.float64)
    return float(np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-12))


def _opt_tree(rng):
    """Factored leaves (2-D, 3-D expert-shaped), vectors, a list."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(6, 5), "experts": f(3, 4, 5), "b": f(5),
            "layers": [{"scale": f(4)}, {"scale": f(4), "wo": f(4, 7)}]}


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_jax(name):
    """Three updates from the same tree and gradients (global norms ~8, so
    AdamW's clip acts; weight decay on): params and every state leaf equal
    JAX's within 1e-6 relative; the step counter is int32 3; dtypes kept."""
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    make_j = getattr(jopt, name)
    make_t = getattr(opt_mod, name)
    jo, to = make_j(lr=1e-2, weight_decay=0.1), make_t(lr=1e-2,
                                                     weight_decay=0.1)
    jp, tp = _as_jax(params), _as_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(_as_jax(g), js, jp)
        tp, ts = to.update(_as_torch(g), ts, tp)
    assert to.name == jo.name == name
    for path, t, j in _walk(tp, jp):
        assert t.dtype == torch.float32
        assert _rel(t, j) <= OPT_RTOL, (path, _rel(t, j))
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3
    for path, t, j in _walk({k: v for k, v in ts.items() if k != "step"},
                            {k: v for k, v in js.items() if k != "step"}):
        assert t.dtype == torch.float32 and t.shape == j.shape, path
        assert _rel(t, j) <= OPT_RTOL, (path, _rel(t, j))


def test_update_keeps_param_dtypes_and_arguments():
    """bf16 params stay bf16, the float32 state stays float32, and
    ``update`` leaves its arguments as they were (a functional transform)."""
    p = {"w": torch.randn(4, 3).bfloat16(), "v": torch.randn(3)}
    g = {"w": torch.randn(4, 3).bfloat16(), "v": torch.randn(3)}
    for opt in (opt_mod.adamw(lr=1e-2), opt_mod.adafactor(lr=1e-2)):
        s = opt.init(p)
        before = [t.clone() for t in tree_leaves((p, s))]
        new_p, new_s = opt.update(g, s, p)
        assert new_p["w"].dtype == torch.bfloat16
        assert new_p["v"].dtype == torch.float32
        assert all(t.dtype == torch.float32 for t in tree_leaves(new_s)
                   if t.dtype.is_floating_point)
        assert not torch.equal(new_p["v"], p["v"])
        for a, b in zip(before, tree_leaves((p, s))):
            assert torch.equal(a, b)


def test_global_norm_clip_and_policy():
    rng = np.random.default_rng(1)
    tree = _opt_tree(rng)
    assert _rel(opt_mod.global_norm(_as_torch(tree)),
                jopt.global_norm(_as_jax(tree))) <= OPT_RTOL
    for max_norm in (1.0, 100.0):                    # clipped / untouched
        for path, t, j in _walk(
                opt_mod.clip_by_global_norm(_as_torch(tree), max_norm),
                jopt.clip_by_global_norm(_as_jax(tree), max_norm)):
            assert _rel(t, j) <= OPT_RTOL, path
    g = {"a": torch.ones(10) * 10.0}
    clipped = opt_mod.clip_by_global_norm(g, 1.0)
    assert float(opt_mod.global_norm(clipped)) == pytest.approx(1.0,
                                                                rel=1e-5)
    assert opt_mod.optimizer_for(1026.0).name == "adafactor"
    assert opt_mod.optimizer_for(8.0).name == "adamw"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internvl2-2b",
                                  "whisper-small"])
@pytest.mark.parametrize("kind", ["markov", "random"])
def test_batches_equal_jax(kind, arch):
    """make_batch at three steps, tokens and the vision / encoder inputs,
    bit for bit and in JAX's dtypes; the entropy floor equal."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    kw = dict(batch_size=3, seq_len=24, vocab_size=tcfg.vocab_size, seed=5,
              kind=kind)
    jdc, tdc = jdata.DataConfig(**kw), data_mod.DataConfig(**kw)
    for step in (0, 1, 17):
        jb = jdata.make_batch(jdc, step, jcfg)
        tb = data_mod.make_batch(tdc, step, tcfg, "cpu")
        assert sorted(tb) == sorted(jb)
        for k, want in jb.items():
            want = np.asarray(want)
            assert tb[k].numpy().dtype == want.dtype, k
            assert np.array_equal(tb[k].numpy(), want), (k, step)
    assert np.array_equal(data_mod._transition_table(tdc),
                          jdata._transition_table(jdc))
    assert data_mod.entropy_floor(tdc) == jdata.entropy_floor(jdc)
    it = data_mod.batches(tdc, tcfg, start_step=17, device="cpu")
    assert torch.equal(next(it)["tokens"], tb["tokens"])


def test_data_determinism_and_learnability():
    dc = data_mod.DataConfig(batch_size=4, seq_len=64, vocab_size=128)
    b1 = data_mod.make_batch(dc, 7, device="cpu")
    b2 = data_mod.make_batch(dc, 7, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = data_mod.make_batch(dc, 8, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])
    table = data_mod._transition_table(dc)
    assert table.shape == (128, dc.branching)
    assert 0 < data_mod.entropy_floor(dc) < np.log(128)


# ---------------------------------------------------------------------------
# ports of tests/test_training.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    model = make_model(cfg, device="cpu")
    return cfg, model, model.init(0)


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_adamw_decreases_loss(setup):
    cfg, model, params = setup
    opt = opt_mod.adamw(lr=1e-2)
    state = opt.init(params)
    dc = data_mod.DataConfig(batch_size=8, seq_len=32,
                             vocab_size=cfg.vocab_size)
    step = make_train_step(model, opt)
    losses = []
    p = params
    for s in range(40):
        p, state, m = step(p, state, data_mod.make_batch(dc, s, cfg, "cpu"))
        losses.append(float(m["loss"]))
        assert sorted(m) == ["aux", "ce", "grad_norm", "loss", "ppl_proxy"]
    assert losses[-1] < losses[0] - 0.5


def test_grad_accumulation_equivalence():
    # dense arch: MoE capacity is per-microbatch, so drop patterns (and
    # hence grads) legitimately differ under accumulation
    cfg = tconfigs.get_smoke_config("qwen1.5-0.5b")
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    opt = opt_mod.adamw(lr=1e-3, grad_clip=None)
    dc = data_mod.DataConfig(batch_size=8, seq_len=16,
                             vocab_size=cfg.vocab_size)
    batch = data_mod.make_batch(dc, 0, cfg, "cpu")
    step1 = make_train_step(model, opt, TrainConfig(grad_accum=1))
    step4 = make_train_step(model, opt, TrainConfig(
        grad_accum=4, bf16_grad_reduce=False))
    p1, _, m1 = step1(params, opt.init(params), batch)
    p4, _, m4 = step4(params, opt.init(params), batch)
    # microbatched grads average to the full-batch grads (loss is a mean)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(model, opt, TrainConfig(grad_accum=3))(
            params, opt.init(params), batch)


def test_adafactor_state_is_factored(setup):
    cfg, model, params = setup
    opt = opt_mod.adafactor()
    state = opt.init(params)
    # factored second moments ≪ AdamW's 2× f32 params
    assert tree_bytes(state) < 0.6 * tree_bytes(params)
    newp, news = opt.update(tree_map(torch.ones_like, params), state,
                            params)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(newp))


def test_checkpoint_roundtrip_and_gc(setup):
    cfg, model, params = setup
    opt = opt_mod.adamw()
    state = opt.init(params)
    with tempfile.TemporaryDirectory() as d:
        for s in (10, 20, 30, 40):
            ckpt_mod.save(d, s, params, state)
        assert ckpt_mod.list_steps(d) == [10, 20, 30, 40]
        step, p2, s2, _ = ckpt_mod.restore_latest(d, params, state)
        assert step == 40
        assert _equal_trees(p2, params) and _equal_trees(s2, state)
        ck = ckpt_mod.AsyncCheckpointer(d, keep=2)
        ck.save(50, params, state, extra={"cursor": 50})
        ck.wait()
        assert ckpt_mod.list_steps(d) == [40, 50]
        assert ckpt_mod.restore_latest(d, params, state)[3] == {
            "cursor": 50}
    with tempfile.TemporaryDirectory() as d:
        assert ckpt_mod.restore_latest(d, params) is None


def test_uncommitted_checkpoint_ignored(setup):
    cfg, model, params = setup
    with tempfile.TemporaryDirectory() as d:
        ckpt_mod.save(d, 5, params)
        # simulate a crash mid-write: step 7 without COMMITTED
        crash = os.path.join(d, "step_000000007")
        os.makedirs(crash)
        with open(os.path.join(crash, "MANIFEST.json"), "w") as f:
            f.write("{}")
        assert ckpt_mod.list_steps(d) == [5]


def _restart(model, cfg, device):
    """Three steps, an async checkpoint at step 3, three more steps; then
    restore and repeat them. Returns (run A, run B) as (params, state)."""
    params = model.init(0)
    opt = opt_mod.adamw(lr=1e-3)
    state = opt.init(params)
    dc = data_mod.DataConfig(batch_size=4, seq_len=16,
                             vocab_size=cfg.vocab_size)
    step = make_train_step(model, opt)
    p, s = params, state
    for i in range(3):
        p, s, _ = step(p, s, data_mod.make_batch(dc, i, cfg, device))
    with tempfile.TemporaryDirectory() as d:
        ck = ckpt_mod.AsyncCheckpointer(d)
        ck.save(3, p, s)
        ck.wait()
        pa, sa = p, s
        for i in range(3, 6):
            pa, sa, _ = step(pa, sa, data_mod.make_batch(dc, i, cfg, device))
        _, pb, sb, _ = ckpt_mod.restore_latest(d, p, s)
        for i in range(3, 6):
            pb, sb, _ = step(pb, sb, data_mod.make_batch(dc, i, cfg, device))
    return (pa, sa), (pb, sb)


def test_restart_bitwise_determinism(setup):
    cfg, model, _ = setup
    (pa, sa), (pb, sb) = _restart(model, cfg, "cpu")
    assert _equal_trees(pa, pb) and _equal_trees(sa, sb)


def test_bf16_checkpoint_round_trip_is_bit_exact():
    """bf16 leaves go to disk as their uint16 bit patterns (manifest dtype
    "bfloat16") and come back bit for bit, specials included; float32 and
    int32 leaves keep their dtypes."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(5, 7, generator=g).bfloat16()
    w[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"),
                             -0.0]).bfloat16()
    tree = {"w": w, "layers": [{"s": torch.randn(3, generator=g)}],
            "n": torch.tensor(7, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        ckpt_mod.save(d, 1, tree)
        with open(os.path.join(d, "step_000000001", "MANIFEST.json")) as f:
            dtypes = {e["name"]: e["dtype"] for e in json.load(f)["leaves"]}
        assert dtypes == {"params.w": "bfloat16",
                          "params.layers._0.s": "float32",
                          "params.n": "int32"}
        raw = np.load(os.path.join(d, "step_000000001", "params.w.npy"))
        assert raw.dtype == np.uint16
        _, back, _, _ = ckpt_mod.restore(d, 1, tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(back["layers"][0]["s"], tree["layers"][0]["s"])
    assert back["n"].dtype == torch.int32 and int(back["n"]) == 7


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b",
                                  "whisper-small"])
def test_remat_gradients_bit_identical(arch):
    """cfg.remat checkpoints each layer (decoder and encoder): the loss and
    every gradient equal the un-rematerialised ones bit for bit."""
    cfg = tconfigs.get_smoke_config(arch)
    model = make_model(cfg, device="cpu")
    remat = make_model(dataclasses.replace(cfg, remat=True), device="cpu")
    params = model.init(0)
    dc = data_mod.DataConfig(batch_size=2, seq_len=16,
                             vocab_size=cfg.vocab_size)
    batch = data_mod.make_batch(dc, 0, cfg, "cpu")
    l0, m0, g0 = loss_and_grads(model, params, batch)
    l1, m1, g1 = loss_and_grads(remat, params, batch)
    assert torch.equal(l0, l1)
    assert _equal_trees(g0, g1)
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(g1))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_cuda_train_step_matches_cpu(cuda, arch):
    """One float32 step's gradients (TF32 off) on the card against the CPU
    on the same weights and batch: ≤ 1e-4 relative per leaf."""
    cfg = tconfigs.get_smoke_config(arch)
    cpu_model, gpu_model = make_model(cfg, device="cpu"), make_model(
        cfg, device=cuda)
    params = cpu_model.init(0)
    dc = data_mod.DataConfig(batch_size=2, seq_len=16,
                             vocab_size=cfg.vocab_size)
    batch = data_mod.make_batch(dc, 0, cfg, "cpu")
    _, _, g_cpu = loss_and_grads(cpu_model, params, batch)
    _, _, g_gpu = loss_and_grads(
        gpu_model, tree_map(lambda t: t.to(cuda), params),
        {k: v.to(cuda) for k, v in batch.items()})
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
        assert bool(torch.isfinite(a).all())
        err = float((a.cpu().double() - b.double()).norm()
                    / b.double().norm().clamp(min=1e-12))
        assert err <= 1e-4, err


@pytest.mark.gpu
def test_cuda_restart_bitwise_determinism(cuda, monkeypatch):
    """The restart on the card, with deterministic algorithms on (the
    embedding's and the loss gather's backward otherwise accumulate with
    atomics; cuBLAS asks for a fixed workspace): bit-identical params and
    optimizer state."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    model = make_model(cfg, device=cuda)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        (pa, sa), (pb, sb) = _restart(model, cfg, cuda)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert _equal_trees(pa, pb) and _equal_trees(sa, sb)
