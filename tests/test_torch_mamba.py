"""Jamba's hybrid Mamba-2/attention MoE on the port's AFD path, on the CPU
against the JAX package: the Mamba-2 decode step and its gated RMSNorm,
the bridge's dtypes on a bf16 tree, ``AFDRuntime`` decode (one micro-batch
and the 3BO rotation), chunked prefill against teacher forcing inside the
port, bf16 drift against JAX's own, the serving engine against JAX's on
one trace (with a prompt shorter than the SSM head count), and
``rescale``. Inputs come from numpy seeds; weights cross from JAX through
the numpy bridge."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models.layers import gated_rmsnorm as jgated  # noqa: E402
from repro.models.model import make_model  # noqa: E402
from repro.parallel.afd import AFDRuntime as JAFDRuntime  # noqa: E402
from repro.serving.afd_engine import AFDServeEngine as JEngine  # noqa: E402
from repro.serving.workload import ArrivalEvent as JArrival  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models.layers import gated_rmsnorm  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.parallel.afd import AFDRuntime, rescale  # noqa: E402
from repro_torch.serving.afd_engine import AFDServeEngine  # noqa: E402
from repro_torch.serving.workload import ArrivalEvent  # noqa: E402

ARCH = "jamba-v0.1-52b"
# f32: the ROADMAP's attention tolerances; bf16: its bf16 tolerance
TOL = {"float32": dict(atol=1e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x), tree)


def _configs(dtype: str = "float32"):
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=dtype,
                                param_dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype,
                                param_dtype=dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def jamba():
    """JAX's f32 Jamba smoke model and its weights bridged to the port."""
    jcfg, tcfg = _configs()
    jparams = make_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_jax(tcfg, _numpy_tree(jparams),
                                                "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax(dtype):
    """Six ``mamba_decode`` steps from a zero cache on JAX's layer-0 Mamba
    weights: outputs, conv tail and float32 state each step; and
    ``gated_rmsnorm`` on the same inputs."""
    jcfg, tcfg = _configs(dtype)
    jp = make_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")["layers"][0]["mamba"]
    jpar = jax.tree_util.tree_map(lambda x: x[0],
                                  jp["decoder"]["stack"][0]["mamba"])
    rng = np.random.default_rng(3)
    jdt, tdt = jnp.dtype(dtype), TORCH_DTYPE[dtype]
    jc, tc = jkv.init_ssm_cache(jcfg, 2), tkv.init_ssm_cache(tcfg, 2, "cpu")
    assert tc["state"].dtype == torch.float32 and tc["conv"].dtype == tdt
    for _ in range(6):
        x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        want, jc = jmamba.mamba_decode(jpar, jcfg, jnp.asarray(x, jdt), jc)
        got, tc = tmamba.mamba_decode(tp, tcfg, torch.from_numpy(x).to(tdt),
                                      tc)
        assert got.dtype == tdt and tc["state"].dtype == torch.float32
        for g, w in ((got, want), (tc["conv"], jc["conv"]),
                     (tc["state"], jc["state"])):
            np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])
    x = rng.standard_normal((2, 3, tcfg.d_inner)).astype(np.float32)
    z = rng.standard_normal((2, 3, tcfg.d_inner)).astype(np.float32)
    scale = rng.standard_normal(tcfg.d_inner).astype(np.float32)
    want = jgated(jnp.asarray(scale, jdt), jnp.asarray(x, jdt),
                  jnp.asarray(z, jdt))
    got = gated_rmsnorm(torch.from_numpy(scale).to(tdt),
                        torch.from_numpy(x).to(tdt),
                        torch.from_numpy(z).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_bridge_bf16_jamba_keeps_jax_dtypes():
    """A bf16 Jamba tree through the bridge: every leaf has JAX's dtype,
    so A_log, D, dt_bias and the router stay float32."""
    jcfg, tcfg = _configs("bfloat16")
    jp = make_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")
    plan = tcfg.layer_plan()
    assert not plan.prefix
    want_dt = {jnp.dtype("bfloat16"): torch.bfloat16,
               jnp.dtype("float32"): torch.float32}
    seen = set()
    for i, layer in enumerate(tp["layers"]):
        jl = jax.tree_util.tree_map(
            lambda x: x[i // len(plan.period)],
            jp["decoder"]["stack"][i % len(plan.period)])
        flat_j = jax.tree_util.tree_flatten_with_path(jl)[0]
        for path, leaf in flat_j:
            t = layer
            for key in path:
                t = t[key.key]
            assert t.dtype == want_dt[leaf.dtype], (i, path)
            assert tuple(t.shape) == leaf.shape, (i, path)
            seen.add((path[-1].key, t.dtype))
    for name in ("A_log", "D", "dt_bias", "router"):
        assert (name, torch.float32) in seen
    assert ("in_proj", torch.bfloat16) in seen
    assert tp["embed"]["tok"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["decode_step", "decode_step_3bo"])
def test_jamba_runtime_matches_jax(jamba, mode):
    """Six decode steps of two sequences (two micro-batches of two in the
    3BO rotation) against JAX's AFDRuntime on the same weights; logits
    within 1e-4 as JAX's own AFD test holds them, caches within the f32
    tolerance, and the dispatch bytes of every M2N cycle as Eq. 9 prices
    them."""
    jcfg, jparams, tcfg, tparams = jamba
    n_mb = 1 if mode == "decode_step" else 2
    B, S = 2, 6
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                             (n_mb, B, S))
    devs = jax.devices()
    jrt = JAFDRuntime(jcfg, jparams, [devs[0]], [devs[-1]])
    rt = AFDRuntime(tcfg, tparams, device="cpu")
    jst = [[*jrt.init_cache(B, S + 2)] for _ in range(n_mb)]
    tst = [[*rt.init_cache(B, S + 2)] for _ in range(n_mb)]
    for t in range(S):
        if mode == "decode_step":
            want, jst[0][0], jst[0][1] = jrt.decode_step(
                jnp.asarray(toks[0, :, t], jnp.int32), *jst[0])
            got, tst[0][0], tst[0][1] = rt.decode_step(
                torch.from_numpy(toks[0, :, t]), *tst[0])
            wants, gots = [want], [got]
        else:
            jout = jrt.decode_step_3bo(
                [(jnp.asarray(toks[m, :, t], jnp.int32), *jst[m])
                 for m in range(n_mb)], n_bo=n_mb)
            tout = rt.decode_step_3bo(
                [(torch.from_numpy(toks[m, :, t]), *tst[m])
                 for m in range(n_mb)], n_bo=n_mb)
            wants, gots = [o[0] for o in jout], [o[0] for o in tout]
            jst = [[o[1], o[2]] for o in jout]
            tst = [[o[1], o[2]] for o in tout]
    for got, want in zip(gots, wants):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for (tc, _), (jc, _) in zip(tst, jst):
        for layer, (g, w) in enumerate(zip(tc, jc)):
            for name in g:
                np.testing.assert_allclose(_np(g[name]), _np(w[name]),
                                           atol=1e-4, err_msg=f"{layer}")
    moe_layers = sum(s.moe for s in rt.specs)
    assert rt.stats.dispatches == S * n_mb * moe_layers
    per = rt.stats.dispatch_bytes / rt.stats.dispatches
    assert per == B * tcfg.d_model * 4 + B * tcfg.top_k * 8
    assert (rt.stats.dispatch_bytes, rt.stats.combine_bytes) == (
        jrt.stats.dispatch_bytes, jrt.stats.combine_bytes)


def test_jamba_bf16_drift_matches_jax():
    """A 16-token chunk and 4 decode steps of the Jamba smoke model with
    bf16 weights, run with bf16 and with float32 activations in both
    packages. In float32 the port equals JAX to 1e-4 (relative); in bf16
    the hybrid stack amplifies rounding, so JAX's own bf16 run lies ~1e-1
    from its float32 run. The port's bf16 run must lie no farther from
    JAX's bf16 run, nor from its own float32 run, than twice that: the
    drift is the reference's, not the port's. (This is why the card's
    Jamba path check replays the kernel run's expert choices.)"""
    toks = np.random.default_rng(1).integers(1, 256, (2, 20)).astype(
        np.int32)
    jb, tb = _configs("bfloat16")
    jp = make_model(jb).init(jax.random.PRNGKey(0))
    tp = params_from_jax(tb, _numpy_tree(jp), "cpu")
    devs = jax.devices()

    def run(rt, to_tensor, to_numpy):
        caches, pos = rt.init_cache(2, 32)
        lg, caches, pos = rt.prefill(to_tensor(toks[:, :16]), caches, pos)
        out = [to_numpy(lg)]
        for j in range(16, 20):
            lg, caches, pos = rt.decode_step(to_tensor(toks[:, j]), caches,
                                             pos)
            out.append(to_numpy(lg)[:, None])
        return np.concatenate(out, axis=1)
    f32 = dict(dtype="float32")
    jp32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp)
    got = {
        "jax_bf16": run(JAFDRuntime(jb, jp, [devs[0]], [devs[-1]]),
                        jnp.asarray, _np),
        "jax_f32": run(JAFDRuntime(dataclasses.replace(
            jb, param_dtype="float32", **f32), jp32, [devs[0]], [devs[-1]]),
            jnp.asarray, _np),
        "port_bf16": run(AFDRuntime(tb, tp, device="cpu"), torch.from_numpy,
                         _np),
        "port_f32": run(AFDRuntime(dataclasses.replace(tb, **f32), tp,
                                   device="cpu"), torch.from_numpy, _np)}

    def rel(a, b):
        return np.linalg.norm(got[a] - got[b]) / np.linalg.norm(got[b])
    assert rel("port_f32", "jax_f32") <= 1e-4
    drift = rel("jax_bf16", "jax_f32")
    assert 0 < drift
    assert rel("port_bf16", "jax_bf16") <= 2 * drift
    assert rel("port_bf16", "port_f32") <= 2 * drift


@pytest.fixture(scope="module")
def port_jamba():
    cfg = tconfigs.get_smoke_config(ARCH)
    return AFDRuntime(cfg, init_params(cfg, seed=0, device="cpu"),
                      device="cpu")


@pytest.mark.parametrize("chunk", [1, 3, 7, None])
def test_jamba_prefill_bit_exact_vs_teacher_forcing(port_jamba, chunk):
    """Chunked prefill on the plain path (Mamba layers step the chunk,
    attention layers take it whole) gives the logits and every cache leaf
    of token-by-token decode, bit for bit."""
    rt = port_jamba
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, rt.cfg.vocab_size, size=(2, 7)).astype(np.int32))
    caches, pos = rt.init_cache(2, 16)
    ref = []
    for j in range(tokens.shape[1]):
        lg, caches, pos = rt.decode_step(tokens[:, j], caches, pos)
        ref.append(lg)
    c2, p2 = rt.init_cache(2, 16)
    lg, c2, p2 = rt.prefill(tokens, c2, p2, chunk=chunk)
    assert torch.equal(lg, torch.stack(ref, dim=1))
    assert torch.equal(p2, pos)
    kinds = set()
    for spec, got, want in zip(rt.specs, c2, caches):
        assert got.keys() == want.keys()
        for name in got:
            assert torch.equal(got[name], want[name]), (spec, name)
        kinds.add(spec.kind)
    assert kinds == {"attn", "mamba"}


# Prompt lengths of the engine trace: 5 is shorter than the smoke config's
# 8 SSM heads (the state's head axis), 13 spans chunks of 4 unevenly.
ENGINE_TRACE = ((0, 0.0, 5, 6), (1, 0.0, 13, 3), (2, 0.02, 9, 5),
                (3, 0.05, 3, 4))


@pytest.fixture(scope="module")
def engine_runs(jamba):
    """Both engines over one trace, legacy and chunked (chunk 4), on a
    16-slot cache: two micro-batches of two slots, so requests reuse
    drained slots."""
    jcfg, jparams, tcfg, tparams = jamba
    assert len([e for e in ENGINE_TRACE if e[2] < tcfg.ssm_heads]) == 2
    devs = jax.devices()
    out = {}
    for chunk in (None, 4):
        kw = dict(max_len=16, n_bo=2, mb_slots=1, tick_seconds=0.01,
                  prefill_chunk=chunk)
        jeng = JEngine(JAFDRuntime(jcfg, jparams, [devs[0]], [devs[-1]]),
                       **kw)
        jeng.run([JArrival(rid=r, t=t, prompt_len=p, max_new_tokens=n)
                  for r, t, p, n in ENGINE_TRACE], max_ticks=500)
        eng = AFDServeEngine(AFDRuntime(tcfg, tparams, device="cpu"), **kw)
        eng.run([ArrivalEvent(rid=r, t=t, prompt_len=p, max_new_tokens=n)
                 for r, t, p, n in ENGINE_TRACE], max_ticks=500)
        out[chunk] = (jeng, eng)
    return out


@pytest.mark.parametrize("chunk", [None, 4], ids=["legacy", "chunked"])
def test_jamba_engine_matches_jax(engine_runs, chunk):
    """Equal greedy tokens, equal window rows (the clock is virtual, so
    every float is the same sum in the same order), byte-exact windows and
    JAX's slot bytes, which count each Mamba layer's conv tail and state."""
    jeng, eng = engine_runs[chunk]
    assert eng.kv_slot_bytes == jeng.kv_slot_bytes
    assert eng._kv_static_bytes > 0
    assert eng.kv_request_bytes(5, 6) == jeng.kv_request_bytes(5, 6)
    outs = {r.rid: r.output for r in eng.completed}
    assert len(outs) == len(ENGINE_TRACE)
    assert outs == {r.rid: r.output for r in jeng.completed}
    rows = [dataclasses.asdict(w) for w in eng.windows]
    assert rows == [dataclasses.asdict(w) for w in jeng.windows]
    assert rows and all(w["bytes_match"] for w in rows)


def test_jamba_rescale_is_bit_identical(port_jamba):
    """``rescale`` onto the same device split gives bit-identical decode
    logits and shares the expert weights."""
    rt = port_jamba
    rt2 = rescale(rt, "cpu", ["cpu"])
    moe = next(i for i, s in enumerate(rt.specs) if s.moe)
    assert rt2.f_shards[moe][0]["wi"] is rt.f_shards[moe][0]["wi"]
    tokens = torch.tensor([7, 123], dtype=torch.int32)
    logits = []
    for r in (rt, rt2):
        caches, pos = r.init_cache(2, 8)
        for _ in range(3):
            lg, caches, pos = r.decode_step(tokens, caches, pos)
        logits.append(lg)
    assert torch.equal(*logits)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_jamba_runtime_matches_plain_path(cuda):
    """Jamba's smoke runtime on the card (kernels on the attention and MoE
    layers, plain PyTorch Mamba steps) against the same runtime with
    impl="plain", float32: one 5-token prefill chunk, then 3 decode steps.
    The kernels' summation order differs from the plain versions', so the
    logits agree to float32 rounding, not bitwise."""
    from repro_torch.kernels import ops
    cfg = tconfigs.get_smoke_config(ARCH)
    params = init_params(cfg, seed=0, device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    toks = toks.to(torch.int32).to(cuda)
    outs = []
    ops.reset_launch_counts()
    for impl in (None, "plain"):
        rt = AFDRuntime(cfg, params, impl=impl)
        caches, pos = rt.init_cache(2, 16)
        lg, caches, pos = rt.prefill(toks[:, :5], caches, pos)
        steps = [lg]
        for j in range(5, 8):
            out, caches, pos = rt.decode_step(toks[:, j], caches, pos)
            steps.append(out[:, None])
        outs.append(torch.cat(steps, dim=1))
    counts = ops.launch_counts()
    attn = sum(s.kind == "attn" for s in cfg.layer_plan().flat())
    moe = sum(s.moe for s in cfg.layer_plan().flat())
    assert counts["flash_prefill"] == attn
    assert counts["splitkv_attention"] == 3 * attn
    assert counts["grouped_gemm"] == 2 * moe * 4
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].cpu().numpy(),
                               atol=1e-4)


def test_mamba2_bf16_chunked_vs_stepped_drift_matches_jax():
    """mamba2 smoke (all-SSM): the last logits of ``Model.prefill`` over 32
    tokens (chunked SSD, 4 chunks) against 32 ``decode_step`` calls. In
    float32 the two agree to 1e-4 in both packages; in bf16 they drift
    apart by rounding, in JAX as in the port. The port's drift stays
    within twice JAX's own, and JAX's within 1e-1."""
    from repro_torch.models.model import make_model as tmake_model
    toks = np.random.default_rng(2).integers(1, 256, (2, 32)).astype(
        np.int32)
    drift = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jconfigs.get_smoke_config("mamba2-2.7b"),
                                   dtype=dtype, param_dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.get_smoke_config("mamba2-2.7b"),
                                   dtype=dtype, param_dtype=dtype)
        jm, tm = make_model(jcfg), tmake_model(tcfg, device="cpu")
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")
        jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
        tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32)
        jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
        for j in range(32):
            jd, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, j]))
            td, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, j]))

        def rel(a, b):
            return float(np.linalg.norm(_np(a) - _np(b))
                         / np.linalg.norm(_np(b)))
        drift[dtype] = (rel(jl, jd), rel(tl, td))
    assert max(drift["float32"]) <= 1e-4
    jax_drift, port_drift = drift["bfloat16"]
    assert 0 < jax_drift <= 1e-1
    assert port_drift <= 2 * jax_drift


# chip_smoke.py phase 11 gates mamba2-2.7b's bf16 chunked prefill against
# its stepped decode on the card at this depth and prompt length, at full
# width, at this bound
MAMBA_BF16_LAYERS, MAMBA_BF16_TOKENS, MAMBA_BF16_TOL = 4, 32, 5e-2


def test_mamba2_bf16_drift_at_full_width_matches_jax():
    """mamba2-2.7b at full width (d_model 2560, 80 SSD heads, state 128,
    vocab 50,280) cut to its first 4 layers, bf16: the last logits of
    ``Model.prefill`` over 32 tokens against 32 ``decode_step`` calls, in
    JAX and in the port on JAX's weights. JAX's own gap stays within half
    of ``MAMBA_BF16_TOL``, the bound ``chip_smoke.py`` holds the port to on
    the card at this depth, and the port's within twice JAX's. The gaps
    are printed (``pytest -s``)."""
    from repro_torch.models.model import make_model as tmake_model
    jcfg = dataclasses.replace(jconfigs.get_config("mamba2-2.7b"),
                               n_layers=MAMBA_BF16_LAYERS)
    tcfg = dataclasses.replace(tconfigs.get_config("mamba2-2.7b"),
                               n_layers=MAMBA_BF16_LAYERS)
    toks = np.random.default_rng(2).integers(
        1, jcfg.vocab_size, (1, MAMBA_BF16_TOKENS)).astype(np.int32)
    jm, tm = make_model(jcfg), tmake_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")
    jl, _ = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, MAMBA_BF16_TOKENS)
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                       MAMBA_BF16_TOKENS)
    jstep = jax.jit(jm.decode_step)
    jc = jm.init_cache(1, MAMBA_BF16_TOKENS)
    tc = tm.init_cache(1, MAMBA_BF16_TOKENS)
    for j in range(MAMBA_BF16_TOKENS):
        jd, jc = jstep(jp, jc, jnp.asarray(toks[:, j]))
        td, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, j]))

    def rel(a, b):
        return float(np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b)))
    jax_gap, port_gap = rel(jl, jd), rel(tl, td)
    print(f"mamba2-2.7b, {MAMBA_BF16_LAYERS} layers, {MAMBA_BF16_TOKENS} "
          f"tokens, bf16 prefill vs steps: JAX {jax_gap:.3e}, port "
          f"{port_gap:.3e}; port vs JAX: prefill {rel(tl, jl):.3e}, steps "
          f"{rel(td, jd):.3e}")
    assert 0 < jax_gap <= MAMBA_BF16_TOL / 2
    assert port_gap <= 2 * jax_gap
