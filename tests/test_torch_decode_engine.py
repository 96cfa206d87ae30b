"""The single-program serve path of the port against the JAX package on
the CPU: the configs, presets and parameter counts; ``Model`` (init
layout, forward, loss, prefill and decode steps with their caches) on
JAX's own weights for every smoke config; ``DecodeEngine`` token streams
and counters (greedy, sampled, after a failure drain); and ``python -m
repro_torch serve`` against ``python -m repro.launch.serve``. float32;
whole-model logits within atol 1e-4, as the AFD tests hold them."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.train import preset_config as jpreset  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models.model import make_model as jmake_model  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_jax, unstack_layers  # noqa: E402
from repro_torch.launch.presets import preset_config  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models.model import Model, make_model  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ATOL = 1e-4


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


def _paths(tree, prefix=""):
    """{path: (shape, dtype)} of a nested dict/list tree's leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


# ---------------------------------------------------------------------------
# configs, presets, parameter counts
# ---------------------------------------------------------------------------

def test_configs_presets_and_counts_match_jax():
    """All 10 archs: CONFIG and smoke_config field for field, ARCHS and
    canonical ids, the three presets, param_count (fault included),
    active_param_count and max_decode_positions; unknown names raise the
    same KeyError."""
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        mod = jconfigs._ALIASES[arch]
        assert tconfigs.canonical_id(mod) == jconfigs.canonical_id(mod)
        for preset in ("smoke", "100m", "full"):
            j, t = jpreset(arch, preset), preset_config(arch, preset)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch,
                                                                    preset)
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
            assert t.max_decode_positions() == j.max_decode_positions()
        assert dataclasses.asdict(tconfigs.get_config(mod)) == \
            dataclasses.asdict(jconfigs.get_config(mod))
    for bad in (lambda c: c.canonical_id("qwen9"),):
        with pytest.raises(KeyError) as te:
            bad(tconfigs)
        with pytest.raises(KeyError) as je:
            bad(jconfigs)
        assert te.value.args == je.value.args
    with pytest.raises(KeyError):
        tconfigs.get_config("qwen9")


def test_param_count_omits_mamba_layer_ffns_as_jax_does():
    """The reference's param_count counts dense FFNs on attention layers
    only, while the model builds them on Mamba layers too (jamba): both
    packages count the same short number; tree_count counts the tree
    (which ``test_model_matches_jax`` holds equal to JAX's)."""
    cfg = tconfigs.get_smoke_config("jamba-v0.1-52b")
    tp = Model(cfg, device="cpu").init(0)
    mamba_ffn = sum(3 * cfg.d_model * cfg.d_ff for i in range(cfg.n_layers)
                    if cfg.layer_spec(i).kind == "mamba"
                    and not cfg.layer_spec(i).moe)
    assert mamba_ffn > 0
    assert cfg.param_count() == jconfigs.get_smoke_config(
        "jamba-v0.1-52b").param_count()
    assert tcommon.tree_count(tp) == cfg.param_count() + mamba_ffn
    assert tcommon.tree_bytes(tp) == 4 * tcommon.tree_count(tp)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _batch(cfg, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.vision_seq:
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _check_cache(tcfg, tc, jc):
    layers = unstack_layers(tcfg, jc["prefix"], jc["stack"])
    assert len(tc["layers"]) == len(layers)
    for got, want in zip(tc["layers"], layers):
        assert sorted(got) == sorted(want)
        for name in got:
            _close(got[name], want[name])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].dtype == torch.int32
    if "cross_kv" in jc:
        ckv = jc["cross_kv"]
        want = list(ckv["prefix"])
        if ckv["stack"] is not None:
            want += [(ckv["stack"]["k"][p], ckv["stack"]["v"][p])
                     for p in range(ckv["stack"]["k"].shape[0])]
        assert len(tc["cross_kv"]) == len(want)
        for (k, v), (wk, wv) in zip(tc["cross_kv"], want):
            _close(k, wk)
            _close(v, wv)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_model_matches_jax(arch):
    """``Model`` on JAX's weights: the init tree's layout (the port's own
    initializer), forward logits and MoE aux, loss and its parts, prefill
    logits and cache (layer by layer, position, cross K/V), then three
    decode steps' logits and caches."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    jm, tm = jmake_model(jcfg), make_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")
    assert _paths(tm.init(1)) == _paths(tp)
    assert tcommon.tree_count(tp) == jcommon.tree_count(jp)
    assert tcommon.tree_bytes(tp) == jcommon.tree_bytes(jp)

    jb, tb = _batch(tcfg, 2, 8, seed=1)
    want, jaux = jm.forward(jp, jb)
    got, taux = tm.forward(tp, tb)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)
    _close(taux, jaux, atol=1e-5)
    jl, jparts = jm.loss(jp, jb)
    tl, tparts = tm.loss(tp, tb)
    _close(tl, jl, atol=1e-5)
    for k in ("ce", "aux", "ppl_proxy"):      # ppl_proxy = exp(ce): rtol
        np.testing.assert_allclose(_np(tparts[k]), _np(jparts[k]),
                                   atol=1e-5, rtol=1e-5)

    want, jc = jm.prefill(jp, jb, max_len=24)
    got, tc = tm.prefill(tp, tb, max_len=24)
    _close(got, want)
    _check_cache(tcfg, tc, jc)
    toks = np.random.default_rng(2).integers(1, tcfg.vocab_size, (3, 2))
    for step in toks:
        want, jc = jm.decode_step(jp, jc, jnp.asarray(step, jnp.int32))
        got, tc = tm.decode_step(tp, tc, torch.from_numpy(step).to(
            torch.int32))
        _close(got, want)
    _check_cache(tcfg, tc, jc)
    assert tkv.cache_bytes(tc) == jkv.cache_bytes(jc)


def test_model_defaults_to_cuda():
    """device=None means the card; without one the model, its engine and
    ``python -m repro_torch serve`` (default --device cuda) raise rather
    than carrying on on the CPU."""
    cfg = tconfigs.get_smoke_config("qwen3-8b")
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro_torch", "serve",
                          "--arch", "qwen3-8b"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert "EP:" not in res.stdout


# ---------------------------------------------------------------------------
# DecodeEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_setups():
    out = {}
    for arch in ("qwen1.5-0.5b", "granite-moe-1b-a400m", "h2o-danube-1.8b",
                 "jamba-v0.1-52b", "mamba2-2.7b"):
        jcfg, tcfg = jconfigs.get_smoke_config(arch), \
            tconfigs.get_smoke_config(arch)
        jm = jmake_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        out[arch] = (jm, jp, make_model(tcfg, device="cpu"),
                     params_from_jax(tcfg, _numpy_tree(jp), "cpu"))
    return out


def _run_engine(engine_cls, request_cls, model, params, prompts, mode):
    eng = engine_cls(model, params, n_slots=4, max_len=32,
                     greedy=mode != "sampled", seed=3)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=5 + i % 3)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    if mode == "failure":
        for _ in range(3):
            eng.tick()
        assert eng.simulate_failure(0.25) == 1
    eng.run()
    return [list(r.output) for r in reqs], dataclasses.asdict(eng.stats)


@pytest.mark.parametrize("mode", ["greedy", "sampled", "failure"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-1b-a400m",
                                  "h2o-danube-1.8b", "jamba-v0.1-52b",
                                  "mamba2-2.7b"])
def test_decode_engine_matches_jax(engine_setups, arch, mode):
    """Six requests through four slots: every request's token stream and
    the engine's counters equal JAX's, greedy, sampled (same seed) and
    with a quarter of the slots drained after three ticks. Prompts of 10
    and 12 tokens: longer than h2o-danube's 8-token window, so its
    prefill writes the ring phase."""
    jm, jp, tm, tp = engine_setups[arch]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, tm.cfg.vocab_size, 10 + 2 * (i % 2)).astype(
        np.int32) for i in range(6)]
    want = _run_engine(JEngine, JRequest, jm, jp, prompts, mode)
    got = _run_engine(DecodeEngine, Request, tm, tp, prompts, mode)
    assert got == want


def test_engine_dead_slots_run_past_the_cache():
    """A slot left dead keeps decoding at growing positions past max_len;
    the writes there are dropped and the live slot's stream is unchanged
    (the same request served alone)."""
    cfg = tconfigs.get_smoke_config("qwen3-8b")
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    prompt = np.arange(1, 15, dtype=np.int32)

    def serve(n_slots, extra):
        eng = DecodeEngine(model, params, n_slots=n_slots, max_len=16)
        long = Request(rid=0, prompt=prompt[:2], max_new_tokens=30)
        eng.submit(long)
        for i in range(extra):        # ends after its first tick at pos 15
            eng.submit(Request(rid=1 + i, prompt=prompt, max_new_tokens=1))
        eng.run()
        return long.output, eng
    alone, _ = serve(1, 0)
    shared, eng = serve(2, 1)
    assert shared == alone and len(alone) == 16 - 2
    assert int(eng.cache["pos"][1]) > 16       # the dead slot ran past T


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

ARGS = ["--arch", "granite-moe-1b-a400m", "--preset", "smoke",
        "--requests", "6", "--slots", "2", "--max-new", "5",
        "--prompt-len", "6", "--fail-at", "3"]


def _summary(text: str):
    """The lines that do not depend on the clock: the header, the failure
    line and the EP counters without the wall time."""
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("serving", "[tick", "EP:"))]
    return [re.sub(r" in [0-9.]+s \([0-9.]+ tok/s\)", "", ln) for ln in lines]


def test_cli_serve_matches_jax_script():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    port = subprocess.run([sys.executable, "-m", "repro_torch", "serve",
                           "--device", "cpu", *ARGS], env=env,
                          capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve", *ARGS],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr
    assert _summary(port.stdout) == _summary(ref.stdout)
    assert len(_summary(port.stdout)) == 3
    assert "scheduler: σ̂=" in port.stdout


def test_cli_serve_afd_mode():
    """--mode afd: AFDRuntime decode steps on one device; the M2N bytes
    follow from the shapes (2 sequences × 5 steps × 2 MoE layers)."""
    from repro_torch.launch.serve import run
    out = run(["--device", "cpu", "--mode", "afd", *ARGS])
    cfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    st = out["stats"]
    assert st.dispatches == 5 * cfg.n_layers
    assert st.combine_bytes == 5 * cfg.n_layers * 2 * cfg.d_model * 4
    with pytest.raises(SystemExit):
        run(["--device", "cpu", "--mode", "afd", "--arch", "qwen3-8b"])


@pytest.mark.parametrize("flag", ["--n-a-nodes", "--n-f-nodes"])
def test_cli_serve_refuses_node_counts(flag):
    """The JAX script's node counts have no meaning on the port's one
    device: a command line that sets one fails before serving."""
    from repro_torch.launch.serve import run
    with pytest.raises(SystemExit) as exc:
        run(["--device", "cpu", "--mode", "afd", *ARGS, flag, "2"])
    assert exc.value.code == 2


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
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen3-8b"])
def test_cuda_model_matches_plain_path(cuda, arch):
    """Model on the card (split-KV and, for granite, the grouped GEMM)
    against Model(impl="plain"), float32 smoke config: a 6-token prefill
    and 4 decode steps. The kernels' accumulation order differs, so the
    logits agree to float32 rounding; each kernel of the path launched."""
    from repro_torch.kernels import ops
    cfg = tconfigs.get_smoke_config(arch)
    params = make_model(cfg).init(0)
    toks = torch.randint(1, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(0))
    toks = toks.to(torch.int32).to(cuda)
    outs = []
    ops.reset_launch_counts()
    for impl in (None, "plain"):
        model = make_model(cfg, impl=impl)
        lg, cache = model.prefill(params, {"tokens": toks[:, :6]}, 16)
        steps = [lg]
        for j in range(6, 10):
            lg, cache = model.decode_step(params, cache, toks[:, j])
            steps.append(lg)
        outs.append(torch.stack(steps, dim=1))
    counts = ops.launch_counts()
    assert counts["splitkv_attention"] == 4 * cfg.n_layers
    assert counts["grouped_gemm"] == (8 * cfg.n_layers if cfg.is_moe else 0)
    assert counts["flash_prefill"] == 0
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].cpu().numpy(),
                               atol=1e-4)
