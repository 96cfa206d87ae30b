"""The port's AFD slice end to end on the CPU: AFDRuntime decode against
the JAX runtime on JAX's own weights (through the numpy bridge), chunked
prefill bit-exact against teacher forcing inside the port, the serving
engine's counters against JAX's on one seeded trace, the import rule, the
device default and the command line."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import make_model  # noqa: E402
from repro.parallel.afd import AFDRuntime as JAFDRuntime  # noqa: E402
from repro.serving.afd_engine import AFDServeEngine as JEngine  # noqa: E402
from repro.serving.workload import generate_trace as jtrace  # noqa: E402
from repro.serving.workload import get_profile as jprofile  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.parallel.afd import AFDRuntime  # noqa: E402
from repro_torch.serving.afd_engine import AFDServeEngine  # noqa: E402
from repro_torch.serving.workload import generate_trace, get_profile  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _numpy_tree(tree):
    """JAX pytree → the same nesting of float32 numpy arrays (bf16 leaves
    become f32, which torch.from_numpy accepts)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x), tree)


@pytest.fixture(scope="module")
def jax_setups():
    out = {}
    for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b"):
        jcfg = jconfigs.get_smoke_config(arch)
        params = make_model(jcfg).init(jax.random.PRNGKey(0))
        tcfg = tconfigs.get_smoke_config(arch)
        out[arch] = (jcfg, params, tcfg,
                     params_from_jax(tcfg, _numpy_tree(params), "cpu"))
    return out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_afd_decode_matches_jax(jax_setups, arch):
    jcfg, jparams, tcfg, tparams = jax_setups[arch]
    B, S = 2, 6
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S))
    devs = jax.devices()
    jrt = JAFDRuntime(jcfg, jparams, [devs[0]], [devs[-1]])
    jc, jpos = jrt.init_cache(B, S + 2)
    rt = AFDRuntime(tcfg, tparams, device="cpu")
    tc, tpos = rt.init_cache(B, S + 2)
    for t in range(S):
        want, jc, jpos = jrt.decode_step(jnp.asarray(toks[:, t], jnp.int32),
                                         jc, jpos)
        got, tc, tpos = rt.decode_step(torch.from_numpy(toks[:, t]), tc, tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert rt.stats.dispatches > 0
    per = rt.stats.dispatch_bytes / rt.stats.dispatches
    assert per == B * tcfg.d_model * 4 + B * tcfg.top_k * 8
    assert (rt.stats.dispatch_bytes, rt.stats.combine_bytes) == (
        jrt.stats.dispatch_bytes, jrt.stats.combine_bytes)


def test_bridge_bf16_round_trip_is_exact():
    """bf16 JAX weights → float32 numpy → the bridge's bf16 tensors are the
    same bits (the router stays float32, as in the JAX model)."""
    import dataclasses
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(
        "granite-moe-1b-a400m"), dtype="bfloat16", param_dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(
        "granite-moe-1b-a400m"), dtype="bfloat16", param_dtype="bfloat16")
    jp = make_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")
    want = jax.tree_util.tree_map(
        lambda x: x[1], jp["decoder"]["stack"][0])       # layer 1 of 2
    got = tp["layers"][1]
    assert got["moe"]["router"].dtype == torch.float32
    assert got["attn"]["wq"].dtype == torch.bfloat16
    for path in (("attn", "wq"), ("moe", "wi"), ("moe", "router"),
                 ("ln1", "scale")):
        w, t = want[path[0]][path[1]], got[path[0]][path[1]]
        assert np.array_equal(np.asarray(w, np.float32), t.float().numpy())


@pytest.fixture(scope="module")
def port_runtime():
    cfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    return AFDRuntime(cfg, init_params(cfg, seed=0, device="cpu"),
                      device="cpu")


@pytest.mark.parametrize("chunk", [1, 3, 7, None])
def test_prefill_bit_exact_vs_teacher_forcing(port_runtime, chunk):
    rt = port_runtime
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, rt.cfg.vocab_size, size=(2, 7)).astype(np.int32))
    caches, pos = rt.init_cache(2, 16)
    ref = []
    for j in range(tokens.shape[1]):
        lg, caches, pos = rt.decode_step(tokens[:, j], caches, pos)
        ref.append(lg)
    ref_lg = torch.stack(ref, dim=1)
    c2, p2 = rt.init_cache(2, 16)
    lg, c2, p2 = rt.prefill(tokens, c2, p2, chunk=chunk)
    assert torch.equal(lg, ref_lg)
    assert torch.equal(p2, pos)
    for got, want in zip(c2, caches):
        for name in ("k", "v"):
            assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("chunk", [None, 64], ids=["legacy", "chunked"])
def test_engine_matches_jax(jax_setups, chunk):
    """The same seeded poisson-burst trace through both engines: equal
    counters, bytes and greedy outputs."""
    jcfg, jparams, tcfg, tparams = jax_setups["granite-moe-1b-a400m"]
    kw = dict(max_len=32, n_bo=2, mb_slots=2, tick_seconds=0.01,
              prefill_chunk=chunk)
    devs = jax.devices()
    jeng = JEngine(JAFDRuntime(jcfg, jparams, [devs[0]], [devs[-1]]), **kw)
    jeng.run(jtrace(jprofile("poisson-burst"), seed=0, max_requests=10),
             max_ticks=2000)
    eng = AFDServeEngine(AFDRuntime(tcfg, tparams, device="cpu"), **kw)
    eng.run(generate_trace(get_profile("poisson-burst"), seed=0,
                           max_requests=10), max_ticks=2000)
    got, want = eng.summary(), jeng.summary()
    for key in ("completed", "decode_ticks", "engine_ticks",
                "prefill_chunks", "dispatch_bytes", "combine_bytes",
                "bytes_match_all"):
        assert got[key] == want[key], key
    assert got["completed"] == 10 and got["bytes_match_all"]
    assert all(w.bytes_match for w in eng.windows)
    assert eng.predicted_wire_bytes() == jeng.predicted_wire_bytes() == (
        got["dispatch_bytes"], got["combine_bytes"])
    outs = {r.rid: r.output for r in eng.completed}
    assert outs == {r.rid: r.output for r in jeng.completed}


def _fleet_shape_logits(rt, to_tensor, to_numpy, toks):
    """The fleet path check's sequence: 12 legacy-prefill steps of one
    sequence into a 32-slot cache, then 32 ``decode_step_3bo`` steps of a
    2-slot micro-batch, its second slot reset to position 0 halfway."""
    out = []
    caches, pos = rt.init_cache(1, 32)
    for j in range(12):
        lg, caches, pos = rt.decode_step(to_tensor(toks[0, j:j + 1]),
                                         caches, pos)
        out.append(to_numpy(lg))
    caches, pos = rt.init_cache(2, 32)
    for j in range(32):
        if j == 16:
            pos = (pos.at[1].set(0) if isinstance(pos, jax.Array)
                   else torch.tensor([int(pos[0]), 0], dtype=pos.dtype))
        ((lg, caches, pos),) = rt.decode_step_3bo(
            [(to_tensor(toks[:, j]), caches, pos)], n_bo=1)
        out.append(to_numpy(lg))
    return np.concatenate(out)


def test_plain_runtime_matches_jax_bf16_at_fleet_shapes(monkeypatch):
    """The port's plain runtime against JAX's AFDRuntime on the same bf16
    weights, through the card's fleet path check sequence at smoke width.
    The two round bf16 at different places, and a near-tie in top-k routing
    may flip an expert; both are allowed, so the logits are held to the
    card's path gate (relative error 5e-2) and every router input (the
    normed hidden state of every MoE layer and step) to the same bound."""
    import dataclasses
    from repro.parallel import afd as jafd
    from repro_torch.parallel import afd as tafd
    arch = "granite-moe-1b-a400m"
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype="bfloat16", param_dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="bfloat16", param_dtype="bfloat16")
    jp = make_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")
    hidden = {"jax": [], "port": []}
    for key, mod, to_np in (("jax", jafd, lambda x: np.asarray(x, np.float32)),
                            ("port", tafd, lambda x: x.float().numpy())):
        route = mod.moe_mod.route

        def recording(params, cfg, x, route=route, key=key, to_np=to_np):
            hidden[key].append(to_np(x))
            return route(params, cfg, x)
        monkeypatch.setattr(mod.moe_mod, "route", recording)
    toks = np.random.default_rng(9).integers(1, tcfg.vocab_size,
                                             (2, 32)).astype(np.int32)
    devs = jax.devices()
    want = _fleet_shape_logits(JAFDRuntime(jcfg, jp, [devs[0]], [devs[-1]]),
                               jnp.asarray, np.asarray, toks)
    got = _fleet_shape_logits(AFDRuntime(tcfg, tp, device="cpu"),
                              torch.from_numpy, lambda x: x.float().numpy(),
                              toks)
    assert got.shape == want.shape == (12 + 2 * 32, tcfg.vocab_size)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 5e-2
    assert len(hidden["port"]) == len(hidden["jax"]) == 44 * tcfg.n_layers
    for g, w in zip(hidden["port"], hidden["jax"]):
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 5e-2


def test_engine_kv_budget_caps_admission(port_runtime):
    """A budget below one request's KV reservation admits one request at a
    time (an empty batch always admits), so every request still completes
    but the trace takes more decode ticks than under the default budget."""
    trace = generate_trace(get_profile("poisson-burst"), seed=0,
                           max_requests=6)
    ticks = []
    for budget in (None, 1):
        eng = AFDServeEngine(port_runtime, max_len=32, n_bo=2, mb_slots=2,
                             tick_seconds=0.01, kv_budget_bytes=budget)
        live = []
        orig = eng._admit

        def admit():
            orig()
            live.append(eng.live_count())
        eng._admit = admit
        eng.run(trace)
        assert eng.summary()["completed"] == 6
        ticks.append(eng.stats.decode_ticks)
    assert max(live) == 1 and ticks[1] > ticks[0]


def test_engine_helpers_match_jax():
    """failure_drain_count and splice_batch_slot (whole-slot and token-slab
    writes, including the n_slots == 1 case) against the JAX helpers."""
    from repro.serving import engine as jeng
    from repro_torch.serving import engine as teng
    for frac, n in ((0.0, 4), (0.25, 4), (0.3, 4), (1.0, 3), (0.5, 1)):
        assert teng.failure_drain_count(frac, n) == \
            jeng.failure_drain_count(frac, n)
    rng = np.random.default_rng(5)
    for n_slots, t_src, t_off in ((3, 8, 0), (3, 5, 2), (1, 8, 0), (1, 3, 4)):
        dst = rng.standard_normal((n_slots, 8, 2, 4)).astype(np.float32)
        src = rng.standard_normal((1, t_src, 2, 4)).astype(np.float32)
        want = jeng.splice_batch_slot({"k": jnp.asarray(dst)},
                                      {"k": jnp.asarray(src)}, n_slots - 1,
                                      n_slots, t_offset=t_off)
        got = teng.splice_batch_slot({"k": torch.from_numpy(dst.copy())},
                                     {"k": torch.from_numpy(src)},
                                     n_slots - 1, n_slots, t_offset=t_off)
        assert np.array_equal(got["k"].numpy(), np.asarray(want["k"]))
        assert not np.array_equal(got["k"].numpy(), dst)   # not a no-op


def test_split_nodes():
    from repro.parallel.afd import split_nodes as jsplit
    from repro_torch.parallel.afd import split_nodes
    devs = list(range(6))
    assert split_nodes(devs, 1, 2, 2) == jsplit(devs, 1, 2, 2)
    with pytest.raises(ValueError):
        split_nodes(devs, 2, 2, 2)


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n.startswith('jaxlib') or n == 'repro' "
        "or n.startswith('repro.'))\n"
        "print(' '.join(n for n in sys.modules if n.startswith('repro_torch')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    imported = set(res.stdout.split())
    assert len(imported) >= 20                    # every submodule imported
    assert {f"repro_torch.core.{m}" for m in (
        "hardware", "modelspec", "budget", "comm_roofline", "hfu_bound",
        "imbalance", "planner")} | {"repro_torch.api.registry",
                                    "repro_torch.serving.scheduler"} | {
        f"repro_torch.fleet.{m}" for m in (
            "events", "router", "rescaler", "controller")} | {
        "repro_torch.models.mamba2", "repro_torch.provision.calibrate",
        "repro_torch.configs.jamba_v0_1_52b"} | {
        f"repro_torch.models.{m}" for m in ("transformer", "model")} | {
        "repro_torch.serving.engine", "repro_torch.launch.serve",
        "repro_torch.launch.presets", "repro_torch.launch.train",
        "repro_torch.serving.mtp"} | {
        f"repro_torch.parallel.{m}" for m in (
            "afd", "sharding", "collectives", "ep")} | {
        f"repro_torch.training.{m}" for m in (
            "optimizer", "data", "train", "checkpoint")} | {
        f"repro_torch.api.{m}" for m in (
            "records", "sweep", "deployment")} | {
        f"repro_torch.provision.{m}" for m in (
            "pricing", "pareto", "search", "recommend")} | {
        f"repro_torch.configs.{m}" for m in (
            "qwen1_5_0_5b", "qwen3_8b", "granite_8b", "h2o_danube_1_8b",
            "internvl2_2b", "whisper_small", "mamba2_2_7b")} <= imported


def test_runtime_defaults_to_cuda():
    """device=None means the card; without one it raises rather than
    carrying on on the CPU."""
    cfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    params = init_params(cfg, seed=0, device="cpu")
    if torch.cuda.is_available():
        assert AFDRuntime(cfg, params).a_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AFDRuntime(cfg, params)


@pytest.mark.parametrize("change,error", [
    (dict(n_experts=0, top_k=0, d_ff=64), ValueError),          # dense
    # a hybrid SSM with no routed experts has no F role either
    (dict(n_experts=0, top_k=0, ssm_state=16, attn_layer_period=2),
     ValueError),
], ids=["dense", "mamba"])
def test_runtime_refuses_unported_configs(change, error):
    import dataclasses
    cfg = dataclasses.replace(
        tconfigs.get_smoke_config("granite-moe-1b-a400m"), **change)
    with pytest.raises(error):
        AFDRuntime(cfg, {}, device="cpu")


def test_cli_serve_traffic_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    for extra in ([], ["--sample", "--prefill-chunk", "3"]):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch", "serve-traffic",
             "--device", "cpu", "--max-requests", "4", "--json", "-",
             *extra], env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        summary = json.loads(res.stdout)["summary"]
        assert summary["bytes_match_all"] and summary["completed"] == 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_runtime_matches_plain_path(cuda):
    """The AFD runtime on the card (kernels) against the same runtime with
    impl="plain", float32 smoke config: one 5-token prefill chunk, then 3
    decode steps. Online softmax and FMA order differ from the plain
    versions, so the logits agree to float32 rounding, not bitwise."""
    from repro_torch.kernels import ops
    cfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
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
    assert all(counts[k] > 0 for k in ("grouped_gemm", "flash_prefill",
                                       "splitkv_attention")), counts
    assert counts["grouped_gemm_int8"] == counts["grouped_gemm_int4"] == 0
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].cpu().numpy(),
                               atol=1e-4)
