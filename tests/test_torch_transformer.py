"""The single-program model's pieces in the port against their JAX twins
on the same numpy inputs, float32 on the CPU: full-sequence prefill
attention (causal, sliding window with a ring-phase cache write,
bidirectional; the query-chunked form), cross-attention, the capacity MoE
(its aux loss, a tight capacity that drops tokens, shared experts) and
the sorted MoE, the Mamba-2 causal conv, chunked SSD against both
packages' sequential recurrence, ``mamba_prefill`` with a cache, and the
whisper encoder. Kernel-free, so the tolerances are those of the JAX
tests' f32 attention (atol 1e-5, rtol 2e-5)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model import make_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

TOL = dict(atol=1e-5, rtol=2e-5)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """numpy tree → (JAX tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _attn_params(rng, cfg, bias=False):
    d = cfg.d_model
    p = {"wq": _rand(rng, d, cfg.q_dim, scale=1 / 8),
         "wk": _rand(rng, d, cfg.kv_dim, scale=1 / 8),
         "wv": _rand(rng, d, cfg.kv_dim, scale=1 / 8),
         "wo": _rand(rng, cfg.q_dim, d, scale=1 / 8)}
    if bias:
        p.update(bq=_rand(rng, cfg.q_dim), bk=_rand(rng, cfg.kv_dim),
                 bv=_rand(rng, cfg.kv_dim))
    return p


@pytest.mark.parametrize("kw", [
    dict(),                                         # causal, full cache
    dict(sliding_window=4),                         # ring phase: S 12 > 4
    dict(causal=False, use_rope=False),             # bidirectional encoder
], ids=["causal", "window", "bidirectional"])
def test_attention_prefill_and_cache_write(kw):
    """attention_prefill's output and the cache it writes from position 0
    (``write_kv_prefill``; a 4-slot ring keeps the last 4 of 12 positions
    in slot p mod 4); qwen1.5's QKV biases."""
    jcfg, tcfg = _cfgs("qwen1.5-0.5b", **kw)
    rng = np.random.default_rng(0)
    jp, tp = _both(_attn_params(rng, jcfg, bias=True))
    b, s, t = 2, 12, 16
    x = _rand(rng, b, s, jcfg.d_model)
    positions = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    want, jc = jattn.attention_prefill(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(positions),
                                       jkv.init_attn_cache(jcfg, b, t))
    got, tc = tattn.attention_prefill(tp, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(positions),
                                      tkv.init_attn_cache(tcfg, b, t, "cpu"))
    _close(got, want)
    assert tc["k"].shape == jc["k"].shape
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    nocache, none = tattn.attention_prefill(tp, tcfg, torch.from_numpy(x),
                                            torch.from_numpy(positions))
    assert none is None and torch.equal(nocache, got)


@pytest.mark.parametrize("window", [None, 5], ids=["causal", "window"])
def test_chunked_causal_attention(window):
    """The query-chunked form (chunk 8 over S 16) against JAX's and against
    the port's one-block masked form."""
    jcfg, tcfg = _cfgs("qwen3-8b", sliding_window=window)
    rng = np.random.default_rng(1)
    q = _rand(rng, 2, 16, jcfg.n_heads, jcfg.d_head)
    k = _rand(rng, 2, 16, jcfg.n_kv_heads, jcfg.d_head)
    v = _rand(rng, 2, 16, jcfg.n_kv_heads, jcfg.d_head)
    want = jattn._chunked_causal_attention(jcfg, jnp.asarray(q),
                                           jnp.asarray(k), jnp.asarray(v), 8)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn._chunked_causal_attention(tcfg, tq, tk, tv, 8)
    _close(got, want)
    whole = tattn.gqa_scores_softmax_out(tcfg, tq, tk, tv,
                                         tattn.causal_mask(tcfg, 16))
    _close(got, whole)
    assert np.array_equal(tattn.causal_mask(tcfg, 16, 20).numpy(),
                          np.asarray(jattn.causal_mask(jcfg, 16, 20)))


def test_cross_attention():
    """project_cross_kv on an encoder output, then cross_attention of a
    decoder chunk over it, with and without an encoder mask."""
    jcfg, tcfg = _cfgs("whisper-small")
    rng = np.random.default_rng(2)
    jp, tp = _both(_attn_params(rng, jcfg))
    enc = _rand(rng, 2, 10, jcfg.d_model)
    x = _rand(rng, 2, 3, jcfg.d_model)
    jk, jv = jattn.project_cross_kv(jp, jcfg, jnp.asarray(enc))
    tk, tv = tattn.project_cross_kv(tp, tcfg, torch.from_numpy(enc))
    _close(tk, jk)
    _close(tv, jv)
    mask = np.arange(10)[None, :] < np.asarray([[10], [6]])
    for m in (None, mask):
        want = jattn.cross_attention(jp, jcfg, jnp.asarray(x), jk, jv,
                                     None if m is None else jnp.asarray(m))
        got = tattn.cross_attention(tp, tcfg, torch.from_numpy(x), tk, tv,
                                    None if m is None else
                                    torch.from_numpy(m))
        _close(got, want)


@pytest.fixture(scope="module")
def moe_params():
    """JAX's MoE layer params for granite-moe (no shared expert) and kimi
    (a shared expert), as (JAX tree, torch tree) per arch."""
    out = {}
    for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b"):
        jcfg, tcfg = _cfgs(arch)
        jp = jmoe.init_moe(jax.random.PRNGKey(3), "m", jcfg)
        out[arch] = (jcfg, tcfg, jp, _both(_numpy_tree(jp))[1])
    return out


@pytest.mark.parametrize("arch,cap", [
    ("granite-moe-1b-a400m", None),
    ("granite-moe-1b-a400m", 2),          # tight: most pairs are dropped
    ("kimi-k2-1t-a32b", None),            # shared expert
], ids=["granite", "granite-tight", "kimi-shared"])
def test_moe_capacity_and_sorted(moe_params, arch, cap):
    """moe_capacity (output and aux loss) and moe_sorted against JAX on the
    same tokens; with a tight capacity the dropped pairs are the same ones
    (the outputs would differ otherwise), and moe_capacity then differs
    from the dropless moe_sorted. The aux loss on its own, and capacity()
    with its floor of 4."""
    jcfg, tcfg, jp, tp = moe_params[arch]
    rng = np.random.default_rng(4)
    x = _rand(rng, 3, 5, jcfg.d_model)
    want, jaux = jmoe.moe_capacity(jp, jcfg, jnp.asarray(x), cap=cap)
    got, taux = tmoe.moe_capacity(tp, tcfg, torch.from_numpy(x), cap=cap)
    _close(got, want)
    _close(taux, jaux)
    want_s = jmoe.moe_sorted(jp, jcfg, jnp.asarray(x), impl="xla")
    got_s = tmoe.moe_sorted(tp, tcfg, torch.from_numpy(x))
    _close(got_s, want_s)
    probs, _, topi = tmoe.route(tp, tcfg, torch.from_numpy(x).reshape(15, -1))
    _close(tmoe.aux_load_balance_loss(probs, topi, tcfg.n_experts),
           jmoe.aux_load_balance_loss(jnp.asarray(probs.numpy()),
                                      jnp.asarray(topi.numpy()),
                                      jcfg.n_experts))
    assert tmoe.capacity(tcfg, 15) == jmoe.capacity(jcfg, 15)
    assert tmoe.capacity(tcfg, 15, 0.1) == jmoe.capacity(jcfg, 15, 0.1) == 4
    if cap is not None:
        assert not np.allclose(_np(got), _np(got_s), **TOL)


@pytest.fixture(scope="module")
def mamba2_layer():
    """mamba2 smoke config (8 heads of 16, state 16, chunk 8) and JAX's
    layer-0 Mamba params, in both packages."""
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp = make_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")["layers"][0]["mamba"]
    jpar = jax.tree_util.tree_map(lambda a: a[0],
                                  jp["decoder"]["stack"][0]["mamba"])
    return jcfg, tcfg, jpar, tp


def test_causal_conv(mamba2_layer):
    jcfg, tcfg, jp, tp = mamba2_layer
    x = _rand(np.random.default_rng(5), 2, 7, jcfg.conv_dim)
    b = _rand(np.random.default_rng(6), jcfg.conv_dim)
    _close(tmamba.causal_conv(tcfg, torch.from_numpy(x), tp["conv_w"],
                              torch.from_numpy(b)),
           jmamba.causal_conv(jcfg, jnp.asarray(x), jp["conv_w"],
                              jnp.asarray(b)))


@pytest.mark.parametrize("init", [False, True], ids=["zero", "carried"])
def test_ssd_chunked_matches_sequential(init):
    """ssd_chunked (chunk 8 over S 24: three chunks) against JAX's
    ssd_chunked and against both packages' ssd_sequential, from a zero or
    a carried state: outputs and final state."""
    rng = np.random.default_rng(7)
    bs, s, h, p, n = 2, 24, 4, 8, 6
    x, b, c = _rand(rng, bs, s, h, p), _rand(rng, bs, s, h, n), \
        _rand(rng, bs, s, h, n)
    dt = np.log1p(np.exp(_rand(rng, bs, s, h))).astype(np.float32)
    a = -np.linspace(1.0, 4.0, h).astype(np.float32)
    st = _rand(rng, bs, h, p, n) if init else None
    j_in = [jnp.asarray(t) for t in (x, dt, a, b, c)]
    t_in = [torch.from_numpy(t) for t in (x, dt, a, b, c)]
    jst = None if st is None else jnp.asarray(st)
    tst = None if st is None else torch.from_numpy(st)
    got = tmamba.ssd_chunked(*t_in, 8, init_state=tst)
    for want in (jmamba.ssd_chunked(*j_in, 8, init_state=jst),
                 jmamba.ssd_sequential(*j_in, init_state=jst),
                 tmamba.ssd_sequential(*t_in, init_state=tst)):
        _close(got[0], want[0])
        _close(got[1], want[1])
    assert got[1].dtype == torch.float32


@pytest.mark.parametrize("s", [2, 13, 16], ids=["s2", "s13", "s16"])
def test_mamba_prefill_with_cache(mamba2_layer, s):
    """mamba_prefill's output and new cache (conv tail, final state) from a
    cache whose conv rows are live: s = 2 keeps one old conv row (S <
    ssm_conv - 1), 13 is no multiple of the chunk (8), 16 is two chunks.
    The prefill's final state then equals s decode steps' state."""
    jcfg, tcfg, jp, tp = mamba2_layer
    rng = np.random.default_rng(8 + s)
    x = _rand(rng, 2, s, jcfg.d_model)
    conv = _rand(rng, 2, jcfg.ssm_conv - 1, jcfg.conv_dim)
    jc = {"conv": jnp.asarray(conv),
          "state": jnp.zeros((2, jcfg.ssm_heads, jcfg.ssm_head_dim,
                              jcfg.ssm_state), jnp.float32)}
    tc = tkv.init_ssm_cache(tcfg, 2, "cpu")
    tc["conv"] = torch.from_numpy(conv.copy())
    want, jnew = jmamba.mamba_prefill(jp, jcfg, jnp.asarray(x), jc)
    got, tnew = tmamba.mamba_prefill(tp, tcfg, torch.from_numpy(x), tc)
    _close(got, want)
    _close(tnew["conv"], jnew["conv"])
    _close(tnew["state"], jnew["state"])
    assert torch.equal(tc["conv"], torch.from_numpy(conv))    # not modified
    dc = tkv.init_ssm_cache(tcfg, 2, "cpu")
    for j in range(s):
        _, dc = tmamba.mamba_decode(tp, tcfg,
                                    torch.from_numpy(x[:, j:j + 1].copy()), dc)
    _close(tnew["state"], dc["state"], atol=1e-4, rtol=1e-4)


def test_encode():
    """The whisper encoder (bidirectional, LayerNorm, gelu MLPs with
    biases, learned frame positions) on JAX's weights."""
    jcfg, tcfg = _cfgs("whisper-small")
    jp = make_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")
    frames = _rand(np.random.default_rng(9), 2, jcfg.encoder_seq,
                   jcfg.d_model)
    want = jtransformer.encode(jp["encoder"], jcfg, jnp.asarray(frames))
    got = ttransformer.encode(tp["encoder"], tcfg, torch.from_numpy(frames))
    _close(got, want, atol=1e-4, rtol=2e-5)
    ecfg = ttransformer.encoder_config(tcfg)
    assert (ecfg.n_layers, ecfg.causal, ecfg.n_encoder_layers) == (
        tcfg.n_encoder_layers, False, 0)
    assert "bi" in tp["encoder"]["layers"][0]["mlp"]
