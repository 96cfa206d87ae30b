"""Port model pieces against their JAX twins on the same numpy inputs:
norms, RoPE, the KV-cache writers and masks (ring wrap included), decode
and chunk attention, routing and the expert sort. All float32 on the CPU,
where the port runs the JAX package's default (dense masked) path."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ATOL = 1e-5
ARCH = "granite-moe-1b-a400m"


def _cfgs(**kw):
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), **kw))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _attn_params(rng, cfg):
    d = cfg.d_model
    return {"wq": _rand(rng, d, cfg.q_dim) / 8, "wk": _rand(rng, d, cfg.kv_dim) / 8,
            "wv": _rand(rng, d, cfg.kv_dim) / 8, "wo": _rand(rng, cfg.q_dim, d) / 8}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def test_norms_and_rope():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 3, 5, 64), _rand(rng, 64)
    _close(tlayers.apply_norm({"scale": torch.from_numpy(scale)}, tcfg,
                              torch.from_numpy(x)),
           jlayers.apply_norm({"scale": jnp.asarray(scale)}, jcfg,
                              jnp.asarray(x)))
    _close(tlayers.rmsnorm_1d(torch.from_numpy(scale[:16]),
                              torch.from_numpy(x[..., :16])),
           jlayers.rmsnorm_1d(jnp.asarray(scale[:16]),
                              jnp.asarray(x[..., :16])))
    q = _rand(rng, 2, 5, 4, 16)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 900, 10, 11]], np.int32)
    _close(tlayers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 1e4),
           jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4),
           atol=1e-4)


@pytest.mark.parametrize("window", [None, 4], ids=["full", "ring"])
def test_kv_writers_and_masks(window):
    """write_kv / write_kv_chunk / valid_mask / valid_mask_chunk; the ring
    case wraps (a 7-token chunk into a 4-slot ring keeps the last 4)."""
    jcfg, tcfg = _cfgs(sliding_window=window)
    rng = np.random.default_rng(1)
    b, t = 2, (4 if window else 12)
    pos = np.asarray([1, 3], np.int32)
    jc = jkv.init_attn_cache(jcfg, b, t)
    tc = tkv.init_attn_cache(tcfg, b, t, "cpu")
    k1, v1 = _rand(rng, b, 1, 2, 16), _rand(rng, b, 1, 2, 16)
    jc = jkv.write_kv(jcfg, jc, jnp.asarray(k1), jnp.asarray(v1),
                      jnp.asarray(pos))
    tc = tkv.write_kv(tcfg, tc, torch.from_numpy(k1), torch.from_numpy(v1),
                      torch.from_numpy(pos))
    k7, v7 = _rand(rng, b, 7, 2, 16), _rand(rng, b, 7, 2, 16)
    jc = jkv.write_kv_chunk(jcfg, jc, jnp.asarray(k7), jnp.asarray(v7),
                            jnp.asarray(pos + 1))
    tc = tkv.write_kv_chunk(tcfg, tc, torch.from_numpy(k7),
                            torch.from_numpy(v7), torch.from_numpy(pos + 1))
    for name in ("k", "v"):
        _close(tc[name], jc[name], atol=0)
    for p in (pos, pos + 9):
        assert np.array_equal(
            tkv.valid_mask(tcfg, t, torch.from_numpy(p)).numpy(),
            np.asarray(jkv.valid_mask(jcfg, t, jnp.asarray(p))))
        assert np.array_equal(
            tkv.valid_mask_chunk(tcfg, t, torch.from_numpy(p), 5).numpy(),
            np.asarray(jkv.valid_mask_chunk(jcfg, t, jnp.asarray(p), 5)))


def test_write_kv_past_end_is_dropped():
    """A full cache drops writes at pos >= T, as JAX's scatter does."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    pos = np.asarray([3, 6], np.int32)               # T = 6: second drops
    k1 = _rand(rng, 2, 1, 2, 16)
    jc = jkv.write_kv(jcfg, jkv.init_attn_cache(jcfg, 2, 6), jnp.asarray(k1),
                      jnp.asarray(k1), jnp.asarray(pos))
    tc = tkv.write_kv(tcfg, tkv.init_attn_cache(tcfg, 2, 6, "cpu"),
                      torch.from_numpy(k1), torch.from_numpy(k1),
                      torch.from_numpy(pos))
    _close(tc["k"], jc["k"], atol=0)


@pytest.mark.parametrize("window", [None, 5], ids=["full", "ring"])
def test_attention_decode_and_chunk(window):
    """attention_decode then attention_prefill_cached on a shared cache,
    positions ragged across the batch (the dense masked path)."""
    jcfg, tcfg = _cfgs(sliding_window=window)
    rng = np.random.default_rng(3)
    jp, tp = _both(_attn_params(rng, jcfg))
    b, t = 2, 16
    pos = np.asarray([2, 6], np.int32)
    jc, tc = jkv.init_attn_cache(jcfg, b, t), tkv.init_attn_cache(tcfg, b, t,
                                                                  "cpu")
    x1 = _rand(rng, b, 1, 64)
    jo, jc = jattn.attention_decode(jp, jcfg, jnp.asarray(x1), jc,
                                    jnp.asarray(pos))
    to, tc = tattn.attention_decode(tp, tcfg, torch.from_numpy(x1), tc,
                                    torch.from_numpy(pos))
    _close(to, jo)
    x4 = _rand(rng, b, 4, 64)
    jo, jc = jattn.attention_prefill_cached(jp, jcfg, jnp.asarray(x4), jc,
                                            jnp.asarray(pos + 1))
    to, tc = tattn.attention_prefill_cached(tp, tcfg, torch.from_numpy(x4),
                                            tc, torch.from_numpy(pos + 1))
    _close(to, jo)
    _close(tc["k"], jc["k"])


def test_route_and_sort_by_expert():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(4)
    x, router = _rand(rng, 9, 64), _rand(rng, 64, 8)
    jprobs, jw, ji = jmoe.route({"router": jnp.asarray(router)}, jcfg,
                                jnp.asarray(x))
    tprobs, tw, ti = tmoe.route({"router": torch.from_numpy(router)}, tcfg,
                                torch.from_numpy(x))
    _close(tprobs, jprobs)
    _close(tw, jw)
    assert ti.dtype == torch.int32
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    for got, want in zip(tmoe.sort_by_expert(ti, 8),
                         jmoe.sort_by_expert(ji, 8)):
        assert np.array_equal(got.numpy(), np.asarray(want))
