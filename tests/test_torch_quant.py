"""The port's weight-only quantized grouped GEMM (int8, packed int4) and the
attention rows with no live key, against the JAX package on the same numpy
inputs; and, on a card (``python -m pytest -m gpu``), each CUDA kernel
against its plain version. The ``gpu`` tests skip without an NVIDIA GPU,
decided inside the ``cuda`` fixture.

Tolerances are the JAX kernel tests': grouped GEMM f32 2e-5·K, bf16
0.15·√K; attention f32 1e-5 (split-KV) / 2e-5 (prefill), bf16 5e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import grouped_gemm as jgg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.bridge import quantized_experts_from_jax  # noqa: E402
from repro_torch.kernels import grouped_gemm as tgg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

G, K, N = 5, 64, 256
SIZES = [9, 0, 14, 3, 0]                  # empty groups; 26 of 30 rows


def _gemm_tol(dtype, k):
    return 2e-5 * k if dtype == "float32" else 0.15 * np.sqrt(k)


def _pair(x: np.ndarray, dtype: str):
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    if dtype == "bfloat16":
        t, j = t.bfloat16(), j.astype(jnp.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _weights(seed, dtype, g=G, k=K, n=N):
    """Seeded expert weights with a different range per expert."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((g, k, n))
         * rng.uniform(0.1, 10.0, (g, 1, 1))).astype(np.float32)
    return _pair(w, dtype)


def _quantize(mode, jw, tw, block_n=128):
    if mode == "int8":
        return jgg.quantize_experts(jw), tgg.quantize_experts(tw)
    return (jgg.quantize_experts_int4(jw, block_n),
            tgg.quantize_experts_int4(tw, block_n))


# ---- quantization helpers ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_helpers_bit_equal_jax(dtype):
    """Codes and scales equal bit for bit (both round half to even), and so
    do the unpacked int4 codes and the dequantized weights."""
    jw, tw = _weights(0, dtype)
    (jc, js), (tc, ts) = _quantize("int8", jw, tw)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jgg.dequantize_experts(jc, js)),
                          tgg.dequantize_experts(tc, ts).numpy())
    for block_n in (64, 128):
        (jc, js), (tc, ts) = _quantize("int4", jw, tw, block_n)
        assert tc.shape == (G, K // 2, N) and ts.shape == (G, N // block_n)
        assert np.array_equal(np.asarray(jc), tc.numpy())
        assert np.array_equal(np.asarray(js), ts.numpy())
        codes = tgg.unpack_experts_int4(tc).numpy()
        assert np.array_equal(np.asarray(jgg.unpack_experts_int4(jc)), codes)
        assert codes.min() >= -7 and codes.max() <= 7
        assert np.array_equal(np.asarray(jgg.dequantize_experts_int4(jc, js)),
                              tgg.dequantize_experts_int4(tc, ts).numpy())


def test_bridge_loads_jax_quantized_weights():
    jw, _ = _weights(1, "float32")
    for codes, scales in (jgg.quantize_experts(jw),
                          jgg.quantize_experts_int4(jw, 64)):
        tc, ts = quantized_experts_from_jax(np.asarray(codes),
                                            np.asarray(scales), "cpu")
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        assert np.array_equal(tc.numpy(), np.asarray(codes))
        assert np.array_equal(ts.numpy(), np.asarray(scales))


# ---- quantized grouped GEMM: plain version against JAX -----------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_gemm_plain_vs_jax(mode, dtype):
    """Unfused (30 rows, 26 in groups) and fused (row_index gather from 8
    tokens, out_index scatter into 32 rows): the port's plain version
    against the JAX Pallas kernel (interpret mode) and its ref oracle."""
    rng = np.random.default_rng(2)
    _, tw = _weights(3, "float32")
    jw = jnp.asarray(tw.numpy())
    (jc, js), (tc, ts) = _quantize(mode, jw, tw)
    gs = np.asarray(SIZES, np.int32)
    jg, tg = jnp.asarray(gs), torch.from_numpy(gs)
    tol = _gemm_tol(dtype, K)
    jl, tl = _pair(rng.standard_normal((30, K)).astype(np.float32), dtype)
    out = tops.grouped_gemm(tl, tc, tg, scales=ts)
    assert out.dtype == tl.dtype and out.shape == (30, N)
    for impl in ("pallas", "ref"):
        want = jops.grouped_gemm(jl, jc, jg, impl=impl, scales=js)
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=1e-2)
    assert not _np(out)[sum(SIZES):].any()

    row_index = rng.integers(0, 8, 30).astype(np.int32)
    out_index = rng.permutation(32)[:30].astype(np.int32)
    jx, tx = _pair(rng.standard_normal((8, K)).astype(np.float32), dtype)
    fused = tops.grouped_gemm(tx, tc, tg, scales=ts,
                              row_index=torch.from_numpy(row_index),
                              out_index=torch.from_numpy(out_index),
                              out_rows=32)
    for impl in ("pallas", "ref"):
        want = jops.grouped_gemm(jx, jc, jg, impl=impl, scales=js,
                                 row_index=jnp.asarray(row_index),
                                 out_index=jnp.asarray(out_index),
                                 out_rows=32)
        np.testing.assert_allclose(_np(fused), _np(want), atol=tol,
                                   rtol=1e-2)


def test_quant_wrapper_on_cpu_counts_nothing_and_checks_shapes():
    """On CPU tensors the wrapper takes the plain version and counts no
    launch; malformed quantized operands raise as in the JAX kernel."""
    _, tw = _weights(4, "float32")
    lhs = torch.ones((6, K))
    gs = torch.tensor([2, 0, 4, 0, 0], dtype=torch.int32)
    tops.reset_launch_counts()
    for codes, scales in (tgg.quantize_experts(tw),
                          tgg.quantize_experts_int4(tw, 128)):
        got = tgg.grouped_gemm(lhs, codes, gs, scales=scales)
        assert torch.equal(got, tops.grouped_gemm(lhs, codes, gs,
                                                  scales=scales,
                                                  impl="plain"))
    assert set(tops.launch_counts().values()) == {0}
    packed, scales = tgg.quantize_experts_int4(tw, 128)
    jl = jnp.ones((6, K))
    jgs = jnp.asarray(gs.numpy())
    for bad_rhs, bad_scales in ((packed[:, :-1], scales),        # not K/2
                                (packed, scales[:, :1].repeat(1, 3))):
        with pytest.raises(ValueError):
            tops.grouped_gemm(lhs, bad_rhs, gs, scales=bad_scales)
        with pytest.raises(ValueError):
            jops.grouped_gemm(jl, jnp.asarray(bad_rhs.numpy()), jgs,
                              impl="pallas",
                              scales=jnp.asarray(bad_scales.numpy()))


# ---- attention rows with no live key: plain versions against JAX -------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_live_key_rows_plain_vs_jax_dense(dtype):
    """A chunk with t_valid = 0 and decode lengths holding 0: the port's
    plain versions and the JAX dense forms both give the mean of v over the
    T cache slots, and an LSE of -1e30 (log-sum-exp of T equal values
    -1e30 rounds back to -1e30 in float32)."""
    rng = np.random.default_rng(5)
    b, s, hq, hkv, d, t = 2, 4, 4, 2, 16, 12
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    f32_mean = arrs[2].mean(axis=1)                       # (b, hkv, d)
    out = tops.flash_prefill_attention(tq, tk, tv, q_offset=3, t_valid=0)
    want = jops.flash_prefill_attention(jq, jk, jv, impl="xla", q_offset=3,
                                        t_valid=0)
    tol = 2e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=1e-2)
    np.testing.assert_allclose(
        _np(out), np.repeat(f32_mean, hq // hkv, axis=1)[:, None]
        .repeat(s, axis=1), atol=tol, rtol=1e-2)

    lengths = np.asarray([0, 7], np.int32)
    out, lse = tops.splitkv_attention(tq[:, 0], tk, tv,
                                      torch.from_numpy(lengths),
                                      return_lse=True)
    want, want_lse = jops.splitkv_attention(jq[:, 0], jk, jv,
                                            jnp.asarray(lengths), impl="ref",
                                            return_lse=True)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=1e-2)
    np.testing.assert_allclose(_np(out)[0],
                               np.repeat(f32_mean[0], hq // hkv, axis=0),
                               atol=tol, rtol=1e-2)
    assert np.array_equal(lse.numpy()[0], np.asarray(want_lse)[0])
    assert (lse.numpy()[0] == np.float32(-1e30)).all()
    np.testing.assert_allclose(_np(lse), _np(want_lse), atol=tol, rtol=1e-2)


# ---- CUDA kernels against their plain versions (on a card) ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,block_n", [("int8", None), ("int4", 32),
                                          ("int4", 64), ("int4", 128)],
                         ids=["int8", "int4-block32", "int4-block64",
                              "int4-block128"])
def test_cuda_quant_gemm_vs_plain(cuda, mode, block_n, dtype):
    """K = 96, N = 256; fused gather + scatter is bit-identical to the
    unfused composition (float32 and bf16 activations)."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((6, 96, 256)).astype(np.float32))
    codes, scales = (tgg.quantize_experts(w) if mode == "int8"
                     else tgg.quantize_experts_int4(w, block_n))
    codes, scales = codes.to(cuda), scales.to(cuda)
    lhs = _pair(rng.standard_normal((70, 96)).astype(np.float32),
                dtype)[1].to(cuda)
    gs = torch.tensor([20, 0, 31, 1, 0, 9], dtype=torch.int32, device=cuda)
    tops.reset_launch_counts()
    out = tops.grouped_gemm(lhs, codes, gs, scales=scales)
    assert tops.launch_counts()[f"grouped_gemm_{mode}"] == 1
    assert tops.launch_counts()["grouped_gemm"] == 0
    want = tops.grouped_gemm(lhs, codes, gs, scales=scales, impl="plain")
    assert out.dtype == lhs.dtype
    np.testing.assert_allclose(_np(out), _np(want),
                               atol=_gemm_tol(dtype, 96), rtol=1e-2)
    perm = torch.randperm(70, generator=torch.Generator().manual_seed(0))
    ri, oi = perm.to(cuda), torch.roll(perm, 3).to(cuda)
    fused = tops.grouped_gemm(lhs, codes, gs, scales=scales, row_index=ri,
                              out_index=oi, out_rows=75)
    unfused = torch.zeros_like(fused)
    unfused[oi.long()] = tops.grouped_gemm(lhs[ri.long()], codes, gs,
                                           scales=scales)
    np.testing.assert_allclose(
        _np(fused), _np(tops.grouped_gemm(lhs, codes, gs, scales=scales,
                                          row_index=ri, out_index=oi,
                                          out_rows=75, impl="plain")),
        atol=_gemm_tol(dtype, 96), rtol=1e-2)
    assert torch.equal(fused, unfused)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_no_live_key_rows_vs_plain(cuda, dtype):
    rng = np.random.default_rng(7)
    b, s, hq, hkv, d, t = 2, 20, 16, 8, 64, 300
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d))]
    q, k, v = (_pair(a, dtype)[1].to(cuda) for a in arrs)
    tol = 2e-5 if dtype == "float32" else 5e-2
    for q_offset, t_valid, window in ((0, 0, None), (40, 30, 8)):
        # the second case: rows at positions 40.. see no key of the 30
        # live slots through their 8-key window
        out = tops.flash_prefill_attention(q, k, v, q_offset=q_offset,
                                           t_valid=t_valid, window=window)
        want = tops.flash_prefill_attention(q, k, v, q_offset=q_offset,
                                            t_valid=t_valid, window=window,
                                            impl="plain")
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=1e-2)
    lengths = torch.tensor([0, 65], dtype=torch.int32, device=cuda)
    out, lse = tops.splitkv_attention(q[:, 0], k, v, lengths,
                                      return_lse=True)
    want, want_lse = tops.splitkv_attention(q[:, 0], k, v, lengths,
                                            return_lse=True, impl="plain")
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=1e-2)
    assert torch.equal(lse[0], want_lse[0])
    np.testing.assert_allclose(_np(lse), _np(want_lse), atol=tol, rtol=1e-2)
