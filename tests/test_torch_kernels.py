"""Port kernels: the plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode) and its jnp oracles, on the same numpy
inputs; and, on a card (``python -m pytest -m gpu``), each CUDA kernel
against its plain version. Without an NVIDIA GPU the ``gpu`` tests skip,
decided inside the ``cuda`` fixture (never at import, so every xdist
worker collects the same tests).

Tolerances are the JAX kernel tests': grouped GEMM f32 2e-5·K, bf16
0.15·√K (test_kernels_grouped_gemm.py); attention f32 1e-5 (split-KV) /
2e-5 (prefill), bf16 5e-2 (test_kernels_splitkv.py,
test_kernels_flash_prefill.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.grouped_gemm import grouped_gemm_pallas  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _gemm_tol(dtype, k):
    return 2e-5 * k if dtype == "float32" else 0.15 * np.sqrt(k)


def _attn_tol(dtype, f32_tol):
    return f32_tol if dtype == "float32" else 5e-2


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (f32 → bf16 rounds to nearest-even in both frameworks)."""
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    if dtype == "bfloat16":
        t, j = t.bfloat16(), j.astype(jnp.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _gemm_case(seed, m, k, n, sizes):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    return lhs, rhs, np.asarray(sizes, np.int32)


# ---- grouped GEMM -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [[9, 0, 14, 3, 0], [0, 0, 20, 0, 0]],
                         ids=["empty-groups+surplus", "one-group+surplus"])
def test_grouped_gemm_plain_vs_jax(dtype, sizes):
    """Empty groups and rows past sum(group_sizes) (40 rows, ≤ 26 in
    groups): the surplus rows are zero in every version."""
    lhs, rhs, gs = _gemm_case(0, 40, 32, 48, sizes)
    jl, tl = _pair(lhs, dtype)
    jr, tr = _pair(rhs, dtype)
    out = tops.grouped_gemm(tl, tr, torch.from_numpy(gs))
    pallas = grouped_gemm_pallas(jl, jr, jnp.asarray(gs), tile_m=16,
                                 tile_n=16, tile_k=16, interpret=True)
    ref = jref.grouped_gemm_ref(jl, jr, jnp.asarray(gs))
    tol = _gemm_tol(dtype, 32)
    for other in (pallas, ref):
        np.testing.assert_allclose(_np(out), _np(other), atol=tol, rtol=1e-2)
    assert not _np(out)[int(gs.sum()):].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_fused_permute_vs_jax(dtype):
    """Fused row_index gather and out_index/out_rows scatter, as the
    F-role FFN uses them (router order in, token order out)."""
    rng = np.random.default_rng(1)
    tokens, top_k, e, k, n = 6, 3, 4, 32, 40
    x = rng.standard_normal((tokens, k)).astype(np.float32)
    rhs = rng.standard_normal((e, k, n)).astype(np.float32)
    topi = np.stack([rng.permutation(e)[:top_k] for _ in range(tokens)])
    flat = topi.reshape(-1)
    sort_idx = np.argsort(flat, kind="stable").astype(np.int32)
    gs = np.bincount(flat, minlength=e).astype(np.int32)
    row_index = sort_idx // top_k
    jx, tx = _pair(x, dtype)
    jr, tr = _pair(rhs, dtype)
    jg = jnp.asarray(gs)
    tg = torch.from_numpy(gs)
    tol = _gemm_tol(dtype, k)
    gathered = tops.grouped_gemm(tx, tr, tg,
                                 row_index=torch.from_numpy(row_index))
    for impl in ("pallas", "ref"):
        want = jops.grouped_gemm(jx, jr, jg, impl=impl,
                                 row_index=jnp.asarray(row_index))
        np.testing.assert_allclose(_np(gathered), _np(want), atol=tol,
                                   rtol=1e-2)
    scattered = tops.grouped_gemm(tx[torch.from_numpy(row_index).long()], tr,
                                  tg, out_index=torch.from_numpy(sort_idx),
                                  out_rows=tokens * top_k + 2)
    for impl in ("pallas", "ref"):
        want = jops.grouped_gemm(jx[jnp.asarray(row_index)], jr, jg,
                                 impl=impl, out_index=jnp.asarray(sort_idx),
                                 out_rows=tokens * top_k + 2)
        np.testing.assert_allclose(_np(scattered), _np(want), atol=tol,
                                   rtol=1e-2)
    assert not _np(scattered)[tokens * top_k:].any()


# ---- flash prefill ------------------------------------------------------------

# (Hq, Hkv, d): small heads, and Kimi K2's head dim 112 with group 8
KIMI_FLASH = (16, 2, 112)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "q_offset,t_valid,heads",
    [(0, None, (4, 2, 16)), (5, 17, (4, 2, 16)), (12, 20, (4, 2, 16)),
     (0, None, KIMI_FLASH), (12, 20, KIMI_FLASH)],
    ids=["causal", "offset", "offset-partial-cache", "causal-hq16-hkv2-d112",
         "offset-partial-cache-hq16-hkv2-d112"])
def test_flash_prefill_plain_vs_jax(dtype, q_offset, t_valid, heads):
    """A chunk of 8 rows at absolute positions q_offset.. against a
    24-slot cache whose first t_valid slots hold keys."""
    rng = np.random.default_rng(2)
    (hq, hkv, d), b, s, t = heads, 2, 8, 24
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out = tops.flash_prefill_attention(tq, tk, tv, causal=True,
                                       q_offset=q_offset, t_valid=t_valid)
    tol = _attn_tol(dtype, 2e-5)
    for impl in ("pallas", "ref"):
        want = jops.flash_prefill_attention(jq, jk, jv, causal=True,
                                            impl=impl, q_offset=q_offset,
                                            t_valid=t_valid, tile_q=8,
                                            tile_k=8)
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=1e-2)


# ---- split-KV decode ----------------------------------------------------------

# (Hq, Hkv, d): the first case's small heads, granite-moe's full widths,
# group 1, Kimi K2's head dim 112 and group 8
SPLITKV_HEADS = [(8, 2, 16), (16, 8, 64), (8, 8, 32), (16, 2, 112),
                 (8, 1, 128)]
SPLITKV_IDS = [f"hq{a}-hkv{b}-d{c}" for a, b, c in SPLITKV_HEADS]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("len_dtype", ["int32", "int64"])
@pytest.mark.parametrize("heads", SPLITKV_HEADS, ids=SPLITKV_IDS)
def test_splitkv_plain_vs_jax_with_lse(heads, len_dtype, dtype):
    """The first case keeps its 40-slot cache and lengths [1, 23, 40]; the
    others run a 48-slot cache (three of the Pallas kernel's 16-key chunks)
    with lengths 0 (no live key), 1, T and more than T."""
    rng = np.random.default_rng(3)
    hq, hkv, d = heads
    if heads == SPLITKV_HEADS[0]:
        b, t, lengths = 3, 40, [1, 23, 40]
    else:
        b, t = 5, 48
        lengths = [0, 1, t, t + 9, 17]
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    lengths = np.asarray(lengths, getattr(np, len_dtype))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out, lse = tops.splitkv_attention(tq, tk, tv, torch.from_numpy(lengths),
                                      return_lse=True)
    tol = _attn_tol(dtype, 1e-5)
    for impl in ("pallas", "ref"):
        want, want_lse = jops.splitkv_attention(jq, jk, jv,
                                                jnp.asarray(lengths),
                                                impl=impl, chunk=16,
                                                return_lse=True)
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=1e-2)
        np.testing.assert_allclose(_np(lse), _np(want_lse), atol=tol,
                                   rtol=1e-2)


@pytest.mark.parametrize("d,elem_bytes", [(16, 4), (64, 2), (112, 2),
                                          (112, 4), (128, 4)])
@pytest.mark.parametrize("b,hkv,t", [(8, 8, 1024), (5, 8, 1000), (3, 2, 40),
                                     (1, 1, 4096), (64, 8, 32768)])
def test_splitkv_split_plan(b, hkv, t, d, elem_bytes):
    """The planner's splits cover [0, T) exactly once, each a multiple of
    16 keys that fits the kernel's shared-memory tile; at the main path's
    shape (8 sequences, 8 kv heads, T 1024) on 132 SMs the grid holds at
    least 132 blocks."""
    from repro_torch.kernels import splitkv_attention as skv
    most = skv.max_split(d, elem_bytes)
    assert most % 16 == 0 and 2 * most * d * elem_bytes <= skv.KV_TILE_BYTES
    split, n_splits = skv.plan_splits(b, hkv, t, 132, most)
    assert split % 16 == 0 and 16 <= split <= most
    covered = np.zeros(t, np.int64)
    for i in range(n_splits):
        covered[i * split:min((i + 1) * split, t)] += 1
    assert (covered == 1).all() and (n_splits - 1) * split < t
    if (b, hkv, t) == (8, 8, 1024):
        assert b * hkv * n_splits >= 132


def test_moe_ffn_ref_vs_jax():
    rng = np.random.default_rng(4)
    n, d, e, m, k = 5, 16, 4, 8, 2
    x, router = (rng.standard_normal(s).astype(np.float32)
                 for s in ((n, d), (d, e)))
    w_in = rng.standard_normal((e, d, 2 * m)).astype(np.float32)
    w_out = rng.standard_normal((e, m, d)).astype(np.float32)
    out = tref.moe_ffn_ref(*(torch.from_numpy(a)
                             for a in (x, router, w_in, w_out)), top_k=k)
    want = jref.moe_ffn_ref(*(jnp.asarray(a) for a in (x, router, w_in,
                                                       w_out)), top_k=k)
    np.testing.assert_allclose(_np(out), _np(want), atol=1e-4, rtol=1e-4)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    """On CPU tensors each kernel wrapper returns its plain version, and a
    launch counter moves only where a kernel is launched."""
    from repro_torch.kernels import flash_prefill, grouped_gemm
    from repro_torch.kernels import splitkv_attention
    rng = np.random.default_rng(8)
    lhs, rhs, gs = (torch.from_numpy(a) for a in
                    _gemm_case(8, 12, 16, 24, [5, 0, 4]))
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((1, 3, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    lengths = torch.tensor([5])
    tops.reset_launch_counts()
    assert torch.equal(grouped_gemm.grouped_gemm(lhs, rhs, gs),
                       tref.grouped_gemm_fused_ref(lhs, rhs, gs))
    assert torch.equal(flash_prefill.flash_prefill(q, k, v, q_offset=2),
                       tref.flash_prefill_ref(q, k, v, q_offset=2))
    assert torch.equal(
        splitkv_attention.splitkv_attention(q[:, 0], k, v, lengths),
        tref.splitkv_attention_ref(q[:, 0], k, v, lengths))
    assert set(tops.launch_counts().values()) == {0}


def test_impl_cuda_on_cpu_tensors_raises():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        tops.grouped_gemm(x, torch.zeros(1, 8, 8), torch.tensor([4]),
                          impl="cuda")


# ---- CUDA kernels against their plain versions (on a card) ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (rows M, K, N, group sizes): ragged groups and a partial N tile; an
# expert of 150 rows (three passes of the bf16 kernel's 64) beside experts
# of 1, 15, 16, 17 and 63 rows, with K = 104 (not a multiple of its 32-deep
# K step) and N = 136; K = 36 (rows not a multiple of 8 elements, so the A
# tile is not copied in 16-byte chunks). Every case has surplus rows.
GEMM_CASES = {
    "ragged": (70, 96, 72, [20, 0, 31, 1, 0, 9]),
    "multi-pass": (270, 104, 136, [150, 1, 15, 16, 17, 63, 0]),
    "k-not-x8": (80, 36, 64, [5, 70, 0, 3]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_cuda_grouped_gemm_vs_plain(cuda, case, dtype):
    m, k, n, sizes = GEMM_CASES[case]
    lhs, rhs, gs = _gemm_case(5, m, k, n, sizes)
    tl, tr = _pair(lhs, dtype)[1].to(cuda), _pair(rhs, dtype)[1].to(cuda)
    tg = torch.from_numpy(gs).to(cuda)
    out = tops.grouped_gemm(tl, tr, tg)
    want = tops.grouped_gemm(tl, tr, tg, impl="plain")
    np.testing.assert_allclose(_np(out), _np(want),
                               atol=_gemm_tol(dtype, k), rtol=1e-2)
    assert not _np(out)[int(gs.sum()):].any()
    # fused gather (sources repeat) + scatter is bit-identical to the
    # unfused composition, with int64 and with int32 indices
    gen = torch.Generator().manual_seed(0)
    ri = torch.randint(0, m, (m,), generator=gen).to(cuda)
    oi = (torch.randperm(m, generator=gen) + 2).to(cuda)
    fused = tops.grouped_gemm(tl, tr, tg, row_index=ri, out_index=oi,
                              out_rows=m + 5)
    unfused = torch.zeros_like(fused)
    unfused[oi] = tops.grouped_gemm(tl[ri], tr, tg)
    assert torch.equal(fused, unfused)
    assert torch.equal(fused, tops.grouped_gemm(
        tl, tr, tg, row_index=ri.int(), out_index=oi.int(), out_rows=m + 5))
    np.testing.assert_allclose(
        _np(fused), _np(tops.grouped_gemm(tl, tr, tg, row_index=ri,
                                          out_index=oi, out_rows=m + 5,
                                          impl="plain")),
        atol=_gemm_tol(dtype, k), rtol=1e-2)
    # out_index a permutation of the M rows (the combine's scatter): out is
    # not zero-filled first, and the surplus rows' destinations get 0
    perm = torch.randperm(m, generator=gen).to(cuda)
    scattered = tops.grouped_gemm(tl, tr, tg, out_index=perm, out_rows=m)
    unfused = torch.empty_like(scattered)
    unfused[perm] = out
    assert torch.equal(scattered, unfused)
    assert not _np(scattered)[perm[int(gs.sum()):].cpu().numpy()].any()


# (Hq, Hkv, d): GQA groups 2, 1 and 4 with head dims 64, 16, 32 and 128;
# then Kimi K2's head dim 112 at group 8, and at Kimi K2's own heads
FLASH_HEADS = [(16, 8, 64), (4, 4, 16), (8, 2, 32), (8, 4, 128),
               (16, 2, 112), (64, 8, 112)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", FLASH_HEADS,
                         ids=[f"hq{a}-hkv{b}-d{c}" for a, b, c in FLASH_HEADS])
def test_cuda_flash_prefill_vs_plain(cuda, heads, dtype):
    """A 37-row chunk (not a multiple of 16) against a 300-slot cache:
    from the start, mid-cache, ending on a 64-key tile edge (t_valid 128),
    ending at T, with t_valid 0 (no live key), under a 40-key window, and
    not causal."""
    rng = np.random.default_rng(6)
    hq, hkv, d = heads
    b, s, t = 2, 37, 300
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d))]
    q, k, v = (_pair(a, dtype)[1].to(cuda) for a in arrs)
    for q_offset, t_valid, window, causal in (
            (0, None, None, True), (200, 237, None, True),
            (91, 128, None, True), (263, 300, None, True),
            (0, 0, None, True), (100, 137, 40, True),
            (200, 237, None, False)):
        kw = dict(q_offset=q_offset, t_valid=t_valid, window=window,
                  causal=causal)
        out = tops.flash_prefill_attention(q, k, v, **kw)
        want = tops.flash_prefill_attention(q, k, v, impl="plain", **kw)
        np.testing.assert_allclose(_np(out), _np(want),
                                   atol=_attn_tol(dtype, 2e-5), rtol=1e-2,
                                   err_msg=str(kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", SPLITKV_HEADS, ids=SPLITKV_IDS)
def test_cuda_splitkv_vs_plain(cuda, heads, dtype):
    """T = 1000 (not a multiple of the split), lengths on the planned
    split's boundaries ±1, 0 and more than T, as int32 and int64; calls
    with 12, then 17 (counters grow), then 12 sequences again (counters
    were reset); a repeat call is bit-identical."""
    from repro_torch.kernels import splitkv_attention as skv
    rng = np.random.default_rng(7)
    hq, hkv, d = heads
    t = 1000
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((17, hq, d), (17, t, hkv, d), (17, t, hkv, d))]
    q, k, v = (_pair(a, dtype)[1].to(cuda) for a in arrs)
    tol = _attn_tol(dtype, 1e-5)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for b in (12, 17, 12):
        split, _ = skv.plan_splits(b, hkv, t, n_sm,
                                   skv.max_split(d, q.element_size()))
        lengths = [1, 63, 64, 65, 1000, 0, split - 1, split, split + 1,
                   2 * split + 1, 999, 1005, 3 * split, 500, 7, 0, 2 * split]
        for len_dtype in (torch.int32, torch.int64):
            lens = torch.tensor(lengths[:b], dtype=len_dtype, device=cuda)
            args = (q[:b], k[:b], v[:b], lens)
            out, lse = tops.splitkv_attention(*args, return_lse=True)
            want, want_lse = tops.splitkv_attention(*args, return_lse=True,
                                                    impl="plain")
            msg = f"b={b} split={split} lengths {len_dtype}"
            np.testing.assert_allclose(_np(out), _np(want), atol=tol,
                                       rtol=1e-2, err_msg=msg)
            np.testing.assert_allclose(_np(lse), _np(want_lse), atol=tol,
                                       rtol=1e-2, err_msg=msg)
            again = tops.splitkv_attention(*args, return_lse=True)
            assert torch.equal(again[0], out) and torch.equal(again[1], lse)
            assert torch.equal(tops.splitkv_attention(*args), out)
