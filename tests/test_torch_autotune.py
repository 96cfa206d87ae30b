"""The grouped GEMM's tile autotuner (``repro_torch.kernels.autotune``)
against the JAX package's (``repro.kernels.autotune``): bucket, key and
lookup on a grid, ``tune``'s merged table with a stubbed timer, the
tiling arguments of ``kernels.ops.grouped_gemm``, and the ``tune``
command without a card. The ``gpu``-marked cases hold every built tiling
to the default's bits on the card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import autotune as jat  # noqa: E402
from repro_torch.kernels import autotune as tat  # noqa: E402
from repro_torch.kernels import grouped_gemm as tgg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHAPES = [(32, 2, 1024, 1024), (16, 1, 4096, 28672), (6, 64, 7168, 4096),
          (8, 3, 256, 512), (16, 8, 4096, 28672)]
GRID = [(e, m, d) for e in (1, 6, 8, 16, 32) for m in (1, 2, 3, 17, 64, 384,
                                                       4096)
        for d in (512, 1024, 4096, 28672)]


def fake_time(m, k, n, g, tiles, reps, *rest):
    """A deterministic stand-in for the timer: µs from the shape and tiles."""
    tm, tn, tk = tiles
    return float((m * 7 + k // tk * 3 + n // tn * 5 + g * tm) % 97 + tm / 64)


@pytest.fixture
def tables(tmp_path, monkeypatch):
    """Both packages' ``tune`` on the same shapes, candidates and stubbed
    timings, each merged into a copy of the same starting table."""
    start = {"version": 1, "entries": {"E99_tpe1_dff8": {
        "tile_m": 64, "tile_n": 64, "tile_k": 32, "us": 1.0,
        "shape": {"E": 99, "tokens_per_expert": 1, "d_model": 8, "d_ff": 8}}}}
    paths = {}
    for name in ("jax", "port"):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(start))
    monkeypatch.setattr(jat, "_time_tiling", fake_time)
    monkeypatch.setattr(tat, "_time_tiling", fake_time)
    monkeypatch.setattr(tat, "device_line", lambda: "TEST CARD, 1.00 W")
    res_j = jat.tune(SHAPES, candidates=tat.CANDIDATE_TILES,
                     path=str(paths["jax"]), interpret=True)
    res_t = tat.tune(SHAPES, candidates=tat.CANDIDATE_TILES,
                     path=str(paths["port"]))
    jat.invalidate_cache()
    tat.invalidate_cache()
    yield ({k: json.loads(p.read_text()) for k, p in paths.items()},
           res_j, res_t, paths)
    jat.invalidate_cache()
    tat.invalidate_cache()


def test_tune_merges_jax_s_table(tables):
    """Same winners, timings and shape records, entry for entry; only
    JAX's ``interpret`` is the port's ``device``."""
    docs, res_j, res_t, _ = tables
    assert res_t == res_j
    jent, tent = docs["jax"]["entries"], docs["port"]["entries"]
    assert set(jent) == set(tent)
    for key in jent:
        j, t = dict(jent[key]), dict(tent[key])
        if key != "E99_tpe1_dff8":
            assert j.pop("interpret") is True
            assert t.pop("device") == "TEST CARD, 1.00 W"
        assert j == t, key
    assert docs["jax"]["version"] == docs["port"]["version"] == 1


def test_bucket_key_lookup_match_jax(tables):
    """On a grid of (E, m, d_ff), against the tables both wrote and an
    empty one: the same bucket, key and tiles, read by either package."""
    _, _, _, paths = tables
    for t in range(0, 5000, 7):
        assert tat.bucket_tokens_per_expert(t) == jat.bucket_tokens_per_expert(t)
    hits = 0
    for e, m, d in GRID:
        assert tat.table_key(e, m, d) == jat.table_key(e, m, d)
        for p in paths.values():
            want = jat.lookup(e, m, d, path=str(p))
            entries = tat.load_table(str(p))["entries"]
            key = tat.table_key(e, max(1, m // e), d)
            if key in entries:
                hits += 1
            else:       # each package's own default for a missing key
                assert want == jat.DEFAULT_TILES
                want = tat.DEFAULT_TILES
            assert tat.lookup(e, m, d, path=str(p)) == want
    assert hits > 0
    missing = str(paths["jax"]) + ".none"
    assert tat.lookup(8, 64, 512, path=missing) == tat.DEFAULT_TILES


def test_defaults_and_committed_table():
    """The default is the kernel's first tiling, (64, 64, 32); every entry
    of the committed table names a built tiling and the card it was tuned
    on with its power limit."""
    assert tat.DEFAULT_TILES == tgg.DEFAULT_TILING == (64, 64, 32)
    assert tat.CANDIDATE_TILES == tgg.TILINGS and len(tgg.TILINGS) >= 6
    doc = tat.load_table()
    assert doc["entries"]
    for key, entry in doc["entries"].items():
        tiles = (entry["tile_m"], entry["tile_n"], entry["tile_k"])
        assert tiles in tgg.TILINGS, key
        assert entry["device"].startswith("NVIDIA H100"), key
        assert entry["device"].endswith(" W"), key
        shape = entry["shape"]
        assert key == tat.table_key(shape["E"], shape["tokens_per_expert"],
                                    shape["d_ff"])


def _operands(seed, m, e, k, n):
    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32))
    sizes = torch.from_numpy(rng.multinomial(m - 3, [1 / e] * e).astype(
        np.int32))
    return lhs, rhs, sizes


@pytest.mark.parametrize("tiles", tgg.TILINGS)
def test_pinned_tiles_equal_unpinned_on_the_plain_path(tiles):
    lhs, rhs, sizes = _operands(0, 40, 4, 48, 32)
    want = tops.grouped_gemm(lhs, rhs, sizes)
    got = tops.grouped_gemm(lhs, rhs, sizes, tile_m=tiles[0],
                            tile_n=tiles[1], tile_k=tiles[2])
    assert torch.equal(got, want)
    assert tops.gemm_tiles(lhs, rhs, tile_m=tiles[0], tile_n=tiles[1],
                           tile_k=tiles[2]) == tiles


@pytest.mark.parametrize("pinned", [dict(tile_m=8), dict(tile_n=256),
                                    dict(tile_m=128, tile_n=128, tile_k=512)])
def test_unknown_tiling_raises(pinned):
    """A tiling the kernel is not built for raises (JAX's TPU tiles
    included); it never falls back to the default."""
    lhs, rhs, sizes = _operands(1, 16, 2, 32, 32)
    with pytest.raises(ValueError, match="not built for tiles"):
        tops.grouped_gemm(lhs, rhs, sizes, **pinned)


def test_int4_forces_a_column_tile_dividing_the_block():
    """int4 forces the n-tile, as JAX forces it: the widest built column
    tile of the same (tile_m, tile_k) that divides the quantization
    block; none raises."""
    w = torch.randn(4, 64, 128)
    codes, scales = quant.quantize_experts_int4(w, block_n=32)
    lhs = torch.randn(8, 64)
    assert tops.gemm_tiles(lhs, codes, scales=scales) == (64, 32, 32)
    assert tops.gemm_tiles(lhs, codes, scales=scales, tile_m=16,
                           tile_k=64) == (16, 32, 64)
    with pytest.raises(ValueError, match="int4 block"):
        tops.gemm_tiles(lhs, codes, scales=scales, tile_m=128, tile_n=128,
                        tile_k=32)
    codes128, scales128 = quant.quantize_experts_int4(w, block_n=128)
    assert tops.gemm_tiles(lhs, codes128, scales=scales128, tile_m=128,
                           tile_n=128, tile_k=32) == (128, 128, 32)


def test_tune_command_without_a_card_exits_2(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "table.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "tune", "--shape", "8:8:256:512",
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2
    assert proc.stderr.strip().startswith("error: tune") and \
        len(proc.stderr.strip().splitlines()) == 1
    assert proc.stdout == "" and not out.exists()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "int8", "int4"])
def test_every_tiling_gives_the_default_bits(cuda, mode):
    """bf16, ragged groups with an expert of 150 rows, surplus rows, a
    partial column tile, the fused gather and scatter: every built tiling
    equals the default bit for bit, and the default is within the GEMM
    tolerance of the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    e, k, n, m = 6, 200, 272, 200
    w = torch.randn((e, k, n), generator=gen, device="cuda").to(torch.bfloat16)
    rhs, sc = {"dense": (w, None), "int8": quant.quantize_experts(w),
               "int4": quant.quantize_experts_int4(w, block_n=16)}[mode]
    sizes = torch.tensor([150, 0, 17, 1, 20, 2], dtype=torch.int32,
                         device="cuda")
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(m, generator=gen, device="cuda")
    kw = dict(row_index=perm, out_index=perm, out_rows=m)
    ref = tgg.grouped_gemm(x, rhs, sizes, scales=sc, **kw)
    plain = tops.grouped_gemm(x, rhs, sizes, scales=sc, impl="plain", **kw)
    assert (ref.float() - plain.float()).abs().max() <= 0.15 * k ** 0.5
    for tiles in tgg.TILINGS[1:]:
        got = tgg.grouped_gemm(x, rhs, sizes, scales=sc, tiles=tiles, **kw)
        assert torch.equal(got, ref), tiles


@pytest.mark.gpu
def test_kernel_refuses_an_unknown_tiling(cuda):
    x = torch.zeros((8, 32), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((2, 32, 32), dtype=torch.bfloat16, device="cuda")
    sizes = torch.tensor([4, 4], dtype=torch.int32, device="cuda")
    assert tgg.kernel_tilings() == tgg.TILINGS
    with pytest.raises(RuntimeError, match="CUDA error"):
        tgg.grouped_gemm(x, w, sizes, tiles=(8, 8, 8))
