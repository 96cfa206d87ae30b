"""The benchmark's frozen work and MFU arithmetic: it reproduces the bound
column of the kernel table in ``PERF.md`` (NVIDIA H100, 3.35 TB/s, 989
TFLOP/s bf16) at its shapes, and a share read above 100% fails."""

from __future__ import annotations

import json

import pytest

from afdbench import work
from afdbench.tests import tiny

BF16, I64, I32 = 2, 8, 4


def _gemm(m_rows, tokens, k, n, n_experts, visited, gather=True,
          scatter=False):
    """A grouped-GEMM call as ``moe.expert_ffn`` makes it: gate|up gathers
    the tokens through ``row_index``; down scatters through
    ``out_index``."""
    sizes = [m_rows // visited + (1 if i < m_rows % visited else 0)
             for i in range(visited)] + [0] * (n_experts - visited)
    shapes = {"lhs": (tokens if gather else m_rows, k),
              "rhs": (n_experts, k, n), "group_sizes": (n_experts,),
              "row_index": (m_rows,) if gather else None,
              "out_index": (m_rows,) if scatter else None, "scales": None}
    el = {"lhs": BF16, "rhs": BF16, "group_sizes": I32, "row_index": I64,
          "out_index": I64, "scales": 0}
    return work.Call("grouped_gemm", shapes, el,
                     values={"group_sizes": sizes},
                     args={"out_rows": m_rows if scatter else None})


@pytest.mark.parametrize("call,ms", [
    # granite decode gate|up: 8 tokens x top-8, K 1024, N 1024, 26/32
    (_gemm(64, 8, 1024, 1024, 32, 26), 0.0163),
    # granite decode down (out_index), K 512, N 1024, 29/32
    (_gemm(64, 64, 512, 1024, 32, 29, gather=False, scatter=True), 0.0091),
    # granite prefill gate|up: a 64-token chunk x top-8, 32/32
    (_gemm(512, 64, 1024, 1024, 32, 32), 0.0204),
    # Jamba decode gate|up: 4 sequences x top-2, K 4096, N 28672, 5/16
    (_gemm(8, 4, 4096, 28672, 16, 5), 0.3507),
    # Jamba decode down, K 14336, N 4096, 6/16
    (_gemm(8, 8, 14336, 4096, 16, 6, gather=False, scatter=True), 0.2104),
])
def test_grouped_gemm_bound_matches_the_kernel_table(call, ms):
    flops, nbytes = work.grouped_gemm_work(call)
    assert nbytes / work.PEAK_BYTES_PER_S > flops / work.PEAK_FLOPS_BF16
    assert round(work.bound_s(flops, nbytes) * 1e3, 4) == ms


def test_splitkv_bound_matches_the_kernel_table():
    # granite: 8 sequences, T 1024, 2,341 live keys, Hq 16, Hkv 8, d 64
    lengths = [293] * 7 + [2341 - 7 * 293]
    call = work.Call("splitkv", {"q": (8, 16, 64), "k": (8, 1024, 8, 64),
                                 "lengths": (8,)},
                     {"q": BF16, "k": BF16, "lengths": I32},
                     values={"lengths": lengths})
    assert round(work.bound_s(*work.splitkv_work(call)) * 1e3, 4) == 0.0014


def test_flash_prefill_bound_matches_the_kernel_table():
    # granite: a 64-row chunk at q_offset 448, t_valid 512, T 1024
    call = work.Call("flash_prefill", {"q": (1, 64, 16, 64),
                                       "k": (1, 1024, 8, 64)},
                     {"q": BF16, "k": BF16},
                     args={"causal": True, "window": None, "q_offset": 448,
                           "t_valid": 512})
    flops, nbytes = work.flash_prefill_work(call)
    assert flops == 4 * 16 * 64 * sum(449 + j for j in range(64))
    assert round(work.bound_s(flops, nbytes) * 1e3, 4) == 0.0004


def test_live_keys_only():
    call = work.Call("splitkv", {"q": (2, 4, 16), "k": (2, 32, 2, 16),
                                 "lengths": (2,)},
                     {"q": 4, "k": 4, "lengths": 4},
                     values={"lengths": [5, 99]})   # clamped to T = 32
    flops, _ = work.splitkv_work(call)
    assert flops == 4 * (5 + 32) * 4 * 16


def test_a_share_above_100_percent_fails_the_run():
    assert work.share_pct(1.0, 2.0, "x") == 50.0
    assert work.share_pct(0.0, 2.0, "x") is None
    with pytest.raises(work.ShareAbove100, match="x reads"):
        work.share_pct(1.01, 1.0, "x")


def test_token_flops_of_granite():
    """2 × granite's matmul parameters met by one token (its ~400M active
    parameters without the embedding lookup) plus attention."""
    cfg = json.loads((tiny.ROOT / "afdbench" / "configs"
                      / "granite-moe-1b-a400m-afd.json").read_text())
    arch = cfg["port"]
    per_layer = (1024 * 1024 * 2 + 1024 * 512 * 2 + 1024 * 32
                 + 8 * 3 * 1024 * 512)
    params = 24 * per_layer + 1024 * 49155
    assert work.token_flops(arch, 0) == 2 * params
    assert work.token_flops(arch, 100) - work.token_flops(arch, 0) \
        == 24 * 4 * 64 * 16 * 100
