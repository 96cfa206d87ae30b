"""Tile autotuning for the grouped GEMM. Counterpart of
``repro.kernels.autotune``.

The best (tile_m, tile_n, tile_k) of the bf16 tensor-core kernel depends on
the expert shard's shape: the number of resident experts E, the tokens
each expert sees per step (a few at decode, the paper's fan-out; tens to
thousands at prefill) and d_ff (the N extent, so the number of column
blocks). A small on-disk table maps

    key = (E, tokens_per_expert bucket, d_ff)   →   (tile_m, tile_n, tile_k)

``lookup()`` is consulted by ``kernels.ops.grouped_gemm`` whenever the
caller does not pin tiles; missing keys give ``DEFAULT_TILES``. The table
is filled by ``tune()`` (``python -m repro_torch tune``), which times each
candidate tiling on the card on uniform-group bf16 workloads, the weights
read from device memory as on the main path (not from the L2 cache), and
records the fastest, with the card's name and power limit. Tokens per expert are
rounded up to a power of two so that nearby workloads share an entry.
Keys, buckets and the table's layout are the JAX module's; an entry
carries ``device`` where JAX's carries ``interpret``.

The candidates are the tilings the kernel is built for
(``grouped_gemm.TILINGS``), chosen for Hopper: JAX's TPU tiles (up to
(128, 256, 512)) do not fit a block's shared memory. The committed table
(``autotune_table.json`` beside this module) comes from ``tune`` on an
H100; the float32 kernel has one fixed tiling and does not read it.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels import grouped_gemm as _gg

DEFAULT_TILES: Tuple[int, int, int] = _gg.DEFAULT_TILING
TABLE_VERSION = 1
_TABLE_PATH = os.path.join(os.path.dirname(__file__), "autotune_table.json")

# Candidate tilings swept by tune(): every tiling the kernel is built for.
CANDIDATE_TILES: Tuple[Tuple[int, int, int], ...] = _gg.TILINGS

_cache: Dict[str, dict] = {}


def bucket_tokens_per_expert(tokens_per_expert: int) -> int:
    """Round up to the nearest power of two (min 1)."""
    t = max(1, int(tokens_per_expert))
    b = 1
    while b < t:
        b *= 2
    return b


def table_key(n_groups: int, tokens_per_expert: int, d_ff: int) -> str:
    return (f"E{int(n_groups)}_tpe{bucket_tokens_per_expert(tokens_per_expert)}"
            f"_dff{int(d_ff)}")


def load_table(path: Optional[str] = None) -> dict:
    p = path or _TABLE_PATH
    if p not in _cache:
        try:
            with open(p) as f:
                data = json.load(f)
            if data.get("version") != TABLE_VERSION:
                data = {"version": TABLE_VERSION, "entries": {}}
        except (OSError, ValueError):
            data = {"version": TABLE_VERSION, "entries": {}}
        _cache[p] = data
    return _cache[p]


def invalidate_cache() -> None:
    _cache.clear()


def lookup(n_groups: int, m: int, d_ff: int,
           path: Optional[str] = None) -> Tuple[int, int, int]:
    """Best-known (tile_m, tile_n, tile_k) for this workload shape.

    m is the total GEMM row count (tokens × top_k for the expert path);
    tokens_per_expert = m / n_groups under the uniform-load assumption the
    table is keyed on. Unknown keys return DEFAULT_TILES.
    """
    tpe = max(1, int(m) // max(1, int(n_groups)))
    entry = load_table(path)["entries"].get(table_key(n_groups, tpe, d_ff))
    if not entry:
        return DEFAULT_TILES
    return (int(entry["tile_m"]), int(entry["tile_n"]), int(entry["tile_k"]))


def device_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# The main path reads each layer's experts from device memory: the timed
# calls rotate over enough weight copies to overflow the H100's 50 MB L2.
COLD_BYTES = 2 * 50 * 2 ** 20


def cold_operands(m: int, k: int, n: int, g: int):
    """bf16 lhs (m, k), copies of rhs (g, k, n) whose bytes together pass
    ``COLD_BYTES``, and uniform group sizes (the last takes the remainder),
    as JAX's ``_time_tiling`` lays the groups out; from an explicit
    ``torch.Generator`` on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1234)
    lhs = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    copies = max(1, -(-COLD_BYTES // (g * k * n * 2)))
    rhs = [torch.randn((g, k, n), generator=gen, device="cuda",
                       dtype=torch.bfloat16) for _ in range(copies)]
    gs = torch.full((g,), m // g, dtype=torch.int32, device="cuda")
    gs[-1] += m - g * (m // g)
    return lhs, rhs, gs


def time_calls(fn, n_args: int, reps: int) -> float:
    """µs per call of ``fn(i)`` (i cycling over ``n_args`` operand sets)
    over ``reps`` back-to-back calls between CUDA events, after one
    warm-up call per set."""
    import torch
    for i in range(n_args):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fn(r % n_args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def _time_tiling(m: int, k: int, n: int, g: int,
                 tiles: Tuple[int, int, int], reps: int) -> float:
    """Device time (µs per call) of the kernel at tiling ``tiles`` on
    bf16 (m, k) × (g, k, n), the weights coming from device memory
    (``cold_operands``). Needs a card."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("tune times the grouped-GEMM kernel and needs a "
                           "CUDA device")
    lhs, rhs, gs = cold_operands(m, k, n, g)
    return time_calls(lambda i: _gg.grouped_gemm(lhs, rhs[i], gs, tiles=tiles),
                      len(rhs), reps)


def tune(shapes: Sequence[Tuple[int, int, int, int]],
         candidates: Sequence[Tuple[int, int, int]] = CANDIDATE_TILES,
         reps: int = 2, path: Optional[str] = None) -> List[dict]:
    """Time each candidate tiling per shape and persist the winners.

    shapes: (E, tokens_per_expert, d_model, d_ff) tuples — the GEMM is
    (E·tpe, d_model) × (E, d_model, d_ff). Returns one result dict per
    shape (key, winner, per-candidate timings) and rewrites the table at
    ``path`` (module-adjacent default) with the winners merged in.
    """
    p = path or _TABLE_PATH
    table = {"version": TABLE_VERSION,
             "entries": dict(load_table(p)["entries"])}
    device = None
    results = []
    for (g, tpe, k, n) in shapes:
        m = g * tpe
        timings = {}
        for cand in candidates:
            # JAX's clamp of oversize tiles to the shape (dedup via the
            # label); a clamped tiling the kernel is not built for raises
            tm, tn, tk = cand
            tn, tk = min(tn, n), min(tk, k)
            label = f"{tm}x{tn}x{tk}"
            if label not in timings:
                timings[label] = _time_tiling(m, k, n, g, (tm, tn, tk), reps)
        best = min(timings, key=timings.get)
        tm, tn, tk = (int(v) for v in best.split("x"))
        key = table_key(g, tpe, n)
        device = device or device_line()
        table["entries"][key] = {
            "tile_m": tm, "tile_n": tn, "tile_k": tk,
            "us": round(timings[best], 1),
            "shape": {"E": g, "tokens_per_expert": tpe,
                      "d_model": k, "d_ff": n},
            "device": device,
        }
        results.append({"key": key, "best": best, "timings_us": timings})
    with open(p, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    invalidate_cache()
    return results
