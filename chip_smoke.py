#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right and serves.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --profile       # + a profiled window of ticks

Phases, each of which fails the run by raising:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions.
2. Build the three hand-written kernels from ``src/repro_torch/kernels/csrc``
   with nvcc (one process per source, in parallel).
3. Each kernel against its plain PyTorch version at the main path's shapes,
   in bf16 and f32, with its time beside its bound, the plain version's
   time and one PyTorch library call's time (CUDA events, L2 flushed, no
   host gaps inside the timed call). The dense grouped GEMM, flash prefill
   and split-KV come first, on one seeded generator; the grouped GEMM's
   check includes its block mode, fused, over 4 blocks of the experts
   (rows of pairs outside the block exactly 0). Then the grouped GEMM's
   int8 and int4 weight modes (weights quantized on the card from seeded
   bf16 weights by the port's helpers; the serving path never runs them,
   so their launches are those of their checks), and both attention
   kernels on rows with no live key (``lengths`` holding 0, a chunk with
   ``t_valid = 0``), the grouped GEMM's bf16 fused == unfused bit
   identity in every weight mode, and split-KV in every variant (query
   groups 1/2/4/8 x head dims 16/32/64/112/128, both dtypes), each on a
   generator of its own; then flash prefill at Kimi K2's heads (64 q
   heads, 8 kv heads, d 112) against its plain version, with its times
   logged (not in the kernels' record), and a head dim the kernel does
   not take must raise; then split-KV and the grouped GEMM at phase 7's
   shapes (1 and 2 sequences of a 32-slot cache, 8 and 16 expert rows);
   last, all three kernels at phase 9's shapes (Jamba's widths: 16
   experts top-2 of width 14336 on d_model 4096, 32 q / 8 kv heads of
   128, a 512-slot cache) in bf16 and f32, with their bf16 times, bounds
   and library calls; and split-KV at each phase 10-11 path's own batch,
   cache length and heads (``MODEL_SPLITKV``), at every length the path
   reaches and each split boundary, in both dtypes, with its bf16 time,
   bound, plain and SDPA times. The build fails the run if a split-KV variant or a
   bf16 flash-prefill variant spills registers (``-Xptxas -v``).
4. Full-width serve: granite-moe-1b-a400m (24 layers, bf16, random weights
   from seed 0) through ``AFDRuntime`` + ``AFDServeEngine`` on a 24-request
   seeded trace with chunked prefill, on the wall clock, with no policy
   loop. Every request must complete, measured M2N bytes must equal the
   Eq. 9/17 prediction, and each kernel's launch count over this run must
   equal one launch per layer of every cycle.
5. Path check at full width: one 64-token prefill chunk and 4 decode steps
   through the kernels and through the plain versions; the logits must
   agree within the bf16 tolerance stated below.
6. The §3.3 policy loop on the card: the same model served on the wall
   clock with an EP-mode ``SLOScheduler`` (TPOT SLO 50 ms) and an
   ``HFUProbe`` on the AFD plan for the H100 entry of ``core.hardware``.
   Every request must complete, bytes must match in every window, every
   window must carry σ, α, a live cap ≥ 1 and the HFU fields, and measured
   HFU must stay at or under the plan's prediction.
7. The fleet (``repro_torch.fleet``) at full width: three replicas of
   phase 4's model (shape 1x2, ``max_len`` 32, sharing one parameter tree
   on the card) behind the least-kv router serve 48 seeded
   ``poisson-burst`` requests on the virtual clock (10 ms ticks, 8-tick
   windows); replica 1 fails at t = 1.8 s; an ``HFUProbe`` and the
   ``ElasticRescaler`` price the H100 plan. The run must reproduce the
   fleet's counts exactly (the clock is virtual and every count is
   independent of the model's width): 48/48 completed, 0 lost, 5
   requeued, 203 fleet ticks, 26 windows all byte-exact, routing 20/13/15,
   decode ticks 61/28/34, prompt tokens 113/44/84, rescale trajectory
   1->2->1 with each event equal to the planner's decision; and each
   kernel's launches must follow from the engines' own counters. Then
   replica 0's runtime must agree with a plain-version runtime at the
   fleet's shapes (legacy prefill, 2-slot decode up to length 32) within
   phase 5's tolerance, and, rebuilt through ``parallel.afd.rescale``,
   give bit-identical decode logits before and after. That check also
   runs the same weights in float32 on the plain path and logs the error
   per step and the top-8 routing disagreements between the runs.
8. Calibration at full width: ``repro_torch.provision.calibrate``'s body
   on phase 4's model with the JAX package's engine shape and virtual
   clock: 4 busy windows (as on the CPU), ``hfu_predicted`` equal to the
   planner's for the full-width model on H800, 0 < scale ≤ 1 and
   ``t_budget_effective = t_budget_analytic × b_rank_utilization``.
9. Jamba at full width: jamba-v0.1-52b (d_model 4096, 16 experts top-2 of
   width 14336, Mamba-2 d_inner 8192 with 128 heads), cut to 16 of its 32
   layers so that its bf16 weights fit on one 80 GB card (2 attention and
   14 Mamba mixers, 8 MoE and 8 dense FFNs), random weights from seed 0,
   serves 8 seeded requests (prompts 16-256 tokens, outputs 8-32) with
   64-token chunked prefill on the wall clock: every request completes,
   every window's bytes equal Eq. 9/17, each kernel's launches follow the
   rule per attention and MoE layer; then phase 5's path check on it.
10. The single-program serve at full width and depth: ``python -m
   repro_torch serve --mode ep`` (``launch.serve``: ``Model`` behind
   ``DecodeEngine``, the JAX package's ``launch/serve.py``) on
   granite-moe-1b-a400m, bf16, seed-0 weights (phase 4's), 8 slots,
   24 requests of 256 prompt and 32 new tokens, a quarter of the slots
   drained at tick 20. Every request completes, prefills = 24 +
   requeued, and the launches are exactly 2 x 24 grouped GEMMs and 24
   split-KV per tick, flash 0 (prefill runs no kernel, as in JAX). Then
   ``Model`` on the kernels against the plain versions on 8 prompts
   (prefill + 16 decode steps), gated at ``PATH_REL_TOL`` with the plain
   run replaying the kernel run's experts; the free-routing error logged.
11. The other families at full width through ``Model``, one at a time:
   qwen3-8b (36 layers, qk-norm, split-KV group 4) serves 8 requests
   through ``DecodeEngine`` and passes the path check; mamba2-2.7b's
   chunked SSD prefill of 256 tokens against 256 decode steps (both
   walls, float32 gate), and in bf16 on its first 4 layers (fixed gate);
   whisper-small (encoder over 1,500
   frames, cross-attention, learned positions, group 1) and internvl2-2b
   (256 patch embeddings prefixed) pass the path check. Each run's
   launches are one split-KV per attention layer and decode step.

12. Training and MTP at full width (no kernel is on this path: in both
   packages the train-mode forward is dense attention and the capacity
   MoE's einsums, so every launch count must stay 0): a. ``python -m
   repro_torch train`` (``launch.train``) on granite-moe-1b-a400m at full
   width and depth, bf16, 8 x 128 tokens: 12 steps with a checkpoint
   every 6, then the same command to 18 steps, which must print
   ``resumed from step 12`` and ``done: 6 steps``, every loss and
   gradient norm finite (step wall, tokens/s, peak memory, parameter and
   AdamW-state bytes logged; the loss is not gated: 18 steps cannot
   learn the stream's 49,155-token bigram table); b. 20 AdamW steps (lr
   1e-3) on one fixed batch must lower the loss by 1 nat; c. the model cut
   to 2 layers in float32, TF32 off: card gradients within 1e-4 per leaf
   of the CPU's; d. with deterministic algorithms, a restart from an
   ``AsyncCheckpointer`` save at step 3 repeats three steps bit for bit
   (params and AdamW state); e. ``remat=True`` gives bit-identical
   gradients (both peaks logged); f. the MTP harness on qwen1.5-0.5b at
   full width in float32: a self-draft (k 4, a 32-token prompt, 16
   tokens) may reject only at a near-tie of the target's logits (top-2
   gap ≤ 1e-3 of the row's largest |logit|), and a noisy draft's
   ``MTPStats`` are logged beside it.

13. Expert parallelism (``parallel.ep``, ``parallel.collectives``) under
   one NCCL group at world size 1 on a (1, 1) ("data", "model") mesh,
   the counts reset before each part and read after it: a. ``moe_ep_decode``
   on one full-width granite MoE layer (64 tokens, bf16 and f32) must be
   bit-identical to ``moe_sorted`` on the kernels (one rank holds every
   expert) and within ``EP_BF16_RTOL`` (bf16; f32 1e-5) of the plain
   path, in 2 grouped-GEMM launches; and ``expert_ffn`` over each of 4
   blocks of the experts (``first_expert``, the block mode that EP over
   several ranks and the F role over N_F blocks run; 64 and 512 rows)
   within the same tolerance of its plain path, tokens with no pair in
   the block exactly 0, the blocks' sum against the whole-expert call;
   b. ``moe_ep_train`` on 8 x 128 tokens, forward and backward, at
   capacity factor 8 in float32 within 1e-4 of the oracle ``moe_ffn_ref``
   with no drop, at 2.0 in bf16 with its drop fraction logged, at 2.0 in
   float32 against the same call on the CPU (the group's gloo backend):
   output and every gradient leaf within ``TRAIN_GRAD_RTOL``, aux and
   drop fraction equal; every gradient finite and nonzero, no kernel
   launched (capacity einsums, as in JAX); c. ``moe_ep_decode_etp`` as a;
   d. ``splitkv_decode_attention`` over one KV shard at granite's heads
   (8 x T 1024) against the split-KV kernel alone, bit-identical or
   within 1e-6 (logged which); e. phase 10's serve with the EP hook
   installed (prefill through the EP train path, decode through the EP
   decode): every request completes, phase 10's launches per tick, token
   agreement with phase 10 logged, the path check gated at
   ``PATH_REL_TOL`` under replayed routing; f. phase 4's AFD engine with
   the F role over four blocks of 8 experts on the one card
   (``f_devices = [cuda:0] * 4``) on 8 requests: all complete, bytes
   equal Eq. 9/17 in every window, 8 grouped-GEMM launches per M2N cycle
   against N_F = 1's 2, logits within ``PATH_REL_TOL`` of N_F = 1's
   under replayed routing (free routing logged); g.
   one Kimi K2 MoE layer at full width (384 experts, d 7168, 33.8 GB of
   bf16 experts): ``moe_ep_decode`` of 64 tokens within ``EP_BF16_RTOL``
   of ``moe_ffn_ref``, and both grouped-GEMM shapes timed beside their
   bytes bound and ``torch._grouped_mm``.

14. The analysis front door (``python -m repro_torch plan | sweep | bench
   | provision | list``, host numpy) and its calibrated leg on the card:
   a. the stock AFD-vs-EP provisioning search (1,105,920 points) in a
   subprocess, on the default tiles in one process and on a quarter of
   them over 4 forked workers: the two JSON documents byte-identical
   without ``wall_s`` and the tiling's own counts (tiles, frontier
   evictions), DeepSeek-V3 on H800 ``stay-ep`` and on GB200
   ``deploy-afd``; every paper model's verdict on H100 logged; b.
   ``provision --models DeepSeek-V3,Kimi-K2 --hardware H100,H800,GB200
   --n-f-max 40 --calibrate`` in this process, on the card: calibration
   (granite's smoke config through the AFD engine) launches the grouped
   GEMM and split-KV by phase 8's rule (flash and the quantized modes 0),
   sees ``CALIB_WINDOWS`` busy windows, and every verdict carries its
   scale as the derate; c. the same grid's verdicts for DeepSeek-V3 and
   Kimi-K2 on H100 and H800 derated by phase 8's full-width report (both
   scales logged); d. ``plan --json``, ``sweep --name dead-zone``,
   ``bench`` (bit-exact) and ``list`` exit 0.

With ``--profile`` a last phase (15) times 12 steady engine ticks (16
sequences, prefill chunks interleaved with decode), traces the same ticks
with ``torch.profiler`` and prints the device's busy share of the wall
clock and its time by kernel; it fails unless split-KV ran one device
kernel per wrapper call.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Phase 5: kernel path vs plain path, full model in bf16. The two differ
# in accumulation order and in where bf16 rounds (the plain decode forms
# bf16 scores, the kernels f32), and a rare near-tie in top-8 routing can
# flip one expert of one token; so the check is on the whole logit tensor:
# ||kernel - plain|| / ||plain|| ≤ 5e-2. Greedy-token agreement is printed
# but not gated: with random weights the top logits over 49k tokens are
# near-ties, and a flip between two tokens whose plain logits differ by
# less than twice the max abs error is already allowed by that error.
PATH_REL_TOL = 5e-2

REPLACES = {
    "grouped_gemm": "src/repro/kernels/grouped_gemm.py:151",
    "grouped_gemm_int8": "src/repro/kernels/grouped_gemm.py:151 (int8 mode)",
    "grouped_gemm_int4": "src/repro/kernels/grouped_gemm.py:151 (int4 mode)",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:87",
    "splitkv_attention": "src/repro/kernels/splitkv_attention.py:79",
}
SOURCES = {"grouped_gemm_int8": "grouped_gemm", "grouped_gemm_int4": "grouped_gemm"}
# the kernels of the serving path (the quantized modes are not on it)
PATH_KERNELS = ("grouped_gemm", "flash_prefill", "splitkv_attention")
INT4_BLOCK_N = 128
SPILL = re.compile(r"[1-9]\d* bytes spill (stores|loads)")

# Phase 7: the JAX package's fleet acceptance run (benchmarks/fleet_smoke.py
# and its rows in benchmarks/golden.json), whose counts the port must give
# at full width: per replica (arrivals routed, decode ticks, prompt tokens
# prefilled), and the fleet's totals.
FLEET_ROUTED = (20, 13, 15)
FLEET_DECODE_TICKS = (61, 28, 34)
FLEET_PREFILL_TOKENS = (113, 44, 84)
FLEET_TOTALS = {"arrivals": 48, "completed": 48, "lost": 0, "requeued": 5,
                "fleet_ticks": 203, "windows": 26}
FLEET_TRAJECTORY = [1, 2, 1]

# Phase 8: calibration windows of the JAX package's calibrate() on its
# virtual clock (the count does not depend on the model's width).
CALIB_WINDOWS = 4

# Phase 9: Jamba's depth on one 80 GB card and its engine shape
JAMBA_LAYERS = 16
JAMBA_MB_SLOTS = 4
JAMBA_MAX_LEN = 512
# Phase 9's path check: the kernel path's distance to float32 activations
# may exceed the plain path's by this factor (the two route differently,
# so their distances differ at random; see PERF.md §6)
JAMBA_F32_RATIO = 1.1

# Phase 3: split-KV at the single-program paths' shapes: (name, (Hq, Hkv,
# d), B, T, the lengths the path reaches). Phase 10's serve (8 slots of
# 1024, 256-token prompts, 32 new tokens) and path check (8 prompts, 16
# steps into 512 slots); phase 11's qwen3-8b engine (4 slots of 512) and
# path check, whisper-small (32 prompt tokens and 16 steps into 64 slots)
# and internvl2-2b (256 patch embeddings + 32 tokens, 16 steps, 320
# slots); and qwen3-8b's heads at 8 sequences of a 1024-slot cache.
MODEL_SPLITKV = (
    ("granite-moe EP serve", (16, 8, 64), 8, 1024, range(257, 290)),
    ("granite-moe path check", (16, 8, 64), 8, 512, range(257, 273)),
    ("qwen3-8b", (32, 8, 128), 4, 512, range(257, 290)),
    ("qwen3-8b B 8", (32, 8, 128), 8, 1024, range(257, 289)),
    ("whisper-small", (12, 12, 64), 4, 64, range(33, 49)),
    ("internvl2-2b", (16, 8, 128), 4, 320, range(289, 305)),
)

# Phase 10: the JAX package's single-program serve (launch/serve.py --mode
# ep) at full width and depth
EP_REQUESTS = 24
EP_ARGV = ["--arch", "granite-moe-1b-a400m", "--preset", "full", "--mode",
           "ep", "--slots", "8", "--max-len", "1024", "--prompt-len", "256",
           "--max-new", "32", "--requests", str(EP_REQUESTS), "--fail-at",
           "20", "--device", "cuda"]
# Phase 11: mamba2-2.7b's chunked SSD prefill against its stepped decode
# of the same tokens, on the last position's logits. With float32
# activations they agree to float32 rounding over 64 layers: ≤
# MAMBA_F32_TOL. With bf16 activations each 64-layer run lies ~0.5 from
# its float32 twin (random weights, 64 residual layers; PERF.md §6), so
# no fixed bound holds the 64-layer bf16 gap: it is logged. bf16 is gated
# at full width on the first MAMBA_BF16_LAYERS layers of the same weights
# over MAMBA_BF16_TOKENS tokens, at MAMBA_BF16_TOL: there
# tests/test_torch_mamba.py::test_mamba2_bf16_drift_at_full_width_matches_jax
# holds the port's gap to twice JAX's own on JAX's weights, and JAX's to
# this bound (its gap spans 1.5e-2 to 4.9e-2 over root keys).
MAMBA_F32_TOL = 1e-3
MAMBA_BF16_LAYERS = 4
MAMBA_BF16_TOKENS = 32
MAMBA_BF16_TOL = 5e-2

# Phase 13: the EP decode at bf16 against the plain path (and Kimi K2's
# layer against the float32 oracle): relative error of the whole output
EP_BF16_RTOL = 1e-2
# Phase 12: the JAX package's training driver (launch/train.py) at full
# width and depth, its other flags at their defaults (lr 3e-3, seed 0)
TRAIN_ARGV = ["--arch", "granite-moe-1b-a400m", "--preset", "full",
              "--batch", "8", "--seq", "128", "--ckpt-every", "6",
              "--log-every", "6", "--device", "cuda"]
# AdamW at lr 1e-3 on one fixed 8 x 128 batch: the loss must fall by at
# least LEARN_DROP nats in LEARN_STEPS steps
LEARN_STEPS, LEARN_LR, LEARN_DROP = 20, 1e-3, 1.0
# card against CPU gradients, float32 with TF32 off, per leaf:
# ||g_card - g_cpu|| / ||g_cpu|| (the CPU tests hold the port to JAX at 1e-4)
TRAIN_GRAD_RTOL = 1e-4
# a self-draft rejection must sit at a near-tie: the target's top-2 logit
# gap at most this fraction of the row's largest |logit|
MTP_GAP_TOL = 1e-3


def log(*args) -> None:
    print(*args, flush=True)


def _free(torch) -> None:
    """Free earlier phases' models (cycles included) and restart the
    peak-memory count."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of ``fn`` over ``iters`` calls, each between
    CUDA events. Before each call a 256 MB buffer is rewritten, so that
    inputs come from device memory as on the main path (every layer has
    its own weights and cache), and the device then spins ~2 ms
    (``torch.cuda._sleep``) while the host enqueues the call: the events
    see the call's kernels back to back, without host launch gaps.

    The rewrite leaves the 50 MB L2 full of dirty lines, which the call's
    own reads must first write back. ``clean=True`` evicts by reading the
    buffer instead, so the call starts with clean lines: the difference
    between the two is that write-back, not the kernel."""

    SLEEP_CYCLES = 4_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters: int = 20, clean: bool = False) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            if clean:
                self.flush.sum()
            else:
                self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, atol, rtol=1e-2, show=True) -> float:
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    worst = float(err.max()) if err.numel() else 0.0
    ok = bool((err <= limit).all())
    if show or not ok:
        log(f"  {name}: max_abs_err={worst:.3e} (atol {atol:.3e}, rtol "
            f"{rtol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {worst})")
    return worst


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def bf16_atol(want) -> float:
    """The atol of a bf16 attention output (a flash prefill chunk, or one
    split-KV sequence): 2e-2 of the largest plain output (3 to 5 bf16 ulps
    of it), at most 5e-2. Rows over hundreds of live keys average that
    many v rows and stay near 0.05, so a fixed 5e-2 would hold only the
    short rows; the 1% rtol rides on top."""
    return min(5e-2, 2e-2 * float(want.float().abs().max()))


def spilling(build_log: str, kernel: str):
    """``-Xptxas -v`` spill lines of the kernels whose (mangled) name
    holds ``kernel``."""
    bad, fn = [], ""
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        elif kernel in fn and SPILL.search(line):
            bad.append(f"{fn}: {line.strip()}")
    return bad


def seeded(torch, seed: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return gen


def routing(torch, tokens: int, n_experts: int, top_k: int, gen):
    """Top-k expert ids of ``tokens`` tokens under a random router, and the
    expert sort the F role runs on them."""
    from repro_torch.models.moe import sort_by_expert
    scores = torch.rand((tokens, n_experts), generator=gen, device="cuda")
    topi = torch.topk(scores, top_k, dim=-1).indices.to(torch.int32)
    sort_idx, _, sizes = sort_by_expert(topi, n_experts)
    return sort_idx, sizes


def fused_block_rows(torch, cfg, dt, tol, gen, n_blocks: int = 4) -> None:
    """The grouped GEMM's block mode, fused: each of ``n_blocks`` blocks
    of the experts (as EP decode over that many ranks and the F role over
    that many F blocks run it) at the decode (8 tokens, 64 rows) and
    prefill-chunk (64 tokens, 512 rows) shapes. Pairs routed outside the
    block sort past ``sum(group_sizes)``: the gate|up rows there and the
    down GEMM's scattered rows of those pairs must be exactly 0, and all
    rows within phase 3's tolerance of the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.models.moe import sort_by_local_expert
    E, D, F, k = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    e_loc = E // n_blocks
    for label, tokens in (("decode", 8), ("prefill", 64)):
        m = tokens * k
        topi = torch.topk(torch.rand((tokens, E), generator=gen,
                                     device="cuda"), k, dim=-1).indices
        worst, outside = 0.0, 0
        for j in range(n_blocks):
            sort_idx, sizes = sort_by_local_expert(topi, j * e_loc, e_loc)
            flat = topi.reshape(-1)
            away = (flat < j * e_loc) | (flat >= (j + 1) * e_loc)
            live = int(sizes.sum())
            x = torch.randn((tokens, D), generator=gen, device="cuda").to(dt)
            wi = torch.randn((e_loc, D, 2 * F), generator=gen,
                             device="cuda").to(dt)
            h = torch.randn((m, F), generator=gen, device="cuda").to(dt)
            wo = torch.randn((e_loc, F, D), generator=gen,
                             device="cuda").to(dt)
            up_kw = dict(row_index=sort_idx // k)
            dn_kw = dict(out_index=sort_idx, out_rows=m)
            up = ops.grouped_gemm(x, wi, sizes, **up_kw)
            dn = ops.grouped_gemm(h, wo, sizes, **dn_kw)
            name = f"grouped_gemm block {j}/{n_blocks} {label} {dt}"
            worst = max(worst, check_close(
                f"{name} gate|up", up,
                ops.grouped_gemm(x, wi, sizes, impl="plain", **up_kw),
                tol(D), show=False), check_close(
                f"{name} down", dn,
                ops.grouped_gemm(h, wo, sizes, impl="plain", **dn_kw),
                tol(F), show=False))
            if (live != m - int(away.sum()) or bool(up[live:].any())
                    or bool(dn[away].any())):
                raise AssertionError(f"{name}: rows of pairs routed outside "
                                     "the block are not exactly 0")
            outside += m - live
        log(f"  grouped_gemm fused, {n_blocks} blocks of {e_loc} experts, "
            f"{label} ({m} rows) {dt}: max_abs_err={worst:.3e} against the "
            f"plain version; the {outside} rows of pairs routed outside "
            f"their block exactly 0")


def kernel_grouped_gemm(torch, timer, cfg, gen):
    from repro_torch.kernels import ops
    E, D, F, k = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    tol = {torch.float32: lambda kk: 2e-5 * kk,
           torch.bfloat16: lambda kk: 0.15 * math.sqrt(kk)}
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for label, tokens in (("decode", 8), ("prefill", 64)):
            sort_idx, sizes = routing(torch, tokens, E, k, gen)
            x = torch.randn((tokens, D), generator=gen, device="cuda").to(dt)
            wi = torch.randn((E, D, 2 * F), generator=gen,
                             device="cuda").to(dt)
            wo = torch.randn((E, F, D), generator=gen, device="cuda").to(dt)
            h = torch.randn((tokens * k, F), generator=gen,
                            device="cuda").to(dt)
            args_up = (x, wi, sizes)
            kw_up = dict(row_index=sort_idx // k)
            args_dn = (h, wo, sizes)
            kw_dn = dict(out_index=sort_idx, out_rows=tokens * k)
            for part, args, kw, kk in (("gate|up", args_up, kw_up, D),
                                       ("down", args_dn, kw_dn, F)):
                got = ops.grouped_gemm(*args, **kw)
                want = ops.grouped_gemm(*args, impl="plain", **kw)
                err = check_close(f"grouped_gemm {label} {part} {dt}", got,
                                  want, tol[dt](kk))
                if dt == torch.bfloat16:
                    worst = max(worst, err)
        # empty groups and rows past sum(group_sizes)
        sizes = torch.tensor([0, 17, 0, 0, 30, 1] + [0] * (E - 6),
                             dtype=torch.int32, device="cuda")
        x = torch.randn((64, D), generator=gen, device="cuda").to(dt)
        w = torch.randn((E, D, 2 * F), generator=gen, device="cuda").to(dt)
        got = ops.grouped_gemm(x, w, sizes)
        check_close(f"grouped_gemm empty-groups+surplus {dt}", got,
                    ops.grouped_gemm(x, w, sizes, impl="plain"), tol[dt](D))
        if got[48:].abs().max() != 0:
            raise AssertionError("surplus rows of the grouped GEMM are not 0")
        fused_block_rows(torch, cfg, dt, tol[dt], seeded(torch, 23))
        if dt == torch.float32:
            # fused gather + scatter == unfused composition, bit for bit
            sort_idx, sizes = routing(torch, 64, E, k, gen)
            x = torch.randn((64, D), generator=gen, device="cuda")
            ri = sort_idx // k
            fused = ops.grouped_gemm(x, w, sizes, row_index=ri,
                                     out_index=sort_idx, out_rows=64 * k)
            unfused = torch.zeros_like(fused)
            unfused[sort_idx] = ops.grouped_gemm(x[ri], w, sizes)
            if not torch.equal(fused, unfused):
                raise AssertionError("fused grouped GEMM is not bit-identical "
                                     "to gather -> GEMM -> scatter in f32")
            log("  grouped_gemm fused == unfused (f32): bit-identical")

    # timing, bf16, at the three shapes of the main path: decode (8
    # sequences x top-8 = 64 rows) gate|up and down, prefill (a 64-token
    # chunk, 512 rows) gate|up; the record keeps decode gate|up
    rows = {}
    for label, tokens, part in (("decode", 8, "gate|up"),
                                ("decode", 8, "down"),
                                ("prefill", 64, "gate|up")):
        sort_idx, sizes = routing(torch, tokens, E, k, gen)
        m = tokens * k
        kk, nn = (D, 2 * F) if part == "gate|up" else (F, D)
        w = torch.randn((E, kk, nn), generator=gen,
                        device="cuda").to(torch.bfloat16)
        if part == "gate|up":
            x = torch.randn((tokens, kk), generator=gen,
                            device="cuda").to(torch.bfloat16)
            kw = dict(row_index=sort_idx // k)
            xs = x[sort_idx // k].contiguous()
            in_rows = tokens
        else:
            x = torch.randn((m, kk), generator=gen,
                            device="cuda").to(torch.bfloat16)
            kw = dict(out_index=sort_idx, out_rows=m)
            xs, in_rows = x, m
        ms = timer(lambda: ops.grouped_gemm(x, w, sizes, **kw))
        plain_ms = timer(lambda: ops.grouped_gemm(x, w, sizes, impl="plain",
                                                  **kw), iters=5)
        library_ms = None
        if hasattr(torch, "_grouped_mm"):
            offs = torch.cumsum(sizes, 0).to(torch.int32)
            library_ms = timer(lambda: torch._grouped_mm(xs, w, offs=offs))
        visited = int((sizes > 0).sum())
        nbytes = (in_rows * kk + visited * kk * nn + m * nn) * 2 + m * 4
        b_ms, b_by = bound(nbytes, 2 * m * kk * nn, PEAK_BF16_FLOPS)
        log(f"  grouped_gemm {label} {part} bf16 (M={m}, K={kk}, N={nn}, "
            f"{visited}/{E} experts): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {library_ms} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        clean_lib = (timer(lambda: torch._grouped_mm(xs, w, offs=offs),
                           clean=True) if library_ms is not None else None)
        log(f"    L2 flushed by reads: kernel "
            f"{timer(lambda: ops.grouped_gemm(x, w, sizes, **kw), clean=True):.4f}"
            f" ms, library {clean_lib} ms")
        rows[(label, part)] = {"max_abs_err": worst, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": library_ms}
    return rows[("decode", "gate|up")]


def quantize(torch, mode, w):
    """Port helpers, on the card: int8 per expert, or int4 packed two per
    byte along K with one scale per (expert, 128-column block)."""
    from repro_torch.kernels import quant
    if mode == "int8":
        return quant.quantize_experts(w)
    return quant.quantize_experts_int4(w, block_n=INT4_BLOCK_N)


def kernel_grouped_gemm_quant(torch, timer, cfg, gen, mode):
    """One weight mode against its plain version (dequantize to f32, then
    the plain fused grouped GEMM) at the main path's expert shapes, in bf16
    and f32 activations, fused == unfused bit for bit in f32; then its
    time in bf16 beside its bound. There is no one PyTorch call that takes
    these grouped int8 / nibble-packed int4 weights with their scales, so
    ``library_ms`` is null; the dense bf16 ``torch._grouped_mm`` time of
    the same shape is printed beside it as context. Returns the record row
    and the kernel's launches over the checks (counts reset just before
    them, read just after, before the timing)."""
    from repro_torch.kernels import ops
    E, D, Fd, k = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    tol = {torch.float32: lambda kk: 2e-5 * kk,
           torch.bfloat16: lambda kk: 0.15 * math.sqrt(kk)}
    w_bytes = 1.0 if mode == "int8" else 0.5
    worst = 0.0
    wts = {}
    for part, (kk, nn) in (("gate|up", (D, 2 * Fd)), ("down", (Fd, D))):
        w = torch.randn((E, kk, nn), generator=gen,
                        device="cuda").to(torch.bfloat16)
        wts[part] = (w, *quantize(torch, mode, w))

    def operands(tokens, part, dt):
        sort_idx, sizes = routing(torch, tokens, E, k, gen)
        m = tokens * k
        w, codes, scales = wts[part]
        if part == "gate|up":
            x = torch.randn((tokens, w.shape[1]), generator=gen,
                            device="cuda").to(dt)
            return x, codes, scales, sizes, dict(row_index=sort_idx // k)
        x = torch.randn((m, w.shape[1]), generator=gen, device="cuda").to(dt)
        return x, codes, scales, sizes, dict(out_index=sort_idx, out_rows=m)

    shapes = (("decode", 8, "gate|up"), ("decode", 8, "down"),
              ("prefill", 64, "gate|up"))
    ops.reset_launch_counts()
    for dt in (torch.bfloat16, torch.float32):
        for label, tokens, part in shapes:
            x, codes, scales, sizes, kw = operands(tokens, part, dt)
            got = ops.grouped_gemm(x, codes, sizes, scales=scales, **kw)
            want = ops.grouped_gemm(x, codes, sizes, scales=scales,
                                    impl="plain", **kw)
            if got.dtype != dt:
                raise AssertionError(f"{mode} output dtype {got.dtype}")
            err = check_close(f"grouped_gemm_{mode} {label} {part} {dt}",
                              got, want, tol[dt](x.shape[1]))
            if dt == torch.bfloat16:
                worst = max(worst, err)
    # empty groups and rows past sum(group_sizes); fused == unfused in f32
    _, codes, scales = wts["gate|up"]
    sizes = torch.tensor([0, 17, 0, 0, 30, 1] + [0] * (E - 6),
                         dtype=torch.int32, device="cuda")
    x = torch.randn((64, D), generator=gen, device="cuda")
    got = ops.grouped_gemm(x, codes, sizes, scales=scales)
    check_close(f"grouped_gemm_{mode} empty-groups+surplus f32", got,
                ops.grouped_gemm(x, codes, sizes, scales=scales,
                                 impl="plain"), tol[torch.float32](D))
    if got[48:].abs().max() != 0:
        raise AssertionError(f"surplus rows of the {mode} GEMM are not 0")
    sort_idx, sizes = routing(torch, 64, E, k, gen)
    ri = sort_idx // k
    fused = ops.grouped_gemm(x, codes, sizes, row_index=ri,
                             out_index=sort_idx, out_rows=64 * k,
                             scales=scales)
    unfused = torch.zeros_like(fused)
    unfused[sort_idx] = ops.grouped_gemm(x[ri], codes, sizes, scales=scales)
    if not torch.equal(fused, unfused):
        raise AssertionError(f"fused {mode} grouped GEMM is not bit-identical"
                             " to gather -> GEMM -> scatter in f32")
    log(f"  grouped_gemm_{mode} fused == unfused (f32): bit-identical")
    counts = ops.launch_counts()
    checks = 2 * len(shapes) + 3
    log(f"  grouped_gemm_{mode} check launches: {counts}")
    if counts != {**{name: 0 for name in counts}, f"grouped_gemm_{mode}": checks}:
        raise AssertionError(f"the {mode} checks launched {counts}, not "
                             f"{checks} {mode} kernels alone")

    rows = {}
    for label, tokens, part in shapes:
        x, codes, scales, sizes, kw = operands(tokens, part, torch.bfloat16)
        w = wts[part][0]
        m = tokens * k
        kk, nn = w.shape[1], w.shape[2]
        ms = timer(lambda: ops.grouped_gemm(x, codes, sizes, scales=scales,
                                            **kw))
        plain_ms = timer(lambda: ops.grouped_gemm(
            x, codes, sizes, scales=scales, impl="plain", **kw), iters=5)
        dense_ms = None
        if hasattr(torch, "_grouped_mm"):
            xs = (x[kw["row_index"]].contiguous() if "row_index" in kw
                  else x)
            offs = torch.cumsum(sizes, 0).to(torch.int32)
            dense_ms = timer(lambda: torch._grouped_mm(xs, w, offs=offs))
        visited = int((sizes > 0).sum())
        n_scales = 1 if mode == "int8" else nn // INT4_BLOCK_N
        nbytes = (x.shape[0] * kk * 2 + visited * kk * nn * w_bytes
                  + visited * n_scales * 4 + m * nn * 2 + m * 4)
        b_ms, b_by = bound(nbytes, 2 * m * kk * nn, PEAK_BF16_FLOPS)
        log(f"  grouped_gemm_{mode} {label} {part} bf16 (M={m}, K={kk}, "
            f"N={nn}, {visited}/{E} experts): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library none (dense bf16 _grouped_mm "
            f"{dense_ms} ms), bound {b_ms:.4f} ms ({b_by})")
        rows[(label, part)] = {"max_abs_err": worst, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": None}
    return rows[("decode", "gate|up")], checks


def splitkv_head_sweep(torch, gen) -> None:
    """Split-KV against its plain version in every variant the kernel
    has: query groups 1/2/4/8 x head dims 16/32/64/112/128, f32 and bf16,
    on 4 sequences of a 1000-slot cache with lengths 0, 1, 517 and more
    than T."""
    from repro_torch.kernels import ops
    hkv, t = 2, 1000
    lengths = torch.tensor([0, 1, 517, 1003], dtype=torch.int32,
                           device="cuda")
    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        tol = 5e-2 if dt == torch.bfloat16 else 1e-5
        for group in (1, 2, 4, 8):
            for d in (16, 32, 64, 112, 128):
                q = torch.randn((4, hkv * group, d), generator=gen,
                                device="cuda").to(dt)
                kc = torch.randn((4, t, hkv, d), generator=gen,
                                 device="cuda").to(dt)
                vc = torch.randn((4, t, hkv, d), generator=gen,
                                 device="cuda").to(dt)
                got, lse = ops.splitkv_attention(q, kc, vc, lengths,
                                                 return_lse=True)
                want, want_lse = ops.splitkv_attention(
                    q, kc, vc, lengths, return_lse=True, impl="plain")
                for what, x, y in (("out", got, want), ("lse", lse, want_lse)):
                    err = (x.float() - y.float()).abs()
                    if not bool((err <= tol + 1e-2 * y.float().abs()).all()):
                        raise AssertionError(
                            f"splitkv group {group} d {d} {dt} {what}: max "
                            f"abs err {float(err.max())}")
                    key = (dt, what)
                    worst[key] = max(worst.get(key, 0.0), float(err.max()))
    log("  splitkv sweep (groups 1/2/4/8 x d 16/32/64/112/128, lengths 0, "
        "1, 517, 1003 of T 1000): max_abs_err " + ", ".join(
            f"{str(dt).split('.')[-1]} {what} {e:.3e}"
            for (dt, what), e in worst.items()) + " ok")


def no_live_key_rows(torch, cfg, gen) -> None:
    """Rows with no live key: a prefill chunk with t_valid = 0, a chunk
    whose 8-key window holds no live slot, and decode sequences with
    lengths 0. Kernel and plain version both give the mean of v over the T
    slots (and an LSE of -1e30)."""
    from repro_torch.kernels import ops
    hq, hkv, d, t = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 1024
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((2, 64, hq, d), generator=gen, device="cuda").to(dt)
        kc = torch.randn((2, t, hkv, d), generator=gen, device="cuda").to(dt)
        vc = torch.randn((2, t, hkv, d), generator=gen, device="cuda").to(dt)
        for off, tv, win in ((448, 0, None), (600, 300, 8)):
            kw = dict(q_offset=off, t_valid=tv, window=win)
            check_close(f"flash_prefill no live key (q_offset={off}, "
                        f"t_valid={tv}, window={win}) {dt}",
                        ops.flash_prefill_attention(q, kc, vc, **kw),
                        ops.flash_prefill_attention(q, kc, vc, impl="plain",
                                                    **kw),
                        5e-2 if dt == torch.bfloat16 else 2e-5)
        lengths = torch.tensor([0, 300], dtype=torch.int32, device="cuda")
        got, lse = ops.splitkv_attention(q[:, 0], kc, vc, lengths,
                                         return_lse=True)
        want, want_lse = ops.splitkv_attention(q[:, 0], kc, vc, lengths,
                                               return_lse=True, impl="plain")
        tol = 5e-2 if dt == torch.bfloat16 else 1e-5
        check_close(f"splitkv lengths [0, 300] out {dt}", got, want, tol)
        check_close(f"splitkv lengths [0, 300] lse {dt}", lse, want_lse, tol)
        if not torch.equal(lse[0], want_lse[0]):
            raise AssertionError("LSE of a sequence with no live key differs "
                                 "from the plain version's -1e30")


def fused_bit_identity_bf16(torch, cfg, gen) -> None:
    """bf16 fused gather + scatter == gather -> GEMM -> scatter, bit for
    bit, in every weight mode at the main path's expert shapes (decode and
    prefill routing): the tensor-core kernel's gather and scatter only
    change addresses."""
    from repro_torch.kernels import ops
    E, D, Fd, k = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    w = torch.randn((E, D, 2 * Fd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    weights = {"dense": (w, None), "int8": quantize(torch, "int8", w),
               "int4": quantize(torch, "int4", w)}
    for tokens in (8, 64):
        sort_idx, sizes = routing(torch, tokens, E, k, gen)
        x = torch.randn((tokens, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        ri = sort_idx // k
        for mode, (rhs, scales) in weights.items():
            fused = ops.grouped_gemm(x, rhs, sizes, row_index=ri,
                                     out_index=sort_idx,
                                     out_rows=tokens * k, scales=scales)
            unfused = torch.zeros_like(fused)
            unfused[sort_idx] = ops.grouped_gemm(x[ri], rhs, sizes,
                                                 scales=scales)
            if not torch.equal(fused, unfused):
                raise AssertionError(
                    f"fused {mode} grouped GEMM ({tokens} tokens) is not "
                    "bit-identical to gather -> GEMM -> scatter in bf16")
    log("  grouped_gemm fused == unfused (bf16; dense, int8, int4; 8 and 64 "
        "tokens): bit-identical")


def flash_prefill_kimi_heads(torch, timer, gen) -> None:
    """Flash prefill at Kimi K2's head layout (64 q heads over 8 kv heads,
    d 112) against its plain version at phase 3's chunk shape, in bf16
    and f32, then its bf16 times beside its bound, the plain version's and
    SDPA's (logged only; the kernels' record keeps granite's shape). A
    head dim outside the kernel's set must raise."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    import torch.nn.functional as F
    kimi = get_config("kimi-k2-1t-a32b")
    hq, hkv, d, t, s = kimi.n_heads, kimi.n_kv_heads, kimi.d_head, 1024, 64
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((1, s, hq, d), generator=gen, device="cuda").to(dt)
        kc = torch.randn((1, t, hkv, d), generator=gen, device="cuda").to(dt)
        vc = torch.randn((1, t, hkv, d), generator=gen, device="cuda").to(dt)
        for off in (0, 448, 960):
            kw = dict(q_offset=off, t_valid=off + s)
            want = ops.flash_prefill_attention(q, kc, vc, impl="plain", **kw)
            check_close(f"flash_prefill Kimi heads (hq {hq}, hkv {hkv}, d "
                        f"{d}) q_offset={off} {dt}",
                        ops.flash_prefill_attention(q, kc, vc, **kw), want,
                        bf16_atol(want) if dt == torch.bfloat16
                        else 2e-5)
    q, kc, vc = (x.to(torch.bfloat16) for x in (q, kc, vc))
    off, tv = 448, 512
    ms = timer(lambda: ops.flash_prefill_attention(q, kc, vc, q_offset=off,
                                                   t_valid=tv))
    plain_ms = timer(lambda: ops.flash_prefill_attention(
        q, kc, vc, q_offset=off, t_valid=tv, impl="plain"), iters=5)
    mask = _sdpa_mask(torch, off + torch.arange(s, device="cuda"), t, tv)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    keys = sum(min(off + j + 1, tv) for j in range(s))     # live keys
    nbytes = (2 * s * hq * d + 2 * tv * hkv * d) * 2
    b_ms, b_by = bound(nbytes, 4 * keys * hq * d, PEAK_BF16_FLOPS)
    log(f"  flash_prefill Kimi heads bf16 (S={s}, q_offset={off}, "
        f"t_valid={tv}, T={t}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    odd = torch.zeros((1, 8, 8, 96), dtype=torch.bfloat16, device="cuda")
    try:
        ops.flash_prefill_attention(odd, odd, odd)
    except ValueError as e:
        log(f"  flash_prefill at d 96 raises: {e}")
    else:
        raise AssertionError("flash_prefill took head dim 96")


def fleet_shape_kernels(torch, cfg, gen) -> None:
    """The serving kernels at phase 7's shapes against their plain
    versions: split-KV over a 32-slot cache for 1 and 2 sequences (every
    length 1..32 on some row), and both expert GEMMs of 1 and 2 tokens
    (8 and 16 rows of top-8 routing), in bf16 and f32, at the tolerances
    of the main-path checks above."""
    from repro_torch.kernels import ops
    E, D, F, k = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    hq, hkv, d, t = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 32
    gemm_tol = {torch.float32: lambda kk: 2e-5 * kk,
                torch.bfloat16: lambda kk: 0.15 * math.sqrt(kk)}
    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        tol = 5e-2 if dt == torch.bfloat16 else 1e-5
        for b in (1, 2):
            q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dt)
            kc = torch.randn((b, t, hkv, d), generator=gen,
                             device="cuda").to(dt)
            vc = torch.randn((b, t, hkv, d), generator=gen,
                             device="cuda").to(dt)
            for n in range(1, t + 1):
                lengths = torch.tensor([n, t + 1 - n][:b], dtype=torch.int32,
                                       device="cuda")
                got, lse = ops.splitkv_attention(q, kc, vc, lengths,
                                                 return_lse=True)
                want, want_lse = ops.splitkv_attention(
                    q, kc, vc, lengths, return_lse=True, impl="plain")
                for what, x, y in (("out", got, want), ("lse", lse, want_lse)):
                    key = f"splitkv B {b} {what} {name}"
                    worst[key] = max(worst.get(key, 0.0), check_close(
                        f"{key} lengths {lengths.tolist()}", x, y, tol,
                        show=False))
        for tokens in (1, 2):
            sort_idx, sizes = routing(torch, tokens, E, k, gen)
            x = torch.randn((tokens, D), generator=gen, device="cuda").to(dt)
            h = torch.randn((tokens * k, F), generator=gen,
                            device="cuda").to(dt)
            wi = torch.randn((E, D, 2 * F), generator=gen,
                             device="cuda").to(dt)
            wo = torch.randn((E, F, D), generator=gen, device="cuda").to(dt)
            for part, args, kw, kk in (
                    ("gate|up", (x, wi, sizes),
                     dict(row_index=sort_idx // k), D),
                    ("down", (h, wo, sizes),
                     dict(out_index=sort_idx, out_rows=tokens * k), F)):
                key = f"grouped_gemm {tokens * k} rows {part} {name}"
                worst[key] = check_close(
                    key, ops.grouped_gemm(*args, **kw),
                    ops.grouped_gemm(*args, impl="plain", **kw),
                    gemm_tol[dt](kk), show=False)
    log("  fleet shapes (split-KV B 1/2 x lengths 1..32 of T 32; grouped "
        "GEMM 8/16 rows): max_abs_err " + ", ".join(
            f"{key} {e:.3e}" for key, e in worst.items()) + " ok")


def jamba_cfg():
    """Phase 9's model: jamba-v0.1-52b at full width, cut to 16 layers
    (two periods of its layer plan: 2 attention and 14 Mamba mixers, 8 MoE
    and 8 dense FFNs). All 32 layers take ~104 GB in bf16, above the
    card's 80 GB."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("jamba-v0.1-52b"),
                               n_layers=JAMBA_LAYERS)


def jamba_shape_kernels(torch, timer, gen):
    """The three kernels at phase 9's shapes (Jamba's widths) against their
    plain versions in bf16 and f32, then their bf16 times beside the bound,
    the plain version's and the library call's. Grouped GEMM: 16 experts
    top-2, gate|up K 4096 N 28672, down K 14336 N 4096, at a decode micro-
    batch (4 sequences, 8 rows) and a 64-token chunk (128 rows). Flash
    prefill: Hq 32 / Hkv 8 / d 128, a 64-row chunk of a 512-slot cache.
    Split-KV: 4 sequences of a 512-slot cache. bf16 GEMM errors are also
    given relative to the plain output's norm, since the tolerance
    0.15·√K grows with K. Returns the bf16 rows, logged as one JSON
    line."""
    from repro_torch.kernels import ops
    import torch.nn.functional as F
    cfg = jamba_cfg()
    E, D, Fd, k = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    rows = {}
    gemm_tol = {torch.float32: lambda kk: 2e-5 * kk,
                torch.bfloat16: lambda kk: 0.15 * math.sqrt(kk)}
    for part, (kk, nn) in (("gate|up", (D, 2 * Fd)), ("down", (Fd, D))):
        w32 = torch.randn((E, kk, nn), generator=gen, device="cuda")
        for label, tokens in (("decode", JAMBA_MB_SLOTS), ("prefill", 64)):
            sort_idx, sizes = routing(torch, tokens, E, k, gen)
            m = tokens * k
            if part == "gate|up":
                x32 = torch.randn((tokens, kk), generator=gen, device="cuda")
                kw = dict(row_index=sort_idx // k)
            else:
                x32 = torch.randn((m, kk), generator=gen, device="cuda")
                kw = dict(out_index=sort_idx, out_rows=m)
            errs = {}
            for dt in (torch.float32, torch.bfloat16):
                w, x = w32.to(dt), x32.to(dt)
                got = ops.grouped_gemm(x, w, sizes, **kw)
                want = ops.grouped_gemm(x, w, sizes, impl="plain", **kw)
                errs[dt] = check_close(
                    f"grouped_gemm Jamba {label} {part} {dt}", got, want,
                    gemm_tol[dt](kk), show=False)
                rel = float((got.float() - want.float()).norm()
                            / want.float().norm())
                log(f"  grouped_gemm Jamba {label} {part} "
                    f"{str(dt).split('.')[-1]} (M={m}, K={kk}, N={nn}): "
                    f"max_abs_err {errs[dt]:.3e} (atol "
                    f"{gemm_tol[dt](kk):.3e}), rel_err {rel:.3e} ok")
                del got, want
            if label == "prefill" and part == "down":
                continue                  # the record keeps the three below
            xs = x[kw["row_index"]].contiguous() if "row_index" in kw else x
            in_rows = x.shape[0]
            ms = timer(lambda: ops.grouped_gemm(x, w, sizes, **kw))
            plain_ms = timer(lambda: ops.grouped_gemm(
                x, w, sizes, impl="plain", **kw), iters=5)
            library_ms = None
            if hasattr(torch, "_grouped_mm"):
                offs = torch.cumsum(sizes, 0).to(torch.int32)
                library_ms = timer(lambda: torch._grouped_mm(xs, w,
                                                             offs=offs))
            visited = int((sizes > 0).sum())
            nbytes = (in_rows * kk + visited * kk * nn + m * nn) * 2 + m * 8
            b_ms, b_by = bound(nbytes, 2 * m * kk * nn, PEAK_BF16_FLOPS)
            log(f"  grouped_gemm Jamba {label} {part} bf16 ({visited}/{E} "
                f"experts): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {library_ms} ms, bound {b_ms:.4f} ms ({b_by})")
            rows[f"grouped_gemm {label} {part}"] = {
                "M": m, "K": kk, "N": nn, "experts": visited, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": errs[torch.bfloat16]}
            del w, x, xs
        del w32
        torch.cuda.empty_cache()

    hq, hkv, d, t, c = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, JAMBA_MAX_LEN, 64
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((1, c, hq, d), generator=gen, device="cuda").to(dt)
        kc = torch.randn((1, t, hkv, d), generator=gen, device="cuda").to(dt)
        vc = torch.randn((1, t, hkv, d), generator=gen, device="cuda").to(dt)
        for off in (0, 192, t - c):
            kw = dict(q_offset=off, t_valid=off + c)
            want = ops.flash_prefill_attention(q, kc, vc, impl="plain", **kw)
            errs[(dt, off)] = check_close(
                f"flash_prefill Jamba heads q_offset={off} {dt}",
                ops.flash_prefill_attention(q, kc, vc, **kw), want,
                bf16_atol(want) if dt == torch.bfloat16 else 2e-5,
                show=False)
    log("  flash_prefill Jamba heads (Hq 32, Hkv 8, d 128, T 512), "
        "q_offset 0/192/448: max_abs_err " + ", ".join(
            f"{str(dt).split('.')[-1]} {e:.3e}" for (dt, _), e in errs.items())
        + " ok")
    q, kc, vc = (x.to(torch.bfloat16) for x in (q, kc, vc))
    off, tv = 192, 256
    ms = timer(lambda: ops.flash_prefill_attention(q, kc, vc, q_offset=off,
                                                   t_valid=tv))
    plain_ms = timer(lambda: ops.flash_prefill_attention(
        q, kc, vc, q_offset=off, t_valid=tv, impl="plain"), iters=5)
    mask = _sdpa_mask(torch, off + torch.arange(c, device="cuda"), t, tv)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    keys = sum(min(off + j + 1, tv) for j in range(c))
    nbytes = (2 * c * hq * d + 2 * tv * hkv * d) * 2
    b_ms, b_by = bound(nbytes, 4 * keys * hq * d, PEAK_BF16_FLOPS)
    log(f"  flash_prefill Jamba heads bf16 (S={c}, q_offset={off}, "
        f"t_valid={tv}, T={t}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows["flash_prefill"] = {
        "q_offset": off, "t_valid": tv, "T": t, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
        "bound_by": b_by, "max_abs_err": max(
            e for (dt, _), e in errs.items() if dt == torch.bfloat16)}

    rows["splitkv_attention"], _ = splitkv_row(
        torch, timer, gen, "Jamba heads", (hq, hkv, d), t,
        [[1, 100, 300, t]], [170, 60, 290, 110])
    log("  jamba_kernels " + json.dumps(rows))
    return rows


def _sdpa_mask(torch, rows, t, t_valid):
    cols = torch.arange(t, device="cuda")[None, :]
    return (cols < t_valid) & (cols <= rows[:, None])


def kernel_flash_prefill(torch, timer, cfg, gen):
    from repro_torch.kernels import ops
    import torch.nn.functional as F
    hq, hkv, d, t, s = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 1024, 64
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((1, s, hq, d), generator=gen, device="cuda").to(dt)
        kc = torch.randn((1, t, hkv, d), generator=gen, device="cuda").to(dt)
        vc = torch.randn((1, t, hkv, d), generator=gen, device="cuda").to(dt)
        for off in (0, 448, 960):
            tv = off + s
            got = ops.flash_prefill_attention(q, kc, vc, q_offset=off,
                                              t_valid=tv)
            want = ops.flash_prefill_attention(q, kc, vc, q_offset=off,
                                               t_valid=tv, impl="plain")
            err = check_close(f"flash_prefill q_offset={off} t_valid={tv} "
                              f"{dt}", got, want,
                              bf16_atol(want) if dt == torch.bfloat16
                              else 2e-5)
            if dt == torch.bfloat16:
                worst = max(worst, err)
    # timing: a 64-token chunk at offset 448 of a 1024-slot cache
    q = torch.randn((1, s, hq, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    kc = torch.randn((1, t, hkv, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vc = torch.randn_like(kc)
    off, tv = 448, 512
    ms = timer(lambda: ops.flash_prefill_attention(q, kc, vc, q_offset=off,
                                                   t_valid=tv))
    plain_ms = timer(lambda: ops.flash_prefill_attention(
        q, kc, vc, q_offset=off, t_valid=tv, impl="plain"))
    mask = _sdpa_mask(torch, off + torch.arange(s, device="cuda"), t, tv)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    keys = sum(min(off + j + 1, tv) for j in range(s))     # live keys
    nbytes = (2 * s * hq * d + 2 * tv * hkv * d) * 2
    b_ms, b_by = bound(nbytes, 4 * keys * hq * d, PEAK_BF16_FLOPS)
    log(f"  flash_prefill bf16 (S={s}, q_offset={off}, t_valid={tv}, T={t}):"
        f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    clean_ms = timer(lambda: ops.flash_prefill_attention(
        q, kc, vc, q_offset=off, t_valid=tv), clean=True)
    clean_lib = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), clean=True)
    log(f"    L2 flushed by reads: kernel {clean_ms:.4f} ms, library "
        f"{clean_lib:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def splitkv_row(torch, timer, gen, name, heads, t, checks, timed,
                clean=False):
    """Split-KV with ``heads`` = (Hq, Hkv, d) over a ``t``-slot cache
    against its plain version in bf16 and f32, out and LSE, for each list
    of per-sequence lengths in ``checks`` (B = the lists' length; both
    clamp lengths past ``t``). bf16 out is held sequence by sequence at
    ``bf16_atol`` of that sequence's plain output, f32 at 1e-5; LSE at
    5e-2 / 1e-5. Then the bf16 kernel at the ``timed`` lengths beside the
    bound, the plain version and SDPA (``clean``: also with L2 flushed).
    Returns the bf16 row and the timed inputs (q, k, v, lengths)."""
    from repro_torch.kernels import ops
    import torch.nn.functional as F
    hq, hkv, d = heads
    b = len(timed)
    errs, atols = {}, []
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dt)
        kc = torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dt)
        vc = torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dt)
        errs[dt] = 0.0
        for lens in checks:
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got, lse = ops.splitkv_attention(q, kc, vc, lengths,
                                             return_lse=True)
            want, want_lse = ops.splitkv_attention(
                q, kc, vc, lengths, return_lse=True, impl="plain")
            for i, n in enumerate(lens):
                atol = bf16_atol(want[i]) if dt == torch.bfloat16 else 1e-5
                atols.append(atol)
                errs[dt] = max(errs[dt], check_close(
                    f"splitkv {name} out {dt} length {n}", got[i], want[i],
                    atol, show=False))
            check_close(f"splitkv {name} lse {dt}", lse, want_lse,
                        5e-2 if dt == torch.bfloat16 else 1e-5, show=False)
    log(f"  splitkv {name} (Hq {hq}, Hkv {hkv}, d {d}, B {b}, T {t}; "
        f"{len(checks) * b} lengths {min(map(min, checks))}.."
        f"{max(map(max, checks))}): max_abs_err " + ", ".join(
            f"{str(dt).split('.')[-1]} {e:.3e}" for dt, e in errs.items())
        + f" ok (bf16 atols {min(atols[:len(atols) // 2]):.3e}.."
        f"{max(atols[:len(atols) // 2]):.3e})")
    q, kc, vc = (x.to(torch.bfloat16) for x in (q, kc, vc))
    lengths = torch.tensor(timed, dtype=torch.int32, device="cuda")
    ms = timer(lambda: ops.splitkv_attention(q, kc, vc, lengths))
    plain_ms = timer(lambda: ops.splitkv_attention(q, kc, vc, lengths,
                                                   impl="plain"))
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    live = int(lengths.clamp(max=t).sum())
    nbytes = (2 * b * hq * d + 2 * live * hkv * d) * 2 + b * 4
    b_ms, b_by = bound(nbytes, 4 * live * hq * d, PEAK_BF16_FLOPS)
    log(f"  splitkv {name} bf16 (B={b}, T={t}, {live} live keys): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by})")
    if clean:
        clean_ms = timer(lambda: ops.splitkv_attention(q, kc, vc, lengths),
                         clean=True)
        clean_lib = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), clean=True)
        log(f"    L2 flushed by reads: kernel {clean_ms:.4f} ms, library "
            f"{clean_lib:.4f} ms")
    row = {"B": b, "T": t, "live_keys": live, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": errs[torch.bfloat16]}
    return row, (q, kc, vc, lengths)


def kernel_splitkv(torch, timer, cfg, gen):
    """Split-KV at the serve's shapes (8 sequences of a 1024-slot cache),
    timed at the smoke serve's typical decode lengths, then what sets that
    time."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import splitkv_attention as skv
    hkv, d = cfg.n_kv_heads, cfg.d_head
    row, (q, kc, vc, lengths) = splitkv_row(
        torch, timer, gen, "main path", (cfg.n_heads, hkv, d), 1024,
        [[1, 63, 64, 65, 300, 512, 777, 1024]],
        [330, 120, 512, 64, 400, 575, 250, 90], clean=True)
    b, t = row["B"], row["T"]
    # what sets that time: the timer's floor (a one-element add), and the
    # kernel with every live prefix cut to one split (no combine)
    split, _ = skv.plan_splits(
        b, hkv, t, torch.cuda.get_device_properties(0).multi_processor_count,
        skv.max_split(d, 2))
    one = torch.zeros(1, device="cuda")
    short = torch.clamp(lengths, max=split)
    log(f"    timer floor (one-element add) {timer(lambda: one.add_(1)):.4f}"
        f" ms; split {split} keys, every prefix cut to one split "
        f"({int(short.sum())} live keys, no combine) "
        f"{timer(lambda: ops.splitkv_attention(q, kc, vc, short)):.4f} ms")
    # the planner's blocks per SM over the whole cache, against other choices
    waves, sweep = skv.WAVES, []
    try:
        for w in (2, 4, 8, 16):
            skv.WAVES = w
            split, _ = skv.plan_splits(
                b, hkv, t,
                torch.cuda.get_device_properties(0).multi_processor_count,
                skv.max_split(d, 2))
            sweep.append(f"{split} keys "
                         f"{timer(lambda: ops.splitkv_attention(q, kc, vc, lengths)):.4f}")
    finally:
        skv.WAVES = waves
    log(f"    split size (planner default WAVES={waves}): "
        + ", ".join(sweep) + " ms")
    return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}


# ---------------------------------------------------------------------------
# Phases 4 and 5
# ---------------------------------------------------------------------------

def serve(torch, cfg, params, card):
    from repro_torch.kernels import ops
    from repro_torch.parallel.afd import AFDRuntime, AFDStats
    from repro_torch.serving.afd_engine import AFDServeEngine
    from repro_torch.serving.workload import (LengthDist, Phase,
                                              TrafficProfile, generate_trace)
    rt = AFDRuntime(cfg, params)
    # warm-up outside the measured run: cuBLAS handles, allocator
    caches, pos = rt.init_cache(1, 64)
    rt.prefill(torch.ones((1, 8), dtype=torch.int32, device="cuda"),
               caches, pos)
    rt.synchronize()
    rt.stats = AFDStats()
    profile = TrafficProfile(
        name="chip-smoke", phases=(Phase(2.0, 12.0),),
        prompt_len=LengthDist(64, 512), output_len=LengthDist(16, 64))
    trace = generate_trace(profile, seed=0, max_requests=24)
    eng = AFDServeEngine(rt, max_len=1024, n_bo=2, mb_slots=8,
                         prefill_chunk=64, tick_seconds=None)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(trace, max_ticks=20_000)
    rt.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    s = eng.summary()
    log(f"  {card}: {s['completed']}/{len(trace)} completed, "
        f"{s['tokens_out']} tokens in {wall:.2f} s wall "
        f"({s['tokens_out'] / wall:.1f} tokens/s), decode_ticks "
        f"{s['decode_ticks']}, engine_ticks {s['engine_ticks']}, prefill "
        f"chunks {s['prefill_chunks']}")
    log(f"  TTFT p50 {s['ttft_p50']:.4f} s, p95 {s['ttft_p95']:.4f} s; "
        f"mean TPOT {s['tpot_mean']:.4f} s; bytes_match_all "
        f"{s['bytes_match_all']} (dispatch {s['dispatch_bytes']} B, combine "
        f"{s['combine_bytes']} B)")
    log(f"  launches: {launches} (per engine tick: "
        + ", ".join(f"{k} {v / s['engine_ticks']:.2f}"
                    for k, v in launches.items()) + ")")
    log("  serve_summary " + json.dumps({**s, "wall_s": wall,
                                         "launches": launches},
                                        default=float))
    if s["completed"] != len(trace):
        raise AssertionError(f"only {s['completed']}/{len(trace)} requests "
                             "completed")
    if not s["bytes_match_all"]:
        raise AssertionError("measured M2N bytes diverged from Eq. 9/17")
    check_path_launches(launches, s, eng.rt.specs, eng.n_bo)
    return launches


def check_path_launches(launches, s, specs, n_bo) -> None:
    """Every layer of every decode micro-batch and every prefill chunk went
    through the kernels: one split-KV launch per attention layer of each
    decode micro-batch, one flash launch per attention layer of each
    prefill chunk, a gate|up + down pair per MoE layer of both; and no
    quantized launch (the serving path holds dense weights)."""
    missing = [k for k in PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    attn = sum(1 for sp in specs if sp.kind == "attn")
    moe = sum(1 for sp in specs if sp.moe)
    steps = s["decode_ticks"] * n_bo
    expected = {"grouped_gemm": 2 * moe * (steps + s["prefill_chunks"]),
                "grouped_gemm_int8": 0, "grouped_gemm_int4": 0,
                "flash_prefill": attn * s["prefill_chunks"],
                "splitkv_attention": attn * steps}
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")


def policy_loop(torch, cfg, params, card) -> None:
    """Phase 6: the serve of phase 4's model under the §3.3 policy loop,
    on the wall clock: an EP-mode SLOScheduler at a 50 ms TPOT SLO (its
    per-tick budget on the wall clock) and an HFUProbe on the AFD plan for
    the H100 entry of core.hardware (the card this runs on)."""
    from repro_torch.api.registry import spec_from_arch_config
    from repro_torch.core.hardware import HARDWARE
    from repro_torch.core.planner import plan_afd
    from repro_torch.kernels import ops
    from repro_torch.parallel.afd import AFDRuntime
    from repro_torch.serving.afd_engine import AFDServeEngine, HFUProbe
    from repro_torch.serving.scheduler import SLOConfig, SLOScheduler
    from repro_torch.serving.workload import (LengthDist, Phase,
                                              TrafficProfile, generate_trace)
    spec, hw = spec_from_arch_config(cfg), HARDWARE["H100"]
    plan = plan_afd(spec, hw)
    log(f"  AFD plan for {spec.name} on {hw.name}: n_a {plan.n_a}, n_f "
        f"{plan.n_f}, t_B {plan.t_budget:.6e} s, B_rank {plan.b_rank:.6e}, "
        f"HFU {plan.hfu:.6e}")
    profile = TrafficProfile(
        name="chip-policy", phases=(Phase(2.0, 8.0),),
        prompt_len=LengthDist(64, 256), output_len=LengthDist(16, 32))
    trace = generate_trace(profile, seed=1, max_requests=12)
    eng = AFDServeEngine(
        AFDRuntime(cfg, params), max_len=1024, n_bo=2, mb_slots=8,
        prefill_chunk=64, tick_seconds=None,
        scheduler=SLOScheduler(SLOConfig(tpot=0.05), mode="ep", plan=plan),
        probe=HFUProbe(model=spec, hardware=hw, plan=plan))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(trace, max_ticks=20_000)
    eng.rt.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    s = eng.summary()
    log(f"  {card}: {s['completed']}/{len(trace)} completed, "
        f"{s['tokens_out']} tokens in {wall:.2f} s wall, decode_ticks "
        f"{s['decode_ticks']}, engine_ticks {s['engine_ticks']}, "
        f"{len(eng.windows)} windows; launches {launches}")
    log("  win ticks live_cap  sigma  straggler  alpha  alpha_other  "
        "hfu_measured / hfu_predicted  b_rank_util  bytes_ok")
    for w in eng.windows:
        log(f"  {w.window:3d} {w.ticks:5d} {w.live_cap:8d}  {w.sigma:.4f}  "
            f"{w.straggler_rate:9.4f}  {w.alpha:.4f}  {w.alpha_other:11.4f}"
            f"  {w.hfu_measured:.6e} / {w.hfu_predicted:.6e}  "
            f"{w.b_rank_utilization:.6e}  {w.bytes_match}")
    log("  policy_summary " + json.dumps(
        {**s, "wall_s": wall, "launches": launches,
         "live_cap": [w.live_cap for w in eng.windows]}, default=float))
    if s["completed"] != len(trace):
        raise AssertionError(f"policy loop: only {s['completed']}/"
                             f"{len(trace)} requests completed")
    for w in eng.windows:
        if not w.bytes_match:
            raise AssertionError(f"window {w.window}: bytes diverged")
        fields = (w.sigma, w.alpha, w.alpha_other, w.policy_mode,
                  w.live_cap, w.hfu_measured, w.hfu_predicted,
                  w.b_rank_utilization)
        if any(f is None for f in fields) or w.live_cap < 1:
            raise AssertionError(f"window {w.window} lacks policy or HFU "
                                 f"fields: {fields}")
        if w.tokens_routed and w.hfu_measured > w.hfu_predicted + 1e-15:
            raise AssertionError(f"window {w.window}: measured HFU "
                                 f"{w.hfu_measured} above the plan's "
                                 f"{w.hfu_predicted}")
    check_path_launches(launches, s, eng.rt.specs, eng.n_bo)


def fleet(torch, cfg, params, card) -> None:
    """Phase 7: three full-width replicas behind the least-kv router, a
    fatal failure of replica 1 at t = 1.8 s, the HFU probe and the elastic
    N_F rescaler on the H100 plan; then the runtime rescale of replica 0."""
    from repro_torch.api.registry import spec_from_arch_config
    from repro_torch.core import planner as pln
    from repro_torch.core.hardware import HARDWARE
    from repro_torch.fleet.controller import FleetController, FleetReplica
    from repro_torch.fleet.events import FailureEvent
    from repro_torch.fleet.rescaler import ElasticRescaler
    from repro_torch.kernels import ops
    from repro_torch.parallel.afd import AFDRuntime, rescale
    from repro_torch.serving.afd_engine import AFDServeEngine, HFUProbe
    from repro_torch.serving.workload import generate_trace, get_profile
    spec, hw = spec_from_arch_config(cfg), HARDWARE["H100"]
    plan = pln.plan_afd(spec, hw)
    probe = HFUProbe(model=spec, hardware=hw, plan=plan)
    replicas = [FleetReplica(name=f"replica{i}", engine=AFDServeEngine(
        AFDRuntime(cfg, params), max_len=32, n_bo=1, mb_slots=2,
        probe=probe, seed=0, tick_seconds=0.01, window_ticks=8))
        for i in range(3)]
    ctl = FleetController(replicas, router="least-kv",
                          rescaler=ElasticRescaler(spec, hw, plan),
                          window_ticks=8)
    trace = generate_trace(get_profile("poisson-burst"), seed=0,
                           max_requests=48)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ctl.run(trace, failures=[FailureEvent(t=1.8, replica=1)],
            max_ticks=5000)
    for rep in ctl.replicas:
        rep.engine.rt.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    s = ctl.summary()
    engines = [rep.engine for rep in ctl.replicas]
    routed = tuple(rep.dispatched for rep in ctl.replicas)
    decode = tuple(e.stats.decode_ticks for e in engines)
    prompt = tuple(e.stats.prefill_tokens for e in engines)
    steps = sum(e.stats.decode_ticks * e.n_bo + e.stats.prefill_tokens
                for e in engines)
    traj = [plan.n_f] + [e.new_n_f for e in ctl.rescales]
    log(f"  {card}: {s['completed']}/{s['arrivals']} completed, lost "
        f"{s['lost']}, requeued {s['requeued']}, {s['fleet_ticks']} fleet "
        f"ticks, {s['windows']} windows, bytes_match_all "
        f"{s['bytes_match_all']}; {steps} engine steps in {wall:.2f} s wall "
        f"({wall / steps * 1e3:.2f} ms per step)")
    log(f"  routed {routed}, decode ticks {decode}, prompt tokens {prompt}, "
        f"rescale {'->'.join(map(str, traj))}; on the virtual clock: TTFT "
        f"p50 {s['ttft_p50']:.4f} s, p95 {s['ttft_p95']:.4f} s, goodput "
        f"{s['goodput_rps']:.4f} req/s")
    log(f"  launches: {launches}")
    log("  fleet_summary " + json.dumps(
        {**s, "wall_s": wall, "launches": launches,
         "rescales": [dataclasses.asdict(e) for e in ctl.rescales]},
        default=float))
    got = {k: s[k] for k in FLEET_TOTALS}
    if got != FLEET_TOTALS or not all(w.bytes_match for w in ctl.windows):
        raise AssertionError(f"fleet totals {got} != {FLEET_TOTALS}, or a "
                             "window's bytes diverged")
    if (routed, decode, prompt) != (FLEET_ROUTED, FLEET_DECODE_TICKS,
                                    FLEET_PREFILL_TOKENS):
        raise AssertionError(f"per-replica counts {routed} {decode} "
                             f"{prompt} differ from the reference")
    if traj != FLEET_TRAJECTORY:
        raise AssertionError(f"rescale trajectory {traj}")
    for e in ctl.rescales:
        want = pln.rescale_n_f(pln.plan_afd(spec, hw, n_f=e.old_n_f),
                               e.sigma, e.threshold).new_n_f
        if want != e.new_n_f:
            raise AssertionError(f"rescale event {e} disagrees with the "
                                 f"planner's N_F {want}")
    # legacy prefill runs each prompt token as a one-sequence decode step,
    # so every engine step is one split-KV launch per attention layer and a
    # gate|up + down pair per MoE layer
    attn = sum(1 for sp in engines[0].rt.specs if sp.kind == "attn")
    moe = sum(1 for sp in engines[0].rt.specs if sp.moe)
    expected = {"grouped_gemm": 2 * moe * steps, "grouped_gemm_int8": 0,
                "grouped_gemm_int4": 0, "flash_prefill": 0,
                "splitkv_attention": attn * steps}
    if launches != expected:
        raise AssertionError(f"fleet launches {launches} != {expected}")

    rt0 = engines[0].rt
    fleet_path_check(torch, cfg, params, rt0)
    rt1 = rescale(rt0, rt0.a_device, rt0.f_devices)
    shared = (rt1.f_shards[0][0]["wi"].data_ptr()
              == rt0.f_shards[0][0]["wi"].data_ptr())
    tokens = torch.tensor([7, 123], dtype=torch.int32, device="cuda")
    logits = []
    for rt in (rt0, rt1):
        caches, pos = rt.init_cache(2, 32)
        logits.append(rt.decode_step(tokens, caches, pos)[0])
    same = torch.equal(*logits)
    log(f"  rescale of replica 0 on {rt1.a_device}/{rt1.f_devices[0]}: expert "
        f"weights shared {shared}; decode logits bit-identical {same}")
    if not (same and shared):
        raise AssertionError("the rescaled runtime's logits differ, or it "
                             "copied the shared weights")


@contextlib.contextmanager
def recording_routes(calls, replay=None):
    """Record every router call of the runtimes run inside: (router input
    (N, D) float32, router probabilities (N, E), top-k ids (N, k)). With
    ``replay`` (another run's record), each call takes the expert ids of
    the recorded call in the same position instead of its own top-k, and
    weighs them with its own probabilities."""
    from repro_torch.models import moe
    route = moe.route
    recorded = iter(replay or ())

    def recording(params, cfg, x):
        probs, topw, topi = route(params, cfg, x)
        if replay is not None:
            topi = next(recorded)[2]
            topw = probs.gather(-1, topi.long())
            if cfg.router_renorm:
                topw = topw / topw.sum(-1, keepdim=True)
        calls.append((x.float(), probs, topi))
        return probs, topw, topi
    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


def routing_flips(torch, calls_a, calls_b, top_k: int):
    """Per router call, the rows whose top-k expert sets differ between two
    runs of the same inputs, with run b's probability margin between its
    k-th and (k+1)-th expert on those rows."""
    flips, margins = [], []
    for (_, _, ia), (_, pb, ib) in zip(calls_a, calls_b):
        differ = (torch.sort(ia, -1).values != torch.sort(ib, -1).values
                  ).any(-1)
        flips.append(int(differ.sum()))
        if flips[-1]:
            top = torch.topk(pb[differ], top_k + 1, dim=-1).values
            margins += (top[:, top_k - 1] - top[:, top_k]).tolist()
    return flips, margins


def fleet_path_check(torch, cfg, params, rt) -> None:
    """Replica 0's runtime against a plain-version runtime on the same
    tokens, at the fleet's shapes: legacy prefill (one sequence, one
    ``decode_step`` per prompt token into a 32-slot cache), then a 2-slot
    micro-batch through ``decode_step_3bo`` up to length 32, its second
    slot reset to position 0 halfway as a drain leaves it. The logits are
    held to phase 5's relative error.

    To show where that error comes from, a third run takes the same bf16
    weights in float32 on the plain path, and every router call is
    recorded: the error per step, the top-8 routing disagreements per
    (step, layer) between the runs with the plain run's router margin on
    each, the error before the first disagreement, and a plain run that
    replays the kernel run's expert choices."""
    from repro_torch.models.common import tree_map
    from repro_torch.parallel.afd import AFDRuntime
    gen = seeded(torch, 9)
    toks = torch.randint(1, cfg.vocab_size, (2, 32), generator=gen,
                         device="cuda", dtype=torch.int32)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    runs = {"kernels": rt, "plain": AFDRuntime(cfg, params, impl="plain"),
            "plain_f32": AFDRuntime(cfg32, params32, impl="plain"),
            "replay": AFDRuntime(cfg, params, impl="plain")}
    results, calls = {}, {}
    for name, runtime in runs.items():
        out = []
        with recording_routes(calls.setdefault(name, []),
                              calls["kernels"] if name == "replay" else None):
            caches, pos = runtime.init_cache(1, 32)
            for j in range(12):
                lg, caches, pos = runtime.decode_step(toks[0, j:j + 1],
                                                      caches, pos)
                out.append(lg)
            caches, pos = runtime.init_cache(2, 32)
            for j in range(32):
                if j == 16:
                    pos[1] = 0
                ((lg, caches, pos),) = runtime.decode_step_3bo(
                    [(toks[:, j], caches, pos)], n_bo=1)
                out.append(lg)
        results[name] = [o.float() for o in out]
    del runs, params32

    def rel(a, b):
        return float((torch.cat(a) - torch.cat(b)).norm()
                     / torch.cat(b).norm())
    got, want = torch.cat(results["kernels"]), torch.cat(results["plain"])
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite logits at the fleet's shapes")
    rel_err = rel(results["kernels"], results["plain"])
    log(f"  replica 0 vs plain versions at the fleet's shapes (12 legacy "
        f"prefill steps, 32 decode steps of 2 slots, lengths up to 32): "
        f"logits {tuple(got.shape)} rel_err {rel_err:.3e} (≤ {PATH_REL_TOL}),"
        f" max_abs_err {float((got - want).abs().max()):.3e}")
    layers = cfg.n_layers
    per_step = [float((a - b).norm() / b.norm()) for a, b in
                zip(results["kernels"], results["plain"])]
    flips, margins = routing_flips(torch, calls["kernels"], calls["plain"],
                                   cfg.top_k)
    rows = sum(int(c[2].shape[0]) for c in calls["plain"])
    first = next((i for i, f in enumerate(flips) if f), None)
    hidden = [float((a[0] - b[0]).norm() / b[0].norm())
              for a, b in zip(calls["kernels"], calls["plain"])]
    step_hidden = [max(hidden[i:i + layers])
                   for i in range(0, len(hidden), layers)]
    log("  diagnosis, kernels vs plain: logits rel_err per step "
        + " ".join(f"{e:.1e}" for e in per_step))
    log("    router input rel_err, max over layers per step "
        + " ".join(f"{e:.1e}" for e in step_hidden))
    log("    router input rel_err per layer at step 0 "
        + " ".join(f"{e:.1e}" for e in hidden[:layers]))
    log(f"    plain path replaying the kernel run's experts: logits rel_err "
        f"{rel(results['replay'], results['kernels']):.3e} against the "
        f"kernels")
    flip_at = [(i // layers, i % layers, f) for i, f in enumerate(flips) if f]
    log(f"    top-{cfg.top_k} routing disagreements: {sum(flips)} of {rows} "
        f"routed rows (step, layer, rows): {flip_at}")
    if margins:
        mid = sorted(margins)[len(margins) // 2]
        log(f"    plain router margin p_k - p_k+1 on those rows: min "
            f"{min(margins):.2e}, median {mid:.2e}, max {max(margins):.2e}")
    if first is not None and first // layers > 0:
        s0 = first // layers
        early = rel(results["kernels"][:s0], results["plain"][:s0])
        log(f"    before the first disagreement (steps 0..{s0 - 1}): logits "
            f"rel_err {early:.3e}")
    for name in ("kernels", "plain"):
        f, _ = routing_flips(torch, calls[name], calls["plain_f32"],
                             cfg.top_k)
        log(f"  against the float32 plain run on the same weights: {name} "
            f"logits rel_err {rel(results[name], results['plain_f32']):.3e}, "
            f"routing disagreements {sum(f)} of {rows}")
    if rel_err > PATH_REL_TOL:
        raise AssertionError("the fleet's kernel path disagrees with the "
                             "plain path")


def path_check(torch, cfg, params) -> dict:
    """The runtime on the kernels against one on the plain versions, same
    parameters, bf16: a 64-token prefill chunk of two sequences, then 4
    decode steps. Returns the logits' relative errors, which the caller
    gates: ``free`` (each run routes by its own router), ``replayed`` (the
    plain run takes the kernel run's expert choices and weighs them with
    its own router), and ``kernels_f32`` / ``plain_f32``, each run against
    a run of the same weights with float32 activations on the plain path
    (weights cast per call).

    Logged beside them: the top-k routing disagreements per MoE layer and
    the router inputs' relative error per MoE layer in the chunk."""
    from repro_torch.parallel.afd import AFDRuntime
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(1, cfg.vocab_size, (2, 68), generator=gen,
                           device="cuda", dtype=torch.int32)
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def run(runtime, calls, replay=None):
        with recording_routes(calls, replay):
            caches, pos = runtime.init_cache(2, 128)
            lg, caches, pos = runtime.prefill(tokens[:, :64], caches, pos)
            steps = [lg]
            for j in range(64, 68):
                out, caches, pos = runtime.decode_step(tokens[:, j], caches,
                                                       pos)
                steps.append(out[:, None])
        return torch.cat(steps, dim=1).float()
    calls = {name: [] for name in ("kernels", "plain", "replay", "f32")}
    got = run(AFDRuntime(cfg, params), calls["kernels"])
    want = run(AFDRuntime(cfg, params, impl="plain"), calls["plain"])
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite logits")
    rel = float((got - want).norm() / want.norm())
    worst = float((got - want).abs().max())
    pick_k, pick_p = got.argmax(-1), want.argmax(-1)
    top1 = float((pick_k == pick_p).float().mean())
    # plain-logit gap between the two picks where they differ
    gap = (want.gather(-1, pick_p[..., None])
           - want.gather(-1, pick_k[..., None])).max()
    log(f"  logits {tuple(got.shape)}: rel_err {rel:.3e} (free routing),"
        f" max_abs_err {worst:.3e}, |plain| max "
        f"{float(want.abs().max()):.3e}; greedy agreement {top1:.4f}, "
        f"largest plain-logit gap between differing picks {float(gap):.3e}")

    replayed = run(AFDRuntime(cfg, params, impl="plain"), calls["replay"],
                   replay=calls["kernels"])
    ref = run(AFDRuntime(cfg32, params, impl="plain"), calls["f32"])
    moe = sum(1 for sp in cfg.layer_plan().flat() if sp.moe)
    rows = sum(int(c[2].shape[0]) for c in calls["plain"])

    def rel_to(a, b):
        return float((a - b).norm() / b.norm())
    flips, _ = routing_flips(torch, calls["kernels"], calls["plain"],
                             cfg.top_k)
    per_layer = [sum(flips[i::moe]) for i in range(moe)]
    chunk_in = [rel_to(a[0], b[0]) for a, b in
                zip(calls["kernels"][:moe], calls["plain"][:moe])]
    replay_in = [rel_to(a[0], b[0]) for a, b in
                 zip(calls["replay"][:moe], calls["kernels"][:moe])]
    log(f"  diagnosis: top-{cfg.top_k} routing disagreements kernels vs "
        f"plain {sum(flips)} of {rows} routed rows, per MoE layer "
        f"{per_layer}; router input rel_err per MoE layer in the chunk "
        + " ".join(f"{e:.1e}" for e in chunk_in))
    log(f"    plain path replaying the kernel run's experts: logits rel_err "
        f"{rel_to(replayed, got):.3e} against the kernels; router input "
        f"rel_err per MoE layer in the chunk "
        + " ".join(f"{e:.1e}" for e in replay_in))
    out = {"free": rel, "replayed": rel_to(replayed, got)}
    for name, x in (("kernels", got), ("plain", want)):
        f, _ = routing_flips(torch, calls[name], calls["f32"], cfg.top_k)
        out[f"{name}_f32"] = rel_to(x, ref)
        log(f"    against float32 activations on the same weights: {name} "
            f"logits rel_err {out[f'{name}_f32']:.3e}, routing disagreements "
            f"{sum(f)} of {rows}")
    return out


def calibration(torch, cfg, params, card):
    """Phase 8: the port's calibration body (``provision.calibrate``) on
    the full-width model, with the JAX package's engine shape and virtual
    clock, priced on the H800 plan as ``calibrate()`` does. Returns the
    report (phase 14c derates verdicts by its scale)."""
    from repro_torch.api.registry import (resolve_hardware,
                                          spec_from_arch_config)
    from repro_torch.core.planner import plan_afd
    from repro_torch.kernels import ops
    from repro_torch.parallel.afd import AFDRuntime
    from repro_torch.provision.calibrate import _calibrate
    rt = AFDRuntime(cfg, params)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = _calibrate(rt, cfg.name, "poisson-burst", 0, 10, "H800", 2000)
    rt.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"  {card}: {wall:.2f} s wall; launches {launches}")
    log("  calibration_report " + json.dumps(rep.to_obj()))
    # legacy prefill: every engine step, prompt token or decode micro-batch,
    # is one split-KV launch per attention layer and a GEMM pair per MoE
    # layer; flash is off this path
    attn = sum(1 for sp in rt.specs if sp.kind == "attn")
    moe = sum(1 for sp in rt.specs if sp.moe)
    steps = launches["splitkv_attention"] // attn
    expected = {"grouped_gemm": 2 * moe * steps, "grouped_gemm_int8": 0,
                "grouped_gemm_int4": 0, "flash_prefill": 0,
                "splitkv_attention": attn * steps}
    if steps <= 0 or launches != expected:
        raise AssertionError(f"calibration launches {launches} != "
                             f"{expected}")
    plan = plan_afd(spec_from_arch_config(cfg), resolve_hardware("H800"))
    if rep.windows != CALIB_WINDOWS:
        raise AssertionError(f"calibration saw {rep.windows} busy windows, "
                             f"not {CALIB_WINDOWS}")
    if rep.hfu_predicted != plan.hfu:
        raise AssertionError(f"hfu_predicted {rep.hfu_predicted} != the "
                             f"planner's {plan.hfu}")
    if not 0 < rep.scale <= 1:
        raise AssertionError(f"scale {rep.scale} outside (0, 1]")
    if (rep.t_budget_effective
            != rep.t_budget_analytic * rep.b_rank_utilization):
        raise AssertionError("t_budget_effective != t_budget_analytic x "
                             "b_rank_utilization")
    return rep


def jamba_serve(torch, card) -> None:
    """Phase 9: jamba-v0.1-52b at full width, 16 layers, bf16, random
    weights from seed 0, through ``AFDRuntime`` + ``AFDServeEngine`` (2
    micro-batches of 4 slots, a 512-slot cache, 64-token chunked prefill,
    wall clock) on an 8-request seeded trace; then its kernel path against
    the plain path on the same parameters."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_bytes, tree_count
    from repro_torch.models.params import init_params
    from repro_torch.parallel.afd import AFDRuntime, AFDStats
    from repro_torch.serving.afd_engine import AFDServeEngine
    from repro_torch.serving.workload import (LengthDist, Phase,
                                              TrafficProfile, generate_trace)
    cfg = jamba_cfg()
    specs = cfg.layer_plan().flat()
    _free(torch)
    log(f"  allocated before the model: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params, n_bytes = tree_count(params), tree_bytes(params)
    log(f"  {cfg.n_layers} layers ({sum(sp.kind == 'attn' for sp in specs)} "
        f"attention, {sum(sp.kind == 'mamba' for sp in specs)} Mamba; "
        f"{sum(sp.moe for sp in specs)} MoE), {n_params / 1e9:.3f} B "
        f"parameters (param_count {cfg.param_count() / 1e9:.3f} B: it "
        f"omits the Mamba layers' dense FFNs), {n_bytes / 1e9:.2f} GB, "
        f"built in "
        f"{time.perf_counter() - t0:.1f} s; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rt = AFDRuntime(cfg, params)
    caches, pos = rt.init_cache(1, 64)
    rt.prefill(torch.ones((1, 8), dtype=torch.int32, device="cuda"),
               caches, pos)
    rt.synchronize()
    rt.stats = AFDStats()
    profile = TrafficProfile(
        name="chip-jamba", phases=(Phase(2.0, 4.0),),
        prompt_len=LengthDist(16, 256), output_len=LengthDist(8, 32))
    trace = generate_trace(profile, seed=1, max_requests=8)
    lens = [e.prompt_len for e in trace]
    if not (min(lens) < 128 and any(n % 64 for n in lens)):
        raise AssertionError(f"trace prompts {lens} miss a short or an "
                             "uneven prompt")
    eng = AFDServeEngine(rt, max_len=JAMBA_MAX_LEN, n_bo=2,
                         mb_slots=JAMBA_MB_SLOTS, prefill_chunk=64,
                         tick_seconds=None)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(trace, max_ticks=20_000)
    rt.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    s = eng.summary()
    log(f"  {card}: {s['completed']}/{len(trace)} completed (prompts {lens}),"
        f" {s['tokens_out']} tokens in {wall:.2f} s wall "
        f"({s['tokens_out'] / wall:.1f} tokens/s), decode_ticks "
        f"{s['decode_ticks']}, engine_ticks {s['engine_ticks']}, prefill "
        f"chunks {s['prefill_chunks']}, {len(eng.windows)} windows")
    log(f"  TTFT p50 {s['ttft_p50']:.4f} s, p95 {s['ttft_p95']:.4f} s; "
        f"mean TPOT {s['tpot_mean']:.4f} s; bytes_match_all "
        f"{s['bytes_match_all']} (dispatch {s['dispatch_bytes']} B, combine "
        f"{s['combine_bytes']} B); slot bytes {eng.kv_slot_bytes}")
    log(f"  launches: {launches}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("  jamba_summary " + json.dumps({**s, "wall_s": wall,
                                        "launches": launches},
                                       default=float))
    if s["completed"] != len(trace):
        raise AssertionError(f"Jamba: only {s['completed']}/{len(trace)} "
                             "requests completed")
    if not all(w.bytes_match for w in eng.windows):
        raise AssertionError("Jamba: measured M2N bytes diverged from "
                             "Eq. 9/17")
    check_path_launches(launches, s, specs, eng.n_bo)
    # where a tick's wall clock goes: one 64-token chunk of one sequence
    # (the 14 Mamba layers step it token by token) and one decode rotation
    # of both micro-batches, each timed alone (median of 3, synchronised)
    chunk = torch.ones((1, 64), dtype=torch.int32, device="cuda")
    mbs = [rt.init_cache(JAMBA_MB_SLOTS, JAMBA_MAX_LEN) for _ in range(2)]
    feed = torch.ones(JAMBA_MB_SLOTS, dtype=torch.int32, device="cuda")
    timed = {"chunk": lambda: rt.prefill(chunk, *rt.init_cache(
                 1, JAMBA_MAX_LEN)),
             "decode": lambda: rt.decode_step_3bo(
                 [(feed, c, p) for c, p in mbs], n_bo=2)}
    for name, fn in timed.items():
        walls = []
        for _ in range(3):
            rt.synchronize()
            t0 = time.perf_counter()
            fn()
            rt.synchronize()
            walls.append(time.perf_counter() - t0)
        log(f"  one {name} step alone: {sorted(walls)[1] * 1e3:.1f} ms wall")
    del eng, rt, caches, mbs
    # Any two bf16 runs of this random-weight hybrid stack drift apart
    # (the JAX reference's bf16 run differs from its own float32 run by
    # ~1e-1 at smoke width, tests/test_torch_mamba.py), and a flipped
    # top-2 choice swaps half a token's MoE output. So the free-routing
    # error is logged, and the gate replays the kernel run's expert
    # choices on the plain path; the kernel path must also stay as close
    # to float32 activations as the plain path is.
    err = path_check(torch, cfg, params)
    log(f"  gates: replayed-routing rel_err {err['replayed']:.3e} ≤ "
        f"{PATH_REL_TOL}; against float32 activations, kernels "
        f"{err['kernels_f32']:.3e} ≤ {JAMBA_F32_RATIO} x plain "
        f"{err['plain_f32']:.3e}")
    if err["replayed"] > PATH_REL_TOL:
        raise AssertionError("Jamba's kernel path disagrees with the plain "
                             "path under the same routing")
    if err["kernels_f32"] > JAMBA_F32_RATIO * err["plain_f32"]:
        raise AssertionError("Jamba's kernel path is farther from float32 "
                             "activations than the plain path")
    log(f"  peak allocated over phase 9: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


# ---------------------------------------------------------------------------
# Phases 10 and 11: the single-program model
# ---------------------------------------------------------------------------

def path_lengths(torch, b, hkv, d, t, reached):
    """Split-KV lengths to check a path at: every length it reaches, 1,
    T - 1, T, T + 7 (a dead slot runs past the cache), and each split
    boundary ±1 of the bf16 and f32 split plans at (B, Hkv, T); cut into
    lists of B (the last padded with reached lengths)."""
    from repro_torch.kernels import splitkv_attention as skv
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    marks = {1, t - 1, t, t + 7, *reached}
    for elem in (2, 4):
        split, n = skv.plan_splits(b, hkv, t, n_sm, skv.max_split(d, elem))
        marks |= {j * split + e for j in range(1, n) for e in (-1, 0, 1)}
    marks = sorted(marks)
    marks += list(reached)[:-len(marks) % b]
    return [marks[i:i + b] for i in range(0, len(marks), b)]


def splitkv_model_shapes(torch, timer, gen):
    """Split-KV at the single-program paths' own shapes (phases 10-11)
    against its plain version, each at every length its path reaches and
    at its split plan's boundaries, timed at reached lengths:
    ``MODEL_SPLITKV``. Returns the bf16 rows, logged as one JSON line."""
    rows = {}
    for name, heads, b, t, reached in MODEL_SPLITKV:
        timed = [reached[round(i * (len(reached) - 1) / (b - 1))]
                 for i in range(b)]
        rows[name], _ = splitkv_row(
            torch, timer, gen, name, heads, t,
            path_lengths(torch, b, heads[1], heads[2], t, reached), timed)
    log("  model_shape_kernels " + json.dumps(rows))
    return rows


def model_path_check(torch, cfg, params, batch, steps: int, max_len: int,
                     replay: bool = False) -> dict:
    """``Model`` on the kernels against ``Model(impl="plain")`` on the same
    parameters: ``prefill`` of ``batch`` and ``steps`` teacher-forced decode
    steps of seeded tokens. Returns the logits' relative error ``free``
    (each run routes by its own router) and, with ``replay``, ``replayed``
    (the plain run takes the kernel run's expert choices, weighed by its
    own router), with the routing disagreements logged; and ``launches``,
    the kernel run's counts (the plain run launches nothing)."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import make_model
    b = batch["tokens"].shape[0]
    feed = torch.randint(1, cfg.vocab_size, (b, steps), generator=seeded(
        torch, 11), device="cuda", dtype=torch.int32)

    def run(impl, calls, replay_calls=None):
        model = make_model(cfg, impl=impl)
        with recording_routes(calls, replay_calls):
            lg, cache = model.prefill(params, batch, max_len)
            out = [lg]
            for j in range(steps):
                lg, cache = model.decode_step(params, cache, feed[:, j])
                out.append(lg)
        return torch.stack(out, dim=1).float()
    calls = {name: [] for name in ("kernels", "plain", "replay")}
    ops.reset_launch_counts()
    got = run(None, calls["kernels"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = run("plain", calls["plain"])
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")

    def rel(a, c):
        return float((a - c).norm() / c.norm())
    out = {"free": rel(got, want), "launches": launches}
    log(f"  {cfg.name} path check: logits {tuple(got.shape)} (prefill of "
        f"{tuple(batch['tokens'].shape)} tokens + {steps} decode steps), "
        f"kernels vs plain rel_err {out['free']:.3e}, max_abs_err "
        f"{float((got - want).abs().max()):.3e}; kernel run's launches "
        f"{launches}")
    if replay:
        flips, _ = routing_flips(torch, calls["kernels"], calls["plain"],
                                 cfg.top_k)
        rows = sum(int(c[2].shape[0]) for c in calls["plain"])
        out["replayed"] = rel(run("plain", calls["replay"],
                                  calls["kernels"]), got)
        log(f"    top-{cfg.top_k} routing disagreements kernels vs plain "
            f"{sum(flips)} of {rows} routed rows; plain path replaying the "
            f"kernel run's experts: rel_err {out['replayed']:.3e}")
    return out


def ep_serve(torch, card) -> dict:
    """Phase 10: ``repro_torch.launch.serve`` in EP mode (the single-program
    ``DecodeEngine``) at full width and depth on granite-moe-1b-a400m,
    bf16, seed-0 weights (phase 4's numbers); then ``Model`` on the kernels
    against the plain versions on 8 of its prompts. Returns the serve's
    launches and each request's tokens (phase 13 serves it again)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    ops.reset_launch_counts()
    out = serve_mod.run(EP_ARGV)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    eng, wall = out["engine"], out["wall_s"]
    st, d = eng.stats, out["decision"]
    done = sum(r.done for r in out["requests"])
    log(f"  {card}: {done}/{EP_REQUESTS} requests complete, "
        f"{st.tokens_out} tokens, {st.prefills} prefills, {st.ticks} ticks, "
        f"requeued {st.requeued} in {wall:.2f} s wall "
        f"({st.throughput(wall):.1f} tokens/s); scheduler σ̂ {d.sigma:.3f} "
        f"α_ep {d.alpha:.3f} straggler_rate {d.straggler_rate:.2f}")
    log(f"  launches: {launches}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("  ep_summary " + json.dumps({
        **dataclasses.asdict(st), "wall_s": wall, "launches": launches,
        "tokens_per_s": st.throughput(wall), "sigma": d.sigma,
        "alpha": d.alpha, "straggler_rate": d.straggler_rate}))
    layers = eng.cfg.n_layers
    expected = {"grouped_gemm": 2 * layers * st.ticks,
                "grouped_gemm_int8": 0, "grouped_gemm_int4": 0,
                "flash_prefill": 0, "splitkv_attention": layers * st.ticks}
    if done != EP_REQUESTS or st.prefills != EP_REQUESTS + st.requeued:
        raise AssertionError(f"EP serve: {done}/{EP_REQUESTS} complete, "
                             f"{st.prefills} prefills, {st.requeued} "
                             "requeued")
    if launches != expected:
        raise AssertionError(f"EP launches {launches} != {expected}")
    cfg, params = eng.cfg, eng.params
    prompts = torch.stack([torch.as_tensor(r.prompt) for r in
                           out["requests"][:8]]).to("cuda")
    outputs = [list(r.output) for r in out["requests"]]
    del eng, out
    err = model_path_check(torch, cfg, params, {"tokens": prompts}, 16, 512,
                           replay=True)
    log(f"  gate: replayed-routing rel_err {err['replayed']:.3e} ≤ "
        f"{PATH_REL_TOL} (free routing {err['free']:.3e}, logged)")
    if err["replayed"] > PATH_REL_TOL:
        raise AssertionError("the single-program kernel path disagrees with "
                             "the plain path under the same routing")
    return {"launches": launches, "outputs": outputs}


def _fresh(torch, cfg):
    """Seed-0 weights of ``cfg`` on the card, after freeing the previous
    model; logs the tree's size and ``param_count``'s."""
    from repro_torch.models.common import tree_bytes, tree_count
    from repro_torch.models.model import make_model
    _free(torch)
    t0 = time.perf_counter()
    params = make_model(cfg).init(0)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers, {tree_count(params) / 1e9:.3f}"
        f" B parameters (param_count {cfg.param_count() / 1e9:.3f} B), "
        f"{tree_bytes(params) / 1e9:.2f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def _attn_layers(cfg) -> int:
    return sum(1 for sp in cfg.layer_plan().flat() if sp.kind == "attn")


def check_model_launches(cfg, launches, steps: int) -> None:
    """A decode step launches split-KV once per attention layer; prefill
    and dense FFNs launch nothing."""
    expected = {"grouped_gemm": 0, "grouped_gemm_int8": 0,
                "grouped_gemm_int4": 0, "flash_prefill": 0,
                "splitkv_attention": _attn_layers(cfg) * steps}
    if launches != expected:
        raise AssertionError(f"{cfg.name}: launches {launches} != "
                             f"{expected}")


def qwen3_serve(torch, card) -> dict:
    """qwen3-8b at full width through ``DecodeEngine``: 8 requests of 256
    prompt tokens and 32 new tokens on 4 slots; then the path check on 4
    sequences and 16 decode steps."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.model import make_model
    from repro_torch.serving.engine import DecodeEngine, Request
    import numpy as np
    cfg = configs.get_config("qwen3-8b")
    params = _fresh(torch, cfg)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size, 256).astype(
        np.int32), max_new_tokens=32) for i in range(8)]
    eng = DecodeEngine(make_model(cfg), params, n_slots=4, max_len=512)
    for r in reqs:
        eng.submit(r)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = eng.stats
    log(f"  {card}: {sum(r.done for r in reqs)}/8 requests complete, "
        f"{st.tokens_out} tokens, {st.prefills} prefills, {st.ticks} ticks "
        f"in {wall:.2f} s wall ({st.throughput(wall):.1f} tokens/s); "
        f"launches {launches}")
    if not all(r.done for r in reqs) or st.prefills != 8:
        raise AssertionError("qwen3-8b: a request did not complete")
    check_model_launches(cfg, launches, st.ticks)
    prompts = torch.stack([torch.as_tensor(r.prompt) for r in reqs[:4]])
    del eng
    err = model_path_check(torch, cfg, params, {"tokens": prompts.cuda()},
                           16, 512)
    check_model_launches(cfg, err["launches"], 16)
    log(f"  gate: rel_err {err['free']:.3e} ≤ {PATH_REL_TOL}")
    if err["free"] > PATH_REL_TOL:
        raise AssertionError("qwen3-8b: kernel path disagrees with the "
                             "plain path")
    return {"wall_s": wall, "ticks": st.ticks, "tokens": st.tokens_out,
            "launches": launches, "rel_err": err["free"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def mamba2_chunk_vs_steps(torch, card) -> dict:
    """mamba2-2.7b at full width: ``Model.prefill`` of one 256-token prompt
    (one SSD chunk per layer) against 256 ``decode_step`` calls from an
    empty cache, each wall synchronised, with bf16 activations and again
    with float32 activations on the same bf16 weights; float32 gated at
    ``MAMBA_F32_TOL``. Then bf16 on the first ``MAMBA_BF16_LAYERS`` layers
    over ``MAMBA_BF16_TOKENS`` tokens, gated at ``MAMBA_BF16_TOL``, beside
    a control whose stepped run rounds its SSM state to float8 (e4m3)
    after every step (logged)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.model import make_model
    cfg = configs.get_config("mamba2-2.7b")
    params = _fresh(torch, cfg)
    toks = torch.randint(1, cfg.vocab_size, (1, 256), generator=seeded(
        torch, 12), device="cuda", dtype=torch.int32)

    def chunk_and_steps(model, weights, tokens, state_dtype=None):
        s = tokens.shape[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk, _ = model.prefill(weights, {"tokens": tokens}, s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = model.init_cache(1, s)
        for j in range(s):
            step, cache = model.decode_step(weights, cache, tokens[:, j])
            if state_dtype is not None:
                for lc in cache["layers"]:
                    lc["state"] = lc["state"].to(state_dtype).float()
        torch.cuda.synchronize()
        if not (torch.isfinite(chunk).all() and torch.isfinite(step).all()):
            raise AssertionError(f"{model.cfg.name}: non-finite logits")
        return (chunk.float(), step.float(),
                ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    logits, walls = {}, {}
    ops.reset_launch_counts()
    for dt in ("bfloat16", "float32"):
        model = make_model(dataclasses.replace(cfg, dtype=dt))
        model.prefill(params, {"tokens": toks[:, :8]}, 256)   # warm-up
        *logits[dt], walls[dt] = chunk_and_steps(model, params, toks)
    cut = make_model(dataclasses.replace(cfg, n_layers=MAMBA_BF16_LAYERS))
    cut_params = {**params, "layers": params["layers"][:MAMBA_BF16_LAYERS]}
    short = toks[:, :MAMBA_BF16_TOKENS]
    cut_chunk, cut_step, _ = chunk_and_steps(cut, cut_params, short)
    _, fp8_step, _ = chunk_and_steps(cut, cut_params, short,
                                     torch.float8_e4m3fn)
    launches = ops.launch_counts()
    err = {"f32": rel(*logits["float32"]), "bf16": rel(*logits["bfloat16"]),
           "drift": rel(logits["bfloat16"][1], logits["float32"][1]),
           "prefill_drift": rel(logits["bfloat16"][0], logits["float32"][0]),
           "bf16_cut": rel(cut_chunk, cut_step),
           "fp8_state_cut": rel(cut_chunk, fp8_step)}
    for dt, (t_chunk, t_steps) in walls.items():
        log(f"  {card}, {dt} activations: 256-token prefill (chunked SSD) "
            f"{t_chunk:.1f} ms wall, 256 decode steps {t_steps:.1f} ms wall "
            f"({t_steps / t_chunk:.1f}x)")
    log(f"  last-position logits, prefill vs steps, 64 layers: float32 "
        f"{err['f32']:.3e} (≤ {MAMBA_F32_TOL}); bf16 {err['bf16']:.3e} "
        f"(logged; bf16 vs float32: steps {err['drift']:.3e}, prefill "
        f"{err['prefill_drift']:.3e})")
    log(f"  first {MAMBA_BF16_LAYERS} layers, {MAMBA_BF16_TOKENS} tokens, "
        f"bf16: {err['bf16_cut']:.3e} (≤ {MAMBA_BF16_TOL}); control with "
        f"the stepped state in float8 e4m3 {err['fp8_state_cut']:.3e} "
        f"(logged); launches {launches}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if err["f32"] > MAMBA_F32_TOL:
        raise AssertionError("mamba2: chunked SSD prefill and stepped decode "
                             "disagree in float32")
    if err["bf16_cut"] > MAMBA_BF16_TOL:
        raise AssertionError("mamba2: chunked prefill and stepped decode "
                             "disagree in bf16 beyond the drift bound")
    check_model_launches(cfg, launches, 0)
    return {"prefill_ms": walls["bfloat16"][0],
            "steps_ms": walls["bfloat16"][1],
            "f32_prefill_ms": walls["float32"][0],
            "f32_steps_ms": walls["float32"][1], **err,
            "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def frontend_model(torch, card, arch: str) -> dict:
    """whisper-small (the encoder over 1,500 stub frames, cross-attention,
    learned positions) or internvl2-2b (256 stub patch embeddings
    prefixed) at full width: ``Model`` on the kernels against the plain
    versions, 4 sequences of 32 prompt tokens and 16 decode steps."""
    from repro_torch import configs
    cfg = configs.get_config(arch)
    params = _fresh(torch, cfg)
    gen = seeded(torch, 13)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (4, 32),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((4, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device="cuda").to(
                                          cfg.compute_dtype)
    if cfg.vision_seq:
        batch["patch_embeds"] = (0.02 * torch.randn(
            (4, cfg.vision_seq, cfg.d_model), generator=gen,
            device="cuda")).to(cfg.compute_dtype)
    t0 = time.perf_counter()
    err = model_path_check(torch, cfg, params, batch, 16,
                           cfg.vision_seq + 64)
    wall = time.perf_counter() - t0
    log(f"  {card}: both runs in {wall:.2f} s wall; gate rel_err "
        f"{err['free']:.3e} ≤ {PATH_REL_TOL}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_model_launches(cfg, err["launches"], 16)
    if err["free"] > PATH_REL_TOL:
        raise AssertionError(f"{arch}: kernel path disagrees with the plain "
                             "path")
    return {"rel_err": err["free"], "launches": err["launches"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def families(torch, card) -> dict:
    """Phase 11: the other families at full width through ``Model``, one
    model at a time, each freed before the next."""
    out = {"qwen3-8b": qwen3_serve(torch, card),
           "mamba2-2.7b": mamba2_chunk_vs_steps(torch, card)}
    for arch in ("whisper-small", "internvl2-2b"):
        out[arch] = frontend_model(torch, card, arch)
    log("  families_summary " + json.dumps(out))
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 12: training and MTP
# ---------------------------------------------------------------------------

def _check_finite(name, values) -> None:
    bad = [v for v in values if not math.isfinite(v)]
    if bad or not values:
        raise AssertionError(f"{name}: not finite: {bad or 'no values'}")


def train_driver(torch, card) -> dict:
    """12a: ``launch.train`` (``python -m repro_torch train``) at full
    width, 12 steps with a checkpoint every 6 into a temporary directory,
    then the same command to 18 steps, which must resume at 12."""
    import io
    import tempfile
    from repro_torch.launch import train
    from repro_torch.models.common import tree_bytes, tree_count
    from repro_torch.training.checkpoint import list_steps
    runs = []
    with tempfile.TemporaryDirectory() as d:
        for steps in (12, 18):
            _free(torch)
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    r = train.run(TRAIN_ARGV + ["--steps", str(steps),
                                                "--ckpt-dir", d])
            finally:
                for line in buf.getvalue().splitlines():
                    log(f"    | {line}")
            r.update(stdout=buf.getvalue(),
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                     n_params=tree_count(r["params"]),
                     param_gb=tree_bytes(r["params"]) / 1e9,
                     opt_gb=tree_bytes(r["opt_state"]) / 1e9)
            del r["params"], r["opt_state"]
            runs.append(r)
        kept = list_steps(d)
        ckpt_gb = sum(os.path.getsize(os.path.join(d, f"step_{kept[-1]:09d}",
                                                    f))
                      for f in os.listdir(os.path.join(
                          d, f"step_{kept[-1]:09d}"))) / 1e9
    first, second = runs
    for r in runs:
        _check_finite("driver losses", r["losses"])
        _check_finite("driver grad norms", r["grad_norms"])
    if ("done: 12 steps" not in first["stdout"] or "resumed" in
            first["stdout"] or "resumed from step 12" not in second["stdout"]
            or "done: 6 steps" not in second["stdout"] or kept != [6, 12, 18]):
        raise AssertionError(f"driver: resume failed (checkpoints {kept})")
    tokens = 8 * 128
    wall = statistics.median(first["step_walls"][3:])
    out = {"step_wall_s": wall, "tokens_per_s": tokens / wall,
           "rerun_step_wall_s": statistics.median(second["step_walls"][3:]),
           "first_step_s": first["step_walls"][0],
           "run_walls_s": [first["wall_s"], second["wall_s"]],
           "peak_gb": [first["peak_gb"], second["peak_gb"]],
           "n_params": first["n_params"], "param_gb": first["param_gb"],
           "opt_state_gb": first["opt_gb"], "checkpoint_gb": ckpt_gb,
           "losses": first["losses"] + second["losses"],
           "grad_norms": first["grad_norms"] + second["grad_norms"]}
    log(f"  {card}: {out['n_params'] / 1e9:.3f} B parameters "
        f"({out['param_gb']:.2f} GB), AdamW state {out['opt_state_gb']:.2f} "
        f"GB, a checkpoint {ckpt_gb:.2f} GB on disk; step wall (median of "
        f"steps 4-12) {wall * 1e3:.1f} ms = {out['tokens_per_s']:.0f} "
        f"tokens/s, steps 16-18 after the resume "
        f"{out['rerun_step_wall_s'] * 1e3:.1f} ms, first step "
        f"{out['first_step_s']:.2f} s; runs {first['wall_s']:.1f} / "
        f"{second['wall_s']:.1f} s with checkpoints; peak allocated "
        f"{first['peak_gb']:.2f} / {second['peak_gb']:.2f} GB")
    return out


def train_learns(torch, card, cfg) -> dict:
    """12b: LEARN_STEPS AdamW steps (lr LEARN_LR) on one fixed 8 x 128
    batch of the markov stream; the loss must fall by LEARN_DROP nats."""
    from repro_torch.models.model import make_model
    from repro_torch.training import data, optimizer
    from repro_torch.training.train import make_train_step
    _free(torch)
    model = make_model(cfg)
    params = model.init(0)
    opt = optimizer.adamw(lr=LEARN_LR)
    state = opt.init(params)
    batch = data.make_batch(data.DataConfig(8, 128, cfg.vocab_size), 0, cfg,
                            "cuda")
    step = make_train_step(model, opt)
    losses = []
    for _ in range(LEARN_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    _check_finite("fixed-batch losses", losses)
    drop = losses[0] - losses[-1]
    log(f"  {card}: fixed-batch loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(drop {drop:.4f} nats ≥ {LEARN_DROP}); every step: "
        + " ".join(f"{x:.3f}" for x in losses))
    if drop < LEARN_DROP:
        raise AssertionError(f"the loss fell {drop:.4f} nats in "
                             f"{LEARN_STEPS} steps on one batch")
    return {"loss_first": losses[0], "loss_last": losses[-1], "drop": drop}


def train_grads_vs_cpu(torch, card, cfg) -> dict:
    """12c: the full-width model cut to 2 layers, float32, TF32 off: one
    backward on 2 x 64 tokens on the card and on the CPU from the same
    weights; every leaf within TRAIN_GRAD_RTOL."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import make_model
    from repro_torch.training import data
    from repro_torch.training.checkpoint import _named
    from repro_torch.training.train import loss_and_grads
    _free(torch)
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               param_dtype="float32")
    cpu = make_model(cfg2, device="cpu")
    params = cpu.init(0)
    batch = data.make_batch(data.DataConfig(2, 64, cfg.vocab_size), 0, cfg2,
                            "cpu")
    t0 = time.perf_counter()
    loss_cpu, _, g_cpu = loss_and_grads(cpu, params, batch)
    t_cpu = time.perf_counter() - t0
    loss_gpu, _, g_gpu = loss_and_grads(
        make_model(cfg2), tree_map(lambda t: t.cuda(), params),
        {k: v.cuda() for k, v in batch.items()})
    want = dict(_named(g_cpu))
    errs = {}
    for name, g in _named(g_gpu):
        g = g.cpu().double()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"card gradient {name} is not finite")
        w = want[name].double()
        errs[name] = float((g - w).norm() / w.norm().clamp(min=1e-12))
    worst = sorted(errs, key=errs.get, reverse=True)[:3]
    log(f"  {card}: loss card {float(loss_gpu):.6f} / CPU "
        f"{float(loss_cpu):.6f} ({t_cpu:.1f} s on the CPU); {len(errs)} "
        "leaves, worst relative error " + ", ".join(
            f"{n} {errs[n]:.3e}" for n in worst)
        + f" ≤ {TRAIN_GRAD_RTOL}")
    if len(errs) != len(want) or errs[worst[0]] > TRAIN_GRAD_RTOL:
        raise AssertionError("card gradients disagree with the CPU's")
    return {"worst_leaf": worst[0], "worst_rel_err": errs[worst[0]]}


def _bits(torch, t):
    """A tensor's bits as integers: bitwise equality, NaN payloads too."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _bit_differences(torch, a, b) -> list:
    """Per leaf whose bits differ: (path, differing elements, max |a - b|
    over finite pairs, non-finite elements in a, in b)."""
    from repro_torch.training.checkpoint import _named
    out = []
    for (name, x), (_, y) in zip(_named(a), _named(b)):
        bx, by = _bits(torch, x), _bits(torch, y)
        if x.dtype == y.dtype and torch.equal(bx, by):
            continue
        d = (x.float() - y.float()).abs()
        d = d[d.isfinite()]
        out.append((name, int((bx != by).sum()),
                    float(d.max()) if d.numel() else float("nan"),
                    int((~x.isfinite()).sum()), int((~y.isfinite()).sum())))
    return out


def train_restart_and_remat(torch, card, cfg) -> dict:
    """12d and 12e, with deterministic algorithms on (bitwise checks):
    three steps, an ``AsyncCheckpointer`` save at step 3 (bf16 leaves),
    three more; restore and repeat them: params and AdamW state bit for
    bit. Then one backward with ``remat=True`` against one without on the
    same weights and batch: loss and gradients bit for bit, with both
    peaks logged; and the backward without remat once more, against
    itself. Every step's loss and each differing leaf are logged."""
    import tempfile
    from repro_torch.models.model import make_model
    from repro_torch.training import checkpoint, data, optimizer
    from repro_torch.training.train import loss_and_grads, make_train_step
    _free(torch)
    model = make_model(cfg)
    opt = optimizer.adamw(lr=LEARN_LR)
    dc = data.DataConfig(8, 128, cfg.vocab_size)
    batches = [data.make_batch(dc, i, cfg, "cuda") for i in range(6)]
    step = make_train_step(model, opt)
    losses = {"first": [], "A": [], "B": []}

    def run(p, s, bs, key):
        for b in bs:
            p, s, m = step(p, s, b)
            losses[key].append(float(m["loss"]))
        return p, s

    torch.use_deterministic_algorithms(True)
    try:
        p = model.init(0)
        p, s = run(p, opt.init(p), batches[:3], "first")
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            ck = checkpoint.AsyncCheckpointer(d)
            ck.save(3, p, s)
            t_copy = time.perf_counter() - t0
            ck.wait()
            t_save = time.perf_counter() - t0
            pa, sa = run(p, s, batches[3:], "A")
            del p, s
            t0 = time.perf_counter()
            _, pb, sb, _ = checkpoint.restore_latest(d, pa, sa)
            t_restore = time.perf_counter() - t0
        pb, sb = run(pb, sb, batches[3:], "B")
        restart_diff = _bit_differences(torch, (pa, sa), (pb, sb))
        del pb, sb, sa
        remat = make_model(dataclasses.replace(cfg, remat=True))
        runs = []
        for m in (model, remat, model):
            _free(torch)
            base = torch.cuda.memory_allocated()
            loss, _, grads = loss_and_grads(m, pa, batches[0])
            runs.append((loss, grads,
                         torch.cuda.max_memory_allocated() - base))
        (l0, g0, peak0), (l1, g1, peak1), (l2, g2, _) = runs
        remat_diff = _bit_differences(torch, (l0, g0), (l1, g1))
        repeat_diff = _bit_differences(torch, (l0, g0), (l2, g2))
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"  {card}: step losses {json.dumps(losses)}")
    log(f"  restart from an async checkpoint (host copy {t_copy:.1f} s, "
        f"written in {t_save:.1f} s, restored in {t_restore:.1f} s): params "
        f"and state bit-identical {not restart_diff}"
        + (f"; differing leaves {restart_diff[:8]}" if restart_diff else ""))
    log(f"  remat: loss and gradients bit-identical {not remat_diff}"
        + (f"; differing {remat_diff[:8]}" if remat_diff else "")
        + f"; the same backward twice: bit-identical {not repeat_diff}"
        + (f"; differing {repeat_diff[:8]}" if repeat_diff else "")
        + f"; one backward's peak above what was allocated before it: "
        f"{peak0 / 1e9:.2f} GB without, {peak1 / 1e9:.2f} GB with remat")
    if restart_diff or remat_diff:
        raise AssertionError(f"bitwise checks: restart {not restart_diff}, "
                             f"remat {not remat_diff}")
    return {"restart_bitwise": True, "remat_bitwise": True,
            "peak_gb_no_remat": peak0 / 1e9, "peak_gb_remat": peak1 / 1e9,
            "save_s": t_save, "restore_s": t_restore}


class _RecordingModel:
    """A ``Model`` whose ``forward`` keeps each call's tokens and logits:
    the MTP harness's target, so the script can find each rejection."""

    def __init__(self, model):
        self.model, self.device, self.calls = model, model.device, []

    def forward(self, params, batch, mode="train"):
        out = self.model.forward(params, batch, mode)
        self.calls.append((batch["tokens"][0].tolist(), out[0][0]))
        return out


def mtp_full_width(torch, card) -> dict:
    """12f: ``serving.mtp.speculative_generate`` on qwen1.5-0.5b at full
    width, float32 (TF32 off): the self-draft with k = 4 on a 32-token
    prompt for 16 tokens, where every rejection must sit at a near-tie of
    the target's logits; then a draft with 10% noise logged beside it."""
    from repro_torch import configs
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import make_model
    from repro_torch.serving import mtp
    _free(torch)
    cfg = dataclasses.replace(configs.get_config("qwen1.5-0.5b"),
                              dtype="float32", param_dtype="float32")
    model = make_model(cfg)
    params = model.init(0)
    gen = seeded(torch, 15)
    prompt = torch.randint(1, cfg.vocab_size, (32,), generator=gen,
                           device="cuda").tolist()
    k = 4
    target = _RecordingModel(model)
    t0 = time.perf_counter()
    toks, stats = mtp.speculative_generate(target, params, model, params,
                                           prompt, n_tokens=16, k_draft=k)
    wall = time.perf_counter() - t0
    rejections = []
    for tokens, logits in target.calls:
        base = len(tokens) - k
        for i, proposed in enumerate(tokens[base:]):
            row = logits[base - 1 + i]
            if int(torch.argmax(row)) != proposed:
                top2 = torch.topk(row, 2).values
                rejections.append({
                    "pos": base + i, "gap": float(top2[0] - top2[1]),
                    "scale": float(row.abs().max()),
                    "proposed_gap": float(row.max() - row[proposed])})
                break
    log(f"  {card}: self-draft {len(toks)} tokens in {stats.rounds} rounds "
        f"({wall:.2f} s): {dataclasses.asdict(stats)}, acceptance "
        f"{stats.acceptance_rate:.4f}, L_accept {stats.l_accept:.3f}; "
        f"rejections {rejections}")
    for r in rejections:
        if r["gap"] > MTP_GAP_TOL * r["scale"]:
            raise AssertionError(f"self-draft rejection off a near-tie: {r}")
    gen = seeded(torch, 16)
    noisy = tree_map(lambda t: t + 0.1 * t.square().mean().sqrt() * torch.randn(
        t.shape, generator=gen, device="cuda", dtype=t.dtype), params)
    _, nstats = mtp.speculative_generate(model, params, model, noisy, prompt,
                                         n_tokens=16, k_draft=k)
    log(f"  noisy draft (10% of each leaf's RMS): "
        f"{dataclasses.asdict(nstats)}, acceptance "
        f"{nstats.acceptance_rate:.4f}, L_accept {nstats.l_accept:.3f}, "
        "T = SLO x L_accept at a 50 ms SLO: "
        f"{mtp.effective_budget_relaxation(nstats, 0.05) * 1e3:.1f} ms")
    return {"self": dataclasses.asdict(stats), "rejections": rejections,
            "noisy": dataclasses.asdict(nstats)}


def training(torch, card) -> dict:
    """Phase 12: training and MTP at full width; the path runs no kernel
    (in both packages the train-mode forward is dense attention and the
    capacity MoE's einsums), so every launch count stays 0."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    cfg = configs.get_config("granite-moe-1b-a400m")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log("  12a: the training driver with a checkpoint resume")
    out = {"driver": train_driver(torch, card)}
    log(f"  12b: {LEARN_STEPS} steps on one fixed batch")
    out["learn"] = train_learns(torch, card, cfg)
    log("  12c: gradients on the card against the CPU (2 layers, float32)")
    out["grads_vs_cpu"] = train_grads_vs_cpu(torch, card, cfg)
    log("  12d-e: bitwise restart and remat (deterministic algorithms)")
    out["bitwise"] = train_restart_and_remat(torch, card, cfg)
    log("  12f: MTP on qwen1.5-0.5b at full width, float32")
    out["mtp"] = mtp_full_width(torch, card)
    launches = ops.launch_counts()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    log(f"  launches over phase 12: {launches}; phase {out['phase_s']:.1f} s")
    log("  training_summary " + json.dumps(
        {k: v for k, v in out.items() if k != "driver"}
        | {"driver": {k: v for k, v in out["driver"].items()
                      if k not in ("losses", "grad_norms")}}))
    if any(launches.values()):
        raise AssertionError(f"phase 12 launched kernels: {launches}")
    _free(torch)
    return out


# ---------------------------------------------------------------------------
# Phase 13: the expert-parallel layer under NCCL at world size 1
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def nccl_world1(torch):
    """One NCCL rank on the card (file rendezvous in a temporary
    directory) and its (1, 1) ("data", "model") mesh; CPU tensors take
    the group's gloo backend (13b's CPU reference). The group is
    destroyed on exit so that later phases are untouched."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("cpu:gloo,cuda:nccl",
                                init_method=f"file://{d}/rdv", rank=0,
                                world_size=1)
        try:
            yield init_device_mesh("cuda", (1, 1),
                                   mesh_dim_names=("data", "model"))
        finally:
            dist.destroy_process_group()


def _launches_of(torch, fn):
    """(result, kernel launches of ``fn``) with the counts reset just
    before and read just after."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def _moe_layer(torch, cfg, gen, dtype):
    """Random routed-expert weights of one MoE layer (router float32,
    experts in ``dtype``), scaled by 1/sqrt(fan-in)."""
    d, e, m = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def normal(shape, fan_in, dt):
        w = torch.randn(shape, generator=gen, device="cuda", dtype=dt)
        return w.mul_(fan_in ** -0.5)
    return {"router": normal((d, e), d, torch.float32),
            "wi": normal((e, d, 2 * m), d, dtype),
            "wo": normal((e, m, d), m, dtype)}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def ep_expert_blocks(torch, cfg, gen, n_blocks: int = 4) -> dict:
    """13a, the block mode that EP decode over several ranks and the F
    role over N_F blocks run: ``moe.expert_ffn`` over each of 4 blocks of
    granite's 32 experts (``first_expert`` j·8) at the decode (8 tokens,
    64 rows) and prefill-chunk (64 tokens, 512 rows) shapes, bf16 and
    f32. Each block on the kernels against its plain path (relative error
    ≤ EP_BF16_RTOL in bf16, 1e-5 in f32), the tokens with no pair in the
    block exactly 0, and the blocks' sum against the whole-expert call at
    the same tolerance. Phase 3 holds the two fused GEMMs of this mode
    row for row (``fused_block_rows``)."""
    from repro_torch.models import moe
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        c = dataclasses.replace(cfg, dtype=name, param_dtype=name)
        p = _moe_layer(torch, c, gen, dt)
        e_loc = c.n_experts // n_blocks
        tol = EP_BF16_RTOL if dt == torch.bfloat16 else 1e-5
        for label, tokens in (("decode", 8), ("prefill", 64)):
            x = torch.randn((tokens, c.d_model), generator=gen,
                            device="cuda").to(dt)
            _, topw, topi = moe.route(p, c, x)
            whole = moe.expert_ffn(c, p["wi"], p["wo"], x, topw, topi)
            total, worst, empty = torch.zeros_like(whole), 0.0, 0
            for j in range(n_blocks):
                blk = slice(j * e_loc, (j + 1) * e_loc)
                got, plain = (moe.expert_ffn(c, p["wi"][blk], p["wo"][blk],
                                             x, topw, topi, impl,
                                             first_expert=j * e_loc)
                              for impl in (None, "plain"))
                worst = max(worst, _rel(got, plain))
                away = ((topi < blk.start) | (topi >= blk.stop)).all(-1)
                empty += int(away.sum())
                if bool(got[away].any()):
                    raise AssertionError(f"expert block {j} {label} {name}: "
                                         "tokens routed elsewhere are not 0")
                total += got
            rel_sum = _rel(total, whole)
            log(f"  expert_ffn over {n_blocks} blocks of {e_loc} experts, "
                f"{label} ({tokens * c.top_k} rows) {name}: worst block "
                f"against its plain path rel_err {worst:.3e}, the blocks' "
                f"sum against the whole-expert call rel_err {rel_sum:.3e} "
                f"(≤ {tol}); {empty} token rows with no pair in their "
                "block exactly 0")
            if worst > tol or rel_sum > tol:
                raise AssertionError(f"expert blocks {label} {name} disagree")
            out[f"{label}_{name}"] = {"block_rel_err_plain": worst,
                                      "sum_rel_err_whole": rel_sum}
    return out


def ep_decode_granite(torch, mesh, cfg, gen) -> dict:
    """13a and 13c: ``moe_ep_decode`` and ``moe_ep_decode_etp`` on one
    full-width granite MoE layer (64 tokens) at world size 1, where the
    one rank holds every expert, against ``moe_sorted`` on the kernels
    (expected bit-identical: the wiring through the mesh adds nothing)
    and on the plain path (bf16: relative error ≤ EP_BF16_RTOL; f32
    ≤ 1e-5). ``ep_expert_blocks`` holds the block mode that more ranks
    run."""
    from repro_torch.models import moe
    from repro_torch.parallel import ep
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=str(dt).split(".")[-1],
                                param_dtype=str(dt).split(".")[-1])
        p = _moe_layer(torch, c, gen, dt)
        x = torch.randn((8, 8, c.d_model), generator=gen,
                        device="cuda").to(dt)
        epc = ep.EPConfig(mesh=mesh)
        for name, fn in (("moe_ep_decode", ep.moe_ep_decode),
                         ("moe_ep_decode_etp", ep.moe_ep_decode_etp)):
            cfg_e = dataclasses.replace(epc, etp=name.endswith("etp"))
            got, launches = _launches_of(torch, lambda: fn(p, c, x, cfg_e))
            kern = moe.moe_sorted(p, c, x)
            plain = moe.moe_sorted(p, c, x, impl="plain")
            same = bool(torch.equal(got, kern))
            rel = _rel(got, plain)
            tol = EP_BF16_RTOL if dt == torch.bfloat16 else 1e-5
            log(f"  {name} {dt} (64 tokens, E {c.n_experts}, top-"
                f"{c.top_k}, d {c.d_model}, moe_d_ff {c.moe_d_ff}): "
                f"bit-identical to moe_sorted on the kernels {same}; "
                f"against the plain path rel_err {rel:.3e} (≤ {tol}), "
                f"max_abs_err {float((got - plain).abs().max()):.3e}; "
                f"launches {launches}")
            if not same or rel > tol or launches["grouped_gemm"] != 2:
                raise AssertionError(f"{name} {dt} disagrees")
            out[f"{name}_{str(dt).split('.')[-1]}"] = {
                "bit_identical": same, "rel_err_plain": rel}
    return out


def ep_train_granite(torch, mesh, cfg, gen) -> dict:
    """13b: ``moe_ep_train`` on one full-width granite MoE layer, 8 x 128
    tokens, forward and backward. At capacity factor 8 (no drops) in
    float32 against the oracle ``moe_ffn_ref``; at the default 2.0 in
    bf16 with its drop fraction logged; at 2.0 in float32 against the
    same call on the CPU (gloo) from the same inputs: output, aux and
    drop fraction, and every gradient leaf within TRAIN_GRAD_RTOL as
    phase 12c holds the model's. Gradients finite and nonzero."""
    from repro_torch.kernels.ref import moe_ffn_ref
    from repro_torch.parallel import ep
    out = {}
    for cf, dt in ((8.0, torch.float32), (2.0, torch.bfloat16),
                   (2.0, torch.float32)):
        name = str(dt).split(".")[-1]
        c = dataclasses.replace(cfg, dtype=name, param_dtype=name)
        p = {k: v.requires_grad_() for k, v in
             _moe_layer(torch, c, gen, dt).items()}
        x = torch.randn((8, 128, c.d_model), generator=gen,
                        device="cuda").to(dt)
        epc = ep.EPConfig(mesh=mesh, dp_axes=("data",), capacity_factor=cf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (y, aux), launches = _launches_of(
            torch, lambda: ep.moe_ep_train(p, c, x, epc))
        (y.float().square().sum() + 0.01 * aux).backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.no_grad():
            wi_l, wo_l = ep._local_experts(p, c, epc)
            drop = float(ep._moe_ep_train_local(
                x.reshape(-1, c.d_model), p["router"], wi_l, wo_l, cfg=c,
                ep=epc)[2])
        norms = {k: float(v.grad.float().norm()) for k, v in p.items()}
        row = {"drop_frac": drop, "aux": float(aux.detach()),
               "grad_norms": norms,
               "fwd_bwd_s": wall, "launches": launches}
        msg = (f"  moe_ep_train {name} capacity factor {cf} (8 x 128 "
               f"tokens): drop fraction {drop:.4f}, aux {row['aux']:.4f}, "
               f"gradient norms {norms}, forward + backward {wall:.3f} s; "
               f"launches {launches}")
        if cf == 2.0 and dt == torch.float32:
            row.update(_ep_train_vs_cpu(torch, c, p, x, y, aux, drop, epc))
            msg += (f"; against the CPU: output rel_err "
                    f"{row['out_rel_err_cpu']:.3e}, aux "
                    f"{row['aux_cpu']:.6f}, drop fraction "
                    f"{row['drop_frac_cpu']:.4f}, gradient rel_err "
                    f"{row['grad_rel_err_cpu']} (each ≤ {TRAIN_GRAD_RTOL})")
        if cf == 8.0:
            with torch.no_grad():
                want = moe_ffn_ref(x.reshape(-1, c.d_model), p["router"],
                                   p["wi"], p["wo"], c.top_k,
                                   c.router_renorm).reshape(x.shape)
            row["max_abs_err"] = float((y.detach() - want).abs().max())
            msg += (f"; against moe_ffn_ref max_abs_err "
                    f"{row['max_abs_err']:.3e} (≤ 1e-4)")
        log(msg)
        bad = [k for k, v in norms.items() if not (math.isfinite(v) and v > 0)]
        cpu_errs = [row.get("out_rel_err_cpu", 0.0),
                    *row.get("grad_rel_err_cpu", {}).values()]
        if bad or row.get("max_abs_err", 0.0) > 1e-4 or (
                cf == 8.0 and drop > 0) or any(launches.values()) or (
                max(cpu_errs) > TRAIN_GRAD_RTOL) or row.get(
                "drop_frac_cpu", drop) != drop or abs(
                row.get("aux_cpu", row["aux"]) - row["aux"]) > 1e-5:
            raise AssertionError(f"moe_ep_train {name}: {row}")
        out[f"cf{cf}_{name}"] = row
    return out


def _ep_train_vs_cpu(torch, cfg, p, x, y, aux, drop, epc) -> dict:
    """``moe_ep_train`` on the CPU from the card's inputs and weights
    (float32; the group's CPU tensors take its gloo backend): the card's
    output and gradients against it, relative error per leaf."""
    from repro_torch.parallel import ep
    pc = {k: v.detach().cpu().requires_grad_() for k, v in p.items()}
    xc = x.detach().cpu()
    t0 = time.perf_counter()
    yc, auxc = ep.moe_ep_train(pc, cfg, xc, epc)
    (yc.square().sum() + 0.01 * auxc).backward()
    with torch.no_grad():
        wi_l, wo_l = ep._local_experts(pc, cfg, epc)
        drop_c = float(ep._moe_ep_train_local(
            xc.reshape(-1, cfg.d_model), pc["router"], wi_l, wo_l, cfg=cfg,
            ep=epc)[2])

    def rel(a, b):
        a, b = a.detach().cpu().double(), b.detach().double()
        return float((a - b).norm() / b.norm().clamp(min=1e-12))
    return {"out_rel_err_cpu": rel(y, yc), "aux_cpu": float(auxc.detach()),
            "drop_frac_cpu": drop_c, "cpu_s": time.perf_counter() - t0,
            "grad_rel_err_cpu": {k: rel(p[k].grad, pc[k].grad) for k in p}}


def ep_splitkv_granite(torch, mesh, cfg, gen) -> dict:
    """13d: ``splitkv_decode_attention`` over one KV shard at granite's
    heads (8 sequences, T 1024, phase 3's lengths) against the split-KV
    kernel alone: one shard weighs its partial by exactly 1, so the
    result is expected bit-identical; else it is held at 1e-6."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import collectives as coll
    out = {}
    lengths = torch.tensor([1, 63, 64, 65, 300, 512, 777, 1024],
                           dtype=torch.int32, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((8, cfg.n_heads, cfg.d_head), generator=gen,
                        device="cuda").to(dt)
        k, v = (torch.randn((8, 1024, cfg.n_kv_heads, cfg.d_head),
                            generator=gen, device="cuda").to(dt)
                for _ in range(2))
        got, launches = _launches_of(torch, lambda: coll.splitkv_decode_attention(
            q, k, v, lengths - 1, mesh))
        want = ops.splitkv_attention(q, k, v, lengths)
        same = bool(torch.equal(got, want))
        err = float((got.float() - want.float()).abs().max())
        log(f"  splitkv_decode_attention {dt}: bit-identical to the kernel "
            f"alone {same}" + ("" if same else f", max_abs_err {err:.3e} "
                               "(≤ 1e-6)") + f"; launches {launches}")
        if (not same and err > 1e-6) or launches["splitkv_attention"] != 1:
            raise AssertionError(f"split-KV over one shard {dt}: {err}")
        out[str(dt).split(".")[-1]] = {"bit_identical": same,
                                       "max_abs_err": err}
    return out


def ep_serve_hooked(torch, mesh, card, phase10) -> dict:
    """13e: phase 10's ``DecodeEngine`` workload with the EP hook
    installed: prefill through ``moe_ep_train``, decode through
    ``moe_ep_decode``. Every request completes; launches per tick as in
    phase 10; token agreement with phase 10's run logged; then the path
    check gated at ``PATH_REL_TOL`` with replayed routing."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.parallel import ep
    _free(torch)
    epc = ep.EPConfig(mesh=mesh, dp_axes=("data",))
    with ep.activate(epc):
        out, launches = _launches_of(torch, lambda: serve_mod.run(EP_ARGV))
        eng, wall = out["engine"], out["wall_s"]
        st = eng.stats
        done = sum(r.done for r in out["requests"])
        outputs = [list(r.output) for r in out["requests"]]
        agree = sum(a == b for a, b in zip(outputs, phase10["outputs"]))
        tok_agree = sum(x == y for a, b in zip(outputs, phase10["outputs"])
                        for x, y in zip(a, b))
        layers = eng.cfg.n_layers
        expected = {"grouped_gemm": 2 * layers * st.ticks,
                    "grouped_gemm_int8": 0, "grouped_gemm_int4": 0,
                    "flash_prefill": 0, "splitkv_attention": layers * st.ticks}
        log(f"  {card}: {done}/{EP_REQUESTS} requests complete, "
            f"{st.tokens_out} tokens, {st.prefills} prefills, {st.ticks} "
            f"ticks, requeued {st.requeued} in {wall:.2f} s wall "
            f"({st.throughput(wall):.1f} tokens/s); launches {launches} "
            f"({launches['grouped_gemm'] / max(st.ticks, 1):.0f} grouped GEMM "
            f"and {launches['splitkv_attention'] / max(st.ticks, 1):.0f} "
            f"split-KV per tick); requests whose tokens equal phase 10's "
            f"{agree}/{EP_REQUESTS}, tokens {tok_agree}/"
            f"{sum(map(len, outputs))}")
        if done != EP_REQUESTS or launches != expected:
            raise AssertionError(f"EP-hooked serve: {done} complete, "
                                 f"launches {launches} != {expected}")
        cfg, params = eng.cfg, eng.params
        prompts = torch.stack([torch.as_tensor(r.prompt) for r in
                               out["requests"][:8]]).to("cuda")
        del eng, out
        err = model_path_check(torch, cfg, params, {"tokens": prompts}, 16,
                               512, replay=True)
    log(f"  gate: replayed-routing rel_err {err['replayed']:.3e} ≤ "
        f"{PATH_REL_TOL} (free routing {err['free']:.3e}, logged)")
    if err["replayed"] > PATH_REL_TOL:
        raise AssertionError("the EP-hooked kernel path disagrees with the "
                             "plain path under the same routing")
    return {"wall_s": wall, "ticks": st.ticks, "launches": launches,
            "requests_equal_phase10": agree, "tokens_equal_phase10": tok_agree,
            "path_rel_err": err["replayed"], "path_rel_err_free": err["free"]}


def afd_four_f_blocks(torch, cfg, card) -> dict:
    """13f: phase 4's AFD engine with the F role over four F blocks on the
    one card (``f_devices = [cuda:0] * 4``: 4 blocks of 8 experts) on 8
    requests: all complete, bytes equal Eq. 9/17 in every window, and 8
    grouped-GEMM launches per M2N cycle against N_F = 1's 2; then its
    logits against N_F = 1's on one prefill chunk and 4 decode steps,
    gated with N_F 4 replaying N_F 1's expert choices (the block partials
    sum in another order, which flips near-tie routes downstream; the
    free-routing error is logged)."""
    from repro_torch.models.params import init_params
    from repro_torch.parallel.afd import AFDRuntime
    from repro_torch.serving.afd_engine import AFDServeEngine
    from repro_torch.serving.workload import (LengthDist, Phase,
                                              TrafficProfile, generate_trace)
    _free(torch)
    params = init_params(cfg, seed=0, device="cuda")
    profile = TrafficProfile(
        name="chip-smoke", phases=(Phase(2.0, 12.0),),
        prompt_len=LengthDist(64, 512), output_len=LengthDist(16, 64))
    trace = generate_trace(profile, seed=0, max_requests=8)
    out = {}
    for n_f in (1, 4):
        rt = AFDRuntime(cfg, params, f_devices=["cuda"] * n_f)
        eng = AFDServeEngine(rt, max_len=1024, n_bo=2, mb_slots=8,
                             prefill_chunk=64, tick_seconds=None)
        t0 = time.perf_counter()
        _, launches = _launches_of(torch, lambda: eng.run(trace,
                                                          max_ticks=20_000))
        wall = time.perf_counter() - t0
        s = eng.summary()
        per_cycle = launches["grouped_gemm"] / rt.stats.dispatches
        log(f"  N_F {n_f}: {s['completed']}/{len(trace)} completed, "
            f"{s['tokens_out']} tokens in {wall:.2f} s wall, "
            f"{rt.stats.dispatches} M2N cycles, bytes_match_all "
            f"{s['bytes_match_all']}; grouped-GEMM launches "
            f"{launches['grouped_gemm']} = {per_cycle:g} per cycle; "
            f"launches {launches}")
        if (s["completed"] != len(trace) or not s["bytes_match_all"]
                or per_cycle != 2 * n_f):
            raise AssertionError(f"AFD over {n_f} F blocks: {s}, {launches}")
        out[f"n_f{n_f}"] = {"wall_s": wall, "cycles": rt.stats.dispatches,
                            "grouped_gemm_per_cycle": per_cycle,
                            "tokens_per_s": s["tokens_out"] / wall}
    gen = seeded(torch, 17)
    tokens = torch.randint(1, cfg.vocab_size, (2, 68), generator=gen,
                           device="cuda", dtype=torch.int32)

    def run(n_f, calls, replay=None):
        rt = AFDRuntime(cfg, params, f_devices=["cuda"] * n_f)
        with recording_routes(calls, replay):
            caches, pos = rt.init_cache(2, 128)
            lg, caches, pos = rt.prefill(tokens[:, :64], caches, pos)
            steps = [lg]
            for j in range(64, 68):
                lg, caches, pos = rt.decode_step(tokens[:, j], caches, pos)
                steps.append(lg[:, None])
        return torch.cat(steps, dim=1).float()
    calls = {name: [] for name in ("one", "four", "replay")}
    one, four = run(1, calls["one"]), run(4, calls["four"])
    replayed = run(4, calls["replay"], calls["one"])
    flips, _ = routing_flips(torch, calls["one"], calls["four"], cfg.top_k)
    rel, rel_replayed = _rel(four, one), _rel(replayed, one)
    log(f"  logits N_F 4 against N_F 1 (a 64-token chunk + 4 decode steps "
        f"of 2 sequences): rel_err {rel:.3e} (free routing, logged), "
        f"max_abs_err {float((four - one).abs().max()):.3e}; top-"
        f"{cfg.top_k} routing disagreements {sum(flips)} of "
        f"{sum(int(c[2].shape[0]) for c in calls['one'])} routed rows; "
        f"N_F 4 replaying N_F 1's experts: rel_err {rel_replayed:.3e} ≤ "
        f"{PATH_REL_TOL} (gate)")
    if not torch.isfinite(four).all() or rel_replayed > PATH_REL_TOL:
        raise AssertionError("four F blocks disagree with one")
    out["logits_rel_err"] = rel_replayed
    out["logits_rel_err_free"] = rel
    return out


def kimi_moe_layer(torch, mesh, timer, gen) -> dict:
    """13g: one Kimi K2 MoE layer at full width (384 experts, top-8, d
    7168, moe_d_ff 2048; bf16 experts 33.8 GB): ``moe_ep_decode`` of 64
    tokens against the plain per-token oracle ``moe_ffn_ref`` (the plain
    grouped GEMM's float32 copy of every expert, 45 GB, does not fit
    beside them), then the two grouped-GEMM shapes' kernel time beside
    their bytes bound and ``torch._grouped_mm``."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_ffn_ref
    from repro_torch.models import moe
    from repro_torch.parallel import ep
    _free(torch)
    cfg = configs.get_config("kimi-k2-1t-a32b")
    e, k, d, m = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    t0 = time.perf_counter()
    p = _moe_layer(torch, cfg, gen, torch.bfloat16)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in p.values()) / 1e9
    x = torch.randn((64, 1, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    epc = ep.EPConfig(mesh=mesh)
    got, launches = _launches_of(torch, lambda: ep.moe_ep_decode(
        p, cfg, x, epc))
    out = {"decode_ms": timer(lambda: ep.moe_ep_decode(p, cfg, x, epc),
                              iters=5)}
    want = moe_ffn_ref(x.reshape(-1, d), p["router"], p["wi"], p["wo"], k,
                       cfg.router_renorm).reshape(x.shape)
    rel = _rel(got, want)
    log(f"  {cfg.name} MoE layer: {gb:.2f} GB of weights built in "
        f"{time.perf_counter() - t0:.1f} s; moe_ep_decode of 64 tokens "
        f"{out['decode_ms']:.3f} ms; against moe_ffn_ref rel_err {rel:.3e} "
        f"(≤ {EP_BF16_RTOL}), max_abs_err "
        f"{float((got.float() - want.float()).abs().max()):.3e}; launches "
        f"{launches}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not torch.isfinite(got).all() or rel > EP_BF16_RTOL:
        raise AssertionError("Kimi K2 MoE layer disagrees with moe_ffn_ref")
    out["rel_err"] = rel
    _, _, topi = moe.route(p, cfg, x.reshape(-1, d))
    sort_idx, _, sizes = moe.sort_by_expert(topi, e)
    visited = int((sizes > 0).sum())
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    xf = x.reshape(-1, d)
    h = torch.randn((64 * k, m), generator=gen, device="cuda").to(
        torch.bfloat16)
    for part, kk, nn, fn, lib_x in (
            ("gate|up", d, 2 * m,
             lambda: ops.grouped_gemm(xf, p["wi"], sizes,
                                      row_index=sort_idx // k),
             xf[sort_idx // k].contiguous()),
            ("down", m, d,
             lambda: ops.grouped_gemm(h, p["wo"], sizes, out_index=sort_idx,
                                      out_rows=64 * k), h)):
        w = p["wi"] if part == "gate|up" else p["wo"]
        ms = timer(fn)
        library_ms = timer(lambda: torch._grouped_mm(lib_x, w, offs=offs))
        rows = 64 if part == "gate|up" else 64 * k
        nbytes = (rows * kk + visited * kk * nn + 64 * k * nn) * 2 + 64 * k * 4
        b_ms, b_by = bound(nbytes, 2 * 64 * k * kk * nn, PEAK_BF16_FLOPS)
        log(f"  grouped_gemm Kimi K2 decode {part} bf16 (M={64 * k}, "
            f"K={kk}, N={nn}, {visited}/{e} experts, "
            f"{visited * kk * nn * 2 / 1e9:.2f} GB of weights): kernel "
            f"{ms:.4f} ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}) = {b_ms / ms:.1%} of it")
        out[part] = {"ms": ms, "library_ms": library_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "visited": visited}
    del p
    _free(torch)
    return out


def expert_parallel(torch, card, phase10) -> dict:
    """Phase 13: the expert-parallel layer (``parallel.ep``,
    ``parallel.collectives``) under one NCCL group at world size 1, the
    EP hook on phase 10's serve, the AFD F role over four blocks and one
    Kimi K2 MoE layer at full width."""
    from repro_torch import configs
    cfg = configs.get_config("granite-moe-1b-a400m")
    t0 = time.perf_counter()
    out = {}
    timer = Timer(torch)
    with nccl_world1(torch) as mesh:
        log("  13a/13c: EP decode and ETP decode, one granite MoE layer")
        out["decode"] = ep_decode_granite(torch, mesh, cfg, seeded(torch, 18))
        out["blocks"] = ep_expert_blocks(torch, cfg, seeded(torch, 22))
        log("  13b: EP train, one granite MoE layer, 8 x 128 tokens")
        out["train"] = ep_train_granite(torch, mesh, cfg, seeded(torch, 19))
        log("  13d: split-KV over one KV shard")
        out["splitkv"] = ep_splitkv_granite(torch, mesh, cfg,
                                            seeded(torch, 20))
        log("  13e: phase 10's serve with the EP hook installed")
        out["serve"] = ep_serve_hooked(torch, mesh, card, phase10)
        log("  13f: the AFD engine with the F role over four blocks")
        out["afd_n_f"] = afd_four_f_blocks(torch, cfg, card)
        log("  13g: one Kimi K2 MoE layer at full width")
        out["kimi"] = kimi_moe_layer(torch, mesh, timer, seeded(torch, 21))
    del timer
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 13 {out['phase_s']:.1f} s")
    log("  ep_summary13 " + json.dumps(out, default=str))
    _free(torch)
    return out


# ---------------------------------------------------------------------------
# Phase 14: the analysis front door and the calibrated provisioning leg
# ---------------------------------------------------------------------------

def front_door(args, timeout: int = 600):
    """``python -m repro_torch ARGS`` in a fresh interpreter (the
    provisioning search forks its worker pool, which must not inherit this
    process's CUDA context); returns (wall s, stdout)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch", *args],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"python -m repro_torch {' '.join(args)} exited "
                             f"{res.returncode}: {res.stderr[-2000:]}")
    return wall, res.stdout


def _verdicts(doc) -> dict:
    return {f"{v['model']}|{v['hardware']}": v for v in doc["verdicts"]}


def _verdict_line(v) -> str:
    afd = v["afd"] or {}
    return (f"{v['model']} on {v['hardware']}: {v['decision']}, HFU margin "
            f"{v['hfu_margin']:+.6f}, N_F {afd.get('n_f')}, N_A "
            f"{afd.get('n_a')}, derate {v['calibration_scale']!r}")


def stock_search(tmp) -> dict:
    """14a: the stock million-point search through the port's command line,
    once on the default tiles in one process and once on a quarter of them
    over 4 forked workers. The two documents must agree byte for byte
    without ``wall_s`` and the two counts of the tiling's own work (tiles,
    frontier evictions); DeepSeek-V3 must stay with EP on H800 and deploy
    AFD on GB200 (the JAX package's CI classifications)."""
    from repro_torch.api.sweep import DEFAULT_TILE_POINTS
    docs, walls = [], []
    for extra in ([], ["--tile-points", str(DEFAULT_TILE_POINTS // 4),
                       "--processes", "4"]):
        path = os.path.join(tmp, f"stock{len(docs)}.json")
        wall, out = front_door(["provision", "--json", path, *extra])
        with open(path) as fh:
            doc = json.load(fh)
        res = doc["result"]
        log(f"  14a provision {' '.join(extra) or '(defaults)'}: "
            f"{res['points']:,} points, {wall:.2f} s wall ({doc['wall_s']:.2f}"
            f" s search), {res['tiles']} tiles, eligible {res['eligible']:,},"
            f" frontier {res['frontier_size']} (evicted "
            f"{res['frontier_evicted']}), counters {res['counters']}")
        docs.append(doc)
        walls.append(wall)
    tiling = ("tiles", "frontier_evicted")
    a, b = (json.dumps({**d, "wall_s": None,
                        "result": {k: v for k, v in d["result"].items()
                                   if k not in tiling}}, sort_keys=True)
            for d in docs)
    if a != b:
        raise AssertionError("the stock search's documents differ between "
                             "tilings and worker counts")
    if docs[0]["result"]["points"] != 1_105_920:
        raise AssertionError("the stock grid is not 1,105,920 points")
    verdicts = _verdicts(docs[0])
    for key, want in (("DeepSeek-V3|H800", "stay-ep"),
                      ("DeepSeek-V3|GB200", "deploy-afd")):
        if verdicts[key]["decision"] != want:
            raise AssertionError(f"{key}: {verdicts[key]['decision']} != "
                                 f"{want}")
        log("  14a gate: " + _verdict_line(verdicts[key]))
    h100 = [v for k, v in verdicts.items() if k.endswith("|H100")]
    for v in h100:
        log("  14a on H100: " + _verdict_line(v))
    afd = sum(v["decision"] == "deploy-afd" for v in h100)
    log(f"  14a: {afd} of {len(h100)} paper models deploy AFD on H100")
    return {"walls": walls, "search_s": [d["wall_s"] for d in docs],
            "h100_deploy_afd": afd}


CALIBRATED_ARGV = ["provision", "--models", "DeepSeek-V3,Kimi-K2",
                   "--hardware", "H100,H800,GB200", "--n-f-max", "40",
                   "--calibrate"]


def calibrated_search(torch, tmp) -> dict:
    """14b: ``python -m repro_torch provision --calibrate`` in this process
    (it forks no pool, and its launches are counted here), on the card by
    default: calibration on granite's smoke config launches the grouped
    GEMM and split-KV by phase 8's rule, sees ``CALIB_WINDOWS`` busy
    windows, and every verdict carries its scale as the derate."""
    import io
    from repro_torch import __main__ as cli
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    path = os.path.join(tmp, "calibrated.json")
    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(CALIBRATED_ARGV + ["--json", path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"provision --calibrate exited {rc}")
    with open(path) as fh:
        doc = json.load(fh)
    cal = doc["calibration"]
    log(f"  14b {' '.join(CALIBRATED_ARGV)}: {wall:.2f} s wall "
        f"({doc['wall_s']:.2f} s search); launches {launches}")
    log("  14b calibration " + json.dumps(cal))
    for line in out.getvalue().splitlines()[:2]:
        log("  14b " + line)
    cfg = get_smoke_config(cal["arch"])
    specs = cfg.layer_plan().flat()
    attn = sum(1 for sp in specs if sp.kind == "attn")
    moe = sum(1 for sp in specs if sp.moe)
    steps = launches["splitkv_attention"] // attn
    expected = {"grouped_gemm": 2 * moe * steps, "grouped_gemm_int8": 0,
                "grouped_gemm_int4": 0, "flash_prefill": 0,
                "splitkv_attention": attn * steps}
    if steps <= 0 or launches != expected:
        raise AssertionError(f"provision --calibrate launches {launches} != "
                             f"{expected}")
    if cal["windows"] != CALIB_WINDOWS:
        raise AssertionError(f"calibration saw {cal['windows']} busy "
                             f"windows, not {CALIB_WINDOWS}")
    if not 0 < cal["scale"] <= 1:
        raise AssertionError(f"scale {cal['scale']} outside (0, 1]")
    for v in doc["verdicts"]:
        if v["calibration_scale"] != cal["scale"]:
            raise AssertionError(f"{v['model']}|{v['hardware']} derated by "
                                 f"{v['calibration_scale']}, not "
                                 f"{cal['scale']}")
        log("  14b " + _verdict_line(v))
    return {"wall": wall, "launches": launches, "scale": cal["scale"],
            "verdicts": {k: v["decision"] for k, v in _verdicts(doc).items()}}


def full_width_verdicts(calib) -> dict:
    """14c: the same search's verdicts for DeepSeek-V3 and Kimi-K2 on H100
    and H800, derated by phase 8's full-width calibration report
    (``recommend(calibration_scale=…)``, the library call)."""
    from repro_torch.provision import default_grid, recommend, search
    res = search(default_grid(models=["DeepSeek-V3", "Kimi-K2"],
                              hardware=["H100", "H800", "GB200"],
                              n_f_max=40))
    out = {}
    for model in ("DeepSeek-V3", "Kimi-K2"):
        for hw in ("H100", "H800"):
            v = recommend(res, model, hw, calibration_scale=calib.scale)
            if v.calibration_scale != calib.scale:
                raise AssertionError("verdict lost its derate")
            log("  14c " + _verdict_line(v.to_obj()))
            out[f"{model}|{hw}"] = v.decision
    return out


def other_front_doors() -> dict:
    """14d: ``plan --json``, ``sweep --name dead-zone``, ``bench`` (its
    vectorized sweep bit-exact against the scalar loop) and ``list``, each
    exiting 0."""
    walls = {}
    for args in (["plan", "--model", "DeepSeek-V3", "--hardware", "H100",
                  "--json"], ["sweep", "--name", "dead-zone"], ["bench"],
                 ["list"]):
        wall, out = front_door(args, timeout=300)
        walls[args[0]] = wall
        if args[0] == "plan":
            doc = json.loads(out)
            log(f"  14d plan DeepSeek-V3 on H100: N_F {doc['plan']['n_f']}, "
                f"N_A {doc['plan']['n_a']}, HFU {doc['plan']['hfu']:.4f}, "
                f"AFD recommended {doc['verdict']['afd_recommended']}")
        elif args[0] == "sweep":
            log(f"  14d sweep dead-zone: {out.splitlines()[0]}")
        elif args[0] == "bench":
            if "bit_exact=True" not in out:
                raise AssertionError("bench: sweep not bit-exact")
            log("  14d bench: " + "; ".join(out.splitlines()[1:]))
        log(f"  14d {args[0]}: {wall:.2f} s wall")
    return walls


def provisioning(torch, calib) -> dict:
    """Phase 14: the analysis front door on the card's host, and its
    calibrated leg on the card."""
    import tempfile
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["stock"] = stock_search(tmp)
        out["calibrated"] = calibrated_search(torch, tmp)
    log(f"  14c: phase 8's full-width scale {calib.scale!r} against 14b's "
        f"smoke-config scale {out['calibrated']['scale']!r}")
    out["full_width"] = full_width_verdicts(calib)
    out["front_doors"] = other_front_doors()
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 14 {out['phase_s']:.1f} s")
    log("  provision_summary14 " + json.dumps(out, default=str))
    return out


def _steady_engine(cfg, params, warm_ticks: int):
    """16 requests of 256 prompt tokens arrive at once; after
    ``warm_ticks`` ticks the engine interleaves one 64-token prefill chunk
    per tick with decode. Admission does not depend on the clock, so two
    engines built here run the same work tick for tick."""
    import collections
    from repro_torch.parallel.afd import AFDRuntime
    from repro_torch.serving.afd_engine import AFDServeEngine
    from repro_torch.serving.workload import ArrivalEvent
    eng = AFDServeEngine(AFDRuntime(cfg, params), max_len=1024, n_bo=2,
                         mb_slots=8, prefill_chunk=64, tick_seconds=None)
    eng.trace = collections.deque(
        ArrivalEvent(rid=i, t=0.0, prompt_len=256, max_new_tokens=64)
        for i in range(16))
    for _ in range(warm_ticks):
        eng.tick()
    eng.rt.synchronize()
    return eng


def profile_ticks(torch, cfg, params, n_ticks: int = 12,
                  warm_ticks: int = 20) -> None:
    """Device busy share of ``n_ticks`` steady engine ticks: the wall time
    comes from an untraced run, the device's kernel time from a
    ``torch.profiler`` trace of the same ticks on a second engine (the
    tracer slows the host, not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    eng = _steady_engine(cfg, params, warm_ticks)
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        eng.tick()
    eng.rt.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    del eng
    eng = _steady_engine(cfg, params, warm_ticks)
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            eng.tick()
        eng.rt.synchronize()
    calls = ops.launch_counts()["splitkv_attention"]
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"  {n_ticks} ticks: {wall_ms:.2f} ms wall untraced "
        f"({wall_ms / n_ticks:.2f} ms/tick); device kernels {busy_ms:.2f} "
        f"ms = busy share {busy_ms / wall_ms:.4f}, idle share "
        f"{1 - busy_ms / wall_ms:.4f}; {sum(r[1] for r in rows)} kernel "
        f"launches ({sum(r[1] for r in rows) / n_ticks:.0f} per tick)")
    for dev_ms, count, key in rows[:10]:
        log(f"  {dev_ms:9.3f} ms {count:6d} x  {key[:90]}")
    skv = [r for r in rows if "splitkv" in r[2]]
    log(f"  split-KV: {calls} wrapper calls; device kernels "
        + "; ".join(f"{key[:60]} {count} x {dev_ms:.3f} ms"
                    for dev_ms, count, key in skv))
    if sum(r[1] for r in skv) != calls:
        raise AssertionError("split-KV device kernels per wrapper call != 1")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace a window of granite's engine ticks after "
                         "phase 14")
    args = ap.parse_args()

    # phase 12's bitwise checks run cuBLAS under deterministic algorithms,
    # which needs a fixed workspace set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.common import tree_count
    from repro_torch.models.params import init_params

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
        f"driver and max SM clock {driver}")

    secs, build_logs = _build.build_all()
    log(f"[2] kernels built in {secs:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                log(f"  {name}: {line.strip()}")
    spills = (spilling(build_logs.get("splitkv_attention", ""), "")
              + spilling(build_logs.get("flash_prefill", ""),
                         "flash_prefill_mma_kernel"))
    if spills:
        raise AssertionError("kernel variants spill: " + "; ".join(spills))

    cfg = get_config("granite-moe-1b-a400m")
    timer = Timer(torch)
    log("[3] kernels against their plain versions (main-path shapes)")
    gen = seeded(torch, 0)
    measured = {"grouped_gemm": kernel_grouped_gemm(torch, timer, cfg, gen),
                "flash_prefill": kernel_flash_prefill(torch, timer, cfg, gen),
                "splitkv_attention": kernel_splitkv(torch, timer, cfg, gen)}
    check_launches = {}
    for seed, mode in ((2, "int8"), (3, "int4")):
        name = f"grouped_gemm_{mode}"
        measured[name], check_launches[name] = kernel_grouped_gemm_quant(
            torch, timer, cfg, seeded(torch, seed), mode)
    no_live_key_rows(torch, cfg, seeded(torch, 4))
    fused_bit_identity_bf16(torch, cfg, seeded(torch, 5))
    splitkv_head_sweep(torch, seeded(torch, 6))
    flash_prefill_kimi_heads(torch, timer, seeded(torch, 7))
    fleet_shape_kernels(torch, cfg, seeded(torch, 8))
    jamba_shape_kernels(torch, timer, seeded(torch, 10))
    splitkv_model_shapes(torch, timer, seeded(torch, 14))
    del timer

    log("[4] full-width serve: granite-moe-1b-a400m, 24 layers, bf16")
    params = init_params(cfg, seed=0, device="cuda")
    log(f"  {tree_count(params) / 1e9:.3f} B parameters")
    launches = serve(torch, cfg, params, card)

    log("[5] path check: kernels vs plain versions, full width bf16")
    err = path_check(torch, cfg, params)
    log(f"  gate: free-routing rel_err {err['free']:.3e} ≤ {PATH_REL_TOL}")
    if err["free"] > PATH_REL_TOL:
        raise AssertionError("kernel path disagrees with the plain path")
    log("[6] policy loop: SLO scheduler (EP) + HFU probe on the H100 plan")
    policy_loop(torch, cfg, params, card)
    log("[7] fleet: 3 replicas, least-kv router, failure, elastic N_F")
    fleet(torch, cfg, params, card)
    log("[8] calibration at full width: granite-moe-1b-a400m, bf16, H800 "
        "plan")
    calib = calibration(torch, cfg, params, card)
    del params                  # phase 9 needs the card's memory
    log(f"[9] Jamba at full width: jamba-v0.1-52b, {JAMBA_LAYERS} of 32 "
        "layers, bf16")
    jamba_serve(torch, card)
    _free(torch)
    log("[10] single-program EP serve: granite-moe-1b-a400m, 24 layers, "
        "bf16, python -m repro_torch serve " + " ".join(EP_ARGV))
    phase10 = ep_serve(torch, card)
    log("[11] the other families at full width through Model")
    fam = families(torch, card)
    log("  launches over phases 10-11: " + json.dumps(
        {"ep_serve": phase10["launches"], **{k: v["launches"]
                                     for k, v in fam.items()}}))
    log("[12] training and MTP at full width: granite-moe-1b-a400m, 24 "
        "layers, bf16; qwen1.5-0.5b float32")
    training(torch, card)
    log("[13] expert parallelism under NCCL at world size 1: EP decode, "
        "ETP, EP train, split-KV, the EP-hooked serve, AFD over four F "
        "blocks, a Kimi K2 MoE layer")
    expert_parallel(torch, card, phase10)
    log("[14] the analysis front door: the stock provisioning search, "
        "provision --calibrate on the card, full-width verdicts, plan / "
        "sweep / bench / list")
    provisioning(torch, calib)
    if args.profile:
        log("[15] profiled window of engine ticks")
        torch.cuda.empty_cache()
        profile_ticks(torch, cfg, init_params(cfg, seed=0, device="cuda"))
    log(f"done in {time.perf_counter() - t_start:.1f} s")

    # launches: the serve's counts for the serving path's kernels; the
    # quantized modes, which the serving path never runs, report the
    # launches of their phase-3 checks
    launches.update(check_launches)
    kernels = [{"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/"
                          f"{SOURCES.get(name, name)}.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                **measured[name]} for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
