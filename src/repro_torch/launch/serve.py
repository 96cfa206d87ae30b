"""End-to-end serving script: continuous-batching decode of the
single-program model with the SLO scheduler observing every tick, an
optional fault-injection drill, or the two-role AFD runtime. Counterpart
of ``repro.launch.serve``, with its flags and defaults plus ``--device``,
less ``--n-a-nodes`` / ``--n-f-nodes``: the port's AFD runtime holds one
device for both roles, so a command line that sets them is refused.

    PYTHONPATH=src python -m repro_torch serve \\
        --arch kimi-k2-1t-a32b --preset smoke --requests 16 --slots 4 \\
        --mode ep [--device cuda|cpu]
    ... --mode afd          # AFDRuntime decode steps on the one device
    ... --fail-at 5         # drain a quarter of the slots at tick 5

Weights are random, made from ``--seed`` on ``--device`` by the port's
initializer (they are not JAX's numbers; the request stream is the same).
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.launch.presets import PRESETS, preset_config
from repro_torch.models.model import make_model
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.scheduler import SLOConfig, SLOScheduler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="smoke", choices=list(PRESETS))
    ap.add_argument("--mode", default="ep", choices=["ep", "afd"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="tick at which to simulate a node failure")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the plain "
                         "PyTorch path)")
    return ap


def run(argv: Optional[List[str]] = None) -> dict:
    """Serve as ``main`` does and return what it printed as numbers:
    ``mode``, ``wall_s``, and for EP the ``engine`` (its ``stats``), the
    ``requests`` and the scheduler's ``decision``, for AFD the runtime's
    ``stats``."""
    args = build_parser().parse_args(argv)
    cfg = preset_config(args.arch, args.preset)
    model = make_model(cfg, device=args.device)
    params = model.init(args.seed)
    rng = np.random.RandomState(args.seed)
    print(f"serving {cfg.name} ({args.mode}); "
          f"params≈{cfg.param_count()/1e6:.1f}M", flush=True)

    if args.mode == "afd":
        from repro_torch.parallel.afd import AFDRuntime
        if not cfg.is_moe:
            raise SystemExit(f"{cfg.name} is dense — AFD inapplicable; use "
                             "--mode ep")
        rt = AFDRuntime(cfg, params, device=model.device)
        caches, pos = rt.init_cache(args.slots, args.max_len)
        toks = torch.as_tensor(rng.randint(1, cfg.vocab_size,
                                           size=(args.slots,)),
                               dtype=torch.int32, device=model.device)
        t0 = time.time()
        n_steps = args.max_new
        for _ in range(n_steps):
            logits, caches, pos = rt.decode_step(toks, caches, pos)
            toks = torch.argmax(logits, -1).to(torch.int32)
        rt.synchronize()
        dt = time.time() - t0
        print(f"AFD: {n_steps} steps × {args.slots} seqs in {dt:.2f}s "
              f"({n_steps*args.slots/dt:.1f} tok/s)")
        print(f"M2N traffic: dispatch {rt.stats.dispatch_bytes/1e3:.1f} kB, "
              f"combine {rt.stats.combine_bytes/1e3:.1f} kB over "
              f"{rt.stats.dispatches} transfers", flush=True)
        return {"mode": "afd", "wall_s": dt, "stats": rt.stats}

    engine = DecodeEngine(model, params, n_slots=args.slots,
                          max_len=args.max_len)
    requests = [Request(rid=i, prompt=rng.randint(
        1, cfg.vocab_size, size=(args.prompt_len,)).astype(np.int32),
        max_new_tokens=args.max_new) for i in range(args.requests)]
    for req in requests:
        engine.submit(req)

    sched = SLOScheduler(SLOConfig(), mode="ep", lam=4.0)
    t0 = time.time()
    tick = 0
    while engine.queue or any(s is not None for s in engine.slots):
        ts = time.time()
        engine.tick()
        sched.observe(time.time() - ts)
        tick += 1
        if args.fail_at is not None and tick == args.fail_at:
            n = engine.simulate_failure(0.25)
            print(f"[tick {tick}] simulated node failure: "
                  f"requeued {n} requests")
        if tick > 10_000:
            break
    wall = time.time() - t0
    st = engine.stats
    print(f"EP: {st.tokens_out} tokens, {st.prefills} prefills, "
          f"{st.ticks} ticks in {wall:.2f}s "
          f"({st.throughput(wall):.1f} tok/s); requeued={st.requeued}")
    d = sched.decide(t_budget=np.median(sched.samples))
    print(f"scheduler: σ̂={d.sigma:.3f} α_ep={d.alpha:.3f} "
          f"straggler_rate={d.straggler_rate:.2f}", flush=True)
    return {"mode": "ep", "wall_s": wall, "engine": engine,
            "requests": requests, "decision": d}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
