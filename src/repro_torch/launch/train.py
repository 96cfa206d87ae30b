"""End-to-end training driver. Counterpart of ``repro.launch.train``,
with its flags and defaults plus ``--device``:

    PYTHONPATH=src python -m repro_torch train \\
        --arch granite-moe-1b-a400m --steps 300 --batch 8 --seq 128 \\
        --preset 100m --ckpt-dir CKPT [--device cuda|cpu]

(also ``python -m repro_torch.launch.train``). Presets (``launch.presets``):
smoke — the arch's reduced smoke config (seconds on a CPU); 100m — a
~100M-parameter member of the same family; full — the published config.

Weights are random, made from ``--seed`` by the port's initializer; the
data stream is the JAX driver's, batch for batch. The driver resumes from
the newest committed checkpoint in ``--ckpt-dir``: kill it mid-run and
rerun the same command to exercise the restart path (bitwise
deterministic, thanks to the (seed, step) data stream). It checkpoints
every ``--ckpt-every`` steps and at the end, as JAX's does, except that
the end's save is skipped when the loop has just written that step.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from repro_torch.launch.presets import PRESETS, preset_config
from repro_torch.models.model import make_model
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train import TrainConfig, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="100m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the plain "
                         "PyTorch path)")
    return ap


def run(argv: Optional[List[str]] = None) -> dict:
    """Train as ``main`` does and return what it measured: ``start`` (the
    resumed step), ``steps``, per-step ``losses``, ``grad_norms`` and
    ``step_walls`` (s, each ending in the host's read of the loss, so the
    device has finished the step), ``wall_s``, ``tokens``, and the final
    ``params``, ``opt_state`` and ``cfg``."""
    args = build_parser().parse_args(argv)
    cfg = preset_config(args.arch, args.preset)
    model = make_model(cfg, device=args.device)
    print(f"arch={cfg.name} preset={args.preset} "
          f"params≈{cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M)", flush=True)

    params = model.init(args.seed)
    opt = opt_mod.adamw(lr=args.lr)
    opt_state = opt.init(params)
    dc = data_mod.DataConfig(batch_size=args.batch, seq_len=args.seq,
                             vocab_size=cfg.vocab_size, seed=args.seed)
    step_fn = make_train_step(model, opt, TrainConfig(args.grad_accum))

    start, saved, ck = 0, None, None
    if args.ckpt_dir:
        ck = ckpt_mod.AsyncCheckpointer(args.ckpt_dir, keep=3)
        restored = ckpt_mod.restore_latest(args.ckpt_dir, params, opt_state)
        if restored is not None:
            start, params, opt_state, _ = restored
            saved = start
            print(f"resumed from step {start}")

    losses, grad_norms, walls = [], [], []
    t0 = time.time()
    tokens = 0
    for step in range(start, args.steps):
        ts = time.perf_counter()
        batch = data_mod.make_batch(dc, step, cfg, model.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - ts)
        grad_norms.append(float(metrics["grad_norm"]))
        tokens += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step == start:
            dt = time.time() - t0
            print(f"step {step+1:5d}  loss {losses[-1]:.4f}  "
                  f"ce {float(metrics['ce']):.4f}  "
                  f"gnorm {grad_norms[-1]:.2f}  "
                  f"{tokens/max(dt,1e-9):.0f} tok/s", flush=True)
        if ck and (step + 1) % args.ckpt_every == 0:
            ck.save(step + 1, params, opt_state)
            saved = step + 1
    if ck:
        if saved != args.steps:
            ck.save(args.steps, params, opt_state)
        ck.wait()
    wall = time.time() - t0
    print(f"done: {args.steps - start} steps in {wall:.1f}s; "
          f"entropy floor ≈ {data_mod.entropy_floor(dc):.3f} nats",
          flush=True)
    return {"start": start, "steps": args.steps, "losses": losses,
            "grad_norms": grad_norms, "step_walls": walls, "wall_s": wall,
            "tokens": tokens, "params": params, "opt_state": opt_state,
            "cfg": cfg}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
