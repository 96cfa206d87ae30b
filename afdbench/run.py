#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 afdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints what it did on standard error, the
numbers the check compared beside their limits as its last lines there,
and one JSON object as the last line of standard output. Exits 2 for an
unknown cell (listing the known ones), 3 without enough CUDA devices, 4
if JAX or the JAX package is loaded once the window has closed; no result
is printed then.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# one host thread for the program's CPU-side tensor work: the loop is
# host-bound, and idle pool threads only contend with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# every build and kernel cache of the program inside the checkout, at
# fixed paths, so that only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from afdbench import harness
    try:
        cell = harness.load_cell(ROOT, args.workload)
    except (harness.UnknownWorkload, FileNotFoundError) as e:
        print(f"afdbench: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"afdbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace))
    bad = harness.jax_modules()
    if bad:
        print(f"afdbench: loaded after the window: {bad}", file=sys.stderr)
        return 4
    for line in out.notes:
        print(line, file=sys.stderr)
    print(f"card: {card_line()}; peaks {harness.PEAKS}", file=sys.stderr)
    for name, value, limit in out.checks:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
