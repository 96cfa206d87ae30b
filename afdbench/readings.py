#!/usr/bin/env python3
"""Readings that set a cell's limits and rate; not a benchmark run.

    python3 afdbench/readings.py --workload <cell> --seeds 11,12 --seconds <s> [--control]
    python3 afdbench/readings.py --workload <cell> --seeds 11 --seconds <s> --rates 1.5,2,2.5

With ``--control``, for each seed in one process: the weights from the
seed, a run of the cell's window at its own load, then on the same sample
of the window's finished requests the program's logit gaps and the
control's (the reference in float8 weights,
``afdbench.check.control_gap``), each judged as a benchmark run judges
the program (``afdbench.check.judge``, the cell's limits): the control
has to come out ``correct`` false. With
``--rates``, the knee sweep: the cell's traffic at each rate on one
seed's weights, with the queue at the window's two ends and the TTFT of
its two halves. One JSON line per reading on standard output (and in
``--out``, appended).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rates", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from afdbench import check as chk
    from afdbench import harness, weights
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    cell = harness.load_cell(ROOT, args.workload)
    harness.import_program(ROOT)
    dtype = getattr(torch, cell.arch.get("param_dtype", "float32"))
    rates = [float(r) for r in args.rates.split(",") if r]

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in [int(s) for s in args.seeds.split(",")]:
        params = weights.make_params(cell.arch, seed, dtype, dev)
        torch.cuda.synchronize()
        for rate in rates or [None]:
            t0 = time.perf_counter()
            out = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                   False, rate=rate, params=params,
                                   t_start_age=0.0, check=False)
            rec = {"workload": args.workload, "seed": seed,
                   "rate": rate if rate is not None else cell.mix.rate,
                   "seconds": args.seconds, "window": out.window,
                   "memory_peak_bytes": out.record["device"][
                       "memory_peak_bytes"],
                   "wall_s": time.perf_counter() - t0}
            for n in out.notes:
                print(n, file=sys.stderr)
            if args.control:
                smp = chk.sample(out.served, out.prompt_lens, seed,
                                 cell.mix.sample_tokens)
                ctl = chk.control_gap(cell.arch, params, smp,
                                      cell.arch["vocab_size"], dev)
                for who, reading in (("program", ctl["program"]),
                                     ("control", ctl)):
                    ok, checks = chk.judge(reading, cell.check)
                    reading["correct"] = ok
                    print(f"{who} seed {seed}: correct={str(ok).lower()}; "
                          + "; ".join(f"{n} {v!r} limit {lim!r}"
                                      for n, v, lim in checks),
                          file=sys.stderr)
                rec["control"] = ctl
            emit(rec)
            del out
            harness.free_device(dev)
        del params
        harness.free_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
