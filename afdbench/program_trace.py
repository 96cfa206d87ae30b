#!/usr/bin/env python3
"""One traced run of one cell with the program's own spans and counters.

    python3 afdbench/program_trace.py --workload <cell> --seed <n> --seconds <s> [--out <file>]

From the root of a checkout, on the card. The run is ``afdbench/run.py
--trace 1``'s, with the program's tracer set over its traced part
(``afdbench.program.wired``). Prints the run's notes on standard error and
one JSON object as the last line of standard output: the run's result
line (``record``), the readings of the program's spans
(``afdbench.program.report``: the six per-layer readings, phases and
``sync.*`` counts per tick, syncs inside the rotation call, the Mamba
step, collections by generation, the idle gaps labelled by the program's
ranges) and the card. ``--out`` writes the same object to a file. Exits 3
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from afdbench import run  # noqa: E402  (sets the run's environment)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from afdbench import harness, program
    if not torch.cuda.is_available():
        print("afdbench: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    with program.wired():
        out = harness.run_cell(run.ROOT, args.workload, args.seed,
                               args.seconds, True)
    for line in out.notes:
        print(line, file=sys.stderr)
    result = {"workload": args.workload, "seed": args.seed,
              "record": out.record, "program": program.report(out.trace),
              "card": run.card_line()}
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
