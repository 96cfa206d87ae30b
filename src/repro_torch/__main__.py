"""Command line of the port.

    python -m repro_torch serve-traffic [--profile poisson-burst] \
        [--arch granite-moe-1b-a400m] [--device cuda|cpu] \
        [--hardware H800] [--policy ep|afd|off] ...

Runs the two-role AFD serving engine (``AFDRuntime`` + ``AFDServeEngine``)
on the smoke config of ``--arch`` with random weights from ``--seed``,
under a seeded open-loop trace, and prints per-window rows and a summary
(or the JSON document with ``--json``). As in ``python -m repro
serve-traffic``, an ``HFUProbe`` prices every window against the AFD plan
for ``--hardware`` (disabled with a warning when no plan exists), and the
§3.3 ``SLOScheduler`` of ``--policy`` throttles admission. Exits 1 if the
measured M2N bytes diverge from the Eq. 9/17 prediction, 2 on a bad
argument (an unknown hardware name, ``--policy afd`` without a plan).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional


def cmd_serve_traffic(args) -> int:
    from repro_torch import configs
    from repro_torch.api import registry
    from repro_torch.core import planner as pln
    from repro_torch.models.params import init_params
    from repro_torch.parallel.afd import AFDRuntime, resolve_device
    from repro_torch.serving.afd_engine import AFDServeEngine, HFUProbe
    from repro_torch.serving.scheduler import SLOConfig, SLOScheduler
    from repro_torch.serving.workload import generate_trace, get_profile

    profile = get_profile(args.profile)
    cfg = configs.get_smoke_config(args.arch)
    spec = registry.spec_from_arch_config(cfg)
    hw = registry.resolve_hardware(args.hardware)
    try:
        plan = pln.plan_afd(spec, hw)
        probe = HFUProbe(model=spec, hardware=hw, plan=plan)
    except pln.PlanningError as e:
        print(f"warning: no AFD plan for {args.arch} on {args.hardware} "
              f"({e}); HFU probe disabled", file=sys.stderr)
        plan, probe = None, None
    scheduler = None
    if args.policy != "off":
        if args.policy == "afd" and plan is None:
            print("error: --policy afd needs a feasible AFD plan",
                  file=sys.stderr)
            return 2
        scheduler = SLOScheduler(SLOConfig(tpot=args.slo_tpot),
                                 mode=args.policy, plan=plan)

    device = resolve_device(args.device)
    params = init_params(cfg, seed=args.seed, device=device)
    rt = AFDRuntime(cfg, params, device=device)
    eng = AFDServeEngine(
        rt, max_len=args.max_len, n_bo=args.n_bo, mb_slots=args.mb_slots,
        scheduler=scheduler, probe=probe, greedy=not args.sample,
        seed=args.seed, slo_tpot=args.slo_tpot, slo_ttft=args.slo_ttft,
        tick_seconds=args.tick_ms * 1e-3 if args.tick_ms > 0 else None,
        window_ticks=args.window_ticks,
        prefill_chunk=args.prefill_chunk or None)
    trace = generate_trace(profile, seed=args.seed,
                           max_requests=args.max_requests)

    t0 = time.perf_counter()
    windows = eng.run(trace, max_ticks=args.max_ticks)
    summary = eng.summary()
    summary["wall_s"] = time.perf_counter() - t0
    summary["device"] = str(device)

    doc = {"profile": profile.name, "arch": args.arch, "seed": args.seed,
           "windows": [dataclasses.asdict(w) for w in windows],
           "summary": summary}
    if args.json:
        payload = json.dumps(doc, indent=2, sort_keys=True, default=float)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as fh:
                fh.write(payload + "\n")
    if args.json != "-":
        print(f"# {profile.name} seed={args.seed} on {device}: "
              f"{len(trace)} arrivals, {summary['decode_ticks']} decode "
              f"ticks, {len(windows)} windows, wall "
              f"{summary['wall_s']:.1f}s")
        hdr = ("win  t[s]        ticks adm done goodput_rps ttft_p95 "
               "bytes_ok")
        if scheduler is not None:
            hdr += "  sigma alpha"
        if probe is not None:
            hdr += "  hfu_meas/pred"
        print(hdr)
        for w in windows:
            line = (f"{w.window:3d}  {w.t_start:5.2f}-{w.t_end:5.2f} "
                    f"{w.ticks:5d} {w.admitted:3d} {w.completed:4d} "
                    f"{w.goodput_rps:11.2f} "
                    + (f"{w.ttft_p95:8.3f} " if w.ttft_p95 is not None
                       else "       - ")
                    + f"{str(w.bytes_match):>8s}")
            if scheduler is not None:
                line += (f"  {w.sigma:5.2f} {w.alpha:5.2f}"
                         if w.sigma is not None else "      -     -")
            if probe is not None and w.hfu_measured is not None:
                line += (f"  {w.hfu_measured:.2e}/"
                         f"{w.hfu_predicted:.2e}")
            print(line)
        print(f"summary: completed={summary['completed']}"
              f"/{summary['arrivals']}  "
              f"goodput={summary['goodput_rps']:.2f} req/s  "
              f"slo_ok={summary['slo_ok_frac']}  "
              f"bytes_match_all={summary['bytes_match_all']}")
        if "hfu_measured_mean" in summary:
            print(f"hfu: measured_mean={summary['hfu_measured_mean']:.3e}  "
                  f"predicted={summary['hfu_predicted']:.3e}  "
                  f"b_rank_util={summary['b_rank_utilization_mean']:.3e}")
    if not summary["bytes_match_all"]:
        print("FAIL: measured M2N bytes diverged from the Eq. 9/17 "
              "prediction", file=sys.stderr)
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.serving.workload import list_profiles

    p = argparse.ArgumentParser(prog="python -m repro_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("serve-traffic",
                        help="two-role AFD serving engine under a "
                             "stochastic trace")
    st.add_argument("--profile", default="poisson-burst",
                    choices=list_profiles())
    st.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=ARCH_IDS)
    st.add_argument("--hardware", default="H800",
                    help="hardware spec for the live Eq. 9/HFU probe")
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--max-requests", type=int, default=None)
    st.add_argument("--max-ticks", type=int, default=5000)
    st.add_argument("--max-len", type=int, default=32)
    st.add_argument("--n-bo", type=int, default=2,
                    help="micro-batches in the 3BO rotation")
    st.add_argument("--mb-slots", type=int, default=2,
                    help="sequences per micro-batch")
    st.add_argument("--window-ticks", type=int, default=8)
    st.add_argument("--tick-ms", type=float, default=10.0,
                    help="virtual tick length; 0 = wall clock")
    st.add_argument("--policy", default="ep", choices=["ep", "afd", "off"],
                    help="§3.3 SLO scheduler mode throttling admission")
    st.add_argument("--slo-tpot", type=float, default=0.05)
    st.add_argument("--slo-ttft", type=float, default=1.0)
    st.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill of this many tokens per tick; "
                         "0 = token-by-token teacher forcing")
    st.add_argument("--sample", action="store_true",
                    help="sample instead of greedy decoding")
    st.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the plain "
                         "PyTorch path)")
    st.add_argument("--json", default=None, metavar="PATH",
                    help="write the JSON document to PATH ('-' = stdout)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return cmd_serve_traffic(args)
    except (KeyError, ValueError) as e:
        # Registry lookups and parameter checks raise with the known names
        # or the violated constraint: that is the user's message.
        msg = e.args[0] if e.args else str(e)
        print(f"error: {msg}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
