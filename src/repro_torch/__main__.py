"""Command line of the port.

    python -m repro_torch serve-traffic [--profile poisson-burst] \
        [--arch granite-moe-1b-a400m] [--device cuda|cpu] \
        [--hardware H800] [--policy ep|afd|off] ...
    python -m repro_torch serve-fleet --profile poisson-burst \
        [--replicas 3 | --replica-shapes 2x2,1x4] [--router round-robin] \
        [--fail T:REPLICA[:FRAC]] [--no-rescale] [--device cuda|cpu] ...
    python -m repro_torch calibrate [--device cuda|cpu]
    python -m repro_torch serve --arch qwen3-8b [--preset smoke|100m|full] \
        [--mode ep|afd] [--slots 4] [--requests 16] [--fail-at T] \
        [--device cuda|cpu] ...
    python -m repro_torch train --arch granite-moe-1b-a400m \
        [--preset smoke|100m|full] [--steps 300] [--ckpt-dir D] \
        [--device cuda|cpu] ...

``serve-traffic`` runs the two-role AFD serving engine (``AFDRuntime`` +
``AFDServeEngine``) on the smoke config of ``--arch`` with random weights
from ``--seed``, under a seeded open-loop trace, and prints per-window rows
and a summary (or the JSON document with ``--json``). As in ``python -m
repro serve-traffic``, an ``HFUProbe`` prices every window against the AFD
plan for ``--hardware`` (disabled with a warning when no plan exists), and
the §3.3 ``SLOScheduler`` of ``--policy`` throttles admission.

``serve-fleet`` serves the trace on a fleet of such engines behind a
router (``repro_torch.fleet``), with scheduled failures and the elastic
N_F rescaler, as ``python -m repro serve-fleet`` does; the replicas share
one parameter tree on the device.

``calibrate`` runs ``repro_torch.provision.calibrate`` with the JAX
package's defaults (the counterpart of ``python -m repro provision
--calibrate``'s calibration) and prints its report as JSON.

``serve`` is ``repro_torch.launch.serve``, the counterpart of ``python -m
repro.launch.serve`` with its flags: the single-program model behind the
continuous-batching ``DecodeEngine`` (``--mode ep``), or AFD decode steps
(``--mode afd``).

``train`` is ``repro_torch.launch.train``, the counterpart of ``python -m
repro.launch.train`` with its flags: AdamW steps of the model on the
synthetic token stream, resuming from the newest committed checkpoint in
``--ckpt-dir``.

``serve-traffic`` and ``serve-fleet`` exit 1 if measured M2N bytes
diverge from the Eq. 9/17 prediction (``serve-fleet`` also if a request
is lost), and 2 on a bad argument (an unknown hardware or router name,
``--policy afd`` without a plan, a ``--fail`` target outside the fleet).
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
    from repro_torch.models.common import resolve_device
    from repro_torch.models.params import init_params
    from repro_torch.parallel.afd import AFDRuntime
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
    _write_json(doc, args.json)
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


def _parse_shapes(arg: Optional[str], n: int, n_bo: int, mb_slots: int):
    """``--replica-shapes 2x2,2x2,1x4`` as (n_bo, mb_slots) pairs; by
    default ``n`` replicas of the given shape."""
    if not arg:
        return [(n_bo, mb_slots)] * n
    shapes = []
    for part in arg.split(","):
        try:
            bo, slots = part.strip().lower().split("x")
            shapes.append((int(bo), int(slots)))
        except ValueError:
            raise ValueError(
                f"bad replica shape {part!r}; want N_BOxSLOTS, e.g. 2x2"
            ) from None
    return shapes


def _parse_failures(specs: Optional[List[str]]):
    """Repeated ``--fail T:REPLICA[:FRAC]`` as FailureEvents."""
    from repro_torch.fleet.events import FailureEvent
    events = []
    for spec in specs or []:
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bad failure spec {spec!r}; want T:REPLICA[:FRAC]")
        events.append(FailureEvent(
            t=float(parts[0]), replica=int(parts[1]),
            frac=float(parts[2]) if len(parts) == 3 else 1.0))
    return events


def cmd_serve_fleet(args) -> int:
    from repro_torch import configs
    from repro_torch.api import registry
    from repro_torch.core import planner as pln
    from repro_torch.fleet.controller import FleetController, FleetReplica
    from repro_torch.fleet.rescaler import ElasticRescaler
    from repro_torch.models.common import resolve_device
    from repro_torch.models.params import init_params
    from repro_torch.parallel.afd import AFDRuntime
    from repro_torch.serving.afd_engine import AFDServeEngine, HFUProbe
    from repro_torch.serving.workload import generate_trace, get_profile

    profile = get_profile(args.profile)
    cfg = configs.get_smoke_config(args.arch)
    shapes = _parse_shapes(args.replica_shapes, args.replicas,
                           args.n_bo, args.mb_slots)
    failures = _parse_failures(args.fail)
    for f in failures:
        if not 0 <= f.replica < len(shapes):
            print(f"error: --fail targets replica {f.replica} but the "
                  f"fleet has {len(shapes)}", file=sys.stderr)
            return 2
    router = registry.resolve_router(args.router)

    spec = registry.spec_from_arch_config(cfg)
    hw = registry.resolve_hardware(args.hardware)
    probe, rescaler = None, None
    try:
        plan = pln.plan_afd(spec, hw)
        probe = HFUProbe(model=spec, hardware=hw, plan=plan)
        if args.rescale:
            rescaler = ElasticRescaler(spec, hw, plan)
    except pln.PlanningError as e:
        print(f"warning: no AFD plan for {args.arch} on {args.hardware} "
              f"({e}); HFU probe and rescaler disabled", file=sys.stderr)

    device = resolve_device(args.device)
    params = init_params(cfg, seed=args.seed, device=device)
    tick_s = args.tick_ms * 1e-3
    replicas = []
    for i, (bo, slots) in enumerate(shapes):
        eng = AFDServeEngine(
            AFDRuntime(cfg, params, device=device), max_len=args.max_len,
            n_bo=bo, mb_slots=slots, probe=probe, seed=args.seed,
            slo_tpot=args.slo_tpot, slo_ttft=args.slo_ttft,
            tick_seconds=tick_s, window_ticks=args.window_ticks,
            prefill_chunk=args.prefill_chunk or None)
        if args.kv_budget_slots is not None:
            # admission budget as a fraction of the preallocated cache
            # (1.0 = the flat slot cap, below 1 tightens)
            eng.kv_budget_bytes = int(args.kv_budget_slots
                                      * eng.kv_slot_bytes * bo * slots)
        replicas.append(FleetReplica(name=f"replica{i}", engine=eng))

    fleet = FleetController(replicas, router=router, rescaler=rescaler,
                            window_ticks=args.window_ticks)
    trace = generate_trace(profile, seed=args.seed,
                           max_requests=args.max_requests)
    t0 = time.perf_counter()
    windows = fleet.run(trace, failures=failures, max_ticks=args.max_ticks)
    for rep in fleet.replicas:
        rep.engine.rt.synchronize()
    wall = time.perf_counter() - t0
    summary = fleet.summary()
    summary["wall_s"] = wall
    summary["device"] = str(device)

    doc = {"profile": profile.name, "arch": args.arch, "seed": args.seed,
           "router": args.router,
           "shapes": [f"{b}x{s}" for b, s in shapes],
           "failures": [dataclasses.asdict(f) for f in failures],
           "windows": [dataclasses.asdict(w) for w in windows],
           "rescales": [dataclasses.asdict(e) for e in fleet.rescales],
           "summary": summary}
    _write_json(doc, args.json)
    if args.json != "-":
        print(f"# fleet of {len(replicas)} ({args.router}) on "
              f"{profile.name} seed={args.seed} on {device}: {len(trace)} "
              f"arrivals, {summary['fleet_ticks']} fleet ticks, "
              f"{len(windows)} windows, wall {wall:.1f}s")
        print("win  t[s]        arr done  q live sigma  n_f bytes_ok "
              "events")
        for w in windows:
            ev = " fail" * len(w.failures)
            if w.rescale:
                ev += (f" rescale:{w.rescale['old_n_f']}"
                       f"->{w.rescale['new_n_f']}")
            print(f"{w.window:3d}  {w.t_start:5.2f}-{w.t_end:5.2f} "
                  f"{w.arrivals:4d} {w.completed:4d} {w.queue_len:2d} "
                  f"{w.live:4d} {w.sigma_load:5.2f} {w.n_f:4d} "
                  f"{str(w.bytes_match):>8s}{ev}")
        for name, r in summary["per_replica"].items():
            print(f"  {name}: dispatched={r['dispatched']} "
                  f"requeued_in={r['requeued_in']} "
                  f"completed={r['completed']} healthy={r['healthy']}")
        print(f"summary: completed={summary['completed']}"
              f"/{summary['arrivals']} lost={summary['lost']} "
              f"requeued={summary['requeued']} "
              f"rescales={summary['rescale_events']} "
              f"goodput={summary['goodput_rps']:.2f} req/s "
              f"bytes_match_all={summary['bytes_match_all']}")
    if not summary["bytes_match_all"]:
        print("FAIL: a replica's measured M2N bytes diverged from the "
              "Eq. 9/17 prediction", file=sys.stderr)
        return 1
    if summary["lost"]:
        print(f"FAIL: {summary['lost']} requests lost", file=sys.stderr)
        return 1
    return 0


def cmd_calibrate(args) -> int:
    from repro_torch.provision.calibrate import calibrate
    print(json.dumps(calibrate(device=args.device).to_obj(), indent=2))
    return 0


def _write_json(doc, path: Optional[str]) -> None:
    if not path:
        return
    payload = json.dumps(doc, indent=2, sort_keys=True, default=float)
    if path == "-":
        print(payload)
    else:
        with open(path, "w") as fh:
            fh.write(payload + "\n")


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.api.registry import list_routers
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.serving.workload import list_profiles

    # the AFD engines serve the archs with routed experts
    moe_archs = [a for a in ARCH_IDS if get_smoke_config(a).is_moe]
    p = argparse.ArgumentParser(prog="python -m repro_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("serve-traffic",
                        help="two-role AFD serving engine under a "
                             "stochastic trace")
    st.add_argument("--profile", default="poisson-burst",
                    choices=list_profiles())
    st.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=moe_archs)
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
    st.set_defaults(fn=cmd_serve_traffic)

    sf = sub.add_parser("serve-fleet",
                        help="multi-replica AFD fleet: routing, failover, "
                             "elastic N_F")
    sf.add_argument("--profile", required=True, choices=list_profiles())
    sf.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=moe_archs)
    sf.add_argument("--hardware", default="H800",
                    help="hardware spec for the HFU probe and the rescaler")
    sf.add_argument("--replicas", type=int, default=3)
    sf.add_argument("--replica-shapes", default=None,
                    help="heterogeneous shapes N_BOxSLOTS,... (e.g. "
                         "2x2,2x2,1x4); overrides --replicas/--n-bo/"
                         "--mb-slots")
    sf.add_argument("--router", default="round-robin",
                    help="routing policy: " + ", ".join(list_routers()))
    sf.add_argument("--fail", action="append", metavar="T:REPLICA[:FRAC]",
                    help="fail a replica at virtual time T (repeatable); "
                         "FRAC < 1 drains part of it, the default 1.0 kills "
                         "it and re-routes its requests")
    sf.add_argument("--no-rescale", dest="rescale", action="store_false",
                    help="disable the elastic N_F rescaler")
    sf.add_argument("--kv-budget-slots", type=float, default=None,
                    help="KV admission budget as a fraction of the "
                         "preallocated cache (default: the flat slot cap)")
    sf.add_argument("--seed", type=int, default=0)
    sf.add_argument("--max-requests", type=int, default=None)
    sf.add_argument("--max-ticks", type=int, default=5000)
    sf.add_argument("--max-len", type=int, default=32)
    sf.add_argument("--n-bo", type=int, default=2)
    sf.add_argument("--mb-slots", type=int, default=2)
    sf.add_argument("--window-ticks", type=int, default=8)
    sf.add_argument("--tick-ms", type=float, default=10.0)
    sf.add_argument("--slo-tpot", type=float, default=0.05)
    sf.add_argument("--slo-ttft", type=float, default=1.0)
    sf.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill on every replica (0 = legacy)")
    sf.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the plain "
                         "PyTorch path)")
    sf.add_argument("--json", default=None, metavar="PATH",
                    help="write the JSON document to PATH ('-' = stdout)")
    sf.set_defaults(fn=cmd_serve_fleet, rescale=True)

    ca = sub.add_parser("calibrate",
                        help="analytic-vs-measured HFU calibration on the "
                             "serve-traffic path")
    ca.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the plain "
                         "PyTorch path)")
    ca.set_defaults(fn=cmd_calibrate)

    # parsed by repro_torch.launch.serve / .train themselves (see main)
    sub.add_parser("serve", add_help=False,
                   help="single-program model behind the continuous-"
                        "batching DecodeEngine (python -m repro_torch serve "
                        "--help for its flags)")
    sub.add_parser("train", add_help=False,
                   help="the training driver (python -m repro_torch train "
                        "--help for its flags)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        if argv[:1] == ["serve"]:
            from repro_torch.launch import serve
            return serve.main(argv[1:])
        if argv[:1] == ["train"]:
            from repro_torch.launch import train
            return train.main(argv[1:])
        args = build_parser().parse_args(argv)
        return args.fn(args)
    except (KeyError, ValueError) as e:
        # Registry lookups and parameter checks raise with the known names
        # or the violated constraint: that is the user's message.
        msg = e.args[0] if e.args else str(e)
        print(f"error: {msg}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
