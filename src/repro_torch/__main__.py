"""Command line of the port.

    python -m repro_torch plan --model DeepSeek-V3 --hardware H800 [--json]
    python -m repro_torch sweep --name dead-zone | --models M --hardware H
    python -m repro_torch bench [--n-f-max 24]
    python -m repro_torch provision [--models ...] [--hardware ...] \
        [--processes N] [--json PATH] [--calibrate [--device cuda|cpu]]
    python -m repro_torch list [models|hardware|scenarios|sweeps|traffic|...]
    python -m repro_torch serve-traffic [--profile poisson-burst] \
        [--arch granite-moe-1b-a400m] [--device cuda|cpu] \
        [--hardware H800] [--policy ep|afd|off] ...
    python -m repro_torch serve-fleet --profile poisson-burst \
        [--replicas 3 | --replica-shapes 2x2,1x4] [--router round-robin] \
        [--fail T:REPLICA[:FRAC]] [--no-rescale] [--device cuda|cpu] ...
    python -m repro_torch calibrate [--device cuda|cpu]
    python -m repro_torch tune [--shape E:TPE:DMODEL:DFF ...] [--reps 2] \
        [--out PATH] [--json]
    python -m repro_torch serve --arch qwen3-8b [--preset smoke|100m|full] \
        [--mode ep|afd] [--slots 4] [--requests 16] [--fail-at T] \
        [--device cuda|cpu] ...
    python -m repro_torch train --arch granite-moe-1b-a400m \
        [--preset smoke|100m|full] [--steps 300] [--ckpt-dir D] \
        [--device cuda|cpu] ...

``plan``, ``sweep``, ``bench``, ``provision`` and ``list`` are ``python -m
repro``'s analysis subcommands with its flags, defaults, output lines and
exit codes, on the port's copies of ``repro.api`` and ``repro.provision``
(host numpy). They import no torch: the serving commands' ``--arch``
choices are built only when a serving command is parsed. ``provision``
streams the million-point AFD-vs-EP grid through the tiled sweep (worker
processes forked with ``--processes``), keeps the Pareto frontier and
prints a deploy verdict per (model, hardware); ``--calibrate`` derates the
verdicts by ``repro_torch.provision.calibrate``, which runs the serving
engine and its kernels on ``--device`` (the card unless ``--device cpu``).
``bench`` exits 1 if the vectorized sweep diverges from the scalar loop,
``provision`` 3 if no grid point is eligible.

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

``tune`` times each candidate tiling of the grouped-GEMM kernel on the
card (``repro_torch.kernels.autotune``) at each ``--shape`` and merges the
winners into the table ``kernels.ops.grouped_gemm`` consults, as ``python
-m repro tune`` does. It needs a card: without one it prints an error and
exits 2 (there is no CPU mode, whose times would say nothing of the
kernel).

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
is lost). Every command exits 2 on a bad argument (an unknown model,
hardware, scenario, sweep or router name prints ``error: unknown …
known: […]``; ``--policy afd`` without a plan, a ``--fail`` target outside
the fleet).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np


def _split(arg: Optional[str]) -> Optional[List[str]]:
    if arg is None:
        return None
    return [a.strip() for a in arg.split(",") if a.strip()]


def _floats(arg: Optional[str]):
    vals = _split(arg)
    return None if vals is None else [float(v) for v in vals]


def cmd_list(args) -> int:
    from repro_torch.api import registry
    kind = args.kind
    if kind in ("models", "all"):
        print("models:")
        for m in registry.list_models():
            spec = registry.resolve_model(m)
            tag = ("MoE" if spec.is_moe else "dense")
            print(f"  {m:22s} {tag:5s} H={spec.hidden_size:5d} "
                  f"M={spec.moe_intermediate:5d} E={spec.n_routed_experts:3d} "
                  f"k={spec.top_k}")
    if kind in ("hardware", "all"):
        print("hardware:")
        for h in registry.list_hardware():
            hw = registry.resolve_hardware(h)
            pod = " superpod" if hw.superpod else ""
            print(f"  {h:8s} peak={hw.peak_flops/1e12:6.0f}T "
                  f"hbm={hw.hbm_bw/1e12:.2f}TB/s cap={hw.hbm_cap/1e9:.0f}GB "
                  f"${hw.cost_per_device_hour:.1f}/chip-h{pod}")
    if kind in ("scenarios", "all"):
        print("scenarios:")
        for s, scen in sorted(registry.SCENARIOS.items()):
            print(f"  {s:12s} slo={scen.slo_tpot*1e3:.0f}ms "
                  f"l_accept={scen.l_accept} t_gap={scen.t_gap*1e3:.0f}ms "
                  f"n_bo={scen.n_bo}")
    if kind in ("sweeps", "all"):
        print("sweeps:")
        for s in registry.list_sweeps():
            params = registry.named_sweep(s)
            print(f"  {s:12s} models={len(params['models'])} "
                  f"hardware={len(params['hardware'])}")
    if kind in ("traffic", "all"):
        from repro_torch.serving import workload
        print("traffic profiles:")
        for name in workload.list_profiles():
            prof = workload.get_profile(name)
            print(f"  {name:14s} {prof.total_duration:4.1f}s "
                  f"~{prof.expected_requests:5.0f} req  "
                  f"{prof.description}")
    if kind in ("routers", "all"):
        from repro_torch.fleet.router import ROUTER_POLICIES
        print("fleet router policies:")
        for name in sorted(ROUTER_POLICIES):
            doc = (ROUTER_POLICIES[name].__doc__ or "").split("\n")[0]
            print(f"  {name:14s} {doc}")
    return 0


def cmd_plan(args) -> int:
    from repro_torch.api import Deployment
    from repro_torch.core.planner import PlanningError
    dep = Deployment(args.model, args.hardware, args.scenario,
                     bw_scale=args.bw_scale)
    try:
        if args.sigma is not None:
            rec = dep.rescale(args.sigma, n_f=args.n_f)
        else:
            rec = dep.plan(n_f=args.n_f)
    except PlanningError as e:
        print(f"planning failed: {e}", file=sys.stderr)
        return 2
    verdict = dep.verdict()
    if args.json:
        print(json.dumps({"plan": dict(rec), "verdict": dict(verdict)},
                         indent=2, sort_keys=True))
        return 0
    plan = rec.get("plan", rec)
    print(f"{dep!r}")
    print(f"  N_F={plan['n_f']}  N_A={plan['n_a']}  "
          f"λ={plan['lambda_afd']:.2f}  total={plan['total_nodes']} nodes")
    print(f"  t_B={plan['t_budget']*1e3:.3f} ms  B_rank={plan['b_rank']:.0f} "
          f"tok  HFU={plan['hfu']:.1%}  S_t={plan['temporal_sparsity']:.3f}")
    print(f"  regime={plan['regime']}  bottleneck={plan['bottleneck']}  "
          f"bubble_free={plan['bubble_free']}  slo_ok={plan['slo_ok']}")
    if args.sigma is not None:
        print(f"  σ={rec['sigma']}: N_A {rec['old_n_a']} → {rec['new_n_a']} "
              f"({rec['rounding']}), α={rec['alpha']:.4f} "
              f"vs EP {rec['alpha_ep_reference']:.4f}")
    mark = "✓" if verdict["afd_recommended"] else "✗"
    print(f"  AFD recommended: {mark} "
          f"(ceiling {verdict['afd_hfu_ceiling']:.1%} vs "
          f"{verdict['ep_reference_hfu']:.0%} large-EP reference)")
    return 0


def cmd_sweep(args) -> int:
    from repro_torch.api import run_named_sweep, sweep
    from repro_torch.core.budget import weight_bytes_per_param
    wb = weight_bytes_per_param(args.weight_dtype)
    t0 = time.perf_counter()
    if args.name:
        overrides = {}
        if args.n_f_max:
            overrides["n_f"] = range(1, args.n_f_max + 1)
        if args.scenario != "default":
            overrides["scenarios"] = args.scenario
        if wb != 1.0:
            overrides["weight_bytes"] = wb
        res = run_named_sweep(args.name, **overrides)
    else:
        models = _split(args.models)
        hardware = _split(args.hardware)
        if not models or not hardware:
            print("sweep needs --name or both --models and --hardware",
                  file=sys.stderr)
            return 2
        res = sweep(models, hardware,
                    n_f=range(1, args.n_f_max + 1) if args.n_f_max else None,
                    scenarios=args.scenario,
                    bw_scale=_floats(args.bw_scale) or 1.0,
                    b_cap=_floats(args.b_cap),
                    weight_bytes=wb)
    dt = time.perf_counter() - t0
    if args.json:
        res.to_json(args.json)
    ceilings = res.ceilings(feasible_only=not args.infeasible)
    print(f"# {res.size} grid points in {dt*1e3:.1f} ms"
          + (f", expert weights {args.weight_dtype} ({wb:g} B/param)"
             if wb != 1.0 else "")
          + (f" → {args.json}" if args.json else ""))
    extra = [k for k in ("bw_scale", "b_cap")
             if ceilings and k in ceilings[0]]
    print("model,hardware,scenario," + "".join(f"{k}," for k in extra)
          + "n_f,hfu,regime,bottleneck,feasible")
    for r in ceilings:
        cols = "".join(f"{r[k]:g}," for k in extra)
        print(f"{r['model']},{r['hardware']},{r['scenario']},{cols}"
              f"{r['n_f']},{r['hfu']:.4f},{r['regime']},{r['bottleneck']},"
              f"{r['feasible']}")
    return 0


def cmd_bench(args) -> int:
    from repro_torch.api import scalar_reference, sweep
    from repro_torch.core.modelspec import PAPER_MODELS
    models = list(PAPER_MODELS)
    hardware = ["H20", "H100", "H200", "H800", "B200", "B300", "GB200",
                "GB300"]
    n_f = range(1, args.n_f_max + 1)
    grid = len(models) * len(hardware) * args.n_f_max

    t0 = time.perf_counter()
    vec = sweep(models, hardware, n_f=n_f)
    t_vec = time.perf_counter() - t0
    for _ in range(args.repeat - 1):           # warm best-of for stability
        t0 = time.perf_counter()
        vec = sweep(models, hardware, n_f=n_f)
        t_vec = min(t_vec, time.perf_counter() - t0)

    t0 = time.perf_counter()
    ref = scalar_reference(models, hardware, n_f=n_f)
    t_ref = time.perf_counter() - t0

    exact = all(
        bool(np.all((vec.fields[f] == ref.fields[f])
                    | (_nan_mask(vec.fields[f]) & _nan_mask(ref.fields[f]))))
        for f in vec.fields)
    speedup = t_ref / t_vec
    print("name,us_per_call,derived")
    print(f"api_sweep_vectorized,{t_vec*1e6:.0f},points={vec.size}")
    print(f"api_sweep_scalar_loop,{t_ref*1e6:.0f},points={ref.size}")
    print(f"api_sweep_equivalence,0,bit_exact={exact};points={vec.size}")
    print(f"api_sweep_speedup,0,speedup={speedup:.1f}")
    if not exact:
        print("FAIL: vectorized sweep diverged from the scalar reference",
              file=sys.stderr)
        return 1
    if grid < 1000:
        print(f"note: grid {grid} < 1000 points; raise --n-f-max",
              file=sys.stderr)
    return 0


def _nan_mask(a: np.ndarray) -> np.ndarray:
    return (a != a) if a.dtype.kind == "f" else np.zeros(a.shape, bool)


def _parse_costs(specs: Optional[List[str]]) -> dict:
    """Parse repeated ``--cost HW=PRICE`` into {name: $/chip-hour}."""
    out = {}
    for spec in specs or []:
        name, sep, price = spec.partition("=")
        if not sep:
            raise ValueError(f"bad --cost {spec!r}; want HW=PRICE, "
                             "e.g. --cost H800=2.4")
        out[name.strip()] = float(price)
    return out


def _parse_targets(specs: Optional[List[str]], grid, scenario: str):
    """Parse ``--target MODEL:HW[:SCENARIO]`` triples (default: every
    model × hardware pair in the grid at the verdict scenario)."""
    if specs:
        triples = []
        for spec in specs:
            parts = spec.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(f"bad --target {spec!r}; "
                                 "want MODEL:HW[:SCENARIO]")
            triples.append((parts[0], parts[1],
                            parts[2] if len(parts) == 3 else scenario))
        return triples
    return [(m.name, h.name, scenario)
            for m in grid.spec.models if m.is_moe
            for h in grid.spec.hardware]


def cmd_provision(args) -> int:
    from repro_torch.api.sweep import DEFAULT_TILE_POINTS
    from repro_torch.core.budget import weight_bytes_per_param
    from repro_torch.provision import default_grid, recommend, search

    kwargs = dict(cost_overrides=_parse_costs(args.cost),
                  sigma=args.sigma, ep_lambda=args.lambda_ep,
                  n_f_max=args.n_f_max,
                  weight_bytes=weight_bytes_per_param(args.weight_dtype))
    if args.models:
        kwargs["models"] = _split(args.models)
    if args.hardware:
        kwargs["hardware"] = _split(args.hardware)
    if args.scenarios:
        kwargs["scenarios"] = _split(args.scenarios)
    if args.bw_scale:
        kwargs["bw_scale"] = _floats(args.bw_scale)
    if args.b_cap:
        kwargs["b_cap"] = _floats(args.b_cap)
    if args.n_a_slack:
        kwargs["n_a_slack"] = [int(s) for s in _split(args.n_a_slack)]
    grid = default_grid(**kwargs)

    t0 = time.perf_counter()
    res = search(grid, tile_points=args.tile_points or DEFAULT_TILE_POINTS,
                 processes=args.processes)
    wall = time.perf_counter() - t0

    calibration = None
    scale = 1.0
    if args.calibrate:
        from repro_torch.provision.calibrate import calibrate
        rep = calibrate(device=args.device)
        calibration = rep.to_obj()
        scale = rep.scale

    scen_names = grid.spec.scenario_names
    verdict_scen = (args.scenario if args.scenario in scen_names
                    else scen_names[0])
    targets = _parse_targets(args.target, grid, verdict_scen)
    verdicts = [recommend(res, m, h, s, calibration_scale=scale)
                for m, h, s in targets]

    doc = {"grid": {"points": grid.points, "shape": list(grid.spec.shape),
                    "n_a_slack": list(grid.n_a_slack),
                    "sigma": grid.sigma, "ep_lambda": grid.ep_lambda,
                    "cost_overrides": dict(grid.cost_overrides),
                    "weight_bytes": grid.spec.weight_bytes},
           "result": res.to_obj(),
           "verdicts": [v.to_obj() for v in verdicts],
           "calibration": calibration,
           "wall_s": wall}
    _write_json(doc, args.json)
    if args.json != "-":
        print(f"# provision: {grid.points} points "
              f"({'x'.join(str(d) for d in grid.spec.shape)} grid "
              f"x {len(grid.n_a_slack)} slack) in {wall:.1f}s, "
              f"{res.tiles} tiles")
        print(f"# eligible={res.eligible} frontier={len(res.frontier)} "
              f"counters={res.counters}")
        if calibration:
            print(f"# calibration: measured/predicted HFU scale "
                  f"{scale:.4f} over {calibration['windows']} windows")
        print("# Pareto frontier (top rows by HFU_eff):")
        print("model,hardware,scenario,bw_scale,b_cap,n_f,n_a,"
              "hfu_eff,slack,cost_per_mtok")
        for row in res.frontier[:args.top]:
            cap = "inf" if row["b_cap"] is None else f"{row['b_cap']:g}"
            print(f"{row['model']},{row['hardware']},{row['scenario']},"
                  f"{row['bw_scale']:g},{cap},{row['n_f']},{row['n_a']},"
                  f"{row['hfu_eff']:.4f},{row['slack_frac']:.4f},"
                  f"{row['cost_per_mtok']:.4f}")
        print("# verdicts:")
        for v in verdicts:
            mark = "✓ AFD" if v.decision == "deploy-afd" else "✗ EP "
            print(f"  {mark} {v.summary}")
    if not res.frontier:
        print("FAIL: no eligible AFD point in the entire grid — the SLO "
              "is infeasible at every searched configuration",
              file=sys.stderr)
        return 3
    return 0


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


def _parse_tune_shapes(specs: Optional[List[str]]) -> List[tuple]:
    """Parse repeated ``--shape E:TPE:DMODEL:DFF`` quads."""
    shapes = []
    for spec in specs or []:
        parts = spec.split(":")
        if len(parts) != 4:
            raise ValueError(f"bad --shape {spec!r}; want E:TPE:DMODEL:DFF, "
                             "e.g. --shape 8:16:256:512")
        shapes.append(tuple(int(v) for v in parts))
    return shapes


# Default tune points: the port's own paths' expert GEMMs (E, tokens per
# expert, K, N): granite-moe-1b-a400m's decode gate|up and down and its
# prefill gate|up (8 sequences / a 64-token chunk x top-8 over 32
# experts); Jamba's (16 experts, top-2) decode gate|up and down and
# prefill gate|up; Kimi K2's AFD F block (6 local experts, 384 dispatched
# rows) gate|up and down.
DEFAULT_TUNE_SHAPES = [(32, 2, 1024, 1024), (32, 2, 512, 1024),
                       (32, 16, 1024, 1024),
                       (16, 1, 4096, 28672), (16, 1, 14336, 4096),
                       (16, 8, 4096, 28672),
                       (6, 64, 7168, 4096), (6, 64, 2048, 7168)]


def cmd_tune(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: tune times the grouped-GEMM kernel on a CUDA device "
              "and none is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import autotune
    shapes = _parse_tune_shapes(args.shape) or DEFAULT_TUNE_SHAPES
    t0 = time.perf_counter()
    results = autotune.tune(shapes, reps=args.reps, path=args.out)
    wall = time.perf_counter() - t0
    path = args.out or autotune._TABLE_PATH
    if args.json:
        print(json.dumps({"results": results, "table": path,
                          "wall_s": wall}, indent=2, sort_keys=True))
        return 0
    print(f"# tuned {len(results)} shape points in {wall:.1f}s → {path}")
    print("key,best_tiles,best_us,candidates")
    for r in results:
        print(f"{r['key']},{r['best']},{r['timings_us'][r['best']]:.1f},"
              f"{len(r['timings_us'])}")
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


def build_parser(arch_choices: bool = True) -> argparse.ArgumentParser:
    """The command line's parser. ``arch_choices=False`` leaves the serving
    commands' ``--arch`` without its list of MoE configs, whose building
    imports ``repro_torch.configs`` and with it torch: ``main`` builds the
    list only for ``serve-traffic`` and ``serve-fleet``, so the analysis
    commands start without torch."""
    from repro_torch.api.registry import list_routers
    from repro_torch.serving.workload import list_profiles

    moe_archs = None
    if arch_choices:
        from repro_torch.configs import ARCH_IDS, get_smoke_config
        # the AFD engines serve the archs with routed experts
        moe_archs = [a for a in ARCH_IDS if get_smoke_config(a).is_moe]
    p = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="The port's front door: AFD analysis (paper §2–§4) and "
                    "the PyTorch/CUDA serving and training paths.")
    sub = p.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("plan", help="§4 planner for one deployment triple")
    pl.add_argument("--model", required=True)
    pl.add_argument("--hardware", required=True)
    pl.add_argument("--scenario", default="default")
    pl.add_argument("--n-f", type=int, default=None,
                    help="force the FFN node count instead of optimizing")
    pl.add_argument("--sigma", type=float, default=None,
                    help="apply the §3.3 elastic rescale under imbalance σ")
    pl.add_argument("--bw-scale", type=float, default=1.0)
    pl.add_argument("--json", action="store_true")
    pl.set_defaults(fn=cmd_plan)

    sw = sub.add_parser("sweep", help="vectorized §3 grid evaluation")
    sw.add_argument("--name", default=None,
                    help="named sweep (see: python -m repro_torch list "
                         "sweeps)")
    sw.add_argument("--models", default=None, help="comma-separated")
    sw.add_argument("--hardware", default=None, help="comma-separated")
    sw.add_argument("--scenario", default="default")
    sw.add_argument("--n-f-max", type=int, default=None)
    sw.add_argument("--bw-scale", default=None,
                    help="comma-separated interconnect scale factors")
    sw.add_argument("--b-cap", default=None,
                    help="comma-separated per-rank token inflow caps")
    sw.add_argument("--infeasible", action="store_true",
                    help="include HBM-infeasible points in ceilings")
    sw.add_argument("--weight-dtype", default="fp8",
                    choices=["f32", "bf16", "f16", "fp8", "int8", "int4"],
                    help="expert-weight storage width for the Eq. 6 Mem "
                         "term (int4 halves bytes vs fp8 and shifts the "
                         "dead-zone boundary)")
    sw.add_argument("--json", default=None, metavar="PATH",
                    help="write the full record grid as JSON")
    sw.set_defaults(fn=cmd_sweep)

    be = sub.add_parser("bench",
                        help="scalar vs vectorized equivalence + speedup")
    be.add_argument("--n-f-max", type=int, default=24,
                    help="grid is 6 models × 8 platforms × n_f_max points")
    be.add_argument("--repeat", type=int, default=3)
    be.set_defaults(fn=cmd_bench)

    pv = sub.add_parser(
        "provision",
        help="million-point AFD-vs-EP search with Pareto frontier + verdict")
    pv.add_argument("--models", default=None,
                    help="comma-separated (default: all paper models)")
    pv.add_argument("--hardware", default=None,
                    help="comma-separated (default: every registry platform)")
    pv.add_argument("--scenarios", default=None,
                    help="comma-separated (default: all named scenarios)")
    pv.add_argument("--scenario", default="default",
                    help="scenario the deploy verdicts are stated for")
    pv.add_argument("--n-f-max", type=int, default=96,
                    help="FFN-node axis sweeps 1..N_F_MAX")
    pv.add_argument("--bw-scale", default=None,
                    help="comma-separated interconnect scale factors")
    pv.add_argument("--b-cap", default=None,
                    help="comma-separated per-rank token inflow caps")
    pv.add_argument("--n-a-slack", default=None,
                    help="comma-separated extra attention nodes (default 0,1)")
    pv.add_argument("--sigma", type=float, default=0.8,
                    help="§3.3 balancedness for the imbalance penalties")
    pv.add_argument("--lambda-ep", type=float, default=3.0,
                    help="t_a/t_f assumed for the large-EP reference")
    pv.add_argument("--tile-points", type=int, default=None,
                    help="max grid cells evaluated per tile")
    pv.add_argument("--processes", type=int, default=None,
                    help="shard tiles across worker processes (fork)")
    pv.add_argument("--cost", action="append", metavar="HW=PRICE",
                    help="override $/chip-hour (repeatable), "
                         "e.g. --cost H800=2.4 --cost GB200=9")
    pv.add_argument("--target", action="append",
                    metavar="MODEL:HW[:SCENARIO]",
                    help="emit a deploy verdict for this triple "
                         "(repeatable; default: every model x hardware)")
    pv.add_argument("--top", type=int, default=10,
                    help="frontier rows printed to stdout")
    pv.add_argument("--weight-dtype", default="fp8",
                    choices=["f32", "bf16", "f16", "fp8", "int8", "int4"],
                    help="expert-weight storage width priced into the "
                         "Eq. 6 Mem term and the HBM feasibility test")
    pv.add_argument("--calibrate", action="store_true",
                    help="derate verdicts by the measured/predicted HFU "
                         "scale from the serving engine on --device")
    pv.add_argument("--device", default="cuda",
                    help="torch device of the --calibrate run (default "
                         "cuda; cpu for the plain PyTorch path); read only "
                         "with --calibrate")
    pv.add_argument("--json", default=None, metavar="PATH",
                    help="write the full search result JSON ('-' for stdout)")
    pv.set_defaults(fn=cmd_provision)

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

    tn = sub.add_parser(
        "tune",
        help="autotune grouped-GEMM block sizes on the card; persists the "
             "table ops.grouped_gemm consults")
    tn.add_argument("--shape", action="append", metavar="E:TPE:DMODEL:DFF",
                    help="workload shape to tune (repeatable); default: "
                         "the port's granite, Jamba and Kimi K2 expert "
                         "GEMMs")
    tn.add_argument("--reps", type=int, default=2,
                    help="timed repetitions per candidate tiling")
    tn.add_argument("--out", default=None, metavar="PATH",
                    help="table file (default: the module-adjacent table "
                         "src/repro_torch/kernels/autotune_table.json)")
    tn.add_argument("--json", action="store_true")
    tn.set_defaults(fn=cmd_tune)

    # parsed by repro_torch.launch.serve / .train themselves (see main)
    sub.add_parser("serve", add_help=False,
                   help="single-program model behind the continuous-"
                        "batching DecodeEngine (python -m repro_torch serve "
                        "--help for its flags)")
    sub.add_parser("train", add_help=False,
                   help="the training driver (python -m repro_torch train "
                        "--help for its flags)")

    ls = sub.add_parser("list", help="registry contents")
    ls.add_argument("kind", nargs="?", default="all",
                    choices=["all", "models", "hardware", "scenarios",
                             "sweeps", "traffic", "routers"])
    ls.set_defaults(fn=cmd_list)
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
        args = build_parser(arch_choices=argv[:1] in (
            ["serve-traffic"], ["serve-fleet"])).parse_args(argv)
        return args.fn(args)
    except (KeyError, ValueError) as e:
        # Registry lookups and parameter checks raise with the known names
        # or the violated constraint: that is the user's message.
        msg = e.args[0] if e.args else str(e)
        print(f"error: {msg}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
