"""Multi-pod dry-run. Counterpart of ``repro.launch.dryrun``.

For every (architecture × input shape × mesh) cell this module

    1. builds the distributed step (train step / prefill / decode step) on
       DTensors placed by the sharding rules, with the MoE layers on the
       expert-parallel hook through ``local_map`` (``parallel.ep``);
    2. runs device 0's program on fake tensors (no storage is allocated)
       over a ``fake`` process group of 256 (``single``) or 512
       (``multi``) ranks, on the production mesh's axes;
    3. counts its FLOPs, bytes and collectives on the 1- and 2-period
       probes (``hlo_analysis.count_cost``) and extrapolates them to full
       depth as JAX does, and follows its live bytes at full depth
       (``hlo_analysis.PeakTracker``);
    4. records the roofline terms into results/dryrun.json (incremental:
       reruns skip finished cells unless --force).

The record has JAX's keys, with these differences. Nothing compiles, so
there is no ``lower_s`` / ``compile_s``: ``price_s`` is the pricing's wall
time. ``memory.argument_bytes_dev`` and ``output_bytes_dev`` are the local
blocks' bytes of the program's inputs and outputs; ``temp_bytes_dev`` and
``peak_bytes_dev`` are the tracker's (the peak of the storages the program
allocates, outputs included), not XLA's buffer assignment; ``code_bytes_dev``
is 0. ``fits_v5e_16g`` keeps its meaning and ``fits`` names the priced
hardware's HBM. Cost and collectives are the port's own program's: the
kernel ops priced by their own work (on fake tensors, by their bound on
the shapes: ``bounded`` names them), DTensor's collectives and the EP
hook's. ``replicated`` names the pieces DTensor could not split and that
run replicated: the attention core keeps its heads whole where the query
heads do not divide over "model" (and gathers the KV heads whole where
only they do not), the MoE layer keeps its experts
whole where they do not divide over the EP axis, and the Mamba mixer's
SSD runs every head on each rank of "model" where the rules do not split
its heads over "model" (they do not divide, or ``sp`` gives "model" to the
sequence; ``models.mamba2``).

Each program runs under ``parallel.sharding.activate(mesh, rules)``, as
JAX's compiles under its rules, so the models' activation annotations
place their activations: ``sp`` (``TRAIN_RULES_SP`` / ``SERVE_RULES_SP``)
splits the sequence over "model" at them. One lever differs from JAX's by
nature. ``donate``: PyTorch has no buffer donation; in the port it means
the decode step writes the cache in place (``alias_bytes_dev`` counts the
cache), and without it the step first copies the cache, as JAX's
undonated program makes a new one.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    ... --arch kimi-k2-1t-a32b --shape decode_32k --mesh multi
    ... --rules serve_nosplitkv --hardware H100
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import configs
from repro_torch.core import modelspec
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import (device_mesh, fake_world,
                                     make_production_mesh)
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.model import Model
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ep as ep_mod
from repro_torch.parallel import sharding as shd
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train import (TrainConfig, distributed_train_step,
                                        train_state_shardings)

RESULTS_DEFAULT = "results/dryrun.json"

RULE_SETS = {
    "train": shd.TRAIN_RULES,
    "serve": shd.SERVE_RULES,
    "serve_nosplitkv": shd.SERVE_RULES_NO_SPLITKV,
    "train_sp": shd.TRAIN_RULES_SP,
}

# §Perf variants ("+"-combinable): each toggles one optimization lever so
# the hillclimb log can price them independently.
VARIANTS = ("etp", "sp", "donate", "qkf32", "nosplitkv", "ws", "ga4")


def _cfg_for_cell(arch: str, spec: shp.ShapeSpec):
    cfg = configs.get_config(arch)
    if spec.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def _ep_config(cfg, spec: shp.ShapeSpec, mesh) -> Optional[ep_mod.EPConfig]:
    if not cfg.is_moe:
        return None
    sizes = shd.axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    # batch-1 decode can't shard tokens over dp — replicate instead
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    if spec.kind == "decode" and spec.global_batch % max(dp_size, 1) != 0:
        dp = ()
    return ep_mod.EPConfig(mesh=mesh, ep_axis="model", dp_axes=dp,
                           capacity_factor=1.25 if spec.kind != "decode"
                           else 2.0)


def _install_splitkv(mesh, cfg) -> None:
    """Decode-attention strategy: split-KV over the cache's T shards
    (``parallel.collectives.splitkv_decode_attention`` on each rank's
    block, through ``local_map``), where JAX installs it: no sliding
    window, T a multiple of the "model" axis and at least 4096."""

    def override(cfg_l, q, k, v, pos):
        n_model = shd.axis_sizes(mesh).get("model", 1)
        t = k.shape[1]
        if cfg_l.sliding_window is not None or t % n_model != 0 or t < 4096:
            return None
        specs = coll.splitkv_specs(mesh, "model", q.shape[0])
        pl = {k_: shd.placements(s, mesh) for k_, s in specs.items()}

        def local(q_l, k_l, v_l, pos_l):
            return (coll.splitkv_decode_attention(q_l, k_l, v_l, pos_l,
                                                  mesh, axis="model"),)

        out, = coll.spmd_map(local, mesh,
                               (pl["q"], pl["kv"], pl["kv"], pl["pos"]),
                               (pl["out"],))(q[:, 0], k, v, pos)
        return out.reshape(out.shape[0], 1, -1)     # (B, 1, Hq·d)

    attn_mod.set_decode_attention_override(override)


def _probe_cfg(cfg, n_periods: int):
    """Reduced-depth variant for cost extrapolation: the first
    ``n_periods`` periods of the layer plan (and as many encoder layers),
    unrolled. Two probes at 1 and 2 periods give exact linear
    extrapolation: metric(n) = m1 + (m2 − m1)·(n − 1)."""
    plan = cfg.layer_plan()
    n_layers = len(plan.prefix) + n_periods * max(len(plan.period), 1)
    kw = {"n_layers": min(n_layers, cfg.n_layers), "force_unroll": True}
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = n_periods
    return dataclasses.replace(cfg, **kw)


def _extrapolate(raw1, raw2, n_periods: int):
    """metric(n) = m1 + (m2 − m1)·(n − 1) for every cost/collective field."""
    (cost1, coll1), (cost2, coll2) = raw1, raw2
    n = max(n_periods, 1)

    def ext(a, b):
        return max(a + (b - a) * (n - 1), 0.0)

    cost = {"flops": ext(float(cost1.get("flops", 0.0)),
                         float(cost2.get("flops", 0.0))),
            "bytes accessed": ext(float(cost1.get("bytes accessed", 0.0)),
                                  float(cost2.get("bytes accessed", 0.0)))}
    coll_ = hlo.CollectiveStats(
        operand_bytes={k: int(ext(coll1.operand_bytes.get(k, 0),
                                  coll2.operand_bytes.get(k, 0)))
                       for k in hlo.COLLECTIVE_OPS},
        link_bytes={k: int(ext(coll1.link_bytes.get(k, 0),
                               coll2.link_bytes.get(k, 0)))
                    for k in hlo.COLLECTIVE_OPS},
        counts={k: int(ext(coll1.counts.get(k, 0), coll2.counts.get(k, 0)))
                for k in hlo.COLLECTIVE_OPS})
    return cost, coll_


def _fake_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype)


def _replicated_pieces(cfg, spec: shp.ShapeSpec, mesh, rules, epc) -> list:
    """The pieces whose block is whole where the rules would split them:
    see the module's docstring."""
    n_model = shd.axis_sizes(mesh).get("model", 1)
    out = []
    if cfg.n_heads and n_model > 1:
        hq, g = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
        q_split = hq % n_model == 0 and (hq // n_model % g == 0
                                         or g % (hq // n_model) == 0)
        if not q_split:
            out.append(f"attention heads ({hq} q / {cfg.n_kv_heads} kv, "
                       f"whole on each of model={n_model})")
        elif cfg.n_kv_heads % n_model:
            out.append(f"KV heads ({cfg.n_kv_heads}, gathered whole on each "
                       f"of model={n_model})")
    if epc is not None and cfg.n_experts % epc.ep_size:
        out.append(f"experts ({cfg.n_experts} over model={epc.ep_size})")
    if cfg.ssm_state and n_model > 1:
        # the SSD's heads: the cache's placement in decode, the annotated
        # head inputs' (sequence padded to a chunk multiple) otherwise
        if spec.kind == "decode":
            logical = ("batch", "heads", None, None)
            shape = (spec.global_batch, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state)
        else:
            chunk = min(cfg.ssm_chunk, spec.seq_len) or 1
            logical = ("batch", "seq", "heads", None)
            shape = (spec.global_batch, -(-spec.seq_len // chunk) * chunk,
                     cfg.ssm_heads, cfg.ssm_head_dim)
        if shd.logical_to_spec(mesh, rules, logical,
                               shape)[logical.index("heads")] is None:
            out.append(f"Mamba mixer ({cfg.ssm_heads} SSD heads whole on "
                       f"each of model={n_model})")
    return out


def _run_variant(cfg, spec: shp.ShapeSpec, mesh, rules, epc, splitkv: bool,
                 arch: str, donate_cache: bool = False, qk_f32: bool = False,
                 grad_accum: int = 1, memory: bool = False) -> Dict:
    """Run device 0's program of one config variant on fake tensors: under
    the cost counter, or with ``memory`` under the peak tracker. Returns
    the counter's cost and collectives, or the memory fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    model = Model(cfg, device="cpu")
    old_qk = attn_mod.QK_F32_BARRIER
    attn_mod.QK_F32_BARRIER = qk_f32
    try:
        with FakeTensorMode(), torch.no_grad():
            params = model.init(0)
            batch = {k: _fake_like(v)
                     for k, v in shp.batch_specs(cfg, spec).items()}
            if spec.kind == "train":
                nb = modelspec.ALL_MODELS.get(arch)
                opt = opt_mod.optimizer_for(
                    (nb.total_params / 1e9) if nb else 1.0)
                state = opt.init(params)
                specs = train_state_shardings(params, state, batch, mesh,
                                              rules)
                args = (params, state, batch)
            else:
                p_spec = shd.params_shardings(params, mesh, rules)
                b_spec = shd.batch_shardings(batch, mesh, rules)
                if spec.kind == "prefill":
                    cache = model.init_cache(spec.global_batch, spec.seq_len)
                else:
                    cache = tree_map(_fake_like, shp.cache_specs(model, spec))
                c_spec = shd.cache_shardings(cache, mesh, rules, cfg)
                if spec.kind == "prefill":
                    specs, args = (p_spec, b_spec, c_spec), (params, batch,
                                                             cache)
                else:
                    specs = (p_spec, c_spec, b_spec["tokens"])
                    args = (params, cache, batch["tokens"])
            arg_bytes = sum(shd.block_bytes(a, s, mesh)
                            for a, s in zip(args, specs))
            if spec.kind == "prefill":      # the cache is made by the step
                arg_bytes -= shd.block_bytes(args[2], specs[2], mesh)
            placed = [shd.distribute_tree(a, s, mesh)
                      for a, s in zip(args, specs)]
            del params, args

            def program():
                with shd.activate(mesh, rules):
                    return run()

            def run():
                ctx = ep_mod.activate_dtensor(epc) if epc else \
                    contextlib.nullcontext()
                if spec.kind == "train":
                    step = distributed_train_step(
                        model, opt, mesh, TrainConfig(grad_accum=grad_accum),
                        ep=epc)
                    with torch.enable_grad():
                        return step(*placed)
                with implicit_replication(), ctx:
                    if splitkv and spec.kind == "decode" and cfg.n_heads > 0:
                        _install_splitkv(mesh, cfg)
                    if spec.kind == "prefill":
                        p, b, c = placed
                        return model.prefill(p, b, max_len=spec.seq_len,
                                             cache=c)
                    p, c, tok = placed
                    if not donate_cache:    # a new cache, as JAX's output
                        c = tree_map(lambda t: None if t is None
                                     else t.clone(), c)
                    return model.decode_step(p, c, tok)

            if memory:
                tracker = hlo.PeakTracker()
                with tracker:
                    out = program()
                out_bytes = sum(t.to_local().numel()
                                * t.to_local().element_size()
                                for t in tree_leaves(out)
                                if isinstance(t, DTensor))
                alias = 0
                if spec.kind == "decode" and donate_cache:
                    alias = shd.block_bytes(placed[1], specs[1], mesh)
                temp = max(tracker.peak - (out_bytes - alias), 0)
                return {"argument_bytes_dev": arg_bytes,
                        "output_bytes_dev": out_bytes,
                        "temp_bytes_dev": temp, "alias_bytes_dev": alias}
            with hlo.count_cost() as counter:
                program()
            return {"cost": counter.cost,
                    "collectives": hlo.collective_stats(counter.collectives),
                    "bounded": sorted(counter.bounded)}
    finally:
        attn_mod.set_decode_attention_override(None)
        attn_mod.QK_F32_BARRIER = old_qk


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               rules_name: Optional[str] = None,
               splitkv: bool = True, probes: bool = True,
               variant: str = "", hardware: str = "TPUv5e") -> Dict:
    """Price one cell; return the result record.

    ``variant`` is a "+"-joined set of §Perf levers (see VARIANTS):
      etp       weight-stationary ETP MoE decode (paper §5.1)
      sp        sequence-parallel activations (the seq axis on "model")
      donate    the decode cache written in place
      qkf32     f32 Q/K before attention scores
      nosplitkv disable the split-KV decode override (iteration-0 baseline)
      ws        weight-stationary serving (experts not FSDP-split)
      ga4       four microbatches of gradient accumulation
    ``hardware`` is the pricing (``hlo_analysis.PRICING``).
    """
    levers = set(v for v in variant.split("+") if v)
    unknown = levers - set(VARIANTS)
    assert not unknown, f"unknown variants {unknown}; known: {VARIANTS}"
    spec = shp.SHAPES[shape_name]
    cfg = _cfg_for_cell(arch, spec)
    ok, reason = shp.cell_supported(cfg, shape_name)
    mesh_name = "multi" if multi_pod else "single"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": spec.kind, "variant": variant or "baseline"}
    if not ok:
        return {**base, "status": "skipped", "reason": reason}

    mesh_shape = make_production_mesh(multi_pod=multi_pod)
    chips = 512 if multi_pod else 256
    if rules_name:
        rules = RULE_SETS[rules_name]
    elif spec.kind == "train":
        rules = shd.TRAIN_RULES_SP if "sp" in levers else shd.TRAIN_RULES
    elif "ws" in levers:
        rules = shd.SERVE_RULES_WS
    elif "sp" in levers:
        rules = shd.SERVE_RULES_SP
    else:
        rules = (shd.SERVE_RULES_NO_SPLITKV if "nosplitkv" in levers
                 else shd.SERVE_RULES)
    splitkv = splitkv and "nosplitkv" not in levers
    kw = dict(donate_cache="donate" in levers, qk_f32="qkf32" in levers,
              grad_accum=4 if "ga4" in levers else 1)
    t0 = time.perf_counter()
    with fake_world(chips):
        mesh = device_mesh(mesh_shape)
        epc = _ep_config(cfg, spec, mesh)
        if epc and "etp" in levers:
            epc = dataclasses.replace(epc, etp=True)
        # 1) the full-depth program under the tracker: the memory fields
        mem = _run_variant(cfg, spec, mesh, rules, epc, splitkv, arch,
                           memory=True, **kw)
        # 2) cost: two probes and linear extrapolation, as JAX prices
        plan = cfg.layer_plan()
        if probes and plan.n_periods >= 2:
            r1, r2 = (_run_variant(_probe_cfg(cfg, n), spec, mesh, rules,
                                   epc, splitkv, arch, **kw) for n in (1, 2))
            cost, cbytes = _extrapolate((r1["cost"], r1["collectives"]),
                                        (r2["cost"], r2["collectives"]),
                                        plan.n_periods)
            bounded = sorted(set(r1["bounded"]) | set(r2["bounded"]))
        else:
            r = _run_variant(cfg, spec, mesh, rules, epc, splitkv, arch, **kw)
            cost, cbytes, bounded = r["cost"], r["collectives"], r["bounded"]
        replicated = _replicated_pieces(cfg, spec, mesh, rules, epc)
    price_s = time.perf_counter() - t0
    terms = hlo.roofline(cost, cbytes, chips, hardware)
    hbm = {"TPUv5e": 16e9, "H100": 80e9}.get(hardware)

    spec_model = modelspec.ALL_MODELS.get(arch)
    n_active = (spec_model.total_params if spec_model and
                spec_model.total_params else cfg.param_count())
    if cfg.is_moe:
        n_active = cfg.active_param_count()
    mflops = hlo.model_flops(n_active, shp.tokens_processed(cfg, spec),
                             train=spec.kind == "train")
    mflops_dev = mflops / chips
    hlo_flops_dev = max(terms.flops_dev, 1.0)
    peak = (mem["argument_bytes_dev"] + mem["output_bytes_dev"]
            + mem["temp_bytes_dev"] - mem["alias_bytes_dev"])
    return {
        **base,
        "status": "ok",
        "rules": rules_name or ("train" if spec.kind == "train" else "serve"),
        "chips": chips,
        "hardware": hardware,
        "price_s": round(price_s, 1),
        "memory": {
            **mem,
            "code_bytes_dev": 0,
            "peak_bytes_dev": peak,
            "fits_v5e_16g": peak < 16e9,
            "fits": {"hardware": hardware, "hbm_bytes": hbm,
                     "fits": None if hbm is None else peak < hbm},
        },
        "cost": {"flops_dev": terms.flops_dev, "bytes_dev": terms.bytes_dev},
        "collectives": {"operand_bytes": cbytes.operand_bytes,
                        "link_bytes": cbytes.link_bytes,
                        "counts": cbytes.counts},
        "roofline": {
            "t_compute": terms.t_compute,
            "t_memory": terms.t_memory,
            "t_collective": terms.t_collective,
            "dominant": terms.dominant,
            "compute_fraction": terms.compute_fraction,
            "model_flops_dev": mflops_dev,
            "useful_flops_ratio": mflops_dev / hlo_flops_dev,
            "hint": hlo.improvement_hint(terms),
        },
        "bounded": bounded,
        "replicated": replicated,
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def load_results(path: str) -> Dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {"cells": {}}


def save_results(path: str, results: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


def cell_key(arch: str, shape: str, mesh: str, rules: Optional[str],
             splitkv: bool, variant: str = "") -> str:
    suffix = "" if splitkv else ":nosplitkv"
    r = f":{rules}" if rules else ""
    v = f":{variant}" if variant else ""
    return f"{arch}|{shape}|{mesh}{r}{suffix}{v}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="single arch id (default all)")
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--rules", default=None, choices=list(RULE_SETS))
    ap.add_argument("--no-splitkv", action="store_true",
                    help="§Perf baseline: disable split-KV decode")
    ap.add_argument("--variant", default="",
                    help="'+'-joined §Perf levers: " + ", ".join(VARIANTS))
    ap.add_argument("--hardware", default="TPUv5e",
                    choices=sorted(hlo.PRICING),
                    help="pricing of the roofline terms (default TPUv5e, "
                         "JAX's)")
    ap.add_argument("--out", default=RESULTS_DEFAULT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else configs.ARCH_IDS
    shapes = [args.shape] if args.shape else list(shp.SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = load_results(args.out)
    failures = 0
    t_sweep = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                key = cell_key(arch, shape, mesh_name, args.rules,
                               not args.no_splitkv, args.variant)
                if key in results["cells"] and not args.force and \
                        results["cells"][key].get("status") in ("ok",
                                                                "skipped"):
                    print(f"[skip-cached] {key}")
                    continue
                print(f"[price] {key} ...", flush=True)
                t0 = time.time()
                try:
                    rec = lower_cell(arch, shape, multi, args.rules,
                                     splitkv=not args.no_splitkv,
                                     variant=args.variant,
                                     hardware=args.hardware)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                rec["wall_s"] = round(time.time() - t0, 1)
                results["cells"][key] = rec
                save_results(args.out, results)
                status = rec.get("status")
                if status == "ok":
                    r = rec["roofline"]
                    print(f"  ok {rec['wall_s']}s dominant={r['dominant']} "
                          f"tc={r['t_compute']:.2e} tm={r['t_memory']:.2e} "
                          f"tl={r['t_collective']:.2e} "
                          f"peak={rec['memory']['peak_bytes_dev']/1e9:.2f}GB",
                          flush=True)
                elif status == "skipped":
                    print(f"  skipped: {rec['reason']}")
                else:
                    print(f"  ERROR: {rec.get('error')}")
    print(f"done in {time.perf_counter() - t_sweep:.1f}s; {failures} "
          "failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
