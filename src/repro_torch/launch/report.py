"""Render results/dryrun.json into the §Dry-run/§Roofline tables and pick
the §Perf hillclimb candidates. Counterpart of ``repro.launch.report``:
on the same records it prints the same lines.

    PYTHONPATH=src python -m repro_torch.launch.report [results/dryrun.json]
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x: float) -> str:
    if x >= 1e9:
        return f"{x/1e9:.2f}GB"
    if x >= 1e6:
        return f"{x/1e6:.1f}MB"
    return f"{x/1e3:.0f}kB"


def load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)["cells"]


def roofline_table(cells: Dict, mesh: str = "single",
                   variant_suffix: str = "") -> List[str]:
    rows = ["| arch | shape | t_comp | t_mem | t_coll | dominant | "
            "roofline frac | useful/HLO | peak GB/dev | fits v5e |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for key in sorted(cells):
        parts = key.split("|")
        if len(parts) != 3 or parts[2] != mesh + variant_suffix:
            continue
        c = cells[key]
        if c.get("status") == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"skipped | — | — | — | — |")
            continue
        if c.get("status") != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"ERROR | — | — | — | — |")
            continue
        r = c["roofline"]
        m = c["memory"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['t_compute'])} | "
            f"{fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} | "
            f"{r['dominant']} | {r['compute_fraction']:.3f} | "
            f"{min(r['useful_flops_ratio'], 99):.2f} | "
            f"{m['peak_bytes_dev']/1e9:.2f} | "
            f"{'yes' if m['fits_v5e_16g'] else 'NO'} |")
    return rows


def dryrun_table(cells: Dict) -> List[str]:
    rows = ["| cell | mesh | status | compile s | peak GB/dev | "
            "collectives (count) |",
            "|---|---|---|---|---|---|"]
    for key in sorted(cells):
        c = cells[key]
        mesh = c.get("mesh", "?")
        if c.get("status") == "ok":
            counts = c["collectives"]["counts"]
            cc = ", ".join(f"{k.split('-')[-1][:4]}:{v}"
                           for k, v in counts.items() if v)
            rows.append(f"| {c['arch']}×{c['shape']} | {mesh} | ok | "
                        f"{c.get('compile_s', '—')} | "
                        f"{c['memory']['peak_bytes_dev']/1e9:.2f} | {cc} |")
        else:
            rows.append(f"| {c['arch']}×{c['shape']} | {mesh} | "
                        f"{c.get('status')} | — | — | "
                        f"{c.get('reason', c.get('error', ''))[:60]} |")
    return rows


def pick_hillclimb(cells: Dict) -> List[str]:
    """The three §Perf pairs: worst roofline fraction, most
    collective-bound, most representative of the paper's technique."""
    ok = {k: c for k, c in cells.items()
          if c.get("status") == "ok" and c["mesh"] == "single"
          and len(k.split("|")) == 3}
    worst = min(ok.items(),
                key=lambda kv: kv[1]["roofline"]["compute_fraction"])
    coll = max(ok.items(),
               key=lambda kv: kv[1]["roofline"]["t_collective"] /
               max(kv[1]["roofline"]["t_compute"] +
                   kv[1]["roofline"]["t_memory"], 1e-12))
    # paper-representative: MoE decode (the AFD/EP grouped-GEMM stage)
    moe_decode = [kv for kv in ok.items()
                  if kv[1]["arch"] in ("kimi-k2-1t-a32b",
                                       "granite-moe-1b-a400m",
                                       "jamba-v0.1-52b")
                  and kv[1]["shape"] == "decode_32k"]
    rep = max(moe_decode,
              key=lambda kv: kv[1]["roofline"]["t_collective"]) \
        if moe_decode else worst
    out = []
    for label, (k, c) in [("worst-roofline-fraction", worst),
                          ("most-collective-bound", coll),
                          ("paper-representative", rep)]:
        r = c["roofline"]
        out.append(f"* **{label}** — `{k}`: fraction "
                   f"{r['compute_fraction']:.3f}, dominant {r['dominant']} "
                   f"({r['hint']})")
    return out


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.json"
    cells = load(path)
    print("## §Roofline — single-pod (16×16 = 256 chips)\n")
    print("\n".join(roofline_table(cells, "single")))
    print("\n## §Roofline — multi-pod (2×16×16 = 512 chips)\n")
    print("\n".join(roofline_table(cells, "multi")))
    print("\n## Hillclimb candidates\n")
    print("\n".join(pick_hillclimb(cells)))


if __name__ == "__main__":
    main()
