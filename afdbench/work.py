"""The benchmark's own work arithmetic: operations and bytes of each
kernel call, the card's peaks, and the model FLOPs of a served token.

The three ``*_work`` functions are frozen copies of
``repro_torch.kernels.ops``'s (each input read once, the output written
once; visited experts and live keys only). They take a ``Call``: the
shapes and element sizes the kernel front door was called with, and the
values the work depends on (group sizes, lengths) read back after the
window. A roofline share is the least time the card could take (the
larger of FLOPs over the peak rate and bytes over the peak bandwidth)
over the device time measured.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


class ShareAbove100(ValueError):
    """A roofline or peak share read above 100%: the work is counted too
    high, or the time leaves out part of it."""


@dataclasses.dataclass
class Call:
    """One call at the kernel front door: ``kind`` is ``grouped_gemm``,
    ``splitkv`` or ``flash_prefill``; ``shapes`` and ``sizes`` (element
    bytes) of the named inputs; ``values`` the data the work depends on
    (numpy or lists, filled in after the window); ``args`` the scalars."""
    kind: str
    shapes: Dict[str, Tuple[int, ...]]
    sizes: Dict[str, int]
    values: Dict[str, object] = dataclasses.field(default_factory=dict)
    args: Dict[str, object] = dataclasses.field(default_factory=dict)


def _nbytes(call: Call, *names: str) -> int:
    out = 0
    for n in names:
        shape = call.shapes.get(n)
        if shape is not None:
            numel = 1
            for s in shape:
                numel *= int(s)
            out += numel * call.sizes[n]
    return out


def grouped_gemm_work(call: Call) -> Tuple[int, int]:
    """2·K·N per routed row (rows past the routed count are written as
    zeros); lhs, the index vectors and the group sizes read once, each
    visited expert's weights (and scales) once, the output written once."""
    lhs, rhs = call.shapes["lhs"], call.shapes["rhs"]
    ri = call.shapes.get("row_index")
    m = lhs[0] if ri is None else ri[0]
    k, n = lhs[1], rhs[2]
    sizes = [int(s) for s in call.values["group_sizes"]]
    routed = min(sum(sizes), m)
    visited = sum(1 for s in sizes if s > 0)
    expert = rhs[1] * rhs[2] * call.sizes["rhs"]
    if call.shapes.get("scales") is not None:
        sc = call.shapes["scales"]
        expert += (sc[1] if len(sc) > 1 else 1) * call.sizes["scales"]
    out_rows = call.args.get("out_rows")
    n_out = m if call.shapes.get("out_index") is None or out_rows is None \
        else int(out_rows)
    nbytes = (_nbytes(call, "lhs", "row_index", "out_index", "group_sizes")
              + visited * expert + n_out * n * call.sizes["lhs"])
    return 2 * routed * k * n, nbytes


def splitkv_work(call: Call) -> Tuple[int, int]:
    """4·d per live key and query head; q, the live keys' K and V rows and
    the lengths read once, the output (and LSE) written once."""
    b, hq, d = call.shapes["q"]
    t, hkv = call.shapes["k"][1], call.shapes["k"][2]
    live = sum(min(max(int(x), 0), t) for x in call.values["lengths"])
    lse = b * hq * 4 if call.args.get("return_lse") else 0
    nbytes = (2 * _nbytes(call, "q") + 2 * live * hkv * d * call.sizes["k"]
              + _nbytes(call, "lengths") + lse)
    return 4 * live * hq * d, nbytes


def flash_prefill_work(call: Call) -> Tuple[int, int]:
    """4·d per live (query row, key) pair and query head; q, the live KV
    prefix and the output once."""
    b, s, hq, d = call.shapes["q"]
    t, hkv = call.shapes["k"][1], call.shapes["k"][2]
    tv = t if call.args.get("t_valid") is None else min(
        int(call.args["t_valid"]), t)
    causal = call.args.get("causal", True)
    window = call.args.get("window")
    q_offset = int(call.args.get("q_offset", 0))
    keys = 0
    for j in range(s):
        row = q_offset + j
        hi = min(tv, row + 1) if causal else tv
        lo = max(0, row - window + 1) if window is not None else 0
        keys += max(hi - lo, 0)
    nbytes = 2 * _nbytes(call, "q") + 2 * b * tv * hkv * d * call.sizes["k"]
    return 4 * b * keys * hq * d, nbytes


WORK = {"grouped_gemm": grouped_gemm_work, "splitkv": splitkv_work,
        "flash_prefill": flash_prefill_work}


def bound_s(flops: int, nbytes: int) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)


def share_pct(least_s: float, measured_s: float, what: str) -> Optional[float]:
    """``least_s`` over ``measured_s`` in percent; None where nothing was
    measured. Above 100% (plus rounding) the run fails: the work is counted
    too high or the time misses part of it."""
    if measured_s <= 0 or least_s <= 0:
        return None
    pct = 100.0 * least_s / measured_s
    if pct > 100.0 + 1e-9:
        raise ShareAbove100(f"{what} reads {pct:.4f}% of its bound "
                            f"({least_s:.6e} s of least time in "
                            f"{measured_s:.6e} s measured)")
    return pct


# ---------------------------------------------------------------------------
# Model FLOPs of a served token (step_mfu)
# ---------------------------------------------------------------------------

def layer_kinds(arch: dict) -> Sequence[Tuple[str, str]]:
    """(mixer, ffn) per layer from the configuration's sizes: mixer
    ``attn`` or ``mamba``, ffn ``moe``, ``mlp`` or ``none`` (the layer
    plan of ``ArchConfig``)."""
    out = []
    ssm = arch.get("ssm_state", 0)
    n_exp = arch.get("n_experts", 0)
    for i in range(arch["n_layers"]):
        if ssm == 0:
            mixer = "attn"
        else:
            per = arch.get("attn_layer_period", 1)
            mixer = ("attn" if per > 0 and i % per ==
                     arch.get("attn_layer_offset", 0) else "mamba")
        off, per = arch.get("moe_layer_offset", 0), arch.get(
            "moe_layer_period", 1)
        if n_exp > 1 and i >= off and (i - off) % per == 0:
            ffn = "moe"
        elif arch.get("d_ff", 0) > 0:
            ffn = "mlp"
        else:
            ffn = "none"
        out.append((mixer, ffn))
    return out


def token_flops(arch: dict, context: int) -> int:
    """Model FLOPs of one token whose attention sees ``context`` keys
    (itself included): 2 × the matmul parameters it is multiplied with
    (projections, the router, its top-k experts, dense FFNs, the LM head)
    plus 4 × d_head × heads × context per attention layer and the SSD
    recurrence's update and read-out (4 × heads × head_dim × d_state) per
    Mamba layer."""
    d = arch["d_model"]
    hq, hkv = arch["n_heads"], arch["n_kv_heads"]
    dh = arch.get("d_head") or d // hq
    params = 0
    attn = 0
    for mixer, ffn in layer_kinds(arch):
        if mixer == "attn":
            params += d * hq * dh * 2 + d * hkv * dh * 2
            attn += 4 * dh * hq * context
        else:
            di = arch.get("ssm_expand", 2) * d
            n, g = arch["ssm_state"], arch.get("ssm_groups", 1)
            heads = di // arch.get("ssm_head_dim", 64)
            params += d * (2 * di + 2 * g * n + heads) + di * d
            params += arch.get("ssm_conv", 4) * (di + 2 * g * n)
            attn += 4 * di * n
        if ffn == "moe":
            params += d * arch["n_experts"]
            params += arch["top_k"] * 3 * d * arch["moe_d_ff"]
            if arch.get("n_shared_experts", 0):
                params += 3 * d * (arch.get("shared_d_ff") or arch["moe_d_ff"]
                                   ) * arch["n_shared_experts"]
        elif ffn == "mlp":
            params += 3 * d * arch["d_ff"]
    params += d * arch["vocab_size"]                # LM head
    return 2 * params + attn
