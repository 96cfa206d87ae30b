"""AFD deployment planner (paper §4 turned into an executable policy).

A copy of ``repro.core.planner`` (the port imports nothing of ``repro``).

Given (model, hardware, scenario) the planner:

  1. sweeps N_F with the communication-extended roofline (`hfu_bound`),
     keeping only memory-feasible points;
  2. sizes the attention fleet N_A so it produces exactly the token stream
     the FFN fleet can absorb within each t_B window (decode-attention is
     modelled with its own compute/memory roofline);
  3. validates SLO (Eq. 2) and the bubble-free constraints (Eqs. 3–5);
  4. under measured imbalance σ, elastically rescales N_A in *discrete node
     units* choosing floor/ceil by Eq. 16 — the paper's quantization penalty
     as a live policy;
  5. reports the AFD-vs-EP verdict of §4/Table 3 for this combination.

The planner is pure (no jax) so the serving scheduler can call it on every
re-plan tick.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.core import budget as bdg
from repro_torch.core import hfu_bound as hb
from repro_torch.core import imbalance as imb
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec


@dataclasses.dataclass(frozen=True)
class AttentionProfile:
    """Decode-attention cost model per token per layer.

    n_kv_ratio: n_kv_heads / n_heads (GQA factor); kv_bytes: bytes per KV
    element (2 = bf16). Costs follow the standard decode breakdown:
      projections   ≈ 4·H²·(1 + n_kv_ratio)/2 FLOPs  (q,o full; k,v GQA-thin)
      score/update  ≈ 4·H·S FLOPs over context S
      KV traffic    ≈ 2·(n_kv_ratio·H)·S·kv_bytes read per token
    """
    hidden: int
    context_len: int = 4096
    n_kv_ratio: float = 0.25
    kv_bytes: int = 2
    weight_bytes: int = 1        # fp8-resident projection weights

    def flops_per_token_layer(self) -> float:
        h = float(self.hidden)
        proj = 4.0 * h * h * (1.0 + self.n_kv_ratio) / 2.0 * 2.0
        attn = 4.0 * h * self.context_len
        return proj + attn

    def bytes_per_token_layer(self) -> float:
        """Per-token memory traffic: KV read dominates decode."""
        kv = 2.0 * self.n_kv_ratio * self.hidden * self.context_len * self.kv_bytes
        return kv

    def weight_bytes_per_layer(self) -> float:
        h = float(self.hidden)
        return (2.0 + 2.0 * self.n_kv_ratio) * h * h * self.weight_bytes


@dataclasses.dataclass(frozen=True)
class AFDPlan:
    model: str
    hardware: str
    n_f: int                    # FFN nodes
    n_a: int                    # attention nodes
    lambda_afd: float           # N_A / N_F
    t_budget: float             # t_B (s)
    b_rank: float               # tokens per FFN rank per t_B (Eq. 9)
    ffn_tokens_total: float     # tokens absorbed per t_B by the FFN fleet
    attn_tokens_per_node: float
    hfu: float                  # FFN-stage HFU upper bound at this N_F
    ofu: float
    temporal_sparsity: float
    regime: str
    bottleneck: str
    memory_ok: bool
    slo_ok: bool
    bubble_free: bool           # Eqs. 3–4 satisfied at the planned point
    total_nodes: int = 0

    @property
    def throughput_per_node(self) -> float:
        """Tokens per second per node — the §3.3 comparison metric."""
        n = self.n_a + self.n_f
        return self.ffn_tokens_total / self.t_budget / n if n else 0.0


class PlanningError(ValueError):
    pass


def attention_tokens_per_node(model: MoEModelSpec, hw: HardwareSpec,
                              t_budget: float,
                              prof: Optional[AttentionProfile] = None) -> float:
    """Tokens one attention node can forward through ONE layer within t_B.

    Decode attention rooflines between compute and HBM; per-token stage time
    is max(flops/peak, bytes/hbm_bw), and a node has g chips.
    """
    prof = prof or AttentionProfile(hidden=model.hidden_size)
    per_tok = max(prof.flops_per_token_layer() / hw.peak_flops,
                  prof.bytes_per_token_layer() / hw.hbm_bw)
    if per_tok <= 0:
        raise PlanningError("degenerate attention profile")
    return hw.gpus_per_node * t_budget / per_tok


def plan_afd(model: MoEModelSpec, hw: HardwareSpec,
             scen: Optional[bdg.Scenario] = None,
             prof: Optional[AttentionProfile] = None,
             n_f: Optional[int] = None,
             max_total_nodes: int = 512,
             weight_bytes: float = 1.0) -> AFDPlan:
    """Produce the best AFD plan (or the plan at a forced ``n_f``).

    ``weight_bytes`` is the expert-weight width in bytes/param (Eq. 6's Mem
    term and the HBM feasibility test both scale with it — quantized expert
    kernels change which N_F the planner picks, not just how fast it runs).
    """
    if not model.is_moe:
        raise PlanningError(
            f"{model.name} has no routed experts; AFD degenerates to a dense "
            "pipeline split — see DESIGN.md §Arch-applicability")
    scen = scen or bdg.Scenario()
    t_b = bdg.stage_budget(model, scen)
    prof = prof or AttentionProfile(hidden=model.hidden_size)

    candidates = ([n_f] if n_f is not None else
                  [p.n_f for p in hb.hfu_sweep(model, hw, scen,
                                               weight_bytes=weight_bytes)
                   if p.feasible])
    if not candidates:
        raise PlanningError(
            f"{model.name} expert weights do not fit any N_F ≤ sweep limit "
            f"on {hw.name} (HBM-infeasible, cf. paper's 'HBM -' annotations)")

    best: Optional[AFDPlan] = None
    for cand in candidates:
        pt = hb.hfu_point(model, hw, cand, scen, weight_bytes=weight_bytes)
        ffn_tokens = pt.b_rank * cand * hw.gpus_per_node
        a_tok = attention_tokens_per_node(model, hw, t_b, prof)
        n_a = max(1, math.ceil(ffn_tokens / a_tok))
        if n_a + cand > max_total_nodes:
            continue
        # Eqs. 3–4 with t_a ≈ t_f ≈ t_B by construction; t_c ≤ t_B iff the
        # interconnect delivers b_rank within the window — true by Eq. 9.
        t_a = ffn_tokens / n_a / a_tok * t_b  # realised attention stage time
        t_f = pt.temporal_sparsity * t_b
        t_c = t_b  # worst case: the link is exactly saturated
        bubble_free = (2 * t_a >= t_f + t_c - 1e-12 and
                       2 * t_f >= t_a + t_c - 1e-12)
        plan = AFDPlan(
            model=model.name, hardware=hw.name, n_f=cand, n_a=n_a,
            lambda_afd=n_a / cand, t_budget=t_b, b_rank=pt.b_rank,
            ffn_tokens_total=ffn_tokens, attn_tokens_per_node=a_tok,
            hfu=pt.hfu, ofu=pt.ofu, temporal_sparsity=pt.temporal_sparsity,
            regime=pt.regime, bottleneck=pt.bottleneck,
            memory_ok=pt.feasible, slo_ok=max(t_a, t_f) <= t_b * (1 + 1e-9),
            bubble_free=bubble_free, total_nodes=n_a + cand)
        if best is None or plan.throughput_per_node > best.throughput_per_node:
            best = plan
    if best is None:
        raise PlanningError("no feasible AFD plan within the node budget")
    return best


@dataclasses.dataclass(frozen=True)
class RescaleDecision:
    sigma: float
    old_n_a: int
    new_n_a: int
    rounding: str               # "exact" | "floor" | "ceil"
    alpha: float                # realised throughput factor (Eq. 16)
    alpha_ep_reference: float   # what large-scale EP would retain (Eq. 12)


def elastic_rescale(plan: AFDPlan, sigma: float) -> RescaleDecision:
    """§3.3 as a policy: shrink the attention fleet under imbalance σ.

    Chooses floor vs ceil of σ·N_A by maximising Eq. 16's α; reports the EP
    reference (same λ) so the scheduler can log the AFD deficit.
    """
    x = sigma * plan.n_a
    a_floor = imb.alpha_afd_floor(sigma, plan.n_a, plan.n_f)
    a_ceil = imb.alpha_afd_ceil(sigma, plan.n_a, plan.n_f)
    if abs(x - round(x)) < 1e-9:
        new_n_a, rounding = round(x), "exact"
        alpha = imb.alpha_afd_exact(sigma, plan.n_a, plan.n_f)
    elif a_floor >= a_ceil:
        new_n_a, rounding, alpha = math.floor(x), "floor", a_floor
    else:
        new_n_a, rounding, alpha = math.ceil(x), "ceil", a_ceil
    new_n_a = max(1, min(int(new_n_a), plan.n_a))
    return RescaleDecision(
        sigma=sigma, old_n_a=plan.n_a, new_n_a=new_n_a, rounding=rounding,
        alpha=alpha, alpha_ep_reference=imb.alpha_ep(sigma, plan.lambda_afd))


@dataclasses.dataclass(frozen=True)
class NFRescaleDecision:
    """§3.3 applied to the FFN fleet: the discrete N_F re-plan decision.

    Under measured load fraction σ (demand / provisioned capacity, may
    exceed 1 under overload), the ideal *continuous* fleet is σ·N_F — EP's
    batch adjustment tracks it exactly (α = 1). AFD must pick an integer,
    paying the quantization penalty the paper prices: α(n) = min(n/x, x/n)
    (saturated → serves n/x of demand; over-provisioned → utilization x/n).
    """
    sigma: float
    old_n_f: int
    new_n_f: int
    rounding: str               # "exact" | "floor" | "ceil"
    alpha_stay: float           # α of keeping the current N_F
    alpha_new: float            # α of the best discrete choice
    alpha_continuous: float     # EP-style continuous reference (= 1)
    penalty: float              # 1 − alpha_stay: what staying put costs
    residual_penalty: float     # 1 − alpha_new: what rounding still costs
    threshold: float            # predicted dead-zone penalty threshold
    triggered: bool             # penalty > threshold and a move exists


def nf_quantization_threshold(n_f: int) -> float:
    """Predicted dead-zone penalty threshold at fleet size ``n_f``.

    The worst-case rounding loss sits at half-integer demand x = k + ½
    where the best discrete α ≈ (k+½)/(k+1), i.e. a penalty ≈ ½/(N_F+1).
    A measured penalty beyond half that bound cannot be explained by
    unavoidable quantization alone — the fleet is mis-provisioned and a
    discrete re-plan is worth its cost.
    """
    return 0.25 / (n_f + 1)


def rescale_n_f(plan: AFDPlan, sigma: float,
                threshold: Optional[float] = None) -> NFRescaleDecision:
    """Decide whether measured load σ warrants a discrete N_F re-plan.

    The fleet rescaler calls this per window; the decision is pure and
    deterministic so fleet runs (and the fleet-smoke golden) can recompute
    it from the recorded (σ, old N_F, threshold) and demand agreement.
    """
    if sigma <= 0:
        raise PlanningError(f"load fraction must be positive, got {sigma}")
    x = sigma * plan.n_f

    def alpha(n: int) -> float:
        return min(n / x, x / n)

    lo = max(1, math.floor(x))
    hi = max(1, math.ceil(x))
    if lo == hi:
        new_n_f, rounding = lo, "exact"
    elif alpha(lo) >= alpha(hi):
        new_n_f, rounding = lo, "floor"
    else:
        new_n_f, rounding = hi, "ceil"
    a_stay = alpha(plan.n_f)
    a_new = alpha(new_n_f)
    thr = (nf_quantization_threshold(plan.n_f) if threshold is None
           else threshold)
    penalty = 1.0 - a_stay
    return NFRescaleDecision(
        sigma=sigma, old_n_f=plan.n_f, new_n_f=new_n_f, rounding=rounding,
        alpha_stay=a_stay, alpha_new=a_new, alpha_continuous=1.0,
        penalty=penalty, residual_penalty=1.0 - a_new, threshold=thr,
        triggered=penalty > thr and new_n_f != plan.n_f)


# ---------------------------------------------------------------------------
# Live measurement ↔ prediction (the serving engines check the paper's
# analytics against what the two-role runtime actually did)
# ---------------------------------------------------------------------------

def predict_m2n_cycle_bytes(n_tokens: int, hidden: int, top_k: int,
                            dtype_bytes: int = 4, gate_bytes: int = 4,
                            idx_bytes: int = 4) -> tuple:
    """(dispatch, combine) bytes of ONE M2N cycle at the engine's dtypes.

    The Eq. 17 wire model evaluated at what the runtime actually ships:
    per cycle ``n_tokens`` hidden vectors each way plus the gating metadata
    (top-k weights + indices) on the dispatch leg. Must stay in lockstep
    with ``parallel.afd.AFDStats.record`` — the serving engine asserts the
    measured counters match this prediction *exactly* per window.
    """
    payload = n_tokens * hidden * dtype_bytes
    meta = n_tokens * top_k * (gate_bytes + idx_bytes)
    return payload + meta, payload


def predict_prefill_window_bytes(prefill_tokens: int, hidden: int,
                                 top_k: int, dtype_bytes: int = 4,
                                 gate_bytes: int = 4,
                                 idx_bytes: int = 4) -> tuple:
    """(dispatch, combine) bytes one MoE layer ships for a window's
    prefill work, for ANY chunking of those tokens.

    Eq. 17's cycle cost is an integer-linear function of the cycle's token
    count, so summing ``predict_m2n_cycle_bytes`` over chunks c_1..c_m
    with Σc_i = prefill_tokens equals evaluating it once at the total:
    the byte predictor prices token-by-token teacher forcing (m cycles of
    1) and batched chunked prefill (⌈S/C⌉ cycles of ≤C) *identically*,
    which is exactly why the engine's measured-vs-predicted equality keeps
    holding bit-exactly when chunking turns on.
    """
    return predict_m2n_cycle_bytes(prefill_tokens, hidden, top_k,
                                   dtype_bytes=dtype_bytes,
                                   gate_bytes=gate_bytes,
                                   idx_bytes=idx_bytes)


@dataclasses.dataclass(frozen=True)
class LiveHFU:
    """Measured FFN-stage operating point vs the Eq. 9 plan, per window."""
    window_s: float
    tokens_routed: float          # tokens through one MoE stage this window
    tokens_per_rank_per_tb: float # measured inflow in Eq. 9's units
    b_rank_predicted: float       # the plan's Eq. 9 cap
    utilization: float            # measured inflow / Eq. 9 cap
    hfu_measured: float           # Eqs. 6–8 at the measured inflow
    hfu_predicted: float          # the plan's HFU at the Eq. 9 inflow


def live_hfu(model: MoEModelSpec, hw: HardwareSpec, plan: AFDPlan,
             tokens_routed: float, window_s: float,
             scen: Optional[bdg.Scenario] = None) -> LiveHFU:
    """Price a measured serving window against the plan's Eq. 9 prediction.

    Converts the window's routed-token count into Eq. 9 units (tokens per
    FFN rank per stage budget t_B) and re-evaluates the §3.2 HFU chain at
    that *measured* inflow (via the ``b_cap`` mechanism, which caps Eq. 9 at
    the observed operating point). ``hfu_measured ≤ hfu_predicted`` always:
    the Eq. 9 cap is an upper bound, so a live engine can only surface the
    dead zone, never escape it.
    """
    scen = scen or bdg.Scenario()
    if window_s <= 0:
        raise PlanningError(f"window must be positive, got {window_s}")
    ranks = plan.n_f * hw.gpus_per_node
    tb_windows = window_s / plan.t_budget
    per_rank = tokens_routed / tb_windows / ranks
    measured = hb.hfu_point(model, hw, plan.n_f, scen, b_cap=per_rank)
    return LiveHFU(
        window_s=window_s, tokens_routed=tokens_routed,
        tokens_per_rank_per_tb=per_rank, b_rank_predicted=plan.b_rank,
        utilization=per_rank / plan.b_rank if plan.b_rank else 0.0,
        hfu_measured=measured.hfu, hfu_predicted=plan.hfu)


@dataclasses.dataclass(frozen=True)
class Verdict:
    """§4 Table 3 as a computed recommendation."""
    model: str
    hardware: str
    afd_hfu_ceiling: float
    ep_reference_hfu: float
    granularity: float          # H / M (coarser = smaller)
    sparsity: float             # N_experts / TopK
    superpod: bool
    afd_recommended: bool
    reasons: tuple


def afd_verdict(model: MoEModelSpec, hw: HardwareSpec,
                scen: Optional[bdg.Scenario] = None) -> Verdict:
    scen = scen or bdg.Scenario()
    ceiling = hb.hfu_ceiling(model, hw, scen, feasible_only=False)
    reasons = []
    favourable = 0
    if hw.superpod:
        favourable += 1
        reasons.append("superpod scale-up fabric removes the scale-out cap")
    if model.granularity <= 4.0:
        favourable += 1
        reasons.append(f"coarse experts (H/M = {model.granularity:.2f})")
    if model.sparsity <= 16.0:
        favourable += 1
        reasons.append(f"low sparsity (E/TopK = {model.sparsity:.1f})")
    beats_ep = ceiling.hfu > hb.LARGE_EP_REFERENCE_HFU
    if beats_ep:
        reasons.append(
            f"AFD HFU ceiling {ceiling.hfu:.1%} above the "
            f"{hb.LARGE_EP_REFERENCE_HFU:.0%} large-EP reference")
    else:
        reasons.append(
            f"AFD HFU ceiling {ceiling.hfu:.1%} below the "
            f"{hb.LARGE_EP_REFERENCE_HFU:.0%} large-EP reference (dead zone)")
    return Verdict(
        model=model.name, hardware=hw.name, afd_hfu_ceiling=ceiling.hfu,
        ep_reference_hfu=hb.LARGE_EP_REFERENCE_HFU,
        granularity=model.granularity, sparsity=model.sparsity,
        superpod=hw.superpod,
        afd_recommended=beats_ep and favourable >= 1,
        reasons=tuple(reasons))


def plan_table(models: List[MoEModelSpec], hws: List[HardwareSpec],
               scen: Optional[bdg.Scenario] = None) -> List[Verdict]:
    return [afd_verdict(m, h, scen) for m in models for h in hws if m.is_moe]
