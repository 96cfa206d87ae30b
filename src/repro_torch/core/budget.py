"""Budget-based HFU analysis (paper §2.2–§2.3, Eqs. 1–8).

A copy of ``repro.core.budget`` (the port imports nothing of ``repro``).

The run-batch latency ``T = SLO × L_accept`` is split into a fixed gap ``t_g``
(batch preparation + dense/non-3BO layers) and ``N_layers × N_BO`` stage
budgets ``t_B``:

    T = t_g + N_layers · N_BO · t_B                       (Eq. 1)
    max(t_a, t_f, t_c) ≤ t_B                              (Eq. 2)
    2·t_a ≥ t_f + t_c ;  2·t_f ≥ t_a + t_c                (Eqs. 3–4, bubble-free)
    S_t  = t_G / t_B                                      (Eq. 6)
    OFU  = FLOPs / t_G / peak                             (Eq. 7, normalised)
    HFU  = FLOPs / t_B / peak = OFU × S_t                 (Eq. 8)

Everything here is a pure function of scenario scalars so the planner,
benchmarks, and property tests can all share it.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.modelspec import MoEModelSpec

# Token payload on the wire (Eq. 17): fp8 dispatch (1 B/elem) + bf16 combine
# (2 B/elem) per hidden element.
DISPATCH_BYTES_PER_ELEM = 1
COMBINE_BYTES_PER_ELEM = 2
WIRE_BYTES_PER_ELEM = DISPATCH_BYTES_PER_ELEM + COMBINE_BYTES_PER_ELEM  # = 3

# Expert-weight residency widths (bytes per parameter). The paper's Eq. 6
# analysis assumes fp8 (1 B) expert weights; the kernel layer now also ships
# int8 and packed-int4 paths (kernels/grouped_gemm.py), and each width moves
# the grouped GEMM's arithmetic intensity — and with it the dead-zone
# boundary — by scaling Mem = 3·G·H·M·bytes_per_param.
WEIGHT_BYTES_PER_PARAM = {
    "f32": 4.0,
    "bf16": 2.0,
    "f16": 2.0,
    "fp8": 1.0,
    "int8": 1.0,
    "int4": 0.5,
}


def weight_bytes_per_param(dtype_name: str) -> float:
    """Bytes per expert-weight parameter for a named storage width."""
    try:
        return WEIGHT_BYTES_PER_PARAM[dtype_name]
    except KeyError:
        raise ValueError(
            f"unknown weight dtype {dtype_name!r}; expected one of "
            f"{sorted(WEIGHT_BYTES_PER_PARAM)}") from None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Deployment scenario (paper Fig. 4 assumptions by default)."""
    slo_tpot: float = 0.05        # s per output token (TPOT SLO)
    l_accept: float = 1.7         # MTP average acceptance length
    t_gap: float = 0.015          # t_g: inter-batch gap + non-3BO layers (s)
    n_bo: int = 3                 # batch-overlap cardinality (3BO for AFD)

    @property
    def run_batch_latency(self) -> float:
        """T = SLO × L_accept (Eq. 1 LHS)."""
        return self.slo_tpot * self.l_accept


def stage_budget(model: MoEModelSpec, scen: Scenario) -> float:
    """t_B from Eq. 1: (T − t_g) / (N_layers · N_BO).

    ``N_layers`` counts the layers forwarded in BO mode (the MoE layers for
    MoE models; all layers for dense models where the pipeline still runs).
    """
    n_layers = model.n_moe_layers if model.is_moe else model.n_layers
    t_avail = scen.run_batch_latency - scen.t_gap
    if t_avail <= 0:
        raise ValueError(
            f"gap t_g={scen.t_gap} exceeds run-batch latency "
            f"T={scen.run_batch_latency}")
    return t_avail / (n_layers * scen.n_bo)


def grouped_gemm_flops(n_groups: int, tokens_per_group: float,
                       hidden: int, inter: int) -> float:
    """FLOPs of the two grouped GEMMs (paper §3.2): 6·G·B·H·M.

    Fused up+gate projection (H → 2M): 2·B·H·2M = 4·B·H·M, plus down
    projection (M → H): 2·B·M·H — totalling 6·B·H·M per group.
    """
    return 6.0 * n_groups * tokens_per_group * hidden * inter


def grouped_gemm_bytes(n_groups: int, hidden: int, inter: int,
                       bytes_per_param: float = 1.0) -> float:
    """Weight bytes of the two grouped GEMMs (paper §3.2): Mem = 3·G·H·M·w.

    3·H·M per expert = fused up+gate (H·2M) + down (M·H) at ``bytes_per_param``
    bytes per element (1.0 = the paper's fp8 assumption; see
    WEIGHT_BYTES_PER_PARAM for the quantized-kernel widths); activation
    tensors neglected (paper §2.3).
    """
    return 3.0 * n_groups * hidden * inter * bytes_per_param


def gemm_time_roofline(flops: float, mem_bytes: float, hw: HardwareSpec,
                       ofu_cap: float = 1.0) -> float:
    """t_G under the classic roofline: max(compute time, memory time)."""
    t_compute = flops / (hw.peak_flops * ofu_cap)
    t_memory = mem_bytes / hw.hbm_bw
    return max(t_compute, t_memory)


@dataclasses.dataclass(frozen=True)
class StageMetrics:
    """OFU / S_t / HFU for one FFN stage inside its t_B window (Eqs. 6–8)."""
    flops: float
    t_gemm: float
    t_budget: float
    peak_flops: float

    @property
    def ofu(self) -> float:
        return self.flops / self.t_gemm / self.peak_flops if self.t_gemm > 0 else 0.0

    @property
    def temporal_sparsity(self) -> float:
        return self.t_gemm / self.t_budget

    @property
    def hfu(self) -> float:
        return self.flops / self.t_budget / self.peak_flops

    def check(self) -> None:
        assert self.t_gemm <= self.t_budget * (1 + 1e-9), "stage overruns budget"


def ffn_stage_metrics(model: MoEModelSpec, hw: HardwareSpec,
                      tokens_per_rank: float, local_experts: int,
                      t_budget: float,
                      weight_bytes: float = 1.0) -> StageMetrics:
    """Metrics for one rank's MoE stage given its token inflow within t_B."""
    g = max(local_experts, 1)
    b_per_expert = tokens_per_rank / g
    flops = grouped_gemm_flops(g, b_per_expert, model.hidden_size,
                               model.moe_intermediate)
    mem = grouped_gemm_bytes(g, model.hidden_size, model.moe_intermediate,
                             bytes_per_param=weight_bytes)
    t_gemm = gemm_time_roofline(flops, mem, hw)
    return StageMetrics(flops=flops, t_gemm=t_gemm, t_budget=t_budget,
                        peak_flops=hw.peak_flops)
