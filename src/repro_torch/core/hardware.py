"""Hardware system registry.

A copy of ``repro.core.hardware`` (the port imports nothing of ``repro``).

Reproduces Table 5 of the paper (NVIDIA platforms, used to check the paper's
own numbers exactly) and adds the TPU targets this repo compiles for.

Conventions (matching the paper):
  * ``peak_flops``          — peak dense FP8 (GPU) / bf16 (TPU) FLOP/s per chip.
  * ``hbm_bw``              — HBM bandwidth, bytes/s per chip.
  * ``hbm_cap``             — HBM capacity, bytes per chip.
  * ``scale_out_bw``        — per-chip scale-out (RDMA / DCN) unidirectional
                              bandwidth, bytes/s. ``None`` ⇒ Superpod (the
                              scale-up domain covers the whole deployment and
                              Eq. 9 collapses to the scale-up term).
  * ``scale_up_bw``         — per-chip scale-up (NVLink / ICI) unidirectional
                              sustained bandwidth, bytes/s.
  * ``gpus_per_node`` (g)   — deployment granularity of AFD roles.

The paper's footnote 3: peak-spec link numbers are derated to sustained
(H800 NVLink 200 → 160 GB/s); Table 5 already lists sustained values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

GB = 1e9
TB = 1e12
TFLOPS = 1e12


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # FLOP/s per chip (FP8 for GPUs, bf16 for TPUs)
    hbm_bw: float              # bytes/s
    hbm_cap: float             # bytes
    scale_up_bw: float         # bytes/s per chip, unidirectional, sustained
    scale_out_bw: Optional[float]  # bytes/s per chip; None => Superpod
    gpus_per_node: int = 8
    superpod: bool = False
    cost_per_device_hour: float = 0.0  # $/chip-hour, on-demand estimate

    @property
    def ridge_intensity(self) -> float:
        """Roofline ridge point (FLOP/byte): I* = peak / hbm_bw."""
        return self.peak_flops / self.hbm_bw

    @property
    def scale_up_over_out(self) -> float:
        """B_ScaleUp / B_ScaleOut ratio (∞ for Superpods)."""
        if self.superpod or self.scale_out_bw is None:
            return float("inf")
        return self.scale_up_bw / self.scale_out_bw


def _mk(name, peak_tflops, bw_tbs, cap_gb, up_gbs, out_gbs, g=8,
        superpod=False, usd_hr=0.0):
    return HardwareSpec(
        name=name,
        peak_flops=peak_tflops * TFLOPS,
        hbm_bw=bw_tbs * TB,
        hbm_cap=cap_gb * GB,
        scale_up_bw=up_gbs * GB,
        scale_out_bw=None if out_gbs is None else out_gbs * GB,
        gpus_per_node=g,
        superpod=superpod,
        cost_per_device_hour=usd_hr,
    )


# --- Table 5 of the paper (FP8 peak) -------------------------------------
# ``usd_hr``: rough 2025/2026 on-demand $/GPU-hour estimates (public cloud
# list-price ballpark; Hopper rentals 2-4 $/h, Blackwell 5-7 $/h, GB-series
# superchips priced per GPU in an NVL72 rack). These feed the provisioning
# $/token objective and are meant to be *overridden* per deployment via
# ``python -m repro provision --cost HW=PRICE`` — only their relative order
# matters for the Pareto frontier shape.
HARDWARE: Dict[str, HardwareSpec] = {
    "H20":   _mk("H20",   296,  4.0,  96, 360, 50, usd_hr=1.8),
    "H100":  _mk("H100", 1979, 3.35,  80, 360, 50, usd_hr=3.5),
    "H200":  _mk("H200", 1979, 4.0,  141, 360, 50, usd_hr=4.0),
    "H800":  _mk("H800", 1979, 3.35,  80, 160, 50, usd_hr=3.0),
    "B200":  _mk("B200", 4500, 7.7,  180, 720, 50, usd_hr=6.0),
    "B300":  _mk("B300", 4500, 8.0,  270, 720, 100, usd_hr=6.8),
    # Superpods: scale-out is the scale-up fabric (fully interconnected).
    "GB200": _mk("GB200", 4500, 7.7, 180, 720, None, superpod=True,
                 usd_hr=7.5),
    "GB300": _mk("GB300", 4500, 8.0, 270, 720, None, superpod=True,
                 usd_hr=8.5),
}

# --- TPU targets (bf16 peak) ----------------------------------------------
# v5e: 197 bf16 TFLOP/s, 819 GB/s HBM, 16 GB HBM, ~50 GB/s/link ICI with
# 4 links/chip on the 2-D torus; DCN between pods ≈ 25 GB/s/chip sustained.
# We treat ICI as "scale-up" and DCN as "scale-out" (see DESIGN.md §3).
# $/h: Cloud TPU on-demand per-chip list price ballpark.
HARDWARE["TPUv5e"] = _mk("TPUv5e", 197, 0.819, 16, 50, 25, g=8, usd_hr=1.2)
HARDWARE["TPUv5p"] = _mk("TPUv5p", 459, 2.765, 95, 100, 25, g=8, usd_hr=4.2)

# Dry-run / roofline constants mandated by the task brief.
TPU_V5E_PEAK_FLOPS = 197e12      # bf16 FLOP/s per chip
TPU_V5E_HBM_BW = 819e9           # bytes/s
TPU_V5E_ICI_BW = 50e9            # bytes/s per link


def get_hardware(name: str) -> HardwareSpec:
    try:
        return HARDWARE[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware {name!r}; known: {sorted(HARDWARE)}") from None
