"""MoE model registry for the analysis layer.

A copy of ``repro.core.modelspec`` (the port imports nothing of ``repro``).

Reproduces Table 4 of the paper exactly (used by the Fig. 2/4/6 benchmarks),
and maps the repo's ten assigned architectures into the same analytical form
so the planner / HFU-bound machinery applies uniformly.

An ``MoEModelSpec`` is the *analysis* view of a model: just the quantities the
paper's equations consume. The *executable* view (layer stacks, weights,
shardings) lives in ``repro.configs`` / ``repro.models``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class MoEModelSpec:
    name: str
    hidden_size: int            # H
    n_layers: int               # total hidden layers
    n_dense_layers: int         # leading dense layers (not in 3BO)
    n_moe_layers: int           # layers forwarded in 3BO mode (N_layers in Eq. 1)
    n_routed_experts: int       # N_experts (1 for dense models)
    top_k: int                  # experts per token (1 for dense models)
    moe_intermediate: int       # M (per-expert FFN width; d_ff for dense)
    total_params: float = 0.0   # for memory-capacity feasibility (bytes = 2x bf16 / 1x fp8)
    n_shared_experts: int = 0

    @property
    def sparsity(self) -> float:
        """Expert sparsity N_experts / TopK (paper §2.4). 1.0 for dense."""
        return self.n_routed_experts / max(self.top_k, 1)

    @property
    def granularity(self) -> float:
        """Expert granularity H / M (paper §2.4; finer = larger)."""
        return self.hidden_size / self.moe_intermediate

    @property
    def is_moe(self) -> bool:
        return self.n_routed_experts > 1


def _spec(name, H, L, Ld, Lmoe, E, k, M, params_b=0.0, shared=0):
    return MoEModelSpec(
        name=name, hidden_size=H, n_layers=L, n_dense_layers=Ld,
        n_moe_layers=Lmoe, n_routed_experts=E, top_k=k, moe_intermediate=M,
        total_params=params_b * 1e9, n_shared_experts=shared)


# --- Table 4 of the paper --------------------------------------------------
PAPER_MODELS: Dict[str, MoEModelSpec] = {
    "DeepSeek-V3":  _spec("DeepSeek-V3", 7168, 61, 3, 58, 256, 8, 2048, 671, shared=1),
    "Kimi-K2":      _spec("Kimi-K2",     7168, 61, 1, 60, 384, 8, 2048, 1026, shared=1),
    "Step3":        _spec("Step3",       7168, 61, 5, 56,  48, 3, 5120, 316, shared=1),
    "Qwen3-Coder":  _spec("Qwen3-Coder", 6144, 62, 0, 62, 160, 8, 2560, 480),
    "ERNIE-4.5":    _spec("ERNIE-4.5",   8192, 54, 3, 51,  64, 8, 3584, 300, shared=1),
    "GLM-4.7":      _spec("GLM-4.7",     5120, 92, 3, 92, 160, 8, 1536, 355, shared=1),
}

# --- Assigned architectures, analysis view ---------------------------------
# Dense models are encoded with E=1, k=1, M=d_ff: the budget model then treats
# the whole FFN as a single "expert" that every token activates (AFD for dense
# models degenerates to an attention/MLP pipeline split — see DESIGN.md §4).
ASSIGNED_MODELS: Dict[str, MoEModelSpec] = {
    "qwen1.5-0.5b":         _spec("qwen1.5-0.5b", 1024, 24, 24, 0, 1, 1, 2816, 0.62),
    "qwen3-8b":             _spec("qwen3-8b", 4096, 36, 36, 0, 1, 1, 12288, 8.2),
    "granite-8b":           _spec("granite-8b", 4096, 36, 36, 0, 1, 1, 14336, 8.1),
    "h2o-danube-1.8b":      _spec("h2o-danube-1.8b", 2560, 24, 24, 0, 1, 1, 6912, 1.8),
    "jamba-v0.1-52b":       _spec("jamba-v0.1-52b", 4096, 32, 16, 16, 16, 2, 14336, 52.0),
    "internvl2-2b":         _spec("internvl2-2b", 2048, 24, 24, 0, 1, 1, 8192, 2.2),
    "kimi-k2-1t-a32b":      _spec("kimi-k2-1t-a32b", 7168, 61, 1, 60, 384, 8, 2048, 1026, shared=1),
    "granite-moe-1b-a400m": _spec("granite-moe-1b-a400m", 1024, 24, 0, 24, 32, 8, 512, 1.3),
    "whisper-small":        _spec("whisper-small", 768, 12, 12, 0, 1, 1, 3072, 0.24),
    "mamba2-2.7b":          _spec("mamba2-2.7b", 2560, 64, 64, 0, 1, 1, 0, 2.7),
}

ALL_MODELS: Dict[str, MoEModelSpec] = {**PAPER_MODELS, **ASSIGNED_MODELS}


def get_model(name: str) -> MoEModelSpec:
    try:
        return ALL_MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(ALL_MODELS)}") from None
