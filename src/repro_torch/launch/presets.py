"""Config presets of the launch scripts (``train`` and ``serve``): a copy
of ``repro.launch.train.preset_config``.

  smoke — the arch's reduced smoke config (seconds on a CPU)
  100m  — a ~100M-parameter member of the same family
  full  — the published config
"""

from __future__ import annotations

import dataclasses

from repro_torch import configs
from repro_torch.models.common import ArchConfig

PRESETS = ("smoke", "100m", "full")


def preset_config(arch: str, preset: str) -> ArchConfig:
    if preset == "smoke":
        return configs.get_smoke_config(arch)
    if preset == "full":
        return configs.get_config(arch)
    # ~100M-parameter family member: scale the smoke config up
    cfg = configs.get_config(arch)
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 8),
        d_model=512,
        n_heads=8 if cfg.n_heads else 0,
        n_kv_heads=min(8, cfg.n_kv_heads) if cfg.n_kv_heads else 0,
        d_head=64 if cfg.n_heads else 0,
        d_ff=2048 if cfg.d_ff else 0,
        moe_d_ff=512 if cfg.is_moe else 0,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        shared_d_ff=512 if cfg.n_shared_experts else 0,
        ssm_head_dim=64 if cfg.ssm_state else 0,
        ssm_state=min(cfg.ssm_state, 64) if cfg.ssm_state else 0,
        vocab_size=min(cfg.vocab_size, 32768),
        n_encoder_layers=min(cfg.n_encoder_layers, 4),
        encoder_seq=min(cfg.encoder_seq, 128) if cfg.encoder_seq else 0,
        vision_seq=min(cfg.vision_seq, 32) if cfg.vision_seq else 0,
        dtype="float32", param_dtype="float32",
    )
