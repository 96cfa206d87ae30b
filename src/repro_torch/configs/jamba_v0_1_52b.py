"""Jamba-v0.1-52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887]

Layer pattern (period 8): attention at offset 4, Mamba elsewhere; MoE FFN
every 2 layers at offset 1. Coarse experts (M = 14336) and low sparsity
(16/2 = 8) make this the assigned pool's most AFD-favourable MoE per the
paper's §4 criteria. A copy of ``repro.configs.jamba_v0_1_52b``.

Jamba's published config has no shared expert and top-2 routing; d_ff of
the MoE experts equals the dense d_ff (coarse granularity H/M =
4096/14336 < 1).
"""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    # MoE: 16 experts, top-2, every 2 layers starting at layer 1
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_layer_offset=1,
    moe_layer_period=2,
    # hybrid: attention at i % 8 == 4, Mamba elsewhere
    attn_layer_offset=4,
    attn_layer_period=8,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    dtype="bfloat16",
    param_dtype="bfloat16",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=16, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, n_experts=4, top_k=2, moe_d_ff=128,
        ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
        dtype="float32", param_dtype="float32")
