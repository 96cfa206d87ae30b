"""Kimi-K2 (1T total, 32B active) — 384 experts top-8, one dense layer,
one shared expert. [arXiv:2501.kimi2 / paper Table 4]

The full configuration does not fit one card; the port uses only its smoke
config, which exercises the dense prefix layer and the shared expert.
A copy of ``repro.configs.kimi_k2_1t_a32b``.
"""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,
    d_ff=18432,                 # the single dense layer's FFN width
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    shared_d_ff=2048,
    moe_layer_offset=1,         # layer 0 dense, layers 1..60 MoE
    moe_layer_period=1,
    rope_theta=5e4,
    dtype="bfloat16",
    param_dtype="bfloat16",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=160, vocab_size=256, n_experts=8, top_k=2, moe_d_ff=32,
        shared_d_ff=32, dtype="float32", param_dtype="float32")
