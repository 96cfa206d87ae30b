"""Granite-3.0-1B-A400M — 32 experts top-8, tiny expert width (M=512).
[hf:ibm-granite/granite-3.0-1b-a400m-base]

The paper's low-sparsity, fine-grained corner: 32/8 = 4 (favourable) but
M = 512 absolute (unfavourable). Every layer is MoE; no shared expert;
tied embeddings. A copy of ``repro.configs.granite_moe_1b_a400m``.
"""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=0,                     # all layers MoE; no dense FFN
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    moe_layer_offset=0,
    moe_layer_period=1,
    tie_embeddings=True,
    rope_theta=1e4,
    dtype="bfloat16",
    param_dtype="bfloat16",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        vocab_size=256, n_experts=8, top_k=4, moe_d_ff=32,
        dtype="float32", param_dtype="float32")
