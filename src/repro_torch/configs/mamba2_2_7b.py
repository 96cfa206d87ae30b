"""Mamba2-2.7B — pure SSM (SSD, state-space duality). [arXiv:2405.21060]

64 layers, d_model 2560, d_state 128, expand 2 (d_inner 5120), head_dim 64
(80 SSD heads), single B/C group, conv width 4. Attention-free: the AFD
A/F-role split has no MoE FFN to disaggregate — served as pure SSM (paper
technique inapplicable). O(1) decode state makes ``long_500k`` trivially
feasible. A copy of ``repro.configs.mamba2_2_7b``.
"""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=50280,
    attn_layer_period=0,        # no attention layers at all
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8,
        dtype="float32", param_dtype="float32")
