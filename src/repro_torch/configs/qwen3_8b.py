"""Qwen3-8B — dense, GQA kv=8, qk-norm, d_head=128. [hf:Qwen/Qwen3-8B]
A copy of ``repro.configs.qwen3_8b``.
"""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    dtype="bfloat16",
    param_dtype="bfloat16",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=160, vocab_size=256, dtype="float32", param_dtype="float32")
