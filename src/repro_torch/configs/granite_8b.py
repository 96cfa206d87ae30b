"""Granite-8B-Code — llama-arch dense, GQA kv=8. [arXiv:2405.04324]
A copy of ``repro.configs.granite_8b``.
"""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=1e7,
    dtype="bfloat16",
    param_dtype="bfloat16",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=192, vocab_size=256, dtype="float32", param_dtype="float32")
