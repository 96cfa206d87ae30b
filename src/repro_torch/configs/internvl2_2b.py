"""InternVL2-2B — InternViT frontend (stub) + InternLM2-1.8B backbone.
[arXiv:2404.16821]

The modality frontend is a stub: the caller provides
precomputed patch embeddings (B, vision_seq, d_model) that the model
prepends to the token embeddings. vision_seq = 256 matches InternVL2's
pixel-unshuffled 448px tile (1024 patches → 256 visual tokens). A copy of
``repro.configs.internvl2_2b``.
"""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=92553,
    vision_seq=256,
    rope_theta=1e6,
    dtype="bfloat16",
    param_dtype="bfloat16",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, vision_seq=8,
        dtype="float32", param_dtype="float32")
