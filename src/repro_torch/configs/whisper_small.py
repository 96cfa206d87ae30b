"""Whisper-small — encoder-decoder, conv frontend (stub). [arXiv:2212.04356]

12 encoder + 12 decoder layers, d_model 768, 12 heads (MHA), GELU MLPs,
LayerNorm, learned absolute positions (no RoPE). The conv1d+mel frontend is
a stub: the caller provides precomputed frame
embeddings (B, 1500, 768) — the encoder consumes them directly.

The pretrained model caps decoder positions at 448; the assigned
``decode_32k``/``prefill_32k`` shapes intentionally stress the cache far
past that (positions clip at the table edge). A copy of
``repro.configs.whisper_small``.
``long_500k`` is skipped (full attention).
"""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=51865,
    n_encoder_layers=12,
    encoder_seq=1500,
    use_rope=False,
    norm_type="layernorm",
    act="gelu",
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, encoder_seq=16, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256,
        dtype="float32", param_dtype="float32")
