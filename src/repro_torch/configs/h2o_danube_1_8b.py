"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]

The 4096-token sliding window makes attention sub-quadratic in context: the
KV cache is a ring of length 4096, so the ``long_500k`` cell runs with an
O(window) cache. A copy of ``repro.configs.h2o_danube_1_8b``.
"""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e4,
    dtype="bfloat16",
    param_dtype="bfloat16",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, sliding_window=8,
        dtype="float32", param_dtype="float32")
