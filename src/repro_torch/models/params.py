"""Random parameter init of the decoder, one dict per layer.

Returns the layout ``parallel.afd.split_roles`` consumes::

    {"embed": {"tok"}, "lm_head": {} | {"w"}, "final_norm": {"scale"},
     "layers": [{"ln1", "attn" | "mamba", "ln2", "moe" | "mlp"}, ...]}

The key names are those of the JAX package's ``Model.init`` pytree
(``repro/models/transformer.py``), whose ``decoder.prefix`` /
``decoder.stack`` are unstacked here into the flat ``layers`` list. The
numbers come from per-name ``torch.Generator`` streams and do not match
JAX's; ``repro_torch.bridge`` loads JAX's own weights instead.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.models.common import ArchConfig, dense_init, embed_init
from repro_torch.models.layers import init_mlp
from repro_torch.models.mamba2 import init_mamba
from repro_torch.models.moe import init_moe


def _norm(cfg: ArchConfig, device) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones(cfg.d_model, dtype=cfg.params_dtype,
                             device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, dtype=cfg.params_dtype,
                                device=device)
    return p


def _attention(seed: int, name: str, cfg: ArchConfig, device):
    D, dt = cfg.d_model, cfg.params_dtype
    p = {"wq": dense_init(seed, f"{name}.wq", (D, cfg.q_dim), dt, device),
         "wk": dense_init(seed, f"{name}.wk", (D, cfg.kv_dim), dt, device),
         "wv": dense_init(seed, f"{name}.wv", (D, cfg.kv_dim), dt, device),
         "wo": dense_init(seed, f"{name}.wo", (cfg.q_dim, D), dt, device)}
    if cfg.qkv_bias:
        for b, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                     ("bv", cfg.kv_dim)):
            p[b] = torch.zeros(n, dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.d_head, dtype=dt, device=device)
        p["k_norm"] = torch.ones(cfg.d_head, dtype=dt, device=device)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Per-layer decoder params (attention or Mamba-2 mixers, MoE or dense
    FFNs), on ``device``."""
    layers: List[Dict[str, object]] = []
    for i in range(cfg.n_layers):
        spec = cfg.layer_spec(i)
        name = f"layer{i}"
        lp: Dict[str, object] = {"ln1": _norm(cfg, device)}
        if spec.kind == "attn":
            lp["attn"] = _attention(seed, f"{name}.attn", cfg, device)
        else:
            lp["mamba"] = init_mamba(seed, f"{name}.mamba", cfg, device)
        if spec.moe:
            lp["ln2"] = _norm(cfg, device)
            lp["moe"] = init_moe(seed, f"{name}.moe", cfg, device)
        elif cfg.d_ff:
            lp["ln2"] = _norm(cfg, device)
            lp["mlp"] = init_mlp(seed, f"{name}.mlp", cfg, device, cfg.d_ff)
        layers.append(lp)
    lm_head = ({} if cfg.tie_embeddings else
               {"w": dense_init(seed, "lm_head.w", (cfg.d_model,
                                                    cfg.vocab_size),
                                cfg.params_dtype, device)})
    return {"embed": {"tok": embed_init(seed, "embed.tok",
                                        (cfg.vocab_size, cfg.d_model),
                                        cfg.params_dtype, device)},
            "lm_head": lm_head,
            "final_norm": _norm(cfg, device),
            "layers": layers}
