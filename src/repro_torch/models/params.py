"""Random parameter init of the model, one dict per layer.

Returns the layout ``parallel.afd.split_roles`` and ``models.model``
consume::

    {"embed": {"tok", "pos"?}, "lm_head": {} | {"w"},
     "final_norm": {"scale", "bias"?},
     "layers": [{"ln1", "attn" | "mamba", "ln_cross"?, "cross"?,
                 "ln2"?, "moe" | "mlp"?}, ...],
     "encoder"?: {"layers": [...], "final_norm", "pos"}}

The key names are those of the JAX package's ``Model.init`` pytree
(``repro/models/model.py``, ``transformer.py``), whose ``prefix`` /
``stack`` are unstacked here into flat ``layers`` lists. The numbers come
from per-name ``torch.Generator`` streams and do not match JAX's;
``repro_torch.bridge`` loads JAX's own weights instead.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.models.common import (ArchConfig, LayerSpec, dense_init,
                                       embed_init)
from repro_torch.models.layers import (init_embedding, init_lm_head,
                                       init_mlp, init_norm)
from repro_torch.models.mamba2 import init_mamba
from repro_torch.models.moe import init_moe
from repro_torch.models.transformer import encoder_config, has_ffn


def init_attention(seed: int, name: str, cfg: ArchConfig, device,
                   cross: bool = False) -> Dict[str, torch.Tensor]:
    """Q/K/V/O projections; QKV biases and (self-attention only) qk-norm
    scales where the config has them."""
    D, dt = cfg.d_model, cfg.params_dtype
    p = {"wq": dense_init(seed, f"{name}.wq", (D, cfg.q_dim), dt, device),
         "wk": dense_init(seed, f"{name}.wk", (D, cfg.kv_dim), dt, device),
         "wv": dense_init(seed, f"{name}.wv", (D, cfg.kv_dim), dt, device),
         "wo": dense_init(seed, f"{name}.wo", (cfg.q_dim, D), dt, device)}
    if cfg.qkv_bias:
        for b, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                     ("bv", cfg.kv_dim)):
            p[b] = torch.zeros(n, dtype=dt, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(cfg.d_head, dtype=dt, device=device)
        p["k_norm"] = torch.ones(cfg.d_head, dtype=dt, device=device)
    return p


def init_layer(seed: int, name: str, cfg: ArchConfig, spec: LayerSpec,
               device) -> Dict[str, object]:
    """One pre-norm residual layer: mixer, cross-attention (enc-dec
    decoders), FFN (MoE, or dense where ``has_ffn``)."""
    lp: Dict[str, object] = {"ln1": init_norm(cfg, device)}
    if spec.kind == "attn":
        lp["attn"] = init_attention(seed, f"{name}.attn", cfg, device)
        if cfg.is_encdec:
            lp["ln_cross"] = init_norm(cfg, device)
            lp["cross"] = init_attention(seed, f"{name}.cross", cfg, device,
                                         cross=True)
    else:
        lp["mamba"] = init_mamba(seed, f"{name}.mamba", cfg, device)
    if has_ffn(cfg, spec):
        lp["ln2"] = init_norm(cfg, device)
        if spec.moe:
            lp["moe"] = init_moe(seed, f"{name}.moe", cfg, device)
        else:
            lp["mlp"] = init_mlp(seed, f"{name}.mlp", cfg, device, cfg.d_ff)
    return lp


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """The whole model's params on ``device``: embedding, decoder layers,
    final norm, LM head, and the encoder of enc-dec archs."""
    layers: List[Dict[str, object]] = [
        init_layer(seed, f"layer{i}", cfg, spec, device)
        for i, spec in enumerate(cfg.layer_plan().flat())]
    params = {"embed": init_embedding(seed, cfg, device),
              "lm_head": init_lm_head(seed, cfg, device),
              "final_norm": init_norm(cfg, device),
              "layers": layers}
    if cfg.is_encdec:
        ecfg = encoder_config(cfg)
        params["encoder"] = {
            "layers": [init_layer(seed, f"enc{i}", ecfg, spec, device)
                       for i, spec in enumerate(ecfg.layer_plan().flat())],
            "final_norm": init_norm(ecfg, device),
            "pos": embed_init(seed, "enc.pos", (cfg.encoder_seq, cfg.d_model),
                              cfg.params_dtype, device)}
    return params
