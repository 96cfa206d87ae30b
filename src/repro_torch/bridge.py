"""Load the JAX package's parameters into the port's layout.

``params_from_jax`` takes the ``Model.init`` pytree as nested dicts and
lists of numpy arrays (the caller converts; the bridge needs no JAX),
unstacks ``decoder.prefix`` + ``decoder.stack[j][p]`` (and the encoder's,
for enc-dec archs) with the port's own ``LayerPlan`` and returns the
per-layer layout of ``repro_torch.models.params.init_params``.
``quantized_experts_from_jax`` takes expert weights quantized by the JAX
package's helpers (int8, or int4 packed two per byte) to the grouped
GEMM's ``scales=`` operands.

numpy has no bfloat16 of its own: JAX bf16 arrays arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects, so callers cast
them to float32 first and the bridge casts back (bf16 → f32 → bf16 is
exact).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import encoder_config


# Leaves the JAX model keeps in float32 whatever the param dtype: the
# router, and the Mamba-2 decay, skip and step-bias vectors.
F32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias"})


def _to_torch(tree, device, dtype: torch.dtype, name: str = ""):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, dtype, name) for v in tree]
    t = torch.from_numpy(np.array(tree))          # a writable copy
    return t.to(device=device,
                dtype=torch.float32 if name in F32_LEAVES else dtype)


def _take(tree, p: int):
    if isinstance(tree, dict):
        return {k: _take(v, p) for k, v in tree.items()}
    return tree[p]


def unstack_layers(cfg: ArchConfig, prefix, stack) -> List:
    """JAX's ``prefix`` list plus ``stack`` (one tree per period slot, each
    leaf with a leading ``n_periods`` axis) as one flat per-layer list in
    layer order: the layout of the port's parameter and cache trees.
    Works on parameters and on caches alike."""
    plan = cfg.layer_plan()
    layers = list(prefix)
    for p in range(plan.n_periods):
        for j in range(len(plan.period)):
            layers.append(_take(stack[j], p))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: pytree holds {len(layers)} layers, "
                         f"config says {cfg.n_layers}")
    return layers


def params_from_jax(cfg: ArchConfig, tree, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
    """The port's parameter tree from JAX's ``Model.init`` tree: decoder
    layers, embedding (with the learned position table where the arch has
    one), LM head, and for enc-dec archs the cross-attention leaves of each
    decoder layer and the encoder (its layers, final norm and position
    table)."""
    dtype = dtype or cfg.params_dtype
    dec = tree["decoder"]
    out = {"embed": _to_torch(tree["embed"], device, dtype),
           "lm_head": _to_torch(tree.get("lm_head", {}), device, dtype),
           "final_norm": _to_torch(dec["final_norm"], device, dtype),
           "layers": _to_torch(unstack_layers(cfg, dec["prefix"],
                                              dec["stack"]), device, dtype)}
    if "encoder" in tree:
        enc, ecfg = tree["encoder"], encoder_config(cfg)
        out["encoder"] = {
            "layers": _to_torch(unstack_layers(ecfg, enc["stack"]["prefix"],
                                               enc["stack"]["stack"]),
                                device, dtype),
            "final_norm": _to_torch(enc["stack"]["final_norm"], device,
                                    dtype),
            "pos": _to_torch(enc["pos"], device, dtype)}
    return out


def quantized_experts_from_jax(codes, scales, device="cuda"):
    """Expert weights quantized by ``repro.kernels.grouped_gemm``'s
    ``quantize_experts`` (int8 codes (G, K, N), scales (G,)) or
    ``quantize_experts_int4`` (packed (G, K/2, N), scales (G, N/block_n))
    as the tensors ``ops.grouped_gemm(..., scales=)`` takes: the layout is
    the same, so codes and scales cross bit for bit."""
    return (torch.from_numpy(np.array(codes, np.int8)).to(device),
            torch.from_numpy(np.array(scales, np.float32)).to(device))
