"""Assigned input shapes and their stand-ins. Counterpart of
``repro.launch.shapes``.

Four shapes per LM architecture:
    train_4k      seq 4,096   × global_batch 256   (training step)
    prefill_32k   seq 32,768  × global_batch 32    (inference prefill)
    decode_32k    one token, KV cache of 32,768 × batch 128 (serve_step)
    long_500k     one token, context 524,288 × batch 1     (serve_step)

``long_500k`` needs sub-quadratic attention: it runs for the SSM / hybrid /
sliding-window archs and is SKIPPED (with the reason recorded) for pure
full-attention models.

The stand-ins are tensors on the ``meta`` device (shape and dtype, no
storage): the port's counterpart of ``jax.ShapeDtypeStruct``. Modality
frontends are stubs: the VLM cell carves ``vision_seq`` positions out of
the sequence budget and supplies patch embeddings; the audio cell supplies
encoder frame embeddings alongside decoder tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import kvcache
from repro_torch.models.common import ArchConfig

I32 = torch.int32
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                   # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def supports_long_context(cfg: ArchConfig) -> bool:
    """Sub-quadratic attention: SSM state, hybrid, or sliding window."""
    return cfg.ssm_state > 0 or cfg.sliding_window is not None


def cell_supported(cfg: ArchConfig, shape_name: str
                   ) -> Tuple[bool, Optional[str]]:
    if shape_name == "long_500k" and not supports_long_context(cfg):
        return False, ("full quadratic attention — long_500k skipped "
                       "(DESIGN.md §4); runs only for SSM/hybrid/SWA archs")
    return True, None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, spec: ShapeSpec,
                act_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for the model inputs of one cell."""
    b = spec.global_batch
    if spec.kind == "decode":
        return {"tokens": _meta((b,), I32)}
    s = spec.seq_len
    out: Dict[str, torch.Tensor] = {}
    if cfg.vision_seq:
        # vision prefix is carved out of the sequence budget
        out["tokens"] = _meta((b, s - cfg.vision_seq), I32)
        out["patch_embeds"] = _meta((b, cfg.vision_seq, cfg.d_model),
                                    act_dtype)
    else:
        out["tokens"] = _meta((b, s), I32)
    if cfg.is_encdec:
        out["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), act_dtype)
    return out


def cache_specs(model, spec: ShapeSpec) -> Dict:
    """Meta-tensor tree of the decode-entry cache (pos = seq-1), in the
    port's layout (``models.kvcache.init_cache``: one entry per layer).

    Enc-dec models also carry the prefill-computed cross-KV (static
    encoder keys/values), one (k, v) per decoder layer (None for Mamba
    layers) where JAX stacks them, so the decode cell prices cross
    attention too.
    """
    cfg = model.cfg
    cache = kvcache.init_cache(cfg, spec.global_batch, spec.seq_len, META)
    if cfg.is_encdec:
        shape = (spec.global_batch, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.d_head)
        cache["cross_kv"] = [
            (_meta(shape, cfg.compute_dtype), _meta(shape, cfg.compute_dtype))
            if s.kind == "attn" else None for s in cfg.layer_plan().flat()]
    return cache


def tokens_processed(cfg: ArchConfig, spec: ShapeSpec) -> int:
    """Token count the cell's step processes (for MODEL_FLOPS)."""
    if spec.kind == "decode":
        return spec.global_batch
    return spec.global_batch * spec.seq_len
