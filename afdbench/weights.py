"""The benchmark's inputs: random weights made from the seed.

Laid out as ``AFDRuntime`` takes them (``repro_torch.models.params``'s
tree: ``embed``, ``lm_head``, ``final_norm``, ``layers``; matrices
``(in, out)``, experts ``(E, in, out)`` with gate|up fused), drawn on the
device with one ``torch.Generator`` into two flat buffers (one in the
served dtype, one in float32 for the router and the Mamba scalars) in one
call each, and scaled per leaf: N(0, 1/fan_in) for a matrix, N(0, 0.02²)
for the embedding, ones for norm scales and ``D``, zeros for biases and
``dt_bias``, ``A_log`` = log(linspace(1, 16)) over the heads. A MoE
layer's shared experts (``n_shared_experts`` of width ``shared_d_ff``, or
``moe_d_ff``) are one gated MLP, ``moe.shared``, drawn after its routed
experts. The same tensors go to the program and, read only, to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from afdbench.work import layer_kinds

# every leaf starts at a multiple of this many elements (256 B in bf16),
# so the kernels' 16-byte vector loads stay aligned
_ALIGN = 128


def _leaf_specs(arch: dict) -> List[Tuple[tuple, tuple, str, float]]:
    """(path, shape, init, scale) for every leaf: init is ``normal``
    (served dtype), ``normal32`` (float32), ``ones``, ``zeros``,
    ``ones32``, ``zeros32`` or ``alog``."""
    d, v = arch["d_model"], arch["vocab_size"]
    hq, hkv = arch["n_heads"], arch["n_kv_heads"]
    dh = arch.get("d_head") or d // hq
    specs = [(("embed", "tok"), (v, d), "normal", 0.02),
             (("final_norm", "scale"), (d,), "ones", 1.0)]
    if not arch.get("tie_embeddings", False):
        specs.append((("lm_head", "w"), (d, v), "normal", 1 / math.sqrt(d)))
    for i, (mixer, ffn) in enumerate(layer_kinds(arch)):
        p = ("layers", i)
        specs.append((p + ("ln1", "scale"), (d,), "ones", 1.0))
        if mixer == "attn":
            for n, shape in (("wq", (d, hq * dh)), ("wk", (d, hkv * dh)),
                             ("wv", (d, hkv * dh)), ("wo", (hq * dh, d))):
                specs.append((p + ("attn", n), shape, "normal",
                              1 / math.sqrt(shape[0])))
        else:
            di = arch.get("ssm_expand", 2) * d
            n, g = arch["ssm_state"], arch.get("ssm_groups", 1)
            heads = di // arch.get("ssm_head_dim", 64)
            conv = arch.get("ssm_conv", 4)
            conv_dim = di + 2 * g * n
            m = p + ("mamba",)
            specs += [
                (m + ("in_proj",), (d, 2 * di + 2 * g * n + heads), "normal",
                 1 / math.sqrt(d)),
                (m + ("conv_w",), (conv, conv_dim), "normal",
                 1 / math.sqrt(conv)),
                (m + ("conv_b",), (conv_dim,), "zeros", 0.0),
                (m + ("A_log",), (heads,), "alog", 0.0),
                (m + ("D",), (heads,), "ones32", 1.0),
                (m + ("dt_bias",), (heads,), "zeros32", 0.0),
                (m + ("norm",), (di,), "ones", 1.0),
                (m + ("out_proj",), (di, d), "normal", 1 / math.sqrt(di))]
        if ffn != "none":
            specs.append((p + ("ln2", "scale"), (d,), "ones", 1.0))
        if ffn == "moe":
            e, mf = arch["n_experts"], arch["moe_d_ff"]
            specs += [
                (p + ("moe", "router"), (d, e), "normal32", 1 / math.sqrt(d)),
                (p + ("moe", "wi"), (e, d, 2 * mf), "normal",
                 1 / math.sqrt(d)),
                (p + ("moe", "wo"), (e, mf, d), "normal", 1 / math.sqrt(mf))]
            if arch.get("n_shared_experts", 0):
                sf = (arch.get("shared_d_ff") or mf) * arch["n_shared_experts"]
                specs += [(p + ("moe", "shared", "wi"), (d, 2 * sf), "normal",
                           1 / math.sqrt(d)),
                          (p + ("moe", "shared", "wo"), (sf, d), "normal",
                           1 / math.sqrt(sf))]
        elif ffn == "mlp":
            f = arch["d_ff"]
            specs += [(p + ("mlp", "wi"), (d, 2 * f), "normal",
                       1 / math.sqrt(d)),
                      (p + ("mlp", "wo"), (f, d), "normal", 1 / math.sqrt(f))]
    return specs


def _put(tree: dict, path: tuple, leaf: torch.Tensor) -> None:
    node = tree
    for key in path[:-1]:
        if isinstance(node, list):
            node = node[key]
        else:
            node = node.setdefault(key, {})
    node[path[-1]] = leaf


def make_params(arch: dict, seed: int, dtype: torch.dtype,
                device) -> Dict[str, object]:
    """The parameter tree from ``seed``: same seed, same tensors."""
    specs = _leaf_specs(arch)
    tree: Dict[str, object] = {"embed": {}, "lm_head": {}, "final_norm": {},
                               "layers": [{} for _ in range(arch["n_layers"])]}
    offsets = {"normal": 0, "normal32": 0}
    placed = []
    for path, shape, init, scale in specs:
        numel = math.prod(shape)
        if init in offsets:
            placed.append((path, shape, init, scale, offsets[init]))
            offsets[init] += -(-numel // _ALIGN) * _ALIGN
        else:
            placed.append((path, shape, init, scale, None))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = {"normal": torch.empty(max(offsets["normal"], 1), dtype=dtype,
                                  device=device),
            "normal32": torch.empty(max(offsets["normal32"], 1),
                                    dtype=torch.float32, device=device)}
    for buf in flat.values():
        buf.normal_(generator=gen)
    for path, shape, init, scale, off in placed:
        if off is not None:
            leaf = flat[init][off:off + math.prod(shape)].view(shape)
            leaf.mul_(scale)
        elif init == "ones":
            leaf = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "ones32":
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        elif init == "zeros32":
            leaf = torch.zeros(shape, dtype=torch.float32, device=device)
        else:                                            # alog
            leaf = torch.log(torch.linspace(1.0, 16.0, shape[0],
                                            dtype=torch.float32,
                                            device=device))
        _put(tree, path, leaf)
    return tree


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
