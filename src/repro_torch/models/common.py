"""Shared model machinery: ArchConfig, layer plans, initializers and the
logical-axis activation hook.

A copy of ``repro.models.common`` (which imports JAX): dtypes resolve to
``torch.dtype`` and the initializers draw from a ``torch.Generator``.
``layer_plan()`` still factors depth into a prefix plus a repeated period,
because the JAX parameter pytree is stacked that way and
``repro_torch.bridge`` unstacks it with this plan.

Activations are annotated with logical axis names (``shard``);
``parallel.sharding.install`` maps them onto a mesh. With nothing
installed the hook is the identity, and a plain (non-DTensor) tensor
passes unchanged even while rules are installed, so the single-device
paths never touch distribution code.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import torch

# ---------------------------------------------------------------------------
# Logical-axis activation hook
# ---------------------------------------------------------------------------

# Installed by repro_torch.parallel.sharding.install(); identity by default.
_constraint_fn: Callable[[torch.Tensor, Tuple[Optional[str], ...]],
                         torch.Tensor] = lambda x, axes: x


def set_constraint_fn(fn) -> None:
    global _constraint_fn
    _constraint_fn = fn


def reset_constraint_fn() -> None:
    set_constraint_fn(lambda x, axes: x)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Annotate ``x`` with logical axis names (one per dim; None =
    replicated)."""
    return _constraint_fn(x, tuple(axes))


# Canonical logical axis vocabulary (parallel/sharding.py maps these):
#   batch    — global batch / token-parallel dim  → ("pod", "data")
#   seq      — sequence (activations)             → None (or "model" for SP)
#   embed    — d_model features                   → None
#   heads    — attention q-heads, SSM heads       → "model"
#   kv_heads — attention kv-heads                 → "model" when divisible
#   kv_seq   — KV-cache sequence dim              → "model" (split-KV decode)
#   mlp      — FFN hidden width                   → "model"
#   experts  — MoE expert dim                     → "model"
#   vocab    — output vocabulary                  → "model"
#   stack    — scanned layer-period dim           → None
#   fsdp     — parameter sharding dim for FSDP    → "data"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One decoder layer's structure."""
    kind: str                   # "attn" | "mamba"
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    prefix: Tuple[LayerSpec, ...]
    period: Tuple[LayerSpec, ...]
    n_periods: int

    def flat(self) -> List[LayerSpec]:
        return list(self.prefix) + list(self.period) * self.n_periods


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                   # dense-layer FFN width (0 for pure-SSM)
    vocab_size: int
    d_head: int = 0             # default d_model // n_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1e4
    use_rope: bool = True
    max_position: int = 1 << 20

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    moe_layer_offset: int = 0
    moe_layer_period: int = 1
    router_renorm: bool = True

    # hybrid / SSM (Mamba-2)
    attn_layer_offset: int = 0
    attn_layer_period: int = 1
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 64

    # encoder-decoder (whisper): the frontend is a stub, the encoder takes
    # precomputed frame embeddings (B, encoder_seq, d_model)
    n_encoder_layers: int = 0
    encoder_seq: int = 0

    # VLM: the frontend is a stub, precomputed patch embeddings
    # (B, vision_seq, d_model) are prepended to the token embeddings
    vision_seq: int = 0

    # misc
    causal: bool = True
    force_unroll: bool = False
    tie_embeddings: bool = False
    rms_eps: float = 1e-6
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"           # silu | gelu
    dtype: str = "float32"      # activation/compute dtype
    param_dtype: str = "float32"
    moe_capacity_factor: float = 1.25
    remat: bool = False

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 1

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def is_attn_layer(self, i: int) -> bool:
        if self.ssm_state == 0:
            return True
        if self.attn_layer_period <= 0:
            return False
        return i % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, i: int) -> bool:
        if not self.is_moe:
            return False
        return (i >= self.moe_layer_offset and
                (i - self.moe_layer_offset) % self.moe_layer_period == 0)

    def layer_spec(self, i: int) -> LayerSpec:
        kind = "attn" if self.is_attn_layer(i) else "mamba"
        return LayerSpec(kind=kind, moe=self.is_moe_layer(i))

    def layer_plan(self) -> LayerPlan:
        """Factor depth into prefix + homogeneous repeated period, exactly
        as ``repro.models.common.ArchConfig.layer_plan`` does (the JAX
        parameter stack is laid out by this plan)."""
        specs = [self.layer_spec(i) for i in range(self.n_layers)]
        n = self.n_layers
        best = LayerPlan(prefix=tuple(specs), period=(), n_periods=0)
        if self.force_unroll:
            return best
        for p in range(1, min(n, 16) + 1):
            for s in range(0, min(n, 8) + 1):
                if (n - s) % p != 0 or (n - s) // p < 2:
                    continue
                window = specs[s:s + p]
                ok = all(specs[s + j] == window[j % p]
                         for j in range(n - s))
                if ok:
                    plan = LayerPlan(prefix=tuple(specs[:s]),
                                     period=tuple(window),
                                     n_periods=(n - s) // p)
                    if (not best.n_periods or
                            len(plan.prefix) < len(best.prefix)):
                        best = plan
                    break
            if best.n_periods:
                break
        return best


    # ---- parameter counting ------------------------------------------------

    def param_count(self) -> int:
        """The JAX package's formula, term for term. It counts a dense FFN
        on attention layers only (``elif spec.kind == "attn"``), while the
        model builds one on every non-MoE layer when ``d_ff > 0``
        (``transformer.has_ffn``): for hybrids with dense FFNs on Mamba
        layers (Jamba) the count is short of the tree's. Kept as the
        reference has it; ``tree_count`` counts the tree."""
        D, V = self.d_model, self.vocab_size
        total = V * D                                   # embedding
        if not self.tie_embeddings:
            total += D * V                              # lm head
        for i in range(self.n_layers):
            spec = self.layer_spec(i)
            if spec.kind == "attn":
                total += D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
                if self.qkv_bias:
                    total += self.q_dim + 2 * self.kv_dim
            else:
                total += (D * (2 * self.d_inner + 2 * self.ssm_groups *
                               self.ssm_state + self.ssm_heads)
                          + self.ssm_conv * self.conv_dim + self.conv_dim
                          + 3 * self.ssm_heads + self.d_inner
                          + self.d_inner * D)
            if spec.moe:
                total += D * self.n_experts             # router
                total += self.n_experts * 3 * D * self.moe_d_ff
                if self.n_shared_experts:
                    total += 3 * D * (self.shared_d_ff or self.moe_d_ff
                                      ) * self.n_shared_experts
            elif spec.kind == "attn" and self.d_ff:
                total += 3 * D * self.d_ff
            total += 2 * D                              # two norms
        total += D                                      # final norm
        if self.is_encdec:
            total += self.n_encoder_layers * (4 * D * D + 3 * D * self.d_ff
                                              + 2 * D)
            total += self.n_layers * (4 * D * D + D)    # cross attention
            total += self.encoder_seq * D + self.max_decode_positions() * D
        return total

    def max_decode_positions(self) -> int:
        """Rows of the learned position table (whisper caps them at 448)."""
        return 448 if self.family == "audio" else self.max_position

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        total = self.param_count()
        moe_layers = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        per = 3 * self.d_model * self.moe_d_ff
        return (total - moe_layers * self.n_experts * per
                + moe_layers * self.top_k * per)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; asking for CUDA without one raises
    (the port never carries on on the CPU unless told to)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _generator(seed: int, name: str, device) -> torch.Generator:
    """Deterministic per-name generator: the stream of one parameter does
    not depend on how many parameters were drawn before it."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + zlib.crc32(name.encode())) % (1 << 63))
    return g


def dense_init(seed: int, name: str, shape: Sequence[int], dtype,
               device, fan_in: Optional[int] = None) -> torch.Tensor:
    """normal × 1/sqrt(fan_in), drawn in float32 then cast."""
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan, 1))
    x = torch.randn(tuple(shape), generator=_generator(seed, name, device),
                    device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def embed_init(seed: int, name: str, shape: Sequence[int], dtype,
               device) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=_generator(seed, name, device),
                    device=device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (the sharded step's tensors)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a layer uses it. On a DTensor (the sharded step), the
    weight stored split over the data-parallel axes (FSDP) is all-gathered
    over every mesh axis but "model", whose tensor-parallel split it keeps,
    as XLA's partitioner does with JAX's FSDP weights. A plain tensor is
    returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = [p if n == "model" else Replicate()
          for n, p in zip(names, w.placements)]
    return w if pl == list(w.placements) else w.redistribute(
        w.device_mesh, pl)


def rows_whole(x: torch.Tensor, w: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """An activation as a projection takes it. On a DTensor split along a
    dim between the batch (dim 0) and the features (the last dim), as
    ``shard``'s "seq" is under the sequence-parallel rules, that split is
    gathered: DTensor's matmul rules fail on the placement a (batch, seq)
    pair split over two mesh axes takes when the matmul flattens it. With
    ``w``, the weight of a row-split projection, the features are split
    over the mesh axes that split ``w``'s rows (a dividing split moved
    there, or a whole copy cut), so that the product is a partial sum and
    ``w``'s gradient is computed split, as in the forward. A plain tensor
    is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    rows = ({i for i, p in enumerate(w.placements)
             if isinstance(p, Shard) and p.dim == 0}
            if isinstance(w, DTensor) else set())
    pl = []
    for i, (p, n) in enumerate(zip(x.placements, x.device_mesh.shape)):
        middle = isinstance(p, Shard) and 0 < p.dim < last
        if i in rows and (middle or isinstance(p, Replicate)) \
                and x.shape[-1] % int(n) == 0:
            p = Shard(last)
        elif middle:
            p = Replicate()
        pl.append(p)
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list tree, in ``tree_map``'s order."""
    return list(_leaves(tree))


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves_of_rest)`` over every tensor of a nested dict/list
    tree, keeping its nesting; ``rest`` are trees with the same nesting
    down to ``tree``'s leaves (their entries there may be subtrees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict/list tree."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def tree_count(tree) -> int:
    """Elements of every tensor in a nested dict/list tree."""
    return sum(t.numel() for t in _leaves(tree))
