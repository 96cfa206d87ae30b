"""The model's public API: init / forward / loss / prefill / decode_step.
Counterpart of ``repro.models.model``.

A ``Model`` wraps an ``ArchConfig`` with functions of plain parameter and
cache trees (``models.params``, ``models.kvcache``). Batch dicts follow the
JAX package's conventions:

  tokens        (B, S) int              — always present (labels = shifted)
  patch_embeds  (B, vision_seq, D)      — VLM stub frontend output
  frames        (B, encoder_seq, D)     — audio stub frontend output

Modes:
  forward(mode="train")   logits over the full sequence (+ MoE aux loss)
  prefill(...)            forward + KV/SSM cache population, last logits
  decode_step(...)        one token per live sequence against the cache

``device`` (None = the CUDA device, which raises without one; ``"cpu"``
only when asked for) is where ``init`` and ``init_cache`` put their
tensors. ``impl`` picks the decode step's kernels as ``kernels.ops`` does
(None by device, ``"plain"`` forces the plain versions); prefill and
forward run no kernel, as in JAX. ``forward`` and ``loss`` are
differentiable end to end (``training.train`` takes the loss's gradients
with ``torch.autograd.grad``; no kernel is on that path, and none needs a
backward of its own); ``prefill`` and ``decode_step`` run without
autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import kvcache, transformer
from repro_torch.models.common import ArchConfig, resolve_device
from repro_torch.models.layers import apply_lm_head, embed_tokens
from repro_torch.models.params import init_params

AUX_LOSS_COEF = 0.01


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] per position, in float32: (B, S).

    On DTensor logits (the sharded train step) each rank takes its block
    (``collectives.spmd_map``): the batch as it is split, the vocabulary
    split over "model" where it divides (else whole), and the softmax's
    max, its normaliser and the label's logit combined over "model" by
    collectives, so no rank holds the whole vocabulary's logits (the
    vocab-parallel cross entropy)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(logits, DTensor):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, labels[..., None])[..., 0]
    import torch.distributed as dist
    from repro_torch.parallel import collectives as coll
    mesh = logits.device_mesh
    names = list(mesh.mesh_dim_names)
    m = int(mesh.shape[names.index("model")]) if "model" in names else 1
    split = m > 1 and logits.shape[-1] % m == 0
    batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
             for p in logits.placements]
    lg_pl = [Shard(2) if split and n == "model" else p
             for n, p in zip(names, batch)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * len(names),
                                    run_check=False)

    def local(lg, lb):
        if not split:                   # the whole vocabulary: as above
            logp = torch.log_softmax(lg.float(), dim=-1)
            return (-logp.gather(-1, lb[..., None])[..., 0],)
        lg = lg.float()
        mx = lg.amax(-1).detach()
        group = mesh.get_group("model")
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        v_l = lg.shape[-1]
        idx = lb - mesh.get_local_rank("model") * v_l
        inside = (idx >= 0) & (idx < v_l)
        picked = lg.gather(-1, idx.clamp(0, v_l - 1)[..., None])[..., 0]
        picked = torch.where(inside, picked, torch.zeros_like(picked))
        se = coll.all_reduce_sum((lg - mx[..., None]).exp().sum(-1), group)
        picked = coll.all_reduce_sum(picked, group)
        return (mx + se.log() - picked,)

    return coll.spmd_map(local, mesh, (tuple(lg_pl), tuple(batch)),
                         (tuple(batch),))(logits, labels)[0]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: Optional[torch.device] = None
    impl: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # ---- init ---------------------------------------------------------------

    def init(self, seed: int = 0):
        return init_params(self.cfg, seed=seed, device=self.device)

    def init_cache(self, batch_size: int, max_len: int):
        return kvcache.init_cache(self.cfg, batch_size, max_len, self.device)

    # ---- embedding frontends ------------------------------------------------

    def _embed(self, params, batch: Dict[str, torch.Tensor],
               positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = embed_tokens(params["embed"], cfg, batch["tokens"], positions)
        if cfg.vision_seq and "patch_embeds" in batch:
            # VLM stub: prepend precomputed patch embeddings
            x = torch.cat([batch["patch_embeds"].to(cfg.compute_dtype), x],
                          dim=1)
        return x

    def _cross_kv(self, params, enc_out: torch.Tensor):
        """Per decoder layer, the cross-attention K/V of the encoder output
        (None for Mamba layers)."""
        return [attn.project_cross_kv(lp["cross"], self.cfg, enc_out)
                if spec.kind == "attn" else None
                for lp, spec in zip(params["layers"],
                                    self.cfg.layer_plan().flat())]

    def _encoder_kv(self, params, batch):
        if not self.cfg.is_encdec:
            return None
        enc_out = transformer.encode(params["encoder"], self.cfg,
                                     batch["frames"])
        return self._cross_kv(params, enc_out)

    # ---- forward / loss -----------------------------------------------------

    def forward(self, params, batch: Dict[str, torch.Tensor],
                mode: str = "train") -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits. Returns (logits (B, S_total, V), aux)."""
        b, s = batch["tokens"].shape
        x = self._embed(params, batch, _positions(b, s, self.device))
        x, _, aux = transformer.stack_forward(
            params, self.cfg, x, mode=mode,
            positions=_positions(b, x.shape[1], self.device),
            cross_kv=self._encoder_kv(params, batch), impl=self.impl)
        return apply_lm_head(params["lm_head"], params["embed"], self.cfg,
                             x), aux

    def loss(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy (+ MoE aux). VLM prefix excluded."""
        logits, aux = self.forward(params, batch, mode="train")
        tokens = batch["tokens"]
        skip = (batch["patch_embeds"].shape[1]
                if self.cfg.vision_seq and "patch_embeds" in batch else 0)
        # every position is scored (those without a label against the
        # sequence's first token) and the nll sliced: logits whose sequence
        # is split over "model" (the sequence-parallel rules) are then never
        # sliced along it, which would gather them whole on every rank
        first = tokens[:, :1]
        labels = torch.cat([first.expand(-1, skip), tokens[:, 1:], first],
                           dim=1).long()
        nll = token_nll(logits, labels)[:, skip:-1]
        mask = torch.ones_like(nll)
        if "loss_mask" in batch:
            mask = batch["loss_mask"][:, 1:].float()
        ce = (nll * mask).sum() / mask.sum().clamp(min=1.0)
        return ce + AUX_LOSS_COEF * aux, {
            "ce": ce, "aux": aux, "ppl_proxy": torch.exp(ce.clamp(max=20.0))}

    # ---- serving ------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params, batch: Dict[str, torch.Tensor], max_len: int,
                cache: Optional[Dict[str, object]] = None
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """Populate a fresh cache from the prompt; return the last
        position's logits (B, V) and the cache. ``cache`` is the fresh
        cache to fill (``init_cache(B, max_len)`` when None; the multi-pod
        dry-run passes one placed on its mesh)."""
        b, s = batch["tokens"].shape
        x = self._embed(params, batch, _positions(b, s, self.device))
        s_total = x.shape[1]
        cross_kv = self._encoder_kv(params, batch)
        x, cache, _ = transformer.stack_forward(
            params, self.cfg, x, mode="prefill",
            positions=_positions(b, s_total, self.device),
            cache=self.init_cache(b, max_len) if cache is None else cache,
            cross_kv=cross_kv, impl=self.impl)
        cache["pos"] = torch.full((b,), s_total, dtype=torch.int32,
                                  device=self.device)
        if cross_kv is not None:
            cache["cross_kv"] = cross_kv
        logits = apply_lm_head(params["lm_head"], params["embed"], self.cfg,
                               x[:, -1:])
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params, cache: Dict[str, object],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One decode step. tokens: (B,) → (logits (B, V), cache). The
        attention caches are updated in place; keep the returned dict."""
        pos = cache["pos"]
        x = embed_tokens(params["embed"], self.cfg, tokens[:, None],
                         pos[:, None])
        x, cache, _ = transformer.stack_forward(
            params, self.cfg, x, mode="decode", cache=cache, pos=pos,
            cross_kv=cache.get("cross_kv"), impl=self.impl)
        cache["pos"] = pos + 1
        logits = apply_lm_head(params["lm_head"], params["embed"], self.cfg,
                               x)
        return logits[:, 0], cache


def make_model(cfg: ArchConfig, device=None,
               impl: Optional[str] = None) -> Model:
    return Model(cfg, device=device, impl=impl)
