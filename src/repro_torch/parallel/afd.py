"""Attention-FFN Disaggregation (AFD) runtime — the paper's Fig. 1a
architecture on two device roles. Counterpart of ``repro.parallel.afd``.

  * **A role** — embeddings, attention mixers, norms, dense MLPs, shared
    experts, the router and the LM head.
  * **F role** — the routed-expert weights of every MoE layer, split
    expert-parallel over the F devices when their count divides E.

Per MoE layer and micro-batch the runtime performs the paper's M2N cycle:

    A: attention sublayer + router           (t_a)
    dispatch: tokens + gating  A → F         (t_dispatch)  [.to(f_devices)]
    F: grouped-GEMM expert FFN per block     (t_f)
    combine: routed outputs  F → A, summed   (t_combine)   [.to(a_device)]

Both roles default to the one card; dispatch and combine are then no-op
moves, and the byte counters still record what would cross the wire so
the serving engine can check them against the Eq. 9/17 prediction (once
per cycle, whatever N_F).
``decode_step_3bo`` issues micro-batches in the 3BO rotation order; the
rotation runs on one CUDA stream (overlapping it on separate streams is
later work). Where both roles are one CUDA device on the CUDA kernels, a
rotation is not enqueued call by call once it repeats: the second call
with the same caches and shapes captures it in a CUDA graph, and later
ones replay it (``parallel.rotation_graph``; the first runs as it comes,
so a one-off caller pays no capture). The runtime keeps one captured
rotation and counts its replays (``replays``): the kernels' launch
counters see the launches issued into the capture, not those a replay
makes. ``rescale`` rebuilds a runtime on another role split.

Mixers are attention or Mamba-2 (hybrid archs such as Jamba): a Mamba
layer's mixer runs on the A role with an O(1) recurrent state, and its
chunked prefill steps the decode recurrence over the chunk, as the JAX
runtime does. Dense architectures have no routed experts: ``AFDRuntime``
refuses them.

Under a ``repro_torch.trace`` tracer each piece of the cycle is a span:
``afd.a.mixer`` (one layer's decode mixer for one micro-batch),
``afd.a.attn_chunk`` / ``afd.a.mamba_chunk`` (a prefill chunk's mixer;
``mamba.steps`` counts the stepped tokens), ``afd.a.route``,
``afd.dispatch``, ``afd.f.experts`` (one per F block), ``afd.combine``,
``afd.a.dense`` (dense FFNs and shared experts) and ``afd.a.head``. None
of them fires in a replayed rotation, which is one ``afd.rotation.replay``
span (its capture one ``afd.rotation.capture``); each rotation counts one
``graph.eager``, ``graph.capture`` or ``graph.replay``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch import trace
from repro_torch.models import attention as attn_mod
from repro_torch.models import kvcache, mamba2, moe as moe_mod
from repro_torch.models.common import ArchConfig, LayerSpec, resolve_device
from repro_torch.models.layers import (apply_lm_head, apply_mlp, apply_norm,
                                       embed_tokens)
from repro_torch.parallel import rotation_graph


def _to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree


def _in_place(cache, new):
    """``new``'s tensors copied into ``cache``'s, and ``cache`` returned:
    a decode step that returns a new cache (Mamba's) leaves it where the
    caller's was, the same values."""
    for name, t in cache.items():
        t.copy_(new[name])
    return cache


def split_roles(params, cfg: ArchConfig):
    """Return (a_params, f_expert_params). Experts leave the A side."""
    a_layers, f_layers = [], []
    for lp in params["layers"]:
        lp = dict(lp)
        f_entry = None
        if "moe" in lp:
            moe_p = dict(lp["moe"])
            f_entry = {"wi": moe_p.pop("wi"), "wo": moe_p.pop("wo")}
            lp["moe"] = moe_p            # router + shared experts stay on A
        a_layers.append(lp)
        f_layers.append(f_entry)
    a_params = {"embed": params["embed"], "lm_head": params["lm_head"],
                "final_norm": params["final_norm"], "layers": a_layers}
    return a_params, f_layers


@dataclasses.dataclass
class AFDStats:
    """M2N wire counters; ``snapshot()``/``since()`` give the serving
    engine per-window deltas to diff against the Eq. 9/17 prediction."""
    dispatch_bytes: int = 0
    combine_bytes: int = 0
    dispatches: int = 0
    tokens_routed: int = 0

    def record(self, n_tokens: int, hidden: int, dtype_bytes: int,
               meta_bytes: int) -> None:
        self.dispatch_bytes += n_tokens * hidden * dtype_bytes + meta_bytes
        self.combine_bytes += n_tokens * hidden * dtype_bytes
        self.dispatches += 1
        self.tokens_routed += n_tokens

    def snapshot(self) -> "AFDStats":
        return dataclasses.replace(self)

    def since(self, prev: "AFDStats") -> "AFDStats":
        return AFDStats(
            dispatch_bytes=self.dispatch_bytes - prev.dispatch_bytes,
            combine_bytes=self.combine_bytes - prev.combine_bytes,
            dispatches=self.dispatches - prev.dispatches,
            tokens_routed=self.tokens_routed - prev.tokens_routed)


class AFDRuntime:
    """Two-role decode/prefill runtime.

    ``device=None`` means the CUDA device (raises without one); ``a_device``
    defaults to ``device`` and ``f_devices`` to ``[device]``. The F role
    runs on the N_F devices of ``f_devices``: when N_F divides the expert
    count, device j holds the contiguous block of E / N_F experts from
    j·E / N_F, and the F program runs each block's experts over the
    tokens routed to them, whose partial outputs sum on the A device (the
    combine); otherwise every F device holds all the experts and the
    first runs them, as JAX's runtime replicates them.
    A list may repeat a device. ``impl`` picks the kernels as
    ``kernels.ops`` does: None by device, ``"plain"`` forces the plain
    PyTorch versions.
    """

    def __init__(self, cfg: ArchConfig, params, device=None, a_device=None,
                 f_devices: Optional[Sequence] = None,
                 impl: Optional[str] = None):
        if not cfg.is_moe:
            raise ValueError(f"{cfg.name}: AFD requires routed experts")
        self.cfg = cfg
        self.specs: List[LayerSpec] = cfg.layer_plan().flat()
        device = resolve_device(device)
        self.a_device = resolve_device(a_device or device)
        self.f_devices = [resolve_device(d) for d in (f_devices or [device])]
        n_f = len(self.f_devices)
        self.experts_sharded = n_f > 1 and cfg.n_experts % n_f == 0
        self.impl = impl
        self.stats = AFDStats()
        # rotations captured in a CUDA graph (``decode_step_3bo``): whether
        # they can be, the one captured, the key of the last eager one and
        # the rotations replayed (which no launch counter sees)
        self._graphable = rotation_graph.applies(self.a_device,
                                                 self.f_devices, impl)
        self._graph: Optional[rotation_graph.CapturedRotation] = None
        self._eager_key = None
        self.replays = 0
        a_params, f_layers = split_roles(params, cfg)
        self.a_params = _to(a_params, self.a_device)
        if cfg.tie_embeddings:
            # One contiguous (D, V) copy of the tied head: a product with
            # the transposed view takes another CPU GEMM path at different
            # row counts, which would break chunk == decode bit-exactness.
            self.a_params["lm_head"] = {
                "w": self.a_params["embed"]["tok"].T.contiguous()}
        # per MoE layer, one {"wi", "wo"} per F device: its block of the
        # experts, or all of them when they are replicated
        e_blk = cfg.n_experts // n_f if self.experts_sharded else cfg.n_experts
        self.f_shards = [None if fl is None else [
            {n: _to(fl[n][j * e_blk:(j + 1) * e_blk] if self.experts_sharded
                    else fl[n], dev) for n in ("wi", "wo")}
            for j, dev in enumerate(self.f_devices)] for fl in f_layers]

    def synchronize(self) -> None:
        """Wait for the runtime's devices (wall-clock timing)."""
        for dev in {self.a_device, *self.f_devices}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ---- per-layer A-role pieces -------------------------------------------

    def _mixer(self, lp, spec: LayerSpec, x, cache, pos):
        with trace.span("afd.a.mixer"):
            h = apply_norm(lp["ln1"], self.cfg, x)
            if spec.kind == "attn":
                mix, nc = attn_mod.attention_decode(lp["attn"], self.cfg, h,
                                                    cache, pos, impl=self.impl)
            else:
                mix, nc = mamba2.mamba_decode(lp["mamba"], self.cfg, h, cache)
            return x + mix, nc

    def _mixer_chunk(self, lp, spec: LayerSpec, x, cache, pos):
        if spec.kind == "attn":
            with trace.span("afd.a.attn_chunk"):
                h = apply_norm(lp["ln1"], self.cfg, x)
                mix, nc = attn_mod.attention_prefill_cached(
                    lp["attn"], self.cfg, h, cache, pos, impl=self.impl)
                return x + mix, nc
        # The SSM recurrence has no cached-state batched form here: step
        # the chunk token by token, bit-identical to decode (each token is
        # made contiguous, as decode's is: a strided operand takes another
        # CPU GEMM path). The M2N saving lives in the MoE dispatch.
        with trace.span("afd.a.mamba_chunk"):
            h = apply_norm(lp["ln1"], self.cfg, x)
            trace.count("mamba.steps", x.shape[1])
            outs = []
            for j in range(x.shape[1]):
                mj, cache = mamba2.mamba_decode(
                    lp["mamba"], self.cfg, h[:, j:j + 1].contiguous(), cache)
                outs.append(mj)
            return x + torch.cat(outs, dim=1), cache

    def _ffn_local(self, lp, spec: LayerSpec, x):
        """Dense-MLP layers run wholly on the A role."""
        if spec.moe or "mlp" not in lp:
            return x
        with trace.span("afd.a.dense"):
            h = apply_norm(lp["ln2"], self.cfg, x)
            return x + apply_mlp(lp["mlp"], self.cfg, h)

    # ---- the M2N cycle -------------------------------------------------------

    def _moe_cycle(self, lp, f_shards, x):
        """Norm → route (A) → dispatch → expert FFN (F) → combine (A)."""
        cfg = self.cfg
        with trace.span("afd.a.route"):
            h = apply_norm(lp["ln2"], cfg, x)
            tokens = h.reshape(-1, cfg.d_model)
            _, topw, topi = moe_mod.route(lp["moe"], cfg, tokens)

        # dispatch: M2N transfer A → F. Gating metadata is priced at 4 bytes
        # per index and per weight, as the Eq. 9/17 predictor assumes.
        blocks = f_shards if self.experts_sharded else f_shards[:1]
        with trace.span("afd.dispatch"):
            self.stats.record(tokens.shape[0], cfg.d_model,
                              tokens.element_size(),
                              topi.numel() * 4 + topw.numel() * 4)
            sent = [(tokens.to(dev), topw.to(dev), topi.to(dev))
                    for dev, _ in zip(self.f_devices, blocks)]

        # F role: the grouped GEMM kernel, dispatch gather and combine
        # unpermute fused into it; one program per expert block, whose
        # partial outputs sum on the A device (combine: F → A)
        parts = []
        for j, (w, (tk, tw, ti)) in enumerate(zip(blocks, sent)):
            with trace.span("afd.f.experts"):
                parts.append(moe_mod.expert_ffn(
                    cfg, w["wi"], w["wo"], tk, tw, ti, self.impl,
                    first_expert=j * w["wi"].shape[0]))

        with trace.span("afd.combine"):
            routed = None
            for part in parts:
                part = part.to(self.a_device)
                routed = part if routed is None else routed + part
            out = x + routed.reshape(x.shape)
        if "shared" in lp["moe"]:
            with trace.span("afd.a.dense"):
                out = out + apply_mlp(lp["moe"]["shared"], cfg, h)
        return out

    def _ffn(self, i: int, spec: LayerSpec, x):
        lp = self.a_params["layers"][i]
        if spec.moe:
            return self._moe_cycle(lp, self.f_shards[i], x)
        return self._ffn_local(lp, spec, x)

    def _head(self, x):
        with trace.span("afd.a.head"):
            x = apply_norm(self.a_params["final_norm"], self.cfg, x)
            return apply_lm_head(self.a_params["lm_head"],
                                 self.a_params["embed"], self.cfg, x)

    # ---- public decode ---------------------------------------------------------

    def init_cache(self, batch: int, max_len: int):
        caches = [kvcache.init_layer_cache(self.cfg, s, batch, max_len,
                                           self.a_device)
                  for s in self.specs]
        return caches, torch.zeros(batch, dtype=torch.int32,
                                   device=self.a_device)

    def decode_step(self, tokens: torch.Tensor, caches, pos: torch.Tensor):
        """One token for one micro-batch. tokens: (B,). Returns (logits,
        caches, pos + 1): attention caches are updated in place, Mamba
        caches are new tensors, so callers keep the returned list."""
        x = embed_tokens(self.a_params["embed"], self.cfg, tokens[:, None],
                         pos[:, None])
        new_caches = []
        for i, spec in enumerate(self.specs):
            x, nc = self._mixer(self.a_params["layers"][i], spec, x,
                                caches[i], pos)
            x = self._ffn(i, spec, x)
            new_caches.append(nc)
        return self._head(x)[:, 0], new_caches, pos + 1

    def decode_step_3bo(self, micro_batches, n_bo: int = 3):
        """Drive the micro-batches through the layer loop in the 3BO
        rotation: per layer, attention for every micro-batch, then every
        micro-batch's FFN cycle. micro_batches: list of (tokens (B,),
        caches, pos). Returns the list of (logits, caches, pos).

        Where the rotation can be captured (``rotation_graph.applies``)
        every cache is updated in place, Mamba's too, and the caches
        returned are the ones given. A rotation whose key
        (``rotation_graph.rotation_key``) is not the last eager one's runs
        eager; one that repeats it is captured in a CUDA graph, and while
        the key matches the captured one it is replayed. Elsewhere it runs
        eager, and Mamba caches are new tensors."""
        if not self._graphable:
            trace.count("graph.eager")
            return self._rotation(micro_batches)
        key = rotation_graph.rotation_key(micro_batches, n_bo)
        if self._graph is not None and self._graph.key == key:
            trace.count("graph.replay")
            self.replays += 1
            with trace.span("afd.rotation.replay"):
                return self._graph.replay(self, micro_batches)
        if key != self._eager_key:
            self._eager_key = key
            trace.count("graph.eager")
            return self._rotation(micro_batches)
        trace.count("graph.capture")
        with trace.span("afd.rotation.capture"):
            self._graph = None          # its memory goes before the next
            self._graph = rotation_graph.capture(self, micro_batches, key)
            return self._graph.replay(self, micro_batches)

    def _rotation(self, micro_batches):
        """The rotation enqueued call by call."""
        states = []
        for tokens, caches, pos in micro_batches:
            x = embed_tokens(self.a_params["embed"], self.cfg,
                             tokens[:, None], pos[:, None])
            states.append({"x": x, "caches": caches, "new": [], "pos": pos})
        for i, spec in enumerate(self.specs):
            lp = self.a_params["layers"][i]
            for st in states:            # stage 1: A role mixers
                cache = st["caches"][i]
                st["x"], nc = self._mixer(lp, spec, st["x"], cache,
                                          st["pos"])
                if self._graphable and nc is not cache:
                    nc = _in_place(cache, nc)
                st["new"].append(nc)
            for st in states:            # stage 2: M2N cycles
                st["x"] = self._ffn(i, spec, st["x"])
        return [(self._head(st["x"])[:, 0], st["new"], st["pos"] + 1)
                for st in states]

    # ---- public prefill --------------------------------------------------------

    def _prefill_block(self, tokens, caches, pos):
        """One chunk (B, C) through the full layer stack — C tokens per
        M2N cycle instead of 1."""
        c = tokens.shape[1]
        x = embed_tokens(self.a_params["embed"], self.cfg, tokens,
                         pos[:, None] + torch.arange(c, dtype=pos.dtype,
                                                     device=pos.device))
        new_caches = []
        for i, spec in enumerate(self.specs):
            x, nc = self._mixer_chunk(self.a_params["layers"][i], spec, x,
                                      caches[i], pos)
            x = self._ffn(i, spec, x)
            new_caches.append(nc)
        return self._head(x), new_caches, pos + c

    def prefill(self, tokens: torch.Tensor, caches, pos: torch.Tensor,
                chunk: Optional[int] = None):
        """Batched prefill: S tokens per sequence in ceil(S/chunk) M2N
        cycles per MoE layer. tokens: (B, S); pos: (B,) start positions.
        On the plain path the logits and caches are bit-exact against
        token-by-token ``decode_step`` teacher forcing.

        Returns (logits (B, S, V) float32, caches, pos + S).
        """
        s = tokens.shape[1]
        c = s if chunk is None else max(1, int(chunk))
        parts = []
        for off in range(0, s, c):
            lg, caches, pos = self._prefill_block(tokens[:, off:off + c],
                                                  caches, pos)
            parts.append(lg)
        return torch.cat(parts, dim=1), caches, pos


def split_nodes(devices: Sequence, n_a_nodes: int, n_f_nodes: int,
                devices_per_node: int = 1):
    """Split a flat device list into A/F roles at node granularity."""
    need = (n_a_nodes + n_f_nodes) * devices_per_node
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    a = devices[:n_a_nodes * devices_per_node]
    f = devices[n_a_nodes * devices_per_node:need]
    return list(a), list(f)


def rescale(runtime: AFDRuntime, a_device, f_devices: Sequence
            ) -> AFDRuntime:
    """Rebuild the runtime on a new role split: the paper's discrete
    N_A/N_F adjustment executed live (after a re-plan, or after a failure
    shrinks a role). The parameters are reassembled from the two roles
    (expert blocks joined) and moved to the new devices; tensors already
    there are shared, not copied. Caches are not migrated: in-flight
    requests drain and requeue as ``AFDServeEngine.simulate_failure``
    does."""
    cfg = runtime.cfg
    layers = []
    for lp, sh in zip(runtime.a_params["layers"], runtime.f_shards):
        lp = dict(lp)
        if sh is not None:
            blocks = sh if runtime.experts_sharded else sh[:1]
            lp["moe"] = {**lp["moe"], **{
                n: blocks[0][n] if len(blocks) == 1 else torch.cat(
                    [b[n].to(blocks[0][n].device) for b in blocks])
                for n in ("wi", "wo")}}
        layers.append(lp)
    a = runtime.a_params
    params = {"embed": a["embed"],
              # the tied head's (D, V) copy is the runtime's own; the new
              # runtime makes its own from the embedding
              "lm_head": {} if cfg.tie_embeddings else a["lm_head"],
              "final_norm": a["final_norm"], "layers": layers}
    return AFDRuntime(cfg, params, device=a_device, f_devices=f_devices,
                      impl=runtime.impl)
