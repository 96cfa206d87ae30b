"""The plain reference of the served models, in float32 with TF32 off.

A whole-sequence forward pass, no cache and no kernels: pre-norm
residual layers whose mixer is grouped-query attention with rotary
positions (causal softmax over the whole prefix) or a Mamba-2 mixer run
as its per-token recurrence, and whose FFN is a top-k routed mixture of
gated SiLU experts (plus its shared experts, one gated SiLU MLP, where the
configuration has them) or a dense gated SiLU MLP; a final RMS norm and
the LM head. It reads the configuration's sizes and the benchmark's weights
(``afdbench.weights``' layout) and imports nothing of the program.

The layers run one after another over every sequence, so one layer's
weights are upcast to float32 at a time (one expert at a time in a MoE
layer) and a 52 GB bf16 model fits beside its float32 copy of one layer.
``quant`` rounds both operands of every weight product (the weight per
output column, the activation per row) and the embedding's rows: the
check's control uses it to compute the reference as a float8 model
would, with products accumulated in float32.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from afdbench.work import layer_kinds

Quant = Optional[Callable[[torch.Tensor, int], torch.Tensor]]


def prompt_tokens(rid: int, prompt_len: int, vocab_size: int) -> np.ndarray:
    """The prompt the serving engine makes for request ``rid``: token j is
    (131·j + 31·rid + 7) mod (V − 1) + 1."""
    base = np.arange(prompt_len, dtype=np.int64)
    return ((base * 131 + rid * 31 + 7) % max(vocab_size - 1, 1) + 1
            ).astype(np.int64)


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest magnitude maps to 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, d): rotate the two halves of each head by position."""
    s, _, d = x.shape
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    """The model of ``arch`` (the configuration file's ``port`` sizes) on
    ``params``; ``quant`` (None, or ``fp8_round``) rounds each product's operands."""

    def __init__(self, arch: dict, params: dict, quant: Quant = None):
        self.arch = arch
        self.p = params
        self.quant = quant
        self.eps = arch.get("rms_eps", 1e-6)

    def _w(self, t: torch.Tensor, in_dim: int = 0) -> torch.Tensor:
        w = t.float()
        return w if self.quant is None else self.quant(w, in_dim)

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (rows, in) @ w (in, out), w already upcast."""
        return (x if self.quant is None else self.quant(x, 1)) @ w

    # ---- mixers --------------------------------------------------------------

    def _attention(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        a = self.arch
        hq, hkv = a["n_heads"], a["n_kv_heads"]
        dh = a.get("d_head") or a["d_model"] // hq
        s = h.shape[0]
        q = self._mm(h, self._w(lp["wq"])).view(s, hq, dh)
        k = self._mm(h, self._w(lp["wk"])).view(s, hkv, dh)
        v = self._mm(h, self._w(lp["wv"])).view(s, hkv, dh)
        if a.get("use_rope", True):
            q, k = _rope(q, a.get("rope_theta", 1e4)), _rope(k, a.get(
                "rope_theta", 1e4))
        g = hq // hkv
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        scores = torch.einsum("shd,thd->hst", q, k) / float(dh) ** 0.5
        mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
        out = torch.einsum("hst,thd->shd", torch.softmax(scores, dim=-1), v)
        return self._mm(out.reshape(s, hq * dh), self._w(lp["wo"]))

    def _mamba(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        a = self.arch
        d = a["d_model"]
        di = a.get("ssm_expand", 2) * d
        n, g = a["ssm_state"], a.get("ssm_groups", 1)
        pdim = a.get("ssm_head_dim", 64)
        heads = di // pdim
        width = a.get("ssm_conv", 4)
        s = h.shape[0]
        proj = self._mm(h, self._w(lp["in_proj"]))
        z, xbc, dt = proj[:, :di], proj[:, di:2 * di + 2 * g * n], \
            proj[:, 2 * di + 2 * g * n:]
        # depthwise causal conv: tap j reads the input j - (width-1) back
        w = self._w(lp["conv_w"], 0)
        xp = F.pad(xbc, (0, 0, width - 1, 0))
        conv = sum(xp[j:j + s] * w[j] for j in range(width))
        xbc = F.silu(conv + lp["conv_b"].float())
        x = xbc[:, :di].view(s, heads, pdim)
        b = xbc[:, di:di + g * n].view(s, g, n).repeat_interleave(
            heads // g, dim=1)
        c = xbc[:, di + g * n:].view(s, g, n).repeat_interleave(
            heads // g, dim=1)
        dt = F.softplus(dt + lp["dt_bias"].float())             # (S, H)
        decay = torch.exp(dt * -torch.exp(lp["A_log"].float()))  # (S, H)
        state = torch.zeros(heads, pdim, n, device=h.device)
        ys = []
        for t in range(s):
            state = state * decay[t][:, None, None] \
                + (dt[t][:, None] * x[t])[:, :, None] * b[t][:, None, :]
            ys.append(torch.einsum("hpn,hn->hp", state, c[t]))
        y = torch.stack(ys) + lp["D"].float()[None, :, None] * x
        y = y.reshape(s, di) * F.silu(z)
        y = _rms(y, lp["norm"], self.eps)
        return self._mm(y, self._w(lp["out_proj"]))

    # ---- FFNs ------------------------------------------------------------------

    def _moe(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        a = self.arch
        mf, k = a["moe_d_ff"], a["top_k"]
        probs = torch.softmax(self._mm(h, self._w(lp["router"])), dim=-1)
        topw, topi = torch.topk(probs, k, dim=-1)
        if a.get("router_renorm", True):
            topw = topw / topw.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in range(a["n_experts"]):
            rows, slot = torch.nonzero(topi == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            hi = self._mm(h[rows], self._w(lp["wi"][e]))
            y = self._mm(F.silu(hi[:, :mf]) * hi[:, mf:],
                         self._w(lp["wo"][e]))
            out.index_add_(0, rows, y * topw[rows, slot][:, None])
        if "shared" in lp:
            out = out + self._mlp(lp["shared"], h)
        return out

    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        f = lp["wo"].shape[0]
        hi = self._mm(h, self._w(lp["wi"]))
        return self._mm(F.silu(hi[:, :f]) * hi[:, f:], self._w(lp["wo"]))

    # ---- the model -------------------------------------------------------------

    def logits(self, seqs: Sequence[torch.Tensor],
               first: Sequence[int]) -> List[torch.Tensor]:
        """Float32 logits of each token sequence (S_i,) from position
        ``first[i]`` on: (S_i − first[i], V) each."""
        p = self.p
        prev = torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                emb = p["embed"]["tok"]
                xs = [self._embed(emb, t) for t in seqs]
                for i, (mixer, ffn) in enumerate(layer_kinds(self.arch)):
                    lp = p["layers"][i]
                    for j, x in enumerate(xs):
                        h = _rms(x, lp["ln1"]["scale"], self.eps)
                        mix = (self._attention(lp["attn"], h) if mixer == "attn"
                               else self._mamba(lp["mamba"], h))
                        xs[j] = x + mix
                    if ffn == "none":
                        continue
                    sizes = [x.shape[0] for x in xs]
                    x = torch.cat(xs)
                    h = _rms(x, lp["ln2"]["scale"], self.eps)
                    y = (self._moe(lp["moe"], h) if ffn == "moe"
                         else self._mlp(lp["mlp"], h))
                    xs = list(torch.split(x + y, sizes))
                head = p.get("lm_head", {}).get("w")
                w = self._w(emb, 1).T if head is None else self._w(head)
                return [self._mm(_rms(x[f:], p["final_norm"]["scale"],
                                     self.eps), w)
                        for x, f in zip(xs, first)]
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = prev

    def _embed(self, emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        rows = emb[tokens.to(emb.device)].float()
        if self.quant is None:
            return rows
        return self.quant(rows, 1)
