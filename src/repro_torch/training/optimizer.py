"""Optimizers as pure transforms of parameter trees. Counterpart of
``repro.training.optimizer``.

  * AdamW     — the default for ≤10B-parameter architectures.
  * Adafactor — factored second moments, no first moment: the state of a
    (K, N) matrix is K + N floats instead of 2·K·N.

API: ``opt = adamw(lr=...)``; ``state = opt.init(params)``;
``params, state = opt.update(grads, state, params)``. Trees are the port's
nested dicts and lists of tensors (``models.common.tree_map``). States are
float32 and the step counter an int32 scalar on the parameters' device;
updated parameters keep their dtype. ``update`` builds new tensors and
leaves its arguments as they were, as the JAX transforms do. The
arithmetic is JAX's, in its order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models.common import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable                  # (grads, state, params) -> (params, state)
    name: str = "opt"


def _step_zero(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": _step_zero(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        if grad_clip is not None:
            grads = clip_by_global_norm(grads, grad_clip)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(F32),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.to(F32).square(),
                      state["nu"], grads)
        c1 = 1.0 - b1 ** step.to(F32)
        c2 = 1.0 - b2 ** step.to(F32)

        def upd(p, m, v):
            u = (m / c1) / ((v / c2).sqrt() + eps)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            return (p.to(F32) - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init=init, update=update, name="adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored; no momentum)
# ---------------------------------------------------------------------------

def adafactor(lr: float = 1e-3, eps: float = 1e-30,
              decay: float = 0.8, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Shazeer–Stern Adafactor with factored second moments for ≥2-D
    params (trailing two dims factored) and full accumulators for vectors.
    The factored update is JAX's expression as it stands."""

    def init(params):
        def state_for(p):
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
        return {"acc": tree_map(state_for, params),
                "step": _step_zero(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        beta = 1.0 - (step.to(F32) + 1.0) ** (-decay)

        def upd(p, g, acc):
            gf = g.to(F32)
            g2 = gf.square() + eps
            if p.ndim >= 2:
                vr = beta * acc["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * acc["vc"] + (1 - beta) * g2.mean(-2)
                r = vr / vr.mean(-1, keepdim=True).clamp(min=eps)
                u = gf / (r.sqrt()[..., None] * vc.sqrt()[..., None, :]
                          / vc.mean(-1, keepdim=True).clamp(min=eps)
                          .sqrt()[..., None, :] + eps)
                new_acc = {"vr": vr, "vc": vc}
            else:
                v = beta * acc["v"] + (1 - beta) * g2
                u = gf / (v.sqrt() + eps)
                new_acc = {"v": v}
            # update clipping (RMS ≤ clip_threshold)
            rms = (u.square().mean() + eps).sqrt()
            u = u / (rms / clip_threshold).clamp(min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            return (p.to(F32) - lr * u).to(p.dtype), new_acc

        outs = tree_map(upd, params, grads, state["acc"])
        new_params = tree_map(lambda p, o: o[0], params, outs)
        new_acc = tree_map(lambda p, o: o[1], params, outs)
        return new_params, {"acc": new_acc, "step": step}

    return Optimizer(init=init, update=update, name="adafactor")


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(x.to(F32).square().sum()
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = (max_norm / norm.clamp(min=1e-12)).clamp(max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads)


def optimizer_for(arch_params_b: float) -> Optimizer:
    """Policy: Adafactor for ≥100B-parameter models, AdamW otherwise."""
    return adafactor() if arch_params_b >= 100.0 else adamw()
