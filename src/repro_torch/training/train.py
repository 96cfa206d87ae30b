"""Train-step builder: gradients by autograd, microbatch accumulation.
Counterpart of ``repro.training.train``.

``build_step_fn`` assembles the (params, opt_state, batch) →
(params, opt_state, metrics) function. The loss's gradients come from
``torch.autograd.grad`` over detached copies of the parameter leaves that
require grad (``torch.func`` does not compose with the
``torch.utils.checkpoint`` that ``cfg.remat`` uses). With ``grad_accum``
> 1 the batch is split into equal microbatches along its first axis, one
backward each, and their gradients are summed in float32 (each first cast
to its parameter's dtype when ``bf16_grad_reduce`` is set, as JAX casts
the gradients it would communicate) and averaged.

``metrics`` holds ``loss``, ``ce``, ``aux``, ``ppl_proxy`` (means over
the microbatches) and ``grad_norm``, the global norm of the gradients
before the optimizer clips them; all are 0-d float32 tensors on the
device.

``make_train_step`` has no ``donate``: eager PyTorch frees nothing when
an argument is donated, so the switch would change nothing. The sharded
step (``opt_state_shardings``, ``jit_distributed_train_step``) waits for
the port's ``parallel/sharding.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.models.common import tree_map
from repro_torch.models.model import Model
from repro_torch.training.optimizer import Optimizer, global_norm


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    bf16_grad_reduce: bool = True


def _microbatches(batch: Dict[str, torch.Tensor],
                  n: int) -> List[Dict[str, torch.Tensor]]:
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by grad_accum {n}")
    parts = {k: v.chunk(n, dim=0) for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], object]:
    """(loss, its parts, the gradient tree) of ``model.loss`` at
    ``params``; every leaf gets a gradient (zeros where the loss does not
    reach it, as ``jax.grad`` gives)."""
    leaves: List[torch.Tensor] = []

    def track(p):
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t

    loss, parts = model.loss(tree_map(track, params), batch)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_map(lambda p: next(grads), params))


def build_step_fn(model: Model, opt: Optimizer,
                  tc: TrainConfig = TrainConfig()):
    def step(params, opt_state, batch):
        if tc.grad_accum == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            losses, parts = [], []
            for mb in _microbatches(batch, tc.grad_accum):
                loss, m, g = loss_and_grads(model, params, mb)
                if tc.bf16_grad_reduce:
                    # communicate in param dtype; accumulate in f32
                    g = tree_map(lambda a, p: a.to(p.dtype), g, params)
                gsum = tree_map(lambda a, b: a + b.to(a.dtype), gsum, g)
                losses.append(loss)
                parts.append(m)
            grads = tree_map(lambda g: g / tc.grad_accum, gsum)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in parts]).mean()
                       for k in parts[0]}
        with torch.no_grad():
            new_params, new_opt = opt.update(grads, opt_state, params)
            metrics = dict(metrics)
            metrics["loss"] = loss
            metrics["grad_norm"] = global_norm(grads)
        return new_params, new_opt, metrics

    return step


def make_train_step(model: Model, opt: Optimizer,
                    tc: TrainConfig = TrainConfig()):
    """The single-device train step (``build_step_fn``; eager, so there is
    nothing to jit or donate)."""
    return build_step_fn(model, opt, tc)
