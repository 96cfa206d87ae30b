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
an argument is donated, so the switch would change nothing.

``distributed_train_step`` is the counterpart of JAX's
``jit_distributed_train_step``: the same step on DTensors. Parameters and
optimizer state are placed by ``parallel.sharding.params_shardings`` and
``opt_state_shardings``, the batch by ``batch_shardings``; DTensor's
sharding propagation puts in the collectives that XLA's partitioner puts
into JAX's program, and the MoE layers run the expert-parallel hook's
``moe_ep_train`` on local blocks (``parallel.ep.make_dtensor_ep_forward``,
through ``local_map``, JAX's ``shard_map``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.common import tree_map
from repro_torch.models.model import Model
from repro_torch.parallel import sharding as shd
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


# ---------------------------------------------------------------------------
# Distributed shardings
# ---------------------------------------------------------------------------

def _replicated(ndim: int) -> shd.Spec:
    return (None,) * ndim


def opt_state_shardings(opt_state_shape, p_shard, mesh=None):
    """Optimizer-state specs derived from parameter specs, as JAX derives
    them: AdamW's mu/nu mirror the params leaf for leaf and its step is
    replicated; Adafactor's vr drops the last param dim and vc the
    second-to-last (factored stats stay sharded on the surviving axes),
    unfactored v keeps the param's spec, and a spec that does not fit the
    leaf gives a replicated one. ``mesh`` is not read (the specs need
    none); it is JAX's signature."""
    if "mu" in opt_state_shape:                       # AdamW
        return {"mu": p_shard, "nu": p_shard, "step": ()}

    def shard_acc(acc_leaf, ps):
        spec = tuple(ps) if ps else ()
        if "v" in acc_leaf:
            nd = acc_leaf["v"].ndim
            return {"v": spec if len(spec) == nd else _replicated(nd)}
        nd = acc_leaf["vr"].ndim + 1                  # param ndim
        if len(spec) != nd:
            spec = (None,) * nd
        return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}

    def walk(acc, ps):
        if isinstance(acc, dict) and ("vr" in acc or "v" in acc):
            return shard_acc(acc, ps)
        if isinstance(acc, dict):
            return {k: walk(v, ps[k]) for k, v in acc.items()}
        return [walk(v, p) for v, p in zip(acc, ps)]

    return {"acc": walk(opt_state_shape["acc"], p_shard), "step": ()}


def train_state_shardings(params, opt_state, batch, mesh,
                          rules: Optional[shd.MeshRules] = None):
    """(param, optimizer-state, batch) spec trees of one sharded step."""
    rules = rules or shd.TRAIN_RULES
    p_shard = shd.params_shardings(params, mesh, rules)
    return (p_shard, opt_state_shardings(opt_state, p_shard, mesh),
            shd.batch_shardings(batch, mesh, rules))


def distributed_train_step(model: Model, opt: Optimizer, mesh,
                           tc: TrainConfig = TrainConfig(), ep=None):
    """The train step on DTensors over ``mesh`` (a ``DeviceMesh``).

    The returned ``step(params, opt_state, batch)`` takes the trees as
    DTensors, placed by ``train_state_shardings`` under the caller's rules
    (``distribute_tree``; JAX's counterpart takes the rules to derive its
    ``in_shardings``), runs ``build_step_fn`` with the MoE layers on
    ``ep`` (an
    ``EPConfig``; by default EP over "model" with the data axes as DP,
    capacity 1.25, as the dry-run configures it) and returns the new
    parameters and state with the placements they came in with, and the
    metrics as replicated DTensors. Plain tensors the model makes (masks,
    positions) count as replicated. The activations' placement is the
    caller's, as in JAX: run the step inside
    ``parallel.sharding.activate(mesh, rules)`` to place them by
    ``rules`` (``TRAIN_RULES_SP`` splits the sequence over "model")."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel import ep as ep_mod
    ep = ep or ep_mod.EPConfig(mesh=mesh, capacity_factor=1.25)
    inner = build_step_fn(model, opt, tc)

    def like(new, old):
        if isinstance(new, DTensor) and isinstance(old, DTensor):
            return new.redistribute(old.device_mesh, old.placements)
        return new

    def step(params, opt_state, batch):
        with implicit_replication(), ep_mod.activate_dtensor(ep):
            new_params, new_opt, metrics = inner(params, opt_state, batch)
        return (tree_map(like, new_params, params),
                tree_map(like, new_opt, opt_state), metrics)

    return step
