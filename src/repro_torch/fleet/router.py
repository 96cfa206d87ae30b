"""Request routing across AFD serving replicas. Counterpart of
``repro.fleet.router``.

A policy sees an immutable ``ReplicaView`` per healthy replica (queue
depth, occupied slots, KV-cache bytes, pending prompt work) and picks one
for each arrival. Nothing reads a clock or a random stream, so a (trace,
seed, policy) triple routes the same way on every run.

Policies:
  round-robin     cycle over the healthy replicas
  least-kv        least KV-cache bytes committed (live + queued)
  predicted-ttft  smallest predicted time to first token
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Type


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """The routing-relevant state of one healthy replica."""
    index: int                  # fleet-wide replica index
    name: str
    queue_len: int
    live: int
    total_slots: int
    kv_occupancy_bytes: int
    kv_budget_bytes: int
    queued_kv_bytes: int
    queued_prompt_tokens: int
    queued_pending_tokens: int
    tick_seconds: float
    prefill_chunk: Optional[int] = None   # chunked-prefill size (None: legacy)
    prefill_backlog_tokens: int = 0       # admitted prompts still prefilling


@dataclasses.dataclass(frozen=True)
class RouteRequest:
    """What a policy knows about the arrival it places."""
    rid: int
    t: float
    prompt_len: int
    max_new_tokens: int


class RouterPolicy:
    """Base class: ``choose`` returns the fleet index of the target."""

    name = "base"

    def choose(self, req: RouteRequest,
               views: Sequence[ReplicaView]) -> int:
        raise NotImplementedError


class RoundRobinRouter(RouterPolicy):
    """Cycle over the healthy replicas in fleet order."""

    name = "round-robin"

    def __init__(self) -> None:
        self._i = 0

    def choose(self, req: RouteRequest,
               views: Sequence[ReplicaView]) -> int:
        view = views[self._i % len(views)]
        self._i += 1
        return view.index


class LeastKVRouter(RouterPolicy):
    """Least KV-cache bytes committed: live reservations plus the queued
    requests' worst-case footprints; ties go to the lowest index."""

    name = "least-kv"

    def choose(self, req: RouteRequest,
               views: Sequence[ReplicaView]) -> int:
        return min(views, key=lambda v: (v.kv_occupancy_bytes
                                         + v.queued_kv_bytes,
                                         v.index)).index


class PredictedTTFTRouter(RouterPolicy):
    """Smallest predicted TTFT under the engines' virtual-clock cost
    model: legacy prefill costs one tick per prompt token (queued prompts
    go first), chunked prefill ``ceil(tokens / chunk)`` ticks (the
    admitted backlog goes first too), and each request beyond the slot
    count waits one full generation."""

    name = "predicted-ttft"

    def predict(self, req: RouteRequest, v: ReplicaView) -> float:
        if v.prefill_chunk:
            pending = (v.queued_prompt_tokens + v.prefill_backlog_tokens
                       + req.prompt_len)
            prefill_ticks = math.ceil(pending / v.prefill_chunk)
        else:
            prefill_ticks = v.queued_prompt_tokens + req.prompt_len
        excess = max(0, v.live + v.queue_len + 1 - v.total_slots)
        wait_ticks = excess * max(req.max_new_tokens, 1)
        return v.tick_seconds * (prefill_ticks + wait_ticks)

    def choose(self, req: RouteRequest,
               views: Sequence[ReplicaView]) -> int:
        return min(views,
                   key=lambda v: (self.predict(req, v), v.index)).index


ROUTER_POLICIES: Dict[str, Type[RouterPolicy]] = {
    cls.name: cls
    for cls in (RoundRobinRouter, LeastKVRouter, PredictedTTFTRouter)
}


def get_policy(name: str) -> RouterPolicy:
    try:
        return ROUTER_POLICIES[name]()
    except KeyError:
        raise KeyError(
            f"unknown router policy {name!r}; "
            f"known: {sorted(ROUTER_POLICIES)}") from None


def list_policies() -> List[str]:
    return sorted(ROUTER_POLICIES)
