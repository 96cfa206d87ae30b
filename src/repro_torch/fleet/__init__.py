"""Fleet layer of the port: request routing across AFD serving replicas,
failure drain and requeue, and elastic N_F rescale (§3.3 as a live fleet
policy). Counterpart of ``repro.fleet``.

``router`` and ``events`` import no torch; ``FleetController`` and
``ElasticRescaler`` are re-exported lazily, so listing the routers does
not load the serving runtime.
"""

from repro_torch.fleet.events import DrainRecord, FailureEvent, RescaleEvent
from repro_torch.fleet.router import (ROUTER_POLICIES, ReplicaView,
                                      RouteRequest, RouterPolicy, get_policy,
                                      list_policies)

__all__ = [
    "DrainRecord", "FailureEvent", "RescaleEvent",
    "ROUTER_POLICIES", "ReplicaView", "RouteRequest", "RouterPolicy",
    "get_policy", "list_policies",
    "ElasticRescaler", "FleetController", "FleetReplica",
    "FleetWindowRecord",
]


def __getattr__(name: str):
    if name == "ElasticRescaler":
        from repro_torch.fleet.rescaler import ElasticRescaler
        return ElasticRescaler
    if name in ("FleetController", "FleetReplica", "FleetWindowRecord"):
        from repro_torch.fleet import controller
        return getattr(controller, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
