"""``repro_torch.api`` — the front door over ``repro_torch.core``; the
counterpart of ``repro.api``, numpy only (no torch).

Public surface:
  * :class:`Deployment` — façade binding (model, hardware, scenario) to the
    planner / roofline / imbalance analytics.
  * :func:`sweep` / :func:`run_named_sweep` — vectorized grid evaluation of
    the §3 hot path (thousands of points in one numpy shot).
  * :func:`sweep_tiles` / :class:`GridSpec` — the streaming tile core under
    ``sweep``: memory-bounded evaluation of million-point grids, optionally
    sharded across worker processes (the ``repro_torch.provision`` search
    rides on this).
  * :class:`Record` — JSON-serializable results.
  * ``registry`` — name resolution for models / hardware / scenarios /
    named sweeps / fleet routers (and the port's ``repro_torch.configs``
    architectures).

CLI: ``python -m repro_torch {plan,sweep,bench,provision,list}``.
"""

from repro_torch.api import registry
from repro_torch.api.deployment import Deployment
from repro_torch.api.records import Record, dump_records, load_records
from repro_torch.api.sweep import (GridSpec, SweepResult, SweepTile,
                                   resolve_grid, run_named_sweep,
                                   scalar_reference, sweep, sweep_tiles,
                                   tile_footprint_bytes, tile_spans,
                                   tiles_from_grid)

list_models = registry.list_models
list_hardware = registry.list_hardware
list_sweeps = registry.list_sweeps

__all__ = [
    "Deployment", "GridSpec", "Record", "SweepResult", "SweepTile",
    "dump_records", "load_records", "registry", "resolve_grid",
    "run_named_sweep", "scalar_reference", "sweep", "sweep_tiles",
    "tile_footprint_bytes", "tile_spans", "tiles_from_grid",
    "list_models", "list_hardware", "list_sweeps",
]
