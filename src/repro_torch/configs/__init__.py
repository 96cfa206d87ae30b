"""Architecture registry of the port: the configs the AFD path carries.

Each module defines ``CONFIG`` (the published configuration) and
``smoke_config()`` (a reduced same-family variant for CPU tests).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ArchConfig

_ALIASES: Dict[str, str] = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS: List[str] = list(_ALIASES)


def _module(name: str):
    mod_name = _ALIASES.get(name, name)
    if mod_name not in _ALIASES.values():
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()
