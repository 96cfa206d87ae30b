"""Architecture registry of the port: a copy of ``repro.configs``.

Each module defines ``CONFIG`` (the published configuration) and
``smoke_config()`` (a reduced same-family variant for CPU tests).
``get_config`` / ``get_smoke_config`` take a CLI id (``qwen3-8b``) or a
module name (``qwen3_8b``).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ArchConfig

ARCHS: List[str] = [
    "qwen1_5_0_5b",
    "qwen3_8b",
    "granite_8b",
    "h2o_danube_1_8b",
    "jamba_v0_1_52b",
    "internvl2_2b",
    "kimi_k2_1t_a32b",
    "granite_moe_1b_a400m",
    "whisper_small",
    "mamba2_2_7b",
]

# CLI ids (dashes/dots) → module names
_ALIASES: Dict[str, str] = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen3-8b": "qwen3_8b",
    "granite-8b": "granite_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "internvl2-2b": "internvl2_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "whisper-small": "whisper_small",
    "mamba2-2.7b": "mamba2_2_7b",
}

ARCH_IDS: List[str] = list(_ALIASES)


def _module(name: str):
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()


def canonical_id(name: str) -> str:
    for cli, mod in _ALIASES.items():
        if name in (cli, mod):
            return cli
    raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
